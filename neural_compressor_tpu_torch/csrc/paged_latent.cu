// MLA latent paging (DeepSeek): the write of each slot's new latent row
// into its page, and single-token decode attention over a slot's latent
// pages, the latent serving as both key and value.
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_latent_write_impl / _latent_write_kernel (K14's write, called
//   through paged_write_latent) and _paged_latent_attn_impl /
//   _paged_latent_kernel (K14's attention, called through
//   paged_latent_attention).
//
// Semantics (as K14): pages [P, 1, page, C] bf16 hold one C = r + dr row a
//   token ([post-norm latent | rotated shared rope key]); block_tables
//   int32 [B, PMAX] map a slot's logical page j to a pool page.
//   Write: row [B, C] goes to row pos[b] % page of pool page
//   block_tables[b, pos[b] / page]; a page index past the table writes the
//   trash page 0 at that row, as JAX's paged_write_latent does (its
//   take_along_axis fills, its page index clamps); a negative position
//   writes nothing. Where several slots target one row (idle slots parked
//   on the trash page), the last slot's row stands, as in the plain
//   version.
//   Attention: q [B, H, C] bf16 (the absorbed query | the rotated rope
//   query); lengths int32 [B] count the slot's rows, the new one included
//   (written first); s = f32(sum_c q . lat) * scale over the rows t <
//   lengths[b] (at most PMAX * page); m the maximum over the slot; e =
//   exp(s - m) in float64, l = sum e unrounded; acc[c] = sum_t bf16(f32(e))
//   * lat[t, c] for c < r (the TPU kernel rounds its probabilities to the
//   pages' dtype for PV); out f32 [B, H, r] = f32(acc) / max(f32(l),
//   1e-30); a zero-length slot gives zeros. The TPU kernel's online softmax
//   over groups of kpp = min(4, PMAX) pages equals this one pass wherever
//   one group covers the slot's pages or its running max does not move.
//
// Bound on this card: bytes at the main path's lengths. Each visited row
//   is read once for all H heads: sum_b len_b * C * 2 bytes, plus q
//   (B*H*C*2) and the float32 output (B*H*r*4). The operations, sum_b 2 * H
//   * len_b * (C + r) (MLA is MQA at rep H: 256 operations a byte at H =
//   128), take longer on the float64 units the sums need: 2.93 GFLOP at the
//   check's lengths, 0.044 ms at the FP64 tensor cores' 67 TFLOP/s.
//
// Design: the write is one block a slot copying its C-wide row; the TPU
//   kernel rewrites the slot's whole page block, this writes only the row.
//   Each block first looks for a later slot with the same target and
//   leaves the row to it, so one writer stands and the result is
//   deterministic. The attention (kernels in paged_latent.cuh) answers what
//   held the one-pass kernel back: no split of a long slot's keys (its 32
//   blocks of 4 heads walked all 4,096 rows twice, on at most 32 SMs),
//   every row staged by 32 blocks in each pass, a float64 shuffle tree a
//   (row, head), synchronous tile loads, and scalar float64 FMAs where the
//   work is a matrix product.
//   * Plan. kernels/paged_attention.py latent_plan cuts a slot's rows into
//     parts of whole pages (part_rows, 512 at 128-row pages; absolute
//     positions set by the page size alone, never by the lengths, B or H,
//     so a row's terms are summed in the same order whatever shares the
//     launch) and the H heads into groups of HG = 32: every head reads the
//     same latent row, so a staged row serves HG heads. A block whose rows
//     start past its slot's length exits at once.
//   * Launch 1, scores and row-block maxima, grid (row blocks of 128 rows,
//     head groups, B): S = q . lat^T for the group's heads and the
//     block's rows as a float64 matrix product on the FP64 tensor cores
//     (mma.sync m16n8k16 .f64; tools/dmma_probe.cu: m16n8k4-k16 run at 67
//     TFLOP/s, m8n8k4 at half), 4096 sums held in registers (16 a thread)
//     while 32-column stages of the rows (through the block table) and of
//     the queries stream by 16-byte cp.async copies through a 3-stage ring
//     in shared memory. Each bf16 converts to float64 exactly as its
//     fragment is loaded (nctt::bf16_bits); a lane's eight columns of a
//     stage are its k values of the stage's products, in an order A and B
//     share. s = f32(S) * scale goes to the workspace [B, H, PMAX * page],
//     each head's maximum over the block to pmax [B, H, row blocks].
//   * Launch 2, PV, grid (parts, head groups x column passes of 256
//     columns, B), a programmatic dependent launch: a block stages its
//     first latent rows, waits for launch 1, takes each head's maximum over
//     the slot's row blocks (fmaxf: order-free), forms p =
//     bf16(f32(exp(s - m))) for the part's rows into shared memory and the
//     part's l (each lane's rows in order, then a butterfly), then its
//     pass's columns of acc = P . lat[:, :r] on the tensor cores (32 sums a
//     thread) over 32-row stages of the rows, staged again (from L2). A
//     slot of one part writes its output; the others' partials go to part
//     [B, H, parts, r + 1] (acc, then l).
//   * Launch 3, the fold, grid (r / 256, H, B), a dependent launch: a
//     thread an output adds the parts' partials in ascending part order and
//     writes f32(acc) / max(f32(l), 1e-30). The fold by each (slot, head
//     group)'s last block, as K11 folds, left one SM to read up to 2 MB of
//     partials after the parts ended (+0.07-0.16 ms a call at parts of
//     128-512 rows, tools/latent_attn_sweep.py); spread over the card it
//     takes its share of the bytes.
//   * Numerics. Every product is exact in float64 (bf16 x bf16), so the
//     sums of q . lat and of p . lat are exact in practice and their order
//     (the tensor cores', the parts', the plain version's) does not show.
//     The maximum is global before p is rounded: a flash-decoding fold of
//     per-part maxima would round p against the wrong maximum. l's sum is
//     the one inexact float64 sum; its order is fixed by the plan.
//   * Host. One argument block (kernels/paged_attention.py
//     latent_workspace: the scratch's addresses and the plan, cached per
//     plan and device) keeps the C entry's arguments few; the score rows,
//     row-block maxima and partials are flat buffers kept per device
//     between calls.
#include "paged_latent.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
paged_latent_write_kernel(const __nv_bfloat16* __restrict__ row,
                          __nv_bfloat16* __restrict__ pages,
                          const int* __restrict__ bt,
                          const int* __restrict__ pos, int B, int page,
                          int PMAX, int C) {
  const int b = blockIdx.x;
  auto target = [&](int s, int& pid, int& off) {
    const int p = pos[s];
    if (p < 0) return false;
    const int j = p / page;
    pid = j < PMAX ? bt[(size_t)s * PMAX + j] : 0;
    off = p % page;
    return true;
  };
  int pid, off;
  if (!target(b, pid, off)) return;
  for (int s = b + 1; s < B; ++s) {  // a later writer of the same row wins
    int pid2, off2;
    if (target(s, pid2, off2) && pid2 == pid && off2 == off) return;
  }
  __nv_bfloat16* dst = pages + ((size_t)pid * page + off) * C;
  const __nv_bfloat16* src = row + (size_t)b * C;
  for (int c = threadIdx.x; c < C; c += THREADS) dst[c] = src[c];
}

}  // namespace

// row bf16 [B, C]; pages bf16 [P, 1, page, C]; block_tables int32
// [B, PMAX]; pos int32 [B].
NCTT_API int nctt_paged_latent_write(const void* row, void* pages,
                                     const void* bt, const void* pos, int B,
                                     int P, int page, int PMAX, int C,
                                     void* stream) {
  (void)P;
  if (B < 1 || page < 1 || PMAX < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  paged_latent_write_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)row, (__nv_bfloat16*)pages, (const int*)bt,
      (const int*)pos, B, page, PMAX, C);
  return (int)cudaGetLastError();
}

// q bf16 [B, H, C]; pages bf16 [P, 1, page, C]; block_tables int32
// [B, PMAX]; lengths int32 [B] on the device; out f32 [B, H, r]. `plan`,
// five 64-bit words (kernels/paged_attention.py latent_workspace): the
// scratch's addresses, ws f32 [B, H, PMAX * page] scores, pmax f32 [B, H,
// row blocks], part f64 [B, H, parts, r + 1]; then the plan (latent_plan):
// part_rows rows a part, `parts` parts over the table. 1 <= r <= C <=
// 1024. Three launches on `stream`.
NCTT_API int nctt_paged_latent_attention(const void* q, const void* pages,
                                         const void* bt, const void* lengths,
                                         void* out, const void* plan, int B,
                                         int H, int P, int page, int PMAX,
                                         int C, int r, float scale,
                                         void* stream) {
  (void)P;
  using namespace nctt_lat;
  const long long* w = (const long long*)plan;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.pages = (const __nv_bfloat16*)pages;
  a.bt = (const int*)bt;
  a.lengths = (const int*)lengths;
  a.out = (float*)out;
  a.ws = (float*)w[0];
  a.pmax = (float*)w[1];
  a.part = (double*)w[2];
  a.part_rows = (int)w[3];
  a.parts = (int)w[4];
  a.H = H;
  a.page = page;
  a.PMAX = PMAX;
  a.C = C;
  a.r = r;
  a.scale = scale;
  a.vec = C % 8 == 0 && ((uintptr_t)q & 15) == 0 &&
          ((uintptr_t)pages & 15) == 0;
  const long long Tv = (long long)PMAX * page;
  if (B < 1 || H < 1 || page < 1 || PMAX < 1 || r < 1 || r > C || C > 1024 ||
      a.part_rows < 1 || a.part_rows > MAX_PART_ROWS || a.parts < 1 ||
      (long long)a.parts * a.part_rows < Tv ||
      (long long)(a.parts - 1) * a.part_rows >= Tv)
    return (int)cudaErrorInvalidValue;
  return launch(a, B, (cudaStream_t)stream);
}
