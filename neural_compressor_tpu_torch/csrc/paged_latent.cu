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
//   lengths[b] (at most PMAX * page); e = exp(s - m), l = sum e
//   unrounded; acc[c] = sum_t bf16(e) * lat[t, c] for c < r (the TPU
//   kernel rounds its probabilities to the pages' dtype for PV); out f32
//   [B, H, r] = acc / max(l, 1e-30); a zero-length slot gives zeros. The
//   TPU kernel's online softmax over groups of kpp = min(4, PMAX) pages
//   equals this one pass wherever one group covers the slot's pages or its
//   running max does not move.
//
// Bound on this card: bytes at the main path's lengths. Each visited row
//   is read once for all H heads: sum_b len_b * C * 2 bytes, plus
//   q (B*H*C*2) and the float32 output (B*H*r*4); the operations,
//   sum_b 2*H*len_b*(C + r), sit near the same time at H = 128, since all
//   128 heads share the rows (MQA at rep 128, 256 operations a byte).
//
// Design: the write is one block a slot copying its C-wide row; the TPU
//   kernel rewrites the slot's whole page block, this writes only the row.
//   Each block first looks for a later slot with the same target and
//   leaves the row to it, so one writer stands and the result is
//   deterministic. The attention is one block a (head group of HB = 4
//   heads, slot), 32 blocks a slot at H = 128, so a long slot's rows spread
//   over 32 SMs. A block stages its slot's rows TT = 32 at a time in a
//   shared tile (32 x 576 bf16 = 36 KiB, 16-byte loads, many in flight),
//   which every head of the block reuses: scores a warp a row, its lanes
//   holding the row's C elements in registers, one warp sum a head; PV a
//   thread a (column, every head) pair, r columns over 256 threads, beside
//   a shared tile of the probabilities. Each pass reads the rows again
//   (from L2 for the second). The float32 score rows live in
//   a workspace in device memory ([B, H, PMAX * page], allocated by the
//   wrapper; they pass through L2), so no length is too long. Sums run in
//   float64 over exact bf16 products and round once, so the kernel and its
//   plain version (kernels/paged_attention.py) agree to float32 rounding.
//   A simple first kernel: no wgmma, TMA or split of the keys across
//   blocks.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HB = 4;         // heads a block
constexpr int TT = 32;        // rows of a probability tile
constexpr int MAX_CPL = 32;   // row elements a lane holds: C <= 1024

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

// rows t0 .. t0 + nt - 1 of slot btb's latent pages into the shared tile
// [TT][C] (16-byte vectors where C % 8 == 0, so many loads are in flight)
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* pages,
                                          const int* btb, int t0, int nt,
                                          int page, int C) {
  if (C % 8 == 0) {
    const int vpr = C / 8;                  // vectors a row
    for (int i = threadIdx.x; i < nt * vpr; i += THREADS) {
      const int tt = i / vpr, v = i % vpr, t = t0 + tt;
      const __nv_bfloat16* row =
          pages + ((size_t)btb[t / page] * page + t % page) * C;
      reinterpret_cast<uint4*>(tile + (size_t)tt * C)[v] =
          reinterpret_cast<const uint4*>(row)[v];
    }
  } else {
    for (int i = threadIdx.x; i < nt * C; i += THREADS) {
      const int tt = i / C, c = i % C, t = t0 + tt;
      tile[(size_t)tt * C + c] =
          pages[((size_t)btb[t / page] * page + t % page) * C + c];
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
paged_latent_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ pages,
                              const int* __restrict__ bt,
                              const int* __restrict__ lengths,
                              float* __restrict__ out,
                              float* __restrict__ ws, int H, int page,
                              int PMAX, int C, int r, float scale) {
  // float64 copies of the queries and probabilities, so the inner loops
  // convert nothing but the latent elements, once each
  extern __shared__ __align__(16) double smem[];
  double* sq = smem;                      // [HB][C] the block's queries
  double* sp = sq + HB * C;               // [HB][TT] a probability tile
  __nv_bfloat16* tile =                   // [TT][C] a tile of latent rows
      reinterpret_cast<__nv_bfloat16*>(sp + HB * TT);
  __shared__ double sl[HB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * HB, b = blockIdx.y;
  const int nh = H - h0 < HB ? H - h0 : HB;   // heads of this block
  const int Tv = PMAX * page;
  const int n = lengths[b];
  const int L = n < 0 ? 0 : (n > Tv ? Tv : n);
  const int* btb = bt + (size_t)b * PMAX;
  float* outb = out + ((size_t)b * H + h0) * r;
  if (L == 0) {
    for (int i = tid; i < nh * r; i += THREADS) outb[i] = 0.0f;
    return;
  }
  const __nv_bfloat16* qb = q + ((size_t)b * H + h0) * C;
  for (int i = tid; i < nh * C; i += THREADS)
    sq[i] = (double)__bfloat162float(qb[i]);
  float* wsb = ws + ((size_t)b * H + h0) * Tv;   // [nh][Tv]

  // pass 1: scores, a tile of rows at a time; a warp a row, every head of
  // the block from the row's elements in registers
  for (int t0 = 0; t0 < L; t0 += TT) {
    const int nt = L - t0 < TT ? L - t0 : TT;
    __syncthreads();
    load_tile(tile, pages, btb, t0, nt, page, C);
    __syncthreads();
    for (int tt = warp; tt < nt; tt += WARPS) {
      double lr[MAX_CPL];
#pragma unroll
      for (int i = 0; i < MAX_CPL; ++i) {
        const int c = lane + 32 * i;
        lr[i] = c < C ? (double)__bfloat162float(tile[(size_t)tt * C + c])
                      : 0.0;
      }
      for (int h = 0; h < nh; ++h) {
        double d = 0.0;
#pragma unroll
        for (int i = 0; i < MAX_CPL; ++i) {
          const int c = lane + 32 * i;
          if (c < C) d += sq[h * C + c] * lr[i];
        }
        d = nctt::warp_sum(d);
        if (lane == 0)
          wsb[(size_t)h * Tv + t0 + tt] = __fmul_rn((float)d, scale);
      }
    }
  }
  __syncthreads();

  // softmax numerators, a warp a head: p = bf16(f32(exp(s - m))), l
  // unrounded
  for (int h = warp; h < nh; h += WARPS) {
    float* row = wsb + (size_t)h * Tv;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      l += e;
      row[t] = __bfloat162float(__float2bfloat16_rn((float)e));
    }
    l = nctt::warp_sum(l);
    if (lane == 0) sl[h] = l;
  }
  __syncthreads();

  // pass 2: PV over the first r columns, a thread a column (NC of them)
  // for every head, the rows and the probabilities a tile at a time in
  // shared memory
  double acc[HB][NC];
#pragma unroll
  for (int h = 0; h < HB; ++h)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[h][j] = 0.0;
  for (int t0 = 0; t0 < L; t0 += TT) {
    const int nt = L - t0 < TT ? L - t0 : TT;
    __syncthreads();
    load_tile(tile, pages, btb, t0, nt, page, C);
    for (int i = tid; i < HB * TT; i += THREADS) {
      const int h = i / TT, tt = i % TT;
      sp[i] = h < nh && tt < nt ? (double)wsb[(size_t)h * Tv + t0 + tt]
                                : 0.0;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tid + THREADS * j;
        if (c >= r) break;
        const double v = (double)__bfloat162float(tile[(size_t)tt * C + c]);
#pragma unroll
        for (int h = 0; h < HB; ++h) acc[h][j] += sp[h * TT + tt] * v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + THREADS * j;
    if (c >= r) break;
#pragma unroll
    for (int h = 0; h < HB; ++h)
      if (h < nh)
        outb[(size_t)h * r + c] =
            __fdiv_rn((float)acc[h][j], fmaxf((float)sl[h], 1e-30f));
  }
}

template <int NC>
int launch_attention(const void* q, const void* pages, const void* bt,
                     const void* lengths, void* out, void* ws, int B, int H,
                     int page, int PMAX, int C, int r, float scale,
                     cudaStream_t s) {
  const size_t smem = sizeof(double) * ((size_t)HB * C + HB * TT) +
      sizeof(__nv_bfloat16) * (size_t)TT * C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_latent_attention_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((H + HB - 1) / HB, B);
  paged_latent_attention_kernel<NC><<<grid, THREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)pages, (const int*)bt,
      (const int*)lengths, (float*)out, (float*)ws, H, page, PMAX, C, r,
      scale);
  return (int)cudaGetLastError();
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
// [B, PMAX]; lengths int32 [B]; out f32 [B, H, r]; ws f32
// [B, H, PMAX * page] scratch for the score rows. 1 <= r <= C <= 1024,
// r <= 1024.
NCTT_API int nctt_paged_latent_attention(const void* q, const void* pages,
                                         const void* bt, const void* lengths,
                                         void* out, void* ws, int B, int H,
                                         int P, int page, int PMAX, int C,
                                         int r, float scale, void* stream) {
  (void)P;
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || H < 1 || page < 1 || PMAX < 1 || r < 1 || r > C ||
      C > 32 * MAX_CPL)
    return (int)cudaErrorInvalidValue;
  const int nc = (r + THREADS - 1) / THREADS;
  switch (nc) {
    case 1: return launch_attention<1>(q, pages, bt, lengths, out, ws, B, H,
                                       page, PMAX, C, r, scale, s);
    case 2: return launch_attention<2>(q, pages, bt, lengths, out, ws, B, H,
                                       page, PMAX, C, r, scale, s);
    case 3:
    case 4: return launch_attention<4>(q, pages, bt, lengths, out, ws, B, H,
                                       page, PMAX, C, r, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
