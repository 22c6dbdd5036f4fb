// Decode attention over a paged KV pool, one query a slot or a causal
// window of W queries a slot (a speculative verify window): bf16 rows, int8
// or fp8-e4m3 codes with per-(token, head) float32 scales, or int4
// token-half-split nibbles with per-(token, head) affine scale and offset.
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_attn_impl_v2 / _paged_kernel_v2 (K11), bf16, int8, fp8 and int4
//   pools, single-query (wq == 1) and the W-query window (wq > 1,
//   paged_window_attention), with gemma's sliding band (`window`) and
//   attention-logit softcap (`softcap`) branches.
//
// Semantics (as K11): q [B, H, W, D]; pools [P, Hkv, page, D] (int4:
//   [P, Hkv, page/2, D] bytes, token r in the low nibble of byte row r and
//   token r + page/2 in the high, value = scale * (nibble - 8) + off);
//   scales and offsets [P, Hkv, page]; block_tables int32 [B, PMAX] map a
//   slot's logical page j to a pool page; lengths int32 [B] count the
//   slot's rows, the new ones included (written before the launch by
//   paged_write.cu). Row t of slot b is row t % page of pool page
//   block_tables[b, t / page]. Query rows pack (w, rep) as K11 packs them:
//   window row w sits at position lengths[b] - W + w and attends keys
//   t <= that position (W = 1: t < lengths[b]), at most PMAX*page keys.
//   Scores s = f32(q . k) [* k_scale] [+ f32(sum q) * k_off] * 1/sqrt(D)
//   (float32 operations in K11's order, none fused), then with a softcap
//   s = cap * f32(tanh(s * f32(1/cap))) (tanh in float64, rounded once),
//   BEFORE the mask; with a window (band) only keys with q_pos - t <
//   window attend, i.e. t >= q_pos - window + 1; m = the row's maximum
//   over all its keys; p = exp(s - m) [* v_scale], rounded to bf16 for
//   the PV product; l = sum exp(s - m) unrounded; int4 adds corr =
//   sum_t f32(exp(s - m)) * v_off[t] to the PV sum in float32; out = acc
//   / max(l, 1e-30). A slot of length 0, and a window row with no key,
//   give exact zeros.
//
// Bound on this card: bytes. Each visited row is read once: 2*Hkv*len*D
//   code bytes (x2 for bf16, /2 for int4) plus 2*Hkv*len*4 scale bytes
//   (x2 with int4 offsets) per slot; the design adds 4 bytes a (query
//   row, key) of float32 scores, written by launch A and read by launch B
//   (through L2 at the engine's sizes).
//
// Design: two launches over a fixed plan of key parts. It answers the four
//   causes that held the one-launch kernel back (one block a slot walking
//   the whole context; one row in flight a warp; a shuffle reduction a key
//   and row; three passes over the score rows in device memory).
//   * Parts. A slot's key axis is cut into parts of a fixed number of
//     whole pages (kernels/paged_attention.py split_plan: 512 keys at
//     128-row pages, the 4-page group JAX's kernel stages). Part
//     boundaries are absolute key positions, a function of the page size
//     alone. The W*rep query rows of a (slot, KV head) split into ng
//     balanced groups of at most 8 (as before). Both launches have one
//     block per (part, KV head x group, slot), grid (parts, Hkv*ng, B); a
//     block whose part holds no key of its group's rows (past the longest
//     row, or before the lowest band start) exits at once, so the work of
//     a launch follows the keys its rows attend and a long slot spreads
//     over many SMs, where one block used to walk a whole slot (64 blocks
//     for gemma2-9b's 8 slots on 132 SMs, the longest slot setting the
//     time).
//   * Staging. A block walks its part in tiles of 64 key slots (64 rows
//     of one page, or 32 int4 byte rows holding 64 tokens), never across
//     a page, so a tile is one contiguous slab of the pool (the part's
//     page ids are read once into shared memory). Every thread issues
//     16-byte cp.async copies of the slab into a ring of 3-6 tiles in
//     shared memory (as many as ~72 KB hold; 3 where D is known only at
//     run time), all but one in flight while one is used; where a row is
//     not a whole number of 16-byte chunks, or a pool is not 16-byte
//     aligned, scalar loads fill the tile and zero its tail. Staged rows
//     are padded to an odd number of 16-byte chunks, so the 16-byte reads
//     of eight consecutive rows hit all 32 banks once.
//   * Launch A: scores and part maxima. Thread (key pair, segment h) sums
//     one D segment (D split into blockDim/32 fixed segments) of q . k for
//     keys kp and kp + 32 of the tile (int4: both nibbles of byte row kp)
//     and every row of its group in float64, elements in ascending order:
//     each key element is converted once and reused across the group's
//     rows, and each q element loaded from shared memory serves two keys
//     (every float64 product takes a shared-memory operand); segments add
//     in ascending order. No shuffle a key. Conversions to float64 are
//     exact bit moves (bf16 and e4m3 bits placed under a double's exponent
//     and rebiased by a power of two; int8 and int4 codes by the 2^52
//     magic number), which
//     Hopper issues at the float64 rate, where its float-to-double
//     conversion runs at a quarter of it. A key's scale and offset are
//     fetched before its dot products. Scale, offset, 1/sqrt(D) and
//     softcap as above; the score goes to the float32 workspace, each
//     row's maximum over the part to maxima [B, Hkv, rows, parts].
//   * Launch B: probabilities, PV partials and the fold. A block reads
//     its rows' global maximum over the parts that hold their keys, stages
//     the V tiles the same way, forms p, exp and corr for (row, slot)
//     pairs from scores and v scales fetched one tile ahead, sums exp and
//     corr per tile by a fixed butterfly over 32 slots and adds tile sums
//     in ascending order. Thread (column pair, slot half) owns columns d
//     and d + ceil(D/2) of every row and sums p * v in float64 over its
//     half of each tile's slots (int4: one nibble) in ascending order,
//     eight slots at a time with their loads ahead of the products and no
//     branch between them, each p loaded serving two columns; the first
//     half's sum plus the second's, exchanged through the free ring, is
//     the part's. Partials go to a float64 [B, Hkv, rows, parts, D + 2]
//     workspace (acc, then l and corr). The last block of a (slot, KV
//     head, group), by an atomic ticket taken after __threadfence(), folds
//     the parts in ascending order, adds corr, divides by max(l, 1e-30),
//     writes bf16 and resets its ticket to 0, so the tickets stay zeroed
//     without a memset launch. A part with no key of a row adds exact
//     zeros for it; a group with no key at all has its part-0 block write
//     zeros.
//   * Compile-time copies: D 32, 64, 128 and 256 (nctt::full_width's
//     widths), any other D at run time; at D 128 and 256 groups of 1 and 2
//     rows (single queries at rep 1 and 2) also fix the row count, so the
//     row loops carry no branch (more rows keep one branch a row: padding
//     a window's 5-row groups to 8 measured slower).
//   * Numerics. Sums run in float64 over exact products (bf16 x bf16,
//     int8, e4m3 or a nibble) and are rounded once, so the kernel and its
//     plain version (kernels/paged_attention.py) agree bit for bit but
//     where a float64 sum's order tips a rounding. Every order a row's
//     terms are summed in (D segments, slot halves within a tile, tiles
//     within a part, parts within the fold) is a function of D, the page
//     size and the absolute key index alone,
//     never of W, rep, B, the lengths or the band, and a term outside a
//     row's keys is an exact zero; so window row w equals the single query
//     at length lengths[b] - W + w + 1 bit for bit. The maximum is global
//     (over all parts) before p is rounded, as in the one-pass softmax: a
//     flash-decoding fold of per-part maxima would round p elsewhere. The
//     float64 sums stay because they are what makes the kernel equal its
//     plain version and its window rows equal its single queries; a
//     float32 tensor-core sum would change the tolerances. Their work fits
//     under the byte bound (about 10 G multiply-adds for a 42-layer
//     gemma2-9b step against ~34 TFLOP/s float64), but not the issue rate
//     they take: a float64 product and a shared-memory operand for every
//     element and row set the pace where a group holds several rows (the
//     verify window, ~10x its byte bound).
//   * Idle engine slots have every block-table entry 0 (the trash page)
//     and a full length: they read page 0 again and again, which is valid
//     memory, and their output is never used.
//   * Workspaces (kernels/paged_attention.py split_workspace): scores
//     [B*Hkv, ng*gs, PMAX*page] float32 (decode_attention.score_workspace);
//     K11's own maxima, partials and int32 tickets [B*Hkv*ng], flat
//     buffers kept per device. At gemma2-9b's 8-slot step (8 KV heads, 2
//     rows, 8192-row contexts: 16 parts): scores 4 MiB, maxima 8 KiB,
//     partials 4.2 MB, tickets 256 bytes.
//   * The kernels live in paged_attention.cuh; this source instantiates
//     them for bf16 and int8 pools, paged_attention_fp8_int4.cu for fp8
//     and int4, so the build compiles the two in parallel.
#include "paged_attention.cuh"

using namespace nctt_k11;

int nctt_k11::dispatch_bf16_int8(int fmt, const Args& a, int B,
                                 cudaStream_t s) {
  return fmt == BF16 ? dispatch<BF16>(a, B, s) : dispatch<INT8>(a, B, s);
}

// q bf16 [B, H, W, D] (W = 1: single-token decode; W > 1: a speculative
// verify window, row w at position lengths[b] - W + w, causal); k/v pages
// [P, Hkv, page, D] bf16 (fmt 0), int8 (1) or e4m3 (2), or
// [P, Hkv, page/2, D] int4 bytes (3); k/v scales f32 [P, Hkv, page] (null
// for bf16); k/v offsets f32 [P, Hkv, page] (int4 only); block_tables
// int32 [B, PMAX]; lengths int32 [B] (the whole window included); out bf16
// [B, H, W, D]. The plan (kernels/paged_attention.py split_plan): ng groups
// of gs = ceil(W*H/Hkv / ng) query rows, parts of part_keys keys (whole
// pages), `parts` of them over PMAX pages. Workspaces: ws f32 [B, Hkv,
// ng*gs, PMAX*page] score rows; pmax f32 [B, Hkv, ng*gs, parts]; part f64
// [B, Hkv, ng*gs, parts, D + 2]; tickets int32 [B*Hkv*ng], zeroed (each
// launch leaves them zeroed). window > 0: the sliding band (keys with
// q_pos - t < window), 0: none; cap > 0: the logit softcap cap * tanh(s *
// inv_cap), 0: none. `page` counts tokens. 1 <= D <= 256; H % Hkv == 0.
// Two launches on `stream`.
NCTT_API int nctt_paged_decode_attention(
    const void* q, const void* kp, const void* ks, const void* ko,
    const void* vp, const void* vs, const void* vo, const void* bt,
    const void* lengths, void* out, void* ws, void* pmax, void* part,
    void* tickets, int B, int H, int Hkv, int W, int P, int page, int PMAX,
    int D, int fmt, int ng, int part_keys, int parts, float scale,
    int window, float cap, float inv_cap, void* stream) {
  (void)P;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv || ng < 1 || parts < 1 ||
      part_keys < 1 || part_keys % page || part_keys / page > MAX_PAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.kp = (const uint8_t*)kp;
  a.ks = (const float*)ks;
  a.ko = (const float*)ko;
  a.vp = (const uint8_t*)vp;
  a.vs = (const float*)vs;
  a.vo = (const float*)vo;
  a.bt = (const int*)bt;
  a.lengths = (const int*)lengths;
  a.out = (__nv_bfloat16*)out;
  a.ws = (float*)ws;
  a.pmax = (float*)pmax;
  a.part = (double*)part;
  a.tickets = (int*)tickets;
  a.H = H;
  a.Hkv = Hkv;
  a.W = W;
  a.page = page;
  a.PMAX = PMAX;
  a.D = D;
  a.ng = ng;
  a.part_keys = part_keys;
  a.parts = parts;
  a.window = window;
  a.scale = scale;
  a.cap = cap;
  a.inv_cap = inv_cap;
  const int rowbytes = fmt == BF16 ? 2 * D : D;
  a.vec = rowbytes % 16 == 0 && ((uintptr_t)kp & 15) == 0 &&
          ((uintptr_t)vp & 15) == 0;
  switch (fmt) {
    case BF16:
    case INT8: return dispatch_bf16_int8(fmt, a, B, s);
    case FP8:
    case INT4: return dispatch_fp8_int4(fmt, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
