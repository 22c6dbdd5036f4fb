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
//   window attend, i.e. t >= q_pos - window + 1; p = exp(s - m)
//   [* v_scale], rounded to bf16 for the PV product; l = sum exp(s - m)
//   unrounded; int4 adds corr = sum_t f32(exp(s - m)) * v_off[t] to the PV
//   sum in float32; out = acc / max(l, 1e-30). A slot of length 0, and a
//   window row with no key, give exact zeros.
//
// Bound on this card: bytes. Each visited row is read once: 2*Hkv*len*D
//   code bytes (x2 for bf16, /2 for int4) plus 2*Hkv*len*4 scale bytes
//   (x2 with int4 offsets) per slot.
//
// Design: one block per (slot, KV head, group of query rows). The W*rep
//   query rows of a (slot, KV head) split into ng = ceil(W*rep / 8) groups
//   of at most MAX_REP = 8 rows, as even as they go (a window of 9 rows at
//   rep 1 is 5 + 4, at rep 4 36 rows are 5 groups of 8 and 4), each group
//   a block that reads the slot's K/V rows again, so the registers a
//   thread holds (o[8][DPL] doubles) do not grow with W or rep. Single
//   queries (rep <= 8) are one group. A group walks the slot's block
//   table from its rows' lowest band start (0 without a window; a band
//   slot starts its key loop at max(0, q_pos - window + 1), so its reads
//   do not grow with the context) up to its longest row: warps take keys
//   round-robin, lanes split D (DPL = ceil(D / 32) elements a lane, 1-8:
//   any D up to 256, the tail past D masked and loaded by scalars, with a
//   compile-time-D copy for 32, 64, 128 and 256, nctt::full_width; an int4
//   lane loads its DPL bytes of the token's byte row and keeps one nibble
//   of each), and a row skips the
//   keys outside its own band and causal limit. The score
//   rows live in a float32 workspace in device memory
//   ([B, Hkv, ng * gs, PMAX*page], allocated by the wrapper; they
//   pass through L2), so shared memory holds only the q rows and the
//   cross-warp partials and any context length fits. Idle engine slots
//   have every block-table entry 0 (the trash page) and a full length:
//   they read page 0 again and again, which is valid memory, and their
//   output is never used. Sums run in float64 over exact products (bf16 x
//   bf16, int8, e4m3 or a nibble) and are rounded once, so the kernel and
//   its plain version (kernels/paged_attention.py) agree bit for bit, and
//   window row w equals the single query at length lengths[b] - W + w + 1
//   bit for bit (the same keys in the same order). The TPU kernel's online
//   softmax over 4-page groups equals this one pass where one group covers
//   the visited pages. A simple first kernel: no split of the keys across
//   blocks, no TMA or cp.async.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

// pool formats, as kernels/paged_attention.py numbers them
constexpr int BF16 = 0, INT8 = 1, FP8 = 2, INT4 = 3;

template <int FMT>
struct Code;
template <> struct Code<BF16> { using T = __nv_bfloat16; };
template <> struct Code<INT8> { using T = int8_t; };
template <> struct Code<FP8> { using T = nctt::fp8e4m3; };
template <> struct Code<INT4> { using T = uint8_t; };

// lane's DPL elements of row r of pool page `pid` (head hk) as float
// (elements lane*DPL + e; zero past D)
template <int DPL, int FMT>
__device__ __forceinline__ void load_page_row(const void* pages, int pid,
                                              int hk, int Hkv, int page,
                                              int r, int lane, int D,
                                              float (&out)[DPL]) {
  using C = typename Code<FMT>::T;
  if constexpr (FMT == INT4) {
    const int half = page >> 1;
    const size_t brow = ((size_t)pid * Hkv + hk) * half + r % half;
    const uint8_t* p = reinterpret_cast<const uint8_t*>(pages) + brow * D +
        lane * DPL;
    uint8_t b[DPL];
    if (D == 32 * DPL) {
      nctt::load_bytes<DPL>(p, b);
    } else {  // a masked tail: scalar loads
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        b[e] = lane * DPL + e < D ? p[e] : (uint8_t)0x88;  // code 0
    }
    const bool hi = r >= half;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      out[e] = (float)((int)(hi ? b[e] >> 4 : b[e] & 15) - 8);
  } else {
    const size_t row = ((size_t)pid * Hkv + hk) * page + r;
    nctt::load_lane<DPL>(reinterpret_cast<const C*>(pages) + row * D, lane,
                         D, out);
  }
}

// rows of query row i of a block: window row w = i / rep sits at position
// n - W + w and attends keys t <= that position, i.e. t < n - W + w + 1
// (W = 1: the single query at n - 1 attends n rows), at most Tv rows
__device__ __forceinline__ int row_len(int n, int W, int rep, int i,
                                       int Tv) {
  const int l = n - W + i / rep + 1;
  return l < 0 ? 0 : (l > Tv ? Tv : l);
}

// the first key of query row i: with a band (window > 0) only keys t with
// q_pos - t < window attend, t >= q_pos - window + 1; else key 0
__device__ __forceinline__ int row_lo(int n, int W, int rep, int i,
                                      int window) {
  if (window <= 0) return 0;
  const int lo = n - W + i / rep - window + 1;
  return lo < 0 ? 0 : lo;
}

template <int DPL, bool FULL, int FMT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ kp,
                       const float* __restrict__ ks,
                       const float* __restrict__ ko,
                       const void* __restrict__ vp,
                       const float* __restrict__ vs,
                       const float* __restrict__ vo,
                       const int* __restrict__ bt,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ ws, int H, int Hkv, int W,
                       int page, int PMAX, int D_, float scale, int window,
                       float cap, float inv_cap) {
  const int D = FULL ? DPL * 32 : D_;
  constexpr bool QUANT = FMT != BF16;
  constexpr bool AFFINE = FMT == INT4;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int rows = W * rep;                           // query rows (w, r)
  const int ng = gridDim.z;                           // groups of rows
  const int gs = (rows + ng - 1) / ng;                // rows of a group
  const int Tv = PMAX * page;                         // visitable rows
  const int hk = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int n = lengths[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double* sred = smem;                                // [WARPS][gs][D]
  double* sl = sred + WARPS * gs * D;                 // [gs]
  double* scorr = sl + gs;                            // [gs] (int4)
  float* sq = reinterpret_cast<float*>(scorr + gs);   // [gs][D]
  float* sqsum = sq + gs * D;                         // [gs] (int4)
  // the group's score rows, in device memory: [gs][Tv]
  float* sp = ws + (((size_t)b * Hkv + hk) * ng + g) * gs * (size_t)Tv;
  const int* btb = bt + (size_t)b * PMAX;
  // query row i = (w, r) is q[b, hk*rep + r, w] and out[b, hk*rep + r, w]
  auto qoff = [&](int i) {
    return (((size_t)b * H + (size_t)hk * rep + i % rep) * W + i / rep) * D;
  };

  const int g0 = g * gs;
  const int G = rows - g0 < gs ? rows - g0 : gs;
  if (G <= 0) return;
  int Lmax = 0, tlo = Tv;
  for (int r = 0; r < G; ++r) {
    const int l = row_len(n, W, rep, g0 + r, Tv);
    const int lo = row_lo(n, W, rep, g0 + r, window);
    Lmax = l > Lmax ? l : Lmax;
    tlo = lo < tlo ? lo : tlo;
  }
  if (n <= 0 || Lmax == 0) {
    for (int i = tid; i < G * D; i += THREADS)
      out[qoff(g0 + i / D) + i % D] = __float2bfloat16_rn(0.0f);
    return;
  }
  for (int i = tid; i < G * D; i += THREADS)
    sq[i] = __bfloat162float(q[qoff(g0 + i / D) + i % D]);
  __syncthreads();
  if constexpr (AFFINE) {
    // sum of each query row, for the rank-1 offset term of the scores
    for (int r = warp; r < G; r += WARPS) {
      double qs = 0.0;
      for (int d = lane; d < D; d += 32) qs += (double)sq[r * D + d];
      qs = nctt::warp_sum(qs);
      if (lane == 0) sqsum[r] = (float)qs;
    }
    __syncthreads();
  }

  // pass 1: scores of the rows that attend key t
  for (int t = tlo + warp; t < Lmax; t += WARPS) {
    const int pid = btb[t / page], rr = t % page;
    const size_t sidx = ((size_t)pid * Hkv + hk) * page + rr;
    float kv[DPL];
    load_page_row<DPL, FMT>(kp, pid, hk, Hkv, page, rr, lane, D, kv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      if (t >= row_len(n, W, rep, g0 + r, Tv) ||
          t < row_lo(n, W, rep, g0 + r, window))
        continue;  // warp-uniform
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (FULL || lane * DPL + e < D)
          d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = nctt::warp_sum(d);
      if (lane == 0) {
        float s = (float)d;
        if constexpr (QUANT) s = __fmul_rn(s, ks[sidx]);
        if constexpr (AFFINE)
          s = __fadd_rn(s, __fmul_rn(sqsum[r], ko[sidx]));
        s = __fmul_rn(s, scale);
        if (cap > 0.f)  // gemma's logit softcap, before the mask
          s = __fmul_rn(cap, (float)tanh((double)__fmul_rn(s, inv_cap)));
        sp[(size_t)r * Tv + t] = s;
      }
    }
  }
  __syncthreads();

  // softmax numerators: p = bf16(f32(exp(s - m)) [* v_scale]), l
  // unrounded; int4: corr = sum f32(exp(s - m)) * v_off
  for (int r = warp; r < G; r += WARPS) {
    const int L = row_len(n, W, rep, g0 + r, Tv);
    const int lo = row_lo(n, W, rep, g0 + r, window);
    float* row = sp + (size_t)r * Tv;
    float m = -INFINITY;
    for (int t = lo + lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0, corr = 0.0;
    for (int t = lo + lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      l += e;
      float pe = (float)e;
      if constexpr (QUANT) {
        const size_t sidx = ((size_t)btb[t / page] * Hkv + hk) * page +
            t % page;
        if constexpr (AFFINE) corr += (double)pe * (double)vo[sidx];
        pe = __fmul_rn(pe, vs[sidx]);
      }
      row[t] = __bfloat162float(__float2bfloat16_rn(pe));
    }
    l = nctt::warp_sum(l);
    if constexpr (AFFINE) corr = nctt::warp_sum(corr);
    if (lane == 0) {
      sl[r] = l;
      scorr[r] = corr;
    }
  }
  __syncthreads();

  // pass 2: PV, each warp over its keys, then a cross-warp sum, + corr,
  // / l
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int t = tlo + warp; t < Lmax; t += WARPS) {
    float vv[DPL];
    load_page_row<DPL, FMT>(vp, btb[t / page], hk, Hkv, page, t % page,
                            lane, D, vv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      if (t >= row_len(n, W, rep, g0 + r, Tv) ||
          t < row_lo(n, W, rep, g0 + r, window))
        continue;  // warp-uniform
      const double pr = sp[(size_t)r * Tv + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] += pr * (double)vv[e];
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= G) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (FULL || lane * DPL + e < D)
        sred[(warp * gs + r) * D + lane * DPL + e] = o[r][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int r = i / D;
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) acc += sred[(wi * gs + r) * D + i % D];
    float a = (float)acc;
    if constexpr (AFFINE) a = __fadd_rn(a, (float)scorr[r]);
    out[qoff(g0 + r) + i % D] = __float2bfloat16_rn(
        __fdiv_rn(a, fmaxf((float)sl[r], 1e-30f)));
  }
}

template <int DPL, bool FULL, int FMT>
int launch(const void* q, const void* kp, const void* ks, const void* ko,
           const void* vp, const void* vs, const void* vo, const void* bt,
           const void* lengths, void* out, void* ws, int B, int H, int Hkv,
           int W, int page, int PMAX, int D, float scale, int window,
           float cap, float inv_cap, cudaStream_t stream) {
  const int rows = W * (H / Hkv);
  const int ng = (rows + MAX_REP - 1) / MAX_REP;      // groups of rows
  const int gs = (rows + ng - 1) / ng;
  const size_t smem = sizeof(double) * ((size_t)WARPS * gs * D + 2 * gs) +
      sizeof(float) * ((size_t)gs * D + gs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<DPL, FULL, FMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<DPL, FULL, FMT><<<dim3(Hkv, B, ng), THREADS, smem,
                                     stream>>>(
      (const __nv_bfloat16*)q, kp, (const float*)ks, (const float*)ko, vp,
      (const float*)vs, (const float*)vo, (const int*)bt, (const int*)lengths,
      (__nv_bfloat16*)out, (float*)ws, H, Hkv, W, page, PMAX, D, scale,
      window, cap, inv_cap);
  return (int)cudaGetLastError();
}

template <int FMT>
int dispatch(const void* q, const void* kp, const void* ks, const void* ko,
             const void* vp, const void* vs, const void* vo, const void* bt,
             const void* lengths, void* out, void* ws, int B, int H, int Hkv,
             int W, int page, int PMAX, int D, float scale, int window,
             float cap, float inv_cap, cudaStream_t s) {
#define NCTT_K11(DPL_)                                                      \
  case DPL_:                                                                \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                         \
               ? launch<DPL_, nctt::full_width(DPL_), FMT>(                  \
                     q, kp, ks, ko, vp, vs, vo, bt, lengths, out, ws, B, H,  \
                     Hkv, W, page, PMAX, D, scale, window, cap, inv_cap, s)  \
               : launch<DPL_, false, FMT>(q, kp, ks, ko, vp, vs, vo, bt,     \
                                          lengths, out, ws, B, H, Hkv, W,    \
                                          page, PMAX, D, scale, window, cap, \
                                          inv_cap, s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K11(1) NCTT_K11(2) NCTT_K11(3) NCTT_K11(4)
    NCTT_K11(5) NCTT_K11(6) NCTT_K11(7) NCTT_K11(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NCTT_K11
}

}  // namespace

// q bf16 [B, H, W, D] (W = 1: single-token decode; W > 1: a speculative
// verify window, row w at position lengths[b] - W + w, causal); k/v pages
// [P, Hkv, page, D] bf16 (fmt 0), int8 (1) or e4m3 (2), or
// [P, Hkv, page/2, D] int4 bytes (3); k/v scales f32 [P, Hkv, page] (null
// for bf16); k/v offsets f32 [P, Hkv, page] (int4 only); block_tables
// int32 [B, PMAX]; lengths int32 [B] (the whole window included); out bf16
// [B, H, W, D]; ws f32 [B, Hkv, ng * gs, PMAX*page] scratch for the score
// rows, ng = ceil(W*H/Hkv / 8) groups of gs = ceil(W*H/Hkv / ng) rows;
// window > 0: the sliding band (keys with q_pos - t < window), 0: none;
// cap > 0: the logit softcap cap * tanh(s * inv_cap), 0: none. `page`
// counts tokens. 1 <= D <= 256; H % Hkv == 0.
NCTT_API int nctt_paged_decode_attention(const void* q, const void* kp,
                                         const void* ks, const void* ko,
                                         const void* vp, const void* vs,
                                         const void* vo, const void* bt,
                                         const void* lengths, void* out,
                                         void* ws, int B, int H, int Hkv,
                                         int W, int P, int page, int PMAX,
                                         int D, int fmt, float scale,
                                         int window, float cap,
                                         float inv_cap, void* stream) {
  (void)P;
  cudaStream_t s = (cudaStream_t)stream;
#define NCTT_FMT(F_)                                                       \
  dispatch<F_>(q, kp, ks, ko, vp, vs, vo, bt, lengths, out, ws, B, H, Hkv, \
               W, page, PMAX, D, scale, window, cap, inv_cap, s)
  switch (fmt) {
    case BF16: return NCTT_FMT(BF16);
    case INT8: return NCTT_FMT(INT8);
    case FP8: return NCTT_FMT(FP8);
    case INT4: return NCTT_FMT(INT4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NCTT_FMT
}
