// Batched single-token decode attention over an already-updated head-major
// KV cache, one position per slot: bf16 rows, or int8 / fp8-e4m3 codes with
// per-(token, head) float32 scales.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _batched_attn_impl / _kernel_batched (K7), bf16 caches and the quant
//   branch (int8 / fp8 codes).
//
// Semantics (as K7): q [B, H, D] against caches [B, Hkv, T, D] that already
//   hold each slot's new row at pos[b] (int32 [B], read here on the device:
//   no host sync per layer); scores s = f32(q . k) [* k_scale] * 1/sqrt(D)
//   (two float32 products, in K7's order); keys t > pos[b] masked out (a
//   slot at or past T - 1 attends every row: the engine parks its idle
//   slots on row T - 1 and lets them run on); p = exp(s - m) [* v_scale]
//   rounded to bf16 for the PV product; l = sum exp(s - m) unrounded; the
//   output is acc / l, normalised after PV as K7 does (K5 normalises
//   first); rep = H/Hkv query heads per KV head; bf16 output. Quantized
//   caches hold the slot's OWN quantized new row (the port writes its codes
//   before the launch, as JAX does at B > 1).
//
// Bound on this card: bytes. Each visited cache row is read once for
//   2*rep*D flops: 2*Hkv*(pos[b]+1)*D*2 bytes of K and V per slot for bf16,
//   2*Hkv*(pos[b]+1)*(D+4) for codes and scales.
//
// Design: one block per (slot, KV head, group of query rows), B*Hkv*ng
//   blocks (256 at B = 8 for llama2-7b, against K5's 32): the rep query
//   rows of a KV head split into ng = ceil(rep / 8) groups of at most
//   MAX_REP = 8 rows, as even as they go, along grid z, so the o[8][DPL]
//   accumulators a thread holds do not grow with rep; a group's rows share
//   every K and V row it reads. The block visits only rows
//   t <= min(pos[b], T-1). Warps take rows round-robin and lanes split D,
//   so each warp reads a whole row coalesced: a lane holds DPL =
//   ceil(D / 32) elements (DPL 1-8, 12 and 16: any D up to 256, and 384 and
//   512 as JAX's K7 runs them), the tail past D masked and loaded by
//   scalars (the widths 32 * DPL of DPL 1, 2, 4, 8, 12 and 16 have a
//   copy with D a compile-time constant, nctt::full_width); at D 512 a
//   group holds at most 6 rows, so that its cross-warp partials fit a
//   block's shared memory. Sums run in float64 over exact products (bf16 x
//   bf16, int8 or e4m3) and are rounded once, so their order almost never shows: the
//   kernel and its plain version (kernels/decode_attention.py) agree bit
//   for bit. The TPU kernel chunks T with an online softmax; one pass over
//   the visited rows gives its result where one chunk covers them. The
//   score rows live in a float32 workspace in device memory ([B, H, T],
//   allocated by the wrapper; they pass through L2), so shared memory does
//   not grow with T and any context length fits. A simple first kernel:
//   no split of T across blocks, no TMA.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

template <int DPL, bool FULL, typename C>
__global__ void __launch_bounds__(THREADS)
batched_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                const C* __restrict__ kc,
                                const C* __restrict__ vc,
                                const float* __restrict__ ks,
                                const float* __restrict__ vs,
                                const int* __restrict__ pos,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ ws, int H, int Hkv, int T,
                                int D_, float scale) {
  const int D = FULL ? DPL * 32 : D_;
  constexpr bool QUANT = !std::is_same<C, __nv_bfloat16>::value;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  const int L = (p < 0 ? 0 : (p > T - 1 ? T - 1 : p)) + 1;  // visited rows
  // this block's G query rows: group blockIdx.z of the rep rows
  const int gs = (rep + gridDim.z - 1) / gridDim.z;
  const int g0 = blockIdx.z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;  // first row
  double* sred = smem;                                // [WARPS][G][D]
  double* sl = sred + WARPS * gs * D;                 // [G]
  float* sq = reinterpret_cast<float*>(sl + gs);      // [G][D]
  float* sp = ws + q0 * T;                            // [G][T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * Hkv + hk;
  const C* kh = kc + bh * (size_t)T * D;
  const C* vh = vc + bh * (size_t)T * D;
  const float* ksh = QUANT ? ks + bh * (size_t)T : nullptr;
  const float* vsh = QUANT ? vs + bh * (size_t)T : nullptr;
  const __nv_bfloat16* qh = q + q0 * D;

  for (int i = tid; i < G * D; i += THREADS) sq[i] = __bfloat162float(qh[i]);
  __syncthreads();

  // pass 1: scores
  for (int t = warp; t < L; t += WARPS) {
    float kv[DPL];
    nctt::load_lane<DPL>(kh + (size_t)t * D, lane, D, kv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (FULL || lane * DPL + e < D)
          d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = nctt::warp_sum(d);
      if (lane == 0) {
        float s = (float)d;
        if constexpr (QUANT) s = s * ksh[t];
        sp[r * T + t] = s * scale;
      }
    }
  }
  __syncthreads();

  // softmax numerators per query row: p = bf16(f32(exp(s - m)) [* v_scale]),
  // l unrounded
  for (int r = warp; r < G; r += WARPS) {
    float* row = sp + r * T;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      l += e;
      float pe = (float)e;
      if constexpr (QUANT) pe = pe * vsh[t];
      row[t] = __bfloat162float(__float2bfloat16_rn(pe));
    }
    l = nctt::warp_sum(l);
    if (lane == 0) sl[r] = l;
  }
  __syncthreads();

  // pass 2: PV, each warp over its rows, then a cross-warp sum and /l
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int t = warp; t < L; t += WARPS) {
    float vv[DPL];
    nctt::load_lane<DPL>(vh + (size_t)t * D, lane, D, vv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      const double pr = sp[r * T + t];
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
        sred[(warp * G + r) * D + lane * DPL + e] = o[r][e];
  }
  __syncthreads();
  __nv_bfloat16* oh = out + q0 * D;
  for (int i = tid; i < G * D; i += THREADS) {
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) acc += sred[wi * G * D + i];
    oh[i] = __float2bfloat16_rn((float)acc / (float)sl[i / D]);
  }
}

template <int DPL, bool FULL, typename C>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, void* ws, int B, int H,
           int Hkv, int T, int D, float scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  // rows of a group: at most MAX_REP, fewer where a group's shared memory
  // would pass a block's 227 KiB (D 512: 6 rows)
  const size_t per_row = sizeof(double) * ((size_t)WARPS * D + 1) +
      sizeof(float) * (size_t)D;
  const int fit = (int)((227 * 1024) / per_row);
  const int gmax = fit < MAX_REP ? fit : MAX_REP;
  const int ng = (rep + gmax - 1) / gmax;             // groups of rows
  const int gs = (rep + ng - 1) / ng;
  const size_t smem = per_row * gs;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_decode_attention_kernel<DPL, FULL, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  batched_decode_attention_kernel<DPL, FULL, C><<<dim3(Hkv, B, ng), THREADS, smem,
                                            stream>>>(
      (const __nv_bfloat16*)q, (const C*)k, (const C*)v, (const float*)ks,
      (const float*)vs, (const int*)pos, (__nv_bfloat16*)out, (float*)ws, H,
      Hkv, T, D, scale);
  return (int)cudaGetLastError();
}

template <typename C>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* ws, int B,
             int H, int Hkv, int T, int D, float scale, cudaStream_t s) {
#define NCTT_K7(DPL_)                                                      \
  case DPL_:                                                               \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                        \
               ? launch<DPL_, nctt::full_width(DPL_), C>(                   \
                     q, k, v, ks, vs, pos, out, ws, B, H, Hkv, T, D, scale, \
                     s)                                                    \
               : launch<DPL_, false, C>(q, k, v, ks, vs, pos, out, ws, B,   \
                                        H, Hkv, T, D, scale, s);
  // DPL = ceil(D / 32): any D up to 256, and 384 and 512 (JAX's K7
  // dispatch runs D % 128 == 0)
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K7(1) NCTT_K7(2) NCTT_K7(3) NCTT_K7(4)
    NCTT_K7(5) NCTT_K7(6) NCTT_K7(7) NCTT_K7(8)
    NCTT_K7(12) NCTT_K7(16)
#undef NCTT_K7
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q bf16 [B, H, D]; caches [B, Hkv, T, D] holding each slot's row pos[b]:
// bf16 (code 0; ks/vs null), int8 (code 1) or e4m3 (code 2) with scales
// f32 [B, Hkv, T]; pos int32 [B]; out bf16 [B, H, D]; ws f32 [B, H, T]
// scratch for the score rows. 1 <= D <= 256, or D = 352..384 or
// 480..512 (DPL 12 and 16); H % Hkv == 0.
NCTT_API int nctt_batched_decode_attention(const void* q, const void* k,
                                           const void* v, const void* ks,
                                           const void* vs, const void* pos,
                                           void* out, void* ws, int B, int H,
                                           int Hkv, int T, int D, int code,
                                           float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0: return dispatch<__nv_bfloat16>(q, k, v, ks, vs, pos, out, ws, B,
                                           H, Hkv, T, D, scale, s);
    case 1: return dispatch<int8_t>(q, k, v, ks, vs, pos, out, ws, B, H, Hkv,
                                    T, D, scale, s);
    case 2: return dispatch<nctt::fp8e4m3>(q, k, v, ks, vs, pos, out, ws, B,
                                           H, Hkv, T, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
