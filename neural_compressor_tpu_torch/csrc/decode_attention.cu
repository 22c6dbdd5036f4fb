// B = 1 single-token decode attention over a head-major KV cache: bf16 rows
// (K5), or int8 / fp8-e4m3 codes with per-(token, head) float32 scales (K6).
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _decode_attn_ro_impl / _kernel_ro (K5), and
//   _decode_attn_quant_ro_impl / _kernel_q_ro (K6).
//
// Semantics (as K5): q [B, H, D] against caches [B, Hkv, T, D] that already
//   hold the new row at `pos` (the port writes it in place before the
//   launch; K5 folds the same bf16 row in by a select); float32 scores times
//   1/sqrt(D); keys t > pos masked out; softmax; probabilities cast to bf16
//   before the PV product; float32 accumulation; rep = H/Hkv query heads per
//   KV head; bf16 output.
// Semantics (as K6): the same over codes, with the RAW bf16 new row
//   (k_new, v_new [B, Hkv, D]) at `pos` and scale 1 there, whatever the
//   cache holds at pos (the port writes the row's codes after the launch);
//   pos is read on the device, and at pos >= T every code row is attended
//   and no raw row is folded in, as the TPU kernel's mask leaves them:
//   s = f32(q . k) * f32(k_scale * 1/sqrt(D)); p = f32(exp(s - m) / l) *
//   v_scale, rounded to bf16 for PV. int8 and e4m3 codes convert to float
//   exactly (e4m3 through Hopper's conversion to half).
//
// Bound on this card: bytes. Each visited cache row is read once for
//   2*rep*D flops: 2*Hkv*(pos+1)*D*2 bytes of K and V per layer for bf16,
//   2*Hkv*min(pos+1, T)*(D+4) for codes and scales.
//
// Design: one block per (batch, KV head, group of query rows): the rep
//   query rows of a KV head split into ng = ceil(rep / 8) groups of at most
//   MAX_REP = 8 rows, as even as they go, along grid z (rep 16: 2 x 8), so
//   the o[8][DPL] accumulators a thread holds do not grow with rep; a
//   group's rows share every K and V row it reads (rep <= 8: one group).
//   The block visits only rows t <= pos (the -1e30 mask makes the others
//   contribute exactly 0). Warps take rows round-robin and
//   lanes split D, so each warp reads a whole row coalesced: a lane holds
//   DPL = ceil(D / 32) elements (DPL 1-8, any D up to 256), the tail past
//   D masked and loaded by scalars (the widths 32, 64, 128 and 256 have a
//   copy with D a compile-time constant, nctt::full_width). Sums run in
//   float64 over exact products and are rounded once, so their order
//   almost never shows: the kernel and its plain version
//   (kernels/decode_attention.py) agree bit for bit, and an int8
//   activation quantization downstream sees the same values on the card
//   and on the CPU. In order: scores into shared memory; per query row
//   l = sum exp(f64(s) - m); p = bf16(f32(e / l) [* v_scale]);
//   o = bf16(f32(sum p*v)) with a cross-warp sum in shared memory. The
//   score rows live in a float32 workspace in device memory ([B, H, T],
//   allocated by the wrapper; they pass through L2), so shared memory does
//   not grow with T and any context length fits. A simple first kernel:
//   only Hkv*B*ng blocks, no split of T across blocks.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

template <int DPL, bool FULL>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int H, int Hkv, int T,
                        int D_, int pos, float scale) {
  const int D = FULL ? DPL * 32 : D_;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int L = pos + 1;                              // visited rows
  const int hk = blockIdx.x, b = blockIdx.y;
  // this block's G query rows: group blockIdx.z of the rep rows
  const int gs = (rep + gridDim.z - 1) / gridDim.z;
  const int g0 = blockIdx.z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;  // first row
  double* sred = smem;                                // [WARPS][G][D]
  float* sq = reinterpret_cast<float*>(sred + WARPS * gs * D);  // [G][D]

  float* sp = ws + q0 * T;                            // [G][T]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head = ((size_t)b * Hkv + hk) * (size_t)T * D;
  const __nv_bfloat16* kh = kc + head;
  const __nv_bfloat16* vh = vc + head;
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
      if (lane == 0) sp[r * T + t] = (float)d * scale;
    }
  }
  __syncthreads();

  // softmax per query row; p is rounded to bf16 as K5 casts it for PV
  for (int r = warp; r < G; r += WARPS) {
    float* row = sp + r * T;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) l += exp((double)row[t] - (double)m);
    l = nctt::warp_sum(l);
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      row[t] = __bfloat162float(__float2bfloat16_rn((float)(e / l)));
    }
  }
  __syncthreads();

  // pass 2: PV, each warp over its rows, then a cross-warp sum
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
      const double p = sp[r * T + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] += p * (double)vv[e];
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
    oh[i] = __float2bfloat16_rn((float)acc);
  }
}

template <int DPL, bool FULL>
int launch(const void* q, const void* k, const void* v, void* out, void* ws,
           int B, int H, int Hkv, int T, int D, int pos, float scale,
           cudaStream_t stream) {
  const int rep = H / Hkv;
  const int ng = (rep + MAX_REP - 1) / MAX_REP;       // groups of rows
  const int gs = (rep + ng - 1) / ng;
  const size_t smem = sizeof(double) * (size_t)WARPS * gs * D +
      sizeof(float) * (size_t)gs * D;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<DPL, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_kernel<DPL, FULL><<<dim3(Hkv, B, ng), THREADS, smem,
                                 stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)ws, H, Hkv, T, D,
      pos, scale);
  return (int)cudaGetLastError();
}

// K6: the same walk over int8 / e4m3 codes (C), the raw new row at pos
template <int DPL, bool FULL, typename C>
__global__ void __launch_bounds__(THREADS)
decode_attention_quant_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ kn,
                              const __nv_bfloat16* __restrict__ vn,
                              const C* __restrict__ kc,
                              const float* __restrict__ ks,
                              const C* __restrict__ vc,
                              const float* __restrict__ vs,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ ws, int H, int Hkv, int T,
                              int D_, const int* __restrict__ pos_b,
                              float scale) {
  const int D = FULL ? DPL * 32 : D_;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  // pos at or past T: every code row, no raw row (JAX's mask keeps all T)
  const int pos = pos_b[b];
  const int L = min(max(pos, 0), T - 1) + 1;          // visited rows
  // this block's G query rows: group blockIdx.z of the rep rows
  const int gs = (rep + gridDim.z - 1) / gridDim.z;
  const int g0 = blockIdx.z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;  // first row
  double* sred = smem;                                // [WARPS][G][D]
  float* sq = reinterpret_cast<float*>(sred + WARPS * gs * D);  // [G][D]
  float* sp = ws + q0 * T;                            // [G][T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * Hkv + hk;
  const C* kh = kc + bh * (size_t)T * D;
  const C* vh = vc + bh * (size_t)T * D;
  const float* ksh = ks + bh * (size_t)T;
  const float* vsh = vs + bh * (size_t)T;
  const __nv_bfloat16* knh = kn + bh * D;
  const __nv_bfloat16* vnh = vn + bh * D;
  const __nv_bfloat16* qh = q + q0 * D;

  for (int i = tid; i < G * D; i += THREADS) sq[i] = __bfloat162float(qh[i]);
  __syncthreads();

  // pass 1: scores, s = f32(q . k) * f32(k_scale * scale)
  for (int t = warp; t < L; t += WARPS) {
    float kv[DPL];
    if (t == pos)
      nctt::load_lane<DPL>(knh, lane, D, kv);
    else
      nctt::load_lane<DPL>(kh + (size_t)t * D, lane, D, kv);
    const float ksc = (t == pos ? 1.0f : ksh[t]) * scale;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (FULL || lane * DPL + e < D)
          d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = nctt::warp_sum(d);
      if (lane == 0) sp[r * T + t] = (float)d * ksc;
    }
  }
  __syncthreads();

  // softmax per query row; p = bf16(f32(e / l) * v_scale)
  for (int r = warp; r < G; r += WARPS) {
    float* row = sp + r * T;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) l += exp((double)row[t] - (double)m);
    l = nctt::warp_sum(l);
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      const float vsc = t == pos ? 1.0f : vsh[t];
      row[t] = __bfloat162float(__float2bfloat16_rn((float)(e / l) * vsc));
    }
  }
  __syncthreads();

  // pass 2: PV, each warp over its rows, then a cross-warp sum
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int t = warp; t < L; t += WARPS) {
    float vv[DPL];
    if (t == pos)
      nctt::load_lane<DPL>(vnh, lane, D, vv);
    else
      nctt::load_lane<DPL>(vh + (size_t)t * D, lane, D, vv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      const double p = sp[r * T + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] += p * (double)vv[e];
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
    oh[i] = __float2bfloat16_rn((float)acc);
  }
}

template <int DPL, bool FULL, typename C>
int launch_quant(const void* q, const void* kn, const void* vn,
                 const void* kc, const void* ks, const void* vc,
                 const void* vs, void* out, void* ws, int B, int H, int Hkv,
                 int T, int D, const int* pos, float scale,
                 cudaStream_t stream) {
  const int rep = H / Hkv;
  const int ng = (rep + MAX_REP - 1) / MAX_REP;       // groups of rows
  const int gs = (rep + ng - 1) / ng;
  const size_t smem = sizeof(double) * (size_t)WARPS * gs * D +
      sizeof(float) * (size_t)gs * D;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_quant_kernel<DPL, FULL, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_quant_kernel<DPL, FULL, C><<<dim3(Hkv, B, ng), THREADS, smem,
                                          stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,
      (const __nv_bfloat16*)vn, (const C*)kc, (const float*)ks, (const C*)vc,
      (const float*)vs, (__nv_bfloat16*)out, (float*)ws, H, Hkv, T, D, pos,
      scale);
  return (int)cudaGetLastError();
}

template <typename C>
int dispatch_quant(const void* q, const void* kn, const void* vn,
                   const void* kc, const void* ks, const void* vc,
                   const void* vs, void* out, void* ws, int B, int H,
                   int Hkv, int T, int D, const int* pos, float scale,
                   cudaStream_t s) {
#define NCTT_K6(DPL_)                                                    \
  case DPL_:                                                             \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                      \
               ? launch_quant<DPL_, nctt::full_width(DPL_), C>(           \
                     q, kn, vn, kc, ks, vc, vs, out, ws, B, H, Hkv, T, D, \
                     pos, scale, s)                                      \
               : launch_quant<DPL_, false, C>(q, kn, vn, kc, ks, vc, vs,  \
                                              out, ws, B, H, Hkv, T, D,   \
                                              pos, scale, s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K6(1) NCTT_K6(2) NCTT_K6(3) NCTT_K6(4)
    NCTT_K6(5) NCTT_K6(6) NCTT_K6(7) NCTT_K6(8)
#undef NCTT_K6
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q bf16 [B, H, D]; caches bf16 [B, Hkv, T, D] holding row `pos`;
// out bf16 [B, H, D]; ws f32 [B, H, T] scratch for the score rows.
// 1 <= D <= 256; H % Hkv == 0.
NCTT_API int nctt_decode_attention(const void* q, const void* k,
                                   const void* v, void* out, void* ws, int B,
                                   int H, int Hkv, int T, int D, int pos,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NCTT_K5(DPL_)                                                   \
  case DPL_:                                                            \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                     \
               ? launch<DPL_, nctt::full_width(DPL_)>(q, k, v, out, ws, B, \
                                                      H, Hkv, T, D, pos,   \
                                                      scale, s)            \
               : launch<DPL_, false>(q, k, v, out, ws, B, H, Hkv, T, D,  \
                                     pos, scale, s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K5(1) NCTT_K5(2) NCTT_K5(3) NCTT_K5(4)
    NCTT_K5(5) NCTT_K5(6) NCTT_K5(7) NCTT_K5(8)
#undef NCTT_K5
    default: return (int)cudaErrorInvalidValue;
  }
}

// q bf16 [B, H, D]; k_new/v_new bf16 [B, Hkv, D] (the raw new rows, folded
// in at pos[b]); codes int8 (fp8 = 0) or e4m3 (fp8 = 1) [B, Hkv, T, D];
// scales f32 [B, Hkv, T]; pos int32 [B] on the device (pos >= T: all T
// code rows, no raw row); out bf16 [B, H, D]; ws f32 [B, H, T] scratch
// for the score rows. 1 <= D <= 256; H % Hkv == 0.
NCTT_API int nctt_decode_attention_quant(const void* q, const void* kn,
                                         const void* vn, const void* kc,
                                         const void* ks, const void* vc,
                                         const void* vs, void* out, void* ws,
                                         int B, int H, int Hkv, int T, int D,
                                         const void* pos_b, int fp8,
                                         float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* pos = (const int*)pos_b;
  return fp8 ? dispatch_quant<nctt::fp8e4m3>(q, kn, vn, kc, ks, vc, vs, out,
                                             ws, B, H, Hkv, T, D, pos, scale,
                                             s)
             : dispatch_quant<int8_t>(q, kn, vn, kc, ks, vc, vs, out, ws, B,
                                      H, Hkv, T, D, pos, scale, s);
}
