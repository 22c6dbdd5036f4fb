// Paged decode attention, one query a slot, walking the slot's pages one at a
// time with an online softmax (K15, the engine's paged_v2 = False kernel):
// bf16 rows, or int8 / fp8-e4m3 codes with per-(token, head) float32 scales.
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_attn_impl / _paged_kernel (bf16 pools) and
//   _paged_attn_quant_impl / _paged_quant_kernel (int8 and fp8 pools), the
//   v1 kernels (grid (B, Hkv, PMAX), one page a grid step).
//
// Semantics (v1's, which rounds in its own places, not K11's): q [B, H, D];
//   pools [P, Hkv, page, D] with scales [P, Hkv, page]; block_tables int32
//   [B, PMAX]; lengths int32 [B] (the new row included). For each visited
//   page p (at most PMAX), in order:
//     s = f32(q . k) * scale (bf16) or * f32(k_scale * scale) (codes), keys
//       t >= length masked;
//     m_cur = max(m_prev, max_t s), the running max UP TO THIS PAGE;
//     alpha = exp(m_prev - m_cur);
//     e = f32(exp(s - m_cur)); l = l * alpha + sum e;
//     p = bf16(e [* v_scale]), UNNORMALISED;
//     acc = acc * alpha + sum p * v;
//   out = bf16(f32(acc) / max(f32(l), 1e-30)); a slot of length 0 gives
//   zeros (JAX multiplies its output by lengths > 0). Pages past the
//   length add exactly nothing (alpha = 1, e = 0) and are not visited.
//   alpha, l and acc are carried in float64 (the TPU carries float32);
//   exp runs in float64 and e is rounded to float32 where the TPU has it.
//
// Bound on this card: bytes. Each visited row is read once: 2*Hkv*len*D
//   code bytes (x2 for bf16) plus 2*Hkv*len*4 scale bytes per slot.
//
// Design: one block per (slot, KV head, group of query rows) as v1's
//   (B, Hkv, PMAX) grid with its page axis a loop inside the block: the
//   rep query rows split into groups of at most 8 along grid z (K5's
//   rule). A page's scores and then its probabilities are staged in shared
//   memory ([G][page] floats), the running max, alpha and l per query row
//   beside them; each warp carries its partial acc[G][DPL] of the output
//   rows in registers across pages, rescaled by alpha at every page, and
//   the warps' partials are summed at the end. So there is no score
//   workspace in device memory and any context length works; a page of up
//   to ~6,000 rows fits shared memory. Warps take a page's rows
//   round-robin and lanes split D (DPL = ceil(D / 32), any D up to 256, as
//   K5). Idle engine slots point at trash page 0 and are attended like any
//   other. A simple first kernel: no split of a slot's pages across blocks,
//   no asynchronous copies.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

template <int DPL, bool FULL, typename C, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_v1_kernel(const __nv_bfloat16* __restrict__ q,
                const C* __restrict__ kp, const float* __restrict__ ks,
                const C* __restrict__ vp, const float* __restrict__ vs,
                const int* __restrict__ bt, const int* __restrict__ lengths,
                __nv_bfloat16* __restrict__ out, int H, int Hkv, int page,
                int PMAX, int D_, float scale) {
  const int D = FULL ? DPL * 32 : D_;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int gs = (rep + gridDim.z - 1) / gridDim.z;
  const int g0 = blockIdx.z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;  // first row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* oh = out + q0 * D;
  const int len = lengths[b];
  if (len <= 0) {                                   // zeros, as JAX masks
    for (int i = tid; i < G * D; i += THREADS)
      oh[i] = __float2bfloat16_rn(0.0f);
    return;
  }
  double* sred = smem;                              // [WARPS][G][D]
  double* sl = sred + WARPS * gs * D;               // [G] l
  double* salpha = sl + gs;                         // [G] alpha
  float* sm = reinterpret_cast<float*>(salpha + gs);  // [G] running max
  float* sq = sm + gs;                              // [G][D]
  float* sp = sq + gs * D;                          // [G][page]
  const int npages = min((len + page - 1) / page, PMAX);

  for (int i = tid; i < G * D; i += THREADS)
    sq[i] = __bfloat162float(q[q0 * D + i]);
  if (tid < G) {
    sm[tid] = -1e30f;
    sl[tid] = 0.0;
  }
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  __syncthreads();

  for (int p = 0; p < npages; ++p) {
    const size_t pg = (size_t)bt[(size_t)b * PMAX + p] * Hkv + hk;
    const C* kh = kp + pg * (size_t)page * D;
    const C* vh = vp + pg * (size_t)page * D;
    const float* ksh = QUANT ? ks + pg * page : nullptr;
    const float* vsh = QUANT ? vs + pg * page : nullptr;
    const int nv = min(page, len - p * page);       // valid rows here

    // the page's scores
    for (int t = warp; t < nv; t += WARPS) {
      float kv[DPL];
      nctt::load_lane<DPL>(kh + (size_t)t * D, lane, D, kv);
      const float ksc = QUANT ? ksh[t] * scale : scale;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
        double d = 0.0;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          if (FULL || lane * DPL + e < D)
            d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
        d = nctt::warp_sum(d);
        if (lane == 0) sp[r * page + t] = (float)d * ksc;
      }
    }
    __syncthreads();

    // the running max, alpha, l and the unnormalised bf16 probabilities
    for (int r = warp; r < G; r += WARPS) {
      float* row = sp + r * page;
      float m = -INFINITY;
      for (int t = lane; t < nv; t += 32) m = fmaxf(m, row[t]);
      m = nctt::warp_max(m);
      const float m_prev = sm[r];
      const float m_cur = fmaxf(m_prev, m);
      double l = 0.0;
      for (int t = lane; t < nv; t += 32) {
        const float e = (float)exp((double)row[t] - (double)m_cur);
        l += (double)e;
        const float pe = QUANT ? e * vsh[t] : e;
        row[t] = __bfloat162float(__float2bfloat16_rn(pe));
      }
      l = nctt::warp_sum(l);
      if (lane == 0) {
        const double alpha = exp((double)m_prev - (double)m_cur);
        salpha[r] = alpha;
        sl[r] = sl[r] * alpha + l;
        sm[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + sum p * v, each warp over its rows
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      const double a = salpha[r];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] *= a;
    }
    for (int t = warp; t < nv; t += WARPS) {
      float vv[DPL];
      nctt::load_lane<DPL>(vh + (size_t)t * D, lane, D, vv);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
        const double pr = sp[r * page + t];
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[r][e] += pr * (double)vv[e];
      }
    }
    __syncthreads();                                // sp is free again
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
  for (int i = tid; i < G * D; i += THREADS) {
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) acc += sred[wi * G * D + i];
    const float l = fmaxf((float)sl[i / D], 1e-30f);
    oh[i] = __float2bfloat16_rn((float)acc / l);
  }
}

template <int DPL, bool FULL, typename C, bool QUANT>
int launch(const void* q, const void* kp, const void* ks, const void* vp,
           const void* vs, const void* bt, const void* lengths, void* out,
           int B, int H, int Hkv, int page, int PMAX, int D, float scale,
           cudaStream_t stream) {
  const int rep = H / Hkv;
  const int ng = (rep + MAX_REP - 1) / MAX_REP;
  const int gs = (rep + ng - 1) / ng;
  const size_t smem = sizeof(double) * ((size_t)WARPS * gs * D + 2 * gs) +
                      sizeof(float) * ((size_t)gs + (size_t)gs * D +
                                       (size_t)gs * page);
  auto kernel = paged_v1_kernel<DPL, FULL, C, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(Hkv, B, ng), THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const C*)kp, (const float*)ks, (const C*)vp,
      (const float*)vs, (const int*)bt, (const int*)lengths,
      (__nv_bfloat16*)out, H, Hkv, page, PMAX, D, scale);
  return (int)cudaGetLastError();
}

template <typename C, bool QUANT>
int dispatch(const void* q, const void* kp, const void* ks, const void* vp,
             const void* vs, const void* bt, const void* lengths, void* out,
             int B, int H, int Hkv, int page, int PMAX, int D, float scale,
             cudaStream_t s) {
#define NCTT_K15(DPL_)                                                      \
  case DPL_:                                                                \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                         \
               ? launch<DPL_, nctt::full_width(DPL_), C, QUANT>(            \
                     q, kp, ks, vp, vs, bt, lengths, out, B, H, Hkv, page,  \
                     PMAX, D, scale, s)                                     \
               : launch<DPL_, false, C, QUANT>(q, kp, ks, vp, vs, bt,       \
                                               lengths, out, B, H, Hkv,     \
                                               page, PMAX, D, scale, s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K15(1) NCTT_K15(2) NCTT_K15(3) NCTT_K15(4)
    NCTT_K15(5) NCTT_K15(6) NCTT_K15(7) NCTT_K15(8)
#undef NCTT_K15
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q bf16 [B, H, D]; pools [P, Hkv, page, D]: fmt 0 bf16 (scales null),
// 1 int8 or 2 fp8-e4m3 codes with scales f32 [P, Hkv, page]; block_tables
// int32 [B, PMAX]; lengths int32 [B]; out bf16 [B, H, D]. 1 <= D <= 256;
// H % Hkv == 0.
NCTT_API int nctt_paged_attention_v1(const void* q, const void* kp,
                                     const void* ks, const void* vp,
                                     const void* vs, const void* bt,
                                     const void* lengths, void* out, int B,
                                     int H, int Hkv, int page, int PMAX,
                                     int D, int fmt, float scale,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case 0:
      return dispatch<__nv_bfloat16, false>(q, kp, ks, vp, vs, bt, lengths,
                                            out, B, H, Hkv, page, PMAX, D,
                                            scale, s);
    case 1:
      return dispatch<int8_t, true>(q, kp, ks, vp, vs, bt, lengths, out, B,
                                    H, Hkv, page, PMAX, D, scale, s);
    case 2:
      return dispatch<nctt::fp8e4m3, true>(q, kp, ks, vp, vs, bt, lengths,
                                           out, B, H, Hkv, page, PMAX, D,
                                           scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
