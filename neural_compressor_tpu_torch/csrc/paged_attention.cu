// Single-token decode attention over a paged KV pool (bf16 rows, or int8
// codes with per-(token, head) float32 scales).
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_attn_impl_v2 / _paged_kernel_v2 (K11), bf16 and int8 pools,
//   without window or softcap.
//
// Semantics (as K11): q [B, H, D]; pools [P, Hkv, page, D]; scales
//   [P, Hkv, page]; block_tables int32 [B, PMAX] map a slot's logical page
//   j to a pool page; lengths int32 [B] count the slot's rows, the new one
//   included (written before the launch by paged_write.cu). Row t of slot b
//   is row t % page of pool page block_tables[b, t / page]. Scores
//   s = f32(q . k) [* k_scale] * 1/sqrt(D) (two float32 products, in K11's
//   order); rows t >= lengths[b] masked; p = exp(s - m) [* v_scale],
//   rounded to bf16 for the PV product; l = sum exp(s - m) unrounded;
//   out = acc / max(l, 1e-30). A slot of length 0 gives exact zeros.
//
// Bound on this card: bytes. Each visited row is read once: 2*Hkv*len*D
//   code bytes (x2 for bf16) plus 2*Hkv*len*4 scale bytes per slot.
//
// Design: one block per (slot, KV head); its rep query rows share every
//   row it reads. The block walks the slot's block table up to
//   min(lengths[b], PMAX*page) rows: warps take rows round-robin, lanes
//   split D. Idle engine slots have every block-table entry 0 (the trash
//   page) and a full length: they read page 0 again and again, which is
//   valid memory, and their output is never used. Sums run in float64 over
//   exact products (bf16 x bf16, bf16 x int8) and are rounded once, so the
//   kernel and its plain version (kernels/paged_attention.py) agree bit
//   for bit. The TPU kernel's online softmax over 4-page groups equals this
//   one pass where one group covers the visited pages. A simple first
//   kernel: no split of the rows across blocks, no TMA or cp.async.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

template <int DPL, bool QUANT>
__device__ __forceinline__ void load_row(const void* base, size_t off,
                                         float (&out)[DPL]) {
  if constexpr (QUANT) {
    const int8_t* p = reinterpret_cast<const int8_t*>(base) + off;
#pragma unroll
    for (int e = 0; e < DPL; ++e) out[e] = (float)p[e];
  } else {
    const __nv_bfloat16* p =
        reinterpret_cast<const __nv_bfloat16*>(base) + off;
#pragma unroll
    for (int e = 0; e < DPL; ++e) out[e] = __bfloat162float(p[e]);
  }
}

template <int DPL, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ kp,
                       const float* __restrict__ ks,
                       const void* __restrict__ vp,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, int H, int Hkv,
                       int page, int PMAX, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int W = PMAX * page;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int n = lengths[b];
  const int L = n < 0 ? 0 : (n > W ? W : n);          // visited rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)hk * rep) * D;
  if (L == 0) {
    for (int i = tid; i < rep * D; i += THREADS)
      oh[i] = __float2bfloat16_rn(0.0f);
    return;
  }
  double* sred = smem;                                // [WARPS][rep][D]
  double* sl = sred + WARPS * rep * D;                // [rep]
  float* sq = reinterpret_cast<float*>(sl + rep);     // [rep][D]
  float* sp = sq + rep * D;                           // [rep][W]
  const int* btb = bt + (size_t)b * PMAX;
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)hk * rep) * D;

  for (int i = tid; i < rep * D; i += THREADS) sq[i] = __bfloat162float(qh[i]);
  __syncthreads();

  // pass 1: scores
  for (int t = warp; t < L; t += WARPS) {
    const size_t srow = ((size_t)btb[t / page] * Hkv + hk) * page + t % page;
    float kv[DPL];
    load_row<DPL, QUANT>(kp, srow * D + lane * DPL, kv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = nctt::warp_sum(d);
      if (lane == 0) {
        float s = (float)d;
        if constexpr (QUANT) s = s * ks[srow];
        sp[r * W + t] = s * scale;
      }
    }
  }
  __syncthreads();

  // softmax numerators: p = bf16(f32(exp(s - m)) [* v_scale]), l unrounded
  for (int r = warp; r < rep; r += WARPS) {
    float* row = sp + r * W;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      l += e;
      float pe = (float)e;
      if constexpr (QUANT)
        pe = pe * vs[((size_t)btb[t / page] * Hkv + hk) * page + t % page];
      row[t] = __bfloat162float(__float2bfloat16_rn(pe));
    }
    l = nctt::warp_sum(l);
    if (lane == 0) sl[r] = l;
  }
  __syncthreads();

  // pass 2: PV, each warp over its rows, then a cross-warp sum and / l
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int t = warp; t < L; t += WARPS) {
    const size_t srow = ((size_t)btb[t / page] * Hkv + hk) * page + t % page;
    float vv[DPL];
    load_row<DPL, QUANT>(vp, srow * D + lane * DPL, vv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      const double pr = sp[r * W + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] += pr * (double)vv[e];
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      sred[(warp * rep + r) * D + lane * DPL + e] = o[r][e];
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += THREADS) {
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) acc += sred[wi * rep * D + i];
    oh[i] = __float2bfloat16_rn((float)acc / fmaxf((float)sl[i / D], 1e-30f));
  }
}

template <int DPL, bool QUANT>
int launch(const void* q, const void* kp, const void* ks, const void* vp,
           const void* vs, const void* bt, const void* lengths, void* out,
           int B, int H, int Hkv, int page, int PMAX, float scale,
           cudaStream_t stream) {
  const int D = DPL * 32, rep = H / Hkv;
  const size_t smem = sizeof(double) * ((size_t)WARPS * rep * D + rep) +
      sizeof(float) * ((size_t)rep * D + (size_t)rep * PMAX * page);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<DPL, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<DPL, QUANT><<<dim3(Hkv, B), THREADS, smem,
                                       stream>>>(
      (const __nv_bfloat16*)q, kp, (const float*)ks, vp, (const float*)vs,
      (const int*)bt, (const int*)lengths, (__nv_bfloat16*)out, H, Hkv, page,
      PMAX, scale);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int dispatch(const void* q, const void* kp, const void* ks, const void* vp,
             const void* vs, const void* bt, const void* lengths, void* out,
             int B, int H, int Hkv, int page, int PMAX, int D, float scale,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<1, QUANT>(q, kp, ks, vp, vs, bt, lengths, out, B,
                                     H, Hkv, page, PMAX, scale, s);
    case 64: return launch<2, QUANT>(q, kp, ks, vp, vs, bt, lengths, out, B,
                                     H, Hkv, page, PMAX, scale, s);
    case 128: return launch<4, QUANT>(q, kp, ks, vp, vs, bt, lengths, out, B,
                                      H, Hkv, page, PMAX, scale, s);
    case 256: return launch<8, QUANT>(q, kp, ks, vp, vs, bt, lengths, out, B,
                                      H, Hkv, page, PMAX, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q bf16 [B, H, D]; k/v pages bf16 or int8 [P, Hkv, page, D]; k/v scales
// f32 [P, Hkv, page] (int8 pools; null for bf16); block_tables int32
// [B, PMAX]; lengths int32 [B]; out bf16 [B, H, D]. D in {32, 64, 128, 256};
// 1 <= H/Hkv <= 8.
NCTT_API int nctt_paged_decode_attention(const void* q, const void* kp,
                                         const void* ks, const void* vp,
                                         const void* vs, const void* bt,
                                         const void* lengths, void* out,
                                         int B, int H, int Hkv, int P,
                                         int page, int PMAX, int D, int quant,
                                         float scale, void* stream) {
  (void)P;
  cudaStream_t s = (cudaStream_t)stream;
  return quant ? dispatch<true>(q, kp, ks, vp, vs, bt, lengths, out, B, H,
                                Hkv, page, PMAX, D, scale, s)
               : dispatch<false>(q, kp, ks, vp, vs, bt, lengths, out, B, H,
                                 Hkv, page, PMAX, D, scale, s);
}
