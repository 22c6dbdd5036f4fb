// Batched single-token decode attention over an already-updated bf16
// head-major KV cache, one position per slot.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _batched_attn_impl / _kernel_batched (K7), bf16 caches.
//
// Semantics (as K7): q [B, H, D] against caches [B, Hkv, T, D] that already
//   hold each slot's new row at pos[b] (int32 [B], read here on the device:
//   no host sync per layer); float32 scores times 1/sqrt(D); keys t > pos[b]
//   masked out (a slot at or past T - 1 attends every row: the engine parks
//   its idle slots on row T - 1 and lets them run on); p = exp(s - m)
//   rounded to bf16 for the PV product; l = sum exp(s - m) unrounded; the
//   output is acc / l, normalised after PV as K7 does (K5 normalises first);
//   rep = H/Hkv query heads per KV head; bf16 output.
//
// Bound on this card: bytes. Each visited cache row is read once for
//   2*rep*D flops: 2*Hkv*(pos[b]+1)*D*2 bytes of K and V per slot.
//
// Design: one block per (slot, KV head), B*Hkv blocks (256 at B = 8 for
//   llama2-7b, against K5's 32); its rep query rows share every K and V row
//   it reads. The block visits only rows t <= min(pos[b], T-1). Warps take
//   rows round-robin and lanes split D, so each warp reads a whole row
//   coalesced. Sums run in float64 over exact bf16 products and are rounded
//   once, so their order almost never shows: the kernel and its plain
//   version (kernels/decode_attention.py) agree bit for bit. The TPU kernel
//   chunks T with an online softmax; one pass over the visited rows gives
//   its result where one chunk covers them. A simple first kernel: no
//   split of T across blocks, no TMA.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

template <int DPL>  // D / 32 elements per lane
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&out)[DPL]) {
  if constexpr (DPL == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
    // DPL bf16 = 2*DPL bytes, 4-byte aligned for DPL >= 2
#pragma unroll
    for (int i = 0; i < DPL; i += 2) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(p + i);
      out[i] = __bfloat162float(v.x);
      out[i + 1] = __bfloat162float(v.y);
    }
  }
}

template <int DPL>
__global__ void __launch_bounds__(THREADS)
batched_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ kc,
                                const __nv_bfloat16* __restrict__ vc,
                                const int* __restrict__ pos,
                                __nv_bfloat16* __restrict__ out, int H,
                                int Hkv, int T, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  const int L = (p < 0 ? 0 : (p > T - 1 ? T - 1 : p)) + 1;  // visited rows
  double* sred = smem;                                // [WARPS][rep][D]
  double* sl = sred + WARPS * rep * D;                // [rep]
  float* sq = reinterpret_cast<float*>(sl + rep);     // [rep][D]
  float* sp = sq + rep * D;                           // [rep][T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head = ((size_t)b * Hkv + hk) * (size_t)T * D;
  const __nv_bfloat16* kh = kc + head;
  const __nv_bfloat16* vh = vc + head;
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)hk * rep) * D;

  for (int i = tid; i < rep * D; i += THREADS) sq[i] = __bfloat162float(qh[i]);
  __syncthreads();

  // pass 1: scores
  for (int t = warp; t < L; t += WARPS) {
    float kv[DPL];
    load_row<DPL>(kh + (size_t)t * D + lane * DPL, kv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = nctt::warp_sum(d);
      if (lane == 0) sp[r * T + t] = (float)d * scale;
    }
  }
  __syncthreads();

  // softmax numerators per query row: p = bf16(exp(s - m)), l unrounded
  for (int r = warp; r < rep; r += WARPS) {
    float* row = sp + r * T;
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
    load_row<DPL>(vh + (size_t)t * D + lane * DPL, vv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      const double pr = sp[r * T + t];
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
  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)hk * rep) * D;
  for (int i = tid; i < rep * D; i += THREADS) {
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) acc += sred[wi * rep * D + i];
    oh[i] = __float2bfloat16_rn((float)acc / (float)sl[i / D]);
  }
}

template <int DPL>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int H, int Hkv, int T, float scale,
           cudaStream_t stream) {
  const int D = DPL * 32, rep = H / Hkv;
  const size_t smem = sizeof(double) * ((size_t)WARPS * rep * D + rep) +
      sizeof(float) * ((size_t)rep * D + (size_t)rep * T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_decode_attention_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  batched_decode_attention_kernel<DPL><<<dim3(Hkv, B), THREADS, smem,
                                         stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)pos, (__nv_bfloat16*)out, H, Hkv,
      T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B, H, D]; caches bf16 [B, Hkv, T, D] holding each slot's row
// pos[b]; pos int32 [B]; out bf16 [B, H, D]. D in {32, 64, 128, 256};
// 1 <= H/Hkv <= 8.
NCTT_API int nctt_batched_decode_attention(const void* q, const void* k,
                                           const void* v, const void* pos,
                                           void* out, int B, int H, int Hkv,
                                           int T, int D, float scale,
                                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<1>(q, k, v, pos, out, B, H, Hkv, T, scale, s);
    case 64: return launch<2>(q, k, v, pos, out, B, H, Hkv, T, scale, s);
    case 128: return launch<4>(q, k, v, pos, out, B, H, Hkv, T, scale, s);
    case 256: return launch<8>(q, k, v, pos, out, B, H, Hkv, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
