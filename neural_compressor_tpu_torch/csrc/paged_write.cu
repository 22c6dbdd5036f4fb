// In-place write of each slot's new K/V row into its page of a paged pool
// (bf16 rows, or int8 codes with a per-(token, head) float32 scale).
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_write_impl with _write_kernel_bf16 and _write_kernel_quant (K12,
//   int8 branch); the int4 branch (_write_kernel_int4) waits for int4 pools.
//
// Semantics (as K12): k_new/v_new bf16 [B, Hkv, D] go to row pos[b] % page
//   of pool page block_tables[b, pos[b] / page], for every KV head. int8:
//   scale = amax * f32(1/127), 1 where amax <= 0 (XLA compiles K12's
//   `amax / 127` as that product); code = clip(rint(x / scale), -128, 127)
//   with a true float32 division and half-to-even rounding; the scale goes
//   to k_scales[pid, h, off]. A row whose page index is past the block
//   table (an idle or finished slot running on inside a multi-step
//   dispatch) is not written, as JAX's scatter drops it.
//
// Bound on this card: bytes, 2*Hkv*D*2 bytes read and 2*Hkv*D (+ 2*Hkv*4
//   scale) bytes written per slot. The TPU kernel stages and rewrites the
//   slot's whole [Hkv, page, D] page block (aliased output); here each
//   block writes one row of one head and touches nothing else.
//
// Design: one block per (slot, KV head), 128 threads over D; the int8 amax
//   is a block max (order-free, exact), so the codes and scales equal the
//   plain version's (kernels/paged_attention.py) and JAX's bit for bit.
//   Several idle slots write the shared trash page 0 in one launch, at the
//   same row: that race is harmless only because page 0 is never attended
//   (the engine masks it by per-slot length and never maps it to a live
//   token).
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 128;

template <bool QUANT>
__device__ __forceinline__ void write_row(const __nv_bfloat16* __restrict__ src,
                                          void* pages, float* scales,
                                          size_t row, int D, float* sred) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (!QUANT) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(pages) + row * D;
    for (int d = tid; d < D; d += THREADS) dst[d] = src[d];
  } else {
    float m = 0.0f;
    for (int d = tid; d < D; d += THREADS)
      m = fmaxf(m, fabsf(__bfloat162float(src[d])));
    m = nctt::warp_max(m);
    if (lane == 0) sred[warp] = m;
    __syncthreads();
    float amax = sred[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, sred[w]);
    __syncthreads();  // sred is reused by the next row
    const float scale = amax <= 0.0f ? 1.0f : amax * (float)(1.0 / 127.0);
    int8_t* dst = reinterpret_cast<int8_t*>(pages) + row * D;
    for (int d = tid; d < D; d += THREADS) {
      const float c = rintf(__bfloat162float(src[d]) / scale);
      dst[d] = (int8_t)fminf(fmaxf(c, -128.0f), 127.0f);
    }
    if (tid == 0) scales[row] = scale;
  }
}

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_write_kernel(const __nv_bfloat16* __restrict__ kn,
                   const __nv_bfloat16* __restrict__ vn, void* kp, float* ks,
                   void* vp, float* vs, const int* __restrict__ bt,
                   const int* __restrict__ pos, int Hkv, int page, int PMAX,
                   int D) {
  __shared__ float sred[THREADS / 32];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  if (p < 0 || p / page >= PMAX) return;
  const int pid = bt[(size_t)b * PMAX + p / page];
  const size_t row = ((size_t)pid * Hkv + hk) * page + p % page;
  const size_t src = ((size_t)b * Hkv + hk) * D;
  write_row<QUANT>(kn + src, kp, ks, row, D, sred);
  write_row<QUANT>(vn + src, vp, vs, row, D, sred);
}

}  // namespace

// k_new/v_new bf16 [B, Hkv, D]; pages bf16 or int8 [P, Hkv, page, D];
// scales f32 [P, Hkv, page] (int8 pools; null for bf16); block_tables int32
// [B, PMAX]; pos int32 [B].
NCTT_API int nctt_paged_write_rows(const void* kn, const void* vn, void* kp,
                                   void* ks, void* vp, void* vs,
                                   const void* bt, const void* pos, int B,
                                   int Hkv, int P, int page, int PMAX, int D,
                                   int quant, void* stream) {
  (void)P;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(Hkv, B);
  if (quant)
    paged_write_kernel<true><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, kp, (float*)ks,
        vp, (float*)vs, (const int*)bt, (const int*)pos, Hkv, page, PMAX, D);
  else
    paged_write_kernel<false><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, kp, (float*)ks,
        vp, (float*)vs, (const int*)bt, (const int*)pos, Hkv, page, PMAX, D);
  return (int)cudaGetLastError();
}
