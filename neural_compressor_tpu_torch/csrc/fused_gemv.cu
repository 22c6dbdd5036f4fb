// Fused W4A8 decode GEMV (M == 1): [RMSNorm prologue] -> int8 activation
// quantization -> grouped int4 dot -> [silu(g)*u] [+ bias] [+ residual] ->
// one bf16 store.
//
// Replaces: neural_compressor_tpu/kernels/fused_matvec.py _fused_impl
//   (K4, kernel body _make_kernel).
//
// Bound on this card: bytes. Every weight nibble is used once (2*K*N int8
//   operations on K*N/2 bytes), far below the ~600 operations per byte where
//   the int8 tensor cores would become the limit, so the kernel's job is to
//   stream "hopper_nk" weights (K*N/2 bytes) plus their float32 scales
//   (K/G*N*4 bytes) at the memory rate.
//
// Design: the TPU kernel quantizes the activation once, at grid step 0,
//   into scratch that later steps reuse, because a TPU grid runs in order.
//   Hopper blocks run in parallel and in no order, so every block recomputes
//   the sum of squares, the max and the int8 codes of the whole activation
//   (K bytes of codes in shared memory, up to MAX_K; x comes from L2).
//   Past MAX_K one block of a first launch quantizes the activation once
//   into global memory and the GEMV blocks read the codes from there (L2
//   holds them), so K has no cap. Then
//   each warp owns 4 output columns: lanes read consecutive 16-byte vectors
//   (32 codes) of a column, dot them with __dp4a against the shared codes,
//   sum each group's 4 vectors exactly in int32 with two shuffles, and
//   add group partial * scale (an exact product) in float64, rounded once
//   to float32. With the sum of squares also in float64, the sums carry
//   29 bits more than the float32 result, so their order almost never
//   shows: the kernel and its plain version (kernels/fused_matvec.py)
//   agree bit for bit on the main path's inputs. silu pairs column n with
//   column n + N/2 of the same concatenated gate_up weight.
#include "gemv_dot.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_WARP = 4;
constexpr int TN = WARPS * COLS_PER_WARP;  // output columns per block
// the activation codes a block keeps in shared memory: 227 KiB less the
// static reductions
constexpr int MAX_K = 227 * 1024 - 1024;

// The prologue, run by a whole block: RMSNorm's sum of squares and the max
// |z|, z = x * w_rms, then the K int8 codes of z into `codes` (shared or
// global memory) and the two scales into scl: [0] the activation scale,
// [1] it times rsqrt(mean(x^2) + eps).
__device__ __forceinline__ void quantize_activation(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ rms_w,
    int K, float eps, int8_t* codes, float* scl) {
  __shared__ double red_ss[WARPS];
  __shared__ float red_am[WARPS];
  __shared__ float s_scale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // pass 1: sum of x^2 (RMSNorm) and max |z|
  double ss = 0.0;
  float am = 0.f;
  for (int k = tid; k < K; k += THREADS) {
    const float xf = __bfloat162float(x[k]);
    const float z = rms_w ? xf * rms_w[k] : xf;
    ss += (double)xf * (double)xf;
    am = fmaxf(am, fabsf(z));
  }
  ss = nctt::warp_sum(ss);
  am = nctt::warp_max(am);
  if (lane == 0) {
    red_ss[warp] = ss;
    red_am[warp] = am;
  }
  __syncthreads();
  if (warp == 0) {
    ss = lane < WARPS ? red_ss[lane] : 0.0;
    am = lane < WARPS ? red_am[lane] : 0.f;
    ss = nctt::warp_sum(ss);
    am = nctt::warp_max(am);
    if (lane == 0) {
      float s = am * (1.0f / 127.0f);  // as XLA compiles amax / 127
      if (s <= 0.f) s = 1.0f;
      const float inv =
          rms_w ? (float)(1.0 / sqrt(ss / K + (double)eps)) : 1.0f;
      s_scale = s;
      scl[0] = s;
      scl[1] = s * inv;
    }
  }
  __syncthreads();
  const float s = s_scale;
  // pass 2: int8 codes, round half to even as jnp.round / torch.round
  for (int k = tid; k < K; k += THREADS) {
    const float xf = __bfloat162float(x[k]);
    const float z = rms_w ? xf * rms_w[k] : xf;
    const float q = fminf(fmaxf(rintf(__fdiv_rn(z, s)), -128.f), 127.f);
    codes[k] = (int8_t)q;
  }
  __syncthreads();
}

// K past MAX_K: one block quantizes the activation once into global memory
// (codes [K] int8, scl [2] f32), which the GEMV blocks then read from L2
__global__ void __launch_bounds__(THREADS)
fused_gemv_quant_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ rms_w, int K, float eps,
                        int8_t* __restrict__ codes, float* __restrict__ scl) {
  quantize_activation(x, rms_w, K, eps, codes, scl);
}

// GLOBAL: the codes and scales come from fused_gemv_quant_kernel in global
// memory; otherwise each block quantizes the activation into its own
// shared memory
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS)
fused_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ rms_w,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ scales,
                  const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ residual,
                  __nv_bfloat16* __restrict__ y, int K, int N, int G,
                  int n_out, int silu, float eps,
                  const int8_t* __restrict__ gcodes,
                  const float* __restrict__ gscl) {
  extern __shared__ __align__(16) int8_t sx[];  // K int8 activation codes
  __shared__ float s_scl[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* codes;
  float ssc;
  if constexpr (GLOBAL) {
    codes = gcodes;
    ssc = gscl[1];
  } else {
    quantize_activation(x, rms_w, K, eps, sx, s_scl);
    codes = sx;
    ssc = s_scl[1];
  }

  const size_t wrow = (size_t)K / 2;
  for (int j = 0; j < COLS_PER_WARP; ++j) {
    const int n = blockIdx.x * TN + warp * COLS_PER_WARP + j;
    if (n >= n_out) break;  // uniform across the warp
    const float g = nctt::dot_column(w + (size_t)n * wrow, codes, scales, n,
                                     N, K, G, lane);
    float u = 0.f;
    if (silu)
      u = nctt::dot_column(w + (size_t)(n + n_out) * wrow, codes, scales,
                           n + n_out, N, K, G, lane);
    if (lane == 0) {
      float v;
      if (silu) {
        const float ga = g * ssc, ua = u * ssc;
        v = ga * (float)(1.0 / (1.0 + exp(-(double)ga))) * ua;
      } else {
        v = g * ssc;
      }
      if (bias) v += bias[n];
      if (residual) v += __bfloat162float(residual[n]);
      y[n] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// x bf16 [K]; rms_w f32 [K] or null; w uint8 [N, K/2]; scales f32 [K/G, N];
// bias f32 [n_out] or null; residual bf16 [n_out] or null; y bf16 [n_out].
// n_out = N/2 with silu, else N. Needs K % 128 == 0 and G % 128 == 0. Up
// to MAX_K the codes live in each block's shared memory; past it, codes
// (int8 [K]) and scl (f32 [2]) are global scratch the wrapper allocates,
// filled by a first launch of one block.
NCTT_API int nctt_fused_gemv(const void* x, const void* rms_w, const void* w,
                             const void* scales, const void* bias,
                             const void* residual, void* y, int K, int N,
                             int G, int n_out, int silu, float eps,
                             void* codes, void* scl, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n_out + TN - 1) / TN;
  if (K > MAX_K) {
    if (!codes || !scl) return (int)cudaErrorInvalidValue;
    fused_gemv_quant_kernel<<<1, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)rms_w, K, eps, (int8_t*)codes,
        (float*)scl);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fused_gemv_kernel<true><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)rms_w, (const uint8_t*)w,
        (const float*)scales, (const float*)bias,
        (const __nv_bfloat16*)residual, (__nv_bfloat16*)y, K, N, G, n_out,
        silu, eps, (const int8_t*)codes, (const float*)scl);
    return (int)cudaGetLastError();
  }
  if (K > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_gemv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K);
    if (e != cudaSuccess) return (int)e;
  }
  fused_gemv_kernel<false><<<blocks, THREADS, K, s>>>(
      (const __nv_bfloat16*)x, (const float*)rms_w, (const uint8_t*)w,
      (const float*)scales, (const float*)bias,
      (const __nv_bfloat16*)residual, (__nv_bfloat16*)y, K, N, G, n_out, silu,
      eps, nullptr, nullptr);
  return (int)cudaGetLastError();
}
