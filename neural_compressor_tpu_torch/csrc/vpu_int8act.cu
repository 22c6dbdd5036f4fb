// K10, vpu_int8act: the all-integer M == 1 product of a W4A8 decode step
// over "tpu_strided" int4/int2 words (sym, or asym with zero points):
//
//   xs = max(max|x|, 1e-6) * f32(1/127);  xq = clip(rint(x / xs), +-127)
//   per group g:   a = sum_k u[k, n] * xq[k],   b = sum_k xq[k]   (int32)
//                  af = f32(a) - (2^(bits-1) + z[g, n]) * f32(b)
//   per K tile t:  part = 0; part = fma(s[g, n], af, part) over the tile's
//                  groups in order;  acc = fma(part, xs, acc)
//
// Replaces: neural_compressor_tpu/kernels/dequant_matmul.py
//   _vpu_matvec_int_impl (kernel body _make_vpu_int_kernel): the same
//   arithmetic in the same order (x quantized per tensor as the jitted
//   program does it, the integer sums over offset-binary fields u, the
//   float work per group and per tile), with the two multiply-adds fused
//   as XLA's CPU program of the reference fuses them, so the card gives
//   its plain version's bits and those of the JAX function on the CPU.
//
// Bound on this card: bytes (each weight word is read once; the
//   operations, 2*K*N integer multiply-adds, are far under the int rate).
//
// Design: a thread owns one column, a block 128 neighbouring columns (its
//   word loads coalesced along N) and one K tile of the TPU kernel's tiling
//   (tk, passed in), so tiles run on separate blocks: each block finds
//   max|x| over all of K, quantizes its tile's x into shared memory in the
//   words' strided order (one 8- or 16-byte load gives a word row's P
//   codes) with each group's sum b, and writes its column's tile sum to a
//   float32 workspace [K/tk, N]. A second launch folds the tiles in tile
//   order, acc + part * xs, as the TPU grid accumulates them: splitting K
//   across blocks keeps the float sums' order, and the card gives the same
//   bits from run to run. Every float operation is an explicit intrinsic
//   (__fmaf_rn where the reference fuses, __fmul_rn / __fsub_rn where it
//   does not), so the compiler contracts nothing else.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename XT>
__device__ __forceinline__ float ldx(const XT* x, int k);
template <>
__device__ __forceinline__ float ldx<float>(const float* x, int k) {
  return __ldg(x + k);
}
template <>
__device__ __forceinline__ float ldx<__nv_bfloat16>(const __nv_bfloat16* x,
                                                    int k) {
  return __bfloat162float(x[k]);
}

// xs = max(max|x|, 1e-6) * f32(1/127), every thread of the block
template <typename XT>
__device__ float act_scale(const XT* x, int K, float* red) {
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) m = fmaxf(m, fabsf(ldx(x, k)));
  m = nctt::warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = red[0];
  for (int i = 1; i < THREADS / 32; ++i) amax = fmaxf(amax, red[i]);
  return __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
}

template <typename XT, int BITS>
__global__ void __launch_bounds__(THREADS)
vpu_int8act_kernel(const XT* __restrict__ x, const uint32_t* __restrict__ w,
                   const float* __restrict__ scales,
                   const float* __restrict__ zeros, float* __restrict__ part,
                   float* __restrict__ xs_out, int N, int K, int G, int tk) {
  constexpr int P = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ __align__(16) int8_t sx[];  // tk codes, then ngk sums
  __shared__ float red[THREADS / 32];
  const int rpg = G / P, ngk = tk / G, t = blockIdx.y;
  int* bsum = reinterpret_cast<int*>(sx + ((tk + 15) / 16) * 16);

  const float xs = act_scale(x, K, red);
  for (int j = threadIdx.x; j < ngk; j += THREADS) bsum[j] = 0;
  __syncthreads();
  // this tile's codes, each group's in the words' order: word row i's P
  // fields at sx[gl*G + i*P + s] (row gl*G + s*rpg + i of the tile)
  for (int j = threadIdx.x; j < tk; j += THREADS) {
    float q = rintf(__fdiv_rn(ldx(x, t * tk + j), xs));
    q = fminf(fmaxf(q, -127.f), 127.f);
    const int gl = j / G, kk = j % G;
    const int s = kk / rpg, i = kk % rpg;
    sx[gl * G + i * P + s] = (int8_t)q;
    atomicAdd(&bsum[gl], (int)q);
  }
  __syncthreads();
  if (t == 0 && blockIdx.x == 0 && threadIdx.x == 0) *xs_out = xs;

  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float half = (float)(1 << (BITS - 1));
  float pt = 0.f;
  for (int gl = 0; gl < ngk; ++gl) {
    const int g = t * ngk + gl;
    const uint32_t* wg = w + (size_t)g * rpg * N + n;
    const int8_t* xg = sx + gl * G;
    int a = 0;
    for (int i = 0; i < rpg; ++i) {
      const uint32_t word = __ldg(wg + (size_t)i * N);
      uint32_t q[P / 4];  // the row's P codes, four a word
      if constexpr (P == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(xg + i * P);
        q[0] = v.x;
        q[1] = v.y;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(xg + i * P);
        q[0] = v.x;
        q[1] = v.y;
        q[2] = v.z;
        q[3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const int xq = (int)(int8_t)((q[s >> 2] >> (8 * (s & 3))) & 0xFFu);
        a += (int)((word >> (BITS * s)) & MASK) * xq;
      }
    }
    const size_t si = (size_t)g * N + n;
    const float off = zeros ? __fadd_rn(half, zeros[si]) : half;
    const float af = __fsub_rn((float)a, __fmul_rn(off, (float)bsum[gl]));
    pt = __fmaf_rn(scales[si], af, pt);
  }
  part[(size_t)t * N + n] = pt;
}

// y[n]: acc = fma(part[t, n], xs, acc) over the tiles in order
__global__ void __launch_bounds__(THREADS)
vpu_int8act_fold(const float* __restrict__ part,
                 const float* __restrict__ xs_in, void* out, int N, int nk,
                 int out_bf16) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float xs = *xs_in;
  float acc = 0.f;
  for (int t = 0; t < nk; ++t)
    acc = __fmaf_rn(part[(size_t)t * N + n], xs, acc);
  if (out_bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[n] = __float2bfloat16_rn(acc);
  else
    reinterpret_cast<float*>(out)[n] = acc;
}

}  // namespace

// K10. x [K] bf16 (x_bf16) or f32; w 32-bit [K/P, N] ("tpu_strided",
// bits 4 or 2, P = 32 / bits); scales (zeros, or null) f32 [K/G, N]; out
// [N] bf16 (out_bf16) or f32; ws f32 [K/tk * N + 4] (the tiles' sums, then
// xs). Needs G % P == 0, tk % G == 0, K % tk == 0, N % 4 == 0.
NCTT_API int nctt_vpu_int8act(const void* x, const void* w, const void* scales,
                              const void* zeros, void* out, void* ws, int N,
                              int K, int G, int bits, int tk, int x_bf16,
                              int out_bf16, void* stream) {
  const int P = bits == 2 || bits == 4 ? 32 / bits : 0;
  if (!P || G < P || G % P || tk < G || tk % G || K % tk || N < 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = K / tk;
  float* part = (float*)ws;
  float* xs = part + (size_t)nk * N;
  const int smem = ((tk + 15) / 16) * 16 + (tk / G) * (int)sizeof(int);
  dim3 grid((N + THREADS - 1) / THREADS, nk);
#define NCTT_K10(XT_, B_)                                                 \
  vpu_int8act_kernel<XT_, B_><<<grid, THREADS, smem, st>>>(               \
      (const XT_*)x, (const uint32_t*)w, (const float*)scales,            \
      (const float*)zeros, part, xs, N, K, G, tk)
  if (x_bf16 && bits == 4) NCTT_K10(__nv_bfloat16, 4);
  else if (x_bf16 && bits == 2) NCTT_K10(__nv_bfloat16, 2);
  else if (!x_bf16 && bits == 4) NCTT_K10(float, 4);
  else NCTT_K10(float, 2);
#undef NCTT_K10
  int err = (int)cudaGetLastError();
  if (err) return err;
  vpu_int8act_fold<<<(N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, xs, out, N, nk, out_bf16);
  return (int)cudaGetLastError();
}
