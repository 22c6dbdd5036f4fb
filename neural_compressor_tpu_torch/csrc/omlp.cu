// The post-attention half of a W4A8 decoder layer in one cooperative launch:
// o-projection, RMSNorm, gate_up with silu(g)*u, down-projection, both
// residual adds (K17, the decoder-block megakernel; ``mlp_fused`` skips the
// o-projection).
//
// Replaces: neural_compressor_tpu/kernels/omlp_matvec.py
//   _omlp_impl / _make_kernel (K17, OMLP_FUSED). On the TPU the three
//   projections are phases of one sequential grid; x1 and the codes of h
//   live in VMEM scratch between them.
//
// Semantics (the TPU kernel's, which differ from the split K4 path):
//   o:  s = f32(max |x| * f32(1/127)) (1 where it is 0), codes of x / s;
//       x1 = f32(acc_o * s) + f32(residual), kept in FLOAT32 (the split
//       path rounds x1 to bf16);
//   gu: RMSNorm folded by scale invariance: z = x1 * w_rms, s2 =
//       f32(max |z| * f32(1/127)), codes of z / s2, ssc = s2 * f32(rsqrt(
//       mean(x1^2) + eps)); g = acc_g * ssc, u = acc_u * ssc, h = g *
//       f32(sigmoid(g)) * u in float32 (not the split path's four bf16
//       roundings);
//   h is int8-quantized per tn_i-wide tile, ONE scale a tile, hs =
//       f32(max |h_tile| * f32(1/127)) (the split path has one a token);
//   d:  y = bf16(f32(sum_r dot_r * f32(dsc[r] * hs[tile of r])) + x1).
//   Group sums run in float64 over exact products, rounded once (the TPU
//   sums in float32), as K4 does; the sum of squares in float64.
//   Without the o-projection the input is x1 itself (bf16).
//
// Bound on this card: bytes. At llama2-7b: o 8.4 MB, gate_up 45.1 MB and
//   down 22.5 MB of int4 weights plus 4.75 MB of float32 scales a launch.
//
// Design: one cooperative persistent kernel (cudaLaunchCooperativeKernel,
//   the grid sized from the occupancy so every block is resident), phases
//   split by grid-wide barriers (cooperative_groups::this_grid().sync()):
//     1. o: every block quantizes the attention output into its shared
//        memory (Ko bytes; it comes from L2), its warps take x1's columns
//        in turn (K4's column dot, gemv_dot.cuh) and write x1 in float32
//        to a global scratch; barrier;
//     2. gate_up: every block reduces the sum of squares and the amax of z
//        over x1 (from L2), quantizes z into shared memory, and its warps
//        take h's columns in turn (gate column n, up column n + I), h in
//        float32 to a global scratch; barrier;
//     3. down: every block takes the amax of each tn_i tile of h, the
//        tile's scale and the int8 codes of h into shared memory, then its
//        warps take the output columns in turn, each group's scale times
//        its tile's scale, plus x1.
//   tn_i is the TPU kernel's tile (_pick_tiles), numerics here rather than
//   a memory choice. The grid barrier needs no relocatable device code
//   (-rdc) since CUDA 11: the kernel links into the port's one shared
//   library as the others do. A simple first kernel: the next phase's
//   weights are not prefetched across a barrier (the TPU kernel's
//   cross-phase pipelining), and the activations are quantized again by
//   every block.
#include <cooperative_groups.h>

#include "gemv_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// the block's amax of |f(i)| over i < n, and optionally its sum of f(i)^2
// in float64; valid in every thread
template <typename F>
__device__ __forceinline__ float block_amax(int n, F f, double* ss) {
  __shared__ float red_f[WARPS];
  __shared__ double red_d[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float am = 0.f;
  double s = 0.0;
  for (int i = tid; i < n; i += THREADS) {
    const float v = f(i);
    am = fmaxf(am, fabsf(v));
    if (ss) s += (double)v * (double)v;
  }
  am = nctt::warp_max(am);
  s = nctt::warp_sum(s);
  if (lane == 0) {
    red_f[warp] = am;
    red_d[warp] = s;
  }
  __syncthreads();
  am = 0.f;
  s = 0.0;
  for (int w = 0; w < WARPS; ++w) {
    am = fmaxf(am, red_f[w]);
    s += red_d[w];
  }
  if (ss) *ss = s;
  __syncthreads();  // red_* are free again
  return am;
}

__device__ __forceinline__ float act_scale(float amax) {
  const float s = amax * (1.0f / 127.0f);   // as XLA compiles amax / 127
  return s <= 0.f ? 1.0f : s;
}

template <bool HAS_O>
__global__ void __launch_bounds__(THREADS)
omlp_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ residual,
            const float* __restrict__ rms_w, const uint8_t* __restrict__ ow,
            const float* __restrict__ osc, const uint8_t* __restrict__ guw,
            const float* __restrict__ gusc, const uint8_t* __restrict__ dw,
            const float* __restrict__ dsc, __nv_bfloat16* __restrict__ y,
            float* x1s, float* hs, int Ko, int Kh, int I, int Go, int Gg,
            int Gd, int tn_i, int codes_bytes, float eps) {
  extern __shared__ __align__(16) int8_t sx[];   // codes, then tile scales
  float* hsc = reinterpret_cast<float*>(sx + codes_bytes);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;

  // phase 1: x1 = o(x) * s + residual, float32, to the scratch
  if constexpr (HAS_O) {
    const float s = act_scale(block_amax(
        Ko, [&](int i) { return __bfloat162float(x[i]); }, nullptr));
    for (int i = tid; i < Ko; i += THREADS)
      sx[i] = nctt::act_code(__bfloat162float(x[i]), s);
    __syncthreads();
    for (int n = gw; n < Kh; n += nw) {
      const float g = nctt::dot_column(ow + (size_t)n * (Ko / 2), sx, osc, n,
                                       Kh, Ko, Go, lane);
      if (lane == 0) x1s[n] = g * s + __bfloat162float(residual[n]);
    }
    grid.sync();
  }
  auto x1 = [&](int i) {
    return HAS_O ? __ldcg(x1s + i) : __bfloat162float(x[i]);
  };

  // phase 2: RMSNorm folded into the act scale, h = silu(g) * u
  double ss = 0.0;
  block_amax(Kh, x1, &ss);
  const float s2 = act_scale(
      block_amax(Kh, [&](int i) { return x1(i) * rms_w[i]; }, nullptr));
  const float inv = (float)(1.0 / sqrt(ss / Kh + (double)eps));
  const float ssc = s2 * inv;
  for (int i = tid; i < Kh; i += THREADS)
    sx[i] = nctt::act_code(x1(i) * rms_w[i], s2);
  __syncthreads();
  const size_t gwrow = (size_t)Kh / 2;
  for (int n = gw; n < I; n += nw) {
    const float g = nctt::dot_column(guw + (size_t)n * gwrow, sx, gusc, n,
                                     2 * I, Kh, Gg, lane);
    const float u = nctt::dot_column(guw + (size_t)(n + I) * gwrow, sx, gusc,
                                     n + I, 2 * I, Kh, Gg, lane);
    if (lane == 0) {
      const float ga = g * ssc, ua = u * ssc;
      hs[n] = ga * (float)(1.0 / (1.0 + exp(-(double)ga))) * ua;
    }
  }
  grid.sync();

  // phase 3: h's codes, one scale a tn_i tile, then down + x1
  const int n_i = I / tn_i;
  for (int t = warp; t < n_i; t += WARPS) {
    float am = 0.f;
    for (int j = lane; j < tn_i; j += 32)
      am = fmaxf(am, fabsf(__ldcg(hs + (size_t)t * tn_i + j)));
    am = nctt::warp_max(am);
    if (lane == 0) hsc[t] = act_scale(am);
  }
  __syncthreads();
  for (int i = tid; i < I; i += THREADS)
    sx[i] = nctt::act_code(__ldcg(hs + i), hsc[i / tn_i]);
  __syncthreads();
  const size_t dwrow = (size_t)I / 2;
  for (int n = gw; n < Kh; n += nw) {
    const float acc = nctt::dot_column(dw + (size_t)n * dwrow, sx, dsc, n,
                                       Kh, I, Gd, lane, hsc, tn_i / Gd);
    if (lane == 0) y[n] = __float2bfloat16_rn(acc + x1(n));
  }
}

template <bool HAS_O>
int launch(const void* x, const void* residual, const void* rms_w,
           const void* ow, const void* osc, const void* guw,
           const void* gusc, const void* dw, const void* dsc, void* y,
           void* x1s, void* hs, int Ko, int Kh, int I, int Go, int Gg,
           int Gd, int tn_i, float eps, cudaStream_t stream) {
  int codes = max(max(HAS_O ? Ko : 0, Kh), I);
  codes = (codes + 15) / 16 * 16;
  const size_t smem = (size_t)codes + sizeof(float) * (size_t)(I / tn_i);
  auto kernel = omlp_kernel<HAS_O>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, nsm = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // two blocks an SM: each block quantizes every phase's activation again,
  // so more blocks would read more of L2 than the weights take
  const int grid = nsm * min(occ, 2);
  const __nv_bfloat16* x_ = (const __nv_bfloat16*)x;
  const __nv_bfloat16* r_ = (const __nv_bfloat16*)residual;
  const float* rw_ = (const float*)rms_w;
  const uint8_t* ow_ = (const uint8_t*)ow;
  const float* osc_ = (const float*)osc;
  const uint8_t* guw_ = (const uint8_t*)guw;
  const float* gusc_ = (const float*)gusc;
  const uint8_t* dw_ = (const uint8_t*)dw;
  const float* dsc_ = (const float*)dsc;
  __nv_bfloat16* y_ = (__nv_bfloat16*)y;
  float* x1_ = (float*)x1s;
  float* hs_ = (float*)hs;
  void* args[] = {&x_, &r_, &rw_, &ow_, &osc_, &guw_, &gusc_, &dw_, &dsc_,
                  &y_, &x1_, &hs_, &Ko, &Kh, &I, &Go, &Gg, &Gd, &tn_i,
                  &codes, &eps};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// has_o = 1: x bf16 [Ko] (the attention output), residual bf16 [Kh], o
// weights uint8 "hopper_nk" [Kh, Ko/2] with scales f32 [Ko/Go, Kh]; has_o
// = 0: x bf16 [Kh] is x1 itself (ow, osc, residual, x1s unused). rms_w f32
// [Kh]; gate_up uint8 [2I, Kh/2] with scales f32 [Kh/Gg, 2I]; down uint8
// [Kh, I/2] with scales f32 [I/Gd, Kh]; y bf16 [Kh]; x1s f32 [Kh] and hs f32
// [I] scratch. Every K and group a multiple of 128; I % tn_i == 0 and
// tn_i % Gd == 0.
NCTT_API int nctt_omlp(const void* x, const void* residual, const void* rms_w,
                       const void* ow, const void* osc, const void* guw,
                       const void* gusc, const void* dw, const void* dsc,
                       void* y, void* x1s, void* hs, int Ko, int Kh, int I,
                       int Go, int Gg, int Gd, int tn_i, float eps,
                       int has_o, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tn_i <= 0 || I % tn_i || tn_i % Gd) return (int)cudaErrorInvalidValue;
  return has_o ? launch<true>(x, residual, rms_w, ow, osc, guw, gusc, dw, dsc,
                              y, x1s, hs, Ko, Kh, I, Go, Gg, Gd, tn_i, eps, s)
               : launch<false>(x, residual, rms_w, ow, osc, guw, gusc, dw,
                               dsc, y, x1s, hs, Ko, Kh, I, Go, Gg, Gd, tn_i,
                               eps, s);
}
