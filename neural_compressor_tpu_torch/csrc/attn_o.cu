// B = 1 decode attention fused into the W4A8 o-projection: one cooperative
// launch from the query heads to the layer's x1 = residual + o(attention).
//
// Replaces: neural_compressor_tpu/kernels/fused_matvec.py
//   _attn_o_impl / _make_attn_o_kernel (K18, ATTN_O_FUSED). On the TPU grid
//   step 0 attends every head in its prologue into VMEM scratch, then each
//   step is one N tile of the o-projection.
//
// Semantics: q [H, D] (rope applied) against bf16 caches [Hkv, T, D] that
//   already hold row pos (the port writes it before the launch, as for K5);
//   pos int32 [1] on the device. Each head's attention is K5's
//   (attend.cuh) up to its float32 output o, which is NOT rounded to bf16:
//   the TPU kernel quantizes the float32 outputs of all heads with ONE
//   scale, s = f32(max |o| * f32(1/127)) (1 where it is 0), codes
//   clip(round(o / s), -128, 127) at lane offset (h*rep + r)*D; then the
//   o-projection's grouped int4 dot (G == D), times s, plus the residual,
//   one bf16 store: y = bf16(f32(acc * s) + residual).
//
// Bound on this card: bytes. The o weights and scales (K*N/2 + K/G*N*4
//   bytes) plus the visited K/V rows (2*Hkv*(pos+1)*D*2 bytes).
//
// Design: one cooperative persistent kernel (cudaLaunchCooperativeKernel,
//   every block resident, the grid sized from the occupancy), two phases
//   split by one grid-wide barrier (cooperative_groups::this_grid().sync()):
//     1. attention: blocks take the (KV head, query group) items in turn
//        and run K5's body on each, writing float32 rows into a global
//        scratch [H*D] and the amax of |o| by an atomicMax on the float bits
//        (non-negative floats order as their bits);
//     2. o-projection: each block quantizes the H*D outputs with the one
//        scale into shared memory, then its warps take output columns in
//        turn, K4's column dot (gemv_dot.cuh: __dp4a over unpacked int4,
//        float64 across groups, rounded once), plus the residual.
//   The grid barrier needs no relocatable device code (-rdc) since CUDA 11:
//   the kernel links into the port's one shared library as the others do.
//   A simple first kernel: the blocks past the attention items wait at the
//   barrier, and the o weights are not prefetched across it.
#include <cooperative_groups.h>

#include "attend.cuh"
#include "gemv_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = nctt::ATT_THREADS;
constexpr int WARPS = nctt::ATT_WARPS;

template <int DPL>
__global__ void __launch_bounds__(THREADS)
attn_o_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* kc,
              __nv_bfloat16* vc, const int* __restrict__ pos_b,
              const uint8_t* __restrict__ w,
              const float* __restrict__ scales,
              const __nv_bfloat16* __restrict__ residual,
              __nv_bfloat16* __restrict__ y, float* att, unsigned* amax,
              float* __restrict__ ws, int H, int Hkv, int T, int N,
              float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) double smem[];
  __shared__ float s_scale;
  cg::grid_group grid = cg::this_grid();
  const int K = H * D;
  const int rep = H / Hkv;
  const int ng = nctt::attend_groups(rep);
  const int pos = pos_b[0];

  // phase 1: the heads' float32 outputs and their amax
  for (int it = blockIdx.x; it < Hkv * ng; it += gridDim.x)
    nctt::attend_bf16<DPL, true, false, true>(
        q, kc, vc, nullptr, nullptr, att, ws, amax, H, Hkv, T, D, pos, scale,
        0, it / ng, it % ng, ng, smem);
  grid.sync();

  // phase 2: one activation scale, the codes, the o-projection
  int8_t* sx = reinterpret_cast<int8_t*>(smem);       // [K] codes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    float s = __uint_as_float(__ldcg(amax)) * (1.0f / 127.0f);
    s_scale = s <= 0.f ? 1.0f : s;
  }
  __syncthreads();
  const float s = s_scale;
  for (int i = tid; i < K; i += THREADS) sx[i] = nctt::act_code(__ldcg(att + i), s);
  __syncthreads();
  const size_t wrow = (size_t)K / 2;
  for (int n = blockIdx.x * WARPS + warp; n < N; n += gridDim.x * WARPS) {
    const float g = nctt::dot_column(w + (size_t)n * wrow, sx, scales, n, N,
                                     K, D, lane);
    if (lane == 0)
      y[n] = __float2bfloat16_rn(g * s + __bfloat162float(residual[n]));
  }
}

template <int DPL>
int launch(const void* q, void* k, void* v, const void* pos, const void* w,
           const void* scales, const void* residual, void* y, void* att,
           void* amax, void* ws, int H, int Hkv, int T, int N, float scale,
           cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const int rep = H / Hkv;
  const int ng = nctt::attend_groups(rep);
  const int gs = (rep + ng - 1) / ng;
  size_t smem = nctt::attend_smem(gs, D);
  if (smem < (size_t)H * D) smem = (size_t)H * D;
  auto kernel = attn_o_kernel<DPL>;
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
  const int want = max(Hkv * ng, (N + WARPS - 1) / WARPS);
  const int grid = min(want, nsm * occ);
  const __nv_bfloat16* q_ = (const __nv_bfloat16*)q;
  __nv_bfloat16* k_ = (__nv_bfloat16*)k;
  __nv_bfloat16* v_ = (__nv_bfloat16*)v;
  const int* pos_ = (const int*)pos;
  const uint8_t* w_ = (const uint8_t*)w;
  const float* sc_ = (const float*)scales;
  const __nv_bfloat16* r_ = (const __nv_bfloat16*)residual;
  __nv_bfloat16* y_ = (__nv_bfloat16*)y;
  float* att_ = (float*)att;
  unsigned* am_ = (unsigned*)amax;
  float* ws_ = (float*)ws;
  void* args[] = {&q_, &k_, &v_, &pos_, &w_, &sc_, &r_, &y_, &att_,
                  &am_, &ws_, &H, &Hkv, &T, &N, &scale};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [H, D]; caches bf16 [Hkv, T, D] holding row pos; pos int32 [1] on
// the device; w uint8 "hopper_nk" [N, H*D/2] with scales f32 [H*D/D, N]
// (groups of D); residual bf16 [N]; y bf16 [N]; att f32 [H*D] scratch;
// amax u32 [1] zeroed by the caller; ws f32 [H, T] scratch for the score
// rows. D is 128 or 256 (G == D, G % 128 == 0); H % Hkv == 0.
NCTT_API int nctt_attn_o(const void* q, void* k, void* v, const void* pos,
                         const void* w, const void* scales,
                         const void* residual, void* y, void* att, void* amax,
                         void* ws, int H, int Hkv, int T, int D, int N,
                         float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return launch<4>(q, k, v, pos, w, scales, residual, y, att, amax, ws, H,
                     Hkv, T, N, scale, s);
  if (D == 256)
    return launch<8>(q, k, v, pos, w, scales, residual, y, att, amax, ws, H,
                     Hkv, T, N, scale, s);
  return (int)cudaErrorInvalidValue;
}
