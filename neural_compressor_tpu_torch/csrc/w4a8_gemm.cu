// W4A8 GEMM: y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Replaces: neural_compressor_tpu/kernels/w4a8_matmul.py _w4a8_impl /
//   _make_kernel (K1, "tpu_strided") and kernels/fused_matvec.py _u4k_impl /
//   _make_mk_kernel (K3, "u4_kpack"): the same function on two TPU layouts.
//   Here the weights are "hopper_nk": uint8 [N, K/2], two K-adjacent signed
//   nibbles per byte (ops/packing.py).
//
// Bound on this card: at the prefill shapes (M = prompt length, 17..512,
//   K x N up to 4096 x 32000) the int8 operations (2*M*N*K at 1979 TOP/s)
//   and the weight stream (K*N/2 bytes at 3.35 TB/s) cross near M ~ 300:
//   short prompts are bound by bytes, long ones by operations.
//
// Design: wgmma has no int4 operand, so each block unpacks its weight tile
//   to int8 in shared memory and runs mma.sync m16n8k32 s8*s8->s32 on it.
//   Block tile 64x64, four warps of 32x32, K staged 128 at a time. The int32
//   accumulators hold one group's exact partial sums and are folded into
//   float32 with the group scale when the group ends (mul and add kept
//   apart, in group order, as the TPU kernel sums). A simple first kernel:
//   no cp.async pipeline, no TMA; making it fast is later work. Group sizes
//   that are not a multiple of 32 (and K % 32, N % 64) take a general path,
//   one thread an output, __dp4a on the CUDA cores (below).
#include "nctt_common.cuh"

namespace {

constexpr int BM = 64;          // block tile rows (tokens)
constexpr int BN = 64;          // block tile columns (outputs)
constexpr int KC = 128;         // K staged per step
constexpr int THREADS = 128;    // 4 warps, 2 x 2 warp tiles of 32 x 32
constexpr int LDS = KC + 16;    // shared row stride in bytes: 36 words, so
                                // the 8 fragment rows hit distinct banks

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
w4a8_gemm_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ w,
                 const float* __restrict__ scales,
                 const float* __restrict__ xscale, float* __restrict__ y,
                 int M, int N, int K, int G) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[2][4][4];
  int part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        part[i][j][e] = 0;
      }

  const size_t wrow = (size_t)K / 2;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);  // a multiple of 32
    // stage A: BM token rows x kc int8 codes (zero rows past M)
    const int avec = kc / 16;
    for (int i = tid; i < BM * avec; i += THREADS) {
      const int r = i / avec, v = i % avec;
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const int4*>(xq + (size_t)(m0 + r) * K + k0 +
                                             v * 16);
      *reinterpret_cast<int4*>(sA + r * LDS + v * 16) = val;
    }
    // stage B: BN columns x kc codes; each 16-byte vector unpacks to 32
    const int bvec = kc / 32;
    for (int i = tid; i < BN * bvec; i += THREADS) {
      const int c = i / bvec, v = i % bvec;
      const uint4 pk = *reinterpret_cast<const uint4*>(
          w + (size_t)(n0 + c) * wrow + k0 / 2 + v * 16);
      uint32_t o[8];
      nctt::unpack8(pk.x, o[0], o[1]);
      nctt::unpack8(pk.y, o[2], o[3]);
      nctt::unpack8(pk.z, o[4], o[5]);
      nctt::unpack8(pk.w, o[6], o[7]);
      uint4* dst = reinterpret_cast<uint4*>(sB + c * LDS + v * 32);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();

    for (int kk = 0; kk < kc; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = sA + (wm + mi * 16 + gid) * LDS + kk + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = sB + (wn + ni * 8 + gid) * LDS + kk + tig * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(part[mi][ni], a[mi], b[ni]);

      if ((k0 + kk + 32) % G == 0) {  // a group ends: fold its partials
        const float* srow = scales + (size_t)((k0 + kk) / G) * N;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn + ni * 8 + tig * 2;
          const float s0 = srow[col], s1 = srow[col + 1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            acc[mi][ni][0] = __fadd_rn(acc[mi][ni][0], __fmul_rn((float)part[mi][ni][0], s0));
            acc[mi][ni][1] = __fadd_rn(acc[mi][ni][1], __fmul_rn((float)part[mi][ni][1], s1));
            acc[mi][ni][2] = __fadd_rn(acc[mi][ni][2], __fmul_rn((float)part[mi][ni][2], s0));
            acc[mi][ni][3] = __fadd_rn(acc[mi][ni][3], __fmul_rn((float)part[mi][ni][3], s1));
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0;
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: times the per-token activation scale, float32 store
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r0 = m0 + wm + mi * 16 + gid, r1 = r0 + 8;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tig * 2;
      if (r0 < M) {
        const float xs = xscale[r0];
        *reinterpret_cast<float2*>(y + (size_t)r0 * N + col) =
            make_float2(acc[mi][ni][0] * xs, acc[mi][ni][1] * xs);
      }
      if (r1 < M) {
        const float xs = xscale[r1];
        *reinterpret_cast<float2*>(y + (size_t)r1 * N + col) =
            make_float2(acc[mi][ni][2] * xs, acc[mi][ni][3] * xs);
      }
    }
  }
}

// The general path, for the shapes the tiles above do not take: a group
// size that is not a multiple of 32 (JAX's "tpu_strided" K1 runs G = 8,
// 16, 24, ...), K % 32 != 0 or N % 64 != 0. One thread per output (m, n):
// each group's partial sum is exact in int32 (four codes at a time by
// __dp4a where the group allows), folded into float32 with the group scale
// in group order, mul and add kept apart, as the tiled kernel folds it.
// Slow (the weight rows are read one column a thread); a path that is right
// for shapes off the main path.
__global__ void __launch_bounds__(128)
w4a8_gemm_any_group_kernel(const int8_t* __restrict__ xq,
                           const uint8_t* __restrict__ w,
                           const float* __restrict__ scales,
                           const float* __restrict__ xscale,
                           float* __restrict__ y, int M, int N, int K,
                           int G) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x, m = blockIdx.y;
  if (n >= N || m >= M) return;
  const uint8_t* wr = w + (size_t)n * (K / 2);
  const int8_t* xr = xq + (size_t)m * K;
  float acc = 0.f;
  for (int g = 0; g < K / G; ++g) {
    int part = 0;
    int k = g * G;
    const int end = k + G;
    if ((G & 3) == 0 && (K & 3) == 0) {
      for (; k < end; k += 4) {  // 4 codes: 2 bytes of w, 4 bytes of x
        const uint32_t b = (uint32_t)wr[k / 2] | ((uint32_t)wr[k / 2 + 1] << 8);
        uint32_t lo4, hi4;
        nctt::unpack8(b, lo4, hi4);  // k .. k+3 in lo4
        int xv;
        memcpy(&xv, xr + k, 4);
        part = __dp4a((int)lo4, xv, part);
      }
    }
    for (; k < end; ++k) {
      const uint8_t b = wr[k / 2];
      const int c = ((int)((k & 1) ? b >> 4 : b & 15) ^ 8) - 8;
      part += c * (int)xr[k];
    }
    acc = __fadd_rn(acc, __fmul_rn((float)part, scales[(size_t)g * N + n]));
  }
  y[(size_t)m * N + n] = acc * xscale[m];
}

}  // namespace

// xq int8 [M, K]; w uint8 [N, K/2]; scales f32 [K/G, N]; xscale f32 [M];
// y f32 [M, N]. K % G == 0 and K even; the tiled kernel where K % 32 == 0,
// G % 32 == 0 and N % 64 == 0, else the general path.
NCTT_API int nctt_w4a8_gemm(const void* xq, const void* w, const void* scales,
                            const void* xscale, void* y, int M, int N, int K,
                            int G, void* stream) {
  if (G < 1 || K % G || K % 2) return (int)cudaErrorInvalidValue;
  if (K % 32 || G % 32 || N % BN) {
    dim3 grid((N + 127) / 128, M);
    w4a8_gemm_any_group_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const int8_t*)xq, (const uint8_t*)w, (const float*)scales,
        (const float*)xscale, (float*)y, M, N, K, G);
    return (int)cudaGetLastError();
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  w4a8_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const uint8_t*)w, (const float*)scales,
      (const float*)xscale, (float*)y, M, N, K, G);
  return (int)cudaGetLastError();
}
