// The W4A8 GEMM core shared by K1 (w4a8_gemm.cu: "hopper_nk" and
// "tpu_strided" words) and K2 (s4_gemm.cu: "s4_rowpack" words):
//
//   y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Only the loader of the weight tile differs between the layouts: each
// stages a tile of BN output columns by KC k-slots as k-contiguous int8
// codes in shared memory (sB[c * LDS + k]), the operand mma.sync and
// __dp4a take. The MMA, the group fold and the epilogue are one kernel
// here, so the three layouts give the same bits on the same codes.
//
// Design: wgmma has no int4 operand, so each block unpacks its weight tile
//   to int8 in shared memory and runs mma.sync m16n8k32 s8*s8->s32 on it.
//   Block tile 64x64, four warps of 32x32, K staged 128 at a time. The int32
//   accumulators hold one group's exact partial sums and are folded into
//   float32 with the group scale when the group ends (mul and add kept
//   apart, in group order, as the TPU kernel sums). A simple first kernel:
//   no cp.async pipeline, no TMA; making it fast is later work. Group sizes
//   that are not a multiple of 32 (and K % 32, N % 64) take a general path,
//   one thread an output, on the CUDA cores (below).
#pragma once

#include "nctt_common.cuh"

namespace nctt {
namespace w4a8 {

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

// Four 32-bit words of eight 4-bit fields each (w[t], t = 0..3, one word
// of each of four consecutive k) -> eight words of four bytes, f[s] byte t
// = field s of w[t], unsigned 0..15: the 4 x 8 nibble matrix transposed.
__device__ __forceinline__ void transpose_nibbles(const uint32_t (&w)[4],
                                                  uint32_t (&f)[8]) {
  uint32_t e[4], o[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    e[t] = w[t] & 0x0F0F0F0Fu;         // fields 0, 2, 4, 6 in bytes 0..3
    o[t] = (w[t] >> 4) & 0x0F0F0F0Fu;  // fields 1, 3, 5, 7
  }
  const uint32_t e01l = __byte_perm(e[0], e[1], 0x5140);
  const uint32_t e01h = __byte_perm(e[0], e[1], 0x7362);
  const uint32_t e23l = __byte_perm(e[2], e[3], 0x5140);
  const uint32_t e23h = __byte_perm(e[2], e[3], 0x7362);
  const uint32_t o01l = __byte_perm(o[0], o[1], 0x5140);
  const uint32_t o01h = __byte_perm(o[0], o[1], 0x7362);
  const uint32_t o23l = __byte_perm(o[2], o[3], 0x5140);
  const uint32_t o23h = __byte_perm(o[2], o[3], 0x7362);
  f[0] = __byte_perm(e01l, e23l, 0x5410);
  f[2] = __byte_perm(e01l, e23l, 0x7632);
  f[4] = __byte_perm(e01h, e23h, 0x5410);
  f[6] = __byte_perm(e01h, e23h, 0x7632);
  f[1] = __byte_perm(o01l, o23l, 0x5410);
  f[3] = __byte_perm(o01l, o23l, 0x7632);
  f[5] = __byte_perm(o01h, o23h, 0x5410);
  f[7] = __byte_perm(o01h, o23h, 0x7632);
}

// four unsigned nibble bytes -> four int8 codes: two's complement
// (v ^ 8) - 8, or offset binary v - 8, per byte with no borrow
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t unbias4(uint32_t v) {
  return __vsub4(v, 0x08080808u);
}

// The tiled kernel. Loader::stage(sB, w, n0, k0, kc, N, K, G, tid) fills
// sB[c * LDS + k] (c < BN, k < kc) with the codes of columns n0 + c and
// rows k0 + k; kc is a multiple of 32.
template <class Loader>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ xq, const void* __restrict__ w,
            const float* __restrict__ scales, const float* __restrict__ xscale,
            float* __restrict__ y, int M, int N, int K, int G) {
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
    // stage B: BN columns x kc codes, by the layout's loader
    Loader::stage(sB, w, n0, k0, kc, N, K, G, tid);
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
// each group's partial sum is exact in int32, folded into float32 with the
// group scale in group order, mul and add kept apart, as the tiled kernel
// folds it. Slow (the weight is read one code a thread); right for shapes
// off the main path. Code::at(w, k, n, N, K, G) is the layout's code.
template <class Code>
__global__ void __launch_bounds__(128)
any_group_kernel(const int8_t* __restrict__ xq, const void* __restrict__ w,
                 const float* __restrict__ scales,
                 const float* __restrict__ xscale, float* __restrict__ y,
                 int M, int N, int K, int G) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x, m = blockIdx.y;
  if (n >= N || m >= M) return;
  const int8_t* xr = xq + (size_t)m * K;
  float acc = 0.f;
  for (int g = 0; g < K / G; ++g) {
    int part = 0;
    for (int k = g * G; k < (g + 1) * G; ++k)
      part += Code::at(w, k, n, N, K, G) * (int)xr[k];
    acc = __fadd_rn(acc, __fmul_rn((float)part, scales[(size_t)g * N + n]));
  }
  y[(size_t)m * N + n] = acc * xscale[m];
}

template <class Loader>
int launch_tiled(const void* xq, const void* w, const void* scales,
                 const void* xscale, void* y, int M, int N, int K, int G,
                 cudaStream_t st) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<Loader><<<grid, THREADS, 0, st>>>(
      (const int8_t*)xq, w, (const float*)scales, (const float*)xscale,
      (float*)y, M, N, K, G);
  return (int)cudaGetLastError();
}

template <class Code>
int launch_any_group(const void* xq, const void* w, const void* scales,
                     const void* xscale, void* y, int M, int N, int K, int G,
                     cudaStream_t st) {
  dim3 grid((N + 127) / 128, M);
  any_group_kernel<Code><<<grid, 128, 0, st>>>(
      (const int8_t*)xq, w, (const float*)scales, (const float*)xscale,
      (float*)y, M, N, K, G);
  return (int)cudaGetLastError();
}

}  // namespace w4a8
}  // namespace nctt
