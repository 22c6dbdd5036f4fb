// Weight-only (W4A16) products over weights stored as the JAX package
// stores them, with no layout conversion: "tpu_strided" 32-bit words
// (int2/int4 offset-binary fields, or nf4/fp4 codebook indices) or "int8"
// codes [K, N], float32 group scales [K/G, N] and optional float32 zero
// points. See ops/packing.py for the layouts.
//
// K8, dequant_gemm: y[M, N] = x[M, K] @ dequant(W), M from 1 to 256.
//   Replaces: neural_compressor_tpu/kernels/dequant_matmul.py
//   _dequant_matmul_impl (kernel bodies _make_kernel, _make_kernel_int8).
//   Each weight is dequantized in float32, (u - (2^(b-1) + z)) * s for
//   integer fields, codebook[u] * s for nf4/fp4, (c - z) * s for int8
//   codes, rounded to bf16 (x's dtype) and multiplied on the tensor cores
//   (mma.sync m16n8k16 bf16 -> f32).
//   Bound on this card: at M <= 256 the bf16 operations (2*M*N*K at 989
//   TFLOP/s) stay under the weight stream (K*N*bits/8 bytes plus scales
//   at 3.35 TB/s) for M below ~60 with int4 weights; above that the
//   operations bound it.
//   Design: one block owns 16, 32 or 64 rows of M by 128 columns of N and
//   walks a range of K. A stage holds 64 k-slots: for "tpu_strided" these
//   are 64 / P whole words of each column, so every word is read once, as
//   a 16-byte vector of 4 neighbouring columns (N is the fast axis of the
//   layout), and unpacked into P consecutive k-slots; x's columns are
//   gathered in the same (strided) order, so the product is unchanged.
//   When the M x N tiles alone leave the card idle, K is split across
//   blocks (blockIdx.z) into float32 partials that a second pass adds in
//   split order (deterministic; no atomics). A simple first kernel: no
//   cp.async pipeline, no TMA, no wgmma; making it fast is later work.
//
// K9, vpu_gemv: the M == 1 product in float32 without rounding the weight,
//   factored per group as the TPU kernel computes it:
//     y_n = sum_g s_gn * (sum_k u_kn x_k - (2^(b-1) + z_gn) * sum_k x_k)
//   over offset-binary "tpu_strided" int2/int4 fields u.
//   Replaces: neural_compressor_tpu/kernels/dequant_matmul.py
//   _vpu_matvec_impl (kernel body _make_vpu_kernel).
//   Bound on this card: bytes (each weight word is read once).
//   Design: a thread owns 4 neighbouring columns and streams their words
//   down its range of K as 16-byte loads, coalesced across the warp; the
//   two per-group sums are folded once a group. K is split across blocks
//   (blockIdx.y) into float32 partials added by the same ordered second
//   pass, so the card gives the same bits from run to run.
#include <algorithm>

#include "nctt_common.cuh"

namespace {

// ----------------------------------------------------------------- shared
__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int out_bf16) {
  if (out_bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[i] = v;
}

// out[i] = sum over s in order of part[s * count + i]
__global__ void splitk_reduce(const float* __restrict__ part, void* out,
                              int splits, long long count, int out_bf16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = part[i];
  for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, part[s * count + i]);
  store_out(out, i, acc, out_bf16);
}

int launch_reduce(const float* part, void* out, int splits, long long count,
                  int out_bf16, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  splitk_reduce<<<(unsigned)blocks, threads, 0, stream>>>(part, out, splits,
                                                          count, out_bf16);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K8
constexpr int BN = 128;        // block tile columns
constexpr int KC = 64;         // k-slots staged per step
constexpr int THREADS = 128;   // 4 warps, each 32 columns x all block rows
constexpr int LDS = KC + 8;    // row stride in bf16: 144 bytes = 36 words,
                               // so the 8 fragment rows hit distinct banks

struct GemmArgs {
  const __nv_bfloat16* x;      // [M, K]
  const void* w;               // uint32 [K/P, N] | int8 [K, N]
  const float* scales;         // [ceil(K/G), N]
  const float* zeros;          // same, or null
  const float* codebook;       // 16 floats, or null
  void* out;                   // [M, N] bf16 | f32
  float* part;                 // [splits, M, N] f32 when splits > 1
  int M, N, K, G, out_bf16, splits, chunks_per_split;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the float32 weight value of a raw field (tpu_strided: unsigned field u;
// int8 layout: signed code c), as the TPU kernel computes it
__device__ __forceinline__ float field_value(int raw, float off,
                                             const float* cb) {
  return cb ? cb[raw & 15] : __fsub_rn((float)raw, off);
}

// MT: 16-row m tiles per block (BM = 16 * MT); BITS: 2 or 4 for
// "tpu_strided" words, 8 for the "int8" layout
template <int MT, int BITS>
__global__ void __launch_bounds__(THREADS) dequant_gemm_kernel(GemmArgs a) {
  constexpr int BM = 16 * MT;
  constexpr bool INT8 = BITS == 8;
  constexpr int P = INT8 ? 1 : 32 / BITS;   // fields per stored element
  constexpr int WR = KC / P;                 // stored rows per stage
  constexpr uint32_t MASK = (1u << (INT8 ? 1 : BITS)) - 1u;
  __shared__ __align__(16) __nv_bfloat16 sA[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sB[BN * LDS];
  __shared__ float sCB[16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = a.M, N = a.N, K = a.K, G = a.G;
  const float* cb = nullptr;
  if (a.codebook) {
    if (tid < 16) sCB[tid] = a.codebook[tid];
    cb = sCB;
  }
  const int WPG = G / P;                       // stored rows per group
  const int rows = K / P;                      // k rows or word rows
  const int nchunks = (rows + WR - 1) / WR;
  const int c0 = blockIdx.z * a.chunks_per_split;
  const int c1 = min(c0 + a.chunks_per_split, nchunks);
  const float half = INT8 ? 0.f : (float)(1 << (BITS - 1));

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(a.x);
  unsigned short* sAu = reinterpret_cast<unsigned short*>(sA);
  __syncthreads();  // sCB

  for (int c = c0; c < c1; ++c) {
    // ---- stage A: x's columns in the stage's k order (zero past M or K)
    for (int i = tid; i < BM * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC;
      const int m = m0 + r;
      int k;
      if constexpr (INT8) {
        k = c * KC + kk;
        if (k >= K) k = -1;
      } else {
        const int wrow = c * WR + kk / P, s = kk % P;
        k = wrow < rows ? (wrow / WPG) * G + s * WPG + wrow % WPG : -1;
      }
      sAu[r * LDS + kk] = (m < M && k >= 0) ? xs[(size_t)m * K + k] : 0;
    }
    // ---- stage B: dequantize into sB[n][kk]
    if constexpr (!INT8) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(a.w);
      const int items = WR * (BN / 4);
      for (int i = tid; i < items; i += THREADS) {
        const int wl = i / (BN / 4), cq = i % (BN / 4);
        const int wrow = c * WR + wl, n = n0 + cq * 4;
        if (wrow < rows) {
          const uint4 pk = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)wrow * N + n));
          const size_t sidx = (size_t)(wrow / WPG) * N + n;
          const float4 sc = __ldg(reinterpret_cast<const float4*>(a.scales + sidx));
          float4 zr = make_float4(0.f, 0.f, 0.f, 0.f);
          if (a.zeros) zr = __ldg(reinterpret_cast<const float4*>(a.zeros + sidx));
          const uint32_t pw[4] = {pk.x, pk.y, pk.z, pk.w};
          const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
          const float z4[4] = {zr.x, zr.y, zr.z, zr.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float off = __fadd_rn(half, z4[j]);
            __nv_bfloat16* dst = sB + (cq * 4 + j) * LDS + wl * P;
#pragma unroll
            for (int s = 0; s < P; ++s) {
              const int u = (int)((pw[j] >> (BITS * s)) & MASK);
              dst[s] = __float2bfloat16_rn(
                  __fmul_rn(field_value(u, off, cb), s4[j]));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            __nv_bfloat16* dst = sB + (cq * 4 + j) * LDS + wl * P;
#pragma unroll
            for (int s = 0; s < P; ++s) dst[s] = __float2bfloat16_rn(0.f);
          }
        }
      }
    } else {
      const int8_t* w = reinterpret_cast<const int8_t*>(a.w);
      const int items = KC * (BN / 16);
      for (int i = tid; i < items; i += THREADS) {
        const int kr = i / (BN / 16), cq = i % (BN / 16);
        const int k = c * KC + kr, n = n0 + cq * 16;
        if (k < K) {
          const uint4 pk = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)k * N + n));
          const uint32_t pw[4] = {pk.x, pk.y, pk.z, pk.w};
          const size_t sidx = (size_t)(k / G) * N + n;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int code = (int)(int8_t)(pw[j >> 2] >> (8 * (j & 3)));
            const float z = a.zeros ? __ldg(a.zeros + sidx + j) : 0.f;
            const float sc = __ldg(a.scales + sidx + j);
            sB[(cq * 16 + j) * LDS + kr] = __float2bfloat16_rn(
                __fmul_rn(field_value(code, z, cb), sc));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            sB[(cq * 16 + j) * LDS + kr] = __float2bfloat16_rn(0.f);
        }
      }
    }
    __syncthreads();

    // ---- tensor cores over the stage: each warp 32 columns x BM rows
    const char* sAb = reinterpret_cast<const char*>(sA);
    const char* sBb = reinterpret_cast<const char*>(sB);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t af[MT][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const char* base = sAb + ((mi * 16 + gid) * LDS + kk) * 2 + tig * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS * 2);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS * 2 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const char* base =
            sBb + ((warp * 32 + ni * 8 + gid) * LDS + kk) * 2 + tig * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // ---- epilogue: the output itself, or this split's float32 partial
  const bool direct = a.splits == 1;
  const size_t zoff = (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int r0 = m0 + mi * 16 + gid, r1 = r0 + 8;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + warp * 32 + ni * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0;
        if (r >= M) continue;
        const size_t i = (size_t)r * N + col;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (direct) {
          store_out(a.out, i, v0, a.out_bf16);
          store_out(a.out, i + 1, v1, a.out_bf16);
        } else {
          a.part[zoff + i] = v0;
          a.part[zoff + i + 1] = v1;
        }
      }
    }
  }
}

// ------------------------------------------------------------------- K9
constexpr int GEMV_THREADS = 128;  // 4 columns each: 512 columns a block

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

template <typename XT, int BITS>
__global__ void __launch_bounds__(GEMV_THREADS)
vpu_gemv_kernel(const XT* __restrict__ x, const uint32_t* __restrict__ w,
                const float* __restrict__ scales,
                const float* __restrict__ zeros, void* out, float* part,
                int N, int K, int G, int groups_per_split, int splits,
                int out_bf16) {
  constexpr int P = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int n = (blockIdx.x * GEMV_THREADS + threadIdx.x) * 4;
  if (n >= N) return;
  const int WPG = G / P, ng = K / G;
  const float half = (float)(1 << (BITS - 1));
  const int g0 = blockIdx.y * groups_per_split;
  const int g1 = min(g0 + groups_per_split, ng);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g = g0; g < g1; ++g) {
    float sa[4] = {0.f, 0.f, 0.f, 0.f};
    float sb = 0.f;
    const uint32_t* wg = w + (size_t)g * WPG * N + n;
    const int kg = g * G;
#pragma unroll 4
    for (int i = 0; i < WPG; ++i) {
      const uint4 pk = __ldg(reinterpret_cast<const uint4*>(wg + (size_t)i * N));
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const float xv = ldx<XT>(x, kg + s * WPG + i);
        const int sh = BITS * s;
        sb += xv;
        sa[0] = fmaf((float)((pk.x >> sh) & MASK), xv, sa[0]);
        sa[1] = fmaf((float)((pk.y >> sh) & MASK), xv, sa[1]);
        sa[2] = fmaf((float)((pk.z >> sh) & MASK), xv, sa[2]);
        sa[3] = fmaf((float)((pk.w >> sh) & MASK), xv, sa[3]);
      }
    }
    const size_t sidx = (size_t)g * N + n;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scales + sidx));
    float4 zr = make_float4(0.f, 0.f, 0.f, 0.f);
    if (zeros) zr = __ldg(reinterpret_cast<const float4*>(zeros + sidx));
    const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
    const float z4[4] = {zr.x, zr.y, zr.z, zr.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float off = half + z4[j];
      acc[j] += s4[j] * (sa[j] - off * sb);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (splits == 1)
      store_out(out, n + j, acc[j], out_bf16);
    else
      part[(size_t)blockIdx.y * N + n + j] = acc[j];
  }
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

// K8's launch plan, so the tiling lives only here: 0 and the split of K
// (*splits blocks along K, *chunks_per_split stages of 64 k-slots each),
// or cudaErrorInvalidValue for a shape K8 does not take (N % 128,
// K % G, or a tpu_strided G that is no multiple of 32 / bits). K is split
// while the M x N tiles alone fill less than four waves of the n_sm SMs,
// as long as the float32 partials move fewer bytes than the weight
// (wbytes).
NCTT_API int nctt_dequant_gemm_plan(int M, int N, int K, int G, int bits,
                                    int layout_int8, int n_sm,
                                    long long wbytes, int* splits,
                                    int* chunks_per_split) {
  const int P = layout_int8 ? 1 : (bits == 2 || bits == 4 ? 32 / bits : 0);
  if (!P || M < 1 || N < BN || N % BN || G < 1 || K % G || G % P)
    return (int)cudaErrorInvalidValue;
  const int nchunks = cdiv(K / P, KC / P);
  const int bm = M <= 16 ? 16 : (M <= 32 ? 32 : 64);
  const int tiles = (N / BN) * cdiv(M, bm);
  long long s = cdiv(4LL * n_sm, tiles);
  s = std::min(s, (long long)std::max(1, nchunks / 4));
  s = std::max(1LL, std::min(s, wbytes / (8LL * M * N)));
  const int per = cdiv(nchunks, s);
  *chunks_per_split = per;
  *splits = cdiv(nchunks, per);
  return 0;
}

// K9's launch plan: 0 and the split of K (*splits blocks along K,
// *groups_per_split groups each), enough blocks for four waves of the
// n_sm SMs; or cudaErrorInvalidValue for a shape K9 does not take
// (bits other than 2 and 4, K % G, G % (32 / bits), N % 4).
NCTT_API int nctt_vpu_gemv_plan(int N, int K, int G, int bits, int n_sm,
                                int* splits, int* groups_per_split) {
  const int P = bits == 2 || bits == 4 ? 32 / bits : 0;
  if (!P || N < 4 || N % 4 || G < 1 || K % G || G % P)
    return (int)cudaErrorInvalidValue;
  const int ng = K / G;
  const int blocks = cdiv(N / 4, GEMV_THREADS);
  const int s = std::max(1, std::min(ng, cdiv(4LL * n_sm, blocks)));
  const int per = cdiv(ng, s);
  *groups_per_split = per;
  *splits = cdiv(ng, per);
  return 0;
}

// K8. x bf16 [M, K]; w uint32 [K/P, N] ("tpu_strided", layout_int8 = 0)
// or int8 [K, N] (layout_int8 = 1); scales (zeros) f32 [ceil(K/G), N];
// codebook f32 [16] or null; out [M, N] bf16 (out_bf16) or f32; part f32
// [splits, M, N] when splits > 1, each split taking chunks_per_split
// stages of 64 k-slots. Needs N % 128 == 0, K % G == 0 and, for
// tpu_strided, G % (32 / bits) == 0.
NCTT_API int nctt_dequant_gemm(const void* x, const void* w,
                               const void* scales, const void* zeros,
                               const void* codebook, void* out, void* part,
                               int M, int N, int K, int G, int bits,
                               int layout_int8, int out_bf16, int splits,
                               int chunks_per_split, void* stream) {
  GemmArgs a{(const __nv_bfloat16*)x, w, (const float*)scales,
             (const float*)zeros, (const float*)codebook, out, (float*)part,
             M, N, K, G, out_bf16, splits, chunks_per_split};
  cudaStream_t st = (cudaStream_t)stream;
  const int mt = M <= 16 ? 1 : (M <= 32 ? 2 : 4);
  const int b = layout_int8 ? 8 : bits;
  dim3 grid(N / BN, (M + 16 * mt - 1) / (16 * mt), splits);
#define NCTT_K8(MT_, B_)                                               \
  if (mt == MT_ && b == B_) dequant_gemm_kernel<MT_, B_><<<grid, THREADS, 0, st>>>(a)
  NCTT_K8(1, 2); else NCTT_K8(1, 4); else NCTT_K8(1, 8);
  else NCTT_K8(2, 2); else NCTT_K8(2, 4); else NCTT_K8(2, 8);
  else NCTT_K8(4, 2); else NCTT_K8(4, 4); else NCTT_K8(4, 8);
  else return (int)cudaErrorInvalidValue;
#undef NCTT_K8
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return launch_reduce((const float*)part, out, splits, (long long)M * N,
                       out_bf16, st);
}

// K9. x [K] bf16 (x_bf16) or f32; w uint32 [K/P, N] ("tpu_strided" int2
// or int4); scales (zeros) f32 [K/G, N]; out [N] bf16 (out_bf16) or f32;
// part f32 [splits, N] when splits > 1, each split taking
// groups_per_split groups. Needs N % 4 == 0, K % G == 0, G % P == 0.
NCTT_API int nctt_vpu_gemv(const void* x, const void* w, const void* scales,
                           const void* zeros, void* out, void* part, int N,
                           int K, int G, int bits, int x_bf16, int out_bf16,
                           int splits, int groups_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N / 4 + GEMV_THREADS - 1) / GEMV_THREADS, splits);
#define NCTT_K9(XT_, B_)                                                  \
  vpu_gemv_kernel<XT_, B_><<<grid, GEMV_THREADS, 0, st>>>(                \
      (const XT_*)x, (const uint32_t*)w, (const float*)scales,            \
      (const float*)zeros, out, (float*)part, N, K, G, groups_per_split,   \
      splits, out_bf16)
  if (x_bf16 && bits == 4) NCTT_K9(__nv_bfloat16, 4);
  else if (x_bf16 && bits == 2) NCTT_K9(__nv_bfloat16, 2);
  else if (!x_bf16 && bits == 4) NCTT_K9(float, 4);
  else if (!x_bf16 && bits == 2) NCTT_K9(float, 2);
  else return (int)cudaErrorInvalidValue;
#undef NCTT_K9
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return launch_reduce((const float*)part, out, splits, (long long)N,
                       out_bf16, st);
}
