// Weight-only (W4A16) products over weights stored as the JAX package
// stores them, with no layout conversion: "tpu_strided" 32-bit words
// (int2/int4 offset-binary fields, or nf4/fp4 codebook indices) or "int8"
// codes [K, N], float32 group scales [K/G, N] and optional float32 zero
// points. See ops/packing.py for the layouts.
//
// K8, dequant_gemm: y[M, N] = x[M, K] @ dequant(W), M from 1 to 256.
//   Replaces: neural_compressor_tpu/kernels/dequant_matmul.py:356
//   _dequant_matmul_impl (kernel bodies _make_kernel, _make_kernel_int8).
//   Each weight is dequantized in float32, (u - (2^(b-1) + z)) * s for
//   integer fields, codebook[u] * s for nf4/fp4, (c - z) * s for int8
//   codes, rounded once to bf16 (x's dtype) and multiplied on the tensor
//   cores (mma.sync m16n8k16 bf16 -> f32); for a float32 x the weights stay
//   float32 and the product runs in float32 FMAs (dequant_gemm_f32_kernel).
//   Bound on this card: at M <= 256 the bf16 operations (2*M*N*K at 989
//   TFLOP/s) stay under the weight stream (K*N*bits/8 bytes plus scales at
//   3.35 TB/s) below M ~ 60 with int4 weights; above that the operations.
//   The wrapper's plan (kernels/dequant_matmul.py dequant_plan) picks one of
//   two paths, and the entry refuses a plan that does not fit:
//   * "small" (bf16 x, "tpu_strided" int2/int4 words, whole chunks of 8
//     word rows a group (G / P % 8 == 0), any M to 256: the decode steps
//     and prefill chunks): dequant_small_kernel puts the weights on
//     mma.sync's wide side (A = 16 columns x 16 k-slots, B = 8 rows of x),
//     so M = 8 fills the MMA; a block takes 8 or 16 rows of x (M above 16
//     in row tiles of 16, each dequantizing the weights again: 2.4-5x the
//     tile path's speed at M 17-256, but no wgmma). A block owns 32
//     columns; each of its eight warps streams its own range of chunks
//     through a ring of `stages` slots of 16 word rows filled by cp.async:
//     the words, x at the same k, and each chunk's scale and zero rows
//     (read once a chunk, kept in registers while the group lasts); the
//     slots' rows are swizzled, not padded, so that three decode blocks
//     share an SM. A weight is dequantized before its product,
//     so an MMA's k-slots may hold any k: lane (g, t) takes word rows 2t
//     and 2t+1 of a chunk for columns g and g + 8 and feeds field 2j of the
//     two rows to k-slots 2t, 2t+1 of the j-th k16 step, field 2j+1 to
//     k-slots 2t+8, 2t+9. Each word goes from its register into A
//     fragments with no shared-memory round trip, and a slot keeps x as
//     [row][field][word row], so a B fragment is one 32-bit shared load;
//     a chunk's eight rows of one field are 16 contiguous bytes of x. An
//     int4 field becomes the float 2^23 + u by one byte permute of the
//     word's low or high nibbles into the exponent bits 0x4B; then the
//     f32 subtract (2^23 + off at once where that sum is exact, as it is
//     for integral zero points; else 2^23, then off), the f32 multiply and
//     one bf16 rounding give the plain version's weight bit for bit. The
//     warps' float32 sums are folded in shared memory in warp order.
//     Where the plan also splits K across blocks (few column tiles, e.g.
//     MoE experts), each block writes its fold to a float32 workspace and
//     the last block of the column tile (an atomic ticket taken after
//     __threadfence, reset by that block) adds the splits in split order:
//     one launch, the same bits every run;
//   * "tile" (the rest: the "int8" layout, other group sizes, float32
//     x): one block owns 16, 32 or 64 rows of M by 128 columns of
//     N and walks a range of K in stages of 64 k-slots (for "tpu_strided"
//     64 / P whole words of each column, read as 16-byte vectors of 4
//     columns and unpacked into P consecutive k-slots, x gathered in the
//     same order); it dequantizes into shared memory and runs mma.sync with
//     x as the m16 operand. Where its M x N tiles fill less than four
//     waves, K is split across blocks into float32 partials that
//     splitk_reduce adds in split order in a second launch.
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
#include <type_traits>

#include "nctt_common.cuh"

namespace {

using nctt::cp_async;
using nctt::cp_commit;
using nctt::cp_wait;
using nctt::Div;
using nctt::make_div;
using nctt::MAX_DYN_SMEM;

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

// ------------------------------------------------------------- K8, small M
constexpr int SK_WARPS = 8;                // a block's warps, each a stream
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_CHUNK = 8;                // word rows a chunk (two rows a
                                           // lane, four lanes a column)
constexpr int SK_RS = 16;                  // word rows a ring slot
constexpr int SK_CPS = SK_RS / SK_CHUNK;   // chunks a slot
constexpr int SK_WN = 32;                  // a block's columns
constexpr float TWO23 = 8388608.f;         // 2^23

// The layout of a warp's ring slot of SK_RS word rows (two chunks, each
// inside one group: the path takes G / P % 8 == 0), in 4-byte words: the
// word rows of the block's columns, then x's mr rows as [row][field][word
// row], then each chunk's scale row and zero row. Rows are unpadded; their
// 16-byte parts are swizzled so that a warp's loads fall on 32 banks: part
// j of word row r sits at j ^ 2((r / 2) % 4) (the rows 2t of lanes t =
// 0..3), part j of x row m at j ^ (m % 8) (its eight rows). The fold of
// the warps' sums reuses the rings; 16 codebook floats follow.
__host__ __device__ inline int small_slot_bytes(int mr, int p) {
  return 4 * (SK_RS * SK_WN + mr * p * SK_RS / 2 + 2 * SK_CPS * SK_WN);
}
__host__ __device__ inline int small_smem(int mr, int p, int stages) {
  const int ring = SK_WARPS * stages * small_slot_bytes(mr, p);
  const int fold = SK_WARPS * mr * SK_WN * 4;
  return (ring > fold ? ring : fold) + 16 * 4;
}

struct SmallArgs {
  const __nv_bfloat16* x;      // [M, K]
  const uint32_t* w;           // [K/P, N]
  const float* scales;         // [K/G, N]
  const float* zeros;          // same, or null
  const float* codebook;       // 16 floats, or null
  void* out;                   // [M, N] bf16 | f32
  float* part;                 // [splits, M, N] f32 when splits > 1
  int* tickets;                // [M tiles, N / SK_WN], zero, when splits > 1
  int M, N, K, G, out_bf16, stages, cpw, splits;
};

// The float32 weight (u - off) * s of an integer field u given as t = 2^23
// + u (its exponent bits), as the TPU kernel rounds it. EXACT: o2 = 2^23 +
// off is exact (an integral off, as RTN and GPTQ zero points are), so
// t - o2 is u - off rounded once; else (t - 2^23, exactly u) - off.
template <bool EXACT>
__device__ __forceinline__ float dq_t(float t, float off, float o2,
                                      float s) {
  if constexpr (EXACT) return __fmul_rn(__fsub_rn(t, o2), s);
  return __fmul_rn(__fsub_rn(__fsub_rn(t, TWO23), off), s);
}

// the float32 weight of the field at bit `sh` of word w: codebook[u] * s,
// or dq_t's
template <int BITS, bool CB, bool EXACT>
__device__ __forceinline__ float dq(uint32_t w, int sh, float off, float o2,
                                    float s, const float* cb) {
  const uint32_t u = (w >> sh) & ((1u << BITS) - 1u);
  if constexpr (CB) return __fmul_rn(cb[u], s);
  return dq_t<EXACT>(__uint_as_float(0x4B000000u | u), off, o2, s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// NT: x's 8-row tiles a block; CB: codebook fields (nf4/fp4). Registers
// capped so that three blocks share an SM at NT = 1 (the decode step's
// slots fit three times in its shared memory), two at NT = 2.
template <int BITS, int NT, bool CB>
__global__ void __launch_bounds__(SK_THREADS, NT == 1 ? 3 : 2)
dequant_small_kernel(SmallArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int P = 32 / BITS, MR = 8 * NT;
  constexpr int RS = SK_RS, CPS = SK_CPS, WN = SK_WN, NA = WN / 16;
  constexpr int LDX = P * RS / 2;   // 4-byte words an x row
  constexpr int OUTS = MR * WN, OPT = (OUTS + SK_THREADS - 1) / SK_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  // 32 columns from n0, split z of K, MR rows of x from m0
  const int n0 = blockIdx.x * WN, z = blockIdx.y, m0 = blockIdx.z * MR;
  const int M = a.M, N = a.N, K = a.K, G = a.G, stages = a.stages;
  const int WPG = G / P, rows = K / P, nchunks = rows / SK_CHUNK;
  const Div dw = make_div(WPG);
  const int slot_b = small_slot_bytes(MR, P);
  const int ring_b = SK_WARPS * stages * slot_b;
  float* cb = reinterpret_cast<float*>(
      smem + (ring_b > SK_WARPS * OUTS * 4 ? ring_b : SK_WARPS * OUTS * 4));
  if (CB && tid < 16) cb[tid] = a.codebook[tid];
  // the warp's chunks [c_lo, c_hi), CPS a slot
  const int c_lo = min((z * SK_WARPS + warp) * a.cpw, nchunks);
  const int c_hi = min(c_lo + a.cpw, nchunks);
  const int nq = (c_hi - c_lo + CPS - 1) / CPS;
  uint8_t* ring = smem + (size_t)warp * stages * slot_b;
  const float half = (float)(1 << (BITS - 1));

  // A lane's share of a slot's copies, the same in every slot: word rows
  // wl + WSTEP k at columns wj..wj+3; x rows xm + XSTEP k of field xf of
  // chunk xc (a chunk's eight rows of one field are 16 bytes of x: k =
  // (r / WPG) G + f WPG + r % WPG for its rows r); scale (sz = 0) or zero
  // (sz = 1) row of chunk sc_c at columns wj..wj+3.
  constexpr int WSTEP = 32 / (WN / 4), XSTEP = 32 / (CPS * P);
  static_assert(RS % WSTEP == 0 && MR % XSTEP == 0 && 2 * CPS * WN / 4 == 32,
                "a slot's copies are whole steps of 32 lanes");
  const int wl = lane / (WN / 4), wj = 4 * (lane % (WN / 4));
  const int xc = lane % CPS, xf = (lane / CPS) % P, xm = lane / (CPS * P);
  const int sz = lane / (CPS * WN / 4), sc_c = (lane / (WN / 4)) % CPS;
  const uint32_t* wsrc = a.w + (size_t)wl * N + n0 + wj;
  const __nv_bfloat16* xsrc = a.x + (size_t)(m0 + xm) * K + xf * WPG;
  const float* ssrc = sz ? a.zeros : a.scales;
  int si = 0;   // the slot issue() fills next

  // slot q holds chunks c_lo + CPS q + cc, cc < CPS; those at or past c_hi
  // are zeros
  auto issue = [&](int q) {
    if (q < nq) {
      uint8_t* s = ring + (size_t)si * slot_b;
      const int c0 = c_lo + CPS * q;
#pragma unroll
      for (int k = 0; k < RS / WSTEP; ++k) {
        const int l = wl + WSTEP * k;
        const bool ok = c0 + l / SK_CHUNK < c_hi;
        cp_async<16>(s + (l * WN + (wj ^ (((l >> 1) & 3) << 3))) * 4,
                     ok ? wsrc + (size_t)(c0 * SK_CHUNK + WSTEP * k) * N
                        : a.w,
                     ok);
      }
      uint8_t* sx = s + RS * WN * 4;
      const int xr = (c0 + xc) * SK_CHUNK;
      const int xk = dw.q(xr) * G + dw.r(xr);
#pragma unroll
      for (int k = 0; k < MR / XSTEP; ++k) {
        const bool ok = c0 + xc < c_hi && m0 + xm + XSTEP * k < M;
        const int m = xm + XSTEP * k;
        cp_async<16>(sx + (m * LDX + 4 * ((2 * xf + xc) ^ (m & 7))) * 4,
                     ok ? xsrc + (size_t)XSTEP * k * K + xk : a.x, ok);
      }
      float* ss = reinterpret_cast<float*>(sx + MR * LDX * 4);
      if (ssrc && c0 + sc_c < c_hi)
        cp_async<16>(ss + (sz * CPS + sc_c) * WN + wj,
                     ssrc + (size_t)dw.q((c0 + sc_c) * SK_CHUNK) * N + n0 +
                         wj);
    }
    si = si + 1 == stages ? 0 : si + 1;
    cp_commit();   // empty past the warp's last slot: uniform counts
  };

  const int ahead = stages - 1;
  for (int q = 0; q < ahead; ++q) issue(q);
  __syncthreads();   // the codebook

  float acc[NA][NT][4];
#pragma unroll
  for (int na = 0; na < NA; ++na)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[na][nt][e] = 0.f;
  // (s, off, 2^23 + off) of the group gk of the chunk, columns cl * 8 +
  // gid; `exact`: every lane's 2^23 + off is exact
  int gk = -1;
  float sc[2 * NA], of[2 * NA], o2[2 * NA];
  bool exact = true;

  for (int q = 0, cs = 0; q < nq; ++q, cs = cs + 1 == stages ? 0 : cs + 1) {
    cp_wait(ahead - 1);   // slot q (ring slot cs) has landed ...
    __syncwarp();         // ... for every lane; slot q - 1 is done with
    issue(q + ahead);     // into the slot of q - 1
    const uint8_t* s = ring + (size_t)cs * slot_b;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(s);
    const uint32_t* sx = sw + RS * WN;
    const float* ss = reinterpret_cast<const float*>(sx + MR * LDX);
#pragma unroll
    for (int cc = 0; cc < CPS; ++cc) {
      const int c = c_lo + CPS * q + cc;
      if (c >= c_hi) break;
      const int l = SK_CHUNK * cc + 2 * t;   // the lane's rows l, l + 1
      // its words, rows l and l + 1 of columns c * 8 + gid; for int4
      // fields, the low (even fields) and high (odd) nibbles of each byte
      uint32_t wd[2][2 * NA], lo[2][2 * NA], hi[2][2 * NA];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int cl = 0; cl < 2 * NA; ++cl) {
          wd[h][cl] = sw[(l + h) * WN + 4 * ((2 * cl + (gid >> 2)) ^ (2 * t)) +
                         (gid & 3)];
          lo[h][cl] = wd[h][cl] & 0x0F0F0F0Fu;
          hi[h][cl] = (wd[h][cl] >> 4) & 0x0F0F0F0Fu;
        }
      const int g = dw.q(c * SK_CHUNK);   // the same for the whole warp
      if (g != gk) {
        gk = g;
        bool mine = true;
#pragma unroll
        for (int cl = 0; cl < 2 * NA; ++cl) {
          const int col = cl * 8 + gid;
          sc[cl] = ss[cc * WN + col];
          of[cl] = CB ? 0.f
                   : a.zeros ? __fadd_rn(half, ss[(CPS + cc) * WN + col])
                             : half;
          o2[cl] = __fadd_rn(TWO23, of[cl]);
          mine = mine && __fsub_rn(o2[cl], TWO23) == of[cl];
        }
        exact = __all_sync(nctt::FULL_MASK, mine);
      }
      // the chunk's P/2 k16 steps: B is x at fields 2j (k-slots 2t, 2t+1)
      // and 2j+1 (2t+8, 2t+9) of rows l, l + 1, token rows nt*8 + gid; A
      // the same fields of the lane's words, columns gid and gid + 8
      auto steps = [&](auto exact_t) {
        constexpr bool EX = decltype(exact_t)::value;
#pragma unroll
        for (int j = 0; j < P / 2; ++j) {
          uint32_t b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // field f, rows l and l + 1: part 2f + cc, word t
            const uint32_t* xr = sx + (nt * 8 + gid) * LDX + t;
            b[nt][0] = xr[4 * ((4 * j + cc) ^ gid)];
            b[nt][1] = xr[4 * ((4 * j + 2 + cc) ^ gid)];
          }
#pragma unroll
          for (int na = 0; na < NA; ++na) {
            uint32_t af[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {   // (column, field) of af[e]
              const int cl = 2 * na + (e & 1), f = 2 * j + (e >> 1);
              float v[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if constexpr (BITS == 4 && !CB) {
                  // field f: nibble f & 1 of byte f / 2, as 2^23 + u
                  const float tf = __uint_as_float(__byte_perm(
                      f & 1 ? hi[h][cl] : lo[h][cl], 0x4B000000u,
                      0x7440 + (f >> 1)));
                  v[h] = dq_t<EX>(tf, of[cl], o2[cl], sc[cl]);
                } else {
                  v[h] = dq<BITS, CB, EX>(wd[h][cl], BITS * f, of[cl],
                                          o2[cl], sc[cl], cb);
                }
              }
              af[e] = pack_bf16(v[0], v[1]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[na][nt], af, b[nt]);
          }
        }
      };
      if (CB || exact)
        steps(std::true_type{});
      else
        steps(std::false_type{});
    }
  }
  cp_wait(0);
  __syncthreads();   // every warp is done with its ring: the fold reuses it

  // c[0]: column na*16 + gid, token nt*8 + 2t; c[1] the next token; c[2],
  // c[3] column + 8
  float* fold = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int na = 0; na < NA; ++na)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* f = fold + (size_t)warp * OUTS + (nt * 8 + 2 * t) * WN +
                 na * 16 + gid;
      f[0] = acc[na][nt][0];
      f[WN] = acc[na][nt][1];
      f[8] = acc[na][nt][2];
      f[WN + 8] = acc[na][nt][3];
    }
  __syncthreads();
  // output o = tid + i * 256 is (m, c) = (o / WN, o % WN): warps in order
  float v[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = tid + i * SK_THREADS;
    v[i] = 0.f;
    if (OUTS % SK_THREADS == 0 || o < OUTS) {
      v[i] = fold[o];
#pragma unroll
      for (int w = 1; w < SK_WARPS; ++w)
        v[i] = __fadd_rn(v[i], fold[w * OUTS + o]);
    }
  }
  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int o = tid + i * SK_THREADS, m = m0 + o / WN;
      if ((OUTS % SK_THREADS == 0 || o < OUTS) && m < M)
        store_out(a.out, (size_t)m * N + n0 + o % WN, v[i], a.out_bf16);
    }
    return;
  }
  // K split across blocks: this split's fold, then the last block of the
  // (column, row) tile adds the splits in order
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = tid + i * SK_THREADS, m = m0 + o / WN;
    if ((OUTS % SK_THREADS == 0 || o < OUTS) && m < M)
      a.part[((size_t)z * M + m) * N + n0 + o % WN] = v[i];
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + blockIdx.z * gridDim.x + blockIdx.x;
  const int mine = tid == 0 ? atomicAdd(ticket, 1) == a.splits - 1 : 0;
  if (!__syncthreads_or(mine)) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = tid + i * SK_THREADS, m = m0 + o / WN;
    if ((OUTS % SK_THREADS == 0 || o < OUTS) && m < M) {
      const size_t at = (size_t)m * N + n0 + o % WN;
      float y = __ldcg(a.part + at);
      for (int sp = 1; sp < a.splits; ++sp)
        y = __fadd_rn(y, __ldcg(a.part + (size_t)sp * M * N + at));
      store_out(a.out, at, y, a.out_bf16);
    }
  }
  if (tid == 0) *ticket = 0;
}

template <int BITS, int NT, bool CB>
int launch_small(const SmallArgs& a, int smem, cudaStream_t st) {
  auto kernel = dequant_small_kernel<BITS, NT, CB>;
  static bool opted_in = false;   // past the default 48 KB, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<dim3(a.N / SK_WN, a.splits, (a.M + 8 * NT - 1) / (8 * NT)),
           SK_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// K8 over float32 activations: the same stages of K, each weight kept in
// float32 (the TPU kernel dequantizes to x's dtype), the products summed
// with float32 FMAs on the CUDA cores (no bf16 or TF32 tensor-core input).
// A thread owns one of the block's 128 columns for all BM rows; the stage's
// x rows and float32 weights sit in dynamic shared memory.
template <int MT, int BITS>
__global__ void __launch_bounds__(THREADS)
dequant_gemm_f32_kernel(GemmArgs a) {
  constexpr int BM = 16 * MT;
  constexpr bool INT8 = BITS == 8;
  constexpr int P = INT8 ? 1 : 32 / BITS;
  constexpr int WR = KC / P;
  constexpr uint32_t MASK = (1u << (INT8 ? 1 : BITS)) - 1u;
  extern __shared__ __align__(16) float sf[];
  float* sA = sf;                    // [BM][KC]
  float* sB = sf + BM * KC;          // [KC][BN]
  float* sCB = sB + KC * BN;         // [16]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = a.M, N = a.N, K = a.K, G = a.G;
  const float* cb = nullptr;
  if (a.codebook) {
    if (tid < 16) sCB[tid] = a.codebook[tid];
    cb = sCB;
  }
  const int WPG = G / P;
  const int rows = K / P;
  const int nchunks = (rows + WR - 1) / WR;
  const int c0 = blockIdx.z * a.chunks_per_split;
  const int c1 = min(c0 + a.chunks_per_split, nchunks);
  const float half = INT8 ? 0.f : (float)(1 << (BITS - 1));
  const float* xf = reinterpret_cast<const float*>(a.x);

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  __syncthreads();  // sCB

  for (int c = c0; c < c1; ++c) {
    // x's columns in the stage's k order (zero past M or K)
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
      sA[i] = (m < M && k >= 0) ? xf[(size_t)m * K + k] : 0.f;
    }
    // the float32 weights of the stage into sB[kk][n]
    if constexpr (!INT8) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(a.w);
      for (int i = tid; i < WR * (BN / 4); i += THREADS) {
        const int wl = i / (BN / 4), cq = i % (BN / 4);
        const int wrow = c * WR + wl, n = n0 + cq * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* dst = sB + (wl * P) * BN + cq * 4 + j;
          if (wrow < rows) {
            const uint32_t word = __ldg(w + (size_t)wrow * N + n + j);
            const size_t sidx = (size_t)(wrow / WPG) * N + n + j;
            const float sc = __ldg(a.scales + sidx);
            const float z = a.zeros ? __ldg(a.zeros + sidx) : 0.f;
            const float off = __fadd_rn(half, z);
#pragma unroll
            for (int s = 0; s < P; ++s) {
              const int u = (int)((word >> (BITS * s)) & MASK);
              dst[s * BN] = __fmul_rn(field_value(u, off, cb), sc);
            }
          } else {
#pragma unroll
            for (int s = 0; s < P; ++s) dst[s * BN] = 0.f;
          }
        }
      }
    } else {
      const int8_t* w = reinterpret_cast<const int8_t*>(a.w);
      for (int i = tid; i < KC * BN; i += THREADS) {
        const int kr = i / BN, cn = i % BN;
        const int k = c * KC + kr, n = n0 + cn;
        float v = 0.f;
        if (k < K) {
          const size_t sidx = (size_t)(k / G) * N + n;
          const int code = (int)__ldg(w + (size_t)k * N + n);
          const float z = a.zeros ? __ldg(a.zeros + sidx) : 0.f;
          v = __fmul_rn(field_value(code, z, cb), __ldg(a.scales + sidx));
        }
        sB[kr * BN + cn] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float b = sB[kk * BN + tid];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = fmaf(sA[r * KC + kk], b, acc[r]);
    }
    __syncthreads();
  }

  const size_t zoff = (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    const size_t i = (size_t)m * N + n0 + tid;
    if (a.splits == 1)
      store_out(a.out, i, acc[r], a.out_bf16);
    else
      a.part[zoff + i] = acc[r];
  }
}

template <int MT, int BITS>
int launch_gemm_f32(const GemmArgs& a, dim3 grid, cudaStream_t st) {
  const int smem = (int)sizeof(float) * (16 * MT * KC + KC * BN + 16);
  const cudaError_t e = cudaFuncSetAttribute(
      dequant_gemm_f32_kernel<MT, BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dequant_gemm_f32_kernel<MT, BITS><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
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

// K8's plan (kernels/dequant_matmul.py dequant_plan): its paths, as the
// wrapper numbers them, and whether a plan fits the shape and the kernels
enum Path { TILE = 0, SMALL = 1 };

struct Plan {
  int path;     // TILE or SMALL
  int mt;       // token rows a block: 16, 32, 64 (TILE); 8, 16 (SMALL)
  int bn;       // output columns a block: 128 (TILE); 32 (SMALL)
  int stages;   // SMALL: ring slots a warp, 2..8
  int per;      // chunks of K a split (TILE: 64 k-slots) or a warp (SMALL:
                // 8 word rows)
  int splits;   // blocks along K
  int smem;     // SMALL: dynamic shared memory (small_smem)
};

bool plan_ok(const Plan& p, int M, int N, int K, int G, int bits, int int8,
             int x_f32) {
  const int P = int8 ? 1 : (bits == 2 || bits == 4 ? 32 / bits : 0);
  if (!P || M < 1 || N < 128 || N % 128 || G < 1 || K % G || G % P ||
      p.per < 1 || p.splits < 1)
    return false;
  if (p.path == TILE) {
    const int nchunks = cdiv(K / P, KC / P);
    return (p.mt == 16 || p.mt == 32 || p.mt == 64) && p.bn == BN &&
           p.splits == cdiv(nchunks, p.per);
  }
  if (p.path != SMALL || int8 || x_f32 || (G / P) % SK_CHUNK ||
      !(p.mt == 8 || p.mt == 16) ||
      p.bn != SK_WN || p.stages < 2 ||
      p.stages > 8)
    return false;
  const int nchunks = cdiv(K / P, SK_CHUNK);
  return p.splits == cdiv(nchunks, SK_WARPS * p.per) &&
         p.smem == small_smem(p.mt, P, p.stages) &&
         p.smem <= MAX_DYN_SMEM;
}

}  // namespace

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

// K8. x bf16 (x_f32 = 0: bf16 weights on the tensor cores) or f32 (x_f32 =
// 1: f32 weights and FMAs) [M, K]; w uint32 [K/P, N] ("tpu_strided",
// layout_int8 = 0) or int8 [K, N] (layout_int8 = 1); scales (zeros) f32
// [K/G, N]; codebook f32 [16] or null; out [M, N] bf16 (out_bf16) or f32;
// the plan (path, mt, bn, stages, per, splits, smem) from the wrapper's
// dequant_plan; part f32 [splits, M, N] when splits > 1, and for the small
// path tickets int32 [ceil(M / mt), N / bn], zero (the kernel leaves them
// zero). Needs N % 128 == 0, K % G == 0 and, for tpu_strided, G % (32 /
// bits) == 0; a plan that does not fit is refused (cudaErrorInvalidValue),
// not run.
NCTT_API int nctt_dequant_gemm(const void* x, const void* w,
                               const void* scales, const void* zeros,
                               const void* codebook, void* out, void* part,
                               void* tickets, int M, int N, int K, int G,
                               int bits, int layout_int8, int x_f32,
                               int out_bf16, int path, int mt, int bn,
                               int stages, int per, int splits, int smem,
                               void* stream) {
  const Plan p{path, mt, bn, stages, per, splits, smem};
  if (!plan_ok(p, M, N, K, G, bits, layout_int8, x_f32) ||
      (splits > 1 && (!part || (path == SMALL && !tickets))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == SMALL) {
    const SmallArgs a{(const __nv_bfloat16*)x, (const uint32_t*)w,
                      (const float*)scales, (const float*)zeros,
                      (const float*)codebook, out, (float*)part,
                      (int*)tickets, M, N, K, G, out_bf16, stages, per,
                      splits};
    const bool cb = codebook != nullptr;
#define NCTT_K8S(B_, NT_, CB_)                                   \
  if (bits == B_ && mt == 8 * NT_ && cb == CB_)                  \
    return launch_small<B_, NT_, CB_>(a, smem, st);
    NCTT_K8S(4, 1, false) NCTT_K8S(4, 2, false)
    NCTT_K8S(4, 1, true) NCTT_K8S(4, 2, true)
    NCTT_K8S(2, 1, false) NCTT_K8S(2, 2, false)
#undef NCTT_K8S
    return (int)cudaErrorInvalidValue;
  }
  GemmArgs a{(const __nv_bfloat16*)x, w, (const float*)scales,
             (const float*)zeros, (const float*)codebook, out, (float*)part,
             M, N, K, G, out_bf16, splits, per};
  const int mtiles = mt / 16;
  const int b = layout_int8 ? 8 : bits;
  dim3 grid(N / BN, (M + mt - 1) / mt, splits);
  int err;
  if (x_f32) {
#define NCTT_K8F(MT_, B_) \
  if (mtiles == MT_ && b == B_) err = launch_gemm_f32<MT_, B_>(a, grid, st)
    NCTT_K8F(1, 2); else NCTT_K8F(1, 4); else NCTT_K8F(1, 8);
    else NCTT_K8F(2, 2); else NCTT_K8F(2, 4); else NCTT_K8F(2, 8);
    else NCTT_K8F(4, 2); else NCTT_K8F(4, 4); else NCTT_K8F(4, 8);
    else return (int)cudaErrorInvalidValue;
#undef NCTT_K8F
  } else {
#define NCTT_K8(MT_, B_)                                               \
  if (mtiles == MT_ && b == B_) dequant_gemm_kernel<MT_, B_><<<grid, THREADS, 0, st>>>(a)
    NCTT_K8(1, 2); else NCTT_K8(1, 4); else NCTT_K8(1, 8);
    else NCTT_K8(2, 2); else NCTT_K8(2, 4); else NCTT_K8(2, 8);
    else NCTT_K8(4, 2); else NCTT_K8(4, 4); else NCTT_K8(4, 8);
    else return (int)cudaErrorInvalidValue;
#undef NCTT_K8
    err = (int)cudaGetLastError();
  }
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
