// The W4A8 GEMM core shared by K1 (w4a8_gemm.cu: "hopper_nk" words;
// w4a8_gemm_strided.cu: "tpu_strided" words) and K2 (s4_gemm.cu:
// "s4_rowpack" words):
//
//   y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Only the layout differs: each layout (a struct in its .cu file) copies
// the packed words of a stage as they lie (Layout::copy) and unpacks them,
// shared memory to shared memory, into k-contiguous 8-bit codes, one row
// of a [column][k] tile per output column (Layout::unpack), the operand
// the MMAs read. The paths, the group fold and the epilogue are this
// file's, so the three layouts give the same bits on the same codes.
//
// Bound on this card: the weight stream (K*N/2 bytes of codes at 3.35 TB/s)
//   below M ~ 300 tokens, the int8 operations (2*M*N*K at 1979 TOP/s) above.
//
// Design. wgmma has no int4 operand, so the weights are unpacked to 8-bit
//   codes in shared memory or registers. Every path streams the raw words
//   in stages of 128 k-slots (KS) through a ring of `stages` slots in
//   dynamic shared memory with 16-byte cp.async (8 bytes where an s4 tile
//   row is 8 bytes), each slot holding one stage's weight words, the token
//   rows of xq it needs and the scale rows of the groups that end in it;
//   copies go out in batches of consecutive stages, several stages ahead of
//   the one being multiplied. Tile sizes are compile-time, so the copy and
//   unpack loops are unrolled, with shifts for their index arithmetic. The
//   MMAs take unsigned codes u = code + 8 (masks and byte permutes give
//   them, no sign extension) against signed xq, and an MMA against ones
//   gives each token's sum(x): a group's exact int32 sum is sum(u * x) -
//   8 * sum(x). The wrapper's plan (kernels/w4a8_matmul.py gemm_plan)
//   picks the path and its tiles:
//   * small M (the decode steps, M <= 32, or <= 16 where N >= 8192; bound
//     by bytes):
//     small_kernel puts the weights on mma.sync's wide side, A = 16
//     columns x 32 k, B = 8 tokens x 32 k (m16n8k32), so no 64-row tile is
//     computed at M = 1 or 8. A block takes 16 or 32 columns, and its eight
//     warps split K by units of whole groups (`ku` k-slots), each warp an
//     independent stream with its own ring and cp.async groups: no
//     block-wide barrier inside a round of eight units, and 8-16 warps an
//     SM with weights in flight. Each warp writes its groups' products
//     fmul(float(sum_g), s_g) to shared memory; after a round the block
//     adds them to its outputs in group order. "hopper_nk" words go from
//     shared memory straight into the MMA's A fragments (a lane's 4 bytes
//     are the 8 k-slots its fragment takes, permuted alike in the xq
//     fragment); the other layouts unpack into a per-warp tile read by
//     ldmatrix;
//   * prefill widths (the other M, G % 128 == 0; bytes to M ~ 300, then
//     operations): wgmma_kernel, a producer warpgroup (the copies and the
//     unpack into 128-byte swizzled tiles) and one or two consumer
//     warpgroups (64 x 64 tiles, or 128 x 128 past M = 64 where N >= 8192;
//     wgmma m64nBNk32 s8 x u8 -> s32 on 64 token rows each,
//     both operands K-major in shared memory), joined by mbarriers; each
//     group's int32 accumulators are folded when its last stage's MMAs are
//     waited for;
//   * anything else (G % 32, K % 128 or N % 64 not 0, or a G that neither
//     divides 128 nor is a multiple of it): the general path below, one
//     thread an output on the CUDA cores.
//   Every path keeps each group's int32 partial sum exact and folds it into
//   float32 with the group's scale in group order, multiply and add rounded
//   apart (__fmul_rn, then __fadd_rn), then multiplies by xs once: the
//   TPU kernel's order and the plain version's, so every plan gives the
//   same bits.
#pragma once

#include "nctt_common.cuh"

namespace nctt {
namespace w4a8 {

// the asynchronous copies and divisions of nctt_common.cuh
using nctt::cp_async;
using nctt::cp_commit;
using nctt::cp_wait;
using nctt::Div;
using nctt::make_div;
using nctt::MAX_DYN_SMEM;
using nctt::smem_u32;

// the paths of a plan, as kernels/w4a8_matmul.py numbers them
enum Path { GENERAL = 0, SMALL = 1, WGMMA = 2 };

struct Plan {
  int path;     // GENERAL, SMALL or WGMMA
  int mt;       // token rows a block: 8, 16, 32 (SMALL); 64, 128 (WGMMA)
  int bn;       // output columns a block: 16, 32 (SMALL); mt (WGMMA)
  int ku;       // SMALL: k-slots a warp's unit (whole groups, 128 | ku)
  int stages;   // ring slots (each warp's, SMALL), 3..8
};

constexpr int KS = 128;                // k-slots a stage, every path
constexpr int SLD = KS + 16;           // the small path's padded tile row
constexpr int SRAW = KS / 2 + 16;      // bytes a column of the small path's
                                       // raw slot: its 64 and 16 of padding
constexpr int SMALL_WARPS = 8;
constexpr int SMALL_THREADS = 32 * SMALL_WARPS;

// f(i) for i = tid, tid + NTHR, ... < COUNT, unrolled
template <int COUNT, int NTHR, class F>
__device__ __forceinline__ void for_items(int tid, F&& f) {
#pragma unroll
  for (int n = 0; n < (COUNT + NTHR - 1) / NTHR; ++n) {
    const int i = tid + n * NTHR;
    if (COUNT % NTHR == 0 || i < COUNT) f(i);
  }
}

// mbarriers of the wgmma path's pipeline (nctt_common.cuh)
using nctt::mbar_arrive;
using nctt::mbar_init;
using nctt::mbar_wait;

// c += a * b, a unsigned int8 (the weights' codes plus 8), b signed int8
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A fragment of a 16-row x 32-byte int8 tile (rows `ld` bytes apart,
// 16-byte aligned) and the B fragment of an 8-row one, by ldmatrix: lane l
// gives the address of row l % 16 (A; bytes 16 further for lanes 16-31) or
// row l % 8 (B; 16 further for lanes 8-15)
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const int8_t* t,
                                       int ld, int lane) {
  const int8_t* p = t + (lane & 15) * ld + ((lane >> 4) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[2], const int8_t* t,
                                       int ld, int lane) {
  const int8_t* p = t + (lane & 7) * ld + (((lane >> 3) & 1) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_u32(p)));
}

// Four 32-bit words of eight 4-bit fields each (w[t], t = 0..3, one word
// of each of four consecutive k) -> eight words of four bytes, f[s] byte t
// = field s of w[t], unsigned 0..15: the 4 x 8 nibble matrix transposed.
// (Fields in offset binary are the unsigned codes as they are.)
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

// Every path multiplies unsigned codes u = code + 8 (0..15), which the
// unpack gets with masks and permutes alone, and takes 8 * sum(x) of the
// group from each group sum: sum(code * x) = sum(u * x) - 8 * sum(x), all
// exact in int32, so the bits are those of signed codes.

// Eight signed int4 codes of one 32-bit "hopper_nk" word (byte j holds
// code 2j in its low nibble and code 2j+1 in its high nibble) -> eight
// unsigned codes u = code + 8 in k order: k0..k3 in `lo4`, k4..k7 in `hi4`
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& lo4,
                                        uint32_t& hi4) {
  w ^= 0x88888888u;   // two's complement -> the code plus 8
  const uint32_t ev = w & 0x0F0F0F0Fu;          // k = 0, 2, 4, 6
  const uint32_t od = (w >> 4) & 0x0F0F0F0Fu;   // k = 1, 3, 5, 7
  lo4 = __byte_perm(ev, od, 0x5140);
  hi4 = __byte_perm(ev, od, 0x7362);
}

// One stage of KS k-slots. Natural order: k0 .. k0 + 127. Gathered
// ("tpu_strided" words at G > 128): word rows i0 .. i0 + 15 of the group
// starting at k0, all 8 fields, slot kk = 16 s + t holding field s of row
// i0 + t, k = k0 + s*G/8 + i0 + t. A group's int32 sum does not depend on
// the order of its terms, so a stage only has to cover each k once.
struct Stage {
  int k0, i0;   // i0 < 0: natural order
  __device__ __forceinline__ int k_at(int kk, int G) const {
    return i0 < 0 ? k0 + kk : k0 + (kk >> 4) * (G >> 3) + i0 + (kk & 15);
  }
  // the groups that end in the stage: k0/G .. k0/G + n_ending - 1 (dg
  // divides by G)
  __device__ __forceinline__ int n_ending(const Div& dg) const {
    if (i0 < 0) return dg.q(k0 + KS) - dg.q(k0);
    return i0 + 16 == (dg.d >> 3) ? 1 : 0;
  }
};

// stage t along K (128 | G or G | 128; dspg divides by G/128, the stages
// a group, where G > 128)
__device__ __forceinline__ Stage stage_at(int t, int G, bool gathered,
                                          const Div& dspg) {
  if (gathered) return Stage{dspg.q(t) * G, dspg.r(t) * 16};
  return Stage{t * KS, -1};
}

// The int8 [column][k] tiles the layouts unpack into. Runs of 4 or 16
// slots (kk a multiple of 4 or 16) stay contiguous in both.
struct PaddedTile {      // small path: rows SLD bytes apart
  int8_t* p;
  __device__ __forceinline__ int8_t* at(int c, int kk) const {
    return p + c * SLD + kk;
  }
};
struct SwizzledTile {    // wgmma path: 128-byte rows, 16-byte chunk j of
  int8_t* p;             // row c at j ^ (c % 8) (1024-byte aligned base)
  __device__ __forceinline__ int8_t* at(int c, int kk) const {
    return p + c * 128 + ((((kk >> 4) ^ c) & 7) << 4) + (kk & 15);
  }
};

// the stage's k-slots of xq rows m0 .. m0 + ROWS - 1 (zeros past M)
template <int ROWS, int NTHR, class Dst>
__device__ __forceinline__ void copy_x(const Dst& dst,
                                       const int8_t* __restrict__ xq, int m0,
                                       const Stage& st, int M, int K, int G,
                                       int tid) {
  for_items<ROWS * KS / 16, NTHR>(tid, [&](int i) {
    const int r = i / (KS / 16), c = i % (KS / 16), m = m0 + r;
    cp_async<16>(dst.at(r, 16 * c),
                 xq + (size_t)min(m, M - 1) * K + st.k_at(16 * c, G), m < M);
  });
}

// the scale rows (columns n0 .. n0 + BN - 1) of the groups ending in st
template <int BN, int NTHR>
__device__ __forceinline__ void copy_scales(float* dst,
                                            const float* __restrict__ scales,
                                            int n0, const Stage& st, int N,
                                            const Div& dg, int tid) {
  constexpr int CH = BN / 4;   // 16-byte chunks a row
  const int rows = st.n_ending(dg), g0 = dg.q(st.k0);
  for (int i = tid; i < rows * CH; i += NTHR) {
    const int q = i / CH, c = i % CH;
    cp_async<16>(dst + q * BN + 4 * c,
                 scales + (size_t)(g0 + q) * N + n0 + 4 * c);
  }
}

// ------------------------------------------------------------ small M
// shared memory of small_kernel: each warp's `stages` slots (raw words, xq
// rows, scale rows) and its unpacked tile, then two rounds' products
__host__ __device__ inline int small_scale_rows(int G) {
  return G < KS ? KS / G : 1;
}
__host__ __device__ inline size_t small_slot_bytes(int mt, int wn, int G) {
  return (size_t)wn * SRAW + (size_t)mt * SLD +
         (size_t)small_scale_rows(G) * wn * 4;
}
// (a layout whose words go straight into the A fragments, DIRECT, has no
// unpacked tile)
__host__ __device__ inline size_t small_warp_bytes(int mt, int wn,
                                                   int stages, int G,
                                                   bool direct) {
  return stages * small_slot_bytes(mt, wn, G) +
         (direct ? 0 : (size_t)wn * SLD);
}
__host__ __device__ inline size_t small_smem(int mt, int wn, int ku,
                                             int stages, int G, bool direct) {
  return SMALL_WARPS * small_warp_bytes(mt, wn, stages, G, direct) +
         2 * (size_t)SMALL_WARPS * (ku / G) * mt * wn * 4;
}

template <class L, int MT, int WN>
__global__ void __launch_bounds__(SMALL_THREADS)
small_kernel(const int8_t* __restrict__ xq, const void* __restrict__ w,
             const float* __restrict__ scales,
             const float* __restrict__ xscale, float* __restrict__ y, int M,
             int N, int K, int G, int KU, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int NT = MT / 8, NA = WN / 16;      // token tiles, column tiles
  constexpr int OUTS = MT * WN;                 // the block's outputs
  constexpr int OPT = (OUTS + SMALL_THREADS - 1) / SMALL_THREADS;
  constexpr size_t RAW_B = (size_t)WN * SRAW, X_B = (size_t)MT * SLD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t slot_b = small_slot_bytes(MT, WN, G);
  uint8_t* ring =
      smem + warp * small_warp_bytes(MT, WN, stages, G, L::DIRECT);
  int8_t* tile = reinterpret_cast<int8_t*>(ring + stages * slot_b);
  float* prods = reinterpret_cast<float*>(
      smem + SMALL_WARPS * small_warp_bytes(MT, WN, stages, G, L::DIRECT));
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * MT;
  const int ng = K / G;
  const bool gathered = L::STRIDED && G > KS;
  const int gpu = KU / G, spu = KU / KS;         // groups, stages a unit
  const int nst = K / KS;                        // the block's stages
  const int nu = (ng + gpu - 1) / gpu;           // its units
  const int rounds = (nu + SMALL_WARPS - 1) / SMALL_WARPS;
  const int gsteps = G / 32;                     // k-steps a group (G <= KS)
  const Div dg = make_div(G), dspg = make_div(gathered ? G / KS : 1),
            dspu = make_div(spu);

  // the warp's q-th stage is stage t of the block: units warp, warp + 8,
  // ..., spu stages each
  auto t_of = [&](int q) {
    return (warp + dspu.q(q) * SMALL_WARPS) * spu + dspu.r(q);
  };
  auto slot = [&](int q) { return ring + (size_t)(q % stages) * slot_b; };
  auto issue = [&](int q) {
    const int t = t_of(q);
    if (t < nst) {
      const Stage st = stage_at(t, G, gathered, dspg);
      uint8_t* s = slot(q);
      L::template copy<WN, 32, SRAW>(s, w, n0, st, N, K, G, lane);
      copy_x<MT, 32>(PaddedTile{reinterpret_cast<int8_t*>(s + RAW_B)}, xq,
                     m0, st, M, K, G, lane);
      copy_scales<WN, 32>(reinterpret_cast<float*>(s + RAW_B + X_B), scales,
                          n0, st, N, dg, lane);
    }
    cp_commit();   // empty past the warp's last stage: uniform counts
  };
  // copies go out in batches of `batch` consecutive stages (a column's 64
  // bytes of each, back to back), `ahead` stages past the one waited for
  const int batch = stages >= 8 ? 4 : stages >= 4 ? 2 : 1;
  const int ahead = stages - batch;
  for (int q = 0; q < ahead; ++q) issue(q);

  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  // p: the group's sum(u * x); qx: its sum(x) for each token (every row
  // of the MMA's A operand all ones)
  int p[NA][NT][4], qx[NT][4];
  const uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u,
                            0x01010101u};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qx[nt][e] = 0;
#pragma unroll
      for (int a = 0; a < NA; ++a) p[a][nt][e] = 0;
    }

  for (int r = 0; r < rounds; ++r) {
    // this round's products: [4 units x gpu groups, in k order][m][c]
    float* pr = prods + (size_t)(r & 1) * SMALL_WARPS * gpu * MT * WN;
    const int g_round = r * SMALL_WARPS * gpu;   // its first group
    for (int s = 0; s < spu; ++s) {
      const int q = r * spu + s, t = t_of(q);
      // the warp's stage q has landed: of the groups committed so far (the
      // first `ahead`, then a batch at every q % batch == 0 before this
      // one), all but the newest q + 1 are stage q or earlier
      cp_wait(ahead + batch * ((q + batch - 1) / batch) - (q + 1));
      __syncwarp();          // ... for every lane; stage q - 1 is done with
      if (q % batch == 0)    // into the slots of stages q - batch .. q - 1
        for (int b = 0; b < batch; ++b) issue(q + ahead + b);
      if (t >= nst) continue;
      const Stage st = stage_at(t, G, gathered, dspg);
      const uint8_t* sl = slot(q);
      if constexpr (!L::DIRECT) {
        L::template unpack<WN, 32, SRAW>(sl, PaddedTile{tile}, st, G, lane);
        __syncwarp();
      }
      const int8_t* sx = reinterpret_cast<const int8_t*>(sl + RAW_B);
      const float* sc = reinterpret_cast<const float*>(sl + RAW_B + X_B);
      const bool stage_ends = gathered ? st.i0 + 16 == (G >> 3)
                                       : dg.r(st.k0 + KS) == 0;
      const int g_stage = dg.q(st.k0);
#pragma unroll
      for (int j = 0; j < KS / 32; ++j) {
        uint32_t a[NA][4];
        if constexpr (L::DIRECT) {
          // A straight from the words: lane (gid, tig) unpacks the 8 codes
          // k = 32j + 8tig .. + 7 of columns gid and gid + 8; the MMA's
          // k-slots 4tig..4tig+3 and 16+4tig..16+4tig+3 take them, and
          // the xq fragment below the same k. A group's sum does not
          // depend on the order of its terms.
#pragma unroll
          for (int na = 0; na < NA; ++na) {
            const uint8_t* rb = sl + (na * 16 + gid) * SRAW + 16 * j + 4 * tig;
            unpack8(*reinterpret_cast<const uint32_t*>(rb), a[na][0],
                    a[na][2]);
            unpack8(*reinterpret_cast<const uint32_t*>(rb + 8 * SRAW),
                    a[na][1], a[na][3]);
          }
        } else {
#pragma unroll
          for (int na = 0; na < NA; ++na)
            ldsm_a(a[na], tile + na * 16 * SLD + 32 * j, SLD, lane);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[2];
          if constexpr (L::DIRECT) {
            const uint2 bv = *reinterpret_cast<const uint2*>(
                sx + (nt * 8 + gid) * SLD + 32 * j + 8 * tig);
            b[0] = bv.x;
            b[1] = bv.y;
          } else {
            ldsm_b(b, sx + nt * 8 * SLD + 32 * j, SLD, lane);
          }
#pragma unroll
          for (int na = 0; na < NA; ++na) mma_u8(p[na][nt], a[na], b);
          mma_u8(qx[nt], ones, b);
        }
        const bool end = G <= KS ? ((j + 1) & (gsteps - 1)) == 0
                                 : j == KS / 32 - 1 && stage_ends;
        if (!end) continue;
        // group g ends: p's products with its scales. c[0]: column
        // na*16 + gid, token nt*8 + 2*tig; c[1] the next token; c[2], c[3]
        // column + 8
        const int row = G <= KS ? dg.q(32 * j) : 0;   // its scale row
        const int g = g_stage + row;
        const float* srow = sc + row * WN;
        float* pg = pr + (size_t)(g - g_round) * MT * WN;
#pragma unroll
        for (int na = 0; na < NA; ++na) {
          const int c0 = na * 16 + gid, c1 = c0 + 8;
          const float s0 = srow[c0], s1 = srow[c1];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int m = nt * 8 + tig * 2;
            // the signed codes' sums: sum(u * x) - 8 * sum(x), exact
            const float v[4] = {
                __fmul_rn((float)(p[na][nt][0] - 8 * qx[nt][0]), s0),
                __fmul_rn((float)(p[na][nt][1] - 8 * qx[nt][1]), s0),
                __fmul_rn((float)(p[na][nt][2] - 8 * qx[nt][2]), s1),
                __fmul_rn((float)(p[na][nt][3] - 8 * qx[nt][3]), s1)};
            const int mm[4] = {m, m + 1, m, m + 1}, cc[4] = {c0, c0, c1, c1};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pg[mm[e] * WN + cc[e]] = v[e];
              p[na][nt][e] = 0;
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) qx[nt][e] = 0;
      }
    }
    __syncthreads();   // the round's products are all written
    const int nrg = min(SMALL_WARPS * gpu, ng - g_round);
    for (int gi = 0; gi < nrg; ++gi)
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int o = tid + i * SMALL_THREADS;
        if (OUTS % SMALL_THREADS == 0 || o < OUTS)
          acc[i] = __fadd_rn(acc[i], pr[(size_t)gi * OUTS + o]);
      }
  }
  // output o = tid + i*256 is (m, c) = (o / WN, o % WN)
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = tid + i * SMALL_THREADS, c = o % WN, m = m0 + o / WN;
    if ((OUTS % SMALL_THREADS == 0 || o < OUTS) && m < M)
      y[(size_t)m * N + n0 + c] = acc[i] * xscale[m];
  }
}

// ------------------------------------------------------------ wgmma
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the wait
template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// a K-major operand of 128-byte rows in 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO), the leading offset unused (1), layout type 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d += x * w^T on 64 token rows: x signed int8, w the weights' unsigned
// codes; Wgmma<8> against a tile of ones gives each row's sum(x)
template <int BN>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.u8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

constexpr int WG_TILES_RING = 2;   // unpacked weight tiles in flight

// shared memory of wgmma_kernel: `stages` slots of [xq rows, swizzled |
// raw words | one scale row, padded to 1 KB], WG_TILES_RING unpacked
// weight tiles, 8 rows of ones, the mbarriers, and 1 KB to align the base
// to the swizzle's 1024 bytes
__host__ __device__ inline size_t wgmma_slot_bytes(int bm, int bn) {
  return (size_t)bm * KS + (size_t)bn * KS / 2 + 1024;
}
__host__ __device__ inline size_t wgmma_smem(int bm, int bn, int stages) {
  return stages * wgmma_slot_bytes(bm, bn) +
         WG_TILES_RING * (size_t)bn * KS + 1024 + 256 + 1024;
}

// WM consumer warpgroups (wgmma on 64 token rows each, the group fold, the
// epilogue) and one producer warpgroup (the copies and the unpack), in
// one pipeline: the producer keeps `stages - 2` stages of copies or fewer
// in flight ahead of the one it unpacks into one of two tiles (`full`);
// the consumers release a tile once its MMAs are waited for (`tfree`),
// and a slot's xq rows and scales once the group they end is folded
// (`xfree`).
template <class L, int WM, int BN>
__global__ void __launch_bounds__((WM + 1) * 128, 1)
wgmma_kernel(const int8_t* __restrict__ xq, const void* __restrict__ w,
             const float* __restrict__ scales,
             const float* __restrict__ xscale, float* __restrict__ y, int M,
             int N, int K, int G, int stages) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  constexpr int BM = 64 * WM, KC = KS, NR = BN / 2, TT = WG_TILES_RING;
  constexpr size_t X_B = (size_t)BM * KC, RAW_B = (size_t)BN * KC / 2;
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const size_t slot_b = wgmma_slot_bytes(BM, BN);
  int8_t* tiles = reinterpret_cast<int8_t*>(smem + stages * slot_b);
  uint32_t* ones = reinterpret_cast<uint32_t*>(tiles + TT * BN * KC);
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + 256);
  uint64_t* tfree = full + TT;
  uint64_t* xfree = tfree + TT;   // [stages]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bool gathered = L::STRIDED && G > KC;
  const int nst = K / KC;
  const Div dg = make_div(G), dspg = make_div(gathered ? G / KS : 1);
  auto slot = [&](int t) { return smem + (size_t)(t % stages) * slot_b; };
  if (tid == 0) {
    for (int i = 0; i < TT; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&tfree[i], WM * 4);
    }
    for (int i = 0; i < stages; ++i) mbar_init(&xfree[i], WM * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 256; i += blockDim.x) ones[i] = 0x01010101u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == WM) {   // ---------------------------------------- producer
    const int pt = tid - WM * 128;
    // copies in batches of `batch` consecutive stages, `ahead` past the
    // one unpacked; the last stage a batch fills is t + stages - 2, whose
    // slot stage t - 2 released (its consumers got stage t - 1 first)
    const int batch = stages >= 7 ? 4 : stages >= 5 ? 2 : 1;
    const int ahead = stages - 1 - batch;
    auto issue = [&](int u) {
      if (u < nst) {
        if (u >= stages)   // stage u - stages released its slot
          mbar_wait(&xfree[u % stages], ((u / stages) - 1) & 1);
        const Stage st = stage_at(u, G, gathered, dspg);
        uint8_t* s = slot(u);
        copy_x<BM, 128>(SwizzledTile{reinterpret_cast<int8_t*>(s)}, xq, m0,
                        st, M, K, G, pt);
        L::template copy<BN, 128, KS / 2>(s + X_B, w, n0, st, N, K, G, pt);
        copy_scales<BN, 128>(reinterpret_cast<float*>(s + X_B + RAW_B),
                             scales, n0, st, N, dg, pt);
      }
      cp_commit();
    };
    for (int u = 0; u < ahead; ++u) issue(u);
    for (int t = 0; t < nst; ++t) {
      if (t % batch == 0)
        for (int b = 0; b < batch; ++b) issue(t + ahead + b);
      // this thread's copies of stage t have landed: all but the newest of
      // the ahead + batch * (t / batch + 1) groups committed
      cp_wait(ahead + batch * (t / batch + 1) - (t + 1));
      // ... and every producer thread's: the unpack reads words another
      // thread copied
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (t >= TT) mbar_wait(&tfree[t % TT], ((t / TT) - 1) & 1);
      L::template unpack<BN, 128, KS / 2>(slot(t) + X_B,
                                  SwizzledTile{tiles + (t % TT) * BN * KC},
                                  stage_at(t, G, gathered, dspg), G,
                                  pt);
      // the tile and the xq rows this thread wrote, to the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[t % TT]);
    }
    return;
  }

  // ------------------------------------------------------ consumers
  const int wwarp = (tid & 127) >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int d[NR], qx[4];   // the group's sum(u * x); each row's sum(x)
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    d[i] = 0;
    acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) qx[i] = 0;
  // d[4i + e]: row 16*wwarp + gid + 8*(e / 2) of the warpgroup's 64,
  // column 8i + 2*tig + e % 2; qx[0] the first row's sum(x), qx[2] the
  // second's. The signed codes' sums: d - 8 * qx, exact
  auto fold = [&](const float* sc) {
    const int c0 = 8 * qx[0], c1 = 8 * qx[2];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * i + 2 * tig);
      acc[4 * i] =
          __fadd_rn(acc[4 * i], __fmul_rn((float)(d[4 * i] - c0), s2.x));
      acc[4 * i + 1] = __fadd_rn(
          acc[4 * i + 1], __fmul_rn((float)(d[4 * i + 1] - c0), s2.y));
      acc[4 * i + 2] = __fadd_rn(
          acc[4 * i + 2], __fmul_rn((float)(d[4 * i + 2] - c1), s2.x));
      acc[4 * i + 3] = __fadd_rn(
          acc[4 * i + 3], __fmul_rn((float)(d[4 * i + 3] - c1), s2.y));
    }
  };
  // stage t's MMAs waited for: its tile released; its group folded if it
  // ends there; its slot released
  auto retire = [&](int t) {
    wg_wait0();
    reg_fence(d);
    reg_fence(qx);
    __syncwarp();
    if (lane == 0) mbar_arrive(&tfree[t % TT]);
    if (stage_at(t, G, gathered, dspg).n_ending(dg))
      fold(reinterpret_cast<const float*>(slot(t) + X_B + RAW_B));
    __syncwarp();
    if (lane == 0) mbar_arrive(&xfree[t % stages]);
  };
  for (int t = 0; t < nst; ++t) {
    mbar_wait(&full[t % TT], (t / TT) & 1);
    if (t > 0) retire(t - 1);
    const Stage st = stage_at(t, G, gathered, dspg);
    const bool fresh = st.i0 < 0 ? dg.r(st.k0) == 0 : st.i0 == 0;
    const uint64_t da = sw128_desc(slot(t) + (size_t)wg * 64 * KC);
    const uint64_t db = sw128_desc(tiles + (t % TT) * BN * KC);
    const uint64_t d1 = sw128_desc(ones);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KC / 32; ++j) {  // 32 bytes further: + 2 (16-B units)
      const int acc_d = (j > 0 || !fresh) ? 1 : 0;
      Wgmma<BN>::mma(d, da + 2 * j, db + 2 * j, acc_d);
      Wgmma<8>::mma(qx, da + 2 * j, d1 + 2 * j, acc_d);
    }
    wg_commit();
  }
  retire(nst - 1);

  const int r0 = m0 + 64 * wg + 16 * wwarp + gid, r1 = r0 + 8;
  const float xs0 = r0 < M ? xscale[r0] : 0.f, xs1 = r1 < M ? xscale[r1] : 0.f;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * tig;
    if (r0 < M)
      *reinterpret_cast<float2*>(y + (size_t)r0 * N + col) =
          make_float2(acc[4 * i] * xs0, acc[4 * i + 1] * xs0);
    if (r1 < M)
      *reinterpret_cast<float2*>(y + (size_t)r1 * N + col) =
          make_float2(acc[4 * i + 2] * xs1, acc[4 * i + 3] * xs1);
  }
}

// The general path, for the shapes the tiled paths do not take: a group
// size that is not a multiple of 32 (JAX's "tpu_strided" K1 runs G = 8,
// 16, 24, ...), K % 32 != 0 or N % 64 != 0. One thread per output (m, n):
// each group's partial sum is exact in int32, folded into float32 with the
// group scale in group order, mul and add kept apart, as the tiled kernels
// fold it. Slow (the weight is read one code a thread); right for shapes
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

inline int opt_in_smem() {   // the card's per-block opt-in maximum, once
  static int v = 0;
  if (v == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return v;
}

// Does the plan fit the shape and the kernels? (The C entries take it from
// the wrapper's gemm_plan; a plan that does not fit is refused, not run.)
template <class L>
bool plan_ok(const Plan& p, int M, int N, int K, int G) {
  if (K % KS || G % 32 || (G % KS && KS % G) || p.bn < 16 || N % p.bn ||
      p.stages < 3 || p.stages > 8)
    return false;
  if (p.path == SMALL) {
    if (!(p.mt == 8 || p.mt == 16 || p.mt == 32) ||
        !(p.bn == 16 || p.bn == 32) || p.ku < KS || p.ku % KS ||
        p.ku % G)
      return false;
    return small_smem(p.mt, p.bn, p.ku, p.stages, G, L::DIRECT) <=
           (size_t)opt_in_smem();
  }
  if (p.path == WGMMA)   // the plan's two tiles: 64 x 64 and 128 x 128
    return ((p.mt == 64 && p.bn == 64) || (p.mt == 128 && p.bn == 128)) &&
           G % KS == 0 &&
           wgmma_smem(p.mt, p.bn, p.stages) <= (size_t)opt_in_smem();
  return false;
}

template <class L, int MT, int WN>
int launch_small(const void* xq, const void* w, const void* scales,
                 const void* xscale, void* y, int M, int N, int K, int G,
                 const Plan& p, cudaStream_t st) {
  auto kernel = small_kernel<L, MT, WN>;
  static bool opted_in = false;   // past the default 48 KB, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const size_t smem = small_smem(MT, WN, p.ku, p.stages, G, L::DIRECT);
  kernel<<<dim3(N / WN, (M + MT - 1) / MT), SMALL_THREADS, smem, st>>>(
      (const int8_t*)xq, w, (const float*)scales, (const float*)xscale,
      (float*)y, M, N, K, G, p.ku, p.stages);
  return (int)cudaGetLastError();
}

template <class L, int WM, int BN>
int launch_wgmma(const void* xq, const void* w, const void* scales,
                 const void* xscale, void* y, int M, int N, int K, int G,
                 const Plan& p, cudaStream_t st) {
  auto kernel = wgmma_kernel<L, WM, BN>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<dim3(N / BN, (M + 64 * WM - 1) / (64 * WM)), 128 * (WM + 1),
           wgmma_smem(64 * WM, BN, p.stages), st>>>(
      (const int8_t*)xq, w, (const float*)scales, (const float*)xscale,
      (float*)y, M, N, K, G, p.stages);
  return (int)cudaGetLastError();
}

// one entry's launch: the plan's path, L the layout of the tiled paths,
// Code its code for the general path
template <class L, class Code>
int launch(const void* xq, const void* w, const void* scales,
           const void* xscale, void* y, int M, int N, int K, int G,
           const Plan& p, cudaStream_t st) {
  if (p.path == GENERAL)
    return launch_any_group<Code>(xq, w, scales, xscale, y, M, N, K, G, st);
  if (!plan_ok<L>(p, M, N, K, G)) return (int)cudaErrorInvalidValue;
#define NCTT_SMALL(MT_, WN_)                                               \
  if (p.mt == MT_ && p.bn == WN_)                                          \
    return launch_small<L, MT_, WN_>(xq, w, scales, xscale, y, M, N, K, G, \
                                     p, st);
  if (p.path == SMALL) {
    NCTT_SMALL(8, 16) NCTT_SMALL(8, 32) NCTT_SMALL(16, 16)
    NCTT_SMALL(16, 32) NCTT_SMALL(32, 16) NCTT_SMALL(32, 32)
  }
#undef NCTT_SMALL
  if (p.mt == 64)
    return launch_wgmma<L, 1, 64>(xq, w, scales, xscale, y, M, N, K, G, p, st);
  return launch_wgmma<L, 2, 128>(xq, w, scales, xscale, y, M, N, K, G, p, st);
}

}  // namespace w4a8
}  // namespace nctt
