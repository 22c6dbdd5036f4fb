// The streaming core of the two M == 1 products over "tpu_strided" words:
// K9 (vpu_gemv, csrc/vpu_gemv.cu: float32 sums) and K10 (vpu_int8act,
// csrc/vpu_int8act.cu: int32 sums with a fixed float tail), y[n] = x .
// dequant(W)[:, n] for one row x [K].
//
// Operands as the JAX package stores them: 32-bit words w [K/P, N] (P =
// 32 / bits fields a word; field s of word row g*WPG + i, WPG = G / P,
// holds the weight at k = g*G + s*WPG + i), float32 scales and optional
// zero points [K/G, N].
//
// Bound on this card: bytes. Each word is read once; the operations (2KN
// multiply-adds, 8 fields a 4-byte word) stay far under the float32 and
// int8 rates.
//
// Design (the plan, kernels/dequant_matmul.py gemv_plan, cached per shape;
// the entries refuse a plan that does not fit, plan_ok):
//  * a block owns a strip of 128 columns (32 lanes x 4) and a range of
//    whole groups, blockIdx = (strip, split of K); K10's ranges are whole
//    tiles of tk (its float tail folds tile by tile). The block's warps
//    share the range, each a contiguous run of its groups;
//  * each warp streams its runs' word rows through its own ring of
//    `stages` slots by 16-byte cp.async (a lane's four columns of a row),
//    a slot `rows` word rows of one group and, in a group's first slot,
//    the group's scale and zero rows: read once a group, no load waits for
//    another, and only __syncwarp orders a ring;
//  * x is staged once per block in shared memory for the block's groups,
//    while the rings' first copies fly, in the order the lanes read it:
//    word row i's P values at [i][(s % FB) * 4 + s / FB] (FB = 8 / bits
//    fields a byte), so the four fields that one mask of a word leaves in
//    its four bytes find their x in one 16-byte (K9: floats) or 4-byte
//    (K10: int8 codes) shared load, the same for all lanes; each group's
//    sum of x (K10: of the codes) comes from a warp reduction;
//  * K9: a field u becomes the float 2^23 + u by one byte permute into the
//    exponent bits 0x4B, u by an exact float subtract, then an FFMA: no
//    integer-to-float conversion. Per group and column
//      acc += s * (sum u x - (2^(b-1) + z) * sum x);
//  * K10: x quantized per tensor as the jitted JAX program does it (each
//    block finds max|x| over all of K: xs = max(max|x|, 1e-6) * f32(1/127),
//    codes rint(x / xs) with a true division, clipped to +-127), four
//    fields a mask as bytes against four codes by __dp4a (exact in int32 in
//    any order), then per group af = f32(a) - (2^(b-1) + z) * f32(b); per
//    tile part = fma(s, af, part) over its groups in order; acc =
//    fma(part, xs, acc) over the tiles in order: the TPU kernel's float
//    work, bit for bit with vpu_int8act_plain;
//  * one launch a call: where the plan splits K, each block writes its
//    partial (K9: its sum; K10: each tile's part) to the workspace, and the
//    last block of the strip (an atomic ticket taken after __threadfence,
//    reset by that block) folds them in order (K9 with __fadd_rn in split
//    order, K10 the whole chain of tiles with __fmaf_rn), so the card gives
//    the same bits from run to run.
#pragma once

#include "nctt_common.cuh"

namespace nctt_gemv {

using nctt::cp_async;
using nctt::cp_commit;
using nctt::cp_wait;

constexpr int BN = 128;           // a block's columns: 32 lanes x 4
constexpr int MAX_ROWS = 16;      // word rows a ring slot, at most
constexpr int MAX_WARPS = 8;
constexpr float TWO23 = 8388608.f;   // 2^23

// The words of the argument block (kernels/dequant_matmul.py
// gemv_workspace), 64 bits each: the workspace's addresses, then the plan
enum PlanWord {
  W_PART, W_TICKETS, W_WARPS, W_STAGES, W_ROWS, W_SPLITS, W_PER, W_NGK,
  W_SMEM, PLAN_WORDS
};

struct Plan {
  float* part;      // float32 partials (splits > 1)
  int* tickets;     // int32, one a strip, zero (the folding block resets it)
  int warps;        // a block's warps: 4 or 8
  int stages;       // ring slots a warp: 2..4
  int rows;         // word rows a slot: a divisor of G / P, <= MAX_ROWS
  int splits;       // blocks along K
  int per;          // units a split (K9: groups; K10: tiles of ngk groups)
  int ngk;          // groups a unit
  int smem;         // dynamic shared memory (layout().total)
};

inline Plan read_plan(const void* block) {
  const long long* w = static_cast<const long long*>(block);
  return Plan{reinterpret_cast<float*>(w[W_PART]),
              reinterpret_cast<int*>(w[W_TICKETS]), (int)w[W_WARPS],
              (int)w[W_STAGES], (int)w[W_ROWS], (int)w[W_SPLITS],
              (int)w[W_PER], (int)w[W_NGK], (int)w[W_SMEM]};
}

__host__ __device__ inline int up16(int b) { return (b + 15) & ~15; }

// Dynamic shared memory, byte offsets: the warps' rings (slots of `rows`
// word rows, then a scale row and a zero row, 512 bytes each), x for the
// block's `groups` groups (K9 float32, K10 int8 codes), the groups' sums
// of x, the fold (K9: each warp's sums; K10: each group's af and scale),
// a word a warp for the block's max|x|.
struct Layout {
  int slot, xs, gsum, fold, red, total;
};

__host__ __device__ inline Layout layout(bool k10, int G, int warps,
                                         int stages, int rows, int groups) {
  Layout L;
  L.slot = (rows + 2) * BN * 4;
  L.xs = warps * stages * L.slot;
  L.gsum = L.xs + up16(groups * G * (k10 ? 1 : 4));
  L.fold = L.gsum + up16(groups * 4);
  L.red = L.fold + (k10 ? 2 * groups * BN * 4 : warps * BN * 4);
  L.total = L.red + MAX_WARPS * 4;
  return L;
}

// Whether a plan fits the shape and the kernels: bits 2 or 4, N % 4 == 0,
// K % G == 0, G % P == 0, (K / G) % ngk == 0, the plan's own rules and the
// workspace where K is split.
inline bool plan_ok(const Plan& p, int N, int K, int G, int bits, int ngk,
                    bool k10) {
  const int P = bits == 2 || bits == 4 ? 32 / bits : 0;
  if (!P || N < 4 || N % 4 || G < P || G % P || K < G || K % G ||
      ngk < 1 || (K / G) % ngk)
    return false;
  const int nunits = K / G / ngk;
  if (p.ngk != ngk || !(p.warps == 4 || p.warps == 8) || p.stages < 2 ||
      p.stages > 4 || p.rows < 1 || p.rows > MAX_ROWS ||
      (G / P) % p.rows || p.per < 1 ||
      p.splits != (nunits + p.per - 1) / p.per)
    return false;
  if (p.splits > 1 && (!p.part || !p.tickets)) return false;
  const Layout L = layout(k10, G, p.warps, p.stages, p.rows, p.per * ngk);
  return p.smem == L.total && L.total <= nctt::MAX_DYN_SMEM;
}

struct Args {
  const void* x;           // [K] bf16 or f32
  const uint32_t* w;       // [K/P, N]
  const float* scales;     // [K/G, N]
  const float* zeros;      // [K/G, N] or null
  void* out;               // [N] bf16 or f32
  float* part;             // K9 [splits, N]; K10 [K/tk, N] (splits > 1)
  int* tickets;            // [N / BN] (splits > 1)
  int N, K, G, out_bf16, warps, stages, rows, splits, per, ngk;
  Layout L;
};

inline Args make_args(const void* x, const void* w, const void* scales,
                      const void* zeros, void* out, const Plan& p, int N,
                      int K, int G, int out_bf16, bool k10) {
  return Args{x, static_cast<const uint32_t*>(w),
              static_cast<const float*>(scales),
              static_cast<const float*>(zeros), out, p.part, p.tickets, N,
              K, G, out_bf16, p.warps, p.stages, p.rows, p.splits, p.per,
              p.ngk,
              layout(k10, G, p.warps, p.stages, p.rows, p.per * p.ngk)};
}

__device__ __forceinline__ void store_out(void* out, int i, float v,
                                          int out_bf16) {
  if (out_bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[i] = v;
}

// byte b (< 16) of f as a float: 2^23 + f_b under the exponent bits 0x4B
// by one byte permute, less 2^23 (exact)
__device__ __forceinline__ float field(uint32_t f, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(f, 0x4B000000u, 0x7440 + b)),
                   TWO23);
}

// eight consecutive values of x from k (k % 8 == 0, x 16-byte aligned)
__device__ __forceinline__ void ld8(const float* x, int k, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x + k));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x + k + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* x, int k,
                                    float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + k));
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
  }
}

// The first chunks of eight values of x a thread takes (chunk i * nt + tid
// for i < C, 32 registers either way), loaded before the rings' first
// copies so that they lead the SM's memory queue; the rest is loaded when
// it is used.
template <typename XT>
struct Ahead {
  static constexpr int C = sizeof(XT) == 2 ? 8 : 4;   // chunks held
  static constexpr int V = sizeof(XT) == 2 ? 1 : 2;   // 16-byte loads a chunk
  uint4 r[C * V];
  // chunks of x from k0, those below n
  __device__ __forceinline__ void load(const XT* x, int k0, int n, int nt) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = i * nt + threadIdx.x;
      if (c < n)
#pragma unroll
        for (int v = 0; v < V; ++v)
          r[i * V + v] =
              __ldg(reinterpret_cast<const uint4*>(x + k0 + 8 * c) + v);
    }
  }
  __device__ __forceinline__ void get(int i, float (&v)[8]) const {
    if constexpr (V == 1) {
      const uint32_t u[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(u[j] << 16);
        v[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
      }
    } else {
      const uint4 a = r[2 * i], b = r[2 * i + 1];
      const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(u[j]);
    }
  }
};

// max|x| over x[0, K) for every thread of the block: the chunks held, the
// rest loaded, then the warps' maxima through `red`
template <typename XT>
__device__ float block_amax(const Ahead<XT>& xa, const XT* x, int K,
                            float* red, int warps) {
  const int nt = warps * 32, n = K / 8;
  float m = 0.f, v[8];
#pragma unroll
  for (int i = 0; i < Ahead<XT>::C; ++i)
    if (i * nt + (int)threadIdx.x < n) {
      xa.get(i, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  for (int c = Ahead<XT>::C * nt + threadIdx.x; c < n; c += nt) {
    ld8(x, 8 * c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  m = nctt::warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = red[0];
  for (int i = 1; i < warps; ++i) amax = fmaxf(amax, red[i]);
  return amax;
}

// One round of stage_x: chunk c (values v) into the stage, and the sums of
// its group where the group's chunks are whole runs of lanes (seg); every
// lane of the warp takes part
template <bool K10, int BITS>
__device__ __forceinline__ void stage_chunk(const Args& a, int c, int chunks,
                                            const float (&v)[8], float xs,
                                            nctt::Div dw, nctt::Div dg,
                                            bool seg, uint8_t* smem) {
  constexpr int P = 32 / BITS, FB = 8 / BITS;
  const int G = a.G, cpg = G / 8;
  float fs = 0.f;
  int is = 0;
  if (c < chunks) {
    const int gl = dg.q(8 * c), kk0 = dg.r(8 * c);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = dw.q(kk0 + e), r = dw.r(kk0 + e);
      const int at = gl * G + r * P + (s % FB) * 4 + s / FB;
      if constexpr (K10) {
        const float q =
            fminf(fmaxf(rintf(__fdiv_rn(v[e], xs)), -127.f), 127.f);
        reinterpret_cast<int8_t*>(smem + a.L.xs)[at] = (int8_t)q;
        is += (int)q;
      } else {
        reinterpret_cast<float*>(smem + a.L.xs)[at] = v[e];
        fs += v[e];
      }
    }
  }
  if (seg) {   // chunks c of a group are lanes [cpg j, cpg (j + 1))
    for (int o = 1; o < cpg; o <<= 1) {
      if constexpr (K10)
        is += __shfl_xor_sync(nctt::FULL_MASK, is, o);
      else
        fs += __shfl_xor_sync(nctt::FULL_MASK, fs, o);
    }
    if (c < chunks && (threadIdx.x & (cpg - 1)) == 0) {
      if constexpr (K10)
        reinterpret_cast<int*>(smem + a.L.gsum)[c / cpg] = is;
      else
        reinterpret_cast<float*>(smem + a.L.gsum)[c / cpg] = fs;
    }
  }
}

// x (K9: as float32, its first chunks from `xa`) or its int8 codes (K10,
// scale xs) for the block's groups [g0, g0 + nb) in the lanes' field
// order, and each group's sum. Every thread takes eight consecutive k at a
// time; a group's sum comes from the lanes that hold it by xor shuffles
// where its chunks of eight are a power-of-two run of at most 32 lanes (G
// <= 256), else from a warp a group over the staged values: a fixed order
// either way
template <bool K10, typename XT, int BITS>
__device__ void stage_x(const Args& a, const XT* x, const Ahead<XT>& xa,
                        int g0, int nb, float xs, uint8_t* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.G, nt = a.warps * 32, cpg = G / 8;
  const nctt::Div dw = nctt::make_div(G / (32 / BITS)), dg = nctt::make_div(G);
  const bool seg = cpg <= 32 && !(cpg & (cpg - 1));
  const int chunks = nb * cpg, rounds = (chunks + nt - 1) / nt;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < Ahead<XT>::C; ++i) {
    if (i < rounds) {   // uniform: every lane of the block
      const int c = i * nt + threadIdx.x;
      if (c < chunks) {
        if constexpr (K10)
          ld8(x, g0 * G + 8 * c, v);   // in L1 since block_amax
        else
          xa.get(i, v);
      }
      stage_chunk<K10, BITS>(a, c, chunks, v, xs, dw, dg, seg, smem);
    }
  }
  for (int i = Ahead<XT>::C; i < rounds; ++i) {
    const int c = i * nt + threadIdx.x;
    if (c < chunks) ld8(x, g0 * G + 8 * c, v);
    stage_chunk<K10, BITS>(a, c, chunks, v, xs, dw, dg, seg, smem);
  }
  if (seg) return;
  __syncthreads();
  const float* xf = reinterpret_cast<const float*>(smem + a.L.xs);
  const int8_t* xc = reinterpret_cast<const int8_t*>(smem + a.L.xs);
  for (int gl = warp; gl < nb; gl += a.warps) {
    float fs = 0.f;
    int is = 0;
    for (int kk = lane; kk < G; kk += 32) {
      if constexpr (K10)
        is += xc[gl * G + kk];
      else
        fs += xf[gl * G + kk];
    }
    if constexpr (K10) {
#pragma unroll
      for (int o = 16; o; o >>= 1)
        is += __shfl_xor_sync(nctt::FULL_MASK, is, o);
      if (lane == 0) reinterpret_cast<int*>(smem + a.L.gsum)[gl] = is;
    } else {
      fs = nctt::warp_sum(fs);
      if (lane == 0) reinterpret_cast<float*>(smem + a.L.gsum)[gl] = fs;
    }
  }
}

template <bool K10, typename XT, int BITS>
__device__ __forceinline__ void gemv_body(const Args& a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int P = 32 / BITS, FB = 8 / BITS;
  // one field in each byte of a word shifted by BITS * j
  constexpr uint32_t BMASK = ((1u << BITS) - 1u) * 0x01010101u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.warps, N = a.N, G = a.G, R = a.rows, ST = a.stages;
  const int WPG = G / P, ng = a.K / G, CPG = WPG / R;
  const int n0 = blockIdx.x * BN, col = n0 + 4 * lane;
  const bool live = col < N;            // N % 4 == 0: all four or none
  // the block's groups [bg0, bg0 + nb), the warp's [wg0, wg1)
  const int bg0 = min((int)blockIdx.y * a.per * a.ngk, ng);
  const int nb = min(bg0 + a.per * a.ngk, ng) - bg0;
  const int wg0 = bg0 + warp * nb / W, wg1 = bg0 + (warp + 1) * nb / W;
  const int nq = (wg1 - wg0) * CPG;     // the warp's slots
  uint8_t* ring = smem + (size_t)warp * ST * a.L.slot + lane * 16;
  int si = 0;   // the slot issue() fills next

  // slot q: rows ci*R .. ci*R + R - 1 of group wg0 + q / CPG (ci = q %
  // CPG), at the lane's four columns; the group's scale and zero rows with
  // its first slot
  auto issue = [&](int q) {
    if (q < nq) {
      uint8_t* s = ring + si * a.L.slot;
      const int gq = q / CPG, ci = q - gq * CPG, g = wg0 + gq;
      const uint32_t* src = a.w + ((size_t)g * WPG + ci * R) * N + col;
      for (int r = 0; r < R; ++r)
        cp_async<16>(s + r * BN * 4, live ? src + (size_t)r * N : a.w, live);
      if (ci == 0) {
        const size_t at = (size_t)g * N + col;
        cp_async<16>(s + R * BN * 4, live ? a.scales + at : a.scales, live);
        if (a.zeros)
          cp_async<16>(s + (R + 1) * BN * 4, live ? a.zeros + at : a.zeros,
                       live);
      }
    }
    si = si + 1 == ST ? 0 : si + 1;
    cp_commit();   // empty past the warp's last slot: uniform counts
  };
  // x's first chunks (K10: of all of K, for max|x|; K9: of the block's
  // groups) ahead of the rings' first copies, the staging while they fly
  const XT* x = static_cast<const XT*>(a.x);
  const int nt = W * 32;
  Ahead<XT> xa;
  if (K10)
    xa.load(x, 0, a.K / 8, nt);
  else
    xa.load(x, bg0 * G, nb * G / 8, nt);
  const int ahead = ST - 1;
  for (int q = 0; q < ahead; ++q) issue(q);
  float xs = 0.f;
  if constexpr (K10)
    xs = __fmul_rn(fmaxf(block_amax(xa, x, a.K,
                                    reinterpret_cast<float*>(smem + a.L.red),
                                    W),
                         1e-6f),
                   1.0f / 127.0f);
  stage_x<K10, XT, BITS>(a, x, xa, bg0, nb, xs, smem);
  __syncthreads();

  const float half = (float)(1 << (BITS - 1));
  const float* xf = reinterpret_cast<const float*>(smem + a.L.xs);
  const int8_t* xc = reinterpret_cast<const int8_t*>(smem + a.L.xs);
  float* fold = reinterpret_cast<float*>(smem + a.L.fold);
  // the lane's four columns: K9's sums over the warp's groups and the
  // group's sums of u x; K10's group sums of u xq; the group's scale and
  // offset 2^(b-1) + z
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, sa[4] = {0.f, 0.f, 0.f, 0.f};
  int ia[4] = {0, 0, 0, 0};
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, of[4] = {0.f, 0.f, 0.f, 0.f};
  for (int q = 0, cs = 0; q < nq; ++q, cs = cs + 1 == ST ? 0 : cs + 1) {
    cp_wait(ahead - 1);   // slot q (ring slot cs) has landed ...
    __syncwarp();         // ... for every lane; slot q - 1 is done with
    issue(q + ahead);     // into the slot of q - 1
    const uint8_t* s = ring + cs * a.L.slot;
    const int gq = q / CPG, ci = q - gq * CPG, gl = wg0 + gq - bg0;
    if (ci == 0) {
      const float4 s4 = *reinterpret_cast<const float4*>(s + R * BN * 4);
      float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a.zeros) z4 = *reinterpret_cast<const float4*>(s + (R + 1) * BN * 4);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[c] = sv[c];
        of[c] = a.zeros ? __fadd_rn(half, zv[c]) : half;
        sa[c] = 0.f;
        ia[c] = 0;
      }
    }
    const int r0 = gl * G + ci * R * P;   // the slot's first x in the stage
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const uint4 wv = *reinterpret_cast<const uint4*>(s + r * BN * 4);
      const uint32_t wd[4] = {wv.x, wv.y, wv.z, wv.w};
      if constexpr (K10) {
        uint32_t xq[FB];
        if constexpr (P == 8) {
          const uint2 v = *reinterpret_cast<const uint2*>(xc + r0 + r * P);
          xq[0] = v.x;
          xq[1] = v.y;
        } else {
          const uint4 v = *reinterpret_cast<const uint4*>(xc + r0 + r * P);
          xq[0] = v.x;
          xq[1] = v.y;
          xq[2] = v.z;
          xq[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < FB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ia[c] = __dp4a((int)((wd[c] >> (BITS * j)) & BMASK), (int)xq[j],
                           ia[c]);
      } else {
        const float4* xv = reinterpret_cast<const float4*>(xf + r0 + r * P);
#pragma unroll
        for (int j = 0; j < FB; ++j) {
          const float4 xj = xv[j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t f = (wd[c] >> (BITS * j)) & BMASK;
            sa[c] = fmaf(field(f, 0), xj.x, sa[c]);
            sa[c] = fmaf(field(f, 1), xj.y, sa[c]);
            sa[c] = fmaf(field(f, 2), xj.z, sa[c]);
            sa[c] = fmaf(field(f, 3), xj.w, sa[c]);
          }
        }
      }
    }
    if (ci == CPG - 1) {   // the group's last slot
      if constexpr (K10) {
        const float fb =
            __int2float_rn(reinterpret_cast<const int*>(smem + a.L.gsum)[gl]);
        float af[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          af[c] = __fsub_rn(__int2float_rn(ia[c]), __fmul_rn(of[c], fb));
        *reinterpret_cast<float4*>(fold + gl * BN + 4 * lane) =
            make_float4(af[0], af[1], af[2], af[3]);
        *reinterpret_cast<float4*>(fold + (nb + gl) * BN + 4 * lane) =
            make_float4(sc[0], sc[1], sc[2], sc[3]);
      } else {
        const float sb = reinterpret_cast<const float*>(smem + a.L.gsum)[gl];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[c] = fmaf(sc[c], __fsub_rn(sa[c], __fmul_rn(of[c], sb)),
                        acc[c]);
      }
    }
  }
  cp_wait(0);
  if (!K10)
    *reinterpret_cast<float4*>(fold + warp * BN + 4 * lane) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();

  // a thread a column: the block's result (K9: the warps' sums in warp
  // order; K10: each tile's part over its groups in order, and with one
  // split the chain of tiles)
  const int c = n0 + tid;
  const bool mine = tid < BN && c < N;
  const int nk = ng / a.ngk;   // K10's tiles
  float y = 0.f;
  if (mine) {
    if constexpr (K10) {
      for (int t = bg0 / a.ngk; t < (bg0 + nb) / a.ngk; ++t) {
        float part = 0.f;
        for (int gl = t * a.ngk - bg0; gl < (t + 1) * a.ngk - bg0; ++gl)
          part = __fmaf_rn(fold[(nb + gl) * BN + tid], fold[gl * BN + tid],
                           part);
        if (a.splits == 1)
          y = __fmaf_rn(part, xs, y);
        else
          a.part[(size_t)t * N + c] = part;
      }
    } else {
      y = fold[tid];
      for (int w = 1; w < W; ++w) y = __fadd_rn(y, fold[w * BN + tid]);
      if (a.splits > 1) a.part[(size_t)blockIdx.y * N + c] = y;
    }
  }
  if (a.splits == 1) {
    if (mine) store_out(a.out, c, y, a.out_bf16);
    return;
  }
  // K split across blocks: the last block of the strip folds in order
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + blockIdx.x;
  const int last = tid == 0 ? atomicAdd(ticket, 1) == a.splits - 1 : 0;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  if (mine) {
    if constexpr (K10) {
      y = 0.f;
      for (int t = 0; t < nk; ++t)
        y = __fmaf_rn(__ldcg(a.part + (size_t)t * N + c), xs, y);
    } else {
      y = __ldcg(a.part + c);
      for (int z = 1; z < a.splits; ++z)
        y = __fadd_rn(y, __ldcg(a.part + (size_t)z * N + c));
    }
    store_out(a.out, c, y, a.out_bf16);
  }
  if (tid == 0) *ticket = 0;
}

template <typename XT, int BITS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
vpu_gemv_kernel(const Args a) {
  gemv_body<false, XT, BITS>(a);
}

template <typename XT, int BITS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
vpu_int8act_kernel(const Args a) {
  gemv_body<true, XT, BITS>(a);
}

// One launch on `st`: grid (strips, splits), a.warps warps a block, the
// layout's dynamic shared memory (opted in past 48 KB once a kernel)
template <bool K10, typename XT, int BITS>
int launch(const Args& a, cudaStream_t st) {
  void (*kernel)(const Args);
  if constexpr (K10)
    kernel = vpu_int8act_kernel<XT, BITS>;
  else
    kernel = vpu_gemv_kernel<XT, BITS>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        nctt::MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<dim3((a.N + BN - 1) / BN, a.splits), a.warps * 32, a.L.total,
           st>>>(a);
  return (int)cudaGetLastError();
}

// bf16 or f32 x, bits 4 or 2 (the caller has checked both)
template <bool K10>
int dispatch(const Args& a, int bits, int x_bf16, cudaStream_t st) {
  if (x_bf16)
    return bits == 4 ? launch<K10, __nv_bfloat16, 4>(a, st)
                     : launch<K10, __nv_bfloat16, 2>(a, st);
  return bits == 4 ? launch<K10, float, 4>(a, st)
                   : launch<K10, float, 2>(a, st);
}

}  // namespace nctt_gemv
