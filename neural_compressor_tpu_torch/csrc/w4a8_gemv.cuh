// The column stream of the W4A8 products at M = 1 over "hopper_nk" words:
// K4 (fused_gemv, csrc/fused_gemv.cu) and the three phases of K17 (omlp,
// csrc/omlp.cu). y[n] = sum_g s_gn * sum_{k in g} xq_k c_kn: the int8 codes
// xq of the activation against the int4 codes c of column n.
//
// Operands as the port stores them: "hopper_nk" bytes w [N, K/2] (row n
// holds column n's K codes, two a byte, code 2j in byte j's low nibble,
// two's complement), so a run of consecutive columns is one contiguous run
// of bytes; float32 scales [K/G, N]; K % G == 0 and G % 128 == 0.
//
// Bound on this card: bytes. Each code is used once (2KN int8 operations
// on KN/2 bytes), far below the int8 rate; the job is to keep enough
// copies in flight to stream the words at the memory rate.
//
// Design (the plans: kernels/fused_matvec.py w4a8_gemv_plan and
// kernels/omlp_matvec.py omlp_plan, cached per shape; the C entries refuse
// a plan that does not fit):
//  * a persistent grid of `blocks` resident blocks; block b owns the output
//    columns [4 (b q / blocks), 4 ((b + 1) q / blocks)) of a product's n
//    (q = n / 4 quads, the last cut at n) and walks them
//    in a fixed order in tiles of `cols` consecutive columns (with silu a
//    tile is two runs, the gate columns and the up columns n + N/2), each
//    tile in `chunks` slots of `upc` units of 128 codes (whole K where it
//    fits);
//  * a producer warp streams the block's slots through a ring of `stages`
//    slots in shared memory: lane 0 expects the slot's bytes on its full
//    mbarrier, one cp.async.bulk (TMA's 1-D bulk copy) moves each run of
//    codes (each column where a tile takes several chunks) and each unit's
//    row of scales, [upc][runs x cols] (a group's scale repeated where G >
//    128; where a row is no whole 16 bytes, at a ragged end, the lanes copy
//    the scales by 4-byte cp.async, counted on the barrier as they land);
//    a slot is refilled once the consumer warps have arrived on its empty
//    mbarrier;
//  * eight consumer warps: warp w takes the slot's columns w, w + 8, ...;
//    its lanes read 16-byte vectors of a column (32 codes) from the slot and
//    the activation codes from shared memory (K4 past the plan's limit on
//    K: from global memory, written once by a first launch). A 32-bit word's
//    eight codes plus 8 (nibble ^ 8: no sign extension) go through two
//    __dp4a against the word's even and odd activation codes, which the
//    prologue stores apart for that; less 8 times the activation codes' sum
//    over each 128 (kept beside them) this is each 128 codes' exact int32
//    sum, summed over four lanes by two shuffles, times the group's float32
//    scale in float64 (an exact product), summed in float64 and rounded
//    once to float32: the arithmetic of gemv_dot.cuh's dot_column, which
//    the plain versions repeat in another order (29 bits more than the
//    float32 result: the order almost never shows);
//  * the activation prologue (sum of squares in float64, max |z|, the int8
//    codes) runs once a block, by the consumers, while the ring's first
//    copies fly; x comes in 16-byte loads.
#pragma once

#include "nctt_common.cuh"

namespace nctt_w4g {

using nctt::cp_async;
using nctt::mbar_arrive;
using nctt::mbar_wait;

constexpr int CWARPS = 8;                    // consumer warps a block
constexpr int CTHREADS = CWARPS * 32;
constexpr int THREADS = CTHREADS + 32;       // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MAX_CPW = 2;                   // a consumer warp's columns a tile
constexpr int MAX_RUNS = 2;                  // runs a tile (silu: 2)
// a full barrier's arrivals: the producer's lane 0, once the slot's copies
// are issued (cp.async copies add their own arrivals as they land)
constexpr int FULL_ARRIVALS = 1;
constexpr int RED_BYTES = 96;                // CWARPS doubles and floats
constexpr int CONSUMER_BAR = 1;              // the consumers' named barrier
constexpr int PRO_BATCH = 4;                 // the prologue's loads at once

__host__ __device__ inline int up16(int b) { return (b + 15) & ~15; }

// a slot's bytes: codes [runs x cols][upc x 64], scales [upc][runs x cols]
__host__ __device__ inline int slot_bytes(int runs, int cols, int upc) {
  return up16(runs * cols * upc * (64 + 4));
}

// One product of a block: its columns [c0, c1) of n_out, each (with silu)
// two runs of codes, column n and n + half of w.
struct Stream {
  const uint8_t* w;        // [N, K/2]
  const float* scales;     // [K/G, N]
  int K, G, N, half, runs;
  int cols, upc, chunks;
  int c0, c1;
  __device__ int tiles() const {
    return c1 > c0 ? (c1 - c0 + cols - 1) / cols : 0;
  }
  __device__ int slots() const { return tiles() * chunks; }
};

__device__ inline Stream make_stream(const uint8_t* w, const float* scales,
                                     int K, int G, int N, int n_out,
                                     bool silu, int cols, int upc) {
  const int nu = K / 128;
  const long long nb = gridDim.x, b = blockIdx.x, nq = (n_out + 3) / 4;
  return Stream{w, scales, K, G, N, silu ? n_out : 0, silu ? 2 : 1, cols,
                upc, (nu + upc - 1) / upc,
                min(n_out, 4 * (int)(b * nq / nb)),
                min(n_out, 4 * (int)((b + 1) * nq / nb))};
}

// the ring: `stages` slots of `slot` bytes at the start of the dynamic
// shared memory, then a full and an empty mbarrier a slot
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, slot;
};

__device__ inline Ring make_ring(uint8_t* smem, int stages, int slot) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * slot);
  return Ring{smem, bars, bars + stages, stages, slot};
}

// thread 0 sets the barriers up; the block syncs after
__device__ inline void init_ring(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      nctt::mbar_init(&r.full[s], FULL_ARRIVALS);
      nctt::mbar_init(&r.empty[s], CWARPS);
    }
    nctt::mbar_fence_init();
  }
}

// The producer warp: the stream's slots [from, to) into the ring, in the
// consumers' order; q counts the block's slots over every stream.
__device__ inline void produce(const Ring& R, const Stream& st, int from,
                               int to, int& q) {
  const int lane = threadIdx.x & 31;
  const int nu = st.K / 128, upg = st.G / 128, rc = st.runs * st.cols;
  const size_t wrow = (size_t)st.K / 2;
  const int kcb = st.upc * 64;                 // a run's bytes in a slot
  for (int i = from; i < to; ++i, ++q) {
    const int t = i / st.chunks, c = i - t * st.chunks;
    const int n0 = st.c0 + t * st.cols, tc = min(st.cols, st.c1 - n0);
    const int u0 = c * st.upc, uc = min(st.upc, nu - u0);
    const uint32_t cb = uc * 64;               // a column's bytes this slot
    const int s = q % R.stages;
    if (q >= R.stages) mbar_wait(&R.empty[s], ((q / R.stages) - 1) & 1);
    uint8_t* slot = R.base + (size_t)s * R.slot;
    float* ssc = reinterpret_cast<float*>(slot + rc * kcb);
    // the scales' rows by bulk copies where they are whole 16 bytes
    const bool rows16 = tc % 4 == 0 && st.N % 4 == 0 && st.half % 4 == 0;
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      nctt::mbar_expect_tx(&R.full[s], st.runs * tc * (cb + (rows16 ? uc * 4
                                                                   : 0)));
    }
    __syncwarp();
    if (st.chunks == 1) {                      // a run of columns a copy
      if (lane < st.runs)
        nctt::bulk_copy(slot + lane * st.cols * kcb,
                        st.w + (size_t)(n0 + lane * st.half) * wrow,
                        tc * cb, &R.full[s]);
    } else {                                   // a column a copy
      for (int e = lane; e < st.runs * tc; e += 32) {
        const int r = e / tc, j = e - r * tc;
        nctt::bulk_copy(slot + (r * st.cols + j) * kcb,
                        st.w + (size_t)(n0 + r * st.half + j) * wrow +
                            (size_t)u0 * 64,
                        cb, &R.full[s]);
      }
    }
    if (rows16) {
      for (int e = lane; e < uc * st.runs; e += 32) {
        const int ul = st.runs == 2 ? e >> 1 : e, r = e - ul * st.runs;
        nctt::bulk_copy(ssc + ul * rc + r * st.cols,
                        st.scales + (size_t)((u0 + ul) / upg) * st.N + n0 +
                            r * st.half,
                        tc * 4, &R.full[s]);
      }
    } else {
      const int per = st.runs * tc;
      for (int e = lane; e < uc * per; e += 32) {
        const int ul = e / per, rj = e - ul * per;
        const int r = rj / tc, j = rj - r * tc;
        cp_async<4>(ssc + ul * rc + r * st.cols + j,
                    st.scales + (size_t)((u0 + ul) / upg) * st.N + n0 +
                        r * st.half + j);
      }
      nctt::cp_async_arrive(&R.full[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&R.full[s]);
  }
}

// 32 codes of a column (16 bytes, four words) against their activation
// codes: e the even codes of each word, o the odd ones; codes plus 8
__device__ __forceinline__ int dot32(uint4 w, uint4 e, uint4 o, int acc) {
  const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
  const uint32_t ev[4] = {e.x, e.y, e.z, e.w};
  const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = __dp4a((int)((wv[i] & 0x0F0F0F0Fu) ^ 0x08080808u), (int)ev[i],
                 acc);
    acc = __dp4a((int)(((wv[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u),
                 (int)ov[i], acc);
  }
  return acc;
}

// The activation codes the consumers read: E32[c] (O32[c]) the even (odd)
// codes of the eight from k = 8c, gsum[m] the sum of the codes k in
// [128m, 128m + 128).
struct Codes {
  const uint32_t* e;
  const uint32_t* o;
  const int* gsum;
};

// The consumer warps: the stream's slots in order as they land; at a
// tile's last chunk epi(n, y_run0, y_run1) in lane 0 of the column's warp.
// With gmul, the scale of the group of unit u (128 codes) is first
// multiplied in float32 by gmul[u] (K17's down: its tile of h's scale, as
// the TPU kernel folds it).
template <class Epi>
__device__ void consume(const Ring& R, const Stream& st, Codes x,
                        const float* gmul, int& q, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nu = st.K / 128, rc = st.runs * st.cols;
  const int kcb = st.upc * 64;
  const int n = st.slots();
  double acc[MAX_CPW][MAX_RUNS];
#pragma unroll
  for (int a = 0; a < MAX_CPW; ++a)
#pragma unroll
    for (int r = 0; r < MAX_RUNS; ++r) acc[a][r] = 0.0;
  for (int i = 0; i < n; ++i, ++q) {
    const int t = i / st.chunks, c = i - t * st.chunks;
    const int n0 = st.c0 + t * st.cols, tc = min(st.cols, st.c1 - n0);
    const int u0 = c * st.upc, uc = min(st.upc, nu - u0);
    const int s = q % R.stages;
    mbar_wait(&R.full[s], (q / R.stages) & 1);
    const uint8_t* slot = R.base + (size_t)s * R.slot;
    const float* ssc = reinterpret_cast<const float*>(slot + rc * kcb);
    const int nv = uc * 4, vb = u0 * 4;        // vectors; the first's index
#pragma unroll
    for (int a = 0; a < MAX_CPW; ++a) {
      const int j = warp + a * CWARPS;
      if (j >= tc) break;                      // uniform in the warp
#pragma unroll
      for (int r = 0; r < MAX_RUNS; ++r) {
        if (r >= st.runs) break;
        const uint8_t* col = slot + (r * st.cols + j) * kcb;
        const float* sc = ssc + r * st.cols + j;
#pragma unroll 4
        for (int v0 = 0; v0 < nv; v0 += 32) {
          const int v = v0 + lane;
          int part = 0;
          if (v < nv) {
            const int vg = vb + v;
            const uint4 wv = *reinterpret_cast<const uint4*>(col + v * 16);
            const uint4 e = *reinterpret_cast<const uint4*>(x.e + 4 * vg);
            const uint4 o = *reinterpret_cast<const uint4*>(x.o + 4 * vg);
            part = dot32(wv, e, o, 0);
          }
          // lanes 4i..4i+3 hold 128 codes of one group
          part += __shfl_xor_sync(nctt::FULL_MASK, part, 1);
          part += __shfl_xor_sync(nctt::FULL_MASK, part, 2);
          if ((lane & 3) == 0 && v < nv) {
            const int ul = v >> 2;
            part -= 8 * x.gsum[u0 + ul];
            float f = sc[ul * rc];
            if (gmul) f = __fmul_rn(f, gmul[u0 + ul]);
            acc[a][r] += (double)part * (double)f;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&R.empty[s]);
    if (c == st.chunks - 1) {                  // the tile's last chunk
#pragma unroll
      for (int a = 0; a < MAX_CPW; ++a) {
        const int j = warp + a * CWARPS;
        if (j >= tc) break;
        const float y0 = (float)nctt::warp_sum(acc[a][0]);
        const float y1 =
            st.runs > 1 ? (float)nctt::warp_sum(acc[a][1]) : 0.f;
        if (lane == 0) epi(n0 + j, y0, y1);
        acc[a][0] = acc[a][1] = 0.0;
      }
    }
  }
}

// ------------------------------------------ the activation prologue
// (run by the CTHREADS consumer threads; the barriers are theirs)

__device__ __forceinline__ void consumers_sync() {
  nctt::named_sync(CONSUMER_BAR, CTHREADS);
}

// eight values from x + 8c as float (16-byte loads; bf16 or float32)
__device__ __forceinline__ void load8(const __nv_bfloat16* x, int c,
                                      float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + c);
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
  }
}
// float32 written earlier in the same launch: from L2
__device__ __forceinline__ void load8(const float* x, int c, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(x) + 2 * c);
  const float4 b = __ldcg(reinterpret_cast<const float4*>(x) + 2 * c + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8w(const float* w, int c, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w) + 2 * c);
  const float4 b = __ldg(reinterpret_cast<const float4*>(w) + 2 * c + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// PRO_BATCH rounds of a thread's chunks of eight from round r0 (chunk (r0 +
// b) CTHREADS + tid), x and w_rms as float, loaded at once
template <typename T>
struct Batch {
  float v[PRO_BATCH][8], w[PRO_BATCH][8];
  __device__ void load(const T* x, const float* rms_w, int nc, int r0) {
#pragma unroll
    for (int b = 0; b < PRO_BATCH; ++b) {
      const int c = (r0 + b) * CTHREADS + (int)threadIdx.x;
      if (c < nc) {
        load8(x, c, v[b]);
        if (rms_w) load8w(rms_w, c, w[b]);
      }
    }
  }
  // the batch's sum of x^2 (float64) and max |x w_rms| into s and m, its
  // rounds and their values in order
  __device__ void stats(bool rms, int nc, int r0, double& s,
                        float& m) const {
#pragma unroll
    for (int b = 0; b < PRO_BATCH; ++b) {
      if ((r0 + b) * CTHREADS + (int)threadIdx.x >= nc) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += (double)v[b][e] * (double)v[b][e];
        m = fmaxf(m, fabsf(rms ? v[b][e] * w[b][e] : v[b][e]));
      }
    }
  }
  // the codes of x (* w_rms) / scale(c), half to even, clipped to [-128,
  // 127], into E32, O32 and the sums per 128 codes (K % 128 == 0: a 128 is
  // 16 consecutive chunks, 16 lanes of one warp)
  template <class S>
  __device__ void codes(bool rms, int nc, int r0, int rounds, S scale,
                        uint32_t* E, uint32_t* O, int* gsum) const {
#pragma unroll
    for (int b = 0; b < PRO_BATCH; ++b) {
      if (r0 + b >= rounds) break;             // uniform in the block
      const int c = (r0 + b) * CTHREADS + (int)threadIdx.x;
      int sum = 0;
      if (c < nc) {
        const float sc = scale(c);
        uint32_t q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float z = rms ? v[b][e] * w[b][e] : v[b][e];
          const int qi =
              (int)fminf(fmaxf(rintf(__fdiv_rn(z, sc)), -128.f), 127.f);
          sum += qi;
          q[e] = (uint32_t)qi & 0xFFu;
        }
        E[c] = q[0] | q[2] << 8 | q[4] << 16 | q[6] << 24;
        O[c] = q[1] | q[3] << 8 | q[5] << 16 | q[7] << 24;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        sum += __shfl_xor_sync(nctt::FULL_MASK, sum, o);
      if (c < nc && (threadIdx.x & 15) == 0) gsum[c / 16] = sum;
    }
  }
};

// the block's sum and max over the threads' s and m, the same in every
// consumer thread: each warp's shuffles, then the warps in order
__device__ inline void block_stats(double s, float m, uint8_t* red,
                                   double& ss, float& am) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = nctt::warp_sum(s);
  m = nctt::warp_max(m);
  double* rd = reinterpret_cast<double*>(red);
  float* rf = reinterpret_cast<float*>(red + CWARPS * 8);
  if (lane == 0) {
    rd[warp] = s;
    rf[warp] = m;
  }
  consumers_sync();
  s = rd[0];
  m = rf[0];
  for (int w = 1; w < CWARPS; ++w) {
    s += rd[w];
    m = fmaxf(m, rf[w]);
  }
  ss = s;
  am = m;
  consumers_sync();                            // red is free again
}

// the activation scale of max |z|: f32(amax * f32(1/127)), as XLA
// compiles amax / 127; 1 where it is 0
__device__ __forceinline__ float act_scale(float amax) {
  const float s = amax * (1.0f / 127.0f);
  return s <= 0.f ? 1.0f : s;
}

// The codes of x (* rms_w) at scale(c) for x[0, K) (K % 128 == 0)
template <typename T, class S>
__device__ void store_codes(const T* x, const float* rms_w, int K, S scale,
                            uint32_t* E, uint32_t* O, int* gsum) {
  const int nc = K / 8, rounds = (nc + CTHREADS - 1) / CTHREADS;
  for (int r0 = 0; r0 < rounds; r0 += PRO_BATCH) {
    Batch<T> bt;
    bt.load(x, rms_w, nc, r0);
    bt.codes(rms_w != nullptr, nc, r0, rounds, scale, E, O, gsum);
  }
}

// The activation prologue: the block's sum of x^2 (float64), max |z| (z =
// x * rms_w, or x), s = act_scale(max |z|) and the codes of z / s; x read
// once where a thread's share fits a batch, else twice
template <typename T>
__device__ void quantize_x(const T* x, const float* rms_w, int K,
                           uint8_t* red, uint32_t* E, uint32_t* O, int* gsum,
                           double& ss, float& s) {
  const int nc = K / 8, rounds = (nc + CTHREADS - 1) / CTHREADS;
  const bool rms = rms_w != nullptr;
  double sq = 0.0;
  float m = 0.f, am;
  if (rounds <= PRO_BATCH) {
    Batch<T> bt;
    bt.load(x, rms_w, nc, 0);
    bt.stats(rms, nc, 0, sq, m);
    block_stats(sq, m, red, ss, am);
    const float sv = s = act_scale(am);
    bt.codes(rms, nc, 0, rounds, [sv](int) { return sv; }, E, O, gsum);
    return;
  }
  for (int r0 = 0; r0 < rounds; r0 += PRO_BATCH) {
    Batch<T> bt;
    bt.load(x, rms_w, nc, r0);
    bt.stats(rms, nc, r0, sq, m);
  }
  block_stats(sq, m, red, ss, am);
  const float sv = s = act_scale(am);
  store_codes(x, rms_w, K, [sv](int) { return sv; }, E, O, gsum);
}

// ------------------------------------------ K4's plan and layout

// The words of K4's argument block (kernels/fused_matvec.py
// w4a8_gemv_workspace), 64 bits each: the global scratch of the first
// launch past the plan's limit on K, then the plan
enum K4Word {
  K4_CODES, K4_GSUM, K4_SCL, K4_COLS, K4_STAGES, K4_UPC, K4_BLOCKS,
  K4_SLOT, K4_SMEM, K4_GLOBAL, K4_WORDS
};

struct K4Plan {
  uint32_t* codes;   // [K/8] E words, then [K/8] O words (global mode)
  int* gsum;         // [K/128]
  float* scl;        // [2]: the activation scale, times the norm's factor
  int cols, stages, upc, blocks, slot, smem, global;
};

inline K4Plan read_k4_plan(const void* block) {
  const long long* w = static_cast<const long long*>(block);
  return K4Plan{reinterpret_cast<uint32_t*>(w[K4_CODES]),
                reinterpret_cast<int*>(w[K4_GSUM]),
                reinterpret_cast<float*>(w[K4_SCL]), (int)w[K4_COLS],
                (int)w[K4_STAGES], (int)w[K4_UPC], (int)w[K4_BLOCKS],
                (int)w[K4_SLOT], (int)w[K4_SMEM], (int)w[K4_GLOBAL]};
}

// K4's dynamic shared memory, byte offsets: the ring, its barriers, the
// even and odd codes and the sums per 128 (not past the limit on K: in
// global memory), the consumers' reductions
struct K4Layout {
  int xe, xo, gsum, red, total;
};

__host__ __device__ inline K4Layout k4_layout(int K, int stages, int slot,
                                              int global) {
  K4Layout L;
  const int codes = global ? 0 : K;
  L.xe = stages * slot + 16 * stages;
  L.xo = L.xe + codes / 2;
  L.gsum = L.xo + codes / 2;
  L.red = up16(L.gsum + codes / 32);
  L.total = L.red + RED_BYTES;
  return L;
}

// Whether a plan fits K4's shape and kernels (kernels/fused_matvec.py
// w4a8_gemv_plan makes them): K % 128, G % 128, K % G, tiles of 8 or 16
// columns, slots of whole units of 128 codes that fit, the scratch in
// global mode.
inline bool k4_plan_ok(const K4Plan& p, int K, int N, int G, int n_out,
                       int silu) {
  if (K < 128 || K % 128 || G < 128 || G % 128 || K % G || n_out < 1 ||
      (silu ? N != 2 * n_out : N != n_out))
    return false;
  if (!(p.cols == 8 || p.cols == 16) || p.stages < 2 ||
      p.stages > MAX_STAGES || p.upc < 1 || p.upc > K / 128 ||
      p.blocks < 1 || p.slot != slot_bytes(silu ? 2 : 1, p.cols, p.upc))
    return false;
  if (p.global && (!p.codes || !p.gsum || !p.scl)) return false;
  const K4Layout L = k4_layout(K, p.stages, p.slot, p.global);
  return p.smem == L.total && L.total <= nctt::MAX_DYN_SMEM;
}

}  // namespace nctt_w4g
