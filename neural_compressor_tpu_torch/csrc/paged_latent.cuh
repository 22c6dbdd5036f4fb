// K14's attention kernels, included by csrc/paged_latent.cu alone (the C
// entries, K14's write and the design notes), launched over the plan of
// kernels/paged_attention.py latent_plan.
#pragma once

#include "nctt_common.cuh"

namespace nctt_lat {

constexpr int NT = 256;                  // threads a block
constexpr int WARPS = NT / 32;
constexpr int KC = 32;                   // latent columns a scores stage
constexpr int KR = 32;                   // latent rows a PV stage
constexpr int HG = 32;                   // heads a block (HEAD_GROUP)
constexpr int NST = 3;                   // stages of a ring
constexpr int MAX_PART_ROWS = 1024;      // rows a part (kernels/paged_attention.py)
constexpr int MIN_BLOCKS = 2;            // blocks an SM the launches aim at
constexpr int KM = 16;                   // the float64 mma: m16n8k16
constexpr int KPT = KM / 4;              // k values a lane holds a product
// the dynamic shared memory a launch may take: the card's 227 KB less room
// for the kernels' static arrays
constexpr size_t MAX_DYN = nctt::MAX_DYN_SMEM - 12288;

struct Args {
  const __nv_bfloat16* q;      // [B, H, C]
  const __nv_bfloat16* pages;  // [P, 1, page, C]
  const int* bt;               // [B, PMAX]
  const int* lengths;          // [B]
  float* out;                  // [B, H, r]
  float* ws;                   // [B, H, PMAX * page] scores
  float* pmax;                 // [B, H, nrb] row-block maxima
  double* part;                // [B, H, parts, r + 1] partials: acc, then l
  int H, page, PMAX, C, r, part_rows, parts, vec;
  int nrb;                     // scores row blocks over the table (launch)
  float scale;
};

// The scores launch's tiles: a block's output is HG heads x RB latent rows
// (16 float64 sums a thread, four m16n8 tiles a warp), its warps WM along
// the heads and WN along the rows; a stage holds 32 columns of the RB rows
// and of the HG queries, 64 bytes a row (the rows of a quarter warp's
// 16-byte reads fall in distinct banks).
struct ScoresShape {
  static constexpr int MT = HG / 16;             // m-tiles of 16 heads
  static constexpr int RB = 4096 / HG;           // rows of a row block
  static constexpr int MTW = MT < 2 ? MT : 2;    // m-tiles a warp
  static constexpr int WM = MT / MTW;
  static constexpr int WN = WARPS / WM;
  static constexpr int NTW = RB / 8 / WN;        // n-tiles of 8 rows a warp
  static constexpr int ROWS = RB + HG;           // staged rows: latent, q
  static_assert(WM * WN == WARPS && NTW * WN * 8 == RB, "scores tiling");
};

// The PV launch's tiles: a block's output is HG heads x NCC columns of r a
// pass (32 float64 sums a thread, eight m16n8 tiles a warp); warp w owns
// columns w*8*NTW .. +8*NTW of the pass, lane group g the NTW columns
// g*NTW .. +NTW of those (one vector load serves its NTW tiles); a stage
// holds KR latent rows of the pass's columns, SB bytes a row (the four rows
// of a product's k values fall in distinct banks).
struct PvShape {
  static constexpr int MT = HG / 16;
  static constexpr int NTW = 8 / MT;
  static constexpr int NCC = WARPS * 8 * NTW;
  static constexpr int SB = 2 * NCC + 32;
};

// bf16 elements of a row of p a part holds in shared memory: whole KR-row
// stages plus 4 (the eight heads of a product's reads fall in distinct
// banks)
__host__ __device__ inline int p_stride(int part_rows) {
  return (part_rows + KR - 1) / KR * KR + 4;
}
constexpr size_t SCORES_SMEM = (size_t)NST * ScoresShape::ROWS * 64;
inline size_t pv_smem(int part_rows) {
  return (size_t)NST * KR * PvShape::SB + (size_t)HG * p_stride(part_rows) * 2;
}

// Programmatic dependent launch (as csrc/decode_split.cuh): the PV launch
// may start once every scores block has run its allow, stage its first
// latent rows, and wait here before it reads the scores and maxima; the
// fold waits for the PV launch's partials the same way.
__device__ __forceinline__ void wait_prior_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// element j (0..7) of eight bf16 in a 16-byte vector, as float64, exactly
__device__ __forceinline__ double elem(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return nctt::bf16_bits(j & 1 ? w >> 16 : w);
}
__device__ __forceinline__ double bf(__nv_bfloat16 x) {
  return nctt::bf16_bits(__bfloat16_as_ushort(x));
}

// N consecutive bf16 of shared memory (2N-byte aligned) as float64
template <int N>
__device__ __forceinline__ void load_n(const uint8_t* p, double* x) {
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = elem(v, j);
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = nctt::bf16_bits(v.x);
    x[1] = nctt::bf16_bits(v.x >> 16);
    x[2] = nctt::bf16_bits(v.y);
    x[3] = nctt::bf16_bits(v.y >> 16);
  } else if constexpr (N == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    x[0] = nctt::bf16_bits(v);
    x[1] = nctt::bf16_bits(v >> 16);
  } else {
    x[0] = nctt::bf16_bits(*reinterpret_cast<const uint16_t*>(p));
  }
}

// c += a . b on the FP64 tensor cores, m16n8k16 (tools/dmma_probe.cu
// measures the other shapes). Lane 4g + t holds A's
// values i at (row g + 8 (i & 1), k = t + 4 (i >> 1)), B's values i at
// (k = t + 4 i, col g), C's values i at (row g + 8 (i >> 1), col 2t +
// (i & 1)). Products of bf16 values are exact in float64.
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[2 * KPT],
                                    const double (&b)[KPT]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A block's slot and its span of `span` rows (the scores launch's row
// block, the PV launch's part), and the pool rows of the span.
struct Part {
  int p, b, L, r0, nrows, Tv;
  __device__ Part(const Args& a, int span) {
    p = blockIdx.x;
    b = blockIdx.z;
    Tv = a.PMAX * a.page;
    const int n = a.lengths[b];
    L = n < 0 ? 0 : (n > Tv ? Tv : n);
    r0 = p * span;
    nrows = L - r0 < span ? L - r0 : span;
  }
  __device__ bool active() const { return r0 < L; }
  // the spans of `span` rows holding the slot's rows
  __device__ int spans(int span) const { return (L + span - 1) / span; }
  // srow[u]: the pool row (page * page size + offset) of the part's row u
  __device__ void pool_rows(const Args& a, int* srow) const {
    const nctt::Div pd = nctt::make_div(a.page);
    const int* btb = a.bt + (size_t)b * a.PMAX;
    for (int u = threadIdx.x; u < nrows; u += NT) {
      const int t = r0 + u;
      srow[u] = btb[pd.q(t)] * a.page + pd.r(t);
    }
  }
};

// Launch 1, a block a (row block of RB rows, head group, slot): the scores
// of the group's queries against the rows, s = f32(q . lat) * scale, into
// the workspace, and each head's maximum over the rows into pmax [B, H,
// nrb]; 32-column stages through a cp.async ring, the products on the FP64
// tensor cores.
__global__ void __launch_bounds__(NT, MIN_BLOCKS) scores_kernel(const Args a) {
  using S = ScoresShape;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int srow[S::RB];
  __shared__ float smx[S::WN][HG];
  const Part k(a, S::RB);
  const int h0 = blockIdx.y * HG;
  allow_next_launch();
  if (!k.active()) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::WN, wn = warp - wm * S::WN;
  k.pool_rows(a, srow);
  __syncthreads();
  const int total = (a.C + KC - 1) / KC;
  constexpr int SBYTES = S::ROWS * 64;
  const __nv_bfloat16* qb = a.q + ((size_t)k.b * a.H + h0) * a.C;

  // stage i: columns i*32 .. +32 of the rows, then of the queries; zeros
  // past the slot, past H and past C
  auto stage = [&](int i) {
    uint8_t* dst = smem + (i % NST) * SBYTES;
    const int c0 = i * KC, u0 = 0;
    if (a.vec) {
      for (int c = tid; c < S::ROWS * 4; c += NT) {
        const int row = c >> 2, col = c0 + 8 * (c & 3);
        const __nv_bfloat16* src = a.q;
        bool ok = col < a.C;
        if (row < S::RB) {
          ok = ok && u0 + row < k.nrows;
          if (ok) src = a.pages + (size_t)srow[u0 + row] * a.C + col;
        } else {
          ok = ok && h0 + row - S::RB < a.H;
          if (ok) src = qb + (size_t)(row - S::RB) * a.C + col;
        }
        nctt::cp_async<16>(dst + c * 16, src, ok);
      }
    } else {
      for (int c = tid; c < S::ROWS * KC; c += NT) {
        const int row = c / KC, col = c0 + c % KC;
        __nv_bfloat16 x = __ushort_as_bfloat16(0);
        if (col < a.C) {
          if (row < S::RB) {
            if (u0 + row < k.nrows)
              x = a.pages[(size_t)srow[u0 + row] * a.C + col];
          } else if (h0 + row - S::RB < a.H) {
            x = qb[(size_t)(row - S::RB) * a.C + col];
          }
        }
        reinterpret_cast<__nv_bfloat16*>(dst)[c] = x;
      }
    }
  };

  double acc[S::MTW][S::NTW][4];
  float mx[S::MTW][2];
#pragma unroll
  for (int m = 0; m < S::MTW; ++m) {
    mx[m][0] = mx[m][1] = -INFINITY;
#pragma unroll
    for (int n = 0; n < S::NTW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0;
  }
  for (int s = 0; s < NST - 1; ++s) {
    if (s < total) stage(s);
    nctt::cp_commit();
  }
  for (int i = 0; i < total; ++i) {
    if (i + NST - 1 < total) stage(i + NST - 1);
    nctt::cp_commit();
    nctt::cp_wait(NST - 1);
    __syncthreads();
    const uint8_t* st = smem + (i % NST) * SBYTES;
    const uint8_t* sq = st + S::RB * 64;
    // lane (g, t) holds columns 8t .. 8t+7 of its rows: the k values of
    // the stage's products, in an order A and B share
    uint4 qa[S::MTW][2], lb[S::NTW];
#pragma unroll
    for (int m = 0; m < S::MTW; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        qa[m][hh] = *reinterpret_cast<const uint4*>(
            sq + (16 * (wm * S::MTW + m) + g + 8 * hh) * 64 + t * 16);
#pragma unroll
    for (int n = 0; n < S::NTW; ++n)
      lb[n] = *reinterpret_cast<const uint4*>(
          st + (8 * (wn * S::NTW + n) + g) * 64 + t * 16);
#pragma unroll
    for (int s = 0; s < 8 / KPT; ++s) {
      double af[S::MTW][2 * KPT], bv[S::NTW][KPT];
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        const int j = KPT * s + kk;
#pragma unroll
        for (int m = 0; m < S::MTW; ++m) {
          af[m][2 * kk] = elem(qa[m][0], j);
          af[m][2 * kk + 1] = elem(qa[m][1], j);
        }
#pragma unroll
        for (int n = 0; n < S::NTW; ++n) bv[n][kk] = elem(lb[n], j);
      }
#pragma unroll
      for (int m = 0; m < S::MTW; ++m)
#pragma unroll
        for (int n = 0; n < S::NTW; ++n) mma(acc[m][n], af[m], bv[n]);
    }
    __syncthreads();
  }
  // the scores, rounded once, and their maxima
#pragma unroll
  for (int m = 0; m < S::MTW; ++m)
#pragma unroll
    for (int n = 0; n < S::NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = 16 * (wm * S::MTW + m) + g + 8 * (c >> 1);
        const int u = 8 * (wn * S::NTW + n) + 2 * t + (c & 1);
        if (h0 + h < a.H && u < k.nrows) {
          const float s = __fmul_rn((float)acc[m][n][c], a.scale);
          a.ws[((size_t)k.b * a.H + h0 + h) * k.Tv + k.r0 + u] = s;
          mx[m][c >> 1] = fmaxf(mx[m][c >> 1], s);
        }
      }
  // each head's maximum over the row block: its four lanes, then the
  // warps along the rows
#pragma unroll
  for (int m = 0; m < S::MTW; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = mx[m][hh];
      v = fmaxf(v, __shfl_xor_sync(nctt::FULL_MASK, v, 1));
      v = fmaxf(v, __shfl_xor_sync(nctt::FULL_MASK, v, 2));
      if (t == 0) smx[wn][16 * (wm * S::MTW + m) + g + 8 * hh] = v;
    }
  __syncthreads();
  if (tid < HG && h0 + tid < a.H) {
    float v = smx[0][tid];
#pragma unroll
    for (int w = 1; w < S::WN; ++w) v = fmaxf(v, smx[w][tid]);
    a.pmax[((size_t)k.b * a.H + h0 + tid) * a.nrb + k.p] = v;
  }
}

// Launch 2, a block a (part, head group x pass, slot): p = bf16(f32(exp(s
// - m))) against each head's maximum m over the slot, the part's l = sum
// exp(s - m) and its partial of acc = sum p * lat[:, :r] over the pass's
// NCC columns in float64, through a cp.async ring of KR-row stages; a slot
// of one part writes its output, the others' partials go to launch 3.
__global__ void __launch_bounds__(NT, MIN_BLOCKS) pv_kernel(const Args a) {
  using V = PvShape;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int srow[MAX_PART_ROWS];
  __shared__ float sm[HG];
  __shared__ double sl[HG];
  const Part k(a, a.part_rows);
  const int passes = (a.r + V::NCC - 1) / V::NCC;
  const int pass = blockIdx.y % passes, h0 = blockIdx.y / passes * HG;
  const int c0 = pass * V::NCC;                 // the pass's first column
  allow_next_launch();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* outb = a.out + ((size_t)k.b * a.H + h0) * a.r;
  if (!k.active()) {
    if (k.p != 0) return;
    wait_prior_launch();   // a slot of no rows: zeros, once launch 1 ended
    for (int i = tid; i < HG * V::NCC; i += NT) {
      const int h = i / V::NCC, c = c0 + i % V::NCC;
      if (h0 + h < a.H && c < a.r) outb[(size_t)h * a.r + c] = 0.0f;
    }
    return;
  }
  k.pool_rows(a, srow);
  constexpr int SBYTES = KR * V::SB;
  const int PS = p_stride(a.part_rows);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + NST * SBYTES);
  const int nkr = (k.nrows + KR - 1) / KR;
  const int total = nkr;
  __syncthreads();   // srow

  // stage i: rows i*KR .. +KR of the part, the pass's columns; zeros past
  // the part and past C
  auto stage = [&](int i) {
    uint8_t* dst = smem + (i % NST) * SBYTES;
    const int u0 = i * KR;
    if (a.vec) {
      constexpr int VPR = V::NCC / 8;   // 16-byte pieces a row
      for (int c = tid; c < KR * VPR; c += NT) {
        const int row = c / VPR, v = c - row * VPR, col = c0 + 8 * v;
        const bool ok = u0 + row < k.nrows && col < a.C;
        const __nv_bfloat16* src =
            ok ? a.pages + (size_t)srow[u0 + row] * a.C + col : a.pages;
        nctt::cp_async<16>(dst + row * V::SB + v * 16, src, ok);
      }
    } else {
      for (int c = tid; c < KR * V::NCC; c += NT) {
        const int row = c / V::NCC, col = c0 + c % V::NCC;
        __nv_bfloat16 x = __ushort_as_bfloat16(0);
        if (u0 + row < k.nrows && col < a.C)
          x = a.pages[(size_t)srow[u0 + row] * a.C + col];
        reinterpret_cast<__nv_bfloat16*>(dst + row * V::SB)[c % V::NCC] = x;
      }
    }
  };
  for (int s = 0; s < NST - 1; ++s) {
    if (s < total) stage(s);
    nctt::cp_commit();
  }
  wait_prior_launch();
  const int np = k.spans(a.part_rows);
  if (tid < HG) {   // each head's maximum over the slot's row blocks
    float m = -INFINITY;
    if (h0 + tid < a.H) {
      const float* pm = a.pmax + ((size_t)k.b * a.H + h0 + tid) * a.nrb;
      const int nb = k.spans(ScoresShape::RB);
      for (int i = 0; i < nb; ++i) m = fmaxf(m, pm[i]);
    }
    sm[tid] = m;
  }
  __syncthreads();
  // p of the part's rows, a warp a head; zeros past the part (whole
  // stages) and past H; l over the part, each lane's rows in ascending
  // order, then a butterfly. Eight scores a lane are loaded before their
  // exponentials, so the loads overlap.
  for (int h = warp; h < HG; h += WARPS) {
    const bool hv = h0 + h < a.H;
    const float* srs = a.ws + ((size_t)k.b * a.H + h0 + h) * k.Tv + k.r0;
    const double m = (double)sm[h];
    double l = 0.0;
    for (int u0 = lane; u0 < nkr * KR; u0 += 32 * 8) {
      float sv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = u0 + 32 * j;
        sv[j] = hv && u < k.nrows ? srs[u] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = u0 + 32 * j;
        float pv = 0.0f;
        if (hv && u < k.nrows) {
          const double e = exp((double)sv[j] - m);
          l += e;
          pv = (float)e;
        }
        if (u < nkr * KR) P[h * PS + u] = __float2bfloat16_rn(pv);
      }
    }
    l = nctt::warp_sum(l);
    if (lane == 0) sl[h] = l;
  }
  __syncthreads();

  double acc[V::MT][V::NTW][4];
#pragma unroll
  for (int m = 0; m < V::MT; ++m)
#pragma unroll
    for (int n = 0; n < V::NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.0;
  const int wcol = warp * 8 * V::NTW;   // the warp's first column of a pass
  for (int i = 0; i < total; ++i) {
    if (i + NST - 1 < total) stage(i + NST - 1);
    nctt::cp_commit();
    nctt::cp_wait(NST - 1);
    __syncthreads();
    const uint8_t* st = smem + (i % NST) * SBYTES;
    const __nv_bfloat16* Pk = P + i * KR;
#pragma unroll
    for (int s = 0; s < KR / KM; ++s) {
      double af[V::MT][2 * KPT], bv[V::NTW][KPT];
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        const int row = KM * s + t + 4 * kk;
        double x[V::NTW];
        load_n<V::NTW>(st + row * V::SB + (wcol + g * V::NTW) * 2, x);
#pragma unroll
        for (int n = 0; n < V::NTW; ++n) bv[n][kk] = x[n];
#pragma unroll
        for (int m = 0; m < V::MT; ++m) {
          af[m][2 * kk] = bf(Pk[(16 * m + g) * PS + row]);
          af[m][2 * kk + 1] = bf(Pk[(16 * m + g + 8) * PS + row]);
        }
      }
#pragma unroll
      for (int m = 0; m < V::MT; ++m)
#pragma unroll
        for (int n = 0; n < V::NTW; ++n) mma(acc[m][n], af[m], bv[n]);
    }
    __syncthreads();
  }
  // the pass's columns: the output where the slot has one part, else this
  // part's partials (and, from pass 0, its l)
#pragma unroll
  for (int m = 0; m < V::MT; ++m)
#pragma unroll
    for (int n = 0; n < V::NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = 16 * m + g + 8 * (c >> 1);
        const int col = c0 + wcol + (2 * t + (c & 1)) * V::NTW + n;
        if (h0 + h < a.H && col < a.r) {
          if (np == 1)
            outb[(size_t)h * a.r + col] = __fdiv_rn(
                (float)acc[m][n][c], fmaxf((float)sl[h], 1e-30f));
          else
            a.part[(((size_t)k.b * a.H + h0 + h) * a.parts + k.p) *
                       (a.r + 1) + col] = acc[m][n][c];
        }
      }
  if (np > 1 && pass == 0 && tid < HG && h0 + tid < a.H)
    a.part[(((size_t)k.b * a.H + h0 + tid) * a.parts + k.p) * (a.r + 1) +
           a.r] = sl[tid];
}

// Launch 3: the fold of a slot's parts in ascending order, a thread an
// output (slot, head, column), across the whole card: acc = sum of the
// parts' partials, l likewise, out = f32(acc) / max(f32(l), 1e-30). Slots
// of one part wrote their output in launch 2. Every block waits for launch
// 2 to end first, so that the call ends after it.
__global__ void __launch_bounds__(NT) fold_kernel(const Args a) {
  wait_prior_launch();
  const int b = blockIdx.z, h = blockIdx.y;
  const int c = blockIdx.x * NT + threadIdx.x;
  const int Tv = a.PMAX * a.page, n = a.lengths[b];
  const int L = n < 0 ? 0 : (n > Tv ? Tv : n);
  const int np = (L + a.part_rows - 1) / a.part_rows;
  if (np <= 1 || c >= a.r) return;
  const size_t ps = a.r + 1;                      // a part's partials
  const double* src = a.part + ((size_t)b * a.H + h) * a.parts * ps;
  double l = 0.0, s = 0.0;
  for (int pp = 0; pp < np; ++pp) l += __ldcg(src + pp * ps + a.r);
  int pp = 0;
  for (; pp + 8 <= np; pp += 8) {   // eight loads in flight
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __ldcg(src + (pp + u) * ps + c);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; pp < np; ++pp) s += __ldcg(src + pp * ps + c);
  a.out[((size_t)b * a.H + h) * a.r + c] =
      __fdiv_rn((float)s, fmaxf((float)l, 1e-30f));
}

// a launch that may start while the one before it on the stream drains
inline cudaError_t dependent_launch(void (*kernel)(Args), dim3 grid,
                                    size_t smem, cudaStream_t stream,
                                    const Args& a) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// Enqueue one call: scores, grid (row blocks, head groups, B); PV, grid
// (parts, head groups x passes, B); the fold, grid (columns / NT, H, B).
inline int launch(const Args& a, int B, cudaStream_t stream) {
  static_assert(SCORES_SMEM <= MAX_DYN, "scores ring");
  const size_t smem_p = pv_smem(a.part_rows);
  // the plan (kernels/paged_attention.py latent_plan) checks the same
  if (smem_p > MAX_DYN) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;   // dynamic shared memory past 48 KB, once
  cudaError_t e = cudaSuccess;
  if (!opted_in) {
    e = cudaFuncSetAttribute(scores_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_DYN);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MAX_DYN);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  Args b = a;
  constexpr int RB = ScoresShape::RB;
  b.nrb = (a.PMAX * a.page + RB - 1) / RB;
  const int groups = (a.H + HG - 1) / HG;
  const int passes = (a.r + PvShape::NCC - 1) / PvShape::NCC;
  scores_kernel<<<dim3(b.nrb, groups, B), NT, SCORES_SMEM, stream>>>(b);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    e = dependent_launch(pv_kernel, dim3(a.parts, groups * passes, B),
                         smem_p, stream, b);
  if (e == cudaSuccess)
    e = dependent_launch(fold_kernel, dim3((a.r + NT - 1) / NT, a.H, B),
                         0, stream, b);
  return (int)e;
}

}  // namespace nctt_lat
