// K5's, K6's and K7's kernels over a contiguous head-major KV cache, shared
// by the four sources that instantiate them: csrc/decode_split.cu (the C
// entries, K7's bf16 copies), csrc/decode_split_k5.cu (K5: K6's kernels
// over bf16 rows), csrc/decode_split_int8.cu and csrc/decode_split_fp8.cu,
// so that they compile in parallel. K16's in-kernel write
// (csrc/decode_attention.cu) runs K5's copies (bf16) and K6's int8 copies;
// K18's attention (csrc/attn_o.cu) runs K5's with a float32 output. The
// design is described in decode_split.cu.
#pragma once

#include "nctt_common.cuh"

namespace nctt_dsplit {

constexpr int MAX_REP = 8;     // query rows of a group
constexpr int SLOTS = 64;      // cache rows of a tile
constexpr int MAX_STAGES = 8;  // tiles of the ring (nctt::cp_wait: < 8)
// K6: the most parts whose exp sums a PV block takes itself (the plan
// sends more to the third launch; kernels/decode_attention.py LSUM_PARTS)
constexpr int LSUM_MAX = 8;
// the dynamic shared memory a launch may take: the card's 227 KB less room
// for the kernels' static arrays
constexpr size_t MAX_DYN = nctt::MAX_DYN_SMEM - 8192;

// cache formats, as kernels/decode_attention.py numbers them
constexpr int BF16 = 0, INT8 = 1, FP8 = 2;

struct Args {
  const __nv_bfloat16* q;   // [B, H, D]
  const uint8_t* kc;        // [B, Hkv, T, D] rows or codes
  const uint8_t* vc;
  const float* ks;          // [B, Hkv, T] scales (null for bf16)
  const float* vs;
  const __nv_bfloat16* kn;  // the new rows [B, Hkv, D]: K6's raw rows,
  const __nv_bfloat16* vn;  // K16's written rows (K5, K7, K18: null)
  const int* pos;           // [B]
  __nv_bfloat16* out;       // [B, H, D]
  float* ws;                // [B, H, T] scores
  float* pmax;              // [B, H, parts] part maxima
  double* part;             // [B, H, parts, D + 1] partials: acc, then l
  double* lpart;            // K6: [B, H, parts] part sums of exp
  int* tickets;             // [B * Hkv * ng], zeroed
  float* att;               // K18: [B, H, D] float32 out (else null)
  unsigned* amax;           // K18: max |att| as float bits, one word
  int H, Hkv, T, D, ng, part_keys, parts, stages, threads, lsum, vec;
  int write;                // K16: store the new rows at pos (kc..vs)
  float scale;
};

// The argument block of a call (kernels/decode_attention.py
// decode_workspace): the scratch's addresses, then the plan
enum PlanWord {
  W_WS, W_PMAX, W_PART, W_LPART, W_TICKETS, W_ATT, W_AMAX,
  W_NG, W_PART_KEYS, W_PARTS, W_STAGES, W_THREADS, W_LSUM
};

// The arguments of a call with no new rows, no float32 output; 0 where they
// are not valid (csrc/decode_split.cu). esize: bytes an element.
int fill(Args& a, const void* q, const void* kc, const void* vc,
         const void* ks, const void* vs, const void* pos, void* out,
         const long long* plan, int H, int Hkv, int T, int D, int esize,
         float scale);

template <int FMT>
struct Fmt {
  static constexpr bool QUANT = FMT != BF16;
  static constexpr int ESIZE = FMT == BF16 ? 2 : 1;   // bytes an element
  static constexpr int EPC = 16 / ESIZE;              // elements a chunk
};

// elements e and e + 1 of a staged row (byte address `row`) as float64,
// exactly (e even: one 2- or 4-byte load)
template <int FMT>
__device__ __forceinline__ void elem2(const uint8_t* row, int e, double& x0,
                                      double& x1) {
  if constexpr (FMT == BF16) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 2 * e);
    x0 = nctt::bf16_bits(w);
    x1 = nctt::bf16_bits(w >> 16);
  } else {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + e);
    x0 = FMT == INT8 ? nctt::int8_bits(w) : nctt::e4m3_bits(w);
    x1 = FMT == INT8 ? nctt::int8_bits(w >> 8) : nctt::e4m3_bits(w >> 8);
  }
}

// the EPC elements of one 16-byte chunk as float64, exactly
template <int FMT>
__device__ __forceinline__ void chunk(const uint4& c,
                                      double (&x)[Fmt<FMT>::EPC]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (FMT == BF16) {
      x[2 * i] = nctt::bf16_bits(w[i]);
      x[2 * i + 1] = nctt::bf16_bits(w[i] >> 16);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = FMT == INT8 ? nctt::int8_bits(w[i] >> (8 * j))
                                   : nctt::e4m3_bits(w[i] >> (8 * j));
    }
  }
}

// slot groups of the PV launch: a thread owns CPT columns (CPT / 2 adjacent
// pairs) of every row over SLOTS / NSG slots of each tile; 2 where D is
// known only at run time
template <int NT, int DC, int CPT>
__host__ __device__ constexpr int slot_groups() {
  if (!DC) return 2;
  const int ct = ((DC + CPT - 1) / CPT + 31) / 32 * 32;
  const int n = NT / ct;
  return n < 2 ? 2 : (n > 4 ? 4 : n);
}

// bytes of a staged row: padded to an odd number of 16-byte chunks, so the
// 16-byte reads of eight consecutive rows hit all 32 banks once
__host__ __device__ inline int staged_row(int D, int esize) {
  return (((D * esize + 15) / 16) | 1) * 16;
}
// dynamic shared memory of the scores launch: the ring, q as float64 and
// the segment sums; of the PV launch: the ring (or the slot groups'
// exchange, which reuses it), then p of a tile
__host__ __device__ inline size_t scores_smem(int D, int esize, int rows,
                                              int stages, int nt) {
  const int nc = (D * esize + 15) / 16;
  return (size_t)stages * SLOTS * staged_row(D, esize) +
         sizeof(double) * ((size_t)rows * nc * (16 / esize) +
                           (size_t)(nt / 32) * rows * SLOTS);
}
__host__ __device__ inline size_t pv_ring(int D, int esize, int rows,
                                          int stages, int nsg) {
  const size_t ring = (size_t)stages * SLOTS * staged_row(D, esize);
  const size_t xch = sizeof(double) * (size_t)(nsg - 1) * rows * D;
  return ring > xch ? ring : xch;
}
__host__ __device__ inline size_t pv_smem(int D, int esize, int rows,
                                          int stages, int nsg) {
  return pv_ring(D, esize, rows, stages, nsg) +
         sizeof(double) * (size_t)rows * SLOTS;
}

// A block's query rows, its slot's visited keys and its part's tiles.
template <int FMT, bool K6>
struct Block {
  int b, hk, g, G, rows, q0, bh;   // q0: the group's first q row
  int pos, L, np;                  // visited keys t < L, parts holding them
  int p, k0, k1, nt;               // this part's keys [k0, k1), its tiles
  int newk;                        // the new row's key here, or -1 (no
                                   // new rows, or pos outside the part)
  int raw;                         // the key scored apart, or -1: K6's raw
                                   // row; K16's int8 row (launch 1 only)
  int rowbytes, srow, cw, cu, cdu;

  // pv: the PV launch (K16's int8 row is read from the cache there)
  __device__ Block(const Args& a, bool pv) {
    p = blockIdx.x;
    hk = blockIdx.y / a.ng;
    g = blockIdx.y - hk * a.ng;
    b = blockIdx.z;
    const int rep = a.H / a.Hkv;
    rows = (rep + a.ng - 1) / a.ng;
    const int g0 = g * rows;
    G = rep - g0 < rows ? rep - g0 : rows;
    q0 = b * a.H + hk * rep + g0;
    bh = b * a.Hkv + hk;
    pos = a.pos[b];
    // pos at or past T: every row (and no raw row); the engine parks idle
    // slots on row T - 1
    L = (pos < 0 ? 0 : (pos > a.T - 1 ? a.T - 1 : pos)) + 1;
    np = (L + a.part_keys - 1) / a.part_keys;
    k0 = p * a.part_keys;
    k1 = L < k0 + a.part_keys ? L : k0 + a.part_keys;
    nt = k1 > k0 ? (k1 - k0 + SLOTS - 1) / SLOTS : 0;
    newk = K6 && a.kn && pos >= k0 && pos < k1 ? pos : -1;
    // K16's bf16 write stages the new row in place of the cache's row pos,
    // so that it is scored and summed where K5 takes it from the cache
    raw = FMT == BF16 || (pv && a.write) ? -1 : newk;
    rowbytes = a.D * Fmt<FMT>::ESIZE;
    srow = staged_row(a.D, Fmt<FMT>::ESIZE);
    // 16-byte copies: chunk column cw of rows cu, cu + cdu, ... where the
    // block's threads tile whole rows; else (cdu = 0) chunk by chunk
    const int cpr = rowbytes >> 4;
    cdu = cpr && blockDim.x % cpr == 0 ? blockDim.x / cpr : 0;
    cw = cdu ? threadIdx.x % cpr : 0;
    cu = cdu ? threadIdx.x / cpr : 0;
  }

  __device__ bool active() const { return G > 0 && k0 < k1; }


  // issue the copies of tile i of `cache` (rows k0 + 64i ..) into `dst`:
  // one contiguous slab of the slot's rows. Row `sk` (-1: none) is not
  // read from the cache: it comes from `nrow`, or is left as it is where
  // `nrow` is null (a row the block never reads).
  __device__ void stage(const Args& a, const uint8_t* cache, int i,
                        uint8_t* dst, int sk = -1,
                        const uint8_t* nrow = nullptr) const {
    const int t0 = k0 + i * SLOTS;
    const int nu = k1 - t0 < SLOTS ? k1 - t0 : SLOTS;
    const int us = sk - t0;                  // its slot in this tile
    const uint8_t* src = cache + ((size_t)bh * a.T + t0) * rowbytes;
    auto row = [&](int u) {
      return u == us ? nrow : src + (size_t)u * rowbytes;
    };
    if (a.vec && cdu) {
      for (int u = cu; u < nu; u += cdu)
        if (u != us || nrow)
          nctt::cp_async<16>(dst + u * srow + cw * 16, row(u) + cw * 16);
    } else if (a.vec) {
      const int cpr = rowbytes >> 4, m = nu * cpr;
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        const int u = c / cpr, w = c - u * cpr;
        if (u != us || nrow)
          nctt::cp_async<16>(dst + u * srow + w * 16, row(u) + w * 16);
      }
    } else {   // rows of no whole 16-byte chunks: scalars, tail zeroed
      const int rb = ((rowbytes + 15) >> 4) * 16, m = nu * rb;
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        const int u = c / rb, w = c - u * rb;
        if (u != us || nrow)
          dst[u * srow + w] = w < rowbytes ? __ldg(row(u) + w) : (uint8_t)0;
      }
    }
  }
};

// Visit tiles 0 .. n-1 with up to nst - 1 in flight while one is used:
// stage(i, buffer) issues tile i's copies (ring_begin the first nst - 1,
// so that a kernel can start them before its other loads), body(i, buffer)
// runs between two block barriers.
template <typename Stage>
__device__ __forceinline__ void ring_begin(int n, int nst, Stage stage) {
  for (int s = 0; s < nst - 1; ++s) {
    if (s < n) stage(s, s);
    nctt::cp_commit();
  }
}
template <typename Stage, typename Body>
__device__ __forceinline__ void ring_run(int n, int nst, Stage stage,
                                         Body body) {
  for (int i = 0; i < n; ++i) {
    const int j = i + nst - 1;
    if (j < n) stage(j, j % nst);
    nctt::cp_commit();
    nctt::cp_wait(nst - 1);
    __syncthreads();
    body(i, i % nst);
    __syncthreads();
  }
}

// K6's l. A part's sum of exp(s - m) for one row, thread j's share: keys
// t0 + j, t0 + j + NT, ... below t1, ascending (m the row's global
// maximum, s the scores of launch 1).
template <int NT>
__device__ __forceinline__ double part_exp(const float* row, float m, int t0,
                                           int t1) {
  double e = 0.0;
  for (int t = t0 + threadIdx.x; t < t1; t += NT)
    e += exp((double)row[t] - (double)m);
  return e;
}

// The sums of exp(s - m) over the parts p0 .. p0 + n - 1 (n <= LSUM_MAX)
// of each of the group's G rows, in float64 in one fixed order: a part's
// sum is its threads' shares (part_exp) added by nctt::warp_sum's
// butterfly, then warp by warp in ascending order; the parts add in
// ascending order. Row r's sum comes back to thread r < G. It is the one
// float64 sum that is not exact; the third launch (lsum_kernel, n = 1 a
// block) keeps the same order.
template <int NT>
__device__ double exp_sums(const Args& a, int q0, int G, int p0, int n,
                           int L, const float* sm,
                           double (*sred)[NT / 32][MAX_REP]) {
  const int tid = threadIdx.x;
  for (int r = 0; r < G; ++r) {
    const float* row = a.ws + (size_t)(q0 + r) * a.T;
    double e[LSUM_MAX];        // every part's loads before any shuffle
#pragma unroll
    for (int i = 0; i < LSUM_MAX; ++i) {
      const int t0 = (p0 + i) * a.part_keys;
      e[i] = i < n ? part_exp<NT>(row, sm[r], t0,
                                  t0 + a.part_keys < L ? t0 + a.part_keys
                                                       : L)
                   : 0.0;
    }
#pragma unroll
    for (int i = 0; i < LSUM_MAX; ++i) {
      if (i >= n) break;
      const double w = nctt::warp_sum(e[i]);
      if ((tid & 31) == 0) sred[i][tid >> 5][r] = w;
    }
  }
  __syncthreads();
  double l = 0.0;
  if (tid < G)
    for (int i = 0; i < n; ++i) {
      double part = 0.0;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) part += sred[i][w][tid];
      l += part;
    }
  __syncthreads();
  return l;
}

// Programmatic dependent launch (Hopper): the PV launch (and K6's part
// sums) may start once every block of the launch before them has run its
// allow, stage their V tiles into whatever room that launch leaves on an
// SM, and wait here before they read what it wrote. The hardware launches
// the dependent grid only after every block of the one before has run its
// allow, so the waiting blocks never hold an SM that a block of that
// launch still needs. K6's launches (one slot, a wave of blocks or fewer)
// allow it first thing; K7's scores blocks once they have read their
// tiles, since K7's grids fill the card and a PV block started earlier
// would only wait there.
__device__ __forceinline__ void wait_prior_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// each row's maximum over the parts holding its keys, into sm
__device__ __forceinline__ void global_max(const Args& a, int q0, int G,
                                           int np, float* sm) {
  if ((int)threadIdx.x < G) {
    const float* pm = a.pmax + (size_t)(q0 + threadIdx.x) * a.parts;
    float m = -INFINITY;
    for (int pp = 0; pp < np; ++pp) m = fmaxf(m, pm[pp]);
    sm[threadIdx.x] = m;
  }
}

// K16's int8 write: the TPU kernel's rule for the new row x [D] (bf16) of
// one (slot, KV head), by the block's NT threads: scale = f32(max(amax,
// 1e-6) * f32(1/127)), codes clip(rint(x / scale), -127, 127), an all-zero
// row included (not _kv_quant's rule: amax 0 -> 1, clip to -128). The codes
// go to c [D]; every thread gets the scale. sred: NT / 32 floats.
template <int NT>
__device__ float quant_row(const __nv_bfloat16* x, int D, float* c,
                           float* sred) {
  float m = 0.f;
  for (int i = threadIdx.x; i < D; i += NT)
    m = fmaxf(m, fabsf(__bfloat162float(x[i])));
  m = nctt::warp_max(m);
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) m = fmaxf(m, sred[w]);   // order-free
  const float sc = __fmul_rn(fmaxf(m, 1e-6f), 1.0f / 127.0f);
  for (int i = threadIdx.x; i < D; i += NT)
    c[i] = fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(x[i]), sc)), -127.f),
                 127.f);
  __syncthreads();
  return sc;
}

// K18: the block's max |o| into *amax by one atomicMax on the float bits
// (non-negative floats order as their bits). sred: NT / 32 floats.
template <int NT>
__device__ void amax_out(unsigned* amax, float m, float* sred) {
  m = nctt::warp_max(m);
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, sred[w]);
    atomicMax(amax, __float_as_uint(m));
  }
}

// Launch 1: the scores of the group's rows over this part's keys and each
// row's maximum over the part. DC: D at compile time (0: at run time); GP:
// the group's rows at compile time, zero rows past G (0: G at run time).
// blocks an SM K7's single-row copies (GP 1) are compiled for: their
// registers stay under 64 a thread, so eight 128-thread blocks fit (K6
// runs one slot, a wave of blocks or less, and keeps its registers)
template <bool K6, int NT, int GP>
constexpr int min_blocks() {
  return !K6 && GP == 1 ? 1024 / NT : 1;
}

template <int FMT, bool K6, int NT, int DC, int GP>
__global__ void __launch_bounds__(NT, min_blocks<K6, NT, GP>())
    scores_kernel(const Args a) {
  using F = Fmt<FMT>;
  constexpr int NS = NT / 32;              // D segments
  // chunks a segment where D is known at compile time (0: at run time)
  constexpr int NCS = DC && ((DC * F::ESIZE + 15) / 16) % NS == 0
                          ? (DC * F::ESIZE + 15) / 16 / NS : 0;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float smx[2][MAX_REP], sraw[MAX_REP];
  // K16's int8 write: the new row's k and v codes, the block's maxima
  constexpr int QD = K6 && FMT == INT8 ? 256 : 1;
  __shared__ float sck[QD], scv[QD], sqr[NT / 32];
  if constexpr (K6) allow_next_launch();   // one slot: a wave or less
  // K18: the amax word zeroed for this call's PV blocks, which take it
  // after this launch has finished (the call before has finished with it)
  if (a.amax && blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0)
    *a.amax = 0u;
  const Block<FMT, K6> k(a, false);
  if (!k.active()) return;
  const int D = DC ? DC : a.D;
  const int nc = (D * F::ESIZE + 15) / 16;
  const int DQ = nc * F::EPC;              // D padded to whole chunks
  const int G = k.G, tid = threadIdx.x;
  const int RS = GP ? GP : k.rows;         // rows of the buffers
  uint8_t* buf = smem;
  double* sq = reinterpret_cast<double*>(buf + a.stages * SLOTS * k.srow);
  double* spart = sq + RS * DQ;            // [NS][RS][SLOTS]
  const int nst = a.stages < k.nt ? a.stages : k.nt;
  const int tile_bytes = SLOTS * k.srow;
  // K16's write: the cache's row pos is not read (bf16: the new row is
  // staged in its place; int8: it is scored apart)
  const int sk = a.write ? k.newk : -1;
  const uint8_t* nrow =
      FMT == BF16 && sk >= 0
          ? reinterpret_cast<const uint8_t*>(a.kn + (size_t)k.bh * D)
          : nullptr;
  auto stage = [&](int i, int s) {
    k.stage(a, a.kc, i, buf + s * tile_bytes, sk, nrow);
  };
  ring_begin(k.nt, nst, stage);            // the K tiles' copies first
  for (int i = tid; i < RS * DQ; i += NT) {
    const int r = i / DQ, d = i - r * DQ;
    sq[i] = d < D && r < G
        ? (double)__bfloat162float(a.q[(size_t)(k.q0 + r) * D + d]) : 0.0;
  }
  if (tid < MAX_REP) sraw[tid] = -INFINITY;
  __syncthreads();
  if constexpr (K6) {
    // K16's write: group 0's block stores the new row at pos (bf16; the
    // int8 codes and scales below); nothing in this call reads it there
    if constexpr (FMT == BF16) {
      if (sk >= 0 && k.g == 0) {
        const size_t at = ((size_t)k.bh * a.T + sk) * D;
        const __nv_bfloat16* kn = a.kn + (size_t)k.bh * D;
        const __nv_bfloat16* vn = a.vn + (size_t)k.bh * D;
        __nv_bfloat16* kc = (__nv_bfloat16*)a.kc;   // the written cache
        __nv_bfloat16* vc = (__nv_bfloat16*)a.vc;
        for (int e = tid; e < D; e += NT) {
          kc[at + e] = kn[e];
          vc[at + e] = vn[e];
        }
      }
    }
    // the new row at pos, scored apart: K6's raw row, scale 1, s = f32(q .
    // k_new) * 1/sqrt(D); K16's int8 row as its codes times the new scale,
    // s = f32(q . codes) * f32(k_scale * 1/sqrt(D))
    if (k.raw >= 0) {
      const __nv_bfloat16* kn = a.kn + (size_t)k.bh * D;
      float rscale = a.scale;
      bool codes = false;
      if constexpr (FMT == INT8) {
        if (a.write) {
          const float ksc = quant_row<NT>(kn, D, sck, sqr);
          rscale = __fmul_rn(ksc, a.scale);
          codes = true;
          if (k.g == 0) {   // the stored codes and scales
            const float vsc =
                quant_row<NT>(a.vn + (size_t)k.bh * D, D, scv, sqr);
            const size_t at = (size_t)k.bh * a.T + k.raw;
            int8_t* kc = (int8_t*)a.kc;               // the written cache
            int8_t* vc = (int8_t*)a.vc;
            for (int e = tid; e < D; e += NT) {
              kc[at * D + e] = (int8_t)sck[e];
              vc[at * D + e] = (int8_t)scv[e];
            }
            if (tid == 0) {
              ((float*)a.ks)[at] = ksc;
              ((float*)a.vs)[at] = vsc;
            }
          }
        }
      }
      for (int r = tid >> 5; r < G; r += NS) {
        double d = 0.0;
        for (int e = tid & 31; e < D; e += 32)
          d += sq[r * DQ + e] *
               (codes ? (double)sck[e] : (double)__bfloat162float(kn[e]));
        d = nctt::warp_sum(d);
        if ((tid & 31) == 0) {
          const float s = __fmul_rn((float)d, rscale);
          a.ws[(size_t)(k.q0 + r) * a.T + k.raw] = s;
          sraw[r] = s;
        }
      }
    }
  }
  // thread (key pair kp, D segment h) sums keys kp and kp + 32 of a tile,
  // so each q element it loads serves two keys; threads tid < 64 then
  // finish key slot tid
  const int kp = tid & 31, h = tid >> 5, ks_ = tid & (SLOTS - 1);
  const int c_lo = h * nc / NS, c_hi = (h + 1) * nc / NS;
  const float* ksh = F::QUANT ? a.ks + (size_t)k.bh * a.T : nullptr;
  float mx[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) mx[r] = -INFINITY;

  ring_run(k.nt, nst, stage, [&](int i, int s) {
    const uint8_t* tb = buf + s * tile_bytes;
    const int t0 = k.k0 + i * SLOTS;
    const int nu = k.k1 - t0 < SLOTS ? k.k1 - t0 : SLOTS;
    const bool fin = tid < SLOTS && ks_ < nu;   // finishes slot ks_
    // the finishing threads fetch their key's scale first, so the load
    // overlaps the dot products
    float ksc = 0.f;
    if constexpr (F::QUANT)
      if (fin) ksc = ksh[t0 + ks_];
    if (kp < nu) {
      // one sum a (row, key), its elements in ascending order
      double acc[MAX_REP][2];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) acc[r][0] = acc[r][1] = 0.0;
      const uint8_t* rowa = tb + kp * k.srow;
      const uint8_t* rowb = tb + (kp + SLOTS / 2) * k.srow;
      auto dot_chunk = [&](int c) {
        const uint4 va = *reinterpret_cast<const uint4*>(rowa + c * 16);
        const uint4 vb = *reinterpret_cast<const uint4*>(rowb + c * 16);
        double xa[F::EPC], xb[F::EPC];
        chunk<FMT>(va, xa);
        chunk<FMT>(vb, xb);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (GP ? r >= GP : r >= G) break;
          const double2* qd =
              reinterpret_cast<const double2*>(sq + r * DQ + c * F::EPC);
#pragma unroll
          for (int e = 0; e < F::EPC; e += 2) {
            const double2 qq = qd[e / 2];
            acc[r][0] += qq.x * xa[e];
            acc[r][1] += qq.x * xb[e];
            acc[r][0] += qq.y * xa[e + 1];
            acc[r][1] += qq.y * xb[e + 1];
          }
        }
      };
      if constexpr (NCS > 0) {
#pragma unroll
        for (int c = 0; c < NCS; ++c) dot_chunk(c_lo + c);
      } else {
        for (int c = c_lo; c < c_hi; ++c) dot_chunk(c);
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (GP ? r >= GP : r >= G) break;
        spart[(h * RS + r) * SLOTS + kp] = acc[r][0];
        spart[(h * RS + r) * SLOTS + kp + SLOTS / 2] = acc[r][1];
      }
    }
    __syncthreads();
    const int t = t0 + ks_;
    if (fin && t != k.raw) {
      // K7: s = f32(f32(q . k) [* k_scale]) * 1/sqrt(D); K6: s = f32(q . k)
      // * f32(k_scale * 1/sqrt(D)); K5 (bf16 rows): s = f32(q . k) *
      // 1/sqrt(D)
      const float kscale =
          K6 ? (F::QUANT ? __fmul_rn(ksc, a.scale) : a.scale) : 0.f;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
        double d = spart[r * SLOTS + ks_];
#pragma unroll
        for (int hh = 1; hh < NS; ++hh)
          d += spart[(hh * RS + r) * SLOTS + ks_];
        float s = (float)d;
        if constexpr (K6) {
          s = __fmul_rn(s, kscale);
        } else {
          if constexpr (F::QUANT) s = __fmul_rn(s, ksc);
          s = __fmul_rn(s, a.scale);
        }
        a.ws[(size_t)(k.q0 + r) * a.T + t] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
  });
  if constexpr (!K6) allow_next_launch();  // its tiles read

  if (tid < SLOTS) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      const float m = nctt::warp_max(mx[r]);
      if ((tid & 31) == 0) smx[tid >> 5][r] = m;
    }
  }
  __syncthreads();
  if (tid < G)
    a.pmax[(size_t)(k.q0 + tid) * a.parts + k.p] =
        fmaxf(fmaxf(smx[0][tid], smx[1][tid]), sraw[tid]);
}

// K6's third launch where the plan asks for it (a.lsum): each part's sum
// of exp(s - m) against the rows' global maxima, into lpart.
template <int FMT, int NT>
__global__ void __launch_bounds__(NT) lsum_kernel(const Args a) {
  __shared__ float sm[MAX_REP];
  __shared__ double sred[1][NT / 32][MAX_REP];
  allow_next_launch();
  const Block<FMT, true> k(a, false);
  if (!k.active()) return;
  wait_prior_launch();
  global_max(a, k.q0, k.G, k.np, sm);
  __syncthreads();
  const double l = exp_sums<NT>(a, k.q0, k.G, k.p, 1, k.L, sm, sred);
  if ((int)threadIdx.x < k.G)
    a.lpart[(size_t)(k.q0 + threadIdx.x) * a.parts + k.p] = l;
}

// Launch 2: p against each row's global maximum, the part's float64 PV
// partials, and the ordered fold by the group's last block. DC and GP as in
// scores_kernel; CPT: columns a thread.
template <int FMT, bool K6, int NT, int DC, int GP, int CPT>
__global__ void __launch_bounds__(NT, min_blocks<K6, NT, GP>())
    pv_kernel(const Args a) {
  using F = Fmt<FMT>;
  constexpr int J = MAX_REP * SLOTS / NT;          // (row, slot) a thread
  constexpr int NSG = slot_groups<NT, DC, CPT>();  // slot groups
  constexpr int CTS = NT / NSG;                    // threads a slot group
  constexpr int SPG = SLOTS / NSG;                 // slots a slot group
  constexpr int SB = 4;                            // slots loaded at once
  static_assert(!DC || CTS >= (DC + CPT - 1) / CPT, "columns");
  static_assert(SPG % SB == 0, "slots");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sm[MAX_REP], sfl[MAX_REP];
  __shared__ double sl[MAX_REP], sraw_p[MAX_REP];
  __shared__ double se[MAX_REP * SLOTS / 32];
  __shared__ double sred[K6 ? LSUM_MAX : 1][NT / 32][MAX_REP];
  __shared__ float sam[NT / 32];
  __shared__ int last;
  // a dependent launch after this one may start now: K18's o-projection
  // stage in the design the sweep measures (fused_matvec.ATTN_O_DEPENDENT);
  // K5, K6, K7 and the shipped K18 launch nothing that way after PV
  allow_next_launch();
  const Block<FMT, K6> k(a, true);
  if (!k.active()) return;
  const int D = DC ? DC : a.D;
  const int G = k.G, tid = threadIdx.x;
  const int RS = GP ? GP : k.rows;
  uint8_t* buf = smem;
  double* sp = reinterpret_cast<double*>(
      buf + pv_ring(a.D, F::ESIZE, RS, a.stages, NSG));   // [RS][SLOTS]
  const int nst = a.stages < k.nt ? a.stages : k.nt;
  const int tile_bytes = SLOTS * k.srow;
  // K16's write: bf16 stages v_new in place of the cache's row pos; the
  // int8 codes at pos are stored by launch 1, so the block holding them
  // stages its tiles only once that launch has finished
  const int sk = a.write && FMT == BF16 ? k.newk : -1;
  const uint8_t* nrow =
      sk >= 0 ? reinterpret_cast<const uint8_t*>(a.vn + (size_t)k.bh * D)
              : nullptr;
  const bool late = F::QUANT && a.write && k.newk >= 0;
  auto stage = [&](int i, int s) {
    k.stage(a, a.vc, i, buf + s * tile_bytes, sk, nrow);
  };
  if (!late) ring_begin(k.nt, nst, stage);  // the V tiles' copies first
  for (int i = G * SLOTS + tid; i < RS * SLOTS; i += NT)
    sp[i] = 0.0;       // the padded rows' p: never written, always read
  wait_prior_launch();                     // the scores and part maxima
  if (late) ring_begin(k.nt, nst, stage);
  // the scores and v scales of a tile's (row, slot) pairs, fetched a tile
  // ahead so that their loads overlap the PV products (the first tile's
  // beside the maxima)
  const float* vsh = F::QUANT ? a.vs + (size_t)k.bh * a.T : nullptr;
  float fs[J], fvs[J];
  unsigned fok = 0;                    // bit j: pair j is a key of its row
  auto fetch = [&](int i) {
    const int t0 = k.k0 + i * SLOTS;
    const int nu = k.k1 - t0 < SLOTS ? k.k1 - t0 : SLOTS;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pi = j * NT + tid, r = pi / SLOTS, t = t0 + pi - r * SLOTS;
      if (GP && j * NT >= GP * SLOTS) break;
      const bool ok = r < G && pi - r * SLOTS < nu;
      fok = ok ? fok | 1u << j : fok & ~(1u << j);
      if (ok) {
        fs[j] = a.ws[(size_t)(k.q0 + r) * a.T + t];
        if constexpr (F::QUANT) fvs[j] = t == k.raw ? 1.0f : vsh[t];
      }
    }
  };
  fetch(0);
  global_max(a, k.q0, G, k.np, sm);
  __syncthreads();
  if constexpr (K6) {
    // p needs the whole l first: the part sums in ascending part order,
    // from the third launch or computed here
    double l = 0.0;
    if (a.lsum) {
      if (tid < G)
        for (int pp = 0; pp < k.np; ++pp)
          l += a.lpart[(size_t)(k.q0 + tid) * a.parts + pp];
    } else {
      l = exp_sums<NT>(a, k.q0, G, 0, k.np, k.L, sm, sred);
    }
    if (tid < G) sl[tid] = l;
    if (tid < MAX_REP) sraw_p[tid] = 0.0;
    __syncthreads();
  }
  // thread (c, slot group hs): the column pairs c, c + CT, ... (columns
  // 2c, 2c + 1, 2c + 2CT, ...) of every row over the group's slots of each
  // tile; the groups add at the part's end
  const int CT = (D + CPT - 1) / CPT;
  const int hs = tid / CTS, c = tid - hs * CTS;
  double o[MAX_REP][CPT];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[r][j] = 0.0;
  double l_run = 0.0;                  // K7, threads r < G: row r's l

  ring_run(k.nt, nst, stage, [&](int i, int s) {
    const uint8_t* tb = buf + s * tile_bytes;
    const int t0 = k.k0 + i * SLOTS;
    const int nu = k.k1 - t0 < SLOTS ? k.k1 - t0 : SLOTS;
    // K7: p = bf16(f32(exp(s - m)) [* v_scale]) and the tile's sums of exp
    // over 32 slots by a fixed butterfly; K6: p = bf16(f32(exp(s - m) / l)
    // * v_scale), the raw row's p kept apart (K5: no scale, no raw row)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pi = j * NT + tid, r = pi / SLOTS;
      if (j * NT + (tid & ~31) >= (GP ? GP : G) * SLOTS) break;  // per warp
      double e = 0.0, pv = 0.0;
      if (fok >> j & 1u) {
        e = exp((double)fs[j] - (double)sm[r]);
        float pe = K6 ? (float)(e / sl[r]) : (float)e;
        if constexpr (F::QUANT) pe = __fmul_rn(pe, fvs[j]);
        pv = (double)__bfloat162float(__float2bfloat16_rn(pe));
        if (K6 && t0 + pi - r * SLOTS == k.raw) {
          sraw_p[r] = pv;
          pv = 0.0;
        }
      }
      sp[pi] = pv;
      if constexpr (!K6) {
        e = nctt::warp_sum(e);
        if ((tid & 31) == 0) se[pi >> 5] = e;
      }
    }
    if (i + 1 < k.nt) fetch(i + 1);
    __syncthreads();
    if constexpr (!K6)
      if (tid < G) l_run += se[2 * tid] + se[2 * tid + 1];
    if (c < CT) {
      // this thread's slots, SB at a time, their loads ahead of the
      // products; each p it loads serves its CPT columns. Rows past a
      // short tile hold stale bytes and K6's code row at pos is not read:
      // their elements are zeros
#pragma unroll 2
      for (int s0 = hs * SPG; s0 < (hs + 1) * SPG; s0 += SB) {
        double x[CPT][SB];
#pragma unroll
        for (int e = 0; e < SB; ++e) {
          const uint8_t* row = tb + (s0 + e) * k.srow;
          const bool ok = s0 + e < nu && t0 + s0 + e != k.raw;
#pragma unroll
          for (int j = 0; j < CPT; j += 2) {
            const int col = 2 * (c + j / 2 * CT);
            double v0, v1;
            elem2<FMT>(row, col < D ? col : 0, v0, v1);
            x[j][e] = ok && col < D ? v0 : 0.0;
            x[j + 1][e] = ok && col + 1 < D ? v1 : 0.0;
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (GP ? r >= GP : r >= G) break;
          const double2* pr =
              reinterpret_cast<const double2*>(sp + r * SLOTS + s0);
#pragma unroll
          for (int e = 0; e < SB; e += 2) {
            const double2 pq = pr[e / 2];
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              o[r][j] += pq.x * x[j][e];
              o[r][j] += pq.y * x[j][e + 1];
            }
          }
        }
      }
    }
  });

  if constexpr (K6) {
    // the raw new row at pos: value v_new, scale 1
    if (k.raw >= 0 && hs == 0 && c < CT) {
      const __nv_bfloat16* vn = a.vn + (size_t)k.bh * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = 2 * (c + j / 2 * CT) + (j & 1);
        const double v =
            col < D ? (double)__bfloat162float(vn[col]) : 0.0;
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r >= G) break;
          o[r][j] += sraw_p[r] * v;
        }
      }
    }
  } else {
    if (tid < G) sl[tid] = l_run;
  }
  // the slot groups' sums, added in ascending group order through the free
  // ring: this part's acc
  double* xch = reinterpret_cast<double*>(buf);   // [NSG - 1][RS][D]
  if (hs > 0 && c < CT) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = 2 * (c + j / 2 * CT) + (j & 1);
        if (col < D) xch[((hs - 1) * RS + r) * D + col] = o[r][j];
      }
    }
  }
  __syncthreads();
  if (hs == 0 && c < CT) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = 2 * (c + j / 2 * CT) + (j & 1);
        if (col >= D) continue;
        double v = o[r][j];
#pragma unroll
        for (int gg = 1; gg < NSG; ++gg)
          v += xch[((gg - 1) * RS + r) * D + col];
        o[r][j] = v;
      }
    }
  }
  // the output: bf16, or K18's float32 rows and the block's max |o|
  float omax = 0.f;
  auto emit = [&](int r, int col, double acc, float l) {
    float v = (float)acc;
    if constexpr (!K6) v = __fdiv_rn(v, l);   // K7 normalises after PV
    const size_t i = (size_t)(k.q0 + r) * D + col;
    if (a.att) {
      a.att[i] = v;
      omax = fmaxf(omax, fabsf(v));
    } else {
      a.out[i] = __float2bfloat16_rn(v);
    }
  };
  if (k.np == 1) {   // the only part holding keys: no fold
    if (hs == 0 && c < CT) {
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = 2 * (c + j / 2 * CT) + (j & 1);
          if (col < D) emit(r, col, o[r][j], (float)sl[r]);
        }
      }
    }
    if (a.att) amax_out<NT>(a.amax, omax, sam);
    return;
  }
  // this part's partials, then the fold by the group's last block, parts
  // in ascending order
  const size_t rstride = (size_t)a.parts * (D + 1);
  double* pw = a.part + (size_t)k.q0 * rstride + (size_t)k.p * (D + 1);
  if (hs == 0 && c < CT) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = 2 * (c + j / 2 * CT) + (j & 1);
        if (col < D) pw[r * rstride + col] = o[r][j];
      }
    }
  }
  if (!K6 && tid < G) pw[tid * rstride + D] = sl[tid];
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)k.bh * a.ng + k.g;
  if (tid == 0) last = atomicAdd(ticket, 1) == k.np - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double* p0 = a.part + (size_t)k.q0 * rstride;
  if (tid < G) {
    double l = 0.0;
    if constexpr (!K6)
      for (int pp = 0; pp < k.np; ++pp)
        l += __ldcg(p0 + tid * rstride + (size_t)pp * (D + 1) + D);
    sfl[tid] = (float)l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const double* src = p0 + r * rstride + d;
    double acc = 0.0;
    int pp = 0;
    for (; pp + 4 <= k.np; pp += 4) {   // four loads in flight
      double v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldcg(src + (size_t)(pp + u) * (D + 1));
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += v[u];
    }
    for (; pp < k.np; ++pp) acc += __ldcg(src + (size_t)pp * (D + 1));
    emit(r, d, acc, sfl[r]);
  }
  if (tid == 0) *ticket = 0;
  if (a.att) amax_out<NT>(a.amax, omax, sam);
}

// a launch that may start while the one before it on the stream drains
// (it waits in wait_prior_launch before it reads that launch's output)
template <typename A>
cudaError_t dependent_launch(void (*kernel)(A), dim3 grid, int nt,
                             size_t smem, cudaStream_t stream, const A& a) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// Enqueue the launches of one call: scores, K6's part sums where the plan
// asks for them, then PV and the fold.
template <int FMT, bool K6, int NT, int DC, int GP, int CPT>
int launch(const Args& a, int B, cudaStream_t stream) {
  using F = Fmt<FMT>;
  constexpr int NSG = slot_groups<NT, DC, CPT>();
  const int rows = (a.H / a.Hkv + a.ng - 1) / a.ng;
  const int RS = GP ? GP : rows;
  const size_t smem_a = scores_smem(a.D, F::ESIZE, RS, a.stages, NT);
  const size_t smem_b = pv_smem(a.D, F::ESIZE, RS, a.stages, NSG);
  // the plan (kernels/decode_attention.py decode_plan) computes the same
  if (a.threads != NT || (GP && rows != GP) || a.D > CPT * (NT / NSG) ||
      (DC && a.D != DC) || a.stages < 1 || a.stages > MAX_STAGES ||
      smem_a > MAX_DYN || smem_b > MAX_DYN)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.parts, a.Hkv * a.ng, B);
  // dynamic shared memory past the default 48 KB, once
  static bool opted_in = false;
  cudaError_t e = cudaSuccess;
  if (!opted_in) {
    e = cudaFuncSetAttribute(scores_kernel<FMT, K6, NT, DC, GP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_DYN);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pv_kernel<FMT, K6, NT, DC, GP, CPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MAX_DYN);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  scores_kernel<FMT, K6, NT, DC, GP><<<grid, NT, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (K6) {
    if (a.lsum) {
      e = dependent_launch(lsum_kernel<FMT, NT>, grid, NT, 0, stream, a);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)dependent_launch(pv_kernel<FMT, K6, NT, DC, GP, CPT>, grid,
                               NT, smem_b, stream, a);
}

// the compile-time copies: D 128 (single-row groups, rep 1, also at 256
// threads where the plan asks) and 256; any other D at run time, K7's to
// 512 with four columns a thread
template <int FMT, bool K6>
int dispatch(const Args& a, int B, cudaStream_t s) {
  const int rows = (a.H / a.Hkv + a.ng - 1) / a.ng;
  if (a.D == 128) {
    if (rows == 1)
      return a.threads == 256 ? launch<FMT, K6, 256, 128, 1, 2>(a, B, s)
                              : launch<FMT, K6, 128, 128, 1, 2>(a, B, s);
    return launch<FMT, K6, 128, 128, 0, 2>(a, B, s);
  }
  if (a.D == 256) return launch<FMT, K6, 256, 256, 0, 2>(a, B, s);
  if (a.D < 256) return launch<FMT, K6, 256, 0, 0, 2>(a, B, s);
  if constexpr (K6)
    return (int)cudaErrorInvalidValue;
  else
    return launch<FMT, K6, 256, 0, 0, 4>(a, B, s);
}

// each quantized format's launches, defined in its own source (k6: K6's,
// else K7's), and K5's: K6's kernels over bf16 rows (a.kn null)
int dispatch_int8(bool k6, const Args& a, int B, cudaStream_t s);
int dispatch_fp8(bool k6, const Args& a, int B, cudaStream_t s);
int dispatch_k5(const Args& a, int B, cudaStream_t s);

}  // namespace nctt_dsplit
