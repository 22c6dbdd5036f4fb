// K11's kernels, shared by the two sources that instantiate them:
// csrc/paged_attention.cu (the entry, bf16 and int8 pools) and
// csrc/paged_attention_fp8_int4.cu (fp8 and int4 pools), so that the
// formats compile in parallel. The design is described in
// paged_attention.cu. K15 (csrc/paged_attention_v1.cu) takes the scores
// launch (V1: v1's scale and each page's maximum), Block, ring and the
// format helpers.
#pragma once

#include "nctt_common.cuh"

namespace nctt_k11 {

constexpr int MAX_REP = 8;   // query rows of a group
constexpr int SLOTS = 64;    // key slots of a tile
// tiles in the ring: as many as ~72 KB hold, 3 to 6 (3 where D is known
// only at run time)
template <int FMT, int DC>
__host__ __device__ constexpr int ring_stages() {
  const int tile = (FMT == 3 ? SLOTS / 2 : SLOTS) *
                   ((((DC ? DC : 256) * (FMT == 0 ? 2 : 1) + 15) / 16) | 1) *
                   16;
  const int n = 72 * 1024 / tile;
  return !DC || n < 3 ? 3 : (n > 6 ? 6 : n);
}
constexpr int MAX_PAGES = 512;  // pages a part (kernels/paged_attention.py)
// the most dynamic shared memory a launch takes: bf16 D 256, 8 rows (ring
// 101 KiB, q 16 KiB and segment sums 32 KiB)
constexpr int MAX_DYN_SMEM = 160 * 1024;

// pool formats, as kernels/paged_attention.py numbers them
constexpr int BF16 = 0, INT8 = 1, FP8 = 2, INT4 = 3;

struct Args {
  const __nv_bfloat16* q;
  const uint8_t* kp;
  const float* ks;
  const float* ko;
  const uint8_t* vp;
  const float* vs;
  const float* vo;
  const int* bt;
  const int* lengths;
  __nv_bfloat16* out;
  float* ws;        // [B, Hkv, ng*gs, Tv] scores
  float* pmax;      // [B, Hkv, ng*gs, parts] part maxima (K15: page
                    // maxima [B, Hkv, ng*gs, PMAX])
  double* part;     // [B, Hkv, ng*gs, parts, D + 2] partials (K15: a
                    // page's, [B, Hkv, ng*gs, PMAX, D + 2])
  int* tickets;     // [B, Hkv, ng]
  int H, Hkv, W, page, PMAX, D, ng, part_keys, parts, window, vec;
  float scale, cap, inv_cap;
};

template <int FMT>
struct Fmt {
  static constexpr bool QUANT = FMT != BF16;
  static constexpr bool AFFINE = FMT == INT4;
  static constexpr int ESIZE = FMT == BF16 ? 2 : 1;   // bytes an element
  static constexpr int EPC = 16 / ESIZE;              // elements a chunk
  static constexpr int TU = FMT == INT4 ? SLOTS / 2 : SLOTS;  // rows a tile
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>   // all but the N newest groups landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// exact float64 values of the codes, by bit moves and one float64 operation
using nctt::bf16_bits;
using nctt::e4m3_bits;
using nctt::int8_bits;
__device__ __forceinline__ double nibble(uint32_t n) {      // 0..15
  return __hiloint2double(0x43300000, (int)n) - 4503599627370504.0;  // +8
}

// element e of a staged row (byte address `row`), int4: nibble `hi`
template <int FMT>
__device__ __forceinline__ double elem(const uint8_t* row, int e, int hi) {
  if constexpr (FMT == BF16)
    return bf16_bits(*reinterpret_cast<const uint16_t*>(row + 2 * e));
  else if constexpr (FMT == INT8)
    return int8_bits(row[e]);
  else if constexpr (FMT == FP8)
    return e4m3_bits(row[e]);
  else
    return nibble(hi ? row[e] >> 4 : row[e] & 15u);
}

// the EPC elements of one 16-byte chunk as float64
template <int FMT>
__device__ __forceinline__ void chunk(const uint4& c, int hi,
                                      double (&x)[Fmt<FMT>::EPC]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (FMT == BF16) {
      x[2 * i] = bf16_bits(w[i]);
      x[2 * i + 1] = bf16_bits(w[i] >> 16);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = w[i] >> (8 * j);
        if constexpr (FMT == INT8)
          x[4 * i + j] = int8_bits(b);
        else if constexpr (FMT == FP8)
          x[4 * i + j] = e4m3_bits(b);
        else
          x[4 * i + j] = nibble(hi ? (b >> 4) & 15u : b & 15u);
      }
    }
  }
}

// rows of query row i of a group: window row w = i / rep sits at position
// n - W + w and attends keys t < n - W + w + 1 (W = 1: the single query at
// n - 1 attends n rows), at most Tv rows
__device__ __forceinline__ int row_len(int n, int W, int rep, int i,
                                       int Tv) {
  const int l = n - W + i / rep + 1;
  return l < 0 ? 0 : (l > Tv ? Tv : l);
}

// the first key of query row i: with a band (window > 0) only keys t with
// q_pos - t < window attend, t >= q_pos - window + 1; else key 0
__device__ __forceinline__ int row_lo(int n, int W, int rep, int i,
                                      int window) {
  if (window <= 0) return 0;
  const int lo = n - W + i / rep - window + 1;
  return lo < 0 ? 0 : lo;
}

// A block's group, its rows' keys and its part's tiles.
template <int FMT>
struct Block {
  int b, hk, g, G, rep, n, Tv, row0;     // row0: the group's first ws row
  int klo, khi;                          // keys of any of the group's rows
  int p, p_lo, p_hi;                     // this part; the group's parts
  int rows_pp, half, tpp, i_lo, i_hi;    // tile geometry, tiles to visit
  int tsh;                               // log2(tpp), or -1
  int rowbytes, srow, nc;                // staged row bytes, stride, chunks
  int cw, cu, cdu;                       // this thread's copy column, rows

  __device__ Block(const Args& a, int* slo, int* slen) {
    p = blockIdx.x;
    hk = blockIdx.y / a.ng;
    g = blockIdx.y - hk * a.ng;
    b = blockIdx.z;
    rep = a.H / a.Hkv;
    const int rows = a.W * rep;
    const int gs = (rows + a.ng - 1) / a.ng;
    const int g0 = g * gs;
    G = rows - g0 < gs ? rows - g0 : gs;
    n = a.lengths[b];
    Tv = a.PMAX * a.page;
    row0 = ((b * a.Hkv + hk) * a.ng + g) * gs;
    klo = Tv;
    khi = 0;
    for (int r = 0; r < G; ++r) {
      const int l = row_len(n, a.W, rep, g0 + r, Tv);
      const int lo = row_lo(n, a.W, rep, g0 + r, a.window);
      if (threadIdx.x == 0) {
        slo[r] = lo;
        slen[r] = l;
      }
      if (lo < l) {
        klo = lo < klo ? lo : klo;
        khi = l > khi ? l : khi;
      }
    }
    const int PK = a.part_keys;
    p_lo = klo / PK;
    p_hi = khi > klo ? (khi - 1) / PK + 1 : p_lo;
    rows_pp = FMT == INT4 ? a.page / 2 : a.page;
    half = a.page / 2;
    tpp = (rows_pp + Fmt<FMT>::TU - 1) / Fmt<FMT>::TU;
    tsh = (tpp & (tpp - 1)) ? -1 : __ffs(tpp) - 1;
    rowbytes = a.D * Fmt<FMT>::ESIZE;
    nc = (rowbytes + 15) >> 4;
    srow = (nc | 1) * 16;
    // 16-byte copies: chunk column cw of rows cu, cu + cdu, ... where the
    // block's threads tile whole rows; else (cdu = 0) chunk by chunk
    const int cpr = rowbytes >> 4;
    cdu = cpr && blockDim.x % cpr == 0 ? blockDim.x / cpr : 0;
    cw = cdu ? threadIdx.x % cpr : 0;
    cu = cdu ? threadIdx.x / cpr : 0;
    i_lo = i_hi = 0;
    if (p < p_lo || p >= p_hi) return;
    // keys of the group inside this part, then the tiles holding them
    const int ps = p * PK;
    const int k0 = klo > ps ? klo : ps;
    const int k1 = khi < ps + PK ? khi : ps + PK;
    const int j0 = (k0 - ps) / a.page, j1 = (k1 - 1 - ps) / a.page;
    if constexpr (FMT == INT4) {   // a tile's tokens lie in both halves
      i_lo = j0 * tpp;
      i_hi = (j1 + 1) * tpp;
    } else {
      i_lo = j0 * tpp + (k0 - ps - j0 * a.page) / Fmt<FMT>::TU;
      i_hi = j1 * tpp + (k1 - 1 - ps - j1 * a.page) / Fmt<FMT>::TU + 1;
    }
  }

  __device__ bool active() const { return p >= p_lo && p < p_hi; }

  // the pool pages of the part (those of the block table), into spid
  __device__ void load_pages(const Args& a, int* spid) const {
    const int kpp = a.part_keys / a.page, j0 = p * kpp;
    const int n = a.PMAX - j0 < kpp ? a.PMAX - j0 : kpp;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      spid[j] = a.bt[(size_t)b * a.PMAX + j0 + j];
  }

  // tile i of the part: its pool page, first row, rows and first key
  __device__ __forceinline__ void tile(const Args& a, const int* spid, int i,
                                       int& pid, int& u0, int& nu,
                                       int& kb) const {
    const int j = tsh >= 0 ? i >> tsh : i / tpp;
    u0 = (i - j * tpp) * Fmt<FMT>::TU;
    nu = rows_pp - u0 < Fmt<FMT>::TU ? rows_pp - u0 : Fmt<FMT>::TU;
    kb = p * a.part_keys + j * a.page;
    pid = spid[j];
  }

  // slot k of a tile: its staged row, int4 nibble and token of the page
  __device__ __forceinline__ void slot(int k, int u0, int& unit, int& hi,
                                       int& tok) const {
    if constexpr (FMT == INT4) {
      unit = k & (SLOTS / 2 - 1);
      hi = k >= SLOTS / 2;
      tok = u0 + unit + (hi ? half : 0);
    } else {
      unit = k;
      hi = 0;
      tok = u0 + k;
    }
  }

  // issue the copies of tile i's slab of `pages` into `dst`
  __device__ void stage(const Args& a, const int* spid, const uint8_t* pages,
                        int i, uint8_t* dst) const {
    int pid, u0, nu, kb;
    tile(a, spid, i, pid, u0, nu, kb);
    const uint8_t* src =
        pages + (((size_t)pid * a.Hkv + hk) * rows_pp + u0) * rowbytes;
    if (a.vec && cdu) {
      for (int u = cu; u < nu; u += cdu)
        cp_async16(dst + u * srow + cw * 16, src + (size_t)u * rowbytes +
                                                  cw * 16);
    } else if (a.vec) {
      const int cpr = rowbytes >> 4, m = nu * cpr;
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        const int u = c / cpr;
        cp_async16(dst + u * srow + (c - u * cpr) * 16, src + (size_t)c * 16);
      }
    } else {   // a row of no whole 16-byte chunks: scalars, tail zeroed
      const int rb = nc * 16, m = nu * rb;
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        const int u = c / rb, w = c - u * rb;
        dst[u * srow + w] =
            w < rowbytes ? __ldg(src + (size_t)u * rowbytes + w) : (uint8_t)0;
      }
    }
  }
};

// Visit tiles i_lo .. i_hi-1 of `pages` with NST - 1 tiles in flight:
// body(i, staged tile) runs between two block barriers.
template <int NST, int FMT, typename Body>
__device__ __forceinline__ void ring(const Args& a, const Block<FMT>& k,
                                     const int* spid, const uint8_t* pages,
                                     uint8_t* buf, Body body) {
  const int stage_bytes = Fmt<FMT>::TU * k.srow;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (k.i_lo + s < k.i_hi)
      k.stage(a, spid, pages, k.i_lo + s, buf + s * stage_bytes);
    cp_async_commit();
  }
  for (int i = k.i_lo; i < k.i_hi; ++i) {
    const int c = i - k.i_lo;
    if (i + NST - 1 < k.i_hi)
      k.stage(a, spid, pages, i + NST - 1,
              buf + ((c + NST - 1) % NST) * stage_bytes);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    body(i, buf + (c % NST) * stage_bytes);
    __syncthreads();
  }
}

// Launch A: the scores of the group's rows over this part's keys and each
// row's maximum over the part. DC: D at compile time (0: at run time); GP:
// the group's rows padded to a compile-time count, zero rows past G (0: G
// at run time, each row behind a branch). V1 (K15, a single query, no band
// or softcap): s = f32(q . k) * f32(k_scale * scale), and each row's
// maximum over each page's valid keys instead of the part's.
template <int FMT, int NT, int DC, int GP, bool V1 = false>
__global__ void __launch_bounds__(NT) scores_kernel(const Args a) {
  using F = Fmt<FMT>;
  constexpr int NST = ring_stages<FMT, DC>();
  constexpr int NS = NT / 32;              // D segments
  // chunks a segment where D is known at compile time (0: at run time)
  constexpr int NCS = DC && ((DC * F::ESIZE + 15) / 16) % NS == 0
                          ? (DC * F::ESIZE + 15) / 16 / NS : 0;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int slo[MAX_REP], slen[MAX_REP], spid[MAX_PAGES];
  __shared__ float smx[2][MAX_REP];
  __shared__ float sqsum[MAX_REP];
  const Block<FMT> k(a, slo, slen);
  if (!k.active()) return;
  k.load_pages(a, spid);
  const int D = DC ? DC : a.D;
  const int nc = DC ? (DC * F::ESIZE + 15) / 16 : k.nc;
  const int DQ = nc * F::EPC;              // D padded to whole chunks
  const int G = k.G, tid = threadIdx.x;
  const int gs = (a.W * k.rep + a.ng - 1) / a.ng;
  const int RS = GP ? GP : gs;             // rows of the buffers
  uint8_t* buf = smem;
  double* sq = reinterpret_cast<double*>(buf + NST * F::TU * k.srow);
  double* spart = sq + RS * DQ;            // [NS][RS][SLOTS]
  // query row i = (w, r) is q[b, hk*rep + r, w]
  const int g0 = k.g * gs;
  for (int i = tid; i < RS * DQ; i += NT) {
    const int r = i / DQ, d = i - r * DQ, qi = g0 + r;
    sq[i] = d < D && r < G ? (double)__bfloat162float(
                        a.q[(((size_t)k.b * a.H + (size_t)k.hk * k.rep +
                              qi % k.rep) * a.W + qi / k.rep) * D + d])
                  : 0.0;
  }
  __syncthreads();
  if constexpr (F::AFFINE) {
    // sum of each query row, for the rank-1 offset term of the scores
    for (int r = tid >> 5; r < G; r += NT / 32) {
      double s = 0.0;
      for (int d = tid & 31; d < D; d += 32) s += sq[r * DQ + d];
      s = nctt::warp_sum(s);
      if ((tid & 31) == 0) sqsum[r] = (float)s;
    }
  }
  // thread (key pair kp, D segment h) sums keys kp and kp + 32 of a tile
  // (int4: both nibbles of byte row kp), so each q element it loads serves
  // two keys; threads tid < 64 then finish key slot tid
  const int kp = tid & 31, h = tid >> 5, ks_ = tid & (SLOTS - 1);
  const int c_lo = h * nc / NS, c_hi = (h + 1) * nc / NS;
  float mx[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) mx[r] = -INFINITY;

  ring<NST>(a, k, spid, a.kp, buf, [&](int i, const uint8_t* tb) {
    int pid, u0, nu, kb, unit, hi, tok;
    k.tile(a, spid, i, pid, u0, nu, kb);
    k.slot(ks_, u0, unit, hi, tok);
    const bool fin = tid < SLOTS && unit < nu;   // finishes slot ks_
    const size_t sidx = ((size_t)pid * a.Hkv + k.hk) * a.page + tok;
    // the finishing threads fetch their key's scale and offset first, so
    // the loads overlap the dot products
    float ksc = 0.f, kof = 0.f;
    if (fin) {
      if constexpr (F::QUANT) ksc = a.ks[sidx];
      if constexpr (F::AFFINE) kof = a.ko[sidx];
    }
    int ua, ha, ta, ub, hb, tb_;
    k.slot(kp, u0, ua, ha, ta);
    k.slot(kp + SLOTS / 2, u0, ub, hb, tb_);
    if (ua < nu || ub < nu) {
      // one sum a (row, key), its elements in ascending order
      double acc[MAX_REP][2];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) acc[r][0] = acc[r][1] = 0.0;
      const uint8_t* rowa = tb + ua * k.srow;
      const uint8_t* rowb = tb + ub * k.srow;
      auto dot_chunk = [&](int c) {
        const uint4 va = *reinterpret_cast<const uint4*>(rowa + c * 16);
        const uint4 vb = F::AFFINE
            ? va : *reinterpret_cast<const uint4*>(rowb + c * 16);
        double xa[F::EPC], xb[F::EPC];
        chunk<FMT>(va, ha, xa);
        chunk<FMT>(vb, hb, xb);
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
    if (fin) {
      const int t = kb + tok;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
        if (t < slo[r] || t >= slen[r]) continue;
        double d = spart[r * SLOTS + ks_];
#pragma unroll
        for (int hh = 1; hh < NS; ++hh)
          d += spart[(hh * RS + r) * SLOTS + ks_];
        float s = (float)d;
        if constexpr (V1) {
          s = __fmul_rn(s, F::QUANT ? __fmul_rn(ksc, a.scale) : a.scale);
        } else {
          if constexpr (F::QUANT) s = __fmul_rn(s, ksc);
          if constexpr (F::AFFINE)
            s = __fadd_rn(s, __fmul_rn(sqsum[r], kof));
          s = __fmul_rn(s, a.scale);
          if (a.cap > 0.f)  // gemma's logit softcap, before the mask
            s = __fmul_rn(a.cap,
                          (float)tanh((double)__fmul_rn(s, a.inv_cap)));
        }
        a.ws[(size_t)(k.row0 + r) * k.Tv + t] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
    if constexpr (V1) {
      // the page's maximum at its last visited tile (a tile holds rows of
      // one page), through smx: the trailing barrier of the ring's step
      // orders its reads before the next page's writes
      if (i + 1 == k.i_hi || (i + 1) % k.tpp == 0) {
        if (tid < SLOTS) {
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r) {
            if (r >= G) break;
            const float m = nctt::warp_max(mx[r]);
            if ((tid & 31) == 0) smx[tid >> 5][r] = m;
            mx[r] = -INFINITY;
          }
        }
        __syncthreads();
        if (tid < G)
          a.pmax[(size_t)(k.row0 + tid) * a.PMAX + kb / a.page] =
              fmaxf(smx[0][tid], smx[1][tid]);
      }
    }
  });
  if constexpr (V1) return;

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
    a.pmax[(size_t)(k.row0 + tid) * a.parts + k.p] =
        fmaxf(smx[0][tid], smx[1][tid]);
}

// Launch B: p, l and corr against each row's global maximum, the part's
// PV partials, and the ordered fold by the group's last block. DC and GP as
// in scores_kernel.
template <int FMT, int NT, int DC, int GP>
__global__ void __launch_bounds__(NT) pv_kernel(const Args a) {
  using F = Fmt<FMT>;
  constexpr int NST = ring_stages<FMT, DC>();
  constexpr int J = MAX_REP * SLOTS / NT;  // (row, slot) pairs a thread
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int slo[MAX_REP], slen[MAX_REP], spid[MAX_PAGES];
  __shared__ float sm[MAX_REP], sfl[MAX_REP], sfc[MAX_REP];
  __shared__ double se[2 * MAX_REP], sc[2 * MAX_REP];
  __shared__ int last;
  const Block<FMT> k(a, slo, slen);
  const int D = DC ? DC : a.D;
  const int G = k.G, tid = threadIdx.x;
  const int gs = (a.W * k.rep + a.ng - 1) / a.ng;
  const int g0 = k.g * gs;
  auto out_at = [&](int r, int d) -> __nv_bfloat16& {
    const int qi = g0 + r;
    return a.out[(((size_t)k.b * a.H + (size_t)k.hk * k.rep + qi % k.rep) *
                      a.W + qi / k.rep) * D + d];
  };
  if (!k.active()) {
    if (k.p == 0 && k.p_hi <= k.p_lo)   // no key for any row: zeros
      for (int i = tid; i < G * D; i += NT)
        out_at(i / D, i % D) = __float2bfloat16_rn(0.0f);
    return;
  }
  k.load_pages(a, spid);
  uint8_t* buf = smem;
  double* sp = reinterpret_cast<double*>(buf + NST * F::TU * k.srow);
  for (int i = G * SLOTS + tid; i < GP * SLOTS; i += NT)
    sp[i] = 0.0;       // the padded rows' p: never written, always read
  __syncthreads();   // slo, slen, spid
  if (tid < G && slo[tid] < slen[tid]) {
    // the row's maximum over every part that holds its keys
    const float* pm = a.pmax + (size_t)(k.row0 + tid) * a.parts;
    float m = -INFINITY;
    for (int pp = slo[tid] / a.part_keys;
         pp <= (slen[tid] - 1) / a.part_keys; ++pp)
      m = fmaxf(m, pm[pp]);
    sm[tid] = m;
  }
  // the scores and v scales of a tile's (row, slot) pairs, fetched a tile
  // ahead so that their loads overlap the PV products
  float fs[J], fvs[J], fvo[J];
  unsigned fok = 0;                    // bit j: pair j is a key of its row
  auto fetch = [&](int i) {
    int pid, u0, nu, kb;
    k.tile(a, spid, i, pid, u0, nu, kb);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pi = j * NT + tid, r = pi / SLOTS;
      int unit, hi, tok;
      k.slot(pi - r * SLOTS, u0, unit, hi, tok);
      const int t = kb + tok;
      const bool ok = r < G && unit < nu && t >= slo[r] && t < slen[r];
      fok = ok ? fok | 1u << j : fok & ~(1u << j);
      if (ok) {
        fs[j] = a.ws[(size_t)(k.row0 + r) * k.Tv + t];
        const size_t sidx = ((size_t)pid * a.Hkv + k.hk) * a.page + tok;
        if constexpr (F::QUANT) fvs[j] = a.vs[sidx];
        if constexpr (F::AFFINE) fvo[j] = a.vo[sidx];
      }
    }
  };
  if (k.i_lo < k.i_hi) fetch(k.i_lo);
  // thread (column pair, slot half hs): columns d0 and d1 = d0 + DH of
  // every row over slots hs*32 .. hs*32+31 of each tile; the two halves
  // add at the part's end
  const int DH = (D + 1) / 2, hs = tid / (NT / 2);
  const int d0 = tid - hs * (NT / 2), d1 = d0 + DH;
  double o[MAX_REP][2];              // [row][column d0, d1]
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) o[r][0] = o[r][1] = 0.0;
  double l_run = 0.0, c_run = 0.0;   // threads r < G: row r's sums

  ring<NST>(a, k, spid, a.vp, buf, [&](int i, const uint8_t* tb) {
    // p = bf16(f32(exp(s - m)) [* v_scale]) of each (row, slot); the
    // tile's sums of exp and of corr's terms over its slots
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pi = j * NT + tid, r = pi / SLOTS;
      if (j * NT + (tid & ~31) >= G * SLOTS) break;   // warp-uniform
      double e = 0.0, cv = 0.0, pv = 0.0;
      if (fok >> j & 1u) {
        e = exp((double)fs[j] - (double)sm[r]);
        float pe = (float)e;
        if constexpr (F::AFFINE) cv = (double)pe * (double)fvo[j];
        if constexpr (F::QUANT) pe = __fmul_rn(pe, fvs[j]);
        pv = (double)__bfloat162float(__float2bfloat16_rn(pe));
      }
      sp[pi] = pv;
      e = nctt::warp_sum(e);
      if constexpr (F::AFFINE) cv = nctt::warp_sum(cv);
      if ((tid & 31) == 0) {
        se[pi >> 5] = e;
        sc[pi >> 5] = cv;
      }
    }
    if (i + 1 < k.i_hi) fetch(i + 1);
    __syncthreads();
    if (tid < G) {
      l_run += se[2 * tid] + se[2 * tid + 1];
      if constexpr (F::AFFINE) c_run += sc[2 * tid] + sc[2 * tid + 1];
    }
    if (d0 < DH) {
      int pid, u0, nu, kb;
      k.tile(a, spid, i, pid, u0, nu, kb);
      // this thread's half of the slots (int4: one nibble), eight at a
      // time, their loads ahead of the products; each p it loads serves
      // its two columns
#pragma unroll 2
      for (int s0 = hs * SLOTS / 2; s0 < (hs + 1) * SLOTS / 2; s0 += 8) {
        double xa[8], xb[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int unit = F::AFFINE ? (s0 + e) & (SLOTS / 2 - 1) : s0 + e;
          const uint8_t* row = tb + unit * k.srow;
          const double va = elem<FMT>(row, d0, hs);
          const double vb = elem<FMT>(row, d1 < D ? d1 : d0, hs);
          xa[e] = unit < nu ? va : 0.0;   // rows past a short tile: stale
          xb[e] = unit < nu ? vb : 0.0;
        }
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (GP ? r >= GP : r >= G) break;
          const double2* pr =
              reinterpret_cast<const double2*>(sp + r * SLOTS + s0);
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const double2 pq = pr[e / 2];
            o[r][0] += pq.x * xa[e];
            o[r][1] += pq.x * xb[e];
            o[r][0] += pq.y * xa[e + 1];
            o[r][1] += pq.y * xb[e + 1];
          }
        }
      }
    }
  });

  // this part's partials: acc[D] (the first half's slots plus the
  // second's, exchanged through the free ring), then l and corr
  double* xch = reinterpret_cast<double*>(buf);   // [G][D]
  if (hs == 1 && d0 < DH) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      xch[r * D + d0] = o[r][0];
      if (d1 < D) xch[r * D + d1] = o[r][1];
    }
  }
  __syncthreads();
  double* pw = a.part + (size_t)k.row0 * a.parts * (D + 2);
  const size_t rstride = (size_t)a.parts * (D + 2);
  if (hs == 0 && d0 < DH) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      double* pr = pw + r * rstride + (size_t)k.p * (D + 2);
      pr[d0] = o[r][0] + xch[r * D + d0];
      if (d1 < D) pr[d1] = o[r][1] + xch[r * D + d1];
    }
  }
  if (tid < G) {
    pw[tid * rstride + (size_t)k.p * (D + 2) + D] = l_run;
    pw[tid * rstride + (size_t)k.p * (D + 2) + D + 1] = c_run;
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (k.b * a.Hkv + k.hk) * a.ng + k.g;
  if (tid == 0) last = atomicAdd(ticket, 1) == k.p_hi - k.p_lo - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the fold, parts in ascending order
  if (tid < G) {
    double l = 0.0, c = 0.0;
    for (int pp = k.p_lo; pp < k.p_hi; ++pp) {
      l += __ldcg(pw + tid * rstride + (size_t)pp * (D + 2) + D);
      c += __ldcg(pw + tid * rstride + (size_t)pp * (D + 2) + D + 1);
    }
    sfl[tid] = (float)l;
    sfc[tid] = (float)c;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const double* src = pw + r * rstride + d;
    double acc = 0.0;
    int pp = k.p_lo;
    for (; pp + 4 <= k.p_hi; pp += 4) {   // four loads in flight
      double v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldcg(src + (size_t)(pp + u) * (D + 2));
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += v[u];
    }
    for (; pp < k.p_hi; ++pp) acc += __ldcg(src + (size_t)pp * (D + 2));
    float v = (float)acc;
    if constexpr (F::AFFINE) v = __fadd_rn(v, sfc[r]);
    out_at(r, d) = __float2bfloat16_rn(__fdiv_rn(v, fmaxf(sfl[r], 1e-30f)));
  }
  if (tid == 0) *ticket = 0;
}

template <int FMT, int NT, int DC, int GP>
int launch(const Args& a, int B, cudaStream_t stream) {
  using F = Fmt<FMT>;
  const int rows = a.W * (a.H / a.Hkv);
  const int gs = GP ? GP : (rows + a.ng - 1) / a.ng;   // buffer rows
  const int nc = (a.D * F::ESIZE + 15) / 16;
  const size_t ring_bytes =
      (size_t)ring_stages<FMT, DC>() * F::TU * (nc | 1) * 16;
  const size_t smem_a = ring_bytes + sizeof(double) *
      ((size_t)gs * nc * F::EPC + (size_t)(NT / 32) * gs * SLOTS);
  const size_t smem_b = ring_bytes + sizeof(double) * (size_t)gs * SLOTS;
  const dim3 grid(a.parts, a.Hkv * a.ng, B);
  // dynamic shared memory past the default 48 KB (static included), once
  static bool opted_in = false;
  cudaError_t e = cudaSuccess;
  if (!opted_in) {
    e = cudaFuncSetAttribute(scores_kernel<FMT, NT, DC, GP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_DYN_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pv_kernel<FMT, NT, DC, GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  scores_kernel<FMT, NT, DC, GP><<<grid, NT, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pv_kernel<FMT, NT, DC, GP><<<grid, NT, smem_b, stream>>>(a);
  return (int)cudaGetLastError();
}

// the main paths' widths 128 and 256: groups of 1 and 2 rows (single
// queries at rep 1 and 2) with their row count at compile time, so the row
// loops have no branch; more rows at run time (padding a window's 5-row
// groups to 8 measured slower than the branches, and a copy for every
// count from 1 to 8 gained little on the window and lengthened the build)
template <int FMT, int NT, int DC>
int by_rows(const Args& a, int B, cudaStream_t s) {
  const int rows = a.W * (a.H / a.Hkv), gs = (rows + a.ng - 1) / a.ng;
  if (gs == 1) return launch<FMT, NT, DC, 1>(a, B, s);
  if (gs == 2) return launch<FMT, NT, DC, 2>(a, B, s);
  return launch<FMT, NT, DC, 0>(a, B, s);
}

// a compile-time-D copy for the full widths 32, 64, 128 and 256
// (nctt::full_width); any other D at run time, 128 threads up to D 128
template <int FMT>
int dispatch(const Args& a, int B, cudaStream_t s) {
  switch (a.D) {
    case 32: return launch<FMT, 128, 32, 0>(a, B, s);
    case 64: return launch<FMT, 128, 64, 0>(a, B, s);
    case 128: return by_rows<FMT, 128, 128>(a, B, s);
    case 256: return by_rows<FMT, 256, 256>(a, B, s);
    default:
      return a.D <= 128 ? launch<FMT, 128, 0, 0>(a, B, s)
                        : launch<FMT, 256, 0, 0>(a, B, s);
  }
}

// each format pair's launches, defined in its own source
int dispatch_bf16_int8(int fmt, const Args& a, int B, cudaStream_t s);
int dispatch_fp8_int4(int fmt, const Args& a, int B, cudaStream_t s);

}  // namespace nctt_k11
