// Paged decode attention, one query a slot, with v1's online softmax whose
// running maximum moves page by page (K15, the engine's paged_v2 = False
// kernel): bf16 rows, or int8 / fp8-e4m3 codes with per-(token, head)
// float32 scales. Each slot's pages are split across blocks in parts of
// whole pages, as K11's are.
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_attn_impl / _paged_kernel (bf16 pools) and
//   _paged_attn_quant_impl / _paged_quant_kernel (int8 and fp8 pools), the
//   v1 kernels (grid (B, Hkv, PMAX), one page a grid step).
//
// Semantics (v1's, which rounds in its own places, not K11's): q [B, H, D];
//   pools [P, Hkv, page, D] with scales [P, Hkv, page]; block_tables int32
//   [B, PMAX]; lengths int32 [B] (the new row included). For each visited
//   page p (at most PMAX), in order:
//     s = f32(q . k) * scale (bf16) or * f32(k_scale * scale) (codes), keys
//       t >= length masked;
//     m_p = max(m_{p-1}, max_t s), the running max UP TO THIS PAGE
//       (m_{-1} = -1e30);
//     alpha_p = exp(m_{p-1} - m_p);
//     e = f32(exp(s - m_p)); l = l * alpha_p + sum e;
//     p = bf16(e [* v_scale]), UNNORMALISED;
//     acc = acc * alpha_p + sum p * v;
//   out = bf16(f32(acc) / max(f32(l), 1e-30)); a slot of length 0 gives
//   zeros (JAX multiplies its output by lengths > 0). Pages past the
//   length add exactly nothing (alpha = 1, e = 0) and are not visited.
//   alpha, l and acc are carried in float64 (the TPU carries float32);
//   exp runs in float64 and e is rounded to float32 where the TPU has it.
//
// Bound on this card: bytes. Each visited row is read once: 2*Hkv*len*D
//   code bytes (x2 for bf16) plus 2*Hkv*len*4 scale bytes per slot.
//
// Design: K11's split (csrc/paged_attention.cu, paged_attention.cuh) with
//   v1's fold. The one-block-a-(slot, head, group) kernel it replaces
//   walked a slot's pages one after another, three barriers a page and no
//   asynchronous copies, so the longest slot set the launch. A split must
//   keep v1's rounding: p is rounded against the running maximum up to its
//   page, not the global one, so K11's flash-decoding fold (p against the
//   global maximum) would move bits, and so would a running maximum
//   restarted at each part. What makes it splittable: the running maximum
//   up to page p is fmaxf over the page maxima 0..p (order-free), and the
//   recurrence needs only each page's partials (S_p, l_p, alpha_p).
//   * Plan. kernels/paged_attention.py v1_plan: K11's split_plan at W = 1,
//     groups of at most 8 query rows, parts of whole pages (512 keys at
//     128-row pages) at absolute key positions set by the page size alone;
//     grid (parts, Hkv * groups, B) for both launches. Scratch (score
//     rows, page maxima, page partials, zeroed tickets) and the argument
//     block come from v1_workspace, kept per device.
//   * Launch 1: K11's scores_kernel with V1 set: each part's K tiles staged
//     by 16-byte cp.async into a ring, float64 dot products over exact
//     terms, v1's scale, the scores to the float32 workspace, and each
//     row's maximum over each page's valid keys to pmax [.., PMAX].
//   * Launch 2 (pv_fold_kernel below): a block takes the page maxima of its
//     slot up to its part's last page and forms m_p for each of its pages
//     (fmaxf from m_{-1} = -1e30); then, for each tile of its V pages
//     (staged as in K11), e = f32(exp(f64(s) - f64(m_p))), p = bf16(e [*
//     v_scale]) and the tile's sums of e by a fixed butterfly; thread
//     (column pair, slot half) sums p * v in float64 over its slots. At a
//     page's last tile the two slot halves add through shared memory and
//     the page's partials go out: S_p [D], l_p and alpha_p = exp(f64(m_{p-1})
//     - f64(m_p)), into part [B, Hkv, rows, PMAX, D + 2].
//   * The fold. The last block of a (slot, KV head, group), by an atomic
//     ticket taken after __threadfence() (as K11, K6 and K7), replays l =
//     l * alpha_p + l_p and acc = acc * alpha_p + S_p over the slot's pages
//     in ascending order, each product and sum rounded apart (__dmul_rn,
//     __dadd_rn: no contraction into an FMA, as the plain version rounds
//     them), writes bf16(f32(acc) / max(f32(l), 1e-30)) and resets its
//     ticket. A group whose pages lie in one part folds in its own block,
//     with no ticket. A slot of length 0 writes zeros.
//   * Numerics. Every product is exact in float64 (bf16 x bf16, codes x
//     bf16 p), so the dot products and S_p are exact in practice and their
//     order does not show; l_p sums float32 values in float64 and the fold
//     repeats the plain version's operations one for one: the kernel and
//     its plain version (kernels/paged_attention.py paged_attn_v1_plain)
//     agree bit for bit but where a float64 exp or sum lands on a rounding
//     boundary of the output (chip_smoke.py's ulp_check counts them).
//   * Copies: D 128 (groups of one row with the row count at compile
//     time, or more at run time) and 256 with D at compile time; any other
//     D at run time, 128 threads to D 128 and 256 above.
#include "paged_attention.cuh"

namespace nctt_v1 {

using namespace nctt_k11;

// dynamic shared memory of the PV launch: the ring, p of a tile [RS][SLOTS]
// and the slot halves' exchange [RS][D] (float64), the running maxima
// [RS][kpp + 1] (float32)
inline size_t pv_smem(int ring_bytes, int rs, int D, int kpp) {
  return ring_bytes + sizeof(double) * ((size_t)rs * SLOTS + (size_t)rs * D) +
         sizeof(float) * (size_t)rs * (kpp + 1);
}

// Launch 2: p against the running maximum up to its page, the page
// partials, and the fold in page order by the group's last block. DC and
// GP as in scores_kernel.
template <int FMT, int NT, int DC, int GP>
__global__ void __launch_bounds__(NT) pv_fold_kernel(const Args a) {
  using F = Fmt<FMT>;
  constexpr int NST = ring_stages<FMT, DC>();
  constexpr int J = MAX_REP * SLOTS / NT;  // (row, slot) pairs a thread
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int slo[MAX_REP], slen[MAX_REP], spid[MAX_PAGES];
  __shared__ float sfl[MAX_REP];
  __shared__ double se[2 * MAX_REP];
  __shared__ int last;
  const Block<FMT> k(a, slo, slen);
  const int D = DC ? DC : a.D;
  const int G = k.G, tid = threadIdx.x;
  const int gs = (k.rep + a.ng - 1) / a.ng;
  const int RS = GP ? GP : gs;
  // the group's query rows are q[b, hk*rep + g*gs + r] (one query a slot)
  __nv_bfloat16* out =
      a.out + ((size_t)k.b * a.H + (size_t)k.hk * k.rep + k.g * gs) * D;
  if (!k.active()) {
    if (k.p == 0 && k.p_hi <= k.p_lo)   // length 0: zeros
      for (int i = tid; i < G * D; i += NT)
        out[i] = __float2bfloat16_rn(0.0f);
    return;
  }
  k.load_pages(a, spid);
  const int kpp = a.part_keys / a.page;           // pages a part
  const int pg0 = k.p * kpp;                      // the part's first page
  const int Lv = k.n < k.Tv ? k.n : k.Tv;
  const int npg = (Lv + a.page - 1) / a.page;     // the slot's pages
  const int npp = npg - pg0 < kpp ? npg - pg0 : kpp;
  uint8_t* buf = smem;
  double* sp = reinterpret_cast<double*>(buf + NST * F::TU * k.srow);
  double* xch = sp + RS * SLOTS;                  // [RS][D]
  float* spm = reinterpret_cast<float*>(xch + RS * D);   // [RS][kpp + 1]
  for (int i = G * SLOTS + tid; i < RS * SLOTS; i += NT)
    sp[i] = 0.0;       // the padded rows' p: never written, always read
  if (tid < G) {
    // the running maximum before the part, then after each of its pages
    const float* pm = a.pmax + (size_t)(k.row0 + tid) * a.PMAX;
    float* row = spm + tid * (kpp + 1);
    float m = -1e30f;
    for (int j = 0; j < pg0; ++j) m = fmaxf(m, pm[j]);
    row[0] = m;
    for (int jj = 0; jj < npp; ++jj) {
      m = fmaxf(m, pm[pg0 + jj]);
      row[1 + jj] = m;
    }
  }
  __syncthreads();   // slo, slen, spid, spm
  // the scores and v scales of a tile's (row, slot) pairs, fetched a tile
  // ahead so that their loads overlap the PV products
  float fs[J], fvs[J];
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
      const bool ok = r < G && unit < nu && t < slen[r];
      fok = ok ? fok | 1u << j : fok & ~(1u << j);
      if (ok) {
        fs[j] = a.ws[(size_t)(k.row0 + r) * k.Tv + t];
        if constexpr (F::QUANT)
          fvs[j] = a.vs[((size_t)pid * a.Hkv + k.hk) * a.page + tok];
      }
    }
  };
  fetch(k.i_lo);
  // thread (column pair, slot half hs): columns d0 and d1 = d0 + DH of
  // every row over slots hs*32 .. hs*32+31 of each tile of a page; the two
  // halves add at the page's end
  const int DH = (D + 1) / 2, hs = tid / (NT / 2);
  const int d0 = tid - hs * (NT / 2), d1 = d0 + DH;
  double o[MAX_REP][2];              // [row][column d0, d1]
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) o[r][0] = o[r][1] = 0.0;
  double l_run = 0.0;                // threads r < G: the page's sum of e
  const size_t pstride = (size_t)a.PMAX * (D + 2);   // a row's partials

  ring<NST>(a, k, spid, a.vp, buf, [&](int i, const uint8_t* tb) {
    int pid, u0, nu, kb;
    k.tile(a, spid, i, pid, u0, nu, kb);
    const int jj = kb / a.page - pg0;              // the page in the part
    // p = bf16(f32(exp(s - m_p)) [* v_scale]) of each (row, slot); the
    // tile's sums of e over its slots
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pi = j * NT + tid, r = pi / SLOTS;
      if (j * NT + (tid & ~31) >= G * SLOTS) break;   // warp-uniform
      double e = 0.0, pv = 0.0;
      if (fok >> j & 1u) {
        const float ef = (float)exp((double)fs[j] -
                                    (double)spm[r * (kpp + 1) + 1 + jj]);
        float pe = ef;
        if constexpr (F::QUANT) pe = __fmul_rn(pe, fvs[j]);
        pv = (double)__bfloat162float(__float2bfloat16_rn(pe));
        e = (double)ef;
      }
      sp[pi] = pv;
      e = nctt::warp_sum(e);
      if ((tid & 31) == 0) se[pi >> 5] = e;
    }
    if (i + 1 < k.i_hi) fetch(i + 1);
    __syncthreads();
    if (tid < G) l_run += se[2 * tid] + se[2 * tid + 1];
    if (d0 < DH) {
      // this thread's half of the slots, eight at a time, their loads
      // ahead of the products; each p it loads serves its two columns
#pragma unroll 2
      for (int s0 = hs * SLOTS / 2; s0 < (hs + 1) * SLOTS / 2; s0 += 8) {
        double xa[8], xb[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint8_t* row = tb + (s0 + e) * k.srow;
          const double va = elem<FMT>(row, d0, 0);
          const double vb = elem<FMT>(row, d1 < D ? d1 : d0, 0);
          xa[e] = s0 + e < nu ? va : 0.0;   // rows past a short tile: stale
          xb[e] = s0 + e < nu ? vb : 0.0;
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
    if (i + 1 == k.i_hi || (i + 1) % k.tpp == 0) {
      // the page's last tile: its partials S_p (the first half's slots
      // plus the second's), l_p and alpha_p
      if (hs == 1 && d0 < DH) {
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r >= G) break;
          xch[r * D + d0] = o[r][0];
          if (d1 < D) xch[r * D + d1] = o[r][1];
        }
      }
      __syncthreads();
      double* pw = a.part + (size_t)k.row0 * pstride +
                   (size_t)(pg0 + jj) * (D + 2);
      if (hs == 0 && d0 < DH) {
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r >= G) break;
          pw[r * pstride + d0] = o[r][0] + xch[r * D + d0];
          if (d1 < D) pw[r * pstride + d1] = o[r][1] + xch[r * D + d1];
        }
      }
      if (tid < G) {
        const float* row = spm + tid * (kpp + 1);
        pw[tid * pstride + D] = l_run;
        pw[tid * pstride + D + 1] =
            exp((double)row[jj] - (double)row[jj + 1]);
        l_run = 0.0;
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) o[r][0] = o[r][1] = 0.0;
    }
  });

  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (k.b * a.Hkv + k.hk) * a.ng + k.g;
  if (k.p_hi - k.p_lo > 1) {   // the group's last block folds
    if (tid == 0) last = atomicAdd(ticket, 1) == k.p_hi - k.p_lo - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  // the fold: v1's recurrence over the slot's pages in ascending order
  const double* p0 = a.part + (size_t)k.row0 * pstride;
  if (tid < G) {
    const double* src = p0 + tid * pstride;
    double l = 0.0;
    for (int pg = 0; pg < npg; ++pg)
      l = __dadd_rn(__dmul_rn(l, __ldcg(src + (size_t)pg * (D + 2) + D + 1)),
                    __ldcg(src + (size_t)pg * (D + 2) + D));
    sfl[tid] = fmaxf((float)l, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const double* src = p0 + r * pstride;
    double acc = 0.0;
    for (int pg = 0; pg < npg; ++pg) {
      const double* pw = src + (size_t)pg * (D + 2);
      acc = __dadd_rn(__dmul_rn(acc, __ldcg(pw + D + 1)), __ldcg(pw + d));
    }
    out[i] = __float2bfloat16_rn(__fdiv_rn((float)acc, sfl[r]));
  }
  if (tid == 0 && k.p_hi - k.p_lo > 1) *ticket = 0;
}

template <int FMT, int NT, int DC, int GP>
int launch_v1(const Args& a, int B, cudaStream_t stream) {
  using F = Fmt<FMT>;
  const int rows = a.H / a.Hkv;
  const int gs = GP ? GP : (rows + a.ng - 1) / a.ng;   // buffer rows
  const int nc = (a.D * F::ESIZE + 15) / 16;
  const int ring_bytes = ring_stages<FMT, DC>() * F::TU * (nc | 1) * 16;
  const size_t smem_a = ring_bytes + sizeof(double) *
      ((size_t)gs * nc * F::EPC + (size_t)(NT / 32) * gs * SLOTS);
  const size_t smem_b = pv_smem(ring_bytes, gs, a.D, a.part_keys / a.page);
  if (smem_a > MAX_DYN_SMEM || smem_b > MAX_DYN_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.parts, a.Hkv * a.ng, B);
  // dynamic shared memory past the default 48 KB (static included), once
  static bool opted_in = false;
  cudaError_t e = cudaSuccess;
  if (!opted_in) {
    e = cudaFuncSetAttribute(scores_kernel<FMT, NT, DC, GP, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_DYN_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pv_fold_kernel<FMT, NT, DC, GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  scores_kernel<FMT, NT, DC, GP, true><<<grid, NT, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pv_fold_kernel<FMT, NT, DC, GP><<<grid, NT, smem_b, stream>>>(a);
  return (int)cudaGetLastError();
}

// D 128 (single-query groups of one row at compile time: rep 1, the
// llama2-7b main path) and 256 with D at compile time; any other D and
// row count at run time
template <int FMT>
int dispatch_v1(const Args& a, int B, cudaStream_t s) {
  const int rows = a.H / a.Hkv, gs = (rows + a.ng - 1) / a.ng;
  switch (a.D) {
    case 128:
      return gs == 1 ? launch_v1<FMT, 128, 128, 1>(a, B, s)
                     : launch_v1<FMT, 128, 128, 0>(a, B, s);
    case 256: return launch_v1<FMT, 256, 256, 0>(a, B, s);
    default:
      return a.D <= 128 ? launch_v1<FMT, 128, 0, 0>(a, B, s)
                        : launch_v1<FMT, 256, 0, 0>(a, B, s);
  }
}

}  // namespace nctt_v1

// q bf16 [B, H, D]; pools [P, Hkv, page, D]: fmt 0 bf16 (scales null),
// 1 int8 or 2 fp8-e4m3 codes with scales f32 [P, Hkv, page]; block_tables
// int32 [B, PMAX]; lengths int32 [B]; out bf16 [B, H, D]. `plan`, seven
// 64-bit words (kernels/paged_attention.py v1_workspace): the scratch's
// addresses, ws f32 [B, Hkv, ng*gs, PMAX*page] scores, pmax f32 [B, Hkv,
// ng*gs, PMAX] page maxima, part f64 [B, Hkv, ng*gs, PMAX, D + 2] page
// partials, tickets int32 [B*Hkv*ng] zeroed (each call leaves them zeroed);
// then the plan (v1_plan): ng groups of query rows, parts of part_keys keys
// (whole pages, at most MAX_PAGES), `parts` of them over the table. 1 <= D
// <= 256; H % Hkv == 0. Two launches on `stream`.
NCTT_API int nctt_paged_attention_v1(const void* q, const void* kp,
                                     const void* ks, const void* vp,
                                     const void* vs, const void* bt,
                                     const void* lengths, void* out,
                                     const void* plan, int B, int H, int Hkv,
                                     int P, int page, int PMAX, int D,
                                     int fmt, float scale, void* stream) {
  using namespace nctt_k11;
  const long long* w = (const long long*)plan;
  const int ng = (int)w[4], part_keys = (int)w[5], parts = (int)w[6];
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv || P < 1 || page < 1 ||
      PMAX < 1 || ng < 1 || (H / Hkv + ng - 1) / ng > MAX_REP ||
      part_keys < page || part_keys % page ||
      part_keys / page > MAX_PAGES || parts < 1 ||
      (long long)parts * part_keys < (long long)PMAX * page)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = (const __nv_bfloat16*)q;
  a.kp = (const uint8_t*)kp;
  a.ks = (const float*)ks;
  a.vp = (const uint8_t*)vp;
  a.vs = (const float*)vs;
  a.bt = (const int*)bt;
  a.lengths = (const int*)lengths;
  a.out = (__nv_bfloat16*)out;
  a.ws = (float*)w[0];
  a.pmax = (float*)w[1];
  a.part = (double*)w[2];
  a.tickets = (int*)w[3];
  a.H = H;
  a.Hkv = Hkv;
  a.W = 1;
  a.page = page;
  a.PMAX = PMAX;
  a.D = D;
  a.ng = ng;
  a.part_keys = part_keys;
  a.parts = parts;
  a.window = 0;
  const int esize = fmt == BF16 ? 2 : 1;
  a.vec = (D * esize) % 16 == 0 && ((uintptr_t)kp & 15) == 0 &&
          ((uintptr_t)vp & 15) == 0;
  a.scale = scale;
  a.cap = 0.f;
  a.inv_cap = 0.f;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case BF16: return nctt_v1::dispatch_v1<BF16>(a, B, s);
    case INT8: return nctt_v1::dispatch_v1<INT8>(a, B, s);
    case FP8: return nctt_v1::dispatch_v1<FP8>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
