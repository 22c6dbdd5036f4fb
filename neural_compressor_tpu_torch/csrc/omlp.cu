// The post-attention half of a W4A8 decoder layer in one cooperative launch:
// o-projection, RMSNorm, gate_up with silu(g)*u, down-projection, both
// residual adds (K17, the decoder-block megakernel; ``mlp_fused`` skips the
// o-projection).
//
// Replaces: neural_compressor_tpu/kernels/omlp_matvec.py
//   _omlp_impl / _make_kernel (K17, OMLP_FUSED). On the TPU the three
//   projections are phases of one sequential grid; x1 and the codes of h
//   live in VMEM scratch between them, and each phase's first weight blocks
//   are fetched while the previous phase ends.
//
// Semantics (the TPU kernel's, which differ from the split K4 path):
//   o:  s = f32(max |x| * f32(1/127)) (1 where it is 0), codes of x / s;
//       x1 = f32(acc_o * s) + f32(residual), kept in FLOAT32 (the split
//       path rounds x1 to bf16);
//   gu: RMSNorm folded by scale invariance: z = x1 * w_rms, s2 =
//       f32(max |z| * f32(1/127)), codes of z / s2, ssc = s2 * f32(rsqrt(
//       mean(x1^2) + eps)); g = acc_g * ssc, u = acc_u * ssc, h = g *
//       f32(sigmoid(g)) * u in float32 (not the split path's four bf16
//       roundings);
//   h is int8-quantized per tn_i-wide tile, ONE scale a tile, hs =
//       f32(max |h_tile| * f32(1/127)) (the split path has one a token);
//   d:  y = bf16(f32(sum_r dot_r * f32(dsc[r] * hs[tile of r])) + x1).
//   Group sums run in float64 over exact products, rounded once (the TPU
//   sums in float32), as K4 does; the sum of squares in float64. Each
//   float32 operation rounds on its own (no fused multiply-add), as
//   kernels/omlp_matvec.py omlp_plain does. Without the o-projection the
//   input is x1 itself (bf16).
//
// Bound on this card: bytes. At llama2-7b: o 8.4 MB, gate_up 45.1 MB and
//   down 22.5 MB of int4 weights plus 4.75 MB of float32 scales a launch.
//
// Design: one cooperative launch of a persistent grid (every block
//   resident; kernels/omlp_matvec.py omlp_plan), the phases split by
//   grid-wide barriers of the consumer warps (grid_barrier), each
//   phase's weights streamed through the column stream of w4a8_gemv.cuh
//   (a producer warp's bulk copies into one ring of slots shared by the
//   phases, tiles of consecutive columns, eight consumer warps):
//     1. o: the consumers quantize the attention output into shared memory
//        (once a block), then x1 = o(x) * s + residual for the block's
//        columns, in float32 to the workspace; each block leaves its
//        float64 sum of x1^2 and its max |x1 * w_rms| in its own slot;
//     2. gate_up: every block folds the blocks' slots (a fixed order: lane
//        l of a warp takes slots l, l + 32, ... in order, then the warp's
//        shuffles), reads x1 once for z's codes, and writes h for its
//        columns (gate column n, up column n + I); each tn_i tile's max |h|
//        goes into a word of the workspace by atomicMax on the bits of the
//        non-negative float (exact in any order), from the block's own
//        maxima in shared memory;
//     3. down: every block reads the tile words and h once for h's codes,
//        each group's scale times its tile's scale, plus x1.
//   The weights do not depend on the activations: the producer warp never
//   waits at a barrier, it streams o's, gate_up's and down's slots in turn
//   as the ring frees, so each barrier and the next prologue overlap the
//   next phase's first copies (the TPU kernel's cross-phase pipelining; a
//   grid sync that every thread of a block joins, cooperative_groups',
//   also waited for the producer, and measured slower on the H100;
//   PERF.md). The tile words come in two sets: a launch
//   takes the set of its generation's parity (a word of the workspace that
//   every block reads before the first barrier and block 0 advances after
//   the last one) and block 0 zeroes the other set for the next launch.
//   tn_i is the TPU kernel's tile (_pick_tiles), numerics here rather than
//   a memory choice.
#include "w4a8_gemv.cuh"

namespace {

using namespace nctt_w4g;

// The words of the argument block (kernels/omlp_matvec.py omlp_workspace),
// 64 bits each: the workspace's addresses, then the plan
enum PlanWord {
  W_X1S, W_HS, W_SS, W_AM, W_TILES, W_GEN, W_BAR, W_COLS, W_STAGES,
  W_UPC_O, W_UPC_G, W_UPC_D, W_BLOCKS, W_SLOT, W_SMEM, PLAN_WORDS
};

struct Plan {
  float* x1s;        // [Kh] float32 x1
  float* hs;         // [I] float32 h
  double* ss;        // [blocks] the blocks' sums of x1^2
  float* am;         // [blocks] the blocks' max |x1 * w_rms|
  unsigned* tiles;   // [2][I / tn_i] tile maxima (bits), zero between calls
  unsigned* gen;     // the launches' generation
  unsigned long long* bar;   // the grid barrier's arrivals, never reset
  int cols, stages, upc_o, upc_g, upc_d, blocks, slot, smem;
};

Plan read_plan(const void* block) {
  const long long* w = static_cast<const long long*>(block);
  return Plan{reinterpret_cast<float*>(w[W_X1S]),
              reinterpret_cast<float*>(w[W_HS]),
              reinterpret_cast<double*>(w[W_SS]),
              reinterpret_cast<float*>(w[W_AM]),
              reinterpret_cast<unsigned*>(w[W_TILES]),
              reinterpret_cast<unsigned*>(w[W_GEN]),
              reinterpret_cast<unsigned long long*>(w[W_BAR]), (int)w[W_COLS],
              (int)w[W_STAGES], (int)w[W_UPC_O], (int)w[W_UPC_G],
              (int)w[W_UPC_D], (int)w[W_BLOCKS], (int)w[W_SLOT],
              (int)w[W_SMEM]};
}

// dynamic shared memory, byte offsets: the ring and its barriers, the even
// and odd codes and the sums per 128 of the widest activation, h's tile
// scales, the block's tile maxima and h's scale for each unit of 128
// codes, the consumers' reductions
struct Layout {
  int xe, xo, gsum, hsc, tmax, hsu, red, total;
};

__host__ __device__ inline Layout layout(int kmax, int n_i, int stages,
                                         int slot) {
  Layout L;
  L.xe = stages * slot + 16 * stages;
  L.xo = L.xe + kmax / 2;
  L.gsum = L.xo + kmax / 2;
  L.hsc = up16(L.gsum + kmax / 32);
  L.tmax = L.hsc + 4 * n_i;
  L.hsu = L.tmax + 4 * n_i;
  L.red = up16(L.hsu + kmax / 32);
  L.total = L.red + RED_BYTES;
  return L;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* residual;
  const float* rms_w;
  const uint8_t* ow;
  const float* osc;
  const uint8_t* guw;
  const float* gusc;
  const uint8_t* dw;
  const float* dsc;
  __nv_bfloat16* y;
  Plan p;
  int Ko, Kh, I, Go, Gg, Gd, tn_i, kmax;
  float eps;
};

// The grid barrier of the consumer warps: the producer warps never wait at
// it, they stream the next phases' slots as the ring frees. Every block is
// resident (a cooperative launch); the counter only grows, so an arrival's
// generation is its count over the blocks. A barrier that never completes
// traps (a launch error) instead of hanging the card.
__device__ void grid_barrier(unsigned long long* bar) {
  consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long nb = gridDim.x;
    const unsigned long long target = (atomicAdd(bar, 1ull) / nb + 1) * nb;
    for (long long spins = 0;; ++spins) {
      unsigned long long v;
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                   : "=l"(v)
                   : "l"(bar)
                   : "memory");
      if (v >= target) break;
      if (spins > (1ll << 28)) __trap();
    }
  }
  consumers_sync();
}

template <bool HAS_O>
__global__ void __launch_bounds__(THREADS, 1) omlp_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_i = a.I / a.tn_i;
  const Layout L = layout(a.kmax, n_i, a.p.stages, a.p.slot);
  const Ring R = make_ring(smem, a.p.stages, a.p.slot);
  const Stream so = make_stream(a.ow, a.osc, a.Ko, a.Go, a.Kh, a.Kh, false,
                                a.p.cols, a.p.upc_o);
  const Stream sg = make_stream(a.guw, a.gusc, a.Kh, a.Gg, 2 * a.I, a.I,
                                true, a.p.cols, a.p.upc_g);
  const Stream sd = make_stream(a.dw, a.dsc, a.I, a.Gd, a.Kh, a.Kh, false,
                                a.p.cols, a.p.upc_d);
  uint32_t* E = reinterpret_cast<uint32_t*>(smem + L.xe);
  uint32_t* O = reinterpret_cast<uint32_t*>(smem + L.xo);
  int* gs = reinterpret_cast<int*>(smem + L.gsum);
  float* hsc = reinterpret_cast<float*>(smem + L.hsc);
  float* hsu = reinterpret_cast<float*>(smem + L.hsu);
  unsigned* tmax = reinterpret_cast<unsigned*>(smem + L.tmax);
  uint8_t* red = smem + L.red;
  const Codes codes{E, O, gs};
  const bool producer = tid >= CTHREADS;
  const int b = blockIdx.x;
  // this launch's tile words (read before the first barrier)
  const unsigned par = *reinterpret_cast<volatile unsigned*>(a.p.gen) & 1u;
  unsigned* tw = a.p.tiles + par * n_i;
  init_ring(R);
  __syncthreads();
  int q = 0;
  if (producer) {   // every phase's slots, the ring permitting
    if (HAS_O) produce(R, so, 0, so.slots(), q);
    produce(R, sg, 0, sg.slots(), q);
    produce(R, sd, 0, sd.slots(), q);
    return;
  }

  // phase 1: x1 = o(x) * s + residual, float32, to the workspace; the
  // block's sum of x1^2 and max |x1 * w_rms| to its slots
  if constexpr (HAS_O) {
    {
      double ss;
      float s;
      quantize_x(a.x, (const float*)nullptr, a.Ko, red, E, O, gs, ss, s);
      consumers_sync();
      double wss = 0.0;
      float wam = 0.f;
      consume(R, so, codes, nullptr, q, [&](int n, float g, float) {
        const float x1 = __fadd_rn(__fmul_rn(g, s),
                                   __bfloat162float(a.residual[n]));
        a.p.x1s[n] = x1;
        wss += (double)x1 * (double)x1;
        wam = fmaxf(wam, fabsf(x1 * a.rms_w[n]));
      });
      double* rd = reinterpret_cast<double*>(red);
      float* rf = reinterpret_cast<float*>(red + CWARPS * 8);
      if (lane == 0) {
        rd[warp] = wss;
        rf[warp] = wam;
      }
      consumers_sync();
      if (tid == 0) {
        double bs = rd[0];
        float bm = rf[0];
        for (int w = 1; w < CWARPS; ++w) {
          bs += rd[w];
          bm = fmaxf(bm, rf[w]);
        }
        a.p.ss[b] = bs;
        a.p.am[b] = bm;
      }
    }
    grid_barrier(a.p.bar);
  }

  // phase 2: RMSNorm folded into the act scale, h = silu(g) * u
  {
    double ss;
    float s2;
    if constexpr (HAS_O) {   // the blocks' slots, in a fixed order
      ss = 0.0;
      float am = 0.f;
      for (int i = lane; i < gridDim.x; i += 32) {
        ss += __ldcg(a.p.ss + i);
        am = fmaxf(am, __ldcg(a.p.am + i));
      }
      ss = nctt::warp_sum(ss);
      s2 = act_scale(nctt::warp_max(am));
      store_codes(a.p.x1s, a.rms_w, a.Kh, [s2](int) { return s2; }, E, O,
                  gs);
    } else {
      quantize_x(a.x, a.rms_w, a.Kh, red, E, O, gs, ss, s2);
    }
    const float inv = (float)(1.0 / sqrt(ss / a.Kh + (double)a.eps));
    const float ssc = s2 * inv;
    for (int t = tid; t < n_i; t += CTHREADS) tmax[t] = 0u;
    if (b == 0)   // the next launch's tile words
      for (int t = tid; t < n_i; t += CTHREADS)
        a.p.tiles[(par ^ 1u) * n_i + t] = 0u;
    consumers_sync();
    consume(R, sg, codes, nullptr, q, [&](int n, float g, float u) {
      const float ga = __fmul_rn(g, ssc), ua = __fmul_rn(u, ssc);
      const float sig = (float)(1.0 / (1.0 + exp(-(double)ga)));
      const float h = __fmul_rn(__fmul_rn(ga, sig), ua);
      a.p.hs[n] = h;
      atomicMax(&tmax[n / a.tn_i], __float_as_uint(fabsf(h)));
    });
    consumers_sync();
    if (sg.c1 > sg.c0)
      for (int t = sg.c0 / a.tn_i + tid; t <= (sg.c1 - 1) / a.tn_i;
           t += CTHREADS)
        atomicMax(&tw[t], tmax[t]);
  }
  grid_barrier(a.p.bar);

  // phase 3: h's codes, one scale a tn_i tile, then down + x1
  for (int t = tid; t < n_i; t += CTHREADS)
    hsc[t] = act_scale(__uint_as_float(__ldcg(tw + t)));
  consumers_sync();
  const int upt = a.tn_i / 128;                // units of 128 codes a tile
  for (int u = tid; u < a.I / 128; u += CTHREADS) hsu[u] = hsc[u / upt];
  const int tn8 = a.tn_i / 8;
  store_codes(a.p.hs, (const float*)nullptr, a.I,
              [&](int c) { return hsc[c / tn8]; }, E, O, gs);
  consumers_sync();
  consume(R, sd, codes, hsu, q, [&](int n, float acc, float) {
    const float x1 = HAS_O ? __ldcg(a.p.x1s + n)
                           : __bfloat162float(a.x[n]);
    a.y[n] = __float2bfloat16_rn(__fadd_rn(acc, x1));
  });
  if (b == 0 && tid == 0) atomicAdd(a.p.gen, 1u);
}

template <bool HAS_O>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = omlp_kernel<HAS_O>;
  static bool opted_in = false;
  cudaError_t e;
  if (!opted_in) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             nctt::MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  int dev = 0, nsm = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, THREADS, a.p.smem)) != cudaSuccess)
    return (int)e;
  // every block resident, or the grid barrier would wait forever
  if (occ * nsm < a.p.blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(a.p.blocks),
                                  dim3(THREADS), args, a.p.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Whether a plan fits the shape (kernels/omlp_matvec.py omlp_plan makes
// them): tiles of 8 or 16 columns, each phase's slots of units of 128
// codes within the slot, the layout within the block's shared memory
bool plan_ok(const Plan& p, int Ko, int Kh, int I, int tn_i, int has_o,
             int kmax) {
  if (!p.x1s || !p.hs || !p.ss || !p.am || !p.tiles || !p.gen || !p.bar ||
      !(p.cols == 8 || p.cols == 16) || p.stages < 2 ||
      p.stages > MAX_STAGES || p.blocks < 1)
    return false;
  const int K[3] = {Ko, Kh, I};
  const int upc[3] = {p.upc_o, p.upc_g, p.upc_d}, runs[3] = {1, 2, 1};
  for (int i = has_o ? 0 : 1; i < 3; ++i) {
    if (upc[i] < 1 || upc[i] > K[i] / 128 ||
        slot_bytes(runs[i], p.cols, upc[i]) > p.slot)
      return false;
  }
  const Layout L = layout(kmax, I / tn_i, p.stages, p.slot);
  return p.slot % 16 == 0 && p.smem == L.total &&
         L.total <= nctt::MAX_DYN_SMEM;
}

}  // namespace

// has_o = 1: x bf16 [Ko] (the attention output), residual bf16 [Kh], o
// weights uint8 "hopper_nk" [Kh, Ko/2] with scales f32 [Ko/Go, Kh]; has_o
// = 0: x bf16 [Kh] is x1 itself (ow, osc, residual unused). rms_w f32
// [Kh]; gate_up uint8 [2I, Kh/2] with scales f32 [Kh/Gg, 2I]; down uint8
// [Kh, I/2] with scales f32 [I/Gd, Kh]; y bf16 [Kh]; plan: the argument
// block of the wrapper's omlp_workspace (the workspace and omlp_plan's plan,
// in PlanWord's order). Every K and group a multiple of 128; I % tn_i == 0
// and tn_i % Gd == 0; a plan that does not fit is refused
// (cudaErrorInvalidValue), not run.
NCTT_API int nctt_omlp(const void* x, const void* residual, const void* rms_w,
                       const void* ow, const void* osc, const void* guw,
                       const void* gusc, const void* dw, const void* dsc,
                       void* y, const void* plan, int Ko, int Kh, int I,
                       int Go, int Gg, int Gd, int tn_i, float eps,
                       int has_o, void* stream) {
  if (!plan || tn_i <= 0 || I % tn_i || tn_i % Gd || tn_i % 128)
    return (int)cudaErrorInvalidValue;
  const int ks[6] = {Ko, Kh, I, Go, Gg, Gd};
  for (int k : ks)
    if (k < 128 || k % 128) return (int)cudaErrorInvalidValue;
  if (Ko % Go || Kh % Gg || I % Gd) return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  const int kmax = max(max(has_o ? Ko : 0, Kh), I);
  if (!plan_ok(p, Ko, Kh, I, tn_i, has_o, kmax))
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)residual,
               (const float*)rms_w, (const uint8_t*)ow, (const float*)osc,
               (const uint8_t*)guw, (const float*)gusc, (const uint8_t*)dw,
               (const float*)dsc, (__nv_bfloat16*)y, p, Ko, Kh, I, Go, Gg,
               Gd, tn_i, kmax, eps};
  cudaStream_t s = (cudaStream_t)stream;
  return has_o ? launch<true>(a, s) : launch<false>(a, s);
}
