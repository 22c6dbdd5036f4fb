// Fused W4A8 decode GEMV (M == 1): [RMSNorm prologue] -> int8 activation
// quantization -> grouped int4 dot -> [silu(g)*u] [+ bias] [+ residual] ->
// one bf16 store.
//
// Replaces: neural_compressor_tpu/kernels/fused_matvec.py _fused_impl
//   (K4, kernel body _make_kernel).
//
// Bound on this card: bytes. Every weight nibble is used once (2*K*N int8
//   operations on K*N/2 bytes), far below the ~600 operations per byte where
//   the int8 tensor cores would become the limit, so the kernel's job is to
//   stream "hopper_nk" weights (K*N/2 bytes) plus their float32 scales
//   (K/G*N*4 bytes) at the memory rate.
//
// Design: the TPU kernel quantizes the activation once, at grid step 0,
//   into scratch that later steps reuse, because a TPU grid runs in order.
//   Here one launch of a persistent grid streams the weights through the
//   column stream of w4a8_gemv.cuh (a producer warp's bulk copies into a
//   ring of slots, tiles of consecutive columns, eight consumer warps; the
//   plan from kernels/fused_matvec.py w4a8_gemv_plan). Each block first
//   issues the ring's first copies, then quantizes the activation while
//   they fly: the sum of squares in float64, max |z|, z = x * w_rms, and
//   the K int8 codes of z in shared memory, once a block. Past the plan's
//   limit on K one block of a first launch quantizes the activation once
//   into global memory (scratch of the plan's argument block) and the
//   consumers read the codes from there (L2 holds them), so K has no cap.
//   Group sums are exact in int32, summed over groups in float64 and
//   rounded once, as kernels/fused_matvec.py fused_gemv_plain does: the
//   sums carry 29 bits more than the float32 result, so their order almost
//   never shows, and kernel and plain version agree bit for bit on the main
//   path's inputs. silu pairs column n with column n + N/2 of the same
//   concatenated gate_up weight. The epilogue rounds each operation on its
//   own (no fused multiply-add), as the plain version does.
#include "w4a8_gemv.cuh"

namespace {

using namespace nctt_w4g;

struct Args {
  const __nv_bfloat16* x;
  const float* rms_w;          // or null
  const uint8_t* w;
  const float* scales;
  const float* bias;           // or null
  const __nv_bfloat16* residual;   // or null
  __nv_bfloat16* y;
  K4Plan p;
  int K, N, G, n_out, silu;
  float eps;
};

// the activation's codes, sums per 128 and scales (s, s times the norm's
// factor) by the block's consumers, into E/O/gsum
__device__ void quantize_activation(const Args& a, uint32_t* E, uint32_t* O,
                                    int* gsum, uint8_t* red, float& s,
                                    float& ssc) {
  double ss;
  quantize_x(a.x, a.rms_w, a.K, red, E, O, gsum, ss, s);
  const float inv =
      a.rms_w ? (float)(1.0 / sqrt(ss / a.K + (double)a.eps)) : 1.0f;
  ssc = s * inv;
}

// K past the plan's limit: one block of CTHREADS quantizes the activation
// once into the plan's global scratch
__global__ void __launch_bounds__(CTHREADS)
fused_gemv_quant_kernel(const Args a) {
  __shared__ __align__(16) uint8_t red[RED_BYTES];
  float s, ssc;
  quantize_activation(a, a.p.codes, a.p.codes + a.K / 8, a.p.gsum, red, s,
                      ssc);
  if (threadIdx.x == 0) {
    a.p.scl[0] = s;
    a.p.scl[1] = ssc;
  }
}

// GLOBAL: the codes and scales come from fused_gemv_quant_kernel in global
// memory; otherwise each block quantizes the activation into its own
// shared memory
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS, 1)
fused_gemv_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const K4Layout L = k4_layout(a.K, a.p.stages, a.p.slot, GLOBAL);
  const Ring R = make_ring(smem, a.p.stages, a.p.slot);
  const Stream st = make_stream(a.w, a.scales, a.K, a.G, a.N, a.n_out,
                                a.silu, a.p.cols, a.p.upc);
  init_ring(R);
  __syncthreads();
  int q = 0;
  if (threadIdx.x >= CTHREADS) {               // the producer warp
    produce(R, st, 0, st.slots(), q);
    return;
  }
  Codes x;
  float ssc;
  if constexpr (GLOBAL) {
    x = Codes{a.p.codes, a.p.codes + a.K / 8, a.p.gsum};
    ssc = a.p.scl[1];
  } else {
    uint32_t* E = reinterpret_cast<uint32_t*>(smem + L.xe);
    uint32_t* O = reinterpret_cast<uint32_t*>(smem + L.xo);
    int* gs = reinterpret_cast<int*>(smem + L.gsum);
    float s;
    quantize_activation(a, E, O, gs, smem + L.red, s, ssc);
    consumers_sync();
    x = Codes{E, O, gs};
  }
  consume(R, st, x, nullptr, q, [&](int n, float g, float u) {
    float v;
    if (a.silu) {
      const float ga = __fmul_rn(g, ssc), ua = __fmul_rn(u, ssc);
      const float sig = (float)(1.0 / (1.0 + exp(-(double)ga)));
      v = __fmul_rn(__fmul_rn(ga, sig), ua);
    } else {
      v = __fmul_rn(g, ssc);
    }
    if (a.bias) v = __fadd_rn(v, a.bias[n]);
    if (a.residual) v = __fadd_rn(v, __bfloat162float(a.residual[n]));
    a.y[n] = __float2bfloat16_rn(v);
  });
}

template <bool GLOBAL>
int launch(const Args& a, cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_gemv_kernel<GLOBAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, nctt::MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  fused_gemv_kernel<GLOBAL><<<a.p.blocks, THREADS, a.p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [K]; rms_w f32 [K] or null; w uint8 [N, K/2]; scales f32 [K/G, N];
// bias f32 [n_out] or null; residual bf16 [n_out] or null; y bf16 [n_out].
// n_out = N/2 with silu, else N. plan: the argument block of the wrapper's
// w4a8_gemv_workspace (the plan of w4a8_gemv_plan, in K4Word's order, and
// past the plan's limit on K the global scratch for the codes). Needs K %
// 128 == 0 and G % 128 == 0; a plan that does not fit is refused
// (cudaErrorInvalidValue), not run. One launch on `stream` (two past the
// limit on K).
NCTT_API int nctt_fused_gemv(const void* x, const void* rms_w, const void* w,
                             const void* scales, const void* bias,
                             const void* residual, void* y, const void* plan,
                             int K, int N, int G, int n_out, int silu,
                             float eps, void* stream) {
  if (!plan) return (int)cudaErrorInvalidValue;
  const K4Plan p = read_k4_plan(plan);
  if (!k4_plan_ok(p, K, N, G, n_out, silu)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Args a{(const __nv_bfloat16*)x, (const float*)rms_w,
               (const uint8_t*)w, (const float*)scales, (const float*)bias,
               (const __nv_bfloat16*)residual, (__nv_bfloat16*)y, p, K, N, G,
               n_out, silu, eps};
  if (!p.global) return launch<false>(a, s);
  fused_gemv_quant_kernel<<<1, CTHREADS, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch<true>(a, s);
}
