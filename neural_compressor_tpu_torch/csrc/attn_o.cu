// B = 1 decode attention fused into the W4A8 o-projection: from the query
// heads to the layer's x1 = residual + o(attention) in three or four
// stream-ordered launches.
//
// Replaces: neural_compressor_tpu/kernels/fused_matvec.py
//   _attn_o_impl / _make_attn_o_kernel (K18, ATTN_O_FUSED). On the TPU grid
//   step 0 attends every head in its prologue into VMEM scratch, then each
//   step is one N tile of the o-projection.
//
// Semantics: q [H, D] (rope applied) against bf16 caches [Hkv, T, D] that
//   already hold row pos (the port writes it before the call, as for K5);
//   pos int32 [1] on the device. Each head's attention is K5's up to its
//   float32 output o, which is NOT rounded to bf16: the TPU kernel
//   quantizes the float32 outputs of all heads with ONE scale, s =
//   f32(max |o| * f32(1/127)) (1 where it is 0), codes clip(round(o / s),
//   -128, 127) at lane offset (h*rep + r)*D; then the o-projection's grouped
//   int4 dot (G == D), times s, plus the residual, one bf16 store: y =
//   bf16(f32(acc * s) + residual).
//
// Bound on this card: bytes. The o weights and scales (K*N/2 + K/G*N*4
//   bytes) plus the visited K/V rows (2*Hkv*(pos+1)*D*2 bytes).
//
// Design: the attention is K5's split (csrc/decode_split.cuh, design in
//   csrc/decode_split.cu; decode_plan(1, H, Hkv, T, D, "bf16", k6=True)):
//   launch 1 scores and part maxima (and zeroes the amax word), a third
//   launch of l's part sums past 8 parts, then PV and the ordered fold,
//   whose store is float32: each row goes to the att scratch [H*D], and
//   each emitting block takes one atomicMax of its max |o| on the float
//   bits into the amax word (non-negative floats order as their bits). The
//   float32 rows are K5's sums rounded once to float32, the plain
//   version's bits. Then the o-projection stage, oproj_kernel, grid N /
//   cols blocks of 256 threads, `cols` output columns a block
//   (kernels/fused_matvec.py ATTN_O_COLS: 16, 256 blocks at llama2-7b's
//   N = 4096), an ordinary launch: each block issues cp.async copies of
//   its columns' int4 weights and scales into shared memory (8.4 MB in all
//   at llama2-7b's o-projection), every thread reads the one scale beside
//   its share of the rows, the block makes the codes of the H*D outputs in
//   shared memory while its copies land, and its warps take its columns:
//   K4's column dot (gemv_dot.cuh: __dp4a over unpacked int4, float64
//   across groups, rounded once) from shared memory, times s, plus the
//   residual. Where a block's columns do not fit beside the codes (H*D
//   past about 70,000), it keeps the codes alone and reads the weights,
//   scales and residual from global memory, as K4 does. No grid barrier, no cooperative launch: stream order and the
//   split's dependent launches carry every dependency. As a programmatic
//   dependent launch of PV (`dependent` 1, PV allows it first thing) the
//   stage's weight copies overlap the attention but contend with PV's
//   reads: tools/decode_attn_sweep.py --sweep measures that design, slower
//   at llama2-7b's unit. Scratch (scores, maxima, partials, att, amax) and
//   the argument block come from decode_attention.decode_workspace, cached
//   per plan and device.
#include "decode_split.cuh"
#include "gemv_dot.cuh"

using namespace nctt_dsplit;

namespace {

constexpr int NT = 256;

struct OArgs {
  const uint8_t* w;                // [N, K/2] "hopper_nk"
  const float* scales;             // [K/G, N]
  const __nv_bfloat16* residual;   // [N]
  __nv_bfloat16* y;                // [N]
  const float* att;                // [K] float32 attention outputs
  const unsigned* amax;            // max |att|, float bits
  int K, N, G, cols;
  int staged;                      // the columns' weights in shared memory
};

// dynamic shared memory of a block: its columns' weights [cols][K/2], their
// scales [K/G][cols], the codes [K] and the residual [cols]; the codes
// alone where those do not fit (the weights then read from global memory)
__host__ __device__ inline size_t oproj_smem(int K, int G, int cols) {
  return (size_t)cols * (K / 2) + sizeof(float) * (size_t)(K / G) * cols +
         (size_t)K + sizeof(float) * (size_t)cols;
}

__global__ void __launch_bounds__(NT) oproj_kernel(const OArgs o) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int K = o.K, cols = o.cols, ng = K / o.G, tid = threadIdx.x;
  const size_t wrow = (size_t)K / 2;
  uint8_t* sw = smem;                                        // [cols][K/2]
  float* ss = reinterpret_cast<float*>(sw + cols * wrow);    // [K/G][cols]
  int8_t* sx = o.staged ? reinterpret_cast<int8_t*>(ss + ng * cols)
                        : reinterpret_cast<int8_t*>(smem);   // [K]
  float* sres = reinterpret_cast<float*>(sx + K);            // [cols]
  const int n0 = blockIdx.x * cols;
  if (o.staged) {
    // the columns' weights and scales by asynchronous copies, landing
    // while the block makes the codes; the residual
    const uint8_t* wsrc = o.w + (size_t)n0 * wrow;
    const int wchunks = cols * (int)(wrow / 16);
    for (int c = tid; c < wchunks; c += NT)
      nctt::cp_async<16>(sw + (size_t)c * 16, wsrc + (size_t)c * 16);
    const int spg = cols / 4;                // 16-byte chunks a group
    for (int c = tid; c < ng * spg; c += NT) {
      const int g = c / spg, j = c - g * spg;
      nctt::cp_async<16>(ss + g * cols + 4 * j,
                         o.scales + (size_t)g * o.N + n0 + 4 * j);
    }
    nctt::cp_commit();
    for (int c = tid; c < cols; c += NT)
      sres[c] = __bfloat162float(o.residual[n0 + c]);
  }
  wait_prior_launch();     // PV's rows and amax (as a dependent launch)
  // every thread reads the one scale beside its rows (one round trip)
  const float sa = __uint_as_float(__ldcg(o.amax)) * (1.0f / 127.0f);
  const float s = sa <= 0.f ? 1.0f : sa;
  for (int i = tid; i < K / 4; i += NT) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(o.att) + i);
    char4 c;
    c.x = nctt::act_code(v.x, s);
    c.y = nctt::act_code(v.y, s);
    c.z = nctt::act_code(v.z, s);
    c.w = nctt::act_code(v.w, s);
    reinterpret_cast<char4*>(sx)[i] = c;
  }
  nctt::cp_wait(0);
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = warp; c < cols; c += NT / 32) {
    const int n = n0 + c;
    const float g =
        o.staged
            ? nctt::dot_column(sw + c * wrow, sx, ss, c, cols, K, o.G, lane)
            : nctt::dot_column(o.w + n * wrow, sx, o.scales, n, o.N, K, o.G,
                               lane);
    if (lane == 0) {
      const float r =
          o.staged ? sres[c] : __bfloat162float(o.residual[n]);
      o.y[n] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(g, s), r));
    }
  }
}

}  // namespace

// q bf16 [H, D]; caches bf16 [Hkv, T, D] holding row pos; pos int32 [1] on
// the device; w uint8 "hopper_nk" [N, H*D/2] with scales f32 [H*D/D, N]
// (groups of D); residual bf16 [N]; y bf16 [N]; `plan` K5's argument block
// (decode_attention.decode_workspace of decode_plan(1, H, Hkv, T, D,
// "bf16", k6=True)), whose att [H*D] and amax words K18 uses; `cols` output
// columns a block of the o-projection stage (4 to 128, dividing 128; H*D
// codes must fit a block's shared memory);
// `dependent` 1: that stage a programmatic dependent launch (a design the
// sweep measures), 0: an ordinary one. D is 128 or 256 (G == D); H % Hkv ==
// 0; N % 128 == 0. Three or four launches on `stream`.
NCTT_API int nctt_attn_o(const void* q, const void* k, const void* v,
                         const void* pos, const void* w, const void* scales,
                         const void* residual, void* y, const void* plan,
                         int H, int Hkv, int T, int D, int N, int cols,
                         int dependent, float scale, void* stream) {
  Args a;
  const long long* pl = (const long long*)plan;
  const int K = H * D;
  if (!fill(a, q, k, v, nullptr, nullptr, pos, nullptr, pl, H, Hkv, T, D,
            2, scale) ||
      (D != 128 && D != 256) || N < 128 || N % 128 || cols < 4 ||
      128 % cols || (!a.lsum && a.parts > LSUM_MAX))
    return (int)cudaErrorInvalidValue;
  const int staged = oproj_smem(K, D, cols) <= (size_t)nctt::MAX_DYN_SMEM;
  const size_t smem = staged ? oproj_smem(K, D, cols) : (size_t)K;
  if (smem > (size_t)nctt::MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  a.att = (float*)pl[W_ATT];
  a.amax = (unsigned*)pl[W_AMAX];
  static bool opted_in = false;   // dynamic shared memory past 48 KB, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        oproj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        nctt::MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int e = dispatch_k5(a, 1, s);
  if (e) return e;
  const OArgs o{(const uint8_t*)w, (const float*)scales,
                (const __nv_bfloat16*)residual, (__nv_bfloat16*)y, a.att,
                a.amax, K, N, D, cols, staged};
  if (dependent)
    return (int)dependent_launch(oproj_kernel, dim3(N / cols), NT, smem, s,
                                 o);
  oproj_kernel<<<N / cols, NT, smem, s>>>(o);
  return (int)cudaGetLastError();
}
