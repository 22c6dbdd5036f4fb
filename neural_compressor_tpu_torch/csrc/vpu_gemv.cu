// K9, vpu_gemv: the M == 1 W4A16 product in float32 without rounding the
// weight, factored per group as the TPU kernel computes it:
//   y_n = sum_g s_gn * (sum_k u_kn x_k - (2^(b-1) + z_gn) * sum_k x_k)
// over offset-binary "tpu_strided" int2/int4 fields u.
//   Replaces: neural_compressor_tpu/kernels/dequant_matmul.py
//   _vpu_matvec_impl (kernel body _make_vpu_kernel).
//   Bound on this card: bytes (each weight word is read once).
//   Design: the streaming core of csrc/vpu_gemv.cuh (K10's too): column
//   strips of 128, whole groups a warp, words by cp.async through a ring a
//   warp, x staged once per block in the fields' order, fields made float
//   by their exponent bits (no conversion), K split across blocks folded by
//   the strip's last block in split order; one launch a call.
#include "vpu_gemv.cuh"

// K9. x [K] bf16 (x_bf16) or f32; w uint32 [K/P, N] ("tpu_strided" int2 or
// int4, P = 32 / bits); scales (zeros, or null) f32 [K/G, N]; out [N] bf16
// (out_bf16) or f32; plan: the argument block of the wrapper's
// gemv_workspace (workspace addresses and gemv_plan's plan, PlanWord's
// order). Needs N % 4 == 0, K % G == 0, G % P == 0; a plan that does not
// fit is refused (cudaErrorInvalidValue), not run. One launch on `stream`.
NCTT_API int nctt_vpu_gemv(const void* x, const void* w, const void* scales,
                           const void* zeros, void* out, const void* plan,
                           int N, int K, int G, int bits, int x_bf16,
                           int out_bf16, void* stream) {
  using namespace nctt_gemv;
  if (!plan) return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  if (!plan_ok(p, N, K, G, bits, 1, false))
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(
      make_args(x, w, scales, zeros, out, p, N, K, G, out_bf16, false), bits,
      x_bf16, (cudaStream_t)stream);
}
