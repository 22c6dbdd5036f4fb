// K10, vpu_int8act: the all-integer M == 1 product of a W4A8 decode step
// over "tpu_strided" int4/int2 words (sym, or asym with zero points):
//
//   xs = max(max|x|, 1e-6) * f32(1/127);  xq = clip(rint(x / xs), +-127)
//   per group g:   a = sum_k u[k, n] * xq[k],   b = sum_k xq[k]   (int32)
//                  af = f32(a) - (2^(bits-1) + z[g, n]) * f32(b)
//   per K tile t:  part = 0; part = fma(s[g, n], af, part) over the tile's
//                  groups in order;  acc = fma(part, xs, acc)
//
// Replaces: neural_compressor_tpu/kernels/dequant_matmul.py
//   _vpu_matvec_int_impl (kernel body _make_vpu_int_kernel): the same
//   arithmetic in the same order (x quantized per tensor as the jitted
//   program does it, the integer sums over offset-binary fields u, the
//   float work per group and per tile), with the two multiply-adds fused
//   as XLA's CPU program of the reference fuses them, so the card gives
//   its plain version's bits and those of the JAX function on the CPU.
//   Every float operation is an explicit intrinsic (__fmaf_rn where the
//   reference fuses, __fmul_rn / __fsub_rn where it does not), so the
//   compiler contracts nothing else.
//
// Bound on this card: bytes (each weight word is read once; the operations,
//   2*K*N integer multiply-adds, are far under the int rate).
//
// Design: the streaming core of csrc/vpu_gemv.cuh (K9's too): column
//   strips of 128, whole tiles of tk a block (the tile tk is numerics:
//   the float tail folds tile by tile), words by cp.async through a ring a
//   warp, x quantized once per block into codes in the fields' order, each
//   group's sum of codes by a warp reduction, __dp4a over four fields at
//   once; K split across blocks: each block writes its tiles' parts, the
//   strip's last block folds every tile in order; one launch a call.
#include "vpu_gemv.cuh"

// K10. x [K] bf16 (x_bf16) or f32; w 32-bit [K/P, N] ("tpu_strided", bits
// 4 or 2, P = 32 / bits); scales (zeros, or null) f32 [K/G, N]; out [N]
// bf16 (out_bf16) or f32; plan: the argument block of the wrapper's
// gemv_workspace (workspace addresses and gemv_plan's plan for tk, in
// PlanWord's order). Needs G % P == 0, tk % G == 0, K % tk == 0, N % 4 ==
// 0; a plan that does not fit is refused (cudaErrorInvalidValue), not run.
// One launch on `stream`.
NCTT_API int nctt_vpu_int8act(const void* x, const void* w, const void* scales,
                              const void* zeros, void* out, const void* plan,
                              int N, int K, int G, int bits, int tk,
                              int x_bf16, int out_bf16, void* stream) {
  using namespace nctt_gemv;
  if (!plan || G < 1 || tk < G || tk % G || K % tk)
    return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  if (!plan_ok(p, N, K, G, bits, tk / G, true))
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(
      make_args(x, w, scales, zeros, out, p, N, K, G, out_bf16, true), bits,
      x_bf16, (cudaStream_t)stream);
}
