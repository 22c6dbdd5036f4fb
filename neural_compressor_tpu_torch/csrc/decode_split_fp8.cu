// K6 and K7 (csrc/decode_split.cu) over fp8-e4m3 caches: the same kernels
// (decode_split.cuh), instantiated here so that they compile beside the
// bf16 and int8 ones.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _batched_attn_impl / _kernel_batched (K7, quant branch) and
//   _decode_attn_quant_ro_impl / _kernel_q_ro (K6) over fp8 codes, with
//   csrc/decode_split.cu.
#include "decode_split.cuh"

int nctt_dsplit::dispatch_fp8(bool k6, const Args& a, int B,
                              cudaStream_t s) {
  return k6 ? dispatch<FP8, true>(a, B, s) : dispatch<FP8, false>(a, B, s);
}
