// K6 and K7 (csrc/decode_split.cu) over int8 caches: the same kernels
// (decode_split.cuh), instantiated here so that they compile beside the
// bf16 and fp8 ones.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _batched_attn_impl / _kernel_batched (K7, quant branch) and
//   _decode_attn_quant_ro_impl / _kernel_q_ro (K6) over int8 codes, with
//   csrc/decode_split.cu.
#include "decode_split.cuh"

int nctt_dsplit::dispatch_int8(bool k6, const Args& a, int B,
                               cudaStream_t s) {
  return k6 ? dispatch<INT8, true>(a, B, s) : dispatch<INT8, false>(a, B, s);
}
