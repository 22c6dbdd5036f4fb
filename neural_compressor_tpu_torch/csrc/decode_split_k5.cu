// K5 (csrc/decode_split.cu, nctt_decode_attention): K6's kernels
// (decode_split.cuh) over a bf16 cache that already holds the new row, no
// raw row and scales of 1, instantiated here so that they compile beside
// K7's bf16 copies and the quantized formats.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _decode_attn_ro_impl / _kernel_ro (K5), with csrc/decode_split.cu.
#include "decode_split.cuh"

int nctt_dsplit::dispatch_k5(const Args& a, int B, cudaStream_t s) {
  return dispatch<BF16, true>(a, B, s);
}
