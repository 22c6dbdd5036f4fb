// K11 (csrc/paged_attention.cu) over fp8-e4m3 and int4 pools: the same
// kernels (paged_attention.cuh), instantiated here so that they compile
// beside the bf16 and int8 ones.
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_attn_impl_v2 / _paged_kernel_v2 (K11) over fp8 and int4 pools,
//   with csrc/paged_attention.cu.
#include "paged_attention.cuh"

int nctt_k11::dispatch_fp8_int4(int fmt, const Args& a, int B,
                                cudaStream_t s) {
  return fmt == FP8 ? dispatch<FP8>(a, B, s) : dispatch<INT4>(a, B, s);
}
