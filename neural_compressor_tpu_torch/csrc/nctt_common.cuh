// Shared helpers of the port's CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NCTT_API extern "C" __attribute__((visibility("default")))

namespace nctt {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// Eight signed int4 codes of one 32-bit "hopper_nk" word (byte j holds code
// 2j in its low nibble and code 2j+1 in its high nibble, two's complement)
// -> eight int8 codes in k order: k0..k3 in `lo4`, k4..k7 in `hi4`.
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& lo4,
                                        uint32_t& hi4) {
  uint32_t ev = w & 0x0F0F0F0Fu;          // k = 0, 2, 4, 6
  uint32_t od = (w >> 4) & 0x0F0F0F0Fu;   // k = 1, 3, 5, 7
  // sign-extend each nibble to its byte: (v ^ 8) - 8, per byte, no borrow
  ev = __vsub4(ev ^ 0x08080808u, 0x08080808u);
  od = __vsub4(od ^ 0x08080808u, 0x08080808u);
  lo4 = __byte_perm(ev, od, 0x5140);
  hi4 = __byte_perm(ev, od, 0x7362);
}

}  // namespace nctt
