// One output column of a W4A8 GEMV on "hopper_nk" weights: K18's
// o-projection stage (attn_o.cu). K4 and K17 stream their columns through
// w4a8_gemv.cuh, with the same arithmetic.
#pragma once

#include "nctt_common.cuh"

namespace nctt {

// Sum over one column's K codes (a warp; valid in all lanes): each group's
// int32 dot of int8 activation codes `sx` (shared or global memory, 16-byte
// aligned) with the column's int4 codes, times its float32 scale
// scales[g, n], summed in float64 across groups and rounded once to
// float32. With `gmul`, group g's scale is first multiplied in float32 by
// gmul[g / gdiv] (K17's per-tile activation scale, as the TPU kernel folds
// it: dsc[r] * hsc). G % 128 == 0.
__device__ __forceinline__ float dot_column(const uint8_t* __restrict__ col,
                                            const int8_t* __restrict__ sx,
                                            const float* __restrict__ scales,
                                            int n, int N, int K, int G,
                                            int lane,
                                            const float* gmul = nullptr,
                                            int gdiv = 1) {
  const int nvec = K / 32;  // 16-byte vectors in the column
  const int vpg = G / 32;   // vectors per group (a multiple of 4)
  double acc = 0.0;
  for (int v0 = 0; v0 < nvec; v0 += 32) {
    const int v = v0 + lane;
    int part = 0;
    if (v < nvec) {
      const uint4 pk = *reinterpret_cast<const uint4*>(col + (size_t)v * 16);
      const int4 xa = *reinterpret_cast<const int4*>(sx + v * 32);
      const int4 xb = *reinterpret_cast<const int4*>(sx + v * 32 + 16);
      uint32_t lo, hi;
      unpack8(pk.x, lo, hi);
      part = __dp4a((int)lo, xa.x, part);
      part = __dp4a((int)hi, xa.y, part);
      unpack8(pk.y, lo, hi);
      part = __dp4a((int)lo, xa.z, part);
      part = __dp4a((int)hi, xa.w, part);
      unpack8(pk.z, lo, hi);
      part = __dp4a((int)lo, xb.x, part);
      part = __dp4a((int)hi, xb.y, part);
      unpack8(pk.w, lo, hi);
      part = __dp4a((int)lo, xb.z, part);
      part = __dp4a((int)hi, xb.w, part);
    }
    // lanes 4i..4i+3 hold 4 consecutive vectors = 128 codes of one group
    part += __shfl_xor_sync(FULL_MASK, part, 1);
    part += __shfl_xor_sync(FULL_MASK, part, 2);
    if ((lane & 3) == 0 && v < nvec) {
      const int g = v / vpg;
      float sc = scales[(size_t)g * N + n];
      if (gmul) sc = sc * gmul[g / gdiv];
      acc += (double)part * (double)sc;
    }
  }
  return (float)warp_sum(acc);
}

// int8 codes of x / s, round half to even, clipped to [-128, 127]
__device__ __forceinline__ int8_t act_code(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -128.f), 127.f);
}

}  // namespace nctt
