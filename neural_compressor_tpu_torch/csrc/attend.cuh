// The B = 1 decode attention body over bf16 rows, shared by K16's
// in-kernel write (decode_attention.cu) and K18 (attn_o.cu): one (batch, KV
// head, group of query rows) work item, run by a whole block. K5 itself
// runs K6's split (decode_split.cu) with the same function.
//
// Semantics (K5's, neural_compressor_tpu/kernels/decode_attention.py
//   _kernel_ro): float32 scores s = f32(q . k) * 1/sqrt(D) over the rows
//   t <= pos (the -1e30 mask makes the others contribute exactly 0; a
//   position at or past T attends all T rows); per query row l = sum
//   exp(f64(s) - m); p = bf16(f32(e / l)) (normalised BEFORE the bf16
//   cast); o = f32(sum p * v). Sums run in float64 over exact products and
//   are rounded once, so their order almost never shows.
// Row sources:
//   NEW = false: the cache already holds row pos (K18: the port writes it
//     before the launch);
//   NEW = true: row pos comes from k_new / v_new and the work item of
//     query group 0 stores it into the cache (K16's write,
//     _decode_attn_impl / _kernel): nothing reads the cache at pos, so the
//     store races with no read; at pos >= T nothing is stored.
// Output: bf16 rows (K16), or float32 rows plus the amax of |o| over
//   every row, by an atomicMax on the float bits (K18: non-negative floats
//   order as their bits do).
#pragma once

#include "nctt_common.cuh"

namespace nctt {

constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_MAX_REP = 8;

// dynamic shared memory of one work item: the cross-warp partials
// [WARPS][gs][D] doubles and the q rows [gs][D] floats
__host__ __device__ inline size_t attend_smem(int gs, int D) {
  return sizeof(double) * (size_t)ATT_WARPS * gs * D +
         sizeof(float) * (size_t)gs * D;
}

// the query groups of rep rows: ng groups of at most ATT_MAX_REP rows, as
// even as they go (rep 16: 2 x 8)
__host__ __device__ inline int attend_groups(int rep) {
  return (rep + ATT_MAX_REP - 1) / ATT_MAX_REP;
}

template <int DPL, bool FULL, bool NEW, bool F32OUT>
__device__ void attend_bf16(const __nv_bfloat16* __restrict__ q,
                            __nv_bfloat16* kc, __nv_bfloat16* vc,
                            const __nv_bfloat16* __restrict__ kn,
                            const __nv_bfloat16* __restrict__ vn,
                            void* out, float* __restrict__ ws,
                            unsigned* amax, int H, int Hkv, int T, int D_,
                            int pos, float scale, int b, int hk, int z,
                            int nz, double* smem) {
  const int D = FULL ? DPL * 32 : D_;
  const int rep = H / Hkv;
  const int L = min(max(pos, 0), T - 1) + 1;        // visited rows
  // this item's G query rows: group z of the rep rows
  const int gs = (rep + nz - 1) / nz;
  const int g0 = z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;                               // uniform in the block
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;  // first row
  double* sred = smem;                              // [WARPS][G][D]
  float* sq = reinterpret_cast<float*>(sred + ATT_WARPS * gs * D);  // [G][D]
  float* sp = ws + q0 * T;                          // [G][T]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * Hkv + hk;
  __nv_bfloat16* kh = kc + bh * (size_t)T * D;
  __nv_bfloat16* vh = vc + bh * (size_t)T * D;
  const __nv_bfloat16* knh = NEW ? kn + bh * D : nullptr;
  const __nv_bfloat16* vnh = NEW ? vn + bh * D : nullptr;
  const __nv_bfloat16* qh = q + q0 * D;

  if (NEW && z == 0 && pos >= 0 && pos < T) {
    for (int i = tid; i < D; i += ATT_THREADS) {
      kh[(size_t)pos * D + i] = knh[i];
      vh[(size_t)pos * D + i] = vnh[i];
    }
  }
  for (int i = tid; i < G * D; i += ATT_THREADS)
    sq[i] = __bfloat162float(qh[i]);
  __syncthreads();

  // pass 1: scores
  for (int t = warp; t < L; t += ATT_WARPS) {
    float kv[DPL];
    load_lane<DPL>(NEW && t == pos ? knh : kh + (size_t)t * D, lane, D, kv);
#pragma unroll
    for (int r = 0; r < ATT_MAX_REP; ++r) {
      if (r >= G) break;
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (FULL || lane * DPL + e < D)
          d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = warp_sum(d);
      if (lane == 0) sp[r * T + t] = (float)d * scale;
    }
  }
  __syncthreads();

  // softmax per query row; p is rounded to bf16 as K5 casts it for PV
  for (int r = warp; r < G; r += ATT_WARPS) {
    float* row = sp + r * T;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) l += exp((double)row[t] - (double)m);
    l = warp_sum(l);
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      row[t] = __bfloat162float(__float2bfloat16_rn((float)(e / l)));
    }
  }
  __syncthreads();

  // pass 2: PV, each warp over its rows, then a cross-warp sum
  double o[ATT_MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < ATT_MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int t = warp; t < L; t += ATT_WARPS) {
    float vv[DPL];
    load_lane<DPL>(NEW && t == pos ? vnh : vh + (size_t)t * D, lane, D, vv);
#pragma unroll
    for (int r = 0; r < ATT_MAX_REP; ++r) {
      if (r >= G) break;
      const double p = sp[r * T + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] += p * (double)vv[e];
    }
  }
#pragma unroll
  for (int r = 0; r < ATT_MAX_REP; ++r) {
    if (r >= G) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (FULL || lane * DPL + e < D)
        sred[(warp * G + r) * D + lane * DPL + e] = o[r][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += ATT_THREADS) {
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < ATT_WARPS; ++wi) acc += sred[wi * G * D + i];
    if constexpr (F32OUT) {
      const float v = (float)acc;
      reinterpret_cast<float*>(out)[q0 * D + i] = v;
      atomicMax(amax, __float_as_uint(fabsf(v)));
    } else {
      reinterpret_cast<__nv_bfloat16*>(out)[q0 * D + i] =
          __float2bfloat16_rn((float)acc);
    }
  }
  __syncthreads();  // sred and sq are free for the block's next item
}

}  // namespace nctt
