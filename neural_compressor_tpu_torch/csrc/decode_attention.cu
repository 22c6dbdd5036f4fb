// B = 1 single-token decode attention with the new row written inside the
// kernel (K16, set_cache_write_mode("kernel")): bf16 rows, or int8 codes it
// quantizes itself. K5, the read-only kernel over bf16 rows, and K6, the
// same over int8 / fp8 codes, are split across blocks in
// csrc/decode_split.cu.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _decode_attn_impl / _kernel and _decode_attn_quant_impl / _kernel_q
//   (K16's in-kernel write, set_cache_write_mode("kernel")).
//
// Semantics (bf16): K5's (csrc/decode_split.cu): q [B, H, D] against caches
//   [B, Hkv, T, D]; float32 scores times 1/sqrt(D); keys t > pos masked
//   out; softmax; probabilities cast to bf16 before the PV product;
//   float32 accumulation; rep = H/Hkv query heads per KV head; bf16
//   output; row pos taken from k_new / v_new and stored into the cache by
//   the kernel (attend.cuh). Per-slot positions are an int32 [B] tensor
//   read on the device; at pos >= T all T rows are attended and nothing is
//   stored, as the TPU kernel's mask leaves them.
// Semantics (int8): K6 (csrc/decode_split.cu: codes, s = f32(q . k) *
//   f32(k_scale * 1/sqrt(D)), p = bf16(f32(exp(s - m) / l) * v_scale)) with
//   the new row QUANTIZED in the kernel by the TPU kernel's own rule,
//   scale = f32(max(amax, 1e-6) * f32(1/127)) and codes clip(round(x /
//   scale), -127, 127) (not _kv_quant's: amax <= 0 -> 1, clip to -128), the
//   codes and scale stored at pos and the quantized row (codes times the
//   new scale) attended there. The TPU kernel rewrote the whole aliased
//   [T, D] block; here only the row is written. Nothing reads the cache at
//   pos, so the store races with no read; at pos >= T nothing is stored.
//
// Bound on this card: bytes. Each visited cache row is read once for
//   2*rep*D flops: 2*Hkv*(pos+1)*D*2 bytes of K and V per layer for bf16,
//   2*Hkv*min(pos+1, T)*(D+4) for int8 codes and scales.
//
// Design: one block per (batch, KV head, group of query rows): the rep
//   query rows of a KV head split into ng = ceil(rep / 8) groups of at most
//   MAX_REP = 8 rows, as even as they go, along grid z (rep 16: 2 x 8), so
//   the o[8][DPL] accumulators a thread holds do not grow with rep; a
//   group's rows share every K and V row it reads (rep <= 8: one group).
//   The block visits only rows t <= pos (the -1e30 mask makes the others
//   contribute exactly 0). Warps take rows round-robin and
//   lanes split D, so each warp reads a whole row coalesced: a lane holds
//   DPL = ceil(D / 32) elements (DPL 1-8, any D up to 256), the tail past
//   D masked and loaded by scalars (the widths 32, 64, 128 and 256 have a
//   copy with D a compile-time constant, nctt::full_width). Sums run in
//   float64 over exact products and are rounded once, so their order
//   almost never shows: the kernel and its plain version
//   (kernels/decode_attention.py) agree bit for bit, and the bf16 write
//   equals K5 plus the outside write. In order: scores into a float32
//   workspace in device memory ([B, H, T], allocated by the wrapper); per
//   query row l = sum exp(f64(s) - m); p = bf16(f32(e / l) [* v_scale]);
//   o = bf16(f32(sum p*v)) with a cross-warp sum in shared memory. A
//   simple kernel: only Hkv*B*ng blocks, no split of T across blocks.
#include "attend.cuh"

namespace {

constexpr int THREADS = nctt::ATT_THREADS;
constexpr int WARPS = nctt::ATT_WARPS;
constexpr int MAX_REP = nctt::ATT_MAX_REP;

// K16's bf16 write: K5's function with row pos from k_new / v_new, stored
// by the kernel; one block a work item
template <int DPL, bool FULL>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        __nv_bfloat16* kc, __nv_bfloat16* vc,
                        const __nv_bfloat16* __restrict__ kn,
                        const __nv_bfloat16* __restrict__ vn,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int H, int Hkv, int T,
                        int D, const int* __restrict__ pos_b, float scale) {
  extern __shared__ __align__(16) double smem[];
  nctt::attend_bf16<DPL, FULL, true, false>(
      q, kc, vc, kn, vn, out, ws, nullptr, H, Hkv, T, D, pos_b[blockIdx.y],
      scale, blockIdx.y, blockIdx.x, blockIdx.z, gridDim.z, smem);
}

template <int DPL, bool FULL>
int launch(const void* q, void* k, void* v, const void* kn, const void* vn,
           void* out, void* ws, int B, int H, int Hkv, int T, int D,
           const int* pos, float scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  const int ng = nctt::attend_groups(rep);
  const int gs = (rep + ng - 1) / ng;
  const size_t smem = nctt::attend_smem(gs, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<DPL, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_kernel<DPL, FULL><<<dim3(Hkv, B, ng), THREADS, smem,
                                      stream>>>(
      (const __nv_bfloat16*)q, (__nv_bfloat16*)k, (__nv_bfloat16*)v,
      (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn,
      (__nv_bfloat16*)out, (float*)ws, H, Hkv, T, D, pos, scale);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, void* k, void* v, const void* kn,
                  const void* vn, void* out, void* ws, int B, int H, int Hkv,
                  int T, int D, const int* pos, float scale,
                  cudaStream_t s) {
#define NCTT_K16W(DPL_)                                                     \
  case DPL_:                                                              \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                       \
               ? launch<DPL_, nctt::full_width(DPL_)>(                    \
                     q, k, v, kn, vn, out, ws, B, H, Hkv, T, D, pos,     \
                     scale, s)                                            \
               : launch<DPL_, false>(q, k, v, kn, vn, out, ws, B, H, Hkv, \
                                     T, D, pos, scale, s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K16W(1) NCTT_K16W(2) NCTT_K16W(3) NCTT_K16W(4)
    NCTT_K16W(5) NCTT_K16W(6) NCTT_K16W(7) NCTT_K16W(8)
#undef NCTT_K16W
    default: return (int)cudaErrorInvalidValue;
  }
}

// K16's int8 write: K6's walk over int8 codes with the new row quantized in
// the kernel, attended as codes times its new scale, and stored at pos by
// the block of query group 0.
template <int DPL, bool FULL>
__global__ void __launch_bounds__(THREADS)
decode_attention_quant_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ kn,
                              const __nv_bfloat16* __restrict__ vn,
                              int8_t* kc, float* ks, int8_t* vc,
                              float* vs,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ ws, int H, int Hkv, int T,
                              int D_, const int* __restrict__ pos_b,
                              float scale) {
  const int D = FULL ? DPL * 32 : D_;
  extern __shared__ __align__(16) double smem[];
  const int rep = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  // pos at or past T: every code row, no new row (JAX's mask keeps all T)
  const int pos = pos_b[b];
  const int L = min(max(pos, 0), T - 1) + 1;          // visited rows
  // this block's G query rows: group blockIdx.z of the rep rows
  const int gs = (rep + gridDim.z - 1) / gridDim.z;
  const int g0 = blockIdx.z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;  // first row
  double* sred = smem;                                // [WARPS][G][D]
  float* sq = reinterpret_cast<float*>(sred + WARPS * gs * D);  // [G][D]
  float* snew = sq + gs * D;       // [2][D] the new row's codes, k, v
  float* sscl = snew + 2 * D;      // [2] its scales; [2][WARPS] amax
  float* sp = ws + q0 * T;                            // [G][T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * Hkv + hk;
  int8_t* kh = kc + bh * (size_t)T * D;
  int8_t* vh = vc + bh * (size_t)T * D;
  float* ksh = ks + bh * (size_t)T;
  float* vsh = vs + bh * (size_t)T;
  const __nv_bfloat16* knh = kn + bh * D;
  const __nv_bfloat16* vnh = vn + bh * D;
  const __nv_bfloat16* qh = q + q0 * D;

  for (int i = tid; i < G * D; i += THREADS) sq[i] = __bfloat162float(qh[i]);
  // the new row's scales and codes by the TPU kernel's rule: scale =
  // max(amax, 1e-6) / 127, codes clip(round(x / scale), -127, 127)
  float ak = 0.f, av = 0.f;
  for (int i = tid; i < D; i += THREADS) {
    ak = fmaxf(ak, fabsf(__bfloat162float(knh[i])));
    av = fmaxf(av, fabsf(__bfloat162float(vnh[i])));
  }
  ak = nctt::warp_max(ak);
  av = nctt::warp_max(av);
  if (lane == 0) {
    sscl[2 + warp] = ak;
    sscl[2 + WARPS + warp] = av;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) {
      ak = fmaxf(ak, sscl[2 + w]);
      av = fmaxf(av, sscl[2 + WARPS + w]);
    }
    sscl[0] = fmaxf(ak, 1e-6f) * (1.0f / 127.0f);
    sscl[1] = fmaxf(av, 1e-6f) * (1.0f / 127.0f);
  }
  __syncthreads();
  const float nks = sscl[0], nvs = sscl[1];
  for (int i = tid; i < D; i += THREADS) {
    snew[i] = fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(knh[i]), nks)),
                          -127.f), 127.f);
    snew[D + i] =
        fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(vnh[i]), nvs)),
                    -127.f), 127.f);
  }
  __syncthreads();
  if (blockIdx.z == 0 && pos >= 0 && pos < T) {
    for (int i = tid; i < D; i += THREADS) {
      kh[(size_t)pos * D + i] = (int8_t)(int)snew[i];
      vh[(size_t)pos * D + i] = (int8_t)(int)snew[D + i];
    }
    if (tid == 0) {
      ksh[pos] = nks;
      vsh[pos] = nvs;
    }
  }
  __syncthreads();

  // a lane's DPL elements of the new row's codes at pos
  auto new_row = [&](const float* codes, float (&out_)[DPL]) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int i = lane * DPL + e;
      out_[e] = i < D ? codes[i] : 0.0f;
    }
  };

  // pass 1: scores, s = f32(q . k) * f32(k_scale * scale)
  for (int t = warp; t < L; t += WARPS) {
    float kv[DPL];
    if (t == pos)
      new_row(snew, kv);
    else
      nctt::load_lane<DPL>(kh + (size_t)t * D, lane, D, kv);
    const float ksc = (t == pos ? nks : ksh[t]) * scale;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      double d = 0.0;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (FULL || lane * DPL + e < D)
          d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
      d = nctt::warp_sum(d);
      if (lane == 0) sp[r * T + t] = (float)d * ksc;
    }
  }
  __syncthreads();

  // softmax per query row; p = bf16(f32(e / l) * v_scale)
  for (int r = warp; r < G; r += WARPS) {
    float* row = sp + r * T;
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, row[t]);
    m = nctt::warp_max(m);
    double l = 0.0;
    for (int t = lane; t < L; t += 32) l += exp((double)row[t] - (double)m);
    l = nctt::warp_sum(l);
    for (int t = lane; t < L; t += 32) {
      const double e = exp((double)row[t] - (double)m);
      const float vsc = t == pos ? nvs : vsh[t];
      row[t] = __bfloat162float(__float2bfloat16_rn((float)(e / l) * vsc));
    }
  }
  __syncthreads();

  // pass 2: PV, each warp over its rows, then a cross-warp sum
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int t = warp; t < L; t += WARPS) {
    float vv[DPL];
    if (t == pos)
      new_row(snew + D, vv);
    else
      nctt::load_lane<DPL>(vh + (size_t)t * D, lane, D, vv);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= G) break;
      const double p = sp[r * T + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] += p * (double)vv[e];
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= G) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (FULL || lane * DPL + e < D)
        sred[(warp * G + r) * D + lane * DPL + e] = o[r][e];
  }
  __syncthreads();
  __nv_bfloat16* oh = out + q0 * D;
  for (int i = tid; i < G * D; i += THREADS) {
    double acc = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) acc += sred[wi * G * D + i];
    oh[i] = __float2bfloat16_rn((float)acc);
  }
}

template <int DPL, bool FULL>
int launch_quant(const void* q, const void* kn, const void* vn, void* kc,
                 void* ks, void* vc, void* vs, void* out, void* ws, int B,
                 int H, int Hkv, int T, int D, const int* pos, float scale,
                 cudaStream_t stream) {
  const int rep = H / Hkv;
  const int ng = nctt::attend_groups(rep);            // groups of rows
  const int gs = (rep + ng - 1) / ng;
  const size_t smem = nctt::attend_smem(gs, D) +
      sizeof(float) * (2 * (size_t)D + 2 + 2 * WARPS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_quant_kernel<DPL, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_quant_kernel<DPL, FULL>
      <<<dim3(Hkv, B, ng), THREADS, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,
          (const __nv_bfloat16*)vn, (int8_t*)kc, (float*)ks, (int8_t*)vc,
          (float*)vs,
          (__nv_bfloat16*)out, (float*)ws, H, Hkv, T, D, pos, scale);
  return (int)cudaGetLastError();
}

int dispatch_quant(const void* q, const void* kn, const void* vn, void* kc,
                   void* ks, void* vc, void* vs, void* out, void* ws, int B,
                   int H, int Hkv, int T, int D, const int* pos, float scale,
                   cudaStream_t s) {
#define NCTT_K16(DPL_)                                                   \
  case DPL_:                                                             \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                      \
               ? launch_quant<DPL_, nctt::full_width(DPL_)>(              \
                     q, kn, vn, kc, ks, vc, vs, out, ws, B, H, Hkv, T, D, \
                     pos, scale, s)                                      \
               : launch_quant<DPL_, false>(q, kn, vn, kc, ks, vc, vs, out, \
                                           ws, B, H, Hkv, T, D, pos, scale, \
                                           s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K16(1) NCTT_K16(2) NCTT_K16(3) NCTT_K16(4)
    NCTT_K16(5) NCTT_K16(6) NCTT_K16(7) NCTT_K16(8)
#undef NCTT_K16
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K16's in-kernel write: q bf16 [B, H, D]; k_new/v_new bf16 [B, Hkv, D];
// fmt 0: caches bf16 [B, Hkv, T, D] (scales null); fmt 1: int8 codes
// [B, Hkv, T, D] with scales f32 [B, Hkv, T]. The kernel stores each
// slot's new row at pos[b] < T (int8: quantized by the TPU kernel's rule)
// and attends it from its inputs; pos int32 [B] on the device; out bf16
// [B, H, D]; ws f32 [B, H, T]. 1 <= D <= 256; H % Hkv == 0.
NCTT_API int nctt_decode_attention_write(const void* q, const void* kn,
                                         const void* vn, void* kc, void* ks,
                                         void* vc, void* vs, void* out,
                                         void* ws, int B, int H, int Hkv,
                                         int T, int D, const void* pos_b,
                                         int fmt, float scale,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* pos = (const int*)pos_b;
  if (fmt == 0)
    return dispatch_bf16(q, kc, vc, kn, vn, out, ws, B, H, Hkv, T, D, pos,
                         scale, s);
  if (fmt == 1)
    return dispatch_quant(q, kn, vn, kc, ks, vc, vs, out, ws, B, H, Hkv, T,
                          D, pos, scale, s);
  return (int)cudaErrorInvalidValue;
}
