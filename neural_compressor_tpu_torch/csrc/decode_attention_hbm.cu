// B = 1 decode attention over bf16 caches that the kernel copies into shared
// memory itself, in bulk (K16's "hbm" cache space).
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _decode_attn_ro_hbm_impl / _kernel_ro_hbm (K16, set_ro_cache_space("hbm")).
//   On the TPU the caches stay in HBM and the kernel DMAs each [Hkv, T, D]
//   cache into VMEM itself (make_async_copy and two semaphores), instead of
//   letting XLA stage per-(b, h) blocks.
//
// Semantics: K5's (csrc/decode_split.cu): q [B, H, D] against
//   bf16 caches [B, Hkv, T, D] that already hold row pos[b] (the port
//   writes it before the launch, as for K5); pos int32 [B] on the device;
//   rows t <= pos (all T at pos >= T); scores f32(q . k) / sqrt(D);
//   p = bf16(f32(e / l)); bf16 output.
//
// Bound on this card: bytes, as K5: 2*Hkv*(pos+1)*D*2 bytes of K and V.
//
// Design: one block per (KV head, slot, group of at most 8 query rows), grid
//   (Hkv, B, groups), the one-block-a-head walk K5 ran before its split,
//   with the rows coming through shared memory: thread 0 of each block
//   issues cp.async.bulk global->shared copies of the slot's K rows (then
//   its V rows) in tiles of R rows, completion on an mbarrier per stage,
//   two tiles in flight (the raw-bytes bulk copy: no tensor map, the
//   hardware moves the bytes and counts them on the barrier); the block
//   attends the tile that has landed while the next one is on its way. R is
//   a multiple of the 8 warps, so warp w attends the rows t = w (mod 8) in
//   increasing order: float64 sums over exact products, rounded once, so
//   the output equals the plain version's and K5's bit for bit. Rows are
//   16-byte multiples (D % 8 == 0), as the bulk copy needs. A simple first
//   kernel: the score rows live in a float32 workspace in device memory, no
//   split of T across blocks.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;

// dynamic shared memory of a block past its tile ring: the cross-warp
// partials [WARPS][gs][D] doubles and the q rows [gs][D] floats
inline size_t attend_smem(int gs, int D) {
  return sizeof(double) * (size_t)WARPS * gs * D +
         sizeof(float) * (size_t)gs * D;
}

// rows a tile: about 8 KiB of bf16, a multiple of WARPS
__host__ __device__ inline int tile_rows(int D) {
  const int r = (4096 / D) / WARPS * WARPS;
  return r < WARPS ? WARPS : r;
}

using nctt::bulk_load;
using nctt::mbar_init;
using nctt::mbar_wait;

template <int DPL, bool FULL>
__global__ void __launch_bounds__(THREADS)
decode_attention_hbm_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ kc,
                            const __nv_bfloat16* __restrict__ vc,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ ws, int H, int Hkv, int T,
                            int D_, const int* __restrict__ pos_b,
                            float scale) {
  const int D = FULL ? DPL * 32 : D_;
  extern __shared__ __align__(128) double smem[];
  __shared__ __align__(8) uint64_t bar[2];
  const int rep = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int pos = pos_b[b];
  const int L = min(max(pos, 0), T - 1) + 1;          // visited rows
  const int gs = (rep + gridDim.z - 1) / gridDim.z;
  const int g0 = blockIdx.z * gs, G = min(gs, rep - g0);
  if (G <= 0) return;
  const int R = tile_rows(D);
  const int nt = (L + R - 1) / R;                     // tiles a pass
  const size_t q0 = (size_t)b * H + (size_t)hk * rep + g0;
  // [2][R][D] bf16 tile ring, then [WARPS][G][D] doubles, then [G][D] q
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  double* sred = smem + (2 * (size_t)R * D * 2 + 7) / 8;
  float* sq = reinterpret_cast<float*>(sred + WARPS * gs * D);
  float* sp = ws + q0 * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * Hkv + hk;
  const __nv_bfloat16* kh = kc + bh * (size_t)T * D;
  const __nv_bfloat16* vh = vc + bh * (size_t)T * D;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    nctt::mbar_fence_init();
  }
  // tile k of the two passes (k < nt: K rows, else V rows) into stage k & 1
  auto issue = [&](int k) {
    const int i = k < nt ? k : k - nt;
    const int rows = min(R, L - i * R);
    const __nv_bfloat16* src = (k < nt ? kh : vh) + (size_t)i * R * D;
    bulk_load(ring + (size_t)(k & 1) * R * D, src,
              (uint32_t)rows * D * sizeof(__nv_bfloat16), &bar[k & 1]);
  };
  __syncthreads();
  if (tid == 0) {  // two tiles in flight (with one K tile, V's first)
    issue(0);
    issue(1);
  }
  for (int i = tid; i < G * D; i += THREADS)
    sq[i] = __bfloat162float(q[q0 * D + i]);
  __syncthreads();

  // pass 1: scores, tile by tile as the K rows land
  for (int i = 0; i < nt; ++i) {
    mbar_wait(&bar[i & 1], (i >> 1) & 1);
    const __nv_bfloat16* tile = ring + (size_t)(i & 1) * R * D;
    const int rows = min(R, L - i * R);
    for (int tt = warp; tt < rows; tt += WARPS) {
      const int t = i * R + tt;
      float kv[DPL];
      nctt::load_lane<DPL>(tile + (size_t)tt * D, lane, D, kv);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
        double d = 0.0;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          if (FULL || lane * DPL + e < D)
            d += (double)sq[r * D + lane * DPL + e] * (double)kv[e];
        d = nctt::warp_sum(d);
        if (lane == 0) sp[r * T + t] = (float)d * scale;
      }
    }
    __syncthreads();                      // stage i & 1 is free again
    if (tid == 0 && i + 2 < 2 * nt) issue(i + 2);
  }

  // softmax per query row (while the first V tiles land)
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
      row[t] = __bfloat162float(__float2bfloat16_rn((float)(e / l)));
    }
  }
  __syncthreads();

  // pass 2: PV, tile by tile as the V rows land
  double o[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.0;
  for (int i = 0; i < nt; ++i) {
    const int k = nt + i;
    mbar_wait(&bar[k & 1], (k >> 1) & 1);
    const __nv_bfloat16* tile = ring + (size_t)(k & 1) * R * D;
    const int rows = min(R, L - i * R);
    for (int tt = warp; tt < rows; tt += WARPS) {
      const int t = i * R + tt;
      float vv[DPL];
      nctt::load_lane<DPL>(tile + (size_t)tt * D, lane, D, vv);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= G) break;
        const double p = sp[r * T + t];
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[r][e] += p * (double)vv[e];
      }
    }
    __syncthreads();
    if (tid == 0 && k + 2 < 2 * nt) issue(k + 2);
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
int launch(const void* q, const void* k, const void* v, void* out, void* ws,
           int B, int H, int Hkv, int T, int D, const int* pos, float scale,
           cudaStream_t stream) {
  const int rep = H / Hkv;
  const int ng = (rep + MAX_REP - 1) / MAX_REP;     // groups of rows
  const int gs = (rep + ng - 1) / ng;
  const size_t ring = (2 * (size_t)tile_rows(D) * D * 2 + 7) / 8 * 8;
  const size_t smem = ring + attend_smem(gs, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_hbm_kernel<DPL, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_hbm_kernel<DPL, FULL><<<dim3(Hkv, B, ng), THREADS, smem,
                                           stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)ws, H, Hkv, T, D,
      pos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B, H, D]; caches bf16 [B, Hkv, T, D] holding row pos[b], 16-byte
// aligned; pos int32 [B] on the device (pos >= T: all T rows); out bf16
// [B, H, D]; ws f32 [B, H, T] scratch for the score rows. D % 8 == 0 and
// 8 <= D <= 256; H % Hkv == 0.
NCTT_API int nctt_decode_attention_hbm(const void* q, const void* k,
                                       const void* v, void* out, void* ws,
                                       int B, int H, int Hkv, int T, int D,
                                       const void* pos_b, float scale,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* pos = (const int*)pos_b;
  if (D % 8) return (int)cudaErrorInvalidValue;
#define NCTT_K16H(DPL_)                                                    \
  case DPL_:                                                               \
    return D == 32 * DPL_ && nctt::full_width(DPL_)                        \
               ? launch<DPL_, nctt::full_width(DPL_)>(q, k, v, out, ws, B, \
                                                      H, Hkv, T, D, pos,   \
                                                      scale, s)            \
               : launch<DPL_, false>(q, k, v, out, ws, B, H, Hkv, T, D,   \
                                     pos, scale, s);
  switch (D >= 1 ? (D + 31) / 32 : 0) {
    NCTT_K16H(1) NCTT_K16H(2) NCTT_K16H(3) NCTT_K16H(4)
    NCTT_K16H(5) NCTT_K16H(6) NCTT_K16H(7) NCTT_K16H(8)
#undef NCTT_K16H
    default: return (int)cudaErrorInvalidValue;
  }
}
