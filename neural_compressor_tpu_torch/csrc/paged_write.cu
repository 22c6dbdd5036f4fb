// In-place write of each slot's new K/V row into its page of a paged pool:
// bf16 rows, int8 or fp8-e4m3 codes with a per-(token, head) float32 scale,
// or one int4 nibble of a token-half-split byte row with a per-(token, head)
// affine scale and offset.
//
// Replaces: neural_compressor_tpu/kernels/paged_attention.py
//   _paged_write_impl with _write_kernel_bf16, _write_kernel_quant (int8
//   and fp8) and _write_kernel_int4 (K12); and _paged_write_window_impl
//   with _write_kernel_bf16_w, _write_kernel_quant_w and
//   _write_kernel_int4_w (K13: a speculative verify window of W rows a
//   slot, which may cross one page boundary; second entry, below).
//
// Semantics (as K12): k_new/v_new bf16 [B, Hkv, D] go to row r = pos[b] %
//   page of pool page block_tables[b, pos[b] / page], for every KV head.
//   int8: scale = amax * f32(1/127), 1 where amax <= 0 (XLA compiles
//   `amax / 127` as that product); code = clip(rint(x / scale), -128, 127)
//   with a true float32 division and half-to-even rounding. fp8: scale =
//   amax * f32(1/448) (models.llama._kv_quant's form, which JAX's CPU path
//   and the engine's staging copy use; JAX's TPU kernel forms
//   (amax / 127) * (127 / 448), an ulp apart in most rows); code =
//   e4m3(clip(x / scale, -448, 448)), round to nearest even. int4: mn, mx
//   of the row, scale = (mx - mn) * f32(1/15) (1 where mx - mn <= 0),
//   code = clip(rint((x - mn) / scale), 0, 15), off = mn + 8 * scale; the
//   code goes to the low nibble of byte row r (r < page/2) or the high
//   nibble of byte row r - page/2, the partner token's nibble kept. Scales
//   (and offsets) go to [pid, h, r]. A row whose page index is past the
//   block table (an idle or finished slot running on inside a multi-step
//   dispatch) is not written, as JAX's scatter drops it.
//
// Bound on this card: bytes, 2*Hkv*D*2 bytes read and 2*Hkv*D code bytes
//   (x2 for bf16; int4 reads and writes D bytes a head) plus 2*Hkv*4 scale
//   (x2 with int4 offsets) bytes written per slot. The TPU kernel stages
//   and rewrites the slot's whole [Hkv, page, D] page block (aliased
//   output); here each block writes one row of one head and touches
//   nothing else.
//
// Design: one block per (slot, KV head), 128 threads over D; amax, min and
//   max are block reductions (order-free, exact), and every float32
//   operation is written out unfused, so the codes, scales and offsets
//   equal the plain version's (kernels/paged_attention.py) and JAX's bit
//   for bit. Several idle slots write the shared trash page 0 in one
//   launch, at the same row: that race is harmless only because page 0 is
//   never attended (the engine masks it by per-slot length and never maps
//   it to a live token). Two live slots never share a page, so no two
//   blocks merge nibbles into one byte. K13 is the same block looping over
//   its slot's W window rows in order (each row quantized as K12 quantizes
//   it); the TPU kernel stages and rewrites two whole page blocks a slot.
//   Bound: bytes, W times K12's per slot.
#include "nctt_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// pool formats, as kernels/paged_attention.py numbers them
constexpr int BF16 = 0, INT8 = 1, FP8 = 2, INT4 = 3;

// block-wide max of v (every thread gets it); sred holds WARPS floats
__device__ __forceinline__ float block_max(float v, float* sred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = nctt::warp_max(v);
  if (lane == 0) sred[warp] = v;
  __syncthreads();
  float m = sred[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, sred[w]);
  __syncthreads();  // sred is reused by the next reduction
  return m;
}

template <int FMT>
__device__ __forceinline__ void write_row(const __nv_bfloat16* __restrict__ src,
                                          void* pages, float* scales,
                                          float* offs, int pid, int hk,
                                          int Hkv, int page, int r, int D,
                                          float* sred) {
  const int tid = threadIdx.x;
  const size_t srow = ((size_t)pid * Hkv + hk) * page + r;
  if constexpr (FMT == BF16) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(pages) + srow * D;
    for (int d = tid; d < D; d += THREADS) dst[d] = src[d];
  } else if constexpr (FMT == INT4) {
    float lo = INFINITY, hi = -INFINITY;
    for (int d = tid; d < D; d += THREADS) {
      const float x = __bfloat162float(src[d]);
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
    const float mn = -block_max(-lo, sred);
    const float mx = block_max(hi, sred);
    const float span = __fsub_rn(mx, mn);
    const float scale =
        span <= 0.0f ? 1.0f : __fmul_rn(span, (float)(1.0 / 15.0));
    const int half = page >> 1;
    const bool high = r >= half;
    uint8_t* dst = reinterpret_cast<uint8_t*>(pages) +
        (((size_t)pid * Hkv + hk) * half + r % half) * D;
    for (int d = tid; d < D; d += THREADS) {
      const float x = __bfloat162float(src[d]);
      const float c = fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(x, mn), scale)),
                                  0.0f), 15.0f);
      const uint8_t u = (uint8_t)c;
      const uint8_t old = dst[d];
      dst[d] = high ? (uint8_t)((old & 0x0F) | (u << 4))
                    : (uint8_t)((old & 0xF0) | u);
    }
    if (tid == 0) {
      scales[srow] = scale;
      offs[srow] = __fadd_rn(mn, __fmul_rn(8.0f, scale));
    }
  } else {
    float m = 0.0f;
    for (int d = tid; d < D; d += THREADS)
      m = fmaxf(m, fabsf(__bfloat162float(src[d])));
    const float amax = block_max(m, sred);
    constexpr double DIV = FMT == FP8 ? 448.0 : 127.0;
    const float scale =
        amax <= 0.0f ? 1.0f : __fmul_rn(amax, (float)(1.0 / DIV));
    for (int d = tid; d < D; d += THREADS) {
      const float y = __fdiv_rn(__bfloat162float(src[d]), scale);
      if constexpr (FMT == FP8) {
        reinterpret_cast<uint8_t*>(pages)[srow * D + d] =
            nctt::to_e4m3(fminf(fmaxf(y, -448.0f), 448.0f));
      } else {
        reinterpret_cast<int8_t*>(pages)[srow * D + d] =
            (int8_t)fminf(fmaxf(rintf(y), -128.0f), 127.0f);
      }
    }
    if (tid == 0) scales[srow] = scale;
  }
}

template <int FMT>
__global__ void __launch_bounds__(THREADS)
paged_write_kernel(const __nv_bfloat16* __restrict__ kn,
                   const __nv_bfloat16* __restrict__ vn, void* kp, float* ks,
                   float* ko, void* vp, float* vs, float* vo,
                   const int* __restrict__ bt, const int* __restrict__ pos,
                   int Hkv, int page, int PMAX, int D) {
  __shared__ float sred[WARPS];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  if (p < 0 || p / page >= PMAX) return;
  const int pid = bt[(size_t)b * PMAX + p / page];
  const size_t src = ((size_t)b * Hkv + hk) * D;
  write_row<FMT>(kn + src, kp, ks, ko, pid, hk, Hkv, page, p % page, D, sred);
  write_row<FMT>(vn + src, vp, vs, vo, pid, hk, Hkv, page, p % page, D, sred);
}

template <int FMT>
int launch(const void* kn, const void* vn, void* kp, void* ks, void* ko,
           void* vp, void* vs, void* vo, const void* bt, const void* pos,
           int B, int Hkv, int page, int PMAX, int D, cudaStream_t s) {
  paged_write_kernel<FMT><<<dim3(Hkv, B), THREADS, 0, s>>>(
      (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, kp, (float*)ks,
      (float*)ko, vp, (float*)vs, (float*)vo, (const int*)bt,
      (const int*)pos, Hkv, page, PMAX, D);
  return (int)cudaGetLastError();
}

// K13: W consecutive rows per slot from pos[b], as JAX's windowed write
// maps them: the window's first page p0 = clip(floor(pos / page), 0,
// PMAX - 1) and its successor p1 = min(p0 + 1, PMAX - 1); window row w lands
// at row off + w of page block_tables[b, p0] (off = pos mod page) while
// off + w < page, else at row off + w - page of block_tables[b, p1] if the
// window crosses into a page of the table, else of the trash page 0. The
// rows go in window order, so two rows of one window that share an int4
// byte row merge their nibbles in turn.
template <int FMT>
__global__ void __launch_bounds__(THREADS)
paged_write_window_kernel(const __nv_bfloat16* __restrict__ kn,
                          const __nv_bfloat16* __restrict__ vn, void* kp,
                          float* ks, float* ko, void* vp, float* vs,
                          float* vo, const int* __restrict__ bt,
                          const int* __restrict__ pos, int Hkv, int page,
                          int PMAX, int D, int W) {
  __shared__ float sred[WARPS];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  const int pf = p >= 0 ? p / page : -((page - 1 - p) / page);  // floor
  const int off = p - pf * page;
  const int p0 = pf < 0 ? 0 : (pf > PMAX - 1 ? PMAX - 1 : pf);
  const int p1 = p0 + 1 < PMAX - 1 ? p0 + 1 : PMAX - 1;
  const bool crosses = off + W > page && p0 + 1 <= PMAX - 1;
  const int* btb = bt + (size_t)b * PMAX;
  const int pid0 = btb[p0], pid1 = crosses ? btb[p1] : 0;
  for (int w = 0; w < W; ++w) {
    const int t = off + w;
    const int pid = t < page ? pid0 : pid1, r = t < page ? t : t - page;
    const size_t src = (((size_t)b * Hkv + hk) * W + w) * D;
    write_row<FMT>(kn + src, kp, ks, ko, pid, hk, Hkv, page, r, D, sred);
    write_row<FMT>(vn + src, vp, vs, vo, pid, hk, Hkv, page, r, D, sred);
  }
}

template <int FMT>
int launch_window(const void* kn, const void* vn, void* kp, void* ks,
                  void* ko, void* vp, void* vs, void* vo, const void* bt,
                  const void* pos, int B, int Hkv, int page, int PMAX, int D,
                  int W, cudaStream_t s) {
  paged_write_window_kernel<FMT><<<dim3(Hkv, B), THREADS, 0, s>>>(
      (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, kp, (float*)ks,
      (float*)ko, vp, (float*)vs, (float*)vo, (const int*)bt,
      (const int*)pos, Hkv, page, PMAX, D, W);
  return (int)cudaGetLastError();
}

}  // namespace

// k_new/v_new bf16 [B, Hkv, D]; pages [P, Hkv, page, D] bf16 (fmt 0), int8
// (1) or e4m3 (2), or [P, Hkv, page/2, D] int4 bytes (3); scales f32
// [P, Hkv, page] (null for bf16); offsets f32 [P, Hkv, page] (int4 only);
// block_tables int32 [B, PMAX]; pos int32 [B]. `page` counts tokens.
NCTT_API int nctt_paged_write_rows(const void* kn, const void* vn, void* kp,
                                   void* ks, void* ko, void* vp, void* vs,
                                   void* vo, const void* bt, const void* pos,
                                   int B, int Hkv, int P, int page, int PMAX,
                                   int D, int fmt, void* stream) {
  (void)P;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case BF16: return launch<BF16>(kn, vn, kp, ks, ko, vp, vs, vo, bt, pos, B,
                                   Hkv, page, PMAX, D, s);
    case INT8: return launch<INT8>(kn, vn, kp, ks, ko, vp, vs, vo, bt, pos, B,
                                   Hkv, page, PMAX, D, s);
    case FP8: return launch<FP8>(kn, vn, kp, ks, ko, vp, vs, vo, bt, pos, B,
                                 Hkv, page, PMAX, D, s);
    case INT4: return launch<INT4>(kn, vn, kp, ks, ko, vp, vs, vo, bt, pos, B,
                                   Hkv, page, PMAX, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K13. k_new/v_new bf16 [B, Hkv, W, D], W <= page; pools, scales, offsets
// and block tables as for nctt_paged_write_rows; pos int32 [B], the
// window's first position per slot.
NCTT_API int nctt_paged_write_window(const void* kn, const void* vn,
                                     void* kp, void* ks, void* ko, void* vp,
                                     void* vs, void* vo, const void* bt,
                                     const void* pos, int B, int Hkv, int P,
                                     int page, int PMAX, int D, int W,
                                     int fmt, void* stream) {
  (void)P;
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1 || W > page) return (int)cudaErrorInvalidValue;
  switch (fmt) {
    case BF16: return launch_window<BF16>(kn, vn, kp, ks, ko, vp, vs, vo, bt,
                                          pos, B, Hkv, page, PMAX, D, W, s);
    case INT8: return launch_window<INT8>(kn, vn, kp, ks, ko, vp, vs, vo, bt,
                                          pos, B, Hkv, page, PMAX, D, W, s);
    case FP8: return launch_window<FP8>(kn, vn, kp, ks, ko, vp, vs, vo, bt,
                                        pos, B, Hkv, page, PMAX, D, W, s);
    case INT4: return launch_window<INT4>(kn, vn, kp, ks, ko, vp, vs, vo, bt,
                                          pos, B, Hkv, page, PMAX, D, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
