// K2, the W4A8 GEMM over "s4_rowpack" weights, read where they lie:
//
//   y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Replaces: neural_compressor_tpu/kernels/s4_matmul.py _s4_impl /
//   _make_kernel (K2): the same function as K1 on the JAX package's
//   native-int4 layout, 32-bit words [K, N/8], word (k, j) holding the 8
//   consecutive output columns 8j..8j+7 of row k, nibble s = column 8j+s,
//   two's complement (ops/packing.py pack_codes_s4). The TPU kernel views
//   the words as an int4 [K, N] array and lets the hardware convert it;
//   here the loader sign-extends the nibbles itself.
//
// Bound on this card: as K1's, the same bytes and operations (K*N/2 bytes
//   of codes, 2*M*N*K int8 operations): bytes at short prompts and at the
//   decode step's M = 1 and 8, operations past M ~ 300.
//
// Design: the MMA core of w4a8_core.cuh, K1's, so that the same codes give
//   K1's bits at every M (M = 1 and 8 run the same kernel, as on the TPU).
//   The words are packed along N, but mma.sync's B operand wants 4
//   k-contiguous bytes a column: a thread loads two neighbouring words of
//   four consecutive rows (16 columns x 4 k), transposes each 4 x 8 nibble
//   matrix with byte permutes, sign-extends the bytes and stores one 4-byte
//   k-run per column into the [column][k] tile; a warp takes 32 k-quads of
//   one word pair, so its stores fall in distinct banks. Group sizes below
//   32 take the general path of w4a8_core.cuh.
#include "w4a8_core.cuh"

namespace {

using namespace nctt::w4a8;

struct S4Loader {
  static __device__ __forceinline__ void stage(int8_t* sB, const void* wv,
                                               int n0, int k0, int kc, int N,
                                               int K, int G, int tid) {
    const uint32_t* w = (const uint32_t*)wv;
    const int wrow = N / 8;               // words a row
    const int nkq = kc / 4;               // k quads in the stage (<= 32)
    for (int it = tid; it < (BN / 16) * nkq; it += THREADS) {
      const int kq = it % nkq, jp = it / nkq;  // word pair jp: 16 columns
      const uint32_t* src =
          w + (size_t)(k0 + 4 * kq) * wrow + n0 / 8 + 2 * jp;
      uint32_t lo[4], hi[4], f[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(
            src + (size_t)t * wrow));
        lo[t] = v.x;
        hi[t] = v.y;
      }
      transpose_nibbles(lo, f);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *reinterpret_cast<uint32_t*>(sB + (16 * jp + s) * LDS + 4 * kq) =
            sext4(f[s]);
      transpose_nibbles(hi, f);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *reinterpret_cast<uint32_t*>(sB + (16 * jp + 8 + s) * LDS + 4 * kq) =
            sext4(f[s]);
    }
  }
};

struct S4Code {
  static __device__ __forceinline__ int at(const void* wv, int k, int n,
                                           int N, int K, int G) {
    const uint32_t* w = (const uint32_t*)wv;
    const uint32_t nib = (w[(size_t)k * (N / 8) + n / 8] >> (4 * (n % 8))) & 0xFu;
    return ((int)nib ^ 8) - 8;
  }
};

}  // namespace

// xq int8 [M, K]; w 32-bit [K, N/8] ("s4_rowpack"); scales f32 [K/G, N];
// xscale f32 [M]; y f32 [M, N]. K % G == 0 and N % 8 == 0; the tiled
// kernel where K % 32 == 0, G % 32 == 0 and N % 64 == 0, else the general
// path.
NCTT_API int nctt_s4_gemm(const void* xq, const void* w, const void* scales,
                          const void* xscale, void* y, int M, int N, int K,
                          int G, void* stream) {
  if (G < 1 || K % G || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (K % 32 || G % 32 || N % BN)
    return launch_any_group<S4Code>(xq, w, scales, xscale, y, M, N, K, G, st);
  return launch_tiled<S4Loader>(xq, w, scales, xscale, y, M, N, K, G, st);
}
