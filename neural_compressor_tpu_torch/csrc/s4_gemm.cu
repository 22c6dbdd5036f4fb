// K2, the W4A8 GEMM over "s4_rowpack" weights, read where they lie:
//
//   y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Replaces: neural_compressor_tpu/kernels/s4_matmul.py:83 _s4_impl /
//   _make_kernel (K2): the same function as K1 on the JAX package's
//   native-int4 layout, 32-bit words [K, N/8], word (k, j) holding the 8
//   consecutive output columns 8j..8j+7 of row k, nibble s = column 8j+s,
//   two's complement (ops/packing.py pack_codes_s4). The TPU kernel views
//   the words as an int4 [K, N] array and lets the hardware convert it;
//   here the unpack sign-extends the nibbles itself.
//
// Bound on this card: as K1's, the same bytes and operations (K*N/2 bytes
//   of codes, 2*M*N*K int8 operations): bytes at the decode steps' M = 1
//   and 8 and at short prompts, operations past M ~ 300.
//
// Design: the paths of w4a8_core.cuh, K1's, so that the same codes give
//   K1's bits at every M (the B=1 step's M = 1 takes the small path, with
//   the weights on mma.sync's wide side, not a 64-row tile). A stage is 128
//   rows of BN/8 words (BN/16 8-byte word pairs a row), copied 8 bytes at a
//   time along N; word pair u of row r lies at u ^ (r/4 % (BN/16)) in
//   shared memory, so the unpack's loads of four rows by 32 lanes spread
//   over the banks. mma.sync and wgmma want 4 k-contiguous bytes a column:
//   a thread takes one word pair of four consecutive rows (16 columns x 4
//   k), flips bit 3 of every nibble (two's complement to the unsigned code
//   plus 8 the core multiplies), transposes each 4 x 8 nibble matrix with
//   byte permutes and stores one 4-byte k-run per column into the
//   [column][k] tile; a warp takes 32 k-quads of one word pair, so its
//   stores fall in distinct banks. Group sizes below 32 (and the shapes
//   the tiled paths do not take) take the general path of w4a8_core.cuh.
#include "w4a8_core.cuh"

namespace {

using namespace nctt::w4a8;

struct S4Layout {
  static constexpr bool STRIDED = false, DIRECT = false;
  // position of word pair u of stage row r
  template <int BN>
  static __device__ __forceinline__ int unit(int r, int u) {
    return u ^ ((r >> 2) & (BN / 16 - 1));
  }
  template <int BN, int NTHR, int LDR>   // LDR: unused (rows of k)
  static __device__ __forceinline__ void copy(uint8_t* raw, const void* wv,
                                              int n0, const Stage& st, int N,
                                              int K, int G, int tid) {
    const uint8_t* w = (const uint8_t*)wv + (size_t)st.k0 * (N / 2) + n0 / 2;
    constexpr int U = BN / 16, RB = BN / 2;   // pairs, bytes a row
    for_items<KS * U, NTHR>(tid, [&](int i) {
      const int r = i / U, u = i % U;
      cp_async<8>(raw + r * RB + unit<BN>(r, u) * 8,
                  w + (size_t)r * (N / 2) + u * 8);
    });
  }
  template <int BN, int NTHR, int LDR, class Dst>
  static __device__ __forceinline__ void unpack(const uint8_t* raw,
                                                const Dst& dst,
                                                const Stage& st, int G,
                                                int tid) {
    constexpr int U = BN / 16, RB = BN / 2;
    for_items<U * (KS / 4), NTHR>(tid, [&](int i) {
      const int kq = i % (KS / 4), jp = i / (KS / 4);   // pair jp: 16 columns
      uint32_t lo[4], hi[4], f[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = 4 * kq + t;
        const uint2 v = *reinterpret_cast<const uint2*>(
            raw + r * RB + unit<BN>(r, jp) * 8);
        // bit 3 of every nibble flipped: two's complement v -> v ^ 8,
        // the unsigned code (the code plus 8) the MMAs take
        lo[t] = v.x ^ 0x88888888u;
        hi[t] = v.y ^ 0x88888888u;
      }
      transpose_nibbles(lo, f);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *reinterpret_cast<uint32_t*>(dst.at(16 * jp + s, 4 * kq)) = f[s];
      transpose_nibbles(hi, f);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *reinterpret_cast<uint32_t*>(dst.at(16 * jp + 8 + s, 4 * kq)) = f[s];
    });
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
// xscale f32 [M]; y f32 [M, N]; K % G == 0 and N % 8 == 0. The plan as
// nctt_w4a8_gemm's (kernels/w4a8_matmul.py gemm_plan).
NCTT_API int nctt_s4_gemm(const void* xq, const void* w, const void* scales,
                          const void* xscale, void* y, int M, int N, int K,
                          int G, int path, int mt, int bn, int ku, int stages,
                          void* stream) {
  if (G < 1 || K % G || N % 8) return (int)cudaErrorInvalidValue;
  return launch<S4Layout, S4Code>(xq, w, scales, xscale, y, M, N, K, G,
                                  Plan{path, mt, bn, ku, stages},
                                  (cudaStream_t)stream);
}
