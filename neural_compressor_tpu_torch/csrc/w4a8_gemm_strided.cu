// K1 over "tpu_strided" int4 words, read where they lie:
//
//   y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Replaces: neural_compressor_tpu/kernels/w4a8_matmul.py:88 _w4a8_impl /
//   _make_kernel (K1) on its own layout: 32-bit words [K/8, N], eight
//   offset-binary K-direction fields per word, strided within a group (word
//   g*G/8 + i, field s = row g*G + s*(G/8) + i). A W4A8Linear that keeps
//   them (M_INT8_THRESHOLD raised, hybrid GPTQ, to_w4a8_serving(s4=False))
//   runs here. (w4a8_gemm.cu holds K1's "hopper_nk" entry; this entry is a
//   source of its own so that the two compile in parallel.)
//
// Bound on this card: as K1's, the same bytes and operations (K*N/2 bytes
//   of codes, 2*M*N*K int8 operations): bytes below M ~ 300, operations
//   above.
//
// Design: the paths of w4a8_core.cuh, K1's, so that the same codes give
//   K1's bits at every M. A stage is 16 word rows x BN words, 16-byte
//   copies along N; four words of one column (four word rows) are
//   transposed as a 4 x 8 nibble matrix with byte permutes into 8 four-code
//   k-runs, one per field (offset binary: the unsigned codes the core
//   multiplies). Where a stage holds whole groups (G <= 128) the runs land
//   at their k; where a group spans stages (G > 128) a stage takes 16 of
//   its G/8 word rows, all 8 fields, and the xq slots it copies follow the
//   same order (Stage::k_at), so each word is read once at every G. Group
//   sizes that neither divide 128 nor are multiples of it, those below 32
//   and K % 128 != 0 take the general path of w4a8_core.cuh.
#include "w4a8_core.cuh"

namespace {

using namespace nctt::w4a8;

// "tpu_strided" int4, G/8 word rows a group: raw [r][BN] words, the
// stage's 16 word rows from row k0/8 (natural: whole groups, G <= 128) or
// k0/8 + i0 (gathered: a sixteen-row slice of one group, G > 128)
struct StridedLayout {
  static constexpr bool STRIDED = true, DIRECT = false;
  template <int BN, int NTHR, int LDR>   // LDR: unused (rows of words)
  static __device__ __forceinline__ void copy(uint8_t* raw, const void* wv,
                                              int n0, const Stage& st, int N,
                                              int K, int G, int tid) {
    const uint32_t* w = (const uint32_t*)wv +
        (size_t)(st.k0 / 8 + (st.i0 < 0 ? 0 : st.i0)) * N + n0;
    constexpr int CH = BN / 4;   // 16-byte chunks a row
    for_items<16 * CH, NTHR>(tid, [&](int i) {
      const int r = i / CH, j = i % CH;
      cp_async<16>(raw + (r * BN + 4 * j) * 4, w + (size_t)r * N + 4 * j);
    });
  }
  // four words of a column (four word rows) transposed into 8 four-code
  // k-runs, one per field (offset binary: the unsigned codes): natural, field s of local row R at slot
  // (R / rpg) * G + s * rpg + R % rpg; gathered, at 16 s + R
  template <int BN, int NTHR, int LDR, class Dst>
  static __device__ __forceinline__ void unpack(const uint8_t* raw,
                                                const Dst& dst,
                                                const Stage& st, int G,
                                                int tid) {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(raw);
    const int rpg = G >> 3, lg = __ffs(rpg) - 1;   // a power of 2 here
    for_items<BN * 4, NTHR>(tid, [&](int i) {
      const int c = i % BN, iq = i / BN;
      uint32_t q[4], f[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) q[t] = rw[(4 * iq + t) * BN + c];
      transpose_nibbles(q, f);
      const int R = 4 * iq;
      const int kk0 = st.i0 < 0 ? ((R >> lg) * G + (R & (rpg - 1))) : R;
      const int step = st.i0 < 0 ? rpg : 16;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *reinterpret_cast<uint32_t*>(dst.at(c, kk0 + s * step)) = f[s];
    });
  }
};

// the general path's code of (k, n) in "tpu_strided" int4
struct StridedCode {
  static __device__ __forceinline__ int at(const void* wv, int k, int n,
                                           int N, int K, int G) {
    const uint32_t* w = (const uint32_t*)wv;
    const int rpg = G / 8, g = k / G, kk = k % G;
    const uint32_t word = w[(size_t)(g * rpg + kk % rpg) * N + n];
    return (int)((word >> (4 * (kk / rpg))) & 0xFu) - 8;
  }
};

}  // namespace

// xq int8 [M, K]; w 32-bit [K/8, N] ("tpu_strided" int4); scales f32
// [K/G, N]; xscale f32 [M]; y f32 [M, N]; K % G == 0 and G % 8 == 0. The
// plan as nctt_w4a8_gemm's (kernels/w4a8_matmul.py gemm_plan).
NCTT_API int nctt_w4a8_gemm_strided(const void* xq, const void* w,
                                    const void* scales, const void* xscale,
                                    void* y, int M, int N, int K, int G,
                                    int path, int mt, int bn, int ku,
                                    int stages, void* stream) {
  if (G < 8 || G % 8 || K % G) return (int)cudaErrorInvalidValue;
  return launch<StridedLayout, StridedCode>(
      xq, w, scales, xscale, y, M, N, K, G,
      Plan{path, mt, bn, ku, stages}, (cudaStream_t)stream);
}
