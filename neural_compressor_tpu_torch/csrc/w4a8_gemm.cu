// W4A8 GEMM: y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Replaces: neural_compressor_tpu/kernels/w4a8_matmul.py:88 _w4a8_impl /
//   _make_kernel (K1, "tpu_strided") and kernels/fused_matvec.py:324
//   _u4k_impl / _make_mk_kernel (K3, "u4_kpack"): the same function on two
//   TPU layouts. This entry, nctt_w4a8_gemm, reads the port's serving
//   layout "hopper_nk", uint8 [N, K/2], two K-adjacent signed nibbles per
//   byte (ops/packing.py), where it lies; w4a8_gemm_strided.cu reads JAX's
//   own "tpu_strided" words.
//
// Bound on this card: the weight stream (K*N/2 bytes at 3.35 TB/s) below
//   M ~ 300 tokens (every decode step, short prompts), the int8 operations
//   (2*M*N*K at 1979 TOP/s) above.
//
// Design: the paths of w4a8_core.cuh (a ring of raw words streamed by
//   cp.async; mma.sync with the weights on the wide side at small M, its
//   eight warps splitting K by whole groups within a block; wgmma at
//   prefill widths), with a layout struct for copying a stage's words as they lie
//   and unpacking them: a stage (128 k-slots) is [BN columns][64 bytes],
//   16-byte copies along each column's K; the small path reads each lane's
//   4 bytes (8 k-slots) straight into its MMA fragments, the wgmma path
//   unpacks every 16 bytes to 32 k-contiguous codes in its swizzled tile.
//   Group sizes that neither divide 128 nor are multiples of it, those below
//   32 and K % 128 != 0 take the general path of w4a8_core.cuh.
#include "w4a8_core.cuh"

namespace {

using namespace nctt::w4a8;

// "hopper_nk": raw [c][LDR] bytes, a column's 128 codes of the stage in
// its first 64. The small path reads them straight into its MMA's A
// fragments (DIRECT); the wgmma path unpacks them into its tile.
struct HopperLayout {
  static constexpr bool STRIDED = false, DIRECT = true;
  template <int BN, int NTHR, int LDR>
  static __device__ __forceinline__ void copy(uint8_t* raw, const void* wv,
                                              int n0, const Stage& st, int N,
                                              int K, int G, int tid) {
    const uint8_t* w = (const uint8_t*)wv + st.k0 / 2;
    for_items<BN * 4, NTHR>(tid, [&](int i) {
      const int c = i >> 2, v = i & 3;
      cp_async<16>(raw + c * LDR + v * 16,
                   w + (size_t)(n0 + c) * (K / 2) + v * 16);
    });
  }
  // 16 bytes of a column -> 32 k-contiguous unsigned codes
  template <int BN, int NTHR, int LDR, class Dst>
  static __device__ __forceinline__ void unpack(const uint8_t* raw,
                                                const Dst& dst,
                                                const Stage& st, int G,
                                                int tid) {
    for_items<BN * 4, NTHR>(tid, [&](int i) {
      const int c = i >> 2, v = i & 3;
      const uint4 pk = *reinterpret_cast<const uint4*>(raw + c * LDR + v * 16);
      uint32_t o[8];
      nctt::w4a8::unpack8(pk.x, o[0], o[1]);
      nctt::w4a8::unpack8(pk.y, o[2], o[3]);
      nctt::w4a8::unpack8(pk.z, o[4], o[5]);
      nctt::w4a8::unpack8(pk.w, o[6], o[7]);
      *reinterpret_cast<uint4*>(dst.at(c, 32 * v)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst.at(c, 32 * v + 16)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    });
  }
};

// the general path's code of (k, n) in "hopper_nk"
struct HopperCode {
  static __device__ __forceinline__ int at(const void* wv, int k, int n,
                                           int N, int K, int G) {
    const uint8_t b = ((const uint8_t*)wv)[(size_t)n * (K / 2) + k / 2];
    return ((int)((k & 1) ? b >> 4 : b & 15) ^ 8) - 8;
  }
};

}  // namespace

// xq int8 [M, K]; w uint8 [N, K/2]; scales f32 [K/G, N]; xscale f32 [M];
// y f32 [M, N]; K % G == 0 and K even. The plan (kernels/w4a8_matmul.py
// gemm_plan): path (0 general, 1 small, 2 wgmma), token rows and columns a
// block, a small-path warp's unit of k-slots, ring slots. A plan that does
// not fit the shape returns cudaErrorInvalidValue.
NCTT_API int nctt_w4a8_gemm(const void* xq, const void* w, const void* scales,
                            const void* xscale, void* y, int M, int N, int K,
                            int G, int path, int mt, int bn, int ku,
                            int stages, void* stream) {
  if (G < 1 || K % G || K % 2) return (int)cudaErrorInvalidValue;
  return launch<HopperLayout, HopperCode>(
      xq, w, scales, xscale, y, M, N, K, G,
      Plan{path, mt, bn, ku, stages}, (cudaStream_t)stream);
}
