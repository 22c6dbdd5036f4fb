// W4A8 GEMM: y[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * wq[k, n]
//
// Replaces: neural_compressor_tpu/kernels/w4a8_matmul.py _w4a8_impl /
//   _make_kernel (K1, "tpu_strided") and kernels/fused_matvec.py _u4k_impl /
//   _make_mk_kernel (K3, "u4_kpack"): the same function on two TPU layouts.
//   Two entries here read two layouts where they lie:
//   * nctt_w4a8_gemm: "hopper_nk", uint8 [N, K/2], two K-adjacent signed
//     nibbles per byte (the port's serving layout, ops/packing.py);
//   * nctt_w4a8_gemm_strided: "tpu_strided", 32-bit words [K/8, N], eight
//     offset-binary K-direction fields per word, strided within a group
//     (word g*G/8 + i, field s = row g*G + s*(G/8) + i), the words JAX's
//     K1 itself reads; a W4A8Linear that keeps them (M_INT8_THRESHOLD
//     raised, hybrid GPTQ, to_w4a8_serving(s4=False)) runs here.
//
// Bound on this card: at the prefill shapes (M = prompt length, 17..512,
//   K x N up to 4096 x 32000) the int8 operations (2*M*N*K at 1979 TOP/s)
//   and the weight stream (K*N/2 bytes at 3.35 TB/s) cross near M ~ 300:
//   short prompts are bound by bytes, long ones by operations.
//
// Design: the MMA core in w4a8_core.cuh, with a loader per layout that
//   stages the weight tile as k-contiguous int8 codes in shared memory.
//   The strided loader reads a column's words for four consecutive word
//   rows (coalesced along N), transposes the 4 x 8 nibble matrix with byte
//   permutes and stores one 4-byte k-run per field. Where a 128-row stage
//   covers whole word rows (G = 128, 256, 512, 1024, 2048, ...) it keeps
//   nf = 1024 / min(G, 1024) of a word's 8 fields, so each word is read
//   min(G, 1024) / 128 times: once at G = 128, twice at 256, 4 times at
//   512, 8 times from 1024 on. Other group sizes that are multiples of 32
//   read each word once per field (a slower loader off the main path).
//   Group sizes below 32 take the general path of w4a8_core.cuh.
#include "w4a8_core.cuh"

namespace {

using namespace nctt::w4a8;

// "hopper_nk": each 16-byte vector of a column unpacks to 32 codes
struct HopperLoader {
  static __device__ __forceinline__ void stage(int8_t* sB, const void* wv,
                                               int n0, int k0, int kc, int N,
                                               int K, int G, int tid) {
    const uint8_t* w = (const uint8_t*)wv;
    const size_t wrow = (size_t)K / 2;
    const int bvec = kc / 32;
    for (int i = tid; i < BN * bvec; i += THREADS) {
      const int c = i / bvec, v = i % bvec;
      const uint4 pk = *reinterpret_cast<const uint4*>(
          w + (size_t)(n0 + c) * wrow + k0 / 2 + v * 16);
      uint32_t o[8];
      nctt::unpack8(pk.x, o[0], o[1]);
      nctt::unpack8(pk.y, o[2], o[3]);
      nctt::unpack8(pk.z, o[4], o[5]);
      nctt::unpack8(pk.w, o[6], o[7]);
      uint4* dst = reinterpret_cast<uint4*>(sB + c * LDS + v * 32);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
};

// "tpu_strided" int4, rpg = G/8 word rows a group. Where rpg divides 128
// or 128 divides rpg, a stage [k0, k0 + 128) of group g covers fields
// [s0, s0 + nf) of word rows [i0, i0 + nr): item (c, row quad), four words
// read, nf 4-byte k-runs out. A word is read once per stage that covers
// one of its fields, 8 / nf times (once only at G = 128).
struct StridedLoader {
  static __device__ __forceinline__ void stage(int8_t* sB, const void* wv,
                                               int n0, int k0, int kc, int N,
                                               int K, int G, int tid) {
    const uint32_t* w = (const uint32_t*)wv;
    const int rpg = G / 8;
    if (G % KC == 0 && (KC % rpg == 0 || rpg % KC == 0)) {
      const int g = k0 / G, kk0 = k0 % G;
      const int nr = min(rpg, KC);             // word rows in the stage
      const int nf = KC / nr;                  // fields in the stage
      const int s0 = kk0 / rpg, i0 = kk0 % rpg;
      const int nrq = nr / 4;
      for (int it = tid; it < BN * nrq; it += THREADS) {
        const int iq = it % nrq, c = it / nrq;
        const uint32_t* src = w + (size_t)(g * rpg + i0 + 4 * iq) * N + n0 + c;
        uint32_t q[4], f[8];
#pragma unroll
        for (int t = 0; t < 4; ++t) q[t] = __ldg(src + (size_t)t * N);
        transpose_nibbles(q, f);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int fs = s - s0;
          if (fs >= 0 && fs < nf)
            *reinterpret_cast<uint32_t*>(sB + c * LDS + fs * nr + 4 * iq) =
                unbias4(f[s]);
        }
      }
      return;
    }
    // any G % 32 == 0: item (c, k quad), the quad's field of four words
    for (int it = tid; it < BN * (kc / 4); it += THREADS) {
      const int kq = it % (kc / 4), c = it / (kc / 4);
      const int k = k0 + 4 * kq, g = k / G, kk = k % G;
      const int s = kk / rpg, i = kk % rpg;
      const uint32_t* src = w + (size_t)(g * rpg + i) * N + n0 + c;
      uint32_t v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v |= ((__ldg(src + (size_t)t * N) >> (4 * s)) & 0xFu) << (8 * t);
      *reinterpret_cast<uint32_t*>(sB + c * LDS + 4 * kq) = unbias4(v);
    }
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
// y f32 [M, N]. K % G == 0 and K even; the tiled kernel where K % 32 == 0,
// G % 32 == 0 and N % 64 == 0, else the general path.
NCTT_API int nctt_w4a8_gemm(const void* xq, const void* w, const void* scales,
                            const void* xscale, void* y, int M, int N, int K,
                            int G, void* stream) {
  if (G < 1 || K % G || K % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (K % 32 || G % 32 || N % BN)
    return launch_any_group<HopperCode>(xq, w, scales, xscale, y, M, N, K, G,
                                        st);
  return launch_tiled<HopperLoader>(xq, w, scales, xscale, y, M, N, K, G, st);
}

// The same product over "tpu_strided" int4 words: w 32-bit [K/8, N]. K % G
// == 0 and G % 8 == 0; the tiled kernel where G % 32 == 0 and N % 64 == 0,
// else the general path.
NCTT_API int nctt_w4a8_gemm_strided(const void* xq, const void* w,
                                    const void* scales, const void* xscale,
                                    void* y, int M, int N, int K, int G,
                                    void* stream) {
  if (G < 8 || G % 8 || K % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (G % 32 || N % BN)
    return launch_any_group<StridedCode>(xq, w, scales, xscale, y, M, N, K, G,
                                         st);
  return launch_tiled<StridedLoader>(xq, w, scales, xscale, y, M, N, K, G,
                                     st);
}
