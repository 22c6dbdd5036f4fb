// Shared helpers of the port's CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#define NCTT_API extern "C" __attribute__((visibility("default")))

namespace nctt {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// Eight signed int4 codes of one 32-bit "hopper_nk" word (byte j holds code
// 2j in its low nibble and code 2j+1 in its high nibble, two's complement)
// -> eight int8 codes in k order: k0..k3 in `lo4`, k4..k7 in `hi4`.
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& lo4,
                                        uint32_t& hi4) {
  uint32_t ev = w & 0x0F0F0F0Fu;          // k = 0, 2, 4, 6
  uint32_t od = (w >> 4) & 0x0F0F0F0Fu;   // k = 1, 3, 5, 7
  // sign-extend each nibble to its byte: (v ^ 8) - 8, per byte, no borrow
  ev = __vsub4(ev ^ 0x08080808u, 0x08080808u);
  od = __vsub4(od ^ 0x08080808u, 0x08080808u);
  lo4 = __byte_perm(ev, od, 0x5140);
  hi4 = __byte_perm(ev, od, 0x7362);
}

// One fp8-e4m3 code (the bits of torch.float8_e4m3fn), a type of its own so
// that the loaders below can tell it from an int8 code.
struct fp8e4m3 {
  uint8_t bits;
};

// Cache rows and codes as float, exactly: bf16 values, int8 codes, and
// e4m3 codes through Hopper's conversion to half (every e4m3 value,
// subnormals included, is a half).
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(fp8e4m3 x) {
  return __half2float(
      __half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)x.bits, __NV_E4M3)));
}

// Exact float64 values of cache elements by bit moves and one float64
// operation (Hopper issues these at the float64 rate; its float-to-double
// conversion runs at a quarter of it): bf16 and e4m3 bits placed under a
// double's exponent and rebiased by a power of two, int8 codes by the 2^52
// magic number.
__device__ __forceinline__ double bf16_bits(uint32_t b) {   // low 16 bits
  return __hiloint2double(
             (int)(((b & 0x7FFFu) << 13) | ((b & 0x8000u) << 16)), 0) *
         0x1p896;
}
__device__ __forceinline__ double e4m3_bits(uint32_t b) {   // low 8 bits
  return __hiloint2double((int)(((b & 0x7Fu) << 17) | ((b & 0x80u) << 24)),
                          0) *
         0x1p1016;
}
__device__ __forceinline__ double int8_bits(uint32_t b) {   // low 8 bits
  return __hiloint2double(0x43300000, (int)((b & 0xFFu) ^ 0x80u)) -
         4503599627370624.0;                                // 2^52 + 128
}

// float -> e4m3 bits, round to nearest even (the caller clips to +-448)
__device__ __forceinline__ uint8_t to_e4m3(float x) {
  return (uint8_t)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// N consecutive bytes from an N-aligned address, in one load for N <= 8
template <int N>
__device__ __forceinline__ void load_bytes(const void* p, uint8_t (&b)[N]) {
  if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    memcpy(b, &v, 8);
  } else if constexpr (N == 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    memcpy(b, &v, 4);
  } else if constexpr (N == 2) {
    const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
    memcpy(b, &v, 2);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = reinterpret_cast<const uint8_t*>(p)[i];
  }
}

// DPL consecutive elements of a cache row as float: bf16 rows by bf16x2
// loads (4-byte aligned for DPL >= 2), one-byte codes (int8, e4m3) by one
// load of DPL bytes
template <int DPL, typename C>
__device__ __forceinline__ void load_row(const C* p, float (&out)[DPL]) {
  if constexpr (std::is_same<C, __nv_bfloat16>::value) {
    if constexpr (DPL == 1) {
      out[0] = __bfloat162float(p[0]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; i += 2) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(p + i);
        out[i] = __bfloat162float(v.x);
        out[i + 1] = __bfloat162float(v.y);
      }
    }
  } else {
    static_assert(sizeof(C) == 1, "one-byte codes");
    uint8_t b[DPL];
    load_bytes<DPL>(p, b);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      C c;
      memcpy(&c, &b[e], 1);
      out[e] = to_float(c);
    }
  }
}

// Widths DPL whose lanes tile a D = 32*DPL row by whole vectors: the
// attention kernels keep a copy for them with D a compile-time constant
// (the indexing folds and the tail guards vanish), and a ragged copy with D
// at run time for every other width.
constexpr bool full_width(int dpl) {
  return dpl == 1 || dpl == 2 || dpl == 4 || dpl == 8 || dpl == 12 ||
         dpl == 16;
}

// A lane's DPL elements lane*DPL .. lane*DPL + DPL - 1 of a D-wide row
// (D <= 32*DPL) as float, zero past D. Where the lanes tile the row exactly
// and DPL is 1 or even, by load_row's vectors; otherwise (a masked tail,
// or an odd DPL, whose lane offsets are not 4-byte aligned for bf16x2) by
// scalar loads.
template <int DPL, typename C>
__device__ __forceinline__ void load_lane(const C* row, int lane, int D,
                                          float (&out)[DPL]) {
  const int i0 = lane * DPL;
  if constexpr (DPL == 1 || DPL % 2 == 0) {
    if (D == 32 * DPL) {
      load_row<DPL>(row + i0, out);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    out[e] = i0 + e < D ? to_float(row[i0 + e]) : 0.0f;
}

// a block's dynamic shared memory on the H100: 227 KB, the opt-in maximum
constexpr int MAX_DYN_SMEM = 232448;

// ------------------------------------------ asynchronous copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) bytes global -> shared, asynchronously; zeros where
// `valid` is false (nothing is read then)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid = true) {
  const uint32_t n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the n newest commit groups have landed (n < 8)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}


// ------------------------------------------ mbarriers and bulk copies
// (TMA's 1-D bulk copy: no tensor map, the hardware moves the bytes and
// counts them on an mbarrier in shared memory)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// the inits visible to the async proxy (the bulk copies) and the block
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the phase of parity `parity` to complete; a pipeline that never
// completes it traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 26)) __trap();
  }
}
// one arrival on `bar` that also expects `bytes` more of bulk copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// expect `bytes` more of bulk copies on `bar` (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// one thread: expect `bytes` on `bar`, then copy them global -> shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}
// an arrival on `bar` once this thread's cp.async copies issued so far
// have landed; it adds itself to the arrivals the barrier's phase awaits
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// a barrier among the first `threads` threads of the block (id > 0: the
// block's __syncthreads keeps id 0)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}


// x / d and x % d by a shift and a mask where d is a power of 2 (the main
// path's group sizes), by division elsewhere
struct Div {
  int d, sh;   // sh < 0: not a power of 2
  __device__ __forceinline__ int q(int x) const {
    return sh >= 0 ? x >> sh : x / d;
  }
  __device__ __forceinline__ int r(int x) const {
    return sh >= 0 ? x & (d - 1) : x % d;
  }
};
__device__ __forceinline__ Div make_div(int d) {
  return Div{d, (d & (d - 1)) ? -1 : __ffs(d) - 1};
}

}  // namespace nctt
