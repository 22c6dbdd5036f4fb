// A standalone bandwidth probe for the W4A8 core, not part of the kernel
// library (tools/w4a8_core_sweep.py --probe builds and runs it): how fast the card streams a [rows x 2048 B]
// matrix (4096 rows: 8 MiB, llama2-7b's o projection in "hopper_nk"
// words; 32768 rows: 64 MiB, a long stream; `./stream_probe rows`), when
// warps copy `seg` bytes from each of 16 or 64 rows a stage by 16-byte
// cp.async into a ring of `depth` stages and compute nothing (the W4A8
// core's access pattern), against plain 16-byte loads of the same bytes
// in order. Prints ms and GB/s a configuration; copies of the matrix
// (200 MiB or more in all) rotate so that every launch reads device
// memory, not L2.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o stream_probe stream_probe.cu && ./stream_probe 4096
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
template <int N>
__device__ __forceinline__ void wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ void wait_dyn(int n) {
  switch (n) {
    case 0: wait_n<0>(); break;
    case 1: wait_n<1>(); break;
    case 2: wait_n<2>(); break;
    case 3: wait_n<3>(); break;
    case 4: wait_n<4>(); break;
    case 5: wait_n<5>(); break;
    case 6: wait_n<6>(); break;
    default: wait_n<7>();
  }
}

// block b covers rows [b*nrow, +nrow); warp w takes row bytes [w*span,
// (w+1)*span); a stage is `seg` bytes of each of the block's rows
__global__ void ring(const uint8_t* __restrict__ w, size_t rowbytes,
                     int nrow, int seg, int span, int depth,
                     unsigned* sink) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stage_b = nrow * seg;
  uint8_t* buf = sm + warp * depth * stage_b;
  const uint8_t* base =
      w + (size_t)blockIdx.x * nrow * rowbytes + (size_t)warp * span;
  const int nst = span / seg, chunks = stage_b / 16, cpr = seg / 16;
  auto issue = [&](int q) {
    if (q < nst) {
      uint8_t* dst = buf + (q % depth) * stage_b;
      for (int i = lane; i < chunks; i += 32) {
        const int r = i / cpr, c = i % cpr;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         sa(dst + r * seg + c * 16)),
                     "l"(base + (size_t)r * rowbytes + (size_t)q * seg +
                         c * 16)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int q = 0; q < depth - 1; ++q) issue(q);
  unsigned acc = 0;
  for (int q = 0; q < nst; ++q) {
    wait_dyn(depth - 2);
    __syncwarp();
    acc += buf[(q % depth) * stage_b + lane * 4];
    __syncwarp();
    issue(q + depth - 1);
  }
  if (acc == 0x12345678) sink[0] = acc;
}

__global__ void contiguous(const uint4* __restrict__ w, size_t n,
                           unsigned* sink) {
  unsigned acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = w[i];
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678) sink[0] = acc;
}

int main(int argc, char** argv) {
  const size_t rows = argc > 1 ? (size_t)atol(argv[1]) : 4096;
  const size_t rowbytes = 2048, mat = rows * rowbytes;
  const int copies = (int)((200u << 20) / mat) + 2, iters = 48;
  uint8_t* w;
  unsigned* sink;
  if (cudaMalloc(&w, mat * copies) || cudaMalloc(&sink, 4)) return 1;
  cudaMemset(w, 1, mat * copies);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaFuncSetAttribute(ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       227 * 1024);
  struct Cfg { int nrow, seg, warps, depth; };
  const Cfg cfgs[] = {{16, 64, 4, 4},  {16, 64, 4, 8},   {16, 64, 8, 8},
                      {16, 128, 4, 4}, {16, 256, 4, 4},  {16, 512, 2, 6},
                      {64, 64, 4, 4},  {64, 256, 4, 3},  {16, 2048, 1, 3}};
  for (const Cfg& c : cfgs) {
    const int span = rowbytes / c.warps, blocks = rows / c.nrow;
    const size_t smem = (size_t)c.warps * c.depth * c.nrow * c.seg;
    for (int i = 0; i < copies; ++i)
      ring<<<blocks, 32 * c.warps, smem>>>(w + i * mat, rowbytes, c.nrow,
                                           c.seg, span, c.depth, sink);
    cudaEventRecord(a);
    for (int i = 0; i < iters; ++i)
      ring<<<blocks, 32 * c.warps, smem>>>(w + (i % copies) * mat, rowbytes,
                                           c.nrow, c.seg, span, c.depth,
                                           sink);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    ms /= iters;
    printf("%zu MiB ring rows/block=%d seg=%d warps=%d depth=%d: %.4f ms "
           "%.0f GB/s (%s)\n", mat >> 20, c.nrow, c.seg, c.warps, c.depth,
           ms, mat / ms / 1e6,
           cudaGetErrorString(cudaGetLastError()));
  }
  for (int threads : {256, 512, 1024}) {
    cudaEventRecord(a);
    for (int i = 0; i < iters; ++i)
      contiguous<<<132 * 4, threads>>>(
          (const uint4*)(w + (i % copies) * mat), mat / 16, sink);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    ms /= iters;
    printf("%zu MiB contiguous 16-byte loads, %d threads a block: %.4f ms "
           "%.0f GB/s (%s)\n", mat >> 20, threads, ms, mat / ms / 1e6,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
