// A standalone bandwidth probe for the M == 1 matvecs' streaming core
// (csrc/vpu_gemv.cuh), not part of the kernel library
// (tools/woq_rows.py --probe builds and runs it): how fast the card
// streams a [rows x N] matrix of 32-bit words when blocks own strips of
// `bn` columns and a run of `rows / splits` rows, each warp its share of
// the run through its own ring of `depth` slots of 8 KB (16 rows at most)
// by 16-byte cp.async, and nothing is computed. Prints ms and GB/s for each (N, bn,
// splits, warps, depth), and for the same strips read by 16-byte loads
// into registers, 8 or 16 rows in flight a lane; copies of the matrix
// (200 MiB or more in all)
// rotate so that every launch reads device memory, not L2.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o gemv_probe gemv_probe.cu && ./gemv_probe
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ void wait_dyn(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

// block (strip, split): columns [strip*bn, +bn), rows [split*run, +run);
// warp w its run/warps rows, slot by slot
__global__ void strips(const uint32_t* __restrict__ w, int N, int run,
                       int bn, int depth, unsigned* sink) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x / 32, R = min(16, 2048 / bn), slot = R * bn * 4;
  const int quads = bn / 4;                  // 16-byte pieces a row
  uint8_t* buf = sm + warp * depth * slot;
  const int wr = run / W, r0 = blockIdx.y * run + warp * wr;
  const uint32_t* base = w + (size_t)r0 * N + blockIdx.x * bn;
  const int nst = wr / R;
  auto issue = [&](int q) {
    if (q < nst) {
      uint8_t* dst = buf + (q % depth) * slot;
      for (int i = lane; i < R * quads; i += 32) {
        const int r = i / quads, c = i % quads;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         sa(dst + (r * quads + c) * 16)),
                     "l"(base + (size_t)(q * R + r) * N + c * 4)
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
    acc += buf[(q % depth) * slot + lane * 4];
    __syncwarp();
    issue(q + depth - 1);
  }
  if (acc == 0x12345678) sink[0] = acc;
}

// the same strips read into registers instead: each lane loads U rows of
// its four columns (16-byte loads) while it consumes the U rows before
template <int U>
__global__ void strips_regs(const uint32_t* __restrict__ w, int N, int run,
                            unsigned* sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x / 32;
  const int wr = run / W, r0 = blockIdx.y * run + warp * wr;
  const uint4* base = reinterpret_cast<const uint4*>(
      w + (size_t)r0 * N + blockIdx.x * 128 + 4 * lane);
  const size_t stride = N / 4;
  uint4 cur[U], nxt[U];
#pragma unroll
  for (int u = 0; u < U; ++u) cur[u] = __ldg(base + u * stride);
  unsigned acc = 0;
  for (int r = U; r <= wr; r += U) {
    if (r < wr) {
#pragma unroll
      for (int u = 0; u < U; ++u) nxt[u] = __ldg(base + (r + u) * stride);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += cur[u].x ^ cur[u].y ^ cur[u].z ^ cur[u].w;
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
  if (acc == 0x12345678) sink[0] = acc;
}

int main() {
  struct Shape { int rows, N; };
  const Shape shapes[] = {{512, 4096}, {512, 22016}, {1376, 4096},
                          {512, 32000}};
  struct Cfg { int bn, splits, warps, depth; };
  const Cfg cfgs[] = {{32, 1, 8, 2},   {32, 1, 8, 4},  {64, 1, 8, 2},
                      {128, 1, 4, 2},  {128, 1, 8, 2}, {128, 1, 8, 3},
                      {128, 4, 4, 2},  {512, 1, 8, 2}, {512, 4, 8, 2},
                      {512, 8, 4, 2},  {2048, 8, 8, 2},
                      {2048, 32, 4, 2}};
  unsigned* sink;
  if (cudaMalloc(&sink, 4)) return 1;
  cudaFuncSetAttribute(strips, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       227 * 1024);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (const Shape& s : shapes) {
    const size_t mat = (size_t)s.rows * s.N * 4;
    const int copies = (int)((200u << 20) / mat) + 2, iters = 40;
    uint32_t* w;
    if (cudaMalloc(&w, mat * copies)) return 1;
    cudaMemset(w, 1, mat * copies);
    for (const Cfg& c : cfgs) {
      const int run = s.rows / c.splits, R = c.bn > 128 ? 2048 / c.bn : 16;
      const size_t smem = (size_t)c.warps * c.depth * R * c.bn * 4;
      if (s.N % c.bn || run % (c.warps * R) || smem > 227 * 1024) continue;
      const dim3 grid(s.N / c.bn, c.splits);
      const size_t words = mat / 4;
      for (int i = 0; i < copies; ++i)
        strips<<<grid, 32 * c.warps, smem>>>(w + i * words, s.N, run, c.bn,
                                             c.depth, sink);
      cudaEventRecord(a);
      for (int i = 0; i < iters; ++i)
        strips<<<grid, 32 * c.warps, smem>>>(w + (i % copies) * words, s.N,
                                             run, c.bn, c.depth, sink);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      ms /= iters;
      printf("probe %d x %d words (%.1f MB): bn=%d splits=%d warps=%d "
             "depth=%d blocks=%d: %.4f ms %.0f GB/s (%s)\n", s.rows, s.N,
             mat / 1e6, c.bn, c.splits, c.warps, c.depth,
             grid.x * grid.y, ms, mat / ms / 1e6,
             cudaGetErrorString(cudaGetLastError()));
    }
    // register loads: strips of 128 columns, U rows in flight a lane
    for (int splits : {1, 4}) {
      for (int warps : {4, 8}) {
        for (int u : {8, 16}) {
          const int run = s.rows / splits;
          if (s.N % 128 || run % (warps * u)) continue;
          const dim3 grid(s.N / 128, splits);
          const size_t words = mat / 4;
          auto launch = [&](int i) {
            if (u == 8)
              strips_regs<8><<<grid, 32 * warps>>>(w + (i % copies) * words,
                                                   s.N, run, sink);
            else
              strips_regs<16><<<grid, 32 * warps>>>(w + (i % copies) * words,
                                                    s.N, run, sink);
          };
          for (int i = 0; i < copies; ++i) launch(i);
          cudaEventRecord(a);
          for (int i = 0; i < iters; ++i) launch(i);
          cudaEventRecord(b);
          cudaEventSynchronize(b);
          float ms;
          cudaEventElapsedTime(&ms, a, b);
          ms /= iters;
          printf("probe %d x %d words (%.1f MB): registers bn=128 splits=%d "
                 "warps=%d rows in flight=%d blocks=%d: %.4f ms %.0f GB/s "
                 "(%s)\n", s.rows, s.N, mat / 1e6, splits, warps, u,
                 grid.x * grid.y, ms, mat / ms / 1e6,
                 cudaGetErrorString(cudaGetLastError()));
        }
      }
    }
    cudaFree(w);
  }
  return 0;
}
