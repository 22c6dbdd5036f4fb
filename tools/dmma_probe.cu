// A standalone probe of the card's float64 matrix instructions, not part of
// the kernel library (tools/latent_attn_sweep.py --probe builds and runs
// it, one binary a shape): whether this nvcc takes `mma.sync` on .f64
// operands at the shape -DKM selects for sm_90a (KM 0: m8n8k4, the sm_80
// shape; KM 4, 8, 16: m16n8k4, m16n8k8, m16n8k16), whether the fragment
// layouts K14's attention kernels assume (csrc/paged_latent.cuh, mma)
// give the exact product of two integer matrices, and the rate of each
// shape against float64 FMAs on the CUDA cores, in TFLOP/s, every SM's
// warps issuing independent chains from registers.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -DKM=16 \
//       -o dmma_probe dmma_probe.cu && ./dmma_probe
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>

#ifndef KM
#define KM 4
#endif

constexpr int MR = KM ? 16 : 8;     // rows of A and C
constexpr int KK = KM ? KM : 4;     // depth
constexpr int NA = MR * KK / 32;    // A values a lane
constexpr int NB = KK * 8 / 32;     // B values a lane
constexpr int NC = MR * 8 / 32;     // C values a lane

__device__ __forceinline__ void mma(double (&c)[NC], const double (&a)[NA],
                                    const double (&b)[NB]) {
#if KM == 0
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a[0]), "d"(b[0]));
#elif KM == 4
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
#elif KM == 8
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
#endif
}

// the layouts: lane = 4 * g + t; A value i at (row, col), B value i at
// (row k, col n), C value i at (row, col)
__host__ __device__ void a_at(int lane, int i, int& row, int& col) {
  const int g = lane >> 2, t = lane & 3;
  if (!KM) { row = g; col = t; return; }
  row = g + 8 * (i & 1);
  col = t + 4 * (i >> 1);
}
__host__ __device__ void b_at(int lane, int i, int& k, int& n) {
  const int g = lane >> 2, t = lane & 3;
  k = t + 4 * i;
  n = g;
}
__host__ __device__ void c_at(int lane, int i, int& row, int& col) {
  const int g = lane >> 2, t = lane & 3;
  row = g + 8 * (i >> 1);
  col = 2 * t + (i & 1);
}

__global__ void layout(const double* A, const double* B, double* C) {
  const int lane = threadIdx.x;
  double a[NA], b[NB], c[NC];
  for (int i = 0; i < NA; ++i) {
    int r, k;
    a_at(lane, i, r, k);
    a[i] = A[r * KK + k];
  }
  for (int i = 0; i < NB; ++i) {
    int k, n;
    b_at(lane, i, k, n);
    b[i] = B[k * 8 + n];
  }
  for (int i = 0; i < NC; ++i) c[i] = 0.0;
  mma(c, a, b);
  for (int i = 0; i < NC; ++i) {
    int r, n;
    c_at(lane, i, r, n);
    C[r * 8 + n] = c[i];
  }
}

// CH independent accumulator tiles a warp, `iters` MMAs on each
constexpr int CH = 8;
__global__ void rate_mma(int iters, double* sink) {
  double a[NA], b[NB], c[CH][NC];
  for (int i = 0; i < NA; ++i) a[i] = 1.0 + threadIdx.x * 1e-3 + i;
  for (int i = 0; i < NB; ++i) b[i] = 1e-9 * (i + 1);
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < NC; ++i) c[j][i] = j;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < CH; ++j) mma(c[j], a, b);
  double s = 0.0;
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < NC; ++i) s += c[j][i];
  if (s == 12345.678) sink[0] = s;
}

__global__ void rate_fma(int iters, double* sink) {
  double x = 1.0 + threadIdx.x * 1e-3, y = 1e-9, c[CH];
  for (int j = 0; j < CH; ++j) c[j] = j;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < CH; ++j) c[j] = fma(x, y, c[j]);
  double s = 0.0;
  for (int j = 0; j < CH; ++j) s += c[j];
  if (s == 12345.678) sink[0] = s;
}

int main() {
  double hA[MR * KK], hB[KK * 8], hC[MR * 8], want[MR * 8];
  srand(7);
  for (int i = 0; i < MR * KK; ++i) hA[i] = rand() % 17 - 8;
  for (int i = 0; i < KK * 8; ++i) hB[i] = rand() % 17 - 8;
  for (int r = 0; r < MR; ++r)
    for (int n = 0; n < 8; ++n) {
      double s = 0.0;
      for (int k = 0; k < KK; ++k) s += hA[r * KK + k] * hB[k * 8 + n];
      want[r * 8 + n] = s;
    }
  double *A, *B, *C, *sink;
  cudaMalloc(&A, sizeof hA);
  cudaMalloc(&B, sizeof hB);
  cudaMalloc(&C, sizeof hC);
  cudaMalloc(&sink, 8);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout<<<1, 32>>>(A, B, C);
  cudaMemcpy(hC, C, sizeof hC, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < MR * 8; ++i) bad += hC[i] != want[i];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096, threads = 256;
  printf("shape m%dn8k%d: layout %s (%d of %d wrong)", MR, KK,
         bad ? "WRONG" : "exact", bad, MR * 8);
  // 256-thread blocks, 1, 2 and 4 an SM (8, 16 and 32 warps an SM)
  for (int per_sm = 1; per_sm <= 4; per_sm *= 2) {
    const int blocks = sms * per_sm;
    float best_mma = 1e30f, best_fma = 1e30f;
    for (int rep = 0; rep < 3; ++rep) {
      float ms;
      cudaEventRecord(e0);
      rate_mma<<<blocks, threads>>>(iters, sink);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&ms, e0, e1);
      best_mma = ms < best_mma ? ms : best_mma;
      cudaEventRecord(e0);
      rate_fma<<<blocks, threads>>>(iters, sink);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&ms, e0, e1);
      best_fma = ms < best_fma ? ms : best_fma;
    }
    const double warps = blocks * threads / 32.0;
    const double mma_flops = warps * iters * CH * 2.0 * MR * 8 * KK;
    const double fma_flops = blocks * threads * (double)iters * CH * 2.0;
    printf("; %d warps an SM: mma %.2f, cuda-core fma %.2f TFLOP/s",
           8 * per_sm, mma_flops / best_mma / 1e9,
           fma_flops / best_fma / 1e9);
  }
  const cudaError_t err = cudaGetLastError();
  printf("; %s\n", cudaGetErrorString(err));
  return bad || err != cudaSuccess;
}
