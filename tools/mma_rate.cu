// The rate and latency of mma.sync.m16n8k8 tf32 on the card, for
// tools/perf_torch_kernels.py mmarate: each warp runs `chains` independent
// chains of dependent products on register operands (nothing is loaded), so
// one chain a warp measures the latency and many measure the throughput.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS>
__global__ void mma_rate_kernel(float* out, int iters) {
  float d[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, threadIdx.x};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma_tf32(d[c], a, b);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][3];
  if (s == 1.2345f) out[threadIdx.x] = s;  // keeps the products; never true in practice
}

// chains is 1 or 8; returns the cudaError_t of the launch
extern "C" int mma_rate(float* out, int blocks, int threads, int iters, int chains) {
  if (chains == 1) mma_rate_kernel<1><<<blocks, threads>>>(out, iters);
  else mma_rate_kernel<8><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
