// K2: the LYNXNet conv module forward without its residual,
//   y = pw2(PReLU(dwconv(SwiGLU(pw1(LN(x)))) + dw_bias))
// over channel-last x [B, T, C], with pw1 C -> 2I (value columns first, gate
// columns second) and pw2 I -> C. This file holds the two GEMM stages and the
// LN statistics; the depthwise stage is K1 (depthwise_conv.cu), which the
// Python wrapper launches between them.
//
// Replaces the TPU kernel diffsinger_tpu/ops/lynx_fused.py (fused_conv_module,
// Pallas _kernel). Main path: x [16, 1024, 1024] bf16, w1 [4096, 1024],
// w2 [1024, 2048], k = 31; 6 layers x 50 steps = 300 launches per request.
//
// What bounds it on the H100: the tensor cores. The two products are
// 2 * 16384 * (1024 * 4096 + 2048 * 1024) = 206 GFLOP per call, 0.21 ms at
// 989 TFLOP/s bf16, against 0.024 ms to read x and the weights and write y
// once. (This design also writes and reads the intermediates s and z, 268 MB
// more, about 0.08 ms.)
//
// Design: the TPU kernel walks time tiles in order and carries the last k-1
// SwiGLU rows in VMEM; blocks on Hopper run in no order, so nothing is carried.
// Instead the module runs as four launches, each fully parallel:
//   1. ln_stats: one warp per row, mean and 1/sqrt(var + eps) in float32;
//   2. pw1: a tiled GEMM whose prologue normalises x on its way into shared
//      memory (so the LN output never reaches device memory) and whose
//      epilogue adds the bias and applies SwiGLU. Each block computes the value
//      tile and the matching gate tile, so SwiGLU needs no second pass; s
//      [B, T, I] is written once in the compute dtype;
//   3. K1 over s with dw_conv.bias and PReLU (zero padding at each sequence's
//      ends, the conv's own padding; real frames are never masked);
//   4. pw2: a tiled GEMM with a bias epilogue.
// bf16 products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// float32 accumulate) from a register-staged shared-memory tile; float32
// products, kept for exact checks, run on the CUDA cores. Both GEMMs are the
// simple first version: no TMA, no wgmma, no pipelining beyond staging the
// next tile in registers.

#include "common.cuh"

namespace ds {

// ---------------------------------------------------------------- LN stats
template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                                float* __restrict__ rstd, int M, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // uniform across the warp
  const T* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  v = warp_sum(v) / C;
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = 1.f / sqrtf(v + eps);
  }
}

__device__ __forceinline__ float swiglu(float value, float gate) {
  return value * (gate * (1.f / (1.f + expf(-gate))));
}

// Row of W that feeds row r of a B tile BN rows tall, for the output tile
// starting at column n0. With SWIGLU the tile's first BN/2 rows are value
// columns n0.. and the last BN/2 the matching gate columns N + n0..
// (W has 2N rows). Returns -1 past the edge.
template <bool SWIGLU, int BN>
__device__ __forceinline__ int w_row(int r, int n0, int N) {
  if (SWIGLU) {
    const int half = BN / 2;
    const int j = n0 + (r < half ? r : r - half);
    if (j >= N) return -1;
    return r < half ? j : N + j;
  }
  const int n = n0 + r;
  return n < N ? n : -1;
}

// ------------------------------------------------- bf16: tensor-core GEMM
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_LDS = TC_BK + 8;
constexpr int TC_THREADS = 256;  // 8 warps: 2 along M (64 rows) x 4 along N

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B-tile row where n8 tile `ni` (0..3) of warp column `wn` starts. With SWIGLU
// tiles 0, 1 are value columns and 2, 3 the gate columns of the same outputs,
// so one thread holds both halves of each SwiGLU pair.
template <bool SWIGLU>
__device__ __forceinline__ int tc_boff(int wn, int ni) {
  if (SWIGLU) return (ni < 2 ? 0 : TC_BN / 2) + wn * 16 + (ni & 1) * 8;
  return wn * 32 + ni * 8;
}

// out [M, N] = A [M, K] @ W^T + bias, W [N, K]; with SWIGLU, A is normalised
// on load with (mean, rstd, ln_w, ln_b), W is [2N, K], bias [2N], and
// out = value * silu(gate).
template <bool SWIGLU>
__global__ void __launch_bounds__(TC_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const bf16* __restrict__ ln_w,
                 const bf16* __restrict__ ln_b, const bf16* __restrict__ W,
                 const bf16* __restrict__ bias, bf16* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(16) bf16 As[TC_BM][TC_LDS];
  __shared__ __align__(16) bf16 Bs[TC_BN][TC_LDS];
  __shared__ float mean_s[TC_BM], rstd_s[TC_BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * TC_BM;
  const int n0 = blockIdx.y * (SWIGLU ? TC_BN / 2 : TC_BN);

  if (SWIGLU) {
    for (int r = tid; r < TC_BM; r += TC_THREADS) {
      const int m = m0 + r;
      mean_s[r] = m < M ? mean[m] : 0.f;
      rstd_s[r] = m < M ? rstd[m] : 0.f;
    }
    __syncthreads();
  }

  // each thread stages two 16-byte chunks of A and two of B per k tile
  int ld_row[2], ld_col[2], ld_wrow[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int id = tid + p * TC_THREADS;
    ld_row[p] = id >> 2;
    ld_col[p] = (id & 3) * 8;
    ld_wrow[p] = w_row<SWIGLU, TC_BN>(ld_row[p], n0, N);
  }
  uint4 a_reg[2], b_reg[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int m = m0 + ld_row[p];
      a_reg[p] = m < M ? *reinterpret_cast<const uint4*>(A + (size_t)m * K + k0 + ld_col[p]) : zero;
      b_reg[p] = ld_wrow[p] >= 0
                     ? *reinterpret_cast<const uint4*>(W + (size_t)ld_wrow[p] * K + k0 + ld_col[p])
                     : zero;
    }
  };
  auto store = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint4 a = a_reg[p];
      const int r = ld_row[p];
      if (SWIGLU && m0 + r < M) {  // LN prologue, float32 as in the TPU kernel
        bf16* e = reinterpret_cast<bf16*>(&a);
        const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = k0 + ld_col[p] + q;
          e[q] = __float2bfloat16((to_f(e[q]) - mu) * rs * to_f(ln_w[k]) + to_f(ln_b[k]));
        }
      }
      *reinterpret_cast<uint4*>(&As[r][ld_col[p]]) = a;
      *reinterpret_cast<uint4*>(&Bs[r][ld_col[p]]) = b_reg[p];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = K / TC_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load((kt + 1) * TC_BK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < TC_BK; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = lds32(&As[r][ks + t4 * 2]);
        af[mi][1] = lds32(&As[r + 8][ks + t4 * 2]);
        af[mi][2] = lds32(&As[r][ks + t4 * 2 + 8]);
        af[mi][3] = lds32(&As[r + 8][ks + t4 * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = tc_boff<SWIGLU>(wn, ni) + g;
        const uint32_t b0 = lds32(&Bs[n][ks + t4 * 2]);
        const uint32_t b1 = lds32(&Bs[n][ks + t4 * 2 + 8]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
    if (kt + 1 < KT) {
      store((kt + 1) * TC_BK);
      __syncthreads();
    }
  }

  // epilogue: accumulator e of an m16n8 tile sits at row g (+8 for e >= 2),
  // columns 2*t4 and 2*t4 + 1
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm * 64 + mi * 16 + g + hr * 8;
      if (m >= M) continue;
      bf16* orow = out + (size_t)m * N;
      if (SWIGLU) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int n = n0 + wn * 16 + ni * 8 + t4 * 2;
          if (n >= N) continue;  // N is even, so n + 1 < N too
          const float s0 = swiglu(acc[mi][ni][hr * 2] + to_f(bias[n]),
                                  acc[mi][ni + 2][hr * 2] + to_f(bias[N + n]));
          const float s1 = swiglu(acc[mi][ni][hr * 2 + 1] + to_f(bias[n + 1]),
                                  acc[mi][ni + 2][hr * 2 + 1] + to_f(bias[N + n + 1]));
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(s0, s1);
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn * 32 + ni * 8 + t4 * 2;
          if (n >= N) continue;
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(
              acc[mi][ni][hr * 2] + to_f(bias[n]), acc[mi][ni][hr * 2 + 1] + to_f(bias[n + 1]));
        }
      }
    }
  }
}

// -------------------------------------------- float32: CUDA-core GEMM
constexpr int FP_BM = 64, FP_BN = 64, FP_BK = 16, FP_THREADS = 256;

// B-tile row of thread column j (0..3); with SWIGLU j = 0, 1 are value
// columns and j = 2, 3 their gate columns
template <bool SWIGLU>
__device__ __forceinline__ int fp_bcol(int tx, int j) {
  if (SWIGLU) return (j < 2 ? 0 : FP_BN / 2) + tx * 2 + (j & 1);
  return tx * 4 + j;
}

template <bool SWIGLU>
__global__ void __launch_bounds__(FP_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K) {
  __shared__ float As[FP_BK][FP_BM + 4];
  __shared__ float Bs[FP_BK][FP_BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * FP_BM;
  const int n0 = blockIdx.y * (SWIGLU ? FP_BN / 2 : FP_BN);

  const int lr = tid >> 2, lc = (tid & 3) * 4;  // one float4 of A and of B
  const int m_ld = m0 + lr;
  const int w_ld = w_row<SWIGLU, FP_BN>(lr, n0, N);
  float mu = 0.f, rs = 0.f;
  if (SWIGLU && m_ld < M) {
    mu = mean[m_ld];
    rs = rstd[m_ld];
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FP_BK) {
    float4 a = m_ld < M ? *reinterpret_cast<const float4*>(A + (size_t)m_ld * K + k0 + lc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = w_ld >= 0 ? *reinterpret_cast<const float4*>(W + (size_t)w_ld * K + k0 + lc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    if (SWIGLU && m_ld < M) {
      const int k = k0 + lc;
      a.x = (a.x - mu) * rs * ln_w[k] + ln_b[k];
      a.y = (a.y - mu) * rs * ln_w[k + 1] + ln_b[k + 1];
      a.z = (a.z - mu) * rs * ln_w[k + 2] + ln_b[k + 2];
      a.w = (a.w - mu) * rs * ln_w[k + 3] + ln_b[k + 3];
    }
    As[lc][lr] = a.x;
    As[lc + 1][lr] = a.y;
    As[lc + 2][lr] = a.z;
    As[lc + 3][lr] = a.w;
    Bs[lc][lr] = b.x;
    Bs[lc + 1][lr] = b.y;
    Bs[lc + 2][lr] = b.z;
    Bs[lc + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FP_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][fp_bcol<SWIGLU>(tx, j)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float* orow = out + (size_t)m * N;
    if (SWIGLU) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + tx * 2 + e;
        if (n < N) orow[n] = swiglu(acc[i][e] + bias[n], acc[i][2 + e] + bias[N + n]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) orow[n] = acc[i][j] + bias[n];
      }
    }
  }
}

template <bool SWIGLU>
int launch_gemm(int dtype, const void* A, const void* mean, const void* rstd,
                const void* ln_w, const void* ln_b, const void* W, const void* bias,
                void* out, int M, int N, int K, cudaStream_t s) {
  if (K % TC_BK != 0 || N % 2 != 0) return (int)cudaErrorInvalidValue;
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  if (dtype == 1) {
    const int cols = SWIGLU ? TC_BN / 2 : TC_BN;
    const dim3 grid((M + TC_BM - 1) / TC_BM, (N + cols - 1) / cols);
    gemm_bf16_kernel<SWIGLU><<<grid, TC_THREADS, 0, s>>>(
        static_cast<const bf16*>(A), mu, rs, static_cast<const bf16*>(ln_w),
        static_cast<const bf16*>(ln_b), static_cast<const bf16*>(W),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K);
  } else if (dtype == 0) {
    const int cols = SWIGLU ? FP_BN / 2 : FP_BN;
    const dim3 grid((M + FP_BM - 1) / FP_BM, (N + cols - 1) / cols);
    gemm_f32_kernel<SWIGLU><<<grid, FP_THREADS, 0, s>>>(
        static_cast<const float*>(A), mu, rs, static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<const float*>(W),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace ds

// mean, rstd: [M] float32 statistics of the rows of x [M, C].
extern "C" int ds_lynx_ln_stats(const void* x, void* mean, void* rstd, int M, int C,
                                float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = 8;  // one warp per row
  const dim3 grid((M + rows_per_block - 1) / rows_per_block);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (dtype == 0)
    ds::ln_stats_kernel<float><<<grid, 32 * rows_per_block, 0, s>>>(
        static_cast<const float*>(x), mu, rs, M, C, eps);
  else if (dtype == 1)
    ds::ln_stats_kernel<ds::bf16><<<grid, 32 * rows_per_block, 0, s>>>(
        static_cast<const ds::bf16*>(x), mu, rs, M, C, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// s [M, I] = SwiGLU(LN(x) @ w1^T + b1): x [M, C], w1 [2I, C], b1 [2I].
extern "C" int ds_lynx_pw1_swiglu(const void* x, const void* mean, const void* rstd,
                                  const void* ln_w, const void* ln_b, const void* w1,
                                  const void* b1, void* s, int M, int C, int I, int dtype,
                                  void* stream) {
  return ds::launch_gemm<true>(dtype, x, mean, rstd, ln_w, ln_b, w1, b1, s, M, I, C,
                               static_cast<cudaStream_t>(stream));
}

// y [M, C] = z @ w2^T + b2: z [M, I], w2 [C, I], b2 [C].
extern "C" int ds_lynx_pw2(const void* z, const void* w2, const void* b2, void* y, int M,
                           int I, int C, int dtype, void* stream) {
  return ds::launch_gemm<false>(dtype, z, nullptr, nullptr, nullptr, nullptr, w2, b2, y, M,
                                C, I, static_cast<cudaStream_t>(stream));
}
