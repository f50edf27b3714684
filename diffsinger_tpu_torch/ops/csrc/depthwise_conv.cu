// K1: 'same'-padded depthwise 1-D convolution + optional bias + per-channel
// PReLU over channel-last x [B, T, C].
//
// Replaces the TPU kernel diffsinger_tpu/ops/depthwise_conv.py
// (depthwise_conv1d_prelu, Pallas _kernel). On the main path it is the middle
// stage of K2 (lynx_fused.cu): s [16, 1024, 2048] bf16, k = 31, 300 launches
// per request.
//
// What bounds it on the H100: memory, narrowly. Each output element costs k
// float32 multiply-adds (2k = 62 operations) over 2 bytes read and 2 written,
// about 15 operations per byte, under the card's 20 (67 TFLOP/s float32 over
// 3.35 TB/s). The floor is the 134 MB moved at [16, 1024, 2048] bf16: about
// 0.04 ms, against 0.031 ms for the arithmetic.
//
// Design: a block owns a 64-row time tile of 64 channels. It stages the tile
// plus its k-1 halo rows, converted to float32, and the channels' taps in
// shared memory (reads coalesced along channels), so each input element is
// read from device memory about (64 + k - 1) / 64 times instead of k times.
// Each thread then owns one channel and 16 output rows and accumulates the
// taps in float32, in tap order, as the TPU kernel does. Zero padding is
// applied at the staging step, so no sequence reads a neighbour's rows.

#include "common.cuh"

namespace ds {

constexpr int DW_CT = 64;        // channels per block
constexpr int DW_TT = 64;        // output rows per block
constexpr int DW_THREADS = 256;  // 64 channels x 4 groups of 16 rows
constexpr int DW_MAX_K = 61;     // keeps the staged tile under 48 KB

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dwconv_prelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ alpha,
                    T* __restrict__ out, int T_len, int C, int K) {
  extern __shared__ float smem[];
  const int win = DW_TT + K - 1;
  float* xs = smem;               // [win][DW_CT]
  float* ws = smem + win * DW_CT;  // [K][DW_CT]
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * DW_TT;
  const int c0 = blockIdx.x * DW_CT;
  const int pad_l = K / 2;
  const T* xb = x + (size_t)b * T_len * C;

  for (int i = threadIdx.x; i < win * DW_CT; i += DW_THREADS) {
    const int r = i / DW_CT, cc = i % DW_CT;
    const int t = t0 - pad_l + r, c = c0 + cc;
    xs[i] = (t >= 0 && t < T_len && c < C) ? to_f(xb[(size_t)t * C + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < K * DW_CT; i += DW_THREADS) {
    const int j = i / DW_CT, cc = i % DW_CT, c = c0 + cc;
    ws[i] = c < C ? to_f(w[(size_t)c * K + j]) : 0.f;  // w is [C, K]
  }
  __syncthreads();

  const int cc = threadIdx.x % DW_CT;
  const int c = c0 + cc;
  if (c >= C) return;
  constexpr int ROWS = DW_TT / (DW_THREADS / DW_CT);
  const int r0 = (threadIdx.x / DW_CT) * ROWS;
  const float bv = bias ? to_f(bias[c]) : 0.f;
  const float av = to_f(alpha[c]);
  T* ob = out + (size_t)b * T_len * C;
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = r0 + rr, t = t0 + r;
    if (t >= T_len) break;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc += xs[(r + j) * DW_CT + cc] * ws[j * DW_CT + cc];
    acc += bv;
    acc = acc >= 0.f ? acc : av * acc;
    ob[(size_t)t * C + c] = from_f<T>(acc);
  }
}

template <typename T>
int launch_dwconv(const void* x, const void* w, const void* bias, const void* alpha,
                  void* out, int B, int T_len, int C, int K, cudaStream_t stream) {
  const dim3 grid((C + DW_CT - 1) / DW_CT, (T_len + DW_TT - 1) / DW_TT, B);
  const size_t smem = (size_t)(DW_TT + 2 * K - 1) * DW_CT * sizeof(float);
  dwconv_prelu_kernel<T><<<grid, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(alpha), static_cast<T*>(out), T_len, C, K);
  return (int)cudaGetLastError();
}

}  // namespace ds

// x, out: [B, T, C]; w: [C, K] taps; bias (may be null), alpha: [C]; all of
// one element type (dtype 0 = float32, 1 = bfloat16). Returns the CUDA error.
extern "C" int ds_dwconv_prelu(const void* x, const void* w, const void* bias,
                               const void* alpha, void* out, int B, int T, int C,
                               int K, int dtype, void* stream) {
  if (K < 1 || K > ds::DW_MAX_K) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ds::launch_dwconv<float>(x, w, bias, alpha, out, B, T, C, K, s);
  if (dtype == 1) return ds::launch_dwconv<ds::bf16>(x, w, bias, alpha, out, B, T, C, K, s);
  return (int)cudaErrorInvalidValue;
}
