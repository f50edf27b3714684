// K4: the WaveNet's residual blocks in float32, at inference, over
// channel-last activations [B, T, C]. Block i computes
//   y    = dilated_conv(x + d_i)             (k = 3, zero padding = dilation)
//   z    = sigmoid(y[:C] + bias + cond[:C]) * tanh(y[C:] + bias + cond[C:])
//   o    = z @ W_out^T + b_out               (1x1, C -> 2C)
//   x'   = (x + o[:C]) * (1 / sqrt(2)),  skip_sum += o[C:]
// as two kernels: A (the conv and the gate) and B (the output projection,
// the residual, the skip sum, and x' + d_{i+1}, the next block's conv input).
//
// Replaces no TPU kernel: the JAX package computes the WaveNet
// (diffsinger_tpu/models/backbones/wavenet.py) as XLA ops outside any Pallas
// kernel. It was added because stock PyTorch spends about sixteen launches a
// block on the card (cuDNN's implicit-GEMM conv with transposed copies around
// it, the adds, the gate, the 1x1 projection, the residual and skip sums), and
// the pitch WaveNet (20 x 256) holds nearly all of the variance model's device
// time at inference.
//
// What bounds it on the H100: the float32 CUDA cores. The configuration runs
// float32 with TF32 off, and no Hopper tensor-core instruction takes float32,
// so the products are FMAs at 67 TFLOP/s. Kernel A is 2 * M * 3C * 2C FLOP
// (M = B * T), kernel B 2 * M * C * 2C: at [16, 1024, 256] 12.9 and 4.3 GFLOP,
// 0.192 and 0.064 ms, against 0.03 ms to move their operands once.
//
// Design: a SIMT GEMM per kernel. An output tile is 64 frames of one batch
// row by 128 columns, for 128 threads with 8 x 8 outputs each in registers;
// four blocks share an SM, and the small tile keeps the last wave of a grid
// full at the served chunks' sizes. K runs in chunks of 16 through a ring of
// three stages in shared memory filled with cp.async (two chunks in flight
// while one is multiplied, one barrier a chunk). A chunk of A is kept
// frame-major (16 + 4 floats a frame: no bank conflict), W k-major, so a
// thread reads its 8 frames x 4 k and its 8 columns as 16-byte words.
//   - The tile's 128 columns are 64 channels and their partners C further on
//     (gate and filter in A, residual and skip in B), so each thread holds
//     both halves of its 4 channels and applies the epilogue in registers:
//     nothing of [B, T, 2C] reaches device memory.
//   - Kernel A's K runs tap by tap (k = tap * C + ci, the weights re-laid once
//     as [3C, 2C]); a chunk of one tap is rows of x + d shifted by
//     (tap - 1) * dilation, so the conv needs no im2col copy, and cp.async
//     zero-fills the rows outside [0, T): F.conv1d's zero padding of x + d.
//     x + d comes from the previous block's kernel B (the first block's from
//     one stock add), rounded once as the stock x + d is. Adding d in shared
//     memory instead cost kernel A 15 % on the card.
//   - sigmoid and tanh use expf and tanhf and an IEEE division, as PyTorch's
//     own kernels do; the residual is scaled by the float32 reciprocal of
//     sqrt(2), as PyTorch's CUDA division by a Python scalar does.
//   - Kernel B writes x' and x' + d_{i+1} to their own tensors and updates
//     skip_sum in place (the first block writes it): each element is read and
//     written by one thread.
// The wrapper takes C a multiple of 64, any T and any dilation. Products run
// in float32 FMAs only: no mma or wgmma. Tried on the card and dropped: tiles
// of 128 frames (as fast on full grids, 12-22 % slower where the last wave is
// part full), and chunks staged through registers (19-23 % slower on the
// kernels than cp.async at 64 frames).

#include "common.cuh"

namespace ds {

constexpr int WN_BM = 64;         // frames of an output tile
constexpr int WN_BN = 128;        // columns: 64 channels + their 64 partners
constexpr int WN_BK = 16;         // K of a chunk
constexpr int WN_STAGES = 3;      // chunks in shared memory
constexpr int WN_THREADS = 128;   // 8 x 8 outputs each
constexpr int WN_APITCH = WN_BK + 4;

struct WaveNetArgs {
  const float* a;       // A: x + d [B, T, C]; B: z [B, T, C]
  const float* w;       // A: [3C, 2C]; B: [C, 2C] (k-major)
  const float* bias;    // [2C]
  const float* cond;    // A: the hoisted conditioner projection [B, T, 2C]
  const float* x;       // B: the block's input [B, T, C]
  const float* d_next;  // B: the next block's step projection [B, C] (rows d_stride
                        // apart), or null
  float* out;           // A: z [B, T, C]; B: x' [B, T, C]
  float* skip;          // B: skip_sum [B, T, C]
  float* xd_next;       // B: x' + d_next [B, T, C], or null
  int T, C, dilation, skip_init, d_stride;
  float scale;          // B: the float32 reciprocal of sqrt(2)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// CONV: kernel A (dilated conv + gate); else kernel B (output projection,
// residual, skip sum, the next block's input).
template <bool CONV>
__global__ void __launch_bounds__(WN_THREADS, 4) wavenet_block_kernel(const WaveNetArgs p) {
  constexpr int A_WORDS = WN_BM * WN_BK / 4 / WN_THREADS;  // 16-byte words a thread a chunk
  constexpr int B_WORDS = WN_BK * WN_BN / 4 / WN_THREADS;
  __shared__ __align__(16) float As[WN_STAGES][WN_BM][WN_APITCH];
  __shared__ __align__(16) float Bs[WN_STAGES][WN_BK][WN_BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // columns 4tx.., 64 + 4tx..; frames 4ty.., 32 + 4ty..
  const int b = blockIdx.z, t0 = blockIdx.x * WN_BM, c0 = blockIdx.y * (WN_BN / 2);
  const int T = p.T, C = p.C, N = 2 * C;
  const int nk = (CONV ? 3 * C : C) / WN_BK;
  const float* a_rows = p.a + (size_t)b * T * C;

  // chunk kc into its stage: word f of A is frame f / 4, channels 4 (f % 4)..
  // of the chunk; word f of W is row f / 32, columns 4 (f % 32).. of the tile
  // (words 0-15 channels c0.., words 16-31 their partners C + c0..)
  auto load_chunk = [&](int kc) {
    const int stage = kc % WN_STAGES, k0 = kc * WN_BK;
    int ci = k0, shift = 0;
    if (CONV) {
      const int tap = k0 / C;
      ci = k0 - tap * C;
      shift = (tap - 1) * p.dilation;
    }
#pragma unroll
    for (int i = 0; i < A_WORDS; ++i) {
      const int f = tid + i * WN_THREADS, m = f >> 2, q = f & 3;
      const int row = t0 + m + shift;
      const bool valid = row >= 0 && row < T;
      cp_async16(&As[stage][m][4 * q], a_rows + (size_t)(valid ? row : 0) * C + ci + 4 * q,
                 valid);
    }
#pragma unroll
    for (int i = 0; i < B_WORDS; ++i) {
      const int f = tid + i * WN_THREADS, k = f >> 5, q = f & 31;
      const int col = q < 16 ? c0 + 4 * q : C + c0 + 4 * (q - 16);
      cp_async16(&Bs[stage][k][4 * q], p.w + (size_t)(k0 + k) * N + col, true);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < WN_STAGES - 1; ++s) {
    if (s < nk) load_chunk(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<WN_STAGES - 2>();  // this thread's copies of chunk kc have landed
    __syncthreads();  // everyone's have, and chunk kc - 1 is no longer read
    if (kc + WN_STAGES - 1 < nk) load_chunk(kc + WN_STAGES - 1);
    cp_async_commit();
    const int stage = kc % WN_STAGES;
#pragma unroll
    for (int k4 = 0; k4 < WN_BK; k4 += 4) {
      float4 a[8];  // frames 4ty + i and 32 + 4ty + i, k4..k4 + 3
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = ld4(&As[stage][i < 4 ? 4 * ty + i : WN_BM / 2 + 4 * ty + i - 4][k4]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 b0 = ld4(&Bs[stage][k4 + k][4 * tx]);
        const float4 b1 = ld4(&Bs[stage][k4 + k][WN_BN / 2 + 4 * tx]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = at(a[i], k);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: acc[i][j] and acc[i][j + 4] are channel c + j and its partner
  const int c = c0 + 4 * tx;
  const float4 bias_lo = ld4(p.bias + c), bias_hi = ld4(p.bias + C + c);
  float4 dn = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!CONV && p.xd_next) dn = ld4(p.d_next + (size_t)b * p.d_stride + c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + (i < 4 ? 4 * ty + i : WN_BM / 2 + 4 * ty + i - 4);
    if (t >= T) continue;
    const size_t row = (size_t)b * T + t;
    float v[4];
    if (CONV) {
      const float4 cg = ld4(p.cond + row * N + c), cf = ld4(p.cond + row * N + C + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gate = (acc[i][j] + at(bias_lo, j)) + at(cg, j);
        const float filt = (acc[i][j + 4] + at(bias_hi, j)) + at(cf, j);
        v[j] = (1.f / (1.f + expf(-gate))) * tanhf(filt);
      }
    } else {
      const float4 xv = ld4(p.x + row * C + c);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (!p.skip_init) {
        const float4 sk = ld4(p.skip + row * C + c);
        s[0] = sk.x; s[1] = sk.y; s[2] = sk.z; s[3] = sk.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (at(xv, j) + (acc[i][j] + at(bias_lo, j))) * p.scale;
        const float skip = acc[i][j + 4] + at(bias_hi, j);
        s[j] = p.skip_init ? skip : s[j] + skip;
      }
      st4(p.skip + row * C + c, make_float4(s[0], s[1], s[2], s[3]));
      if (p.xd_next)
        st4(p.xd_next + row * C + c,
            make_float4(v[0] + dn.x, v[1] + dn.y, v[2] + dn.z, v[3] + dn.w));
    }
    st4(p.out + row * C + c, make_float4(v[0], v[1], v[2], v[3]));
  }
}

template <bool CONV>
int launch(const WaveNetArgs& p, int B, cudaStream_t s) {
  const dim3 grid((p.T + WN_BM - 1) / WN_BM, p.C / (WN_BN / 2), B);
  wavenet_block_kernel<CONV><<<grid, WN_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace ds

// Kernel A: z [B, T, C] = sigmoid(gate) * tanh(filter) of the dilated conv of
// xd = x + d over w_conv [3C, 2C] (row tap * C + ci), plus bias_conv and cond.
extern "C" int ds_wavenet_conv_gate(const void* xd, const void* w_conv, const void* bias_conv,
                                    const void* cond, void* z, int B, int T, int C,
                                    int dilation, void* stream) {
  if (C % 64 || T <= 0 || B <= 0 || B > 65535 || dilation <= 0)
    return (int)cudaErrorInvalidValue;
  ds::WaveNetArgs p{};
  p.a = static_cast<const float*>(xd);
  p.w = static_cast<const float*>(w_conv);
  p.bias = static_cast<const float*>(bias_conv);
  p.cond = static_cast<const float*>(cond);
  p.out = static_cast<float*>(z);
  p.T = T;
  p.C = C;
  p.dilation = dilation;
  return ds::launch<true>(p, B, static_cast<cudaStream_t>(stream));
}

// Kernel B: o = z @ w_out + bias_out (w_out [C, 2C]); x_out = (x + o[:C]) *
// scale; skip_sum = o[C:] (skip_init) or skip_sum + o[C:], in place; where
// d_next is given (row b at d_next + b * d_stride), xd_next = x_out + d_next[b].
extern "C" int ds_wavenet_out_skip(const void* z, const void* w_out, const void* bias_out,
                                   const void* x, void* x_out, void* skip_sum, int skip_init,
                                   float scale, const void* d_next, void* xd_next, int d_stride,
                                   int B, int T, int C, void* stream) {
  if (C % 64 || T <= 0 || B <= 0 || B > 65535 || (d_next == nullptr) != (xd_next == nullptr) ||
      d_stride % 4)
    return (int)cudaErrorInvalidValue;
  ds::WaveNetArgs p{};
  p.a = static_cast<const float*>(z);
  p.w = static_cast<const float*>(w_out);
  p.bias = static_cast<const float*>(bias_out);
  p.x = static_cast<const float*>(x);
  p.d_next = static_cast<const float*>(d_next);
  p.out = static_cast<float*>(x_out);
  p.skip = static_cast<float*>(skip_sum);
  p.xd_next = static_cast<float*>(xd_next);
  p.T = T;
  p.C = C;
  p.skip_init = skip_init;
  p.d_stride = d_stride;
  p.scale = scale;
  return ds::launch<false>(p, B, static_cast<cudaStream_t>(stream));
}
