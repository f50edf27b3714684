// K1: 'same'-padded depthwise 1-D convolution + optional bias + an activation
// over channel-last x [B, T, C]: per-channel PReLU (LYNXNet's default), SiLU or
// ReLU, chosen at compile time (LYNXNet's `activation`).
//
// Replaces the TPU kernel diffsinger_tpu/ops/depthwise_conv.py
// (depthwise_conv1d_prelu, Pallas _kernel). On the main path it is the middle
// stage of K2 (lynx_fused.cu): s [16, 1024, 2048] bf16, k = 31, 300 launches
// per request.
//
// What bounds it on the H100. By the card's peaks it is a draw: each output
// costs k float32 multiply-adds over 2 bytes read and 2 written, 0.031 ms of
// arithmetic against 0.040 ms for the 134 MB at [16, 1024, 2048] bf16. What a
// kernel meets first, though, is shared memory's return path: an SM does 128
// float32 multiply-adds a clock and shared memory returns 32 words a clock,
// so a thread must do 4 multiply-adds for every word it loads. A loop that
// loads an input and a tap for each multiply-add does 0.5 and runs at 7.4x
// the bound (0.297 ms: the generic kernel below). With the words out of the
// way the limit is the instruction slots of the float32 pipe, one a
// clock and scheduler: every unpack, PReLU, shuffle or address instruction
// takes a slot from a multiply-add (three quarters of the tile kernel's
// instructions are multiply-adds). Then bytes: a plain copy of the tensor
// takes 0.047 ms on the card, not the 0.040 ms of the data sheet.
//
// Design of the tile kernel (k known at compile time: 7 and 31, the sizes the
// shipped configs use; C a multiple of 8):
// - A thread owns two neighbouring channels (one 4-byte word of bf16) and
//   chunks of R = 16 consecutive output rows. Its 2 k taps and 2 R
//   accumulators live in registers; each of the R + k - 1 input words is
//   loaded once and feeds up to k accumulators of each channel: 46 words for
//   992 multiply-adds at k = 31 (21 a word), 22 for 224 at k = 7 (10 a word).
//   The loops are fully unrolled, so every index is a constant. An
//   accumulator receives its taps in the order j = 0..k-1, as the plain
//   version and the TPU kernel add them; bf16 products are exact in float32,
//   so the kernel agrees with the plain version to the bit.
// - A tile is 64 or 128 output rows of 64 channels, kept in shared memory in
//   the input dtype: its rows + k - 1 input rows arrive by 16-byte cp.async,
//   a warp reading whole 128-byte lines. Rows before 0 or past T are
//   zero-filled there, so the padding is the conv's own and no sequence reads
//   a neighbour's rows. The channels' taps are one contiguous run of w and
//   arrive the same way; a lane reads its taps at a stride of k words, which
//   is odd, so without bank conflicts.
// - Loads overlap arithmetic in two ways. A block walks `span` consecutive
//   tiles of one sequence with two stages in shared memory: the copy of the
//   next tile is in flight while the four warps work on this one. And four
//   blocks (128 threads of at most 128 registers, 45 KB) share an SM, so a
//   block that waits at a barrier leaves the pipe to the other three. The
//   wrapper picks rows and span so that the grid has a block for each of the
//   528 slots (ops/depthwise_conv.py::choose_tile).
// - Stores: the four lanes of a quad hold 8 neighbouring channels of 4 rows;
//   they transpose their bf16 pairs with 4 shuffles, so that a lane stores 16
//   bytes and a warp four whole 128-byte lines (float32: 8 bytes a lane, a
//   warp one 256-byte run).
//
// Any other k (1..61) or width goes to the generic kernel (k at run time, one
// channel a thread, both operands of every multiply-add from shared memory).

#include "common.cuh"

namespace ds {

// the epilogue's activation, a template argument of both kernels; alpha (the
// PReLU slopes) is read only for ACT_PRELU
enum : int { ACT_PRELU = 0, ACT_SILU = 1, ACT_RELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float v, float a) {
  if constexpr (ACT == ACT_PRELU) {
    return v >= 0.f ? v : a * v;
  } else if constexpr (ACT == ACT_SILU) {
    // a fast exponential and a fast division (a reciprocal and a product)
    // keep the epilogue to a few instructions an output, where an IEEE
    // division takes a dozen. For v < -87 the exponential is inf and the
    // result -0 (SiLU's limit).
    return __fdividef(v, 1.f + __expf(-v));
  } else {
    return v > 0.f ? v : 0.f;
  }
}

// ---------------------------------------------------------------- generic k
constexpr int DW_CT = 64;        // channels per block
constexpr int DW_TT = 64;        // output rows per block
constexpr int DW_THREADS = 256;  // 64 channels x 4 groups of 16 rows
constexpr int DW_MAX_K = 61;     // keeps the staged tile under 48 KB

template <typename T, int ACT>
__global__ void __launch_bounds__(DW_THREADS)
dwconv_prelu_generic_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
  const float av = ACT == ACT_PRELU ? to_f(alpha[c]) : 0.f;
  T* ob = out + (size_t)b * T_len * C;
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = r0 + rr, t = t0 + r;
    if (t >= T_len) break;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc += xs[(r + j) * DW_CT + cc] * ws[j * DW_CT + cc];
    acc += bv;
    acc = activate<ACT>(acc, av);
    ob[(size_t)t * C + c] = from_f<T>(acc);
  }
}

template <typename T, int ACT>
int launch_generic(const void* x, const void* w, const void* bias, const void* alpha,
                   void* out, int B, int T_len, int C, int K, cudaStream_t stream) {
  const dim3 grid((C + DW_CT - 1) / DW_CT, (T_len + DW_TT - 1) / DW_TT, B);
  const size_t smem = (size_t)(DW_TT + 2 * K - 1) * DW_CT * sizeof(float);
  dwconv_prelu_generic_kernel<T, ACT><<<grid, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(alpha), static_cast<T*>(out), T_len, C, K);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- compile-time k tile
constexpr int DWT_CT = 64;        // channels per block: 32 pairs, one warp wide
constexpr int DWT_GROUPS = 4;     // warps per block, each on its own row chunks
constexpr int DWT_THREADS = 32 * DWT_GROUPS;
// Probe builds (tools/perf_torch_kernels.py k1probe) change the chunk and the
// blocks an SM must hold, or leave out the copies from device memory or all
// multiply-adds but one a row; the port's own build defines none of these.
#ifndef DW_PROBE_R
#define DW_PROBE_R 16
#endif
#ifndef DW_PROBE_BLOCKS
#define DW_PROBE_BLOCKS 4
#endif
constexpr int DWT_R = DW_PROBE_R;  // output rows of a register chunk

// two neighbouring channels of one row from shared memory
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// 4 x 4 transpose of words among the four lanes of a quad: lane m (of the
// quad) gives v[r] = its word of row r and gets row m's words of lanes 0..3.
__device__ __forceinline__ uint4 quad_transpose(uint32_t v0, uint32_t v1, uint32_t v2,
                                                uint32_t v3, int lane) {
  const bool odd = lane & 1, high = lane & 2;
  const uint32_t ra = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 1);
  const uint32_t rb = __shfl_xor_sync(0xffffffffu, odd ? v2 : v3, 1);
  const uint32_t ka = odd ? v1 : v0, kb = odd ? v3 : v2;
  const uint32_t a_lo = odd ? ra : ka, a_hi = odd ? ka : ra;  // row (lane & 1)
  const uint32_t b_lo = odd ? rb : kb, b_hi = odd ? kb : rb;  // row 2 + (lane & 1)
  const uint32_t r_lo = __shfl_xor_sync(0xffffffffu, high ? a_lo : b_lo, 2);
  const uint32_t r_hi = __shfl_xor_sync(0xffffffffu, high ? a_hi : b_hi, 2);
  const uint32_t k_lo = high ? b_lo : a_lo, k_hi = high ? b_hi : a_hi;
  return high ? make_uint4(r_lo, r_hi, k_lo, k_hi) : make_uint4(k_lo, k_hi, r_lo, r_hi);
}

// blocks that share an SM: four in bf16 (128 registers a thread), two in float32,
// whose stages are twice as large
template <typename T, int K, int TT, int ACT>
__global__ void __launch_bounds__(DWT_THREADS, sizeof(T) == 2 ? DW_PROBE_BLOCKS : 2)
dwconv_prelu_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, const T* __restrict__ alpha,
                         T* __restrict__ out, int T_len, int C, int span) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  constexpr int R = DWT_R;
  constexpr int WIN = TT + K - 1;
  constexpr int VEC = 16 / sizeof(T);  // values in a 16-byte copy
  constexpr int ROW_VECS = DWT_CT / VEC;
  constexpr int W_VECS = DWT_CT * K / VEC;
  T* xs = reinterpret_cast<T*>(tile_smem);  // two stages of [WIN][DWT_CT]
  T* ws = xs + 2 * WIN * DWT_CT;            // [DWT_CT][K], as in device memory
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * DWT_CT;
  const int tile0 = blockIdx.y * span;
  const int tile_end = min(tile0 + span, (T_len + TT - 1) / TT);
  const T* xb = x + (size_t)b * T_len * C;

  // rows before 0 or past T are zero-filled: the conv's own padding
  auto stage = [&](int tile, T* dst) {
#ifdef DW_PROBE_NO_STAGE
    return;
#endif
    for (int i = threadIdx.x; i < WIN * ROW_VECS; i += DWT_THREADS) {
      const int r = i / ROW_VECS, cv = (i % ROW_VECS) * VEC;
      const int t = tile * TT - K / 2 + r, c = c0 + cv;
#ifdef DW_PROBE_NO_LOAD
      const bool ok = false;
#else
      const bool ok = t >= 0 && t < T_len && c < C;
#endif
      cp_async16(dst + r * DWT_CT + cv, ok ? xb + (size_t)t * C + c : x, ok);
    }
    cp_async_commit();
  };

  // the block's taps are one contiguous run of w [C, K]; C % 8 == 0 makes
  // every 16-byte piece lie wholly inside or wholly outside it
  for (int i = threadIdx.x; i < W_VECS; i += DWT_THREADS) {
    const bool ok = (size_t)c0 * K + (size_t)i * VEC < (size_t)C * K;
    cp_async16(ws + i * VEC, ok ? w + (size_t)c0 * K + i * VEC : w, ok);
  }
  cp_async_commit();
  stage(tile0, xs);
  cp_async_wait<1>();  // the taps
  __syncthreads();

  const int lane = threadIdx.x % 32, group = threadIdx.x / 32;
  const int c = c0 + 2 * lane;
  // a lane past C works on zeros and stores nothing: it stays for the shuffles
  const bool live = c < C;
  float w0[K], w1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    w0[j] = to_f(ws[(2 * lane) * K + j]);
    w1[j] = to_f(ws[(2 * lane + 1) * K + j]);
  }
  const float b0 = (bias && live) ? to_f(bias[c]) : 0.f;
  const float b1 = (bias && live) ? to_f(bias[c + 1]) : 0.f;
  const float a0 = (ACT == ACT_PRELU && live) ? to_f(alpha[c]) : 0.f;
  const float a1 = (ACT == ACT_PRELU && live) ? to_f(alpha[c + 1]) : 0.f;
  T* ob = out + (size_t)b * T_len * C;

#pragma unroll 1
  for (int tile = tile0; tile < tile_end; ++tile) {
    const T* cur = xs + ((tile - tile0) & 1) * (WIN * DWT_CT);
    if (tile + 1 < tile_end) {  // the next tile's copy flies while this one is computed
      stage(tile + 1, xs + ((tile + 1 - tile0) & 1) * (WIN * DWT_CT));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = tile * TT;
    // the warps take the tile's chunks of R rows in turn
#pragma unroll 1
    for (int r0 = group * R; r0 < TT; r0 += DWT_GROUPS * R) {
      if (t0 + r0 >= T_len) break;
      float acc0[R], acc1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
      const T* xr = cur + r0 * DWT_CT + 2 * lane;
#pragma unroll
      for (int i = 0; i < R + K - 1; ++i) {
        const float2 v = load_pair(xr + i * DWT_CT);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = i - r;  // input row i is tap j of output row r
#ifdef DW_PROBE_NO_FMA
          if (j == 0) {
#else
          if (j >= 0 && j < K) {
#endif
            acc0[r] = fmaf(v.x, w0[j], acc0[r]);
            acc1[r] = fmaf(v.y, w1[j], acc1[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc0[r] += b0;
        acc1[r] += b1;
        acc0[r] = activate<ACT>(acc0[r], a0);
        acc1[r] = activate<ACT>(acc1[r], a1);
      }
      if constexpr (sizeof(T) == 2) {
        // the quad's four words of a row become one lane's 16 bytes
        const int cq = c0 + 8 * (lane / 4);
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(acc0[r + q], acc1[r + q]);
            v[q] = *reinterpret_cast<const uint32_t*>(&h);
          }
          const uint4 row = quad_transpose(v[0], v[1], v[2], v[3], lane);
          const int t = t0 + r0 + r + (lane & 3);
#ifdef DW_PROBE_NO_STORE
          if (live && t < -T_len) *reinterpret_cast<uint4*>(ob + (size_t)t * C + cq) = row;
#else
          if (live && t < T_len) *reinterpret_cast<uint4*>(ob + (size_t)t * C + cq) = row;
#endif
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int t = t0 + r0 + r;
          if (live && t < T_len)
            *reinterpret_cast<float2*>(ob + (size_t)t * C + c) = make_float2(acc0[r], acc1[r]);
        }
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }
}

template <typename T, int K, int TT, int ACT>
int launch_tile(const void* x, const void* w, const void* bias, const void* alpha, void* out,
                int B, int T_len, int C, int span, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(2 * (TT + K - 1) * DWT_CT + DWT_CT * K) * sizeof(T);
  auto kernel = dwconv_prelu_tile_kernel<T, K, TT, ACT>;
  if (smem > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      raised = true;
    }
  }
  const int tiles = (T_len + TT - 1) / TT;
  const dim3 grid((C + DWT_CT - 1) / DWT_CT, (tiles + span - 1) / span, B);
  kernel<<<grid, DWT_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(alpha), static_cast<T*>(out), T_len, C, span);
  return (int)cudaGetLastError();
}

template <typename T, int K, int ACT, typename... Args>
int tile_by_rows(int rows, Args... args) {
  switch (rows) {
    case 64: return launch_tile<T, K, 64, ACT>(args...);
    case 128: return launch_tile<T, K, 128, ACT>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int ACT, typename... Args>
int tile_by_k(int K, int rows, Args... args) {
  switch (K) {
    case 7: return tile_by_rows<T, 7, ACT>(rows, args...);
    case 31: return tile_by_rows<T, 31, ACT>(rows, args...);
  }
  return (int)cudaErrorInvalidValue;
}

// one kernel of each dtype for the activation code
template <int ACT>
int launch(const void* x, const void* w, const void* bias, const void* alpha, void* out,
           int B, int T, int C, int K, int dtype, int rows, int span, cudaStream_t s) {
  if (rows == 0) {
    if (K < 1 || K > DW_MAX_K) return (int)cudaErrorInvalidValue;
    return dtype == 0 ? launch_generic<float, ACT>(x, w, bias, alpha, out, B, T, C, K, s)
                      : launch_generic<bf16, ACT>(x, w, bias, alpha, out, B, T, C, K, s);
  }
  if (C % 8 || span < 1) return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? tile_by_k<float, ACT>(K, rows, x, w, bias, alpha, out, B, T, C, span, s)
             : tile_by_k<bf16, ACT>(K, rows, x, w, bias, alpha, out, B, T, C, span, s);
}

}  // namespace ds

// x, out: [B, T, C]; w: [C, K] taps; bias (may be null), alpha: [C] (read
// for act 0 only, may be null otherwise); all of one element type (dtype 0 =
// float32, 1 = bfloat16). act: 0 PReLU, 1 SiLU, 2 ReLU. rows = 0 runs the
// generic kernel (K from 1 to 61, any C). rows = 64 or 128 runs the tile
// kernel with that many output rows a tile and `span` consecutive tiles a
// block; it takes K = 7 or 31 and C % 8 == 0. Returns the CUDA error.
extern "C" int ds_dwconv_prelu(const void* x, const void* w, const void* bias,
                               const void* alpha, void* out, int B, int T, int C,
                               int K, int dtype, int rows, int span, int act,
                               void* stream) {
  if (B < 1 || B > 65535 || T < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (act == ds::ACT_PRELU && alpha == nullptr) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case ds::ACT_PRELU:
      return ds::launch<ds::ACT_PRELU>(x, w, bias, alpha, out, B, T, C, K, dtype, rows, span, s);
    case ds::ACT_SILU:
      return ds::launch<ds::ACT_SILU>(x, w, bias, alpha, out, B, T, C, K, dtype, rows, span, s);
    case ds::ACT_RELU:
      return ds::launch<ds::ACT_RELU>(x, w, bias, alpha, out, B, T, C, K, dtype, rows, span, s);
  }
  return (int)cudaErrorInvalidValue;
}
