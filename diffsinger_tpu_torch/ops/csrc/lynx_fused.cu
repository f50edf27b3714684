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
// float32 products, kept for exact checks and the float32 slice, run on the
// CUDA cores in a tiled GEMM. bf16 products run on the tensor cores, in the
// usual Hopper shape:
//   - a block of three warpgroups computes 128-row output tiles: one thread of
//     the producer warpgroup issues TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle) of a [128 x 64] tile of A and two [128 x 64] boxes of W, which
//     lie back to back as one [256 x 64] operand, into a ring of up to 4 stages
//     (48 KB each), each stage with a "full" mbarrier that counts the bytes and
//     an "empty" one that the consumers' 8 warps release; registers are handed
//     from the producer to the consumers with setmaxnreg (40 / 232);
//   - each of the two consumer warpgroups owns 64 rows and a float32
//     accumulator of 64 x 256 (wgmma.mma_async m64n256k16, W from shared
//     memory through a descriptor), 128 registers a thread;
//   - the grid is one block per SM; a block walks the output tiles (those
//     that share rows of A next to each other) and its producer runs ahead
//     across tiles, so the next tile's first stages load during the epilogue;
//   - pw1: the two boxes of W are 128 value rows of w1 at n0 and the matching
//     128 gate rows at I + n0, so the value and the gate of an output column
//     sit in the same thread, 64 accumulator registers apart, and the epilogue
//     applies bias and SwiGLU in registers and writes s once (with the
//     hardware's exp and reciprocal approximations: the result is rounded to
//     bf16, and the exact form made the epilogue a seventh of the kernel). The
//     LN prologue stays in the kernel with the plain version's arithmetic: TMA
//     brings raw x; a consumer reads its A fragments from the swizzled tile
//     with ldmatrix, computes (x - mean) * rstd * ln_w + ln_b in float32
//     (statistics of its two rows in registers, ln_w and ln_b from a float32
//     table in shared memory), rounds to bf16 and issues wgmma with A from
//     registers. Two sets of four fragments alternate, so the next k tile is
//     normalised while the tensor cores work on the current one;
//   - pw2: the two boxes are W rows n0.. and n0 + 128.. (a 128 x 256 output
//     tile), A is read from shared memory through a descriptor, the epilogue
//     adds the bias.
// TMA zero-fills what lies past M, N or K, and the epilogues mask the ragged
// edge, so M is any number and C, I any multiples of 32. The tensor maps are
// encoded on the host on every call (activations move between calls) with
// cuTensorMapEncodeTiled, looked up at run time in libcuda, and passed
// by value as __grid_constant__ parameters. The epilogue goes from the
// accumulators to device memory through a transpose among the four lanes of a
// quad, so that each lane stores 16 bytes and each warp whole sectors.
// Tried on the H100 and dropped, each at the main shape: normalising the A
// tile in place in shared memory by the producer warpgroup, with A then read
// through a descriptor (pw1 0.56 ms against 0.40 ms with register fragments);
// clusters of two blocks along M with W multicast (no change: L2 is not the
// limit).

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

// The same with the hardware's exp2 and reciprocal approximations (relative
// error about 2^-21), for results that are rounded to bf16: the exact form
// costs some 40 instructions, and the bf16 epilogue has 64 of them a thread.
__device__ __forceinline__ float swiglu_fast(float value, float gate) {
  return value * gate * __fdividef(1.f, 1.f + __expf(-gate));
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
constexpr int TC_BM = 128;   // rows of an output tile (64 per consumer warpgroup)
constexpr int TC_BOX = 128;  // rows of one box of W
constexpr int TC_TILE_BYTES = 128 * TC_BK * 2;
constexpr int TC_STAGE_BYTES = 3 * TC_TILE_BYTES;  // A, box 0, box 1

// two bf16 values of x (one word) -> LN -> two bf16 values;
// wb = (ln_w[c], ln_b[c], ln_w[c + 1], ln_b[c + 1])
__device__ __forceinline__ uint32_t ln_pair(uint32_t x, float mu, float rs, const float4& wb) {
  const float lo = (__uint_as_float(x << 16) - mu) * rs * wb.x + wb.y;
  const float hi = (__uint_as_float(x & 0xffff0000u) - mu) * rs * wb.z + wb.w;
  return pack_pair(lo, hi);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// PW1:  out [M, N] = SwiGLU(LN(A) @ W^T + bias), A [M, K] raw x, W [2N, K]
//       (value rows, then gate rows), bias [2N]; an output tile is 128 x 128.
// !PW1: out [M, N] = A @ W^T + bias, W [N, K]; an output tile is 128 x 256.
template <bool PW1>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                 const bf16* __restrict__ bias, bf16* __restrict__ out,
                 int M, int N, int K, int stages) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + stages * TC_STAGE_BYTES);
  uint64_t* empty = full + TC_MAX_STAGES;
  float4* ln_tab = reinterpret_cast<float4*>(empty + TC_MAX_STAGES);  // [ceil(K / 64) * 32]

  const int tid = threadIdx.x;
  const int k_tiles = (K + TC_BK - 1) / TC_BK;
  // output tiles, the ones that share rows of A next to each other; a block
  // takes every gridDim.x-th
  constexpr int TILE_N = PW1 ? TC_BOX : 2 * TC_BOX;
  const int n_tiles = (N + TILE_N - 1) / TILE_N;
  const int out_tiles = n_tiles * ((M + TC_BM - 1) / TC_BM);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 8);  // one arrive from each consumer warp
    }
    mbar_init_fence();
  }
  if (PW1) {
    for (int i = tid; i < k_tiles * (TC_BK / 2); i += TC_THREADS) {
      const int c = 2 * i;  // K is even
      ln_tab[i] = c < K ? make_float4(to_f(ln_w[c]), to_f(ln_b[c]), to_f(ln_w[c + 1]),
                                      to_f(ln_b[c + 1]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // ------------------------------------------------------------ producer
    // runs ahead of the consumers across output tiles, so the next tile's
    // first stages load during this tile's epilogue
    reg_dealloc<40>();
    if (tid == 2 * 128) {
      int s = 0;
      uint32_t parity = 1;  // a fresh "empty" barrier lets the first round pass
      for (int tile = blockIdx.x; tile < out_tiles; tile += gridDim.x) {
        const int n0 = tile % n_tiles * TILE_N, m0 = tile / n_tiles * TC_BM;
        const int row_b0 = n0;
        const int row_b1 = PW1 ? N + n0 : n0 + TC_BOX;
        for (int it = 0; it < k_tiles; ++it) {
          mbar_wait(&empty[s], parity);
          mbar_arrive_expect_tx(&full[s], TC_STAGE_BYTES);
          uint8_t* st = tiles + s * TC_STAGE_BYTES;
          const int k0 = it * TC_BK;
          tma_load_2d(st, &map_a, &full[s], k0, m0);
          tma_load_2d(st + TC_TILE_BYTES, &map_w, &full[s], k0, row_b0);
          tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, &full[s], k0, row_b1);
          if (++s == stages) {
            s = 0;
            parity ^= 1;
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // ldmatrix: lanes 0-15 address rows 0-15 of the warp's 16 at the first
    // 16-byte chunk of the k step, lanes 16-31 the same rows at the second
    const int lm_row = wg * 64 + warp * 16 + (lane & 15);
    const int lm_chunk = lane >> 4;
    const uint32_t tiles_u32 = smem_u32(tiles);
    const uint64_t desc0 = wgmma_desc_sw128(tiles);

    float acc[128];  // columns 8 j + 2 t (+ 1) of box 0 for j < 16, of box 1 for j >= 16
    int s = 0, prev = 0;
    uint32_t parity = 0;
    auto advance = [&]() {
      prev = s;
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    };
    auto release_prev = [&]() {
      if (lane == 0) mbar_arrive(&empty[prev]);
    };

    for (int tile = blockIdx.x; tile < out_tiles; tile += gridDim.x) {
      const int n0 = tile % n_tiles * TILE_N, m0 = tile / n_tiles * TC_BM;
      const int row_lo = m0 + wg * 64 + warp * 16 + g, row_hi = row_lo + 8;
      if (PW1) {
        float mu_lo = 0.f, rs_lo = 0.f, mu_hi = 0.f, rs_hi = 0.f;
        if (row_lo < M) mu_lo = mean[row_lo], rs_lo = rstd[row_lo];
        if (row_hi < M) mu_hi = mean[row_hi], rs_hi = rstd[row_hi];
        // the four A fragments of k tile `it` (stage s), normalised
        auto fragments = [&](uint32_t (&f)[4][4], int it) {
          mbar_wait(&full[s], parity);
#pragma unroll
          for (int ks = 0; ks < TC_BK / 16; ++ks) {
            uint32_t raw[4];
            ldmatrix_x4(raw, tiles_u32 + s * TC_STAGE_BYTES + lm_row * 128 +
                                 (((ks * 2 + lm_chunk) ^ (lm_row & 7)) << 4));
            const int c = it * TC_BK + ks * 16 + 2 * t;
            const float4 wb0 = ln_tab[c >> 1], wb1 = ln_tab[(c >> 1) + 4];
            f[ks][0] = ln_pair(raw[0], mu_lo, rs_lo, wb0);
            f[ks][1] = ln_pair(raw[1], mu_hi, rs_hi, wb0);
            f[ks][2] = ln_pair(raw[2], mu_lo, rs_lo, wb1);
            f[ks][3] = ln_pair(raw[3], mu_hi, rs_hi, wb1);
          }
        };
        // the products of k tile `it` from `cur`; meanwhile the next tile's
        // fragments into `next`, which the tile before this one has released
        auto k_tile = [&](uint32_t (&cur)[4][4], uint32_t (&next)[4][4], int it) {
          const uint64_t desc_b = desc0 + ((s * TC_STAGE_BYTES + TC_TILE_BYTES) >> 4);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < TC_BK / 16; ++ks)
            wgmma_m64n256k16_rs(acc, cur[ks], desc_b + 2 * ks, (it | ks) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the k tile before this one is done
          if (it > 0) release_prev();
          advance();
          if (it + 1 < k_tiles) fragments(next, it + 1);
        };
        uint32_t frag_a[4][4], frag_b[4][4];
        fragments(frag_a, 0);
        for (int it = 0; it < k_tiles; it += 2) {
          k_tile(frag_a, frag_b, it);
          if (it + 1 < k_tiles) k_tile(frag_b, frag_a, it + 1);
        }
      } else {
        for (int it = 0; it < k_tiles; ++it) {
          mbar_wait(&full[s], parity);
          const uint32_t st_off = s * TC_STAGE_BYTES;
          const uint64_t desc_a = desc0 + ((st_off + wg * 64 * 128) >> 4);
          const uint64_t desc_b = desc0 + ((st_off + TC_TILE_BYTES) >> 4);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < TC_BK / 16; ++ks)
            wgmma_m64n256k16_ss(acc, desc_a + 2 * ks, desc_b + 2 * ks, (it | ks) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the k tile before this one is done
          if (it > 0) release_prev();
          advance();
        }
      }
      wgmma_wait<0>();
      release_prev();  // the last k tile's stage

      // epilogue: acc[4 j + e] is row_lo (e < 2) or row_hi, column 8 j + 2 t + (e & 1)
      // of the 256 columns of the two boxes. Four column groups j at a time:
      // bias (and SwiGLU), round to bf16 pairs, transpose the pairs among the
      // four lanes that share the rows, so that lane t holds the 8 columns of
      // group 4 q + t and a warp's store fills whole 32-byte sectors.
#pragma unroll
      for (int q = 0; q < (PW1 ? 4 : 8); ++q) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * q + i;
          const int n = n0 + j * 8 + 2 * t;
          const bool in = n < N;  // N is even, so n + 1 < N too
          const float2 zero = make_float2(0.f, 0.f);
          const float2 b = in ? load_pair(bias + n) : zero;
          if (PW1) {  // value in box 0, its gate 16 groups further, in box 1
            const float2 bg = in ? load_pair(bias + N + n) : zero;
            constexpr int G = 4 * 16;
            lo[i] = pack_pair(swiglu_fast(acc[4 * j] + b.x, acc[4 * j + G] + bg.x),
                              swiglu_fast(acc[4 * j + 1] + b.y, acc[4 * j + 1 + G] + bg.y));
            hi[i] = pack_pair(swiglu_fast(acc[4 * j + 2] + b.x, acc[4 * j + 2 + G] + bg.x),
                              swiglu_fast(acc[4 * j + 3] + b.y, acc[4 * j + 3 + G] + bg.y));
          } else {
            lo[i] = pack_pair(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
            hi[i] = pack_pair(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
          }
        }
        quad_transpose(lo, t);
        quad_transpose(hi, t);
        const int n = n0 + (4 * q + t) * 8;
        if (n < N) {  // N is a multiple of 8: the 8 columns are in or out together
          if (row_lo < M)
            *reinterpret_cast<uint4*>(out + (size_t)row_lo * N + n) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
          if (row_hi < M)
            *reinterpret_cast<uint4*>(out + (size_t)row_hi * N + n) =
                make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
    }
  }
}

template <bool PW1>
int launch_gemm_bf16(const void* A, const float* mean, const float* rstd, const void* ln_w,
                     const void* ln_b, const void* W, const void* bias, void* out, int M, int N,
                     int K, cudaStream_t s) {
  CUtensorMap map_a, map_w;
  // A [M, K] and W [N or 2N, K] in boxes of 128 rows
  if (!make_map(&map_a, A, 2, 1, M, K, 128) ||
      !make_map(&map_w, W, 2, 1, PW1 ? 2 * N : N, K, 128))
    return (int)cudaErrorInvalidValue;
  // alignment slack, barriers, and pw1's table of (ln_w, ln_b) pairs
  const int k_tiles = (K + TC_BK - 1) / TC_BK;
  const int fixed = 1024 + 2 * TC_MAX_STAGES * 8 + (PW1 ? k_tiles * TC_BK * 8 : 0);
  const int stages = tc_stages(fixed, TC_STAGE_BYTES, 1);
  const int smem = fixed + stages * TC_STAGE_BYTES;
  if (smem > TC_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_bf16_kernel<PW1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = PW1 ? TC_BOX : 2 * TC_BOX;
  const int out_tiles = ((N + cols - 1) / cols) * ((M + TC_BM - 1) / TC_BM);
  const dim3 grid(out_tiles < sm_count() ? out_tiles : sm_count());  // a block walks its tiles
  kernel<<<grid, TC_THREADS, smem, s>>>(
      map_a, map_w, mean, rstd, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K, stages);
  return (int)cudaGetLastError();
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
  if (K % 32 != 0 || N % 2 != 0) return (int)cudaErrorInvalidValue;
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  if (dtype == 1)
    return launch_gemm_bf16<SWIGLU>(A, mu, rs, ln_w, ln_b, W, bias, out, M, N, K, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int cols = SWIGLU ? FP_BN / 2 : FP_BN;
  const dim3 grid((M + FP_BM - 1) / FP_BM, (N + cols - 1) / cols);
  gemm_f32_kernel<SWIGLU><<<grid, FP_THREADS, 0, s>>>(
      static_cast<const float*>(A), mu, rs, static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(W),
      static_cast<const float*>(bias), static_cast<float*>(out), M, N, K);
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
