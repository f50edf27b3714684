// K4: the WaveNet's residual blocks at inference, over channel-last
// activations [B, T, C], in two routes that the wrapper picks by dtype:
// float32 on the CUDA cores and bf16 on the tensor cores. Block i computes
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
// The float32 route. What bounds it on the H100: the float32 CUDA cores. The
// configuration that runs it (the variance model) runs
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
//
// The bf16 route (wavenet_tc_kernel), for a model declared bf16 (the acoustic
// WaveNet, 20 x 512). Operands are bf16 as the model holds them, products sum
// in float32; x + d and z are rounded to bf16, as the stock bf16 blocks round
// them, while the residual stream x and skip_sum stay in float32 across the
// blocks (the stock blocks round both at every block). What bounds it on the
// H100: kernel A, the tensor cores (at [16 x 544, 512] 27.4 GFLOP, 0.028 ms at
// 989 TFLOP/s, against 0.011 ms for its 36 MB); kernel B, bytes (x, x' and the
// skip sum in float32 read and written, z and the next x + d: 20 bytes a
// channel a frame, 89 MB, 0.027 ms at 3.35 TB/s, against 0.009 ms of products).
//
// Design: Hopper's warp-specialised GEMM, as K2's bf16 GEMMs (lynx_fused.cu).
//   - A block of three warpgroups on each SM walks output tiles (a persistent
//     grid); one thread of the producer warpgroup issues TMA loads (128-byte
//     swizzle) into a ring of 4 stages with "full" and "empty" mbarriers, the
//     two consumer warpgroups run wgmma from shared memory; setmaxnreg hands
//     registers from the producer (40) to the consumers (232).
//   - An output tile is BM frames (128 in kernel A, 64 in B) by 128
//     channels and their 128 partners C further on (gate and filter in A,
//     residual and skip in B): W's rows arrive as four boxes of 64 rows,
//     channels and partners in turn, so each thread holds both halves of its
//     channels in registers and the epilogue needs nothing of [B, T, 2C] in
//     device memory. At BM = 128 each consumer warpgroup takes 64 frames and
//     all 256 columns (m64n256k16); at BM = 64 both take the 64 frames and one
//     half each (m64n128k16). A width that is not a multiple of 128 leaves a
//     half of the last column tile unused; its rows of W arrive as zeros or
//     are never stored.
//   - Kernel A is an implicit GEMM, K = 3C run tap by tap: the A box of a tap
//     is frames t0 + (tap - 1) * dilation.. of one batch row of x + d, through
//     a 3-D tensor map [B, T, C], whose zero fill outside [0, T) is F.conv1d's
//     zero padding (no im2col, no halo); W is re-laid once as [2C, 3C] (row n:
//     tap * C + ci). The epilogue adds the float32 bias and the bf16 condition
//     (read as 16-byte words and transposed among a quad's lanes to the
//     accumulators' pairs), applies the gate with the hardware's exp and
//     reciprocal (z is rounded to bf16), and stores z through the same
//     transpose, 16 bytes a lane.
//   - Kernel B runs over the B * T frames as one row (a 2-D product) with W
//     the torch layout [2C, C]; its epilogue updates x in place and the skip
//     sum (the first block writes it), each pair of a row read and written by
//     one thread, and writes x' + d_{i+1} in bf16 over the x + d that kernel A
//     has read. Each column group issues its loads before its stores (x is
//     updated in place, so a later load may not pass an earlier store).
// The wrapper takes C a multiple of 64, any T and any dilation. Tried on the
// H100 and dropped, at [16, 544, 512]: kernel A in 64-frame tiles (0.0749 ms
// against 0.0670 at 128: W is read from L2 twice as often) and kernel B in
// 128-frame tiles (0.0688 against 0.0598 at 64: the last wave part full);
// kernel B with each load after the previous pair's stores (0.108 ms).

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

// ------------------------------------------------ bf16: tensor-core kernels
constexpr int TC_COLS = 128;        // channels of an output tile (and their 128 partners)
constexpr int TC_BOX_BYTES = 64 * TC_BK * 2;  // a box of W: 64 rows
constexpr int TC_W_BYTES = 4 * TC_BOX_BYTES;  // the tile's 256 rows of W

struct TcArgs {
  const float* bias;    // [2C], float32
  const bf16* cond;     // A: the hoisted conditioner projection [B, T, 2C]
  const float* x;       // B: the block's input [B * T, C], float32
  const float* d_next;  // B: the next block's step projection (rows d_stride apart), or null
  float* x_out;         // B: x' [B * T, C], float32 (may be x)
  float* skip;          // B: skip_sum [B * T, C], float32
  bf16* out;            // A: z [B, T, C]; B: x' + d_next [B, T, C], or null
  int B, T, C, dilation, skip_init, d_stride, stages;
  float scale;          // B: the float32 reciprocal of sqrt(2)
};

__device__ __forceinline__ float2 unpack_pair(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// sigmoid(gate) * tanh(filt) with the hardware's exp and reciprocal
// approximations (relative error about 2^-21): z is rounded to bf16.
__device__ __forceinline__ float gated(float gate, float filt) {
  const float tanh_f = 1.f - __fdividef(2.f, 1.f + __expf(2.f * filt));
  return __fdividef(1.f, 1.f + __expf(-gate)) * tanh_f;
}

// CONV: kernel A, z = gate(conv(x + d) + bias + cond) over the 3C taps of x + d;
// else kernel B, the output projection of z with the residual, the skip sum and
// the next block's x + d. An output tile is BM frames by 128 channels and
// their 128 partners (C further on); BM = 128: each consumer warpgroup 64
// frames and all 256 columns (m64n256k16); BM = 64: each warpgroup the 64
// frames and one half, 64 channels and their partners (m64n128k16).
template <bool CONV, int BM>
__global__ void __launch_bounds__(TC_THREADS, 1)
wavenet_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, const TcArgs p) {
  constexpr int A_BYTES = BM * TC_BK * 2, STAGE = A_BYTES + TC_W_BYTES;
  constexpr int NACC = BM == 128 ? 128 : 64;  // accumulators a thread
  constexpr int HALVES = BM == 128 ? 2 : 1;   // 64-channel halves a warpgroup holds
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + stages * STAGE);
  uint64_t* empty = full + TC_MAX_STAGES;

  const int tid = threadIdx.x, C = p.C;
  // A's tiles lie in one batch row (the taps must not reach the next row);
  // B's run over the B * T frames as one row
  const int rows = CONV ? p.B : 1, len = CONV ? p.T : p.B * p.T;
  const int chunks = C / TC_BK;                      // k tiles of one tap
  const int k_tiles = (CONV ? 3 : 1) * chunks;
  const int n_tiles = (C + TC_COLS - 1) / TC_COLS, t_tiles = (len + BM - 1) / BM;
  const int out_tiles = rows * t_tiles * n_tiles;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 8);  // one arrive from each consumer warp
    }
    mbar_init_fence();
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
        const int n0 = tile % n_tiles * TC_COLS, rt = tile / n_tiles;
        const int t0 = rt % t_tiles * BM, b = rt / t_tiles;
        for (int it = 0; it < k_tiles; ++it) {
          const int tap = it / chunks, k0 = (it - tap * chunks) * TC_BK;
          mbar_wait(&empty[s], parity);
          mbar_arrive_expect_tx(&full[s], STAGE);
          uint8_t* st = tiles + s * STAGE;
          // frames t0 + (tap - 1) * dilation..: rows outside [0, T) arrive as
          // zeros, F.conv1d's zero padding of x + d
          tma_load_3d(st, &map_a, &full[s], k0, t0 + (CONV ? (tap - 1) * p.dilation : 0), b);
          // W's rows in boxes of 64: channels n0.., their partners C + n0..,
          // channels n0 + 64.., their partners C + n0 + 64..
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tma_load_2d(st + A_BYTES + 2 * h * TC_BOX_BYTES, &map_w, &full[s], tap * C + k0,
                        n0 + 64 * h);
            tma_load_2d(st + A_BYTES + (2 * h + 1) * TC_BOX_BYTES, &map_w, &full[s],
                        tap * C + k0, C + n0 + 64 * h);
          }
          if (++s == stages) {
            s = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  reg_alloc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a_off = BM == 128 ? wg * 64 * 128 : 0;
  const uint32_t w_off = A_BYTES + (BM == 128 ? 0 : wg * 2 * TC_BOX_BYTES);
  const uint64_t desc0 = wgmma_desc_sw128(tiles);

  // acc[4 j + e]: row g (e < 2) or g + 8 of the warp's 16, column 8 j + 2 t +
  // (e & 1) of the warpgroup's B operand, whose 64-column halves are channels
  // and their partners in turn: group j's partner is group j + 8
  float acc[NACC];
  int s = 0, prev = 0;
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < out_tiles; tile += gridDim.x) {
    const int n0 = tile % n_tiles * TC_COLS, rt = tile / n_tiles;
    const int t0 = rt % t_tiles * BM, b = rt / t_tiles;
    for (int it = 0; it < k_tiles; ++it) {
      mbar_wait(&full[s], parity);
      const uint64_t desc_a = desc0 + ((s * STAGE + a_off) >> 4);
      const uint64_t desc_b = desc0 + ((s * STAGE + w_off) >> 4);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TC_BK / 16; ++ks) {
        if constexpr (BM == 128)
          wgmma_m64n256k16_ss(acc, desc_a + 2 * ks, desc_b + 2 * ks, (it | ks) != 0);
        else
          wgmma_m64n128k16_ss(acc, desc_a + 2 * ks, desc_b + 2 * ks, (it | ks) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the k tile before this one is done
      if (it > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);  // the last k tile's stage

    // epilogue, four column groups at a time; the bf16 outputs go through a
    // transpose among the quad's lanes, so that lane t stores the 8 channels of
    // group 4 q + t and a warp's store fills whole 32-byte sectors. Each group
    // issues all its loads before its first store (kernel B updates x in
    // place, so a later load may not pass an earlier store): one round trip
    // to device memory a group.
    const int t_lo = t0 + (BM == 128 ? 64 * wg : 0) + 16 * warp + g, t_hi = t_lo + 8;
    const bool in_lo = t_lo < len, in_hi = t_hi < len;
    const size_t r_lo = (size_t)b * len + t_lo, r_hi = r_lo + 8;  // frames of [B * T]
    auto store_pairs = [&](uint32_t (&lo)[4], uint32_t (&hi)[4], int col) {
      quad_transpose(lo, t);
      quad_transpose(hi, t);
      if (in_lo)
        *reinterpret_cast<uint4*>(p.out + r_lo * C + col) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      if (in_hi)
        *reinterpret_cast<uint4*>(p.out + r_hi * C + col) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    };
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const int cb = n0 + 64 * (BM == 128 ? h : wg);  // first channel of the half
      if (cb >= C) continue;  // C is a multiple of 64: the half is in or out whole
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = cb + 8 * (4 * q + t);  // this lane's 8 channels after the transpose
        uint32_t lo[4], hi[4];
        if constexpr (CONV) {
          // the condition's gate and filter words, transposed to the accumulators' pairs
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          const bf16* c_lo = p.cond + r_lo * 2 * C + col;
          const bf16* c_hi = p.cond + r_hi * 2 * C + col;
          const uint4 w0 = in_lo ? *reinterpret_cast<const uint4*>(c_lo) : zero;
          const uint4 w1 = in_lo ? *reinterpret_cast<const uint4*>(c_lo + C) : zero;
          const uint4 w2 = in_hi ? *reinterpret_cast<const uint4*>(c_hi) : zero;
          const uint4 w3 = in_hi ? *reinterpret_cast<const uint4*>(c_hi + C) : zero;
          uint32_t gl[4] = {w0.x, w0.y, w0.z, w0.w}, fl[4] = {w1.x, w1.y, w1.z, w1.w};
          uint32_t gh[4] = {w2.x, w2.y, w2.z, w2.w}, fh[4] = {w3.x, w3.y, w3.z, w3.w};
          quad_transpose(gl, t);
          quad_transpose(fl, t);
          quad_transpose(gh, t);
          quad_transpose(fh, t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 16 * h + 4 * q + i, c = cb + 8 * (4 * q + i) + 2 * t;
            const float2 bg = *reinterpret_cast<const float2*>(p.bias + c);
            const float2 bf = *reinterpret_cast<const float2*>(p.bias + C + c);
            const float2 cgl = unpack_pair(gl[i]), cfl = unpack_pair(fl[i]);
            const float2 cgh = unpack_pair(gh[i]), cfh = unpack_pair(fh[i]);
            lo[i] = pack_pair(gated((acc[4 * j] + bg.x) + cgl.x, (acc[4 * j + 32] + bf.x) + cfl.x),
                              gated((acc[4 * j + 1] + bg.y) + cgl.y,
                                    (acc[4 * j + 33] + bf.y) + cfl.y));
            hi[i] = pack_pair(gated((acc[4 * j + 2] + bg.x) + cgh.x,
                                    (acc[4 * j + 34] + bf.x) + cfh.x),
                              gated((acc[4 * j + 3] + bg.y) + cgh.y,
                                    (acc[4 * j + 35] + bf.y) + cfh.y));
          }
          store_pairs(lo, hi, col);
        } else {
          // x' = (x + residual) * scale and the skip sum in float32, each pair
          // read and written by this thread alone; x' + d_next into lo, hi.
          // [i][row]: the loads first
          float2 xv[4][2], sv[4][2], dn[4][2];
          const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = cb + 8 * (4 * q + i) + 2 * t;
#pragma unroll
            for (int half = 0; half < 2; ++half) {  // row t_lo, then t_hi
              const bool in = half ? in_hi : in_lo;
              const size_t r = half ? r_hi : r_lo;
              xv[i][half] = in ? *reinterpret_cast<const float2*>(p.x + r * C + c) : zero;
              sv[i][half] = in && !p.skip_init
                                ? *reinterpret_cast<const float2*>(p.skip + r * C + c) : zero;
              dn[i][half] = in && p.out ? *reinterpret_cast<const float2*>(
                                              p.d_next + (size_t)(r / p.T) * p.d_stride + c)
                                        : zero;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 16 * h + 4 * q + i, c = cb + 8 * (4 * q + i) + 2 * t;
            const float2 br = *reinterpret_cast<const float2*>(p.bias + c);
            const float2 bs = *reinterpret_cast<const float2*>(p.bias + C + c);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const size_t r = half ? r_hi : r_lo;
              const int e = 4 * j + 2 * half;
              const float2 xo = make_float2((xv[i][half].x + (acc[e] + br.x)) * p.scale,
                                            (xv[i][half].y + (acc[e + 1] + br.y)) * p.scale);
              const float2 sk = make_float2(sv[i][half].x + (acc[e + 32] + bs.x),
                                            sv[i][half].y + (acc[e + 33] + bs.y));
              if (half ? in_hi : in_lo) {
                *reinterpret_cast<float2*>(p.x_out + r * C + c) = xo;
                *reinterpret_cast<float2*>(p.skip + r * C + c) = sk;
              }
              (half ? hi : lo)[i] = pack_pair(xo.x + dn[i][half].x, xo.y + dn[i][half].y);
            }
          }
          if (p.out) store_pairs(lo, hi, col);  // not in the last block
        }
      }
    }
  }
}

// Kernel A in tiles of 128 frames (the tensor cores bound it: the larger
// tile reads W half as often), kernel B in tiles of 64 (bytes bound it: the
// smaller tile fills the last wave).
template <bool CONV>
int launch_tc(TcArgs p, const void* a, const void* w, cudaStream_t s) {
  constexpr int BM = CONV ? 128 : 64;
  CUtensorMap map_a, map_w;
  // A: x + d [B, T, C] (kernel A, boxes of one batch row) or z [B * T, C];
  // W: [2C, 3C] or [2C, C], k contiguous
  if (!make_map(&map_a, a, 3, CONV ? p.B : 1, CONV ? p.T : p.B * p.T, p.C, BM) ||
      !make_map(&map_w, w, 2, 1, 2 * p.C, (CONV ? 3 : 1) * p.C, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int STAGE = BM * TC_BK * 2 + TC_W_BYTES;  // A, then the four boxes of W
  const int fixed = 1024 + 2 * TC_MAX_STAGES * 8;  // alignment slack, barriers
  p.stages = tc_stages(fixed, STAGE, 2);
  const int smem = fixed + p.stages * STAGE;
  auto kernel = wavenet_tc_kernel<CONV, BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int len = CONV ? p.T : p.B * p.T;
  const int out_tiles = (CONV ? p.B : 1) * ((len + BM - 1) / BM) * ((p.C + TC_COLS - 1) / TC_COLS);
  const dim3 grid(out_tiles < sm_count() ? out_tiles : sm_count());  // a block walks its tiles
  kernel<<<grid, TC_THREADS, smem, s>>>(map_a, map_w, p);
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

// Kernel A on the tensor cores: z [B, T, C] (bf16) = sigmoid(gate) *
// tanh(filter) of the dilated conv of xd = x + d (bf16 [B, T, C]) over w_conv
// (bf16 [2C, 3C], row n: tap * C + ci), plus bias_conv (float32 [2C]) and cond
// (bf16 [B, T, 2C]).
extern "C" int ds_wavenet_conv_gate_bf16(const void* xd, const void* w_conv,
                                         const void* bias_conv, const void* cond, void* z,
                                         int B, int T, int C, int dilation, void* stream) {
  if (C % 64 || T <= 0 || B <= 0 || dilation <= 0) return (int)cudaErrorInvalidValue;
  ds::TcArgs p{};
  p.bias = static_cast<const float*>(bias_conv);
  p.cond = static_cast<const ds::bf16*>(cond);
  p.out = static_cast<ds::bf16*>(z);
  p.B = B;
  p.T = T;
  p.C = C;
  p.dilation = dilation;
  return ds::launch_tc<true>(p, xd, w_conv, static_cast<cudaStream_t>(stream));
}

// Kernel B on the tensor cores: o = z @ w_out^T + bias_out (z bf16 [B * T, C],
// w_out bf16 [2C, C], bias float32); x_out = (x + o[:C]) * scale and skip_sum =
// o[C:] (skip_init) or skip_sum + o[C:], float32, in place (x_out may be x);
// where d_next is given (float32, row b at d_next + b * d_stride), xd_next =
// x_out + d_next[b] in bf16.
extern "C" int ds_wavenet_out_skip_bf16(const void* z, const void* w_out, const void* bias_out,
                                        const void* x, void* x_out, void* skip_sum,
                                        int skip_init, float scale, const void* d_next,
                                        void* xd_next, int d_stride, int B, int T, int C,
                                        void* stream) {
  if (C % 64 || T <= 0 || B <= 0 || (d_next == nullptr) != (xd_next == nullptr) ||
      d_stride % 2)
    return (int)cudaErrorInvalidValue;
  ds::TcArgs p{};
  p.bias = static_cast<const float*>(bias_out);
  p.x = static_cast<const float*>(x);
  p.d_next = static_cast<const float*>(d_next);
  p.x_out = static_cast<float*>(x_out);
  p.skip = static_cast<float*>(skip_sum);
  p.out = static_cast<ds::bf16*>(xd_next);
  p.B = B;
  p.T = T;
  p.C = C;
  p.skip_init = skip_init;
  p.d_stride = d_stride;
  p.scale = scale;
  return ds::launch_tc<false>(p, z, w_out, static_cast<cudaStream_t>(stream));
}
