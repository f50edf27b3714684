// K3: flash attention in float32 with key-padding segments, forward and
// backward.
//   out = softmax(q k^T * scale, masked) v,  q, k, v, out: [B, H, L, D]
// and, for training, the row log-sum-exp of the scaled scores, lse [B, H, L],
// from which the backward rebuilds the probabilities.
// Padding follows the TPU kernel's SegmentIds(q=seg, kv=seg): a valid query
// sees only valid keys and a padded query only padded keys. Every row sees at
// least itself, so no row is empty.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention
// as diffsinger_tpu/models/commons.py (SelfAttentionRoPE.__call__) calls it.
// Main path: q, k, v [16, 2, 128, 128] float32, 4 launches per request (one per
// encoder layer); a long phrase runs [B, 2, 512, 128].
// The backward replaces the TPU library's two backward kernels,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq (jax 0.9.0,
// jax/experimental/pallas/ops/tpu/flash_attention.py:941 and :1287), which
// jax.grad runs through the library's custom_vjp. A training step of the
// acoustic model runs it 4 times at [48, 2, 128, 128]: 5 products of the
// forward's size over the visible pairs, about 2 GFLOP in float32 (0.03 ms
// at 67 TFLOP/s), against 19 MB moved, so arithmetic bounds it. Its design is
// the FlashAttention-2 split, kept simple (CUDA cores, float32, no TMA): see
// "backward" below.
//
// What bounds it on the H100: at L = 128 neither resource, really: 0.27 GFLOP
// on the CUDA cores (67 TFLOP/s float32, 0.004 ms) against 8.4 MB moved
// (0.0025 ms), so launch latency dominates. At L = 512 the 4.3 GFLOP float32
// arithmetic bounds it (0.064 ms at B = 16). No tensor cores: the products stay
// in full float32, as the TPU kernel's are.
//
// Design: both products are register-tiled, so that one shared-memory word
// feeds several multiply-adds. Shared memory returns 32 words a clock to an SM
// that can do 128 multiply-adds, so a thread must do at least 4 multiply-adds
// for every word it loads; a TM x TN tile of an outer product loads TM + TN
// words for TM * TN multiply-adds, which 8 x 8 just meets and 8 x 4 misses by
// half. A block owns BQ = TM * NTY query rows of one (batch, head) and walks
// the keys in tiles of BKV. Its threads form an NTY x 16 grid (ty, tx); thread
// (ty, tx) owns
//   - in the score tile [BQ x BKV]: rows ty*TM .. +TM and the TN = BKV / 16
//     keys tx, tx+16, ... It reads Q and K rows as 16-byte vectors along D;
//     the rows are padded by 4 floats, so the 8 threads of a quarter warp,
//     which read 8 neighbouring key rows, hit 8 distinct bank groups, and the
//     Q reads are broadcasts;
//   - in the output tile [BQ x D]: the same rows, D / 16 columns (8 x 8 at
//     D = 128). The probabilities pass through shared memory once
//     (P, [BQ x BKV]) and are read back as 16-byte vectors along the keys.
// The running max and sum of a row live in the 16 lanes (tx) that share the
// row: the max is reduced with 4 shuffles per tile, the sum is kept as a
// per-lane partial (every lane of a row applies the same correction) and
// reduced once at the end. A row that has seen no key yet keeps m = -inf and
// is handled per row without a branch.
// K and V tiles arrive by cp.async (16 bytes a thread, rows past L zero
// filled) into one buffer each, staggered: the V tile lands while the scores
// are computed from K, and the next K tile lands while P V is computed, so
// every load overlaps arithmetic at half the shared memory of double
// buffering both. Shared memory is dynamic.
//
// BQ is chosen by the wrapper (ops/flash_attention.py::choose_bq): the largest
// of 128, 64, 32, 16 whose grid ceil(L / BQ) * B * H still has about one block
// for each of the 132 SMs (120 or more), else 16:
//   - [16, 2, 128, 128] takes BQ = 32 (4 x 4 score tiles, 128 blocks; 64 rows
//     would leave half the SMs idle). It is launch-bound either way;
//   - [16, 2, 512, 128] takes BQ = 128 (128 blocks; K and V are read 4 times
//     instead of 32). This tile walks the keys 128 at a time, so that its
//     score tiles are 8 x 8. At D = 128 Q, K, V and P of that size would need
//     264 KB, so P is written over the K tile, which is dead once the scores
//     are in registers (194 KB); the next K tile can then start only after
//     P V, and that one load in four is not hidden;
//   - the long phrase [1, 2, 512, 128] takes BQ = 16 (2 x 4 score tiles, 64
//     blocks: too few rows to fill the card at any tile, so the smallest it is).

#include "common.cuh"

namespace ds {

constexpr int FA_NTX = 16;  // threads along the keys (and along D for the output)

// BKV keys per tile, TN = BKV / 16 of them per thread. With ALIAS the
// probabilities are written over the K tile, which is dead by then.
template <int D, int TM, int NTY, int BKV, bool ALIAS>
struct FlashCfg {
  static constexpr int BQ = TM * NTY;
  static constexpr int THREADS = NTY * FA_NTX;
  static constexpr int TN = BKV / FA_NTX;
  static constexpr int LDQ = D + 4;    // row stride of Q and K in shared memory
  static constexpr int LDP = BKV + 4;  // row stride of P
  static constexpr int DV = D / FA_NTX;   // output columns per thread
  static constexpr int VW = DV >= 4 ? 4 : 2;  // floats per vector of V and out
  static constexpr int NV = DV / VW;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * LDQ + BKV * LDQ + BKV * D + (ALIAS ? 0 : BQ * LDP));
  static_assert(!ALIAS || BQ * LDP <= BKV * LDQ, "P does not fit over the K tile");
};

// rows [r0, r0 + rows) of src [L, D] into dst (row stride ld), zero past L
template <int D, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int r0,
                                          int rows, int L, int tid) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < rows * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool in = r0 + r < L;
    cp_async16(dst + r * ld + c, src + (size_t)(in ? r0 + r : 0) * D + c, in);
  }
}

template <int D, int TM, int NTY, int BKV, bool ALIAS>
__global__ void __launch_bounds__(NTY * FA_NTX)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ pad,
                 float* __restrict__ out, float* __restrict__ lse, int H, int L, float scale) {
  using Cfg = FlashCfg<D, TM, NTY, BKV, ALIAS>;
  constexpr int BQ = Cfg::BQ, THREADS = Cfg::THREADS, LDQ = Cfg::LDQ, LDP = Cfg::LDP;
  constexpr int VW = Cfg::VW, NV = Cfg::NV, FA_BKV = BKV, FA_TN = Cfg::TN;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [BQ][LDQ]
  float* ks = qs + BQ * LDQ;            // [BKV][LDQ]
  float* vs = ks + BKV * LDQ;           // [BKV][D]
  float* ps = ALIAS ? ks : vs + BKV * D;  // [BQ][LDP]

  const int tid = threadIdx.x, tx = tid % FA_NTX, ty = tid / FA_NTX;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * L * D;
  const uint8_t* padb = pad ? pad + (size_t)b * L : nullptr;

  load_rows<D, THREADS>(qs, LDQ, q + base, q0, BQ, L, tid);
  load_rows<D, THREADS>(ks, LDQ, k + base, 0, FA_BKV, L, tid);
  cp_async_commit();  // group: Q and K tile 0
  load_rows<D, THREADS>(vs, D, v + base, 0, FA_BKV, L, tid);
  cp_async_commit();  // group: V tile 0

  int qseg[TM];
  float m[TM], l[TM], o[TM][NV * VW];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int qi = q0 + ty * TM + r;
    qseg[r] = (padb && qi < L) ? padb[qi] : 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) o[r][c] = 0.f;
  }

  const int tiles = (L + FA_BKV - 1) / FA_BKV;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * FA_BKV;
    cp_async_wait<1>();  // this tile's K (and Q) landed; its V may be in flight
    __syncthreads();

    // scores: s[r][c] = q[ty*TM + r] . k[tx + 16 c]
    float s[TM][FA_TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < FA_TN; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[FA_TN];
#pragma unroll
      for (int c = 0; c < FA_TN; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (tx + FA_NTX * c) * LDQ + d);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (ty * TM + r) * LDQ + d);
#pragma unroll
        for (int c = 0; c < FA_TN; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }
    __syncthreads();  // every thread is done with this K tile
    if (!ALIAS) {
      if (it + 1 < tiles) load_rows<D, THREADS>(ks, LDQ, k + base, k0 + FA_BKV, FA_BKV, L, tid);
      cp_async_commit();  // group: the next K tile (empty after the last)
    }

    // mask, running max, probabilities
    bool kin[FA_TN];
    int kseg[FA_TN];
#pragma unroll
    for (int c = 0; c < FA_TN; ++c) {
      const int kj = k0 + tx + FA_NTX * c;
      kin[c] = kj < L;
      kseg[c] = (padb && kin[c]) ? padb[kj] : 0;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < FA_TN; ++c) {
        const bool ok = kin[c] && kseg[c] == qseg[r];
        s[r][c] = ok ? s[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = FA_NTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      // a row that has seen nothing yet: exponents against 0, all of them 0
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[r] - m_ref);  // 0 while m[r] is -inf
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < FA_TN; ++c) {
        const float p = expf(s[r][c] - m_ref);  // exp(-inf) = 0 where masked
        psum += p;
        ps[(ty * TM + r) * LDP + tx + FA_NTX * c] = p;
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) o[r][c] *= corr;
    }
    if (ALIAS)
      cp_async_wait<0>();  // this tile's V landed
    else
      cp_async_wait<1>();  // this tile's V landed; the next K may be in flight
    __syncthreads();       // P and V are visible

    // o[r][:] += sum_j p[r][j] v[j][:], columns i*16*VW + tx*VW .. +VW
#pragma unroll 2
    for (int j = 0; j < FA_BKV; j += 4) {
      float4 pv[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        pv[r] = *reinterpret_cast<const float4*>(ps + (ty * TM + r) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NV * VW];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float* vp = vs + (j + jj) * D + i * FA_NTX * VW + tx * VW;
          if (VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vp);
            vv[i * VW] = t.x, vv[i * VW + 1] = t.y, vv[i * VW + 2] = t.z, vv[i * VW + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vp);
            vv[i * VW] = t.x, vv[i * VW + 1] = t.y;
          }
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y : jj == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int c = 0; c < NV * VW; ++c) o[r][c] = fmaf(p, vv[c], o[r][c]);
        }
      }
    }
    __syncthreads();  // every thread is done with this V tile and with P
    if (ALIAS) {  // P lay over the K tile: only now can the next one come
      if (it + 1 < tiles) load_rows<D, THREADS>(ks, LDQ, k + base, k0 + FA_BKV, FA_BKV, L, tid);
      cp_async_commit();
    }
    if (it + 1 < tiles) load_rows<D, THREADS>(vs, D, v + base, k0 + FA_BKV, FA_BKV, L, tid);
    cp_async_commit();  // group: the next V tile (empty after the last)
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float lsum = l[r];
#pragma unroll
    for (int off = FA_NTX / 2; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int qi = q0 + ty * TM + r;
    if (qi >= L) continue;
    if (lse && tx == 0) lse[(size_t)bh * L + qi] = m[r] + logf(lsum);
    const float inv = 1.f / lsum;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float* op = out + base + (size_t)qi * D + i * FA_NTX * VW + tx * VW;
      if (VW == 4)
        *reinterpret_cast<float4*>(op) = make_float4(o[r][i * VW] * inv, o[r][i * VW + 1] * inv,
                                                     o[r][i * VW + 2] * inv, o[r][i * VW + 3] * inv);
      else
        *reinterpret_cast<float2*>(op) = make_float2(o[r][i * VW] * inv, o[r][i * VW + 1] * inv);
    }
  }
}

template <int D, int TM, int NTY, int BKV = 64, bool ALIAS = false>
int launch_flash(const void* q, const void* k, const void* v, const void* pad, void* out,
                 void* lse, int B, int H, int L, float scale, cudaStream_t s) {
  using Cfg = FlashCfg<D, TM, NTY, BKV, ALIAS>;
  auto kernel = flash_fwd_kernel<D, TM, NTY, BKV, ALIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + Cfg::BQ - 1) / Cfg::BQ, B * H);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(out), static_cast<float*>(lse), H,
      L, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_d(int bq, const void* q, const void* k, const void* v, const void* pad,
                   void* out, void* lse, int B, int H, int L, float scale, cudaStream_t s) {
  switch (bq) {
    case 16: return launch_flash<D, 2, 8>(q, k, v, pad, out, lse, B, H, L, scale, s);
    case 32: return launch_flash<D, 4, 8>(q, k, v, pad, out, lse, B, H, L, scale, s);
    case 64: return launch_flash<D, 4, 16>(q, k, v, pad, out, lse, B, H, L, scale, s);
    case 128:
      return launch_flash<D, 8, 16, 128, D == 128>(q, k, v, pad, out, lse, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------------ backward
// K3's backward, the FlashAttention-2 split (see the note at the top):
//   pre:  delta[i] = rowsum(dO[i] * O[i])
//   dkv:  a block owns BW_BKV keys of one (batch, head) and walks every query
//         tile: it rebuilds P = exp(S * scale - lse) from Q, K and the row
//         log-sum-exp, dS = P * (dP - delta) with dP = dO V^T, and sums
//         dV += P^T dO and dK += dS^T Q in registers;
//   dq:   a block owns BW_BQ query rows and walks every key tile for
//         dQ += dS K. Each output has one owner block: no atomics.
// Both tiles are 64; 256 threads form a 16 x 16 grid (ty, tx). In the score
// tiles [64 queries x 64 keys] thread (ty, tx) owns queries ty*4 .. +4 and
// keys tx, tx+16, tx+32, tx+48 (the forward's layout); in the outputs it owns
// 4 rows (keys for dK/dV, queries for dQ) and D / 16 columns. P and dS pass
// through shared memory once per tile.
constexpr int BW_T = 64;      // queries and keys per tile
constexpr int BW_TM = 4;      // rows per thread
constexpr int BW_TN = BW_T / FA_NTX;  // keys per thread in a score tile
constexpr int BW_THREADS = 256;

template <int D>
struct BwdCfg {
  static constexpr int LDQ = D + 4;     // row stride of Q, dO, K, V tiles
  static constexpr int LDP = BW_T + 4;  // row stride of the P and dS tiles
  static constexpr int DV = D / FA_NTX;
  static constexpr int VW = DV >= 4 ? 4 : 2;
  static constexpr int NV = DV / VW;
  static constexpr size_t TILE = (size_t)BW_T * LDQ;
  // dkv: K, V, Q, dO, P, dS, lse, delta; dq: Q, dO, K, V, dS, lse, delta
  static constexpr size_t SMEM_DKV = sizeof(float) * (4 * TILE + 2 * BW_T * LDP + 2 * BW_T);
  static constexpr size_t SMEM_DQ = sizeof(float) * (4 * TILE + BW_T * LDP + 2 * BW_T);
};

// the NV * VW columns of a row that thread tx owns: i*16*VW + tx*VW + e
template <int VW, int NV>
__device__ __forceinline__ void load_cols(float (&dst)[NV * VW], const float* row, int tx) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float* p = row + i * FA_NTX * VW + tx * VW;
    if (VW == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      dst[i * VW] = t.x, dst[i * VW + 1] = t.y, dst[i * VW + 2] = t.z, dst[i * VW + 3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(p);
      dst[i * VW] = t.x, dst[i * VW + 1] = t.y;
    }
  }
}

template <int VW, int NV>
__device__ __forceinline__ void store_cols(float* row, const float (&src)[NV * VW], float mul,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float* p = row + i * FA_NTX * VW + tx * VW;
    if (VW == 4)
      *reinterpret_cast<float4*>(p) = make_float4(src[i * VW] * mul, src[i * VW + 1] * mul,
                                                  src[i * VW + 2] * mul, src[i * VW + 3] * mul);
    else
      *reinterpret_cast<float2*>(p) = make_float2(src[i * VW] * mul, src[i * VW + 1] * mul);
  }
}

// lse and delta of query rows [q0, q0 + BW_T) into shared memory, 0 past L
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s, const float* lse,
                                               const float* delta, int q0, int L, int tid) {
  for (int i = tid; i < BW_T; i += BW_THREADS) {
    const bool in = q0 + i < L;
    lse_s[i] = in ? lse[q0 + i] : 0.f;
    del_s[i] = in ? delta[q0 + i] : 0.f;
  }
}

// One score tile, queries q0 + ty*4 + r against keys k0 + tx + 16 c:
//   p[r][c]  = exp(q.k * scale - lse)   where the pair is visible, else 0
//   ds[r][c] = p * (dO.v - delta)
template <int D>
__device__ __forceinline__ void bwd_tile(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* lse_s, const float* del_s,
                                         const uint8_t* padb, int q0, int k0, int L, float scale,
                                         int ty, int tx, float (&p)[BW_TM][BW_TN],
                                         float (&ds)[BW_TM][BW_TN]) {
  constexpr int LDQ = BwdCfg<D>::LDQ;
  float s[BW_TM][BW_TN], dp[BW_TM][BW_TN];
#pragma unroll
  for (int r = 0; r < BW_TM; ++r)
#pragma unroll
    for (int c = 0; c < BW_TN; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kv[BW_TN], vv[BW_TN];
#pragma unroll
    for (int c = 0; c < BW_TN; ++c) {
      kv[c] = *reinterpret_cast<const float4*>(ks + (tx + FA_NTX * c) * LDQ + d);
      vv[c] = *reinterpret_cast<const float4*>(vs + (tx + FA_NTX * c) * LDQ + d);
    }
#pragma unroll
    for (int r = 0; r < BW_TM; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + (ty * BW_TM + r) * LDQ + d);
      const float4 ov = *reinterpret_cast<const float4*>(dos + (ty * BW_TM + r) * LDQ + d);
#pragma unroll
      for (int c = 0; c < BW_TN; ++c) {
        s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
        s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
        s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
        s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        dp[r][c] = fmaf(ov.x, vv[c].x, dp[r][c]);
        dp[r][c] = fmaf(ov.y, vv[c].y, dp[r][c]);
        dp[r][c] = fmaf(ov.z, vv[c].z, dp[r][c]);
        dp[r][c] = fmaf(ov.w, vv[c].w, dp[r][c]);
      }
    }
  }
  int kseg[BW_TN];
  bool kin[BW_TN];
#pragma unroll
  for (int c = 0; c < BW_TN; ++c) {
    const int kj = k0 + tx + FA_NTX * c;
    kin[c] = kj < L;
    kseg[c] = (padb && kin[c]) ? padb[kj] : 0;
  }
#pragma unroll
  for (int r = 0; r < BW_TM; ++r) {
    const int row = ty * BW_TM + r, qi = q0 + row;
    const bool qin = qi < L;
    const int qseg = (padb && qin) ? padb[qi] : 0;
#pragma unroll
    for (int c = 0; c < BW_TN; ++c) {
      const bool ok = qin && kin[c] && kseg[c] == qseg;
      p[r][c] = ok ? expf(s[r][c] * scale - lse_s[row]) : 0.f;
      ds[r][c] = p[r][c] * (dp[r][c] - del_s[row]);
    }
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d]: one warp a row
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_pre_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                     float* __restrict__ delta, int rows, int D) {
  const int row = (blockIdx.x * BW_THREADS + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* o = out + (size_t)row * D;
  const float* g = dout + (size_t)row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(o[c], g[c], acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ pad,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int L, float scale) {
  using Cfg = BwdCfg<D>;
  constexpr int LDQ = Cfg::LDQ, LDP = Cfg::LDP, VW = Cfg::VW, NV = Cfg::NV;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [BW_T][LDQ]
  float* vs = ks + Cfg::TILE;       // [BW_T][LDQ]
  float* qs = vs + Cfg::TILE;       // [BW_T][LDQ]
  float* dos = qs + Cfg::TILE;      // [BW_T][LDQ]
  float* ps = dos + Cfg::TILE;      // [BW_T queries][LDP]
  float* dss = ps + BW_T * LDP;     // [BW_T queries][LDP]
  float* lse_s = dss + BW_T * LDP;  // [BW_T]
  float* del_s = lse_s + BW_T;      // [BW_T]

  const int tid = threadIdx.x, tx = tid % FA_NTX, ty = tid / FA_NTX;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * BW_T;
  const size_t base = (size_t)bh * L * D;
  const uint8_t* padb = pad ? pad + (size_t)b * L : nullptr;
  lse += (size_t)bh * L;
  delta += (size_t)bh * L;

  load_rows<D, BW_THREADS>(ks, LDQ, k + base, k0, BW_T, L, tid);
  load_rows<D, BW_THREADS>(vs, LDQ, v + base, k0, BW_T, L, tid);

  // thread owns keys ty*4 + r of the tile, columns of load_cols
  float acc_k[BW_TM][NV * VW], acc_v[BW_TM][NV * VW];
#pragma unroll
  for (int r = 0; r < BW_TM; ++r)
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BW_T) {
    __syncthreads();  // every thread is done with the previous query tile
    load_rows<D, BW_THREADS>(qs, LDQ, q + base, q0, BW_T, L, tid);
    load_rows<D, BW_THREADS>(dos, LDQ, dout + base, q0, BW_T, L, tid);
    cp_async_commit();
    load_row_stats(lse_s, del_s, lse, delta, q0, L, tid);
    cp_async_wait<0>();
    __syncthreads();

    float p[BW_TM][BW_TN], ds[BW_TM][BW_TN];
    bwd_tile<D>(qs, dos, ks, vs, lse_s, del_s, padb, q0, k0, L, scale, ty, tx, p, ds);
#pragma unroll
    for (int r = 0; r < BW_TM; ++r)
#pragma unroll
      for (int c = 0; c < BW_TN; ++c) {
        ps[(ty * BW_TM + r) * LDP + tx + FA_NTX * c] = p[r][c];
        dss[(ty * BW_TM + r) * LDP + tx + FA_NTX * c] = ds[r][c];
      }
    __syncthreads();  // P and dS are visible

    // dV[key] += sum_j P[j][key] dO[j];  dK[key] += sum_j dS[j][key] Q[j]
#pragma unroll 2
    for (int j = 0; j < BW_T; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(ps + j * LDP + ty * BW_TM);
      const float4 dsj = *reinterpret_cast<const float4*>(dss + j * LDP + ty * BW_TM);
      float go[NV * VW], gq[NV * VW];
      load_cols<VW, NV>(go, dos + j * LDQ, tx);
      load_cols<VW, NV>(gq, qs + j * LDQ, tx);
      const float pr[BW_TM] = {pj.x, pj.y, pj.z, pj.w};
      const float sr[BW_TM] = {dsj.x, dsj.y, dsj.z, dsj.w};
#pragma unroll
      for (int r = 0; r < BW_TM; ++r)
#pragma unroll
        for (int c = 0; c < NV * VW; ++c) {
          acc_v[r][c] = fmaf(pr[r], go[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(sr[r], gq[c], acc_k[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < BW_TM; ++r) {
    const int kj = k0 + ty * BW_TM + r;
    if (kj >= L) continue;
    store_cols<VW, NV>(dk + base + (size_t)kj * D, acc_k[r], scale, tx);
    store_cols<VW, NV>(dv + base + (size_t)kj * D, acc_v[r], 1.f, tx);
  }
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ pad,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int H, int L,
                    float scale) {
  using Cfg = BwdCfg<D>;
  constexpr int LDQ = Cfg::LDQ, LDP = Cfg::LDP, VW = Cfg::VW, NV = Cfg::NV;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BW_T][LDQ]
  float* dos = qs + Cfg::TILE;      // [BW_T][LDQ]
  float* ks = dos + Cfg::TILE;      // [BW_T][LDQ]
  float* vs = ks + Cfg::TILE;       // [BW_T][LDQ]
  float* dss = vs + Cfg::TILE;      // [BW_T queries][LDP]
  float* lse_s = dss + BW_T * LDP;  // [BW_T]
  float* del_s = lse_s + BW_T;      // [BW_T]

  const int tid = threadIdx.x, tx = tid % FA_NTX, ty = tid / FA_NTX;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BW_T;
  const size_t base = (size_t)bh * L * D;
  const uint8_t* padb = pad ? pad + (size_t)b * L : nullptr;

  load_rows<D, BW_THREADS>(qs, LDQ, q + base, q0, BW_T, L, tid);
  load_rows<D, BW_THREADS>(dos, LDQ, dout + base, q0, BW_T, L, tid);
  load_row_stats(lse_s, del_s, lse + (size_t)bh * L, delta + (size_t)bh * L, q0, L, tid);

  // thread owns queries ty*4 + r of the tile, columns of load_cols
  float acc[BW_TM][NV * VW];
#pragma unroll
  for (int r = 0; r < BW_TM; ++r)
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BW_T) {
    __syncthreads();  // every thread is done with the previous key tile
    load_rows<D, BW_THREADS>(ks, LDQ, k + base, k0, BW_T, L, tid);
    load_rows<D, BW_THREADS>(vs, LDQ, v + base, k0, BW_T, L, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float p[BW_TM][BW_TN], ds[BW_TM][BW_TN];
    bwd_tile<D>(qs, dos, ks, vs, lse_s, del_s, padb, q0, k0, L, scale, ty, tx, p, ds);
#pragma unroll
    for (int r = 0; r < BW_TM; ++r)
#pragma unroll
      for (int c = 0; c < BW_TN; ++c) dss[(ty * BW_TM + r) * LDP + tx + FA_NTX * c] = ds[r][c];
    __syncthreads();  // dS is visible

    // dQ[row] += sum_j dS[row][j] K[j]
#pragma unroll 2
    for (int j = 0; j < BW_T; j += 4) {
      float4 sv[BW_TM];
#pragma unroll
      for (int r = 0; r < BW_TM; ++r)
        sv[r] = *reinterpret_cast<const float4*>(dss + (ty * BW_TM + r) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kk[NV * VW];
        load_cols<VW, NV>(kk, ks + (j + jj) * LDQ, tx);
#pragma unroll
        for (int r = 0; r < BW_TM; ++r) {
          const float g = jj == 0 ? sv[r].x : jj == 1 ? sv[r].y : jj == 2 ? sv[r].z : sv[r].w;
#pragma unroll
          for (int c = 0; c < NV * VW; ++c) acc[r][c] = fmaf(g, kk[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BW_TM; ++r) {
    const int qi = q0 + ty * BW_TM + r;
    if (qi < L) store_cols<VW, NV>(dq + base + (size_t)qi * D, acc[r], scale, tx);
  }
}

template <int D>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* pad,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                   int B, int H, int L, float scale, cudaStream_t s) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  const int smem = (int)BwdCfg<D>::SMEM_DKV;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((L + BW_T - 1) / BW_T, B * H), BW_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* pad,
                  const void* dout, const void* lse, const void* delta, void* dq, int B, int H,
                  int L, float scale, cudaStream_t s) {
  auto kernel = flash_bwd_dq_kernel<D>;
  const int smem = (int)BwdCfg<D>::SMEM_DQ;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((L + BW_T - 1) / BW_T, B * H), BW_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq),
      H, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace ds

// q, k, v, out: [B, H, L, D] float32; pad: [B, L] bytes, 1 = padded (may be
// null: no padding); lse: [B, H, L] float32, the row log-sum-exp of the
// scaled scores, written only where not null (training). D is 32, 64 or 128;
// bq, the query rows per block, is 16, 32, 64 or 128.
extern "C" int ds_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* pad, void* out, void* lse, int B, int H, int L,
                                 int D, float scale, int bq, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return ds::launch_flash_d<32>(bq, q, k, v, pad, out, lse, B, H, L, scale, s);
    case 64: return ds::launch_flash_d<64>(bq, q, k, v, pad, out, lse, B, H, L, scale, s);
    case 128: return ds::launch_flash_d<128>(bq, q, k, v, pad, out, lse, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's three launches. out, dout: [B, H, L, D]; lse, delta:
// [B, H, L] float32. pre writes delta = rowsum(dout * out); dkv writes dk and
// dv; dq writes dq (all [B, H, L, D]); dkv and dq read delta.
extern "C" int ds_flash_attn_bwd_pre(const void* out, const void* dout, void* delta, int rows,
                                     int D, void* stream) {
  const int per_block = ds::BW_THREADS / 32;
  ds::flash_bwd_pre_kernel<<<(rows + per_block - 1) / per_block, ds::BW_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<float*>(delta), rows, D);
  return (int)cudaGetLastError();
}

extern "C" int ds_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* pad, const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv, int B, int H, int L,
                                     int D, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return ds::launch_bwd_dkv<32>(q, k, v, pad, dout, lse, delta, dk, dv, B, H, L, scale, s);
    case 64: return ds::launch_bwd_dkv<64>(q, k, v, pad, dout, lse, delta, dk, dv, B, H, L, scale, s);
    case 128: return ds::launch_bwd_dkv<128>(q, k, v, pad, dout, lse, delta, dk, dv, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ds_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* pad, const void* dout, const void* lse,
                                    const void* delta, void* dq, int B, int H, int L, int D,
                                    float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return ds::launch_bwd_dq<32>(q, k, v, pad, dout, lse, delta, dq, B, H, L, scale, s);
    case 64: return ds::launch_bwd_dq<64>(q, k, v, pad, dout, lse, delta, dq, B, H, L, scale, s);
    case 128: return ds::launch_bwd_dq<128>(q, k, v, pad, dout, lse, delta, dq, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
