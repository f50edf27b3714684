// K3: flash-attention forward in float32 with key-padding segments.
//   out = softmax(q k^T * scale, masked) v,  q, k, v, out: [B, H, L, D]
// Padding follows the TPU kernel's SegmentIds(q=seg, kv=seg): a valid query
// sees only valid keys and a padded query only padded keys. Every row sees at
// least itself, so no row is empty.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.flash_attention
// as diffsinger_tpu/models/commons.py (SelfAttentionRoPE.__call__) calls it.
// Main path: q, k, v [16, 2, 128, 128] float32, 4 launches per request (one per
// encoder layer); a long phrase runs [B, 2, 512, 128].
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
                 float* __restrict__ out, int H, int L, float scale) {
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
                 int B, int H, int L, float scale, cudaStream_t s) {
  using Cfg = FlashCfg<D, TM, NTY, BKV, ALIAS>;
  auto kernel = flash_fwd_kernel<D, TM, NTY, BKV, ALIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + Cfg::BQ - 1) / Cfg::BQ, B * H);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(out), H, L, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_d(int bq, const void* q, const void* k, const void* v, const void* pad,
                   void* out, int B, int H, int L, float scale, cudaStream_t s) {
  switch (bq) {
    case 16: return launch_flash<D, 2, 8>(q, k, v, pad, out, B, H, L, scale, s);
    case 32: return launch_flash<D, 4, 8>(q, k, v, pad, out, B, H, L, scale, s);
    case 64: return launch_flash<D, 4, 16>(q, k, v, pad, out, B, H, L, scale, s);
    case 128: return launch_flash<D, 8, 16, 128, D == 128>(q, k, v, pad, out, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ds

// q, k, v, out: [B, H, L, D] float32; pad: [B, L] bytes, 1 = padded (may be
// null: no padding). D is 32, 64 or 128; bq, the query rows per block, is 16,
// 32, 64 or 128.
extern "C" int ds_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* pad, void* out, int B, int H, int L, int D,
                                 float scale, int bq, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return ds::launch_flash_d<32>(bq, q, k, v, pad, out, B, H, L, scale, s);
    case 64: return ds::launch_flash_d<64>(bq, q, k, v, pad, out, B, H, L, scale, s);
    case 128: return ds::launch_flash_d<128>(bq, q, k, v, pad, out, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
