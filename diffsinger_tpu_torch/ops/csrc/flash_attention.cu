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
// acoustic model runs it 4 times at [48, 2, 128, 128]: 5 products over the
// visible pairs, 1.36 GFLOP (0.020 ms on the CUDA cores at 67 TFLOP/s; in
// 3xTF32 on the tensor cores 3 x 1.36 GFLOP at 495 TFLOP/s, 0.008 ms),
// against 50 MB that must move (0.015 ms at 3.35 TB/s): on the tensor cores
// the bytes bound it. Its design: the FlashAttention-2 split with S and dP
// computed once per tile pair, all five products on the tensor cores in
// 3xTF32, dS through a scratch tensor for dQ: see "backward" below.
//
// What bounds the forward on the H100: at L = 128 neither resource, really: 0.27 GFLOP
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
// K3's backward, redesigned for the H100's tensor cores (see the note at the
// top for what it replaces). Two launches:
//   dkv:  a block owns BW_KT = 64 keys of one (batch, head), 4 warps of 16
//         keys, and walks the query rows in steps of BW_QS = 16. Per step it
//         computes delta = rowsum(dO O) of the step's rows (the TPU library
//         and FlashAttention-2 take it from a launch of its own; folded in
//         here, with the O rows loaded a step ahead, the dkv kernel takes 8 %
//         longer and the backward 7 % less at the training shape),
//         S^T = K Q^T and
//         dP^T = V dO^T once, rebuilds
//         P^T = exp(S^T * scale - lse) on the visible pairs and
//         dS^T = P^T (dP^T - delta), sums dV += P^T dO and dK += dS^T Q in
//         registers, and writes dS^T to a scratch tensor [B*H, LP, LP]
//         (LP = L rounded up to 64; row = key, contiguous queries);
//   dq:   a block owns BW_QT = 64 queries, 4 warps of 16, and walks the keys
//         in steps of BW_KS = 32 for dQ += dS K, reading dS from the scratch.
// Five products, each once per visible tile pair; every output has one owner
// block, so the result is deterministic (no atomics).
//
// Every product runs on the tensor cores in float32 accuracy: 3xTF32. An
// operand x splits into hi = x rounded to TF32 and lo = x - hi, and
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo term, 2^-22 of the
// product, is dropped) with mma.sync m16n8k8 tf32 accumulating in float32.
// Single-pass TF32 keeps 11 bits and would miss the 1e-4 tolerance.
//
// What bounds it on the H100 is not the tensor cores but the instruction
// stream around them. mma.sync m16n8k8 tf32 peaks at 306 TFLOP/s there, 62 %
// of wgmma's 495, with 31 clocks from one mma to the next of a dependent
// chain (tools/perf_torch_kernels.py mmarate, H100 80GB HBM3 at 700 W). Each mma needs its B fragment loaded
// from shared memory and split by every warp that uses it, and the dK, dV
// sums (128 registers at D = 128) leave room for only 8 warps an SM. The
// split is integer arithmetic (3 instructions an operand): cvt.rna.tf32.f32
// compiles to a longer compare-and-select sequence on sm_90 (dK/dV 0.0671
// against 0.0599 ms at [48, 2, 128, 128] on the H100). In the dkv
// kernel every operand is split as it is read; Q and dO come through a
// two-stage cp.async ring. The dq kernel splits its B operand (K) once a
// block: K lands in a "hi" plane and one pass splits it in place into "hi"
// and "lo" planes, which the four warps read (faster there than splitting
// as read; in the dkv kernel 7 % slower, for lack of room for a second
// stage). Measured alternatives that were slower: 8 warps with D split
// between warp pairs, or with S/dP split between them (128-register cap,
// spills), two sums for S over halves of D, dQ^T = K^T dS^T.
//
// Fragments (g = lane / 4, t = lane % 4): A [16 x 8] holds (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); B [8 x 8] holds (k t, n g), (k t+4, n g); C [16 x 8]
// holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). P^T and dS^T stay in
// registers: a C fragment is taken as the A fragment of the next product
// with its k slots permuted (slot t is column 2t, slot t+4 column 2t+1), and
// the B operand is read with the same permutation (rows 2t and 2t+1).
// Shared-memory rows are padded to D + 4 floats (dkv: rows g and 2t land on
// distinct banks) or D + 8 and 64 + 8 (dq).
//
// Tile pairs with no visible pair are skipped: each 64-key tile and each
// 16-query group is marked by whether it holds any valid row and any pad row
// (read from the mask, which need not be a contiguous tail; a table in shared
// memory made in the prologue), and a pair is computed only where both hold
// rows of one segment. The dq kernel skips exactly the pairs that the dkv
// kernel skipped, so it never reads scratch that was not written.
//
// Shared memory (D = 128): dkv 109,888 B + a byte a query step (K and V, two
// stages of Q and dO, O and delta of a step), so two blocks fit on an SM and
// the training shape's 192 blocks run in one wave of 264. dq 88,064 B + a
// byte a key tile (two stages of dS^T and the split K).
constexpr int BW_KT = 64;        // keys per dK/dV block
constexpr int BW_QS = 16;        // queries per step of the dK/dV block
constexpr int BW_QT = 64;        // queries per dQ block
constexpr int BW_KS = 32;        // keys per step of the dQ block
constexpr int BW_THREADS = 128;  // 4 warps
constexpr int BW_LDS = BW_QT + 8;  // row stride of the dS^T tile in the dq kernel

// scratch row length: L rounded up to whole key and query tiles
__host__ __device__ __forceinline__ int bwd_lp(int L) { return (L + 63) / 64 * 64; }

template <int D>
struct BwdCfg {
  static constexpr int LDA = D + 4;  // dkv: K, V, Q, dO rows
  static constexpr int LDK = D + 8;  // dq: K rows
  static constexpr int STAGE_DQ = BW_KS * (BW_LDS + 2 * LDK);  // dS^T, K hi, K lo
  // the tables of visible steps follow the tiles
  static size_t smem_dkv(int L) {
    return sizeof(float) * ((size_t)2 * BW_KT * LDA + 5 * BW_QS * LDA + BW_QS) +
           (L + BW_QS - 1) / BW_QS;
  }
  static size_t smem_dq(int L) { return sizeof(float) * 2 * STAGE_DQ + bwd_lp(L) / BW_KT; }
};

// ---- 3xTF32 on mma.sync
// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds finite x), lo = x - hi exactly. The tensor core
// reads the top 19 bits of lo, so lo enters with an error of 2^-21 of x at
// most.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// an A fragment, split as it is read
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};
// d += a b, small terms first: b = (b0, b1) split here, or read from split
// planes (hi, lo) at offsets o0, o1
// (DS_PROBE_ONE_MMA, for tools/perf_torch_kernels.py k3bwdprobe only: a_hi b_hi
// alone, single-pass TF32, which misses the tolerance; it measures what the two
// extra products of 3xTF32 cost.)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
#ifndef DS_PROBE_ONE_MMA
  mma_tf32(d, a.lo, bh);
  mma_tf32(d, a.hi, bl);
#endif
  mma_tf32(d, a.hi, bh);
}
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, float b0, float b1) {
  uint32_t bh[2], bl[2];
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  mma_3xtf32(d, a, bh, bl);
}
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const float* bhi,
                                           const float* blo, int o0, int o1) {
  const uint32_t bh[2] = {__float_as_uint(bhi[o0]), __float_as_uint(bhi[o1])};
  const uint32_t bl[2] = {__float_as_uint(blo[o0]), __float_as_uint(blo[o1])};
  mma_3xtf32(d, a, bh, bl);
}

// rows [0, rows) x D of a tile, split in place: `hi` holds x on entry and
// hi on exit, `lo` receives lo (both with row stride ld)
template <int D>
__device__ __forceinline__ void split_tile(float* hi, float* lo, int ld, int rows, int tid) {
  for (int i = tid; i < rows * (D / 4); i += BW_THREADS) {
    const int off = (i / (D / 4)) * ld + (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Whether rows [r0, r0 + n) hold any valid row (bit 0) and any pad row
// (bit 1), rows past L not counted; with no mask every row in range is valid.
__device__ __forceinline__ int row_flags(const uint8_t* padb, int r0, int n, int L) {
  int f = 0;
  for (int r = r0; r < min(r0 + n, L); ++r) f |= (padb && padb[r]) ? 2 : 1;
  return f;
}
// the same for n <= 64 rows, computed by the warp together; every lane gets it
__device__ __forceinline__ int seg_flags(const uint8_t* padb, int r0, int n, int L, int lane) {
  int f = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lane + 32 * i < n) f |= row_flags(padb, r0 + lane + 32 * i, 1, L);
  return (__any_sync(0xffffffffu, f & 1) ? 1 : 0) | (__any_sync(0xffffffffu, f & 2) ? 2 : 0);
}
// a tile pair holds a visible pair where both hold rows of one segment
__device__ __forceinline__ bool pair_visible(int fa, int fb) { return (fa & fb) != 0; }
// the first entry of table[0, n) at or after s that is set (n if none)
__device__ __forceinline__ int next_set(const uint8_t* table, int s, int n) {
  while (s < n && !table[s]) ++s;
  return s;
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ pad,
                     const float* __restrict__ out, const float* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ dst,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int L, float scale) {
  constexpr int LDA = BwdCfg<D>::LDA, NT = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [BW_KT][LDA]
  float* vs = ks + BW_KT * LDA;      // [BW_KT][LDA]
  float* stage0 = vs + BW_KT * LDA;  // per stage: Q [BW_QS][LDA], dO [BW_QS][LDA]
  float* os = stage0 + 4 * BW_QS * LDA;  // [BW_QS][LDA]: O of the step
  float* del_s = os + BW_QS * LDA;       // [BW_QS]: delta of the step
  uint8_t* vis = reinterpret_cast<uint8_t*>(del_s + BW_QS);  // [steps]: visible

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * BW_KT;
  const size_t base = (size_t)bh * L * D;
  const uint8_t* padb = pad ? pad + (size_t)b * L : nullptr;
  const int LP = bwd_lp(L);
  lse += (size_t)bh * L;
  dst += (size_t)bh * LP * LP;

  load_rows<D, BW_THREADS>(ks, LDA, k + base, k0, BW_KT, L, tid);
  load_rows<D, BW_THREADS>(vs, LDA, v + base, k0, BW_KT, L, tid);
  cp_async_commit();
  const int kflags = seg_flags(padb, k0, BW_KT, L, lane);
  const int steps = (L + BW_QS - 1) / BW_QS;
  for (int s = tid; s < steps; s += BW_THREADS)
    vis[s] = pair_visible(kflags, row_flags(padb, s * BW_QS, BW_QS, L));
  auto load_step = [&](int stage, int s) {
    float* qs = stage0 + stage * 2 * BW_QS * LDA;
    load_rows<D, BW_THREADS>(qs, LDA, q + base, s * BW_QS, BW_QS, L, tid);
    load_rows<D, BW_THREADS>(qs + BW_QS * LDA, LDA, dout + base, s * BW_QS, BW_QS, L, tid);
  };

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  // this thread's keys in the score tiles: rows g and g + 8 of the warp's 16
  const int kr0 = 16 * warp + g;
  int kseg[2];
  bool kin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + kr0 + 8 * h;
    kin[h] = kj < L;
    kseg[h] = (padb && kin[h]) ? padb[kj] : 0;
  }
  __syncthreads();  // the table is complete

  // groups in flight, oldest first: a step's Q and dO, then its O
  int cur = next_set(vis, 0, steps);
  if (cur < steps) load_step(0, cur);
  cp_async_commit();
  if (cur < steps) load_rows<D, BW_THREADS>(os, LDA, out + base, cur * BW_QS, BW_QS, L, tid);
  cp_async_commit();
  for (int it = 0; cur < steps; ++it) {
    const int nxt = next_set(vis, cur + 1, steps);
    if (nxt < steps) load_step((it + 1) & 1, nxt);
    cp_async_commit();
    const int q0 = cur * BW_QS;
    // lse and segment of this thread's query columns 8j + 2t + c
    float lse_r[2][2];
    int qseg[2][2];
    bool qin[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * j + 2 * t + c;
        qin[j][c] = qi < L;
        lse_r[j][c] = qin[j][c] ? lse[qi] : 0.f;
        qseg[j][c] = (padb && qin[j][c]) ? padb[qi] : 0;
      }
    cp_async_wait<1>();  // K, V and this step's Q, dO, O landed; the next Q, dO may be in flight
    __syncthreads();
    const float* qs = stage0 + (it & 1) * 2 * BW_QS * LDA;
    const float* dos = qs + BW_QS * LDA;

    // delta = rowsum(dO O): 8 threads a row, 4 columns every 32 each
    {
      const int r = tid / 8, c = (tid % 8) * 4;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const float4 o4 = *reinterpret_cast<const float4*>(os + r * LDA + c + 32 * i);
        const float4 g4 = *reinterpret_cast<const float4*>(dos + r * LDA + c + 32 * i);
        sum = fmaf(o4.x, g4.x, fmaf(o4.y, g4.y, fmaf(o4.z, g4.z, fmaf(o4.w, g4.w, sum))));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (tid % 8 == 0) del_s[r] = sum;
    }
    __syncthreads();  // delta is visible and the O buffer free: the next step's O
    if (nxt < steps) load_rows<D, BW_THREADS>(os, LDA, out + base, nxt * BW_QS, BW_QS, L, tid);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T: [16 keys x 16 queries] a warp
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 8) {
      const float* kp = ks + kr0 * LDA + kk + t;
      const float* vp = vs + kr0 * LDA + kk + t;
      FragA ka, va;
      ka.set(kp[0], kp[8 * LDA], kp[4], kp[8 * LDA + 4]);
      va.set(vp[0], vp[8 * LDA], vp[4], vp[8 * LDA + 4]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* qp = qs + (8 * j + g) * LDA + kk + t;
        const float* op = dos + (8 * j + g) * LDA + kk + t;
        mma_3xtf32(s[j], ka, qp[0], qp[4]);
        mma_3xtf32(dp[j], va, op[0], op[4]);
      }
    }

    // P^T and dS^T in place; dS^T to the scratch
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = e % 2;
        const bool ok = kin[h] && qin[j][c] && kseg[h] == qseg[j][c];
        const float p = ok ? expf(fmaf(s[j][e], scale, -lse_r[j][c])) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - del_s[8 * j + 2 * t + c]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst + (size_t)(k0 + kr0 + 8 * h) * LP + q0 + 8 * j + 2 * t) =
            make_float2(dp[j][2 * h], dp[j][2 * h + 1]);
    }

    // dV += P^T dO, dK += dS^T Q: k runs over the 16 queries, slots permuted
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragA pa, sa;
      pa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
      sa.set(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
      const float* op = dos + (8 * j + 2 * t) * LDA + g;
      const float* qp = qs + (8 * j + 2 * t) * LDA + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_3xtf32(acc_v[n], pa, op[8 * n], op[LDA + 8 * n]);
        mma_3xtf32(acc_k[n], sa, qp[8 * n], qp[LDA + 8 * n]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
    cur = nxt;
  }
  cp_async_wait<0>();  // K and V, where no step was visible

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + kr0 + 8 * h;
    if (kj >= L) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const size_t off = base + (size_t)kj * D + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 2)
flash_bwd_dq_kernel(const float* __restrict__ k, const uint8_t* __restrict__ pad,
                    const float* __restrict__ dst, float* __restrict__ dq, int H, int L,
                    float scale) {
  constexpr int LDK = BwdCfg<D>::LDK, NT = D / 8, STAGE = BwdCfg<D>::STAGE_DQ;
  // per stage: dS^T [BW_KS][BW_LDS], K hi (K as it lands) and K lo [BW_KS][LDK];
  // then the flags of each 64-key tile
  extern __shared__ __align__(16) float smem[];
  uint8_t* kflags = reinterpret_cast<uint8_t*>(smem + 2 * STAGE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BW_QT;
  const size_t base = (size_t)bh * L * D;
  const uint8_t* padb = pad ? pad + (size_t)b * L : nullptr;
  const int LP = bwd_lp(L);
  dst += (size_t)bh * LP * LP;

  const int wflags = seg_flags(padb, q0 + 16 * warp, 16, L, lane);  // this warp's queries
  const int qflags = seg_flags(padb, q0, BW_QT, L, lane);            // the block's
  const int steps = (L + BW_KS - 1) / BW_KS;
  for (int i = tid; i < LP / BW_KT; i += BW_THREADS)
    kflags[i] = row_flags(padb, i * BW_KT, BW_KT, L);
  __syncthreads();
  auto key_tile_flags = [&](int s) { return kflags[s * BW_KS / BW_KT]; };
  // the first key step at or after s whose tile the block's queries see
  auto next_step = [&](int s) {
    while (s < steps && !pair_visible(qflags, key_tile_flags(s))) ++s;
    return s;
  };
  auto load_step = [&](int stage, int s) {
    float* dss = smem + stage * STAGE;
    for (int i = tid; i < BW_KS * (BW_QT / 4); i += BW_THREADS) {
      const int r = i / (BW_QT / 4), c = (i % (BW_QT / 4)) * 4;
      cp_async16(dss + r * BW_LDS + c, dst + (size_t)(s * BW_KS + r) * LP + q0 + c, true);
    }
    load_rows<D, BW_THREADS>(dss + BW_KS * BW_LDS, LDK, k + base, s * BW_KS, BW_KS, L, tid);
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int cur = next_step(0);
  if (cur < steps) load_step(0, cur);
  cp_async_commit();
  for (int it = 0; cur < steps; ++it) {
    const int nxt = next_step(cur + 1);
    if (nxt < steps) load_step((it + 1) & 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* dss = smem + (it & 1) * STAGE;
    float* kh = dss + BW_KS * BW_LDS;
    float* kl = kh + BW_KS * LDK;
    split_tile<D>(kh, kl, LDK, BW_KS, tid);
    __syncthreads();
    if (pair_visible(wflags, key_tile_flags(cur))) {
      // dQ[16 queries] += dS[16 x 32] K[32 x D]; the dkv kernel wrote this dS
#pragma unroll
      for (int kk = 0; kk < BW_KS; kk += 8) {
        const float* ap = dss + (kk + t) * BW_LDS + 16 * warp + g;
        FragA a;
        a.set(ap[0], ap[8], ap[4 * BW_LDS], ap[4 * BW_LDS + 8]);
        const int o = (kk + t) * LDK + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_3xtf32(acc[n], a, kh, kl, o + 8 * n, o + 4 * LDK + 8 * n);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + 16 * warp + g + 8 * h;
    if (qi >= L) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dq + base + (size_t)qi * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const uint8_t* pad,
               const float* out, const float* dout, const float* lse, float* ds, float* dq,
               float* dk, float* dv, int B, int H, int L, float scale, int parts, cudaStream_t s) {
  cudaError_t err;
  if (parts & 1) {
    auto kernel = flash_bwd_dkv_kernel<D>;
    const int smem = (int)BwdCfg<D>::smem_dkv(L);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((L + BW_KT - 1) / BW_KT, B * H), BW_THREADS, smem, s>>>(
        q, k, v, pad, out, dout, lse, ds, dk, dv, H, L, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    auto kernel = flash_bwd_dq_kernel<D>;
    const int smem = (int)BwdCfg<D>::smem_dq(L);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((L + BW_QT - 1) / BW_QT, B * H), BW_THREADS, smem, s>>>(
        k, pad, ds, dq, H, L, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
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

// The backward. q, k, v, out, dout, dq, dk, dv: [B, H, L, D] float32; pad as
// for the forward; lse: [B, H, L] float32; ds: scratch of B * H * LP * LP
// float32 (LP = L rounded up to 64), 16-byte aligned. parts picks the
// launches, run in this order: 1 dk, dv and dS, 2 dq (reads dS); a whole
// backward is 3.
extern "C" int ds_flash_attn_bwd(const void* q, const void* k, const void* v, const void* pad,
                                 const void* out, const void* dout, const void* lse, void* ds,
                                 void* dq, void* dk, void* dv, int B, int H, int L, int D,
                                 float scale, int parts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto pb = static_cast<const uint8_t*>(pad);
#define DS_BWD(DD)                                                                       \
  ds::launch_bwd<DD>(f(q), f(k), f(v), pb, f(out), f(dout), f(lse), w(ds), w(dq), w(dk), \
                     w(dv), B, H, L, scale, parts, s)
  switch (D) {
    case 32: return DS_BWD(32);
    case 64: return DS_BWD(64);
    case 128: return DS_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DS_BWD
}
