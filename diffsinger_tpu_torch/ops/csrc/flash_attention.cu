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
// arithmetic bounds it (0.064 ms). No tensor cores: the products stay in full
// float32, as the TPU kernel's are.
//
// Design: a block of 4 warps owns 16 query rows of one (batch, head); each warp
// owns 4 rows and keeps their running max, running sum and output row (D / 32
// values per lane) in registers. Key and value tiles of 32 rows pass through
// shared memory; the key tile's rows are padded by one float so that lane j
// reading key j hits a distinct bank. Lane j scores key j, the warp reduces the
// max and the sum with shuffles, and the output update broadcasts each
// probability from its lane. The score matrix never reaches device memory.

#include "common.cuh"

namespace ds {

constexpr int FA_ROWS = 4;               // query rows per warp
constexpr int FA_WARPS = 4;
constexpr int FA_BQ = FA_ROWS * FA_WARPS;  // query rows per block
constexpr int FA_BKV = 32;               // keys per tile, one per lane

template <int DC>  // head dim D = 32 * DC
__global__ void __launch_bounds__(32 * FA_WARPS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ pad,
                 float* __restrict__ out, int H, int L, float scale) {
  constexpr int D = 32 * DC;
  __shared__ float qs[FA_BQ][D];
  __shared__ float ks[FA_BKV][D + 1];
  __shared__ float vs[FA_BKV][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * FA_BQ;
  const size_t base = (size_t)bh * L * D;

  for (int i = tid; i < FA_BQ * D; i += 32 * FA_WARPS) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < L ? q[base + (size_t)(q0 + r) * D + d] : 0.f;
  }
  int qseg[FA_ROWS];
  float m[FA_ROWS], l[FA_ROWS], o[FA_ROWS][DC];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int qi = q0 + warp * FA_ROWS + r;
    qseg[r] = (pad && qi < L) ? pad[(size_t)b * L + qi] : 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += FA_BKV) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < FA_BKV * D; i += 32 * FA_WARPS) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < L;
      ks[j][d] = in ? k[base + (size_t)(k0 + j) * D + d] : 0.f;
      vs[j][d] = in ? v[base + (size_t)(k0 + j) * D + d] : 0.f;
    }
    __syncthreads();
    const int kj = k0 + lane;
    const bool kin = kj < L;
    const int kseg = (pad && kin) ? pad[(size_t)b * L + kj] : 0;
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const float* qr = qs[warp * FA_ROWS + r];
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qr[d] * ks[lane][d];
      s *= scale;
      const bool ok = kin && kseg == qseg[r];
      s = ok ? s : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      if (m_new == -INFINITY) continue;  // warp-uniform: nothing visible yet
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);  // 0 while m[r] is -inf
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DC; ++c) o[r][c] *= corr;
      for (int j = 0; j < FA_BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) o[r][c] += pj * vs[j][lane + 32 * c];
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int qi = q0 + warp * FA_ROWS + r;
    if (qi >= L) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < DC; ++c) out[base + (size_t)qi * D + lane + 32 * c] = o[r][c] * inv;
  }
}

template <int DC>
int launch_flash(const void* q, const void* k, const void* v, const void* pad, void* out,
                 int B, int H, int L, float scale, cudaStream_t s) {
  const dim3 grid((L + FA_BQ - 1) / FA_BQ, B * H);
  flash_fwd_kernel<DC><<<grid, 32 * FA_WARPS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(out), H, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace ds

// q, k, v, out: [B, H, L, D] float32; pad: [B, L] bytes, 1 = padded (may be
// null: no padding). D is 32, 64 or 128.
extern "C" int ds_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* pad, void* out, int B, int H, int L, int D,
                                 float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return ds::launch_flash<1>(q, k, v, pad, out, B, H, L, scale, s);
    case 64: return ds::launch_flash<2>(q, k, v, pad, out, B, H, L, scale, s);
    case 128: return ds::launch_flash<4>(q, k, v, pad, out, B, H, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
