// Flat-layout multi-head self-attention, backward (K2), as two kernels.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel.
// Same (B, N, D) layout and strides as the forward; lse is the forward's
// (B, H, N) fp32 log-sum-exp. The TPU kernel's numerics:
//   p  = exp(s - lse)                   (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . do                 dp = do . v^T
//   delta = rowsum(do * o)              (fp32 from the bf16 values)
//   ds = bf16(p * (dp - delta) * scale)
//   dq = ds . k                         dk = ds^T . q
// with bf16 operands and fp32 accumulation in every product.
//
// The TPU kernel keeps a whole (N, N) score matrix in VMEM and does all five
// products for one head in one grid step. On the H100 a block holds far less
// fast memory and blocks cannot pass sums to each other, so the work splits
// by which operand a block keeps resident:
//   lt_flat_attention_bwd_dq:   one block per (batch, head) holds K and V in
//     shared memory; each warp walks 16-query tiles over all keys and writes
//     dq and the row's delta (fp32, to a (B, H, N) scratch).
//   lt_flat_attention_bwd_dkdv: one block per (batch, head) holds Q, dO, lse
//     and delta; each warp walks 16-key tiles over all queries, working on
//     the transposed scores, and writes dk and dv.
// s and p are recomputed in both (the scores are never stored). What bounds
// it on the H100: at the ViT-B/14 global shape 202 MB move (q, k, v, o, do
// in; dq, dk, dv out), ~60 us at 3.35 TB/s, against 32.5 GFLOP of necessary
// bf16 products (~33 us at the tensor peak), so device memory bounds it;
// the design reads q, k, v and do twice and computes q . k and do . v twice
// (45.5 GFLOP) to avoid any cross-block reduction.
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 8;

template <int HD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long row_stride, int row0, int N,
                                           int lane) {
  constexpr int S = lt::Tile<HD>::kStride;
  for (int i = lane; i < 16 * (HD / 8); i += 32) {
    int r = i / (HD / 8);
    int c = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * S + c) = val;
  }
}

// A fragments (16 x HD) of a staged 16-row tile.
template <int HD>
__device__ __forceinline__ void a_frags(uint32_t (&f)[HD / 16][4],
                                        const bf16* tile, int lane) {
  constexpr int S = lt::Tile<HD>::kStride;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    lt::ldmatrix_x4(f[kk], tile + ((lane % 8) + ((lane / 8) % 2) * 8) * S +
                               kk * 16 + (lane / 16) * 8);
}

// c[2] (16 x 16) = A (16 x HD, fragments) . R[n0 : n0 + 16]^T, R row-major.
template <int HD>
__device__ __forceinline__ void a_times_rows_t(float (&c)[2][4],
                                               const uint32_t (&a)[HD / 16][4],
                                               const bf16* rows, int n0,
                                               int lane) {
  constexpr int S = lt::Tile<HD>::kStride;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t r[4];
    lt::ldmatrix_x4(r, rows + (n0 + (lane % 8) + (lane / 16) * 8) * S +
                           kk * 16 + ((lane / 8) % 2) * 8);
    lt::mma_bf16(c[0], a[kk], r[0], r[1]);
    lt::mma_bf16(c[1], a[kk], r[2], r[3]);
  }
}

// acc (16 x HD) += P (16 x 16, A fragment) . R[n0 : n0 + 16], R row-major.
template <int HD>
__device__ __forceinline__ void p_times_rows(float (&acc)[HD / 8][4],
                                             const uint32_t (&p)[4],
                                             const bf16* rows, int n0,
                                             int lane) {
  constexpr int S = lt::Tile<HD>::kStride;
#pragma unroll
  for (int nb = 0; nb < HD / 16; ++nb) {
    uint32_t r[4];
    lt::ldmatrix_x4_trans(r, rows + (n0 + (lane % 8) + ((lane / 8) % 2) * 8) * S +
                                 nb * 16 + (lane / 16) * 8);
    lt::mma_bf16(acc[2 * nb], p, r[0], r[1]);
    lt::mma_bf16(acc[2 * nb + 1], p, r[2], r[3]);
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long row_stride,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    int col = j * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dst + r0 * row_stride + col) =
          lt::pack_bf16(acc[j][0], acc[j][1]);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dst + r1 * row_stride + col) =
          lt::pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    flat_attention_bwd_dq_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ o,
        const bf16* __restrict__ dout, const float* __restrict__ lse,
        bf16* __restrict__ dq, float* __restrict__ delta, int N, int H,
        int n_pad, long q_sb, long q_sn, long k_sb, long k_sn, long v_sb,
        long v_sn, long o_sb, long o_sn, long do_sb, long do_sn, long dq_sb,
        long dq_sn, float scale) {
  constexpr int S = lt::Tile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + n_pad * S;
  bf16* sW = sV + n_pad * S;  // per warp: 16-row Q tile, then dO tile

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int g = lane >> 2, t = lane & 3;

  lt::load_rows<HD>(sK, k + b * k_sb + h * HD, k_sn, 0, n_pad, N);
  lt::load_rows<HD>(sV, v + b * v_sb + h * HD, v_sn, 0, n_pad, N);
  __syncthreads();

  bf16* sQw = sW + warp * 32 * S;
  bf16* sDw = sQw + 16 * S;
  const bf16* qh = q + b * q_sb + h * HD;
  const bf16* oh = o + b * o_sb + h * HD;
  const bf16* doh = dout + b * do_sb + h * HD;
  const long bh = static_cast<long>(b) * H + h;
  const int n_tiles = (N + 15) / 16;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int row0 = tile * 16;
    stage_tile<HD>(sQw, qh, q_sn, row0, N, lane);
    stage_tile<HD>(sDw, doh, do_sn, row0, N, lane);
    __syncwarp();
    uint32_t qf[HD / 16][4], df[HD / 16][4];
    a_frags<HD>(qf, sQw, lane);
    a_frags<HD>(df, sDw, lane);

    // delta for row (row0 + lane / 2): two lanes per row, HD / 2 columns each.
    float dsum = 0.f;
    {
      const int r = row0 + lane / 2;
      if (r < N) {
        const int c0 = (lane % 2) * (HD / 2);
        for (int c = c0; c < c0 + HD / 2; c += 2) {
          __nv_bfloat162 ov =
              *reinterpret_cast<const __nv_bfloat162*>(oh + r * o_sn + c);
          __nv_bfloat162 dv =
              *reinterpret_cast<const __nv_bfloat162*>(doh + r * do_sn + c);
          dsum += __bfloat162float(ov.x) * __bfloat162float(dv.x);
          dsum += __bfloat162float(ov.y) * __bfloat162float(dv.y);
        }
      }
      dsum += __shfl_xor_sync(0xffffffff, dsum, 1);
      if (r < N && (lane % 2) == 0) delta[bh * N + r] = dsum;
    }
    const float d0 = __shfl_sync(0xffffffff, dsum, 2 * g);
    const float d1 = __shfl_sync(0xffffffff, dsum, 2 * (g + 8));
    const int r0 = row0 + g, r1 = r0 + 8;
    const float lse0 = r0 < N ? lse[bh * N + r0] : 0.f;
    const float lse1 = r1 < N ? lse[bh * N + r1] : 0.f;

    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int n0 = 0; n0 < n_pad; n0 += 16) {
      float s[2][4], dp[2][4];
      a_times_rows_t<HD>(s, qf, sK, n0, lane);
      a_times_rows_t<HD>(dp, df, sV, n0, lane);
      uint32_t dsf[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int key = n0 + j * 8 + 2 * t + (e & 1);
          float p = key < N ? __expf(s[j][e] * scale - (e < 2 ? lse0 : lse1))
                            : 0.f;
          ds[e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * scale;
        }
        dsf[2 * j] = lt::pack_bf16(ds[0], ds[1]);
        dsf[2 * j + 1] = lt::pack_bf16(ds[2], ds[3]);
      }
      p_times_rows<HD>(acc, dsf, sK, n0, lane);
    }
    store_rows<HD>(dq + b * dq_sb + h * HD, dq_sn, acc, row0, N, lane);
    __syncwarp();
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    flat_attention_bwd_dkdv_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, int n_pad,
        long q_sb, long q_sn, long k_sb, long k_sn, long v_sb, long v_sn,
        long do_sb, long do_sn, long dk_sb, long dk_sn, long dv_sb,
        long dv_sn, float scale) {
  constexpr int S = lt::Tile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sD = sQ + n_pad * S;
  bf16* sW = sD + n_pad * S;  // per warp: 16-row K tile, then V tile
  float* sL = reinterpret_cast<float*>(sW + (blockDim.x / 32) * 32 * S);
  float* sDelta = sL + n_pad;

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int t = lane & 3;
  const long bh = static_cast<long>(b) * H + h;

  lt::load_rows<HD>(sQ, q + b * q_sb + h * HD, q_sn, 0, n_pad, N);
  lt::load_rows<HD>(sD, dout + b * do_sb + h * HD, do_sn, 0, n_pad, N);
  // Padded queries get lse = +inf, so their probabilities are exactly 0.
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    sL[i] = i < N ? lse[bh * N + i] : INFINITY;
    sDelta[i] = i < N ? delta[bh * N + i] : 0.f;
  }
  __syncthreads();

  bf16* sKw = sW + warp * 32 * S;
  bf16* sVw = sKw + 16 * S;
  const int n_tiles = (N + 15) / 16;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int key0 = tile * 16;
    stage_tile<HD>(sKw, k + b * k_sb + h * HD, k_sn, key0, N, lane);
    stage_tile<HD>(sVw, v + b * v_sb + h * HD, v_sn, key0, N, lane);
    __syncwarp();
    uint32_t kf[HD / 16][4], vf[HD / 16][4];
    a_frags<HD>(kf, sKw, lane);
    a_frags<HD>(vf, sVw, lane);

    float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
    for (int n0 = 0; n0 < n_pad; n0 += 16) {
      // Transposed tiles: rows are this warp's keys, columns are queries.
      float st[2][4], dpt[2][4];
      a_times_rows_t<HD>(st, kf, sQ, n0, lane);
      a_times_rows_t<HD>(dpt, vf, sD, n0, lane);
      uint32_t pf[4], dsf[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int qi = n0 + j * 8 + 2 * t + (e & 1);
          p[e] = __expf(st[j][e] * scale - sL[qi]);
          ds[e] = p[e] * (dpt[j][e] - sDelta[qi]) * scale;
        }
        pf[2 * j] = lt::pack_bf16(p[0], p[1]);
        pf[2 * j + 1] = lt::pack_bf16(p[2], p[3]);
        dsf[2 * j] = lt::pack_bf16(ds[0], ds[1]);
        dsf[2 * j + 1] = lt::pack_bf16(ds[2], ds[3]);
      }
      p_times_rows<HD>(dv_acc, pf, sD, n0, lane);
      p_times_rows<HD>(dk_acc, dsf, sQ, n0, lane);
    }
    store_rows<HD>(dk + b * dk_sb + h * HD, dk_sn, dk_acc, key0, N, lane);
    store_rows<HD>(dv + b * dv_sb + h * HD, dv_sn, dv_acc, key0, N, lane);
    __syncwarp();
  }
}

}  // namespace

// dq kernel: also writes delta (B, H, N) fp32 for the dk/dv kernel.
extern "C" int lt_flat_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int N, int H, int hd, const long* strides,
    float scale, void* stream) {
  // strides: (batch, row) pairs for q, k, v, o, do, dq, dk, dv.
  if (hd != 64) return cudaErrorInvalidValue;
  constexpr int HD = 64;
  constexpr int S = lt::Tile<HD>::kStride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long* st = strides;
  const int n_pad = (N + 15) / 16 * 16;
  const int n_warps = min(kMaxWarps, n_pad / 16);
  dim3 grid(H, B);

  const size_t smem_dq = (2 * n_pad + n_warps * 32) * S * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flat_attention_bwd_dq_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  flat_attention_bwd_dq_kernel<HD><<<grid, n_warps * 32, smem_dq, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(delta), N, H, n_pad, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = (2 * n_pad + n_warps * 32) * S * sizeof(bf16) +
                         2 * n_pad * sizeof(float);
  err = cudaFuncSetAttribute(flat_attention_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  flat_attention_bwd_dkdv_kernel<HD><<<grid, n_warps * 32, smem_kv, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H, n_pad, st[0],
      st[1], st[2], st[3], st[4], st[5], st[8], st[9], st[12], st[13], st[14],
      st[15], scale);
  return cudaGetLastError();
}
