// Flat-layout multi-head self-attention, forward (K1).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel.
// Inputs q, k, v are (B, N, D) bf16 with D = H * HD, read in place through a
// batch stride and a row stride (so separate q/k/v projections and a fused
// qkv GEMM output both work); head h is the HD contiguous columns at h * HD.
// Outputs o (B, N, D) bf16 (row stride o_sn) and lse (B, H, N) fp32.
//
// Numerics are the TPU kernel's, not an online softmax: s = (q . k) * scale
// in fp32, m = max over ALL keys, p = exp(s - m) rounded to bf16, l = sum of
// the rounded p in fp32, o = (p . v) / l, lse = m + log(l). The row max is
// found in a first pass over the keys and the probabilities in a second, so
// q . k is computed twice; both passes read K from shared memory.
//
// Design: one block per (batch, head). K and V of that head (N rows, padded
// to a multiple of 16 with zeros) are staged once in shared memory; each
// warp takes 16-query tiles in turn and runs mma.sync m16n8k16 (bf16 in,
// fp32 accumulate) over 16-key steps. q, k, v and o each cross device
// memory once. What bounds it on the H100: at the ViT-B/14 global shape
// (B=64, N=257, H=12, HD=64) the 76 MB of q/k/v in and the 25 MB of o out
// need ~30 us at 3.35 TB/s, the 2 x 2 x N^2 x HD x B x H = 13 GFLOP (19.5
// with the recomputed q . k) ~13-20 us at the bf16 tensor peak, so device
// memory bounds it; mma.sync (not wgmma), the second q . k pass and 8 warps
// per block keep it well short of that bound. wgmma, TMA and a
// warp-specialised pipeline are later work.
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 8;

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    flat_attention_fwd_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o,
                              float* __restrict__ lse, int N, int H, int n_pad,
                              long q_sb, long q_sn, long k_sb, long k_sn,
                              long v_sb, long v_sn, long o_sb, long o_sn,
                              float scale) {
  constexpr int S = lt::Tile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // n_pad x S
  bf16* sV = sK + n_pad * S;                     // n_pad x S
  bf16* sQ = sV + n_pad * S;                     // n_warps x 16 x S

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  lt::load_rows<HD>(sK, k + b * k_sb + h * HD, k_sn, 0, n_pad, N);
  lt::load_rows<HD>(sV, v + b * v_sb + h * HD, v_sn, 0, n_pad, N);
  __syncthreads();

  bf16* sQw = sQ + warp * 16 * S;
  const bf16* qh = q + b * q_sb + h * HD;
  const int n_tiles = (N + 15) / 16;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int row0 = tile * 16;
    // Stage this warp's 16 query rows (zero past N) and take A fragments.
    for (int i = lane; i < 16 * (HD / 8); i += 32) {
      int r = i / (HD / 8);
      int c = (i % (HD / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < N)
        val = *reinterpret_cast<const uint4*>(qh + (row0 + r) * q_sn + c);
      *reinterpret_cast<uint4*>(sQw + r * S + c) = val;
    }
    __syncwarp();
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      lt::ldmatrix_x4(qf[kk], sQw + ((lane % 8) + ((lane / 8) % 2) * 8) * S +
                                  kk * 16 + (lane / 16) * 8);
    }
    __syncwarp();

    // s for 16 queries x 16 keys starting at key n0: two 16x8 C tiles.
    auto scores = [&](float (&s)[2][4], int n0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t r[4];
        lt::ldmatrix_x4(r, sK + (n0 + (lane % 8) + (lane / 16) * 8) * S +
                               kk * 16 + ((lane / 8) % 2) * 8);
        lt::mma_bf16(s[0], qf[kk], r[0], r[1]);
        lt::mma_bf16(s[1], qf[kk], r[2], r[3]);
      }
    };

    // Pass 1: row maxima over all keys (rows g and g + 8 of the tile).
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int n0 = 0; n0 < n_pad; n0 += 16) {
      float s[2][4];
      scores(s, n0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int key = n0 + j * 8 + 2 * t + (e & 1);
          float val = key < N ? s[j][e] * scale : -INFINITY;
          if (e < 2)
            m0 = fmaxf(m0, val);
          else
            m1 = fmaxf(m1, val);
        }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffff, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffff, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffff, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffff, m1, 2));

    // Pass 2: p = bf16(exp(s - m)), l += p, acc += p . v.
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int n0 = 0; n0 < n_pad; n0 += 16) {
      float s[2][4];
      scores(s, n0);
      uint32_t pf[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int key = n0 + j * 8 + 2 * t + (e & 1);
          p[e] = key < N ? lt::bf16_round(__expf(s[j][e] * scale -
                                                 (e < 2 ? m0 : m1)))
                         : 0.f;
        }
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        pf[2 * j] = lt::pack_bf16(p[0], p[1]);
        pf[2 * j + 1] = lt::pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int nb = 0; nb < HD / 16; ++nb) {
        uint32_t r[4];
        lt::ldmatrix_x4_trans(
            r, sV + (n0 + (lane % 8) + ((lane / 8) % 2) * 8) * S + nb * 16 +
                   (lane / 16) * 8);
        lt::mma_bf16(acc[2 * nb], pf, r[0], r[1]);
        lt::mma_bf16(acc[2 * nb + 1], pf, r[2], r[3]);
      }
    }
    l0 += __shfl_xor_sync(0xffffffff, l0, 1);
    l0 += __shfl_xor_sync(0xffffffff, l0, 2);
    l1 += __shfl_xor_sync(0xffffffff, l1, 1);
    l1 += __shfl_xor_sync(0xffffffff, l1, 2);

    const int r0 = row0 + g;
    const int r1 = r0 + 8;
    bf16* oh = o + b * o_sb + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      int col = j * 8 + 2 * t;
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(oh + r0 * o_sn + col) =
            lt::pack_bf16(acc[j][0] / l0, acc[j][1] / l0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(oh + r1 * o_sn + col) =
            lt::pack_bf16(acc[j][2] / l1, acc[j][3] / l1);
    }
    if (t == 0) {
      float* lh = lse + (static_cast<long>(b) * H + h) * N;
      if (r0 < N) lh[r0] = m0 + logf(l0);
      if (r1 < N) lh[r1] = m1 + logf(l1);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int N, int H, long q_sb, long q_sn, long k_sb, long k_sn,
           long v_sb, long v_sn, long o_sb, long o_sn, float scale,
           cudaStream_t stream) {
  constexpr int S = lt::Tile<HD>::kStride;
  const int n_pad = (N + 15) / 16 * 16;
  const int n_warps = min(kMaxWarps, n_pad / 16);
  const size_t smem = (2 * n_pad + n_warps * 16) * S * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flat_attention_fwd_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  flat_attention_fwd_kernel<HD><<<grid, n_warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, H, n_pad, q_sb, q_sn, k_sb, k_sn, v_sb,
      v_sn, o_sb, o_sn, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lt_flat_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int N, int H, int hd, long q_sb,
                                     long q_sn, long k_sb, long k_sn,
                                     long v_sb, long v_sn, long o_sb,
                                     long o_sn, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, o, lse, B, N, H, q_sb, q_sn, k_sb, k_sn, v_sb,
                      v_sn, o_sb, o_sn, scale, s);
  return cudaErrorInvalidValue;
}
