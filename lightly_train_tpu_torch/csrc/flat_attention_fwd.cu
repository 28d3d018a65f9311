// Multi-head self-attention, forward: K1 (flat layout) and K4 (per-head
// layout), one kernel, at head dim 16 (fp32 and bf16 q/k/v: the vittest
// sizes). At hd 64, the ViTs' training paths, bf16 is
// flat_attention_fwd_sm90.cu and fp32 flat_attention_fwd_f32_sm90.cu
// (wgmma).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel (K1,
// q/k/v as (B, N, H * hd)) and ::_fwd_kernel (K4, q/k/v as (B, H, N, hd))
// on those routes. The two TPU kernels do the same arithmetic and differ
// only in how a head is addressed, so each tensor here is read or written in
// place through three strides: batch, token and head (the column stride is
// 1). The flat layout and the API layout (B, N, H, hd) have head stride hd,
// the per-head layout has head stride N * hd; no layout is copied or
// transposed. lse is (B, H, N) fp32.
//
// Numerics are the TPU kernel's, not an online softmax: s = (q . k) * scale
// in fp32, m = max over ALL keys, p = exp(s - m) rounded to bf16, l = sum of
// the rounded p in fp32, o = (p . v) / l, lse = m + log(l). The row max is
// found in a first pass over the keys and the probabilities in a second, so
// q . k is computed twice, and every tile of a row uses the same max.
//
// The products run on mma.sync m16n8k16 with fp32 accumulation; fp32
// operands go through it as bf16 hi/lo pairs (three products for q . k, two
// for p . v; see mma.cuh), which keeps about 16 bits of each operand.
//
// Design: each warp owns 16-query tiles; K and V pass through shared memory
// in 16-row steps. The host picks one of two configurations per call (see
// resident_pays in mma.cuh for the rule and the measurements behind it):
//   resident: one block per (batch, head) stages the whole head's K and V
//     once and its warps walk all query tiles; q, k, v and o each cross
//     device memory once. At hd 16 it fits the 227 KB of shared memory a
//     block has at every N <= 768.
//   streamed: one block per (128 queries, head, batch); K (pass 1) and K
//     and V (pass 2) stream through in kStreamRows-row tiles, re-read from
//     L2 by every query block. It serves grids too small to fill the card.
// What bounds it on the H100: at hd 16 a head's products are small beside
// its bytes (at (8, 257, 2, 16), 1.1 MB in fp32 against 68 MFLOP), so
// device memory and the launch bound it; mma.sync (not wgmma), the hi/lo
// products of fp32, the second q . k pass and 8 warps per block keep it
// short of that bound.
#include "mma.cuh"

namespace {

using lt::bf16;
using lt::kMaxWarps;

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, sizeof(T) == 2 ? 2 : 1)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, lt::Geom g, lt::Strides qs,
                         lt::Strides ks, lt::Strides vs, lt::Strides os,
                         float scale) {
  constexpr int P = lt::Planes<T>::value;
  constexpr int S = lt::Tile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int plane = g.rows * S;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // P planes x rows x S
  bf16* sV = sK + P * plane;                     // P planes x rows x S
  bf16* sQ = sV + P * plane;                     // per warp: P x 16 x S

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int t = lane & 3;
  const int N = g.N, n_pad = g.n_pad;
  const bool resident = g.rows >= n_pad;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;

  // K rows [kv0, kv0 + rows) (and V's) into shared memory; a no-op when the
  // head is resident.
  auto stage_kv = [&](int kv0, int rows, bool with_v) {
    if (resident) return;
    __syncthreads();  // every warp is done with the previous tile
    lt::stage_rows<HD, P>(sK, plane, kh, ks.n, kv0, rows, N, threadIdx.x,
                          blockDim.x);
    if (with_v)
      lt::stage_rows<HD, P>(sV, plane, vh, vs.n, kv0, rows, N, threadIdx.x,
                            blockDim.x);
    __syncthreads();
  };
  if (resident) {
    lt::stage_rows<HD, P>(sK, plane, kh, ks.n, 0, n_pad, N, threadIdx.x,
                          blockDim.x);
    lt::stage_rows<HD, P>(sV, plane, vh, vs.n, 0, n_pad, N, threadIdx.x,
                          blockDim.x);
    __syncthreads();
  }

  bf16* sQw = sQ + warp * P * 16 * S;
  const int t_end = min((qb + 1) * g.tiles, n_pad / 16);
  // Every warp runs every iteration (inactive ones only join the staging).
  for (int base = qb * g.tiles; base < t_end; base += n_warps) {
    const bool active = base + warp < t_end;
    const int row0 = (base + warp) * 16;
    uint32_t qf[P][HD / 16][4];
    if (active) {
      lt::stage_rows<HD, P>(sQw, 16 * S, qh, qs.n, row0, 16, N, lane, 32);
      __syncwarp();
      lt::a_frags<HD, P>(qf, sQw, 16 * S, lane);
      __syncwarp();
    }

    // Pass 1: row maxima over all keys (rows g and g + 8 of the tile).
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int kv0 = 0; kv0 < n_pad; kv0 += g.rows) {
      const int rows = min(g.rows, n_pad - kv0);
      stage_kv(kv0, rows, false);
      if (!active) continue;
      for (int n0 = 0; n0 < rows; n0 += 16) {
        float s[2][4];
        lt::a_times_rows_t<HD, P, P>(s, qf, sK, plane, n0, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + n0 + j * 8 + 2 * t + (e & 1);
            const float val = key < N ? s[j][e] * scale : -INFINITY;
            if (e < 2)
              m0 = fmaxf(m0, val);
            else
              m1 = fmaxf(m1, val);
          }
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffff, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffff, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffff, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffff, m1, 2));

    // Pass 2: p = bf16(exp(s - m)), l += p, acc += p . v. Keys past N get
    // p = 0 in every tile.
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int kv0 = 0; kv0 < n_pad; kv0 += g.rows) {
      const int rows = min(g.rows, n_pad - kv0);
      stage_kv(kv0, rows, true);
      if (!active) continue;
      for (int n0 = 0; n0 < rows; n0 += 16) {
        float s[2][4];
        lt::a_times_rows_t<HD, P, P>(s, qf, sK, plane, n0, lane);
        uint32_t pf[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + n0 + j * 8 + 2 * t + (e & 1);
            p[e] = key < N ? lt::bf16_round(__expf(s[j][e] * scale -
                                                   (e < 2 ? m0 : m1)))
                           : 0.f;
          }
          l0 += p[0] + p[1];
          l1 += p[2] + p[3];
          pf[2 * j] = lt::pack_bf16(p[0], p[1]);
          pf[2 * j + 1] = lt::pack_bf16(p[2], p[3]);
        }
        lt::p_times_rows<HD, P>(acc, pf, sV, plane, n0, lane);
      }
    }
    if (!active) continue;
    l0 += __shfl_xor_sync(0xffffffff, l0, 1);
    l0 += __shfl_xor_sync(0xffffffff, l0, 2);
    l1 += __shfl_xor_sync(0xffffffff, l1, 1);
    l1 += __shfl_xor_sync(0xffffffff, l1, 2);
    lt::store_rows<HD>(o + b * os.b + h * os.h, os.n, acc, row0, N, lane, l0,
                       l1);
    if (t == 0) {
      const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
      float* lh = lse + (static_cast<long>(b) * gridDim.y + h) * N;
      if (r0 < N) lh[r0] = m0 + logf(l0);
      if (r1 < N) lh[r1] = m1 + logf(l1);
    }
  }
}

template <typename T, int HD>
size_t fwd_smem(int rows, int n_warps) {
  constexpr int P = lt::Planes<T>::value;
  return static_cast<size_t>(2 * P * rows + n_warps * P * 16) *
         lt::Tile<HD>::kStride * sizeof(bf16);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int N, int H, const long* st, float scale,
           cudaStream_t stream) {
  const int n_tiles = (N + 15) / 16;
  const int n_warps = min(kMaxWarps, n_tiles);
  const lt::Geom g = lt::pick_geometry(N, static_cast<long>(B) * H, n_warps,
                                       fwd_smem<T, HD>);
  const size_t smem = fwd_smem<T, HD>(g.rows, n_warps);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tiles + g.tiles - 1) / g.tiles, H, B);
  attention_fwd_kernel<T, HD><<<grid, n_warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      g, lt::strides_of(st, 0), lt::strides_of(st, 1), lt::strides_of(st, 2),
      lt::strides_of(st, 3), scale);
  return cudaGetLastError();
}

}  // namespace

// strides: (batch, token, head) for q, k, v, o. fp32: 0 for bf16 tensors,
// 1 for fp32 ones. hd 16 only: hd 64 is lt_attention_fwd_sm90's (bf16) and
// lt_attention_fwd_f32_sm90's (fp32).
extern "C" int lt_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int fp32, int B, int N,
                                int H, int hd, const long* strides,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1) return cudaErrorInvalidValue;
#define LT_FWD(T, HD) \
  launch<T, HD>(q, k, v, o, lse, B, N, H, strides, scale, s)
  if (hd == 16) return fp32 ? LT_FWD(float, 16) : LT_FWD(bf16, 16);
#undef LT_FWD
  return cudaErrorInvalidValue;
}
