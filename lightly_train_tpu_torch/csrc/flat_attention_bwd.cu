// Multi-head self-attention, backward: K2 (flat layout) and K5 (per-head
// layout), as two kernels, at head dim 16 for bf16 and fp32 q/k/v. Head dim
// 64, the ViT's training path, is flat_attention_bwd_sm90.cu (bf16) and
// flat_attention_bwd_f32_sm90.cu (fp32), both wgmma.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel (K2)
// and ::_bwd_kernel (K5) at hd 16. Same layouts, strides and types as the
// forward (attention_fwd_hd16.cuh at hd 16); lse is the forward's (B, H, N)
// fp32 log-sum-exp. The TPU kernel's numerics:
//   p  = exp(s - lse)                   (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . bf16(do)           dp = bf16(do) . v^T
//   delta = rowsum(do * o)              (fp32, from the unrounded inputs)
//   ds = bf16(p * (dp - delta) * scale)
//   dq = ds . k                         dk = ds^T . q
// with fp32 accumulation in every product; fp32 q, k and v enter the
// products as bf16 hi/lo pairs (mma.cuh), do is rounded to bf16 as the TPU
// kernel rounds it.
//
// The TPU kernel keeps a whole (N, N) score matrix in VMEM and does all five
// products for one head in one grid step. On the H100 a block holds far less
// fast memory and blocks cannot pass sums to each other, so the work splits
// by which operand a block walks:
//   dq kernel: each warp owns 16-query tiles, walks all keys with K and V
//     in shared memory, and writes dq and the row's delta (fp32, to a
//     (B, H, N) scratch).
//   dk/dv kernel: each warp owns 16-key tiles, walks all queries with Q, do,
//     lse and delta in shared memory, working on the transposed scores, and
//     writes dk and dv.
// s and p are recomputed in both (the scores are never stored). The host
// picks per kernel and call whether the walked operands are resident (one
// block per (batch, head), staged once; at hd 16 they fit in the 227 KB of
// shared memory at every N <= 768 in both dtypes) or streamed in
// kStreamRows-row tiles by blocks of 128 rows (small grids); the rule is
// resident_pays in mma.cuh.
// What bounds it on the H100: at hd 16 the products (N^2 hd a head, 5 of
// them) are small beside the bytes moved (q, k, v, o, do in; dq, dk, dv
// out) up to N of a few hundred; the ViT-B/14 paths never launch it (hd 16
// is the vittest size). The design reads q, k, v and do twice and computes
// q . k and do . v twice to avoid any cross-block reduction.
#include "mma.cuh"

namespace {

using lt::bf16;
using lt::kMaxWarps;

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, sizeof(T) == 2 ? 2 : 1)
    attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ o,
        const T* __restrict__ dout, const float* __restrict__ lse,
        T* __restrict__ dq, float* __restrict__ delta, lt::Geom g,
        lt::Strides qs, lt::Strides ks, lt::Strides vs, lt::Strides os,
        lt::Strides dos, lt::Strides dqs, float scale) {
  constexpr int P = lt::Planes<T>::value;
  constexpr int S = lt::Tile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int plane = g.rows * S;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // P planes x rows x S
  bf16* sV = sK + P * plane;                     // P planes x rows x S
  bf16* sW = sV + P * plane;  // per warp: Q (P planes), then do, 16 x S each

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int gq = lane >> 2, t = lane & 3;
  const int N = g.N, n_pad = g.n_pad;
  const bool resident = g.rows >= n_pad;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;

  auto stage_kv = [&](int kv0, int rows) {
    lt::stage_rows<HD, P>(sK, plane, kh, ks.n, kv0, rows, N, threadIdx.x,
                          blockDim.x);
    lt::stage_rows<HD, P>(sV, plane, vh, vs.n, kv0, rows, N, threadIdx.x,
                          blockDim.x);
  };
  if (resident) {
    stage_kv(0, n_pad);
    __syncthreads();
  }

  bf16* sQw = sW + warp * (P + 1) * 16 * S;
  bf16* sDw = sQw + P * 16 * S;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* oh = o + b * os.b + h * os.h;
  const T* doh = dout + b * dos.b + h * dos.h;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  const int t_end = min((qb + 1) * g.tiles, n_pad / 16);
  for (int base = qb * g.tiles; base < t_end; base += n_warps) {
    const bool active = base + warp < t_end;
    const int row0 = (base + warp) * 16;
    uint32_t qf[P][HD / 16][4], df[1][HD / 16][4];
    float d0 = 0.f, d1 = 0.f, lse0 = 0.f, lse1 = 0.f;
    if (active) {
      lt::stage_rows<HD, P>(sQw, 16 * S, qh, qs.n, row0, 16, N, lane, 32);
      lt::stage_rows<HD, 1>(sDw, 16 * S, doh, dos.n, row0, 16, N, lane, 32);
      __syncwarp();
      lt::a_frags<HD, P>(qf, sQw, 16 * S, lane);
      lt::a_frags<HD, 1>(df, sDw, 16 * S, lane);

      // delta for row (row0 + lane / 2): two lanes per row, HD / 2 columns
      // each, from the unrounded o and do.
      float dsum = 0.f;
      const int r = row0 + lane / 2;
      if (r < N) {
        const int c0 = (lane % 2) * (HD / 2);
        for (int c = c0; c < c0 + HD / 2; c += 2) {
          const float2 ov = lt::load2(oh + r * os.n + c);
          const float2 dv = lt::load2(doh + r * dos.n + c);
          dsum += ov.x * dv.x;
          dsum += ov.y * dv.y;
        }
      }
      dsum += __shfl_xor_sync(0xffffffff, dsum, 1);
      if (r < N && (lane % 2) == 0) delta[bh * N + r] = dsum;
      d0 = __shfl_sync(0xffffffff, dsum, 2 * gq);
      d1 = __shfl_sync(0xffffffff, dsum, 2 * (gq + 8));
      const int r0 = row0 + gq, r1 = r0 + 8;
      lse0 = r0 < N ? lse[bh * N + r0] : 0.f;
      lse1 = r1 < N ? lse[bh * N + r1] : 0.f;
    }

    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kv0 = 0; kv0 < n_pad; kv0 += g.rows) {
      const int rows = min(g.rows, n_pad - kv0);
      if (!resident) {
        __syncthreads();  // every warp is done with the previous tile
        stage_kv(kv0, rows);
        __syncthreads();
      }
      if (!active) continue;
      for (int n0 = 0; n0 < rows; n0 += 16) {
        float s[2][4], dp[2][4];
        lt::a_times_rows_t<HD, P, P>(s, qf, sK, plane, n0, lane);
        lt::a_times_rows_t<HD, 1, P>(dp, df, sV, plane, n0, lane);
        uint32_t dsf[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + n0 + j * 8 + 2 * t + (e & 1);
            const float p =
                key < N ? __expf(s[j][e] * scale - (e < 2 ? lse0 : lse1))
                        : 0.f;
            ds[e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * scale;
          }
          dsf[2 * j] = lt::pack_bf16(ds[0], ds[1]);
          dsf[2 * j + 1] = lt::pack_bf16(ds[2], ds[3]);
        }
        lt::p_times_rows<HD, P>(acc, dsf, sK, plane, n0, lane);
      }
    }
    if (!active) continue;
    lt::store_rows<HD>(dq + b * dqs.b + h * dqs.h, dqs.n, acc, row0, N, lane);
    __syncwarp();
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    attention_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, lt::Geom g, lt::Strides qs,
        lt::Strides ks, lt::Strides vs, lt::Strides dos, lt::Strides dks,
        lt::Strides dvs, float scale) {
  constexpr int P = lt::Planes<T>::value;
  constexpr int S = lt::Tile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_warps = blockDim.x / 32;
  const int plane = g.rows * S;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // P planes x rows x S
  bf16* sD = sQ + P * plane;                     // rows x S (bf16 do)
  bf16* sW = sD + plane;  // per warp: K, then V, P planes of 16 x S each
  float* sL = reinterpret_cast<float*>(sW + n_warps * 2 * P * 16 * S);
  float* sDelta = sL + g.rows;

  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int N = g.N, n_pad = g.n_pad;
  const bool resident = g.rows >= n_pad;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* doh = dout + b * dos.b + h * dos.h;

  // Query rows [q0, q0 + rows) of Q, do, lse and delta. Queries past N get
  // lse = +inf, so their probabilities are exactly 0 in every tile.
  auto stage_q = [&](int q0, int rows) {
    lt::stage_rows<HD, P>(sQ, plane, qh, qs.n, q0, rows, N, threadIdx.x,
                          blockDim.x);
    lt::stage_rows<HD, 1>(sD, plane, doh, dos.n, q0, rows, N, threadIdx.x,
                          blockDim.x);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      sL[i] = q0 + i < N ? lse[bh * N + q0 + i] : INFINITY;
      sDelta[i] = q0 + i < N ? delta[bh * N + q0 + i] : 0.f;
    }
  };
  if (resident) {
    stage_q(0, n_pad);
    __syncthreads();
  }

  bf16* sKw = sW + warp * 2 * P * 16 * S;
  bf16* sVw = sKw + P * 16 * S;
  const int t_end = min((kb + 1) * g.tiles, n_pad / 16);
  for (int base = kb * g.tiles; base < t_end; base += n_warps) {
    const bool active = base + warp < t_end;
    const int key0 = (base + warp) * 16;
    uint32_t kf[P][HD / 16][4], vf[P][HD / 16][4];
    if (active) {
      lt::stage_rows<HD, P>(sKw, 16 * S, k + b * ks.b + h * ks.h, ks.n, key0,
                            16, N, lane, 32);
      lt::stage_rows<HD, P>(sVw, 16 * S, v + b * vs.b + h * vs.h, vs.n, key0,
                            16, N, lane, 32);
      __syncwarp();
      lt::a_frags<HD, P>(kf, sKw, 16 * S, lane);
      lt::a_frags<HD, P>(vf, sVw, 16 * S, lane);
    }

    float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
    for (int q0 = 0; q0 < n_pad; q0 += g.rows) {
      const int rows = min(g.rows, n_pad - q0);
      if (!resident) {
        __syncthreads();  // every warp is done with the previous tile
        stage_q(q0, rows);
        __syncthreads();
      }
      if (!active) continue;
      for (int n0 = 0; n0 < rows; n0 += 16) {
        // Transposed tiles: rows are this warp's keys, columns are queries.
        float st[2][4], dpt[2][4];
        lt::a_times_rows_t<HD, P, P>(st, kf, sQ, plane, n0, lane);
        lt::a_times_rows_t<HD, P, 1>(dpt, vf, sD, plane, n0, lane);
        uint32_t pf[4], dsf[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = n0 + j * 8 + 2 * t + (e & 1);
            p[e] = __expf(st[j][e] * scale - sL[qi]);
            ds[e] = p[e] * (dpt[j][e] - sDelta[qi]) * scale;
          }
          pf[2 * j] = lt::pack_bf16(p[0], p[1]);
          pf[2 * j + 1] = lt::pack_bf16(p[2], p[3]);
          dsf[2 * j] = lt::pack_bf16(ds[0], ds[1]);
          dsf[2 * j + 1] = lt::pack_bf16(ds[2], ds[3]);
        }
        lt::p_times_rows<HD, 1>(dv_acc, pf, sD, plane, n0, lane);
        lt::p_times_rows<HD, P>(dk_acc, dsf, sQ, plane, n0, lane);
      }
    }
    if (!active) continue;
    lt::store_rows<HD>(dk + b * dks.b + h * dks.h, dks.n, dk_acc, key0, N,
                       lane);
    lt::store_rows<HD>(dv + b * dvs.b + h * dvs.h, dvs.n, dv_acc, key0, N,
                       lane);
    __syncwarp();
  }
}

template <typename T, int HD>
size_t dq_smem(int rows, int n_warps) {
  constexpr int P = lt::Planes<T>::value;
  return static_cast<size_t>(2 * P * rows + n_warps * (P + 1) * 16) *
         lt::Tile<HD>::kStride * sizeof(bf16);
}

template <typename T, int HD>
size_t dkdv_smem(int rows, int n_warps) {
  constexpr int P = lt::Planes<T>::value;
  return static_cast<size_t>((P + 1) * rows + n_warps * 2 * P * 16) *
             lt::Tile<HD>::kStride * sizeof(bf16) +
         2 * rows * sizeof(float);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int N, int H, const long* st, float scale,
           cudaStream_t stream) {
  const int n_tiles = (N + 15) / 16;
  const int n_warps = min(kMaxWarps, n_tiles);
  const lt::Geom gq = lt::pick_geometry(N, static_cast<long>(B) * H, n_warps,
                                        dq_smem<T, HD>);
  const size_t smem_dq = dq_smem<T, HD>(gq.rows, n_warps);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((n_tiles + gq.tiles - 1) / gq.tiles, H, B);
  attention_bwd_dq_kernel<T, HD><<<grid_dq, n_warps * 32, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), gq,
      lt::strides_of(st, 0), lt::strides_of(st, 1), lt::strides_of(st, 2),
      lt::strides_of(st, 3), lt::strides_of(st, 4), lt::strides_of(st, 5),
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const lt::Geom gk = lt::pick_geometry(N, static_cast<long>(B) * H, n_warps,
                                        dkdv_smem<T, HD>);
  const size_t smem_kv = dkdv_smem<T, HD>(gk.rows, n_warps);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((n_tiles + gk.tiles - 1) / gk.tiles, H, B);
  attention_bwd_dkdv_kernel<T, HD><<<grid_kv, n_warps * 32, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), gk, lt::strides_of(st, 0),
      lt::strides_of(st, 1), lt::strides_of(st, 2), lt::strides_of(st, 4),
      lt::strides_of(st, 6), lt::strides_of(st, 7), scale);
  return cudaGetLastError();
}

}  // namespace

// strides: (batch, token, head) for q, k, v, o, do, dq, dk, dv. fp32: 0 for
// bf16 tensors, 1 for fp32 ones; hd = 16 only. The dq kernel also writes
// delta (B, H, N) fp32 for the dk/dv kernel. hd 64 is lt_attention_bwd_sm90's
// (bf16) and lt_attention_bwd_f32_sm90's (fp32).
extern "C" int lt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, void* dk, void* dv,
                                void* delta, int fp32, int B, int N, int H,
                                int hd, const long* strides, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1) return cudaErrorInvalidValue;
#define LT_BWD(T, HD)                                                      \
  launch<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, N, H, strides, \
                scale, s)
  if (hd == 16) return fp32 ? LT_BWD(float, 16) : LT_BWD(bf16, 16);
#undef LT_BWD
  return cudaErrorInvalidValue;
}
