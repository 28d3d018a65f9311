// Multi-head self-attention, backward, at head dim 16 on Hopper's warpgroup
// tensor-core products: K2 (flat layout) and K5 (per-head layout), one
// kernel template for both dtypes, launched by flat_attention_bwd_sm90.cu
// (bf16) and flat_attention_bwd_f32_sm90.cu (fp32) when hd = 16.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel (K2)
// and ::_bwd_kernel (K5) at hd 16, the vittest ViTs' head dim. Tensors are
// read and written in place through three strides (batch, token, head), as
// at hd 64; lse is the forward's (B, H, N) fp32 log-sum-exp.
//
// Numerics are the TPU kernel's, as in the hd-64 backwards:
//   p  = exp(s - lse)                  (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . bf16(do)          dp = bf16(do) . v^T
//   delta = rowsum(do * o)             (fp32, from the unrounded inputs)
//   ds = bf16(p * (dp - delta) * scale)   (the fp32 p, not bf16(p))
//   dq = ds . k                        dk = ds^T . q
// with fp32 accumulation in every product. exp is 2^(s * scale log2 e -
// lse log2 e), ex2.approx.ftz with log2 e folded into one FFMA, and ds is
// p * (dp * scale - delta * scale): for hd 16's scale 1/4 that is
// p * (dp - delta) * scale to the bit. fp32 q, k and v enter the bf16
// tensor cores as hi/lo planes (mma.cuh), and do as its hi plane, which is
// bf16_rn(do), the TPU kernel's do16:
//   s  = q . k^T:    q_hi.k_hi + q_hi.k_lo + q_lo.k_hi   (lo.lo dropped)
//   dp = do16 . v^T: do16.v_hi + do16.v_lo
//   dv = p16^T . do16       dq = ds . k_hi + ds . k_lo
//   dk = ds^T . q_hi + ds^T . q_lo
//
// What bounds it on an H100: at (8, 257, 2, 16) the bytes (q, k, v, o, do
// in, dq, dk, dv out) are 1.1 MB in bf16, 0.3 us at 3.35 TB/s, and the
// products (5 of 2 N^2 hd a head) 169 MFLOP, 0.2 us at the bf16 tensor
// peak: nothing. A launch, the staging of a head's tiles and
// the chain of dependent products a warpgroup runs set the time, so the
// design is the hd-16 forward's (attention_fwd_hd16.cuh) where it can be:
//   - One launch, grid (2 nb, H, B) with nb = ceil(nt / 2) blocks a role
//     (nt = ceil(N / 64) tiles), two warpgroups a block, each owning 64
//     rows: blocks x < nb take the dq role for query tiles 2x and 2x + 1,
//     the others the dk/dv role for two key tiles. s and dp are computed in
//     both roles, so every output element is written by one warpgroup, with
//     no atomics, and the result is deterministic. delta needs no second
//     launch: each block forms it for the query rows it stages.
//   - A block stages, behind one commit group and one barrier, its own two
//     tiles (Q, dO and O; or K and V) and all of the head's walked tiles (K
//     and V; or Q, dO and O), and the lse of its query rows (N <= 768: 12
//     tiles of 2 KB per bf16 plane; 87 KB in bf16, 167 KB in fp32 at
//     N = 768). Two warpgroups a block stage each walked tile once for two
//     owned ones: with one, every block read the whole walked side of its
//     head, and the copies took most of a block's time at the vittest14
//     global shape. fp32 rows land raw by cp.async in the slots of their hi
//     and lo planes and the thread that copied a chunk splits it in place
//     (sm90.cuh); it also sums its part of delta from the chunks of O and
//     dO it copied, before the split, so delta is from the unrounded
//     values. Each warpgroup copies every other walked tile, and a block
//     barrier then makes them visible to both.
//   - The products then run back to back, one walked tile a step, with no
//     ring and no barrier between tiles: dS in registers, then dQ += dS . K
//     and the next tile's S and dP in one batch (dk/dv role: P^T and dS^T,
//     then dV and dK in one batch and the next S^T and dP^T in another,
//     which keeps ptxas from serializing the products). S and dP are single
//     k16 steps of m64nNk16 (both operands K-major); dQ += dS . K,
//     dV += P^T . dO and dK += dS^T . Q are m64n16k16 steps with the
//     register A operand and the walked tile read MN-major.
//   - The last walked tile first, on its own, at the narrowest wgmma width
//     that covers it (16, 32, 48 or 64), as the forward does: keys past N
//     get p = 0 by index (dq role), queries past N lse = +inf (dk/dv role).
//   - N <= 64 (one tile, the local views) is its own instantiation, one
//     warpgroup a head in the TPU kernel's one-step form: S^T and dP^T,
//     then dV and dK, then S and dP recomputed un-transposed, then dQ. Four
//     waits on products.
//   - The copies are branch-free in their count, the role is uniform over
//     the block and the warpgroup index warp-uniform, and every register a
//     batch of products reads is defined before its fence, so ptxas keeps
//     the products asynchronous.
#pragma once

#include "sm90.cuh"

namespace lt {
namespace sm90 {
namespace hd16 {

constexpr int kGroups = 2;  // warpgroups (own tiles) a block, N > 64

// dP = dO16 . V^T, or with kTransposed dP^T = V . dO16^T: dO16 is its
// tile's hi plane, V one chain from a bf16 plane or V_hi + V_lo.
template <int P, int NK, bool kTransposed>
__device__ __forceinline__ void dp_scores(float (&dp)[32], uint32_t sD,
                                          uint32_t sV) {
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const uint32_t v = sV + c * G::kTileBytes;
    if constexpr (kTransposed)
      issue_scores<NK, kHD>(dp, v, sD, c == 0);
    else
      issue_scores<NK, kHD>(dp, sD, v, c == 0);
  }
}

// acc (64 x 16) += A . B over NK rows of the tile at sB (MN-major), A in
// registers: one chain from a bf16 plane, B_hi + B_lo from fp32 planes.
template <int P, int NK>
__device__ __forceinline__ void products(float (&acc)[8],
                                         const uint32_t (&a)[4][4],
                                         uint32_t sB) {
#pragma unroll
  for (int c = 0; c < P; ++c)
    issue_pv<NK, kHD>(acc, a, sB + c * G::kTileBytes);
}

// dq role, one key tile of NK keys from kv0 (at sK, V after it): S and dP
// are in s and dp. dS into the register A operand, then dQ += dS . K and
// `next` (the next tile's S and dP, or nothing) in one batch. c0/c1 are lse
// log2 e and d0/d1 delta * scale of this thread's rows g and g + 8; with
// kMask keys at or past N get p = 0 (only the last tile has any).
template <int P, int NK, bool kMask, typename Next>
__device__ __forceinline__ void dq_step(float (&s)[32], float (&dp)[32],
                                        float (&acc)[8], uint32_t sK, int kv0,
                                        int N, float scale2, float scale,
                                        int t, float c0, float c1, float d0,
                                        float d1, Next next) {
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + j * 8 + 2 * t + (e & 1);
      const float x = exp2_ftz(fmaf(s[4 * j + e], scale2, e < 2 ? -c0 : -c1));
      const float p = !kMask || key < N ? x : 0.f;
      ds[e] = p * fmaf(dp[4 * j + e], scale, e < 2 ? -d0 : -d1);
    }
    a[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);      // row g
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);  // row g + 8
  }
  // Every register the products read is defined before the fence.
  fence_registers(acc);
  fence_fragments<NK>(a);
  wgmma_fence();
  products<P, NK>(acc, a, sK);
  next();
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(acc);
  fence_registers(s);
  fence_registers(dp);
}

// dk/dv role, one query tile of NK queries (at sQ, dO after it; st_l and
// st_d hold lse log2 e and delta * scale by query from q0, +inf and 0 past
// N): S^T and dP^T are in s and dp. P^T and dS^T into register A operands,
// then dV += P^T . dO16 and dK += dS^T . Q in one batch and `next` in a
// second: with all of them in flight at once (P^T, dS^T and the next S^T
// and dP^T pinned together) ptxas serialized the products (C7511, C7512).
template <int P, int NK, typename Next>
__device__ __forceinline__ void dkdv_step(float (&s)[32], float (&dp)[32],
                                          float (&dk)[8], float (&dv)[8],
                                          uint32_t sQ, uint32_t sD,
                                          const float* st_l,
                                          const float* st_d, int q0,
                                          float scale2, float scale, int t,
                                          Next next) {
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int col = q0 + j * 8 + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(st_l + col);
    const float2 d = *reinterpret_cast<const float2*>(st_d + col);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(fmaf(s[4 * j + e], scale2, e & 1 ? -l.y : -l.x));
      ds[e] = p[e] * fmaf(dp[4 * j + e], scale, e & 1 ? -d.y : -d.x);
    }
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);       // key row g
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);   // g + 8
    da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
  }
  fence_registers(dk);
  fence_registers(dv);
  fence_fragments<NK>(pa);
  fence_fragments<NK>(da);
  wgmma_fence();
  issue_pv<NK, kHD>(dv, pa, sD);
  products<P, NK>(dk, da, sQ);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dk);
  fence_registers(dv);
  wgmma_fence();
  next();
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dk);
  fence_registers(dv);
  fence_registers(s);
  fence_registers(dp);
}

// The eight values of chunk c of row r of a tile of T as it landed (an fp32
// chunk's first four floats in its hi slot, the last four in its lo slot).
__device__ __forceinline__ void landed(float (&x)[8], uint32_t tile, int r,
                                       int c, bf16) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(chunk_at<kHD>(tile, r, c))
               : "memory");
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void landed(float (&x)[8], uint32_t tile, int r,
                                       int c, float) {
  const uint32_t at = chunk_at<kHD>(tile, r, c);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[4 * h]), "=f"(x[4 * h + 1]), "=f"(x[4 * h + 2]),
                   "=f"(x[4 * h + 3])
                 : "r"(at + h * G::kTileBytes)
                 : "memory");
}

// Walks the dq role's key tiles (slot i at k0 + i * stride: K, then V):
// the last first, masked at its narrowest width, then the whole ones.
template <int P>
__device__ __forceinline__ void dq_walk(float (&acc)[8], uint32_t sQ,
                                        uint32_t sD, uint32_t k0,
                                        uint32_t stride, int nt, int tail16,
                                        int N, float scale2, float scale,
                                        int t, float c0, float c1, float d0,
                                        float d1) {
  constexpr uint32_t kPlanes = P * G::kTileBytes;
  float s[32], dp[32];
  const int last = nt - 1;
  const uint32_t sKl = k0 + last * stride;
  auto next = [&](uint32_t sK) {
    return [&, sK] {
      scores<P, kRows>(s, sQ, sK);
      dp_scores<P, kRows, false>(dp, sD, sK + kPlanes);
    };
  };
#define LT_TAIL(W)                                                       \
  wgmma_fence();                                                         \
  scores<P, W>(s, sQ, sKl);                                              \
  dp_scores<P, W, false>(dp, sD, sKl + kPlanes);                         \
  wgmma_commit();                                                        \
  wgmma_wait<0>();                                                       \
  fence_registers(s);                                                    \
  fence_registers(dp);                                                   \
  dq_step<P, W, true>(s, dp, acc, sKl, last * kRows, N, scale2, scale, t, \
                      c0, c1, d0, d1, next(k0))
  LT_BY_TAIL(tail16, LT_TAIL);
#undef LT_TAIL
  for (int j = 0; j + 1 < last; ++j)
    dq_step<P, kRows, false>(s, dp, acc, k0 + j * stride, j * kRows, N,
                             scale2, scale, t, c0, c1, d0, d1,
                             next(k0 + (j + 1) * stride));
  dq_step<P, kRows, false>(s, dp, acc, k0 + (last - 1) * stride,
                           (last - 1) * kRows, N, scale2, scale, t, c0, c1,
                           d0, d1, [] {});
}

// Walks the dk/dv role's query tiles (slot i at q0 + i * stride: Q, then
// dO) as dq_walk does; queries past N have lse = +inf, so p = 0.
template <int P>
__device__ __forceinline__ void dkdv_walk(float (&dk)[8], float (&dv)[8],
                                          uint32_t sK, uint32_t sV,
                                          uint32_t q0, uint32_t stride,
                                          int nt, int tail16,
                                          const float* st_l,
                                          const float* st_d, float scale2,
                                          float scale, int t) {
  constexpr uint32_t kPlanes = P * G::kTileBytes;
  float s[32], dp[32];
  const int last = nt - 1;
  const uint32_t sQl = q0 + last * stride;
  auto next = [&](uint32_t sQ) {
    return [&, sQ] {
      scores<P, kRows>(s, sK, sQ);
      dp_scores<P, kRows, true>(dp, sQ + kPlanes, sV);
    };
  };
#define LT_TAIL(W)                                                        \
  wgmma_fence();                                                          \
  scores<P, W>(s, sK, sQl);                                               \
  dp_scores<P, W, true>(dp, sQl + kPlanes, sV);                           \
  wgmma_commit();                                                         \
  wgmma_wait<0>();                                                        \
  fence_registers(s);                                                     \
  fence_registers(dp);                                                    \
  dkdv_step<P, W>(s, dp, dk, dv, sQl, sQl + kPlanes, st_l, st_d,          \
                  last * kRows, scale2, scale, t, next(q0))
  LT_BY_TAIL(tail16, LT_TAIL);
#undef LT_TAIL
  for (int j = 0; j + 1 < last; ++j) {
    const uint32_t sQ = q0 + j * stride;
    dkdv_step<P, kRows>(s, dp, dk, dv, sQ, sQ + kPlanes, st_l, st_d,
                        j * kRows, scale2, scale, t, next(sQ + stride));
  }
  const uint32_t sQe = q0 + (last - 1) * stride;
  dkdv_step<P, kRows>(s, dp, dk, dv, sQe, sQe + kPlanes, st_l, st_d,
                      (last - 1) * kRows, scale2, scale, t, [] {});
}

// kOneTile: N <= 64, one warpgroup a head computing dq, dk and dv; else
// kGroups warpgroups a block, each owning one tile of the block's role.
// Both forms are held to 128 registers, so that four warpgroups share an
// SM.
template <typename T, bool kOneTile>
__global__ void __launch_bounds__(kOneTile ? kThreads : kGroups * kThreads,
                                  kOneTile ? 4 : 2)
    attention_bwd_hd16_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ o,
        const T* __restrict__ dout, const float* __restrict__ lse,
        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int N,
        Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
        Strides dqs, Strides dks, Strides dvs, float scale) {
  constexpr int P = Planes<T>::value;
  constexpr uint32_t kPlanes = P * G::kTileBytes;  // a tile's bf16 planes
  constexpr uint32_t kQSlot = 3 * kPlanes;  // Q, dO, O (raw: no split)
  constexpr uint32_t kKSlot = 2 * kPlanes;  // K, V
  constexpr int kOwn = kOneTile ? 1 : kGroups;  // own tiles a block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // The warpgroup's index through a shuffle, so that ptxas sees it (and
  // every branch on it around the products) as warp-uniform.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nt = kOneTile ? 1 : (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width
  // The role, uniform over the block: the dq role stages its query tiles
  // and every key tile, the dk/dv role its key tiles and every query tile.
  const int per_role = (nt + kOwn - 1) / kOwn;  // blocks a role
  const bool dq_role = kOneTile || static_cast<int>(blockIdx.x) < per_role;
  const int own = (dq_role ? blockIdx.x : blockIdx.x - per_role) * kOwn + wg;
  const uint32_t own_slot = dq_role ? kQSlot : kKSlot;
  const uint32_t walk_slot = dq_role ? kKSlot : kQSlot;
  // This warpgroup's own slot, the walked slots, then lse log2 e and
  // delta * scale of the staged query rows (nq tiles of them).
  const uint32_t mine = base + wg * own_slot, walks = base + kOwn * own_slot;
  const uint32_t stats = walks + nt * walk_slot;
  const int nq = dq_role ? kOwn : nt;
  float* st_l = reinterpret_cast<float*>(smem_raw + (stats - raw));
  float* st_d = st_l + nq * kRows;
  const float* lse_h = lse + (static_cast<long>(b) * gridDim.y + h) * N;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* doh = dout + b * dos.b + h * dos.h;
  const T* oh = o + b * os.b + h * os.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;

  // Each warpgroup stages its own tile and every kOwn-th walked tile, all
  // behind one commit group; thread tid copies chunk tid % 2 of row tid / 2
  // of each of them, and the lse of that row of a query tile (stats row
  // srow + r). Rows at or past N are zero-filled.
  const int r = tid >> 1, c = tid & 1;
  auto stage_query = [&](uint32_t slot, int row0, int srow) {
    stage(slot, qh, qs.n, row0, N, tid);
    stage(slot + kPlanes, doh, dos.n, row0, N, tid);
    stage(slot + 2 * kPlanes, oh, os.n, row0, N, tid);
    if (c == 0) {
      const bool valid = row0 + r < N;
      cp_async4(stats + 4 * (srow + r), lse_h + (valid ? row0 + r : 0),
                valid);
    }
  };
  auto stage_key = [&](uint32_t slot, int row0) {
    stage(slot, kh, ks.n, row0, N, tid);
    stage(slot + kPlanes, vh, vs.n, row0, N, tid);
  };
  // delta from the O and dO chunks this thread copied (unrounded), summed
  // with the other half of the row, and lse log2 e (+inf past N).
  auto query_stats = [&](uint32_t slot, int row0, int srow) {
    float x[8], y[8];
    landed(x, slot + kPlanes, r, c, T());
    landed(y, slot + 2 * kPlanes, r, c, T());
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
    sum += __shfl_xor_sync(0xffffffff, sum, 1);
    if (c)
      st_d[srow + r] = sum * scale;
    else
      st_l[srow + r] = row0 + r < N ? st_l[srow + r] * kLog2e : INFINITY;
  };
  auto split = [&](uint32_t slot) {
    if constexpr (P == 2) {
      split_tile<kThreads, kHD>(slot, tid);
      split_tile<kThreads, kHD>(slot + kPlanes, tid);  // dO (hi) or V
    }
  };
  if (dq_role) {
    stage_query(mine, own * kRows, wg * kRows);
    for (int i = wg; i < nt; i += kOwn) stage_key(walks + i * kKSlot, i * kRows);
  } else {
    stage_key(mine, own * kRows);
    for (int i = wg; i < nt; i += kOwn)
      stage_query(walks + i * kQSlot, i * kRows, i * kRows);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if (dq_role) {
    query_stats(mine, own * kRows, wg * kRows);
    split(mine);
    for (int i = wg; i < nt; i += kOwn) split(walks + i * kKSlot);
  } else {
    split(mine);
    for (int i = wg; i < nt; i += kOwn) {
      query_stats(walks + i * kQSlot, i * kRows, i * kRows);
      split(walks + i * kQSlot);
    }
  }
  fence_async_shared();
  __syncthreads();

  const float scale2 = scale * kLog2e;
  const int rr = warp * 16 + g;  // this thread's rows rr and rr + 8
  const int r0 = own * kRows + rr;
  if constexpr (kOneTile) {
    const uint32_t sQ = mine, sD = sQ + kPlanes;
    const uint32_t sK = walks, sV = sK + kPlanes;
    float s[32], dp[32], dqa[8], dka[8], dva[8];
    zero(dqa);
    zero(dka);
    zero(dva);
    const float c0 = st_l[rr], c1 = st_l[rr + 8];
    const float d0 = st_d[rr], d1 = st_d[rr + 8];
#define LT_ONE(W)                                                         \
  wgmma_fence();                                                          \
  scores<P, W>(s, sK, sQ);                                                \
  dp_scores<P, W, true>(dp, sD, sV);                                      \
  wgmma_commit();                                                         \
  wgmma_wait<0>();                                                        \
  fence_registers(s);                                                     \
  fence_registers(dp);                                                    \
  dkdv_step<P, W>(s, dp, dka, dva, sQ, sD, st_l, st_d, 0, scale2, scale,  \
                  t, [&] {                                                \
                    scores<P, W>(s, sQ, sK);                              \
                    dp_scores<P, W, false>(dp, sD, sV);                   \
                  });                                                     \
  dq_step<P, W, true>(s, dp, dqa, sK, 0, N, scale2, scale, t, c0, c1, d0, \
                      d1, [] {})
    LT_BY_TAIL(tail16, LT_ONE);
#undef LT_ONE
    store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, dqa, rr, N, t);
    store_rows(dk + b * dks.b + h * dks.h, dks.n, dka, rr, N, t);
    store_rows(dv + b * dvs.b + h * dvs.h, dvs.n, dva, rr, N, t);
  } else if (own < nt) {  // the last block of a role may have a tile less
    if (dq_role) {
      const int sr = wg * kRows + rr;
      float acc[8];
      zero(acc);
      dq_walk<P>(acc, mine, mine + kPlanes, walks, kKSlot, nt, tail16, N,
                 scale2, scale, t, st_l[sr], st_l[sr + 8], st_d[sr],
                 st_d[sr + 8]);
      store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, acc, r0, N, t);
    } else {
      float dka[8], dva[8];
      zero(dka);
      zero(dva);
      dkdv_walk<P>(dka, dva, mine, mine + kPlanes, walks, kQSlot, nt,
                   tail16, st_l, st_d, scale2, scale, t);
      store_rows(dk + b * dks.b + h * dks.h, dks.n, dka, r0, N, t);
      store_rows(dv + b * dvs.b + h * dvs.h, dvs.n, dva, r0, N, t);
    }
  }
}

// The launch at hd 16 (N <= 768), as the C entries of the backward sources
// take their arguments (strides: q, k, v, o, do, dq, dk, dv).
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dq, void* dk,
               void* dv, int B, int N, int H, const long* strides,
               float scale, void* stream) {
  const int nt = (N + kRows - 1) / kRows;
  if (N < 1 || nt > kMaxTiles) return cudaErrorInvalidValue;
  constexpr int P = Planes<T>::value;
  const bool one = nt == 1;
  // The most either role stages: one tile, Q, dO, O and K, V; else the
  // dk/dv role's, every query tile (3 planes) and kGroups key tiles (2).
  const int tiles = one ? 5 : 3 * nt + 2 * kGroups;
  const size_t smem = 1024 + static_cast<size_t>(P * tiles) * G::kTileBytes +
                      2 * nt * kRows * sizeof(float);
  auto kernel = one ? attention_bwd_hd16_kernel<T, true>
                    : attention_bwd_hd16_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int per_role = (nt + kGroups - 1) / kGroups;
  kernel<<<dim3(one ? 1 : 2 * per_role, H, B),
           one ? kThreads : kGroups * kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), N,
      strides_of(strides, 0), strides_of(strides, 1), strides_of(strides, 2),
      strides_of(strides, 3), strides_of(strides, 4), strides_of(strides, 5),
      strides_of(strides, 6), strides_of(strides, 7), scale);
  return cudaGetLastError();
}

}  // namespace hd16
}  // namespace sm90
}  // namespace lt
