// Multi-head self-attention, backward, at head dim 128 on Hopper's
// warpgroup tensor-core products: K2 (flat layout) and K5 (per-head
// layout), one kernel template in three roles, launched by
// flat_attention_bwd_f32_sm90.cu when hd = 128. It is written for both
// dtypes, but bf16 runs attention_bwd_hd128_tma.cuh's two persistent
// TMA-fed kernels instead (dk and dv in one kernel, S^T once), which build
// on this file's arguments (BwdArgs) and numerics.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel (K2)
// and ::_bwd_kernel (K5) at hd 128, the 7B ViTs' head dim (4096 / 32
// heads). Tensors are read and written in place through three strides
// (batch, token, head), as at hd 64; lse is the forward's (B, H, N) fp32
// log-sum-exp; delta is a (B, H, N) fp32 scratch that the dq role writes
// for the dk role.
//
// Numerics are the TPU kernel's:
//   p  = exp(s - lse)                  (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . bf16(do)          dp = bf16(do) . v^T
//   delta = rowsum(do * o)             (fp32, from the unrounded inputs)
//   ds = bf16(p * (dp - delta) * scale)   (the fp32 p, not bf16(p))
//   dq = ds . k                        dk = ds^T . q
// with fp32 accumulation in every product. exp is 2^(s * scale log2 e -
// lse log2 e) with ex2.approx.ftz (subnormal results flushed to 0), as in
// the other backwards. ds is formed as the JAX expression is written,
// (p * (dp - delta)) * scale: hd 128's scale 1/sqrt(128) is not a power of
// two, so the hd-64 form p * (dp * scale - delta * scale) would be one fp32
// rounding away from it. fp32 q, k and v enter the bf16 tensor cores as
// hi/lo planes (mma.cuh), and do as its hi plane, bf16_rn(do), the TPU
// kernel's do16:
//   s  = q . k^T:    q_hi.k_hi + q_hi.k_lo + q_lo.k_hi   (lo.lo dropped)
//   dp = do16 . v^T: do16.v_hi + do16.v_lo
//   dv = p16^T . do16       dq = ds . k_hi + ds . k_lo
//   dk = ds^T . q_hi + ds^T . q_lo
// The fp32 sums are taken in another order than the JAX kernel's: each
// product sums 16 columns a wgmma step and then across steps; delta is two
// 64-column halves of a row, each summed left to right, then added.
//
// What bounds it on an H100: at the 7B/16 student's shape (B=64, N=201,
// H=32) q, k, v, o, do in and dq, dk, dv out are 843 MB in bf16, ~252 us
// at 3.35 TB/s, against 5 necessary N^2 hd products a head, 66 GFLOP,
// ~67 us at the bf16 tensor peak: bytes bound it. This design runs 8
// passes of N^2 hd (s in all three roles, dp in two), 275 GFLOP once N is
// padded to 64-row tiles, ~0.28 ms at the peak.
//
// The problem is registers. The hd-64 dk/dv kernel keeps four 64 x 64
// fp32 accumulators (S^T, dP^T, dV, dK); at hd 128 dV and dK are 64 x 128
// each, and the four come to 192 accumulator registers a thread before any
// address or fragment, which spills or makes ptxas serialize the products.
// So the key side is split into two roles, and every role is a kernel of
// its own, launched in this order:
//   - dq role: a warpgroup owns 64 query rows (Q and dO in shared memory,
//     K-major A operands) and walks every key tile: S = Q . K^T and
//     dP = dO16 . V^T (32 + 32 accumulators), dS in registers, then
//     dQ += dS . K (64 accumulators; dS the register A operand, K read
//     MN-major). It forms delta of its rows from o and do in global memory
//     (two threads a row, while the first copies fly) and writes it.
//   - dv role: a warpgroup owns 64 key rows (K) and walks every query
//     tile: S^T = K . Q^T, P^T in registers, dV += P^T . dO16 (32 + 64
//     accumulators). It needs no delta and no V.
//   - dk role: a warpgroup owns 64 key rows (K and V) and walks every
//     query tile: S^T = K . Q^T and dP^T = V . dO16^T, dS^T in registers,
//     then dK += dS^T . Q (32 + 32 + 64 accumulators, hd 64's count). It
//     reads the dq role's delta, so it launches after it.
//   S^T runs in both key roles: 8 passes of N^2 hd a tile pair against the
//   hd-64 kernels' 7 and the necessary 5. Every output element is written
//   by one warpgroup: no atomics, and the result is deterministic.
//   - N <= 64 takes the same three kernels with one walked tile: the
//     one-tile form of the other head dims would hold the same 192
//     accumulators.
//   - A tile (64 rows x 128 bf16, 16 KB a plane) is two 64-column
//     sub-tiles in the 128-byte swizzle, 8 KB apart (Geo<128>, sm90.cuh):
//     K-major reads start k16 steps 4 to 7 in the second; an MN-major B
//     operand of n128 steps between them by its LBO.
//   - The walked tiles stream through a ring of kAhead + 1 slots (a slot:
//     two tiles, and lse, or lse and delta, of the walked queries), filled
//     by 16-byte cp.async with rows at or past N zero-filled without a
//     read, kAhead loads in flight, one block barrier a step; a step reads
//     one slot. fp32 rows land raw in the slots of their own hi and lo
//     planes and each thread splits the chunks it copied in place once
//     they have landed (copy_tile_f32, split_tile), before the barrier
//     that hands the tile to the products; dO's lo plane is then unused.
//     Shared memory (BwdConfig): bf16 two warpgroups a block and four
//     slots in every role (193, 163 and 195 KB); fp32, whose tiles are
//     twice as large, a ring of two slots and two warpgroups in the dv role
//     (194 KB), one in the dq and dk roles (193 and 194 KB), whose two
//     owned tiles a warpgroup would need 257 KB for two.
//   - The last walked tile runs at full width with its keys (dq role) or
//     queries (key roles) at or past N masked by index: p = 0, or
//     lse = +inf. Owned rows past N are computed and not stored.
//   - The copies are branch-free in their count and the warpgroup index is
//     warp-uniform; every register a batch of products reads is defined
//     before its fence.
// A simple design: each warpgroup alternates products and arithmetic with a
// wait between them, and S^T runs twice. PERF.md has the measurements; the
// bf16 redesign (attention_bwd_hd128_tma.cuh) is the model for fp32's.
#pragma once

#include "attention_fwd_hd128.cuh"
#include "sm90.cuh"

namespace lt {
namespace sm90 {
namespace hd128 {

enum Role : int { kDqRole = 0, kDvRole = 1, kDkRole = 2 };

// Warpgroups a block and loads in flight, by dtype and role (see above;
// fp32 alone launches these kernels).
template <typename T, int R>
struct BwdConfig;
template <int R>
struct BwdConfig<float, R> {
  static constexpr int kWg = R == kDvRole ? 2 : 1;
  static constexpr int kAhead = 1;  // a ring of 2 slots of 64 KB
};

// What the three kernels take: tensors of T and their (batch, token, head)
// strides.
template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  T *dq, *dk, *dv;
  int N;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
};

// do . o over 64 columns of one row, in fp32.
__device__ __forceinline__ float half_row_dot(const float* a,
                                              const float* b) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 64; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    sum += x.x * y.x;
    sum += x.y * y.y;
    sum += x.z * y.z;
    sum += x.w * y.w;
  }
  return sum;
}

// d (64 x 64) = A . B^T with A one bf16 plane and B one (P = 1) or two
// (hi, lo) planes: dP = dO16 . V^T, or dP^T = V . dO16^T with the planes on
// A's side (kBPlanes false).
template <int P, bool kBPlanes>
__device__ __forceinline__ void plane_pair_scores(float (&d)[32],
                                                  uint32_t sA, uint32_t sB) {
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const uint32_t off = c * G::kTileBytes;
    issue_scores<kRows, kHD>(d, kBPlanes ? sA : sA + off,
                             kBPlanes ? sB + off : sB, c == 0);
  }
}

// acc (64 x 128) += A . B over the 64 rows of the tile at sB (MN-major),
// A in registers: one chain from a bf16 plane, B_hi + B_lo from fp32 planes
// (P = 1 on B's side for dO16).
template <int P>
__device__ __forceinline__ void accumulate(float (&acc)[kHD / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t sB) {
#pragma unroll
  for (int c = 0; c < P; ++c)
    issue_pv<kRows, kHD>(acc, a, sB + c * G::kTileBytes);
}

// The products of one step, once the register A operand is packed: every
// register they read is defined before the fence.
template <int P>
__device__ __forceinline__ void accumulate_step(float (&acc)[kHD / 2],
                                                uint32_t (&a)[4][4],
                                                uint32_t sB) {
  fence_registers(acc);
  fence_fragments(a);
  wgmma_fence();
  accumulate<P>(acc, a, sB);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(acc);
}

// dq role, one key tile (K at sK, V at sV, keys from kv0): S and dP, dS
// into the register A operand, dQ += dS . K. c0/c1 are lse log2 e and
// d0/d1 delta of this thread's rows g and g + 8; with kMask keys at or
// past N get p = 0 (only the last tile has any).
template <int P, bool kMask>
__device__ __forceinline__ void dq_step(float (&s)[32], float (&dp)[32],
                                        float (&acc)[kHD / 2], uint32_t sQ,
                                        uint32_t sD, uint32_t sK,
                                        uint32_t sV, int kv0, int N,
                                        float scale2, float scale, int t,
                                        float c0, float c1, float d0,
                                        float d1) {
  wgmma_fence();
  plane_scores<P, kRows, kHD>(s, sQ, sK);
  plane_pair_scores<P, true>(dp, sD, sV);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  fence_registers(dp);
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + j * 8 + 2 * t + (e & 1);
      const float x = exp2_ftz(fmaf(s[4 * j + e], scale2, e < 2 ? -c0 : -c1));
      const float p = !kMask || key < N ? x : 0.f;
      ds[e] = (p * (dp[4 * j + e] - (e < 2 ? d0 : d1))) * scale;
    }
    a[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);      // row g
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);  // row g + 8
  }
  accumulate_step<P>(acc, a, sK);
}

// lse log2 e of this thread's two query columns col, col + 1 of a walked
// tile from q0 (st: lse by query); with kMask +inf past N, so p = 0.
template <bool kMask>
__device__ __forceinline__ float2 column_lse(const float* st, int col, int q0,
                                             int N) {
  const float2 l = *reinterpret_cast<const float2*>(st + col);
  return make_float2(!kMask || q0 + col < N ? l.x * kLog2e : INFINITY,
                     !kMask || q0 + col + 1 < N ? l.y * kLog2e : INFINITY);
}

// dv role, one query tile (Q at sQ, dO at sD, lse in st): S^T, P^T into
// the register A operand, dV += P^T . dO16.
template <int P, bool kMask>
__device__ __forceinline__ void dv_step(float (&s)[32], float (&acc)[kHD / 2],
                                        uint32_t sK, uint32_t sQ,
                                        uint32_t sD, const float* st, int q0,
                                        int N, float scale2, int t) {
  wgmma_fence();
  plane_scores<P, kRows, kHD>(s, sK, sQ);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const float2 c = column_lse<kMask>(st, j * 8 + 2 * t, q0, N);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = exp2_ftz(fmaf(s[4 * j + e], scale2, e & 1 ? -c.y : -c.x));
    a[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);      // key row g
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);  // g + 8
  }
  accumulate_step<1>(acc, a, sD);
}

// dk role, one query tile (Q at sQ, dO at sD, lse and delta in st): S^T
// and dP^T, dS^T into the register A operand, dK += dS^T . Q.
template <int P, bool kMask>
__device__ __forceinline__ void dk_step(float (&s)[32], float (&dp)[32],
                                        float (&acc)[kHD / 2], uint32_t sK,
                                        uint32_t sV, uint32_t sQ,
                                        uint32_t sD, const float* st, int q0,
                                        int N, float scale2, float scale,
                                        int t) {
  wgmma_fence();
  plane_scores<P, kRows, kHD>(s, sK, sQ);
  plane_pair_scores<P, false>(dp, sV, sD);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  fence_registers(dp);
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 c = column_lse<kMask>(st, col, q0, N);
    const float2 d = *reinterpret_cast<const float2*>(st + kRows + col);
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          exp2_ftz(fmaf(s[4 * j + e], scale2, e & 1 ? -c.y : -c.x));
      ds[e] = (p * (dp[4 * j + e] - (e & 1 ? d.y : d.x))) * scale;
    }
    a[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
  }
  accumulate_step<P>(acc, a, sQ);
}

// One role of the backward (see the head of this file): grid (owned tiles
// / kWg, H, B), kWg warpgroups a block, each owning one 64-row tile.
template <typename T, int R>
__global__ void __launch_bounds__(BwdConfig<T, R>::kWg * 128, 1)
    attention_bwd_hd128_kernel(const BwdArgs<T> a) {
  using C = BwdConfig<T, R>;
  constexpr int P = Planes<T>::value;
  constexpr int kTile = P * G::kTileBytes;  // a tile's bf16 planes
  constexpr int kWg = C::kWg, kThreads = kWg * 128;
  constexpr int kAhead = C::kAhead, kSlots = kAhead + 1;
  constexpr int kOwn = R == kDvRole ? 1 : 2;  // owned tiles a warpgroup
  // Statistics of a slot's walked queries: lse (dv role), lse and delta
  // (dk role).
  constexpr int kStats = R == kDqRole ? 0 : R == kDvRole ? 1 : 2;
  constexpr int kStatBytes = kStats * kRows * 4;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window: the
  // block's owned tiles, the ring (a slot: two tiles), the statistics.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform.
  const int wg = kWg == 1 ? 0 : __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  const uint32_t mine = base + wg * kOwn * kTile;
  const uint32_t ring = base + kWg * kOwn * kTile;
  const uint32_t stats = ring + kSlots * 2 * kTile;
  const int row0 = (blockIdx.x * kWg + wg) * kRows;  // the owned tile's
  const bool active = row0 < N;  // uniform over the warpgroup
  const T* qh = a.q + b * a.qs.b + h * a.qs.h;
  const T* kh = a.k + b * a.ks.b + h * a.ks.h;
  const T* vh = a.v + b * a.vs.b + h * a.vs.h;
  const T* doh = a.dout + b * a.dos.b + h * a.dos.h;
  const float* lse_h = a.lse + bh * N;
  float* delta_h = a.delta + bh * N;
  const int nt = (N + kRows - 1) / kRows;

  // The block's owned tiles (dq role: Q, dO; dv role: K; dk role: K, V),
  // with the first load of the ring.
  for (int w = 0; w < kWg; ++w) {
    const int r0 = (blockIdx.x * kWg + w) * kRows;
    const uint32_t tile = base + w * kOwn * kTile;
    if constexpr (R == kDqRole) {
      stage<kThreads>(tile, qh, a.qs.n, r0, N, tid);
      stage<kThreads>(tile + kTile, doh, a.dos.n, r0, N, tid);
    } else {
      stage<kThreads>(tile, kh, a.ks.n, r0, N, tid);
      if constexpr (R == kDkRole)
        stage<kThreads>(tile + kTile, vh, a.vs.n, r0, N, tid);
    }
  }
  // Load i of the ring: walked tile i (dq role: K and V; the key roles: Q,
  // dO and the statistics of its queries), one commit group per load, empty
  // past the end. Step i reads load i alone.
  auto slot = [&](int i) { return ring + (i % kSlots) * 2 * kTile; };
  auto stat_slot = [&](int i) { return stats + (i % kSlots) * kStatBytes; };
  auto issue = [&](int i) {
    if (i < nt) {
      const int r0 = i * kRows;
      if constexpr (R == kDqRole) {
        stage<kThreads>(slot(i), kh, a.ks.n, r0, N, tid);
        stage<kThreads>(slot(i) + kTile, vh, a.vs.n, r0, N, tid);
      } else {
        stage<kThreads>(slot(i), qh, a.qs.n, r0, N, tid);
        stage<kThreads>(slot(i) + kTile, doh, a.dos.n, r0, N, tid);
#pragma unroll
        for (int n = 0; n < (kStats * kRows + kThreads - 1) / kThreads;
             ++n) {
          const int idx = tid + n * kThreads, r = r0 + idx % kRows;
          const bool valid = r < N;
          if (idx < kStats * kRows)
            cp_async4(stat_slot(i) + 4 * idx,
                      (idx < kRows ? lse_h : delta_h) + (valid ? r : 0),
                      valid);
        }
      }
    }
    cp_async_commit();
  };
  auto arrive = [&](int i) {
    cp_async_wait<kAhead - 1>();
    if (i == 0)
      for (int w = 0; w < kWg * kOwn; ++w)
        planes_ready<kThreads, T>(base + w * kTile, tid);
    planes_ready<kThreads, T>(slot(i), tid);
    planes_ready<kThreads, T>(slot(i) + kTile, tid);
    fence_async_shared();
    // Every thread's copies are visible (and split), and every warpgroup
    // is done with load i - 1, whose slot load i + kAhead refills.
    __syncthreads();
    issue(i + kAhead);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue(i);

  // dq role: delta of the warpgroup's rows (two threads a row, from the
  // unrounded o and do, while the copies fly), written for the dk role;
  // lse log2 e (+inf past N) and delta of this thread's rows g and g + 8.
  float c0 = INFINITY, c1 = INFINITY, d0 = 0.f, d1 = 0.f;
  if constexpr (R == kDqRole) {
    if (active) {
      const T* oh = a.o + b * a.os.b + h * a.os.h;
      const int r = row0 + warp * 16 + (lane >> 1), rc = min(r, N - 1);
      const int half = (lane & 1) * 64;
      float dsum =
          half_row_dot(oh + rc * a.os.n + half, doh + rc * a.dos.n + half);
      dsum += __shfl_xor_sync(0xffffffff, dsum, 1);
      dsum = r < N ? dsum : 0.f;
      if (r < N && (lane & 1) == 0) delta_h[r] = dsum;
      d0 = __shfl_sync(0xffffffff, dsum, 2 * g);
      d1 = __shfl_sync(0xffffffff, dsum, 2 * g + 16);
      const int r0 = row0 + warp * 16 + g;
      if (r0 < N) c0 = lse_h[r0] * kLog2e;
      if (r0 + 8 < N) c1 = lse_h[r0 + 8] * kLog2e;
    }
  }

  float acc[kHD / 2], s[32], dp[32];
  zero(acc);
  const float scale = a.scale, scale2 = scale * kLog2e;
  for (int i = 0; i < nt; ++i) {
    arrive(i);
    if (!active) continue;
    const uint32_t sA = slot(i), sB = sA + kTile;
    const float* st =
        reinterpret_cast<const float*>(smem_raw + (stat_slot(i) - raw));
    const int w0 = i * kRows;  // the walked tile's first row
#define LT_STEP(M)                                                         \
  if constexpr (R == kDqRole)                                              \
    dq_step<P, M>(s, dp, acc, mine, mine + kTile, sA, sB, w0, N, scale2,   \
                  scale, t, c0, c1, d0, d1);                               \
  else if constexpr (R == kDvRole)                                         \
    dv_step<P, M>(s, acc, mine, sA, sB, st, w0, N, scale2, t);             \
  else                                                                     \
    dk_step<P, M>(s, dp, acc, mine, mine + kTile, sA, sB, st, w0, N,       \
                  scale2, scale, t)
    if (i < nt - 1) {
      LT_STEP(false);
    } else {
      LT_STEP(true);
    }
#undef LT_STEP
  }
  cp_async_wait<0>();
  if (!active) return;
  T* out = R == kDqRole ? a.dq + b * a.dqs.b + h * a.dqs.h
           : R == kDvRole ? a.dv + b * a.dvs.b + h * a.dvs.h
                          : a.dk + b * a.dks.b + h * a.dks.h;
  const long stride = R == kDqRole ? a.dqs.n : R == kDvRole ? a.dvs.n
                                                            : a.dks.n;
  store_rows(out, stride, acc, row0 + warp * 16 + g, N, t);
}

// Shared memory of one role's kernel: the owned tiles, the ring, its
// statistics and the 1024 bytes that align the window.
template <typename T, int R>
constexpr size_t bwd_smem() {
  using C = BwdConfig<T, R>;
  constexpr size_t kTile = Planes<T>::value * G::kTileBytes;
  constexpr int kSlots = C::kAhead + 1;
  constexpr int kOwn = R == kDvRole ? 1 : 2;
  constexpr int kStats = R == kDqRole ? 0 : R == kDvRole ? 1 : 2;
  return 1024 + (C::kWg * kOwn + 2 * kSlots) * kTile +
         kSlots * kStats * kRows * 4;
}

template <typename T, int R>
cudaError_t launch_role(const BwdArgs<T>& args, int B, int H,
                        cudaStream_t stream) {
  constexpr int kWg = BwdConfig<T, R>::kWg;
  constexpr size_t smem = bwd_smem<T, R>();
  static_assert(smem <= 232448, "a block's shared memory");
  auto kernel = attention_bwd_hd128_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nt = (args.N + kRows - 1) / kRows;
  kernel<<<dim3((nt + kWg - 1) / kWg, H, B), kWg * 128, smem, stream>>>(
      args);
  return cudaGetLastError();
}

// The launch at hd 128 (N <= 768), as the C entries of the backward sources
// take their arguments (strides: q, k, v, o, do, dq, dk, dv): the dq role
// (which writes delta), then the dv and dk roles.
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dq, void* dk,
               void* dv, void* delta, int B, int N, int H,
               const long* strides, float scale, void* stream) {
  const int nt = (N + kRows - 1) / kRows;
  if (N < 1 || nt > kMaxTiles) return cudaErrorInvalidValue;
  const BwdArgs<T> args{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), N, strides_of(strides, 0),
      strides_of(strides, 1), strides_of(strides, 2), strides_of(strides, 3),
      strides_of(strides, 4), strides_of(strides, 5), strides_of(strides, 6),
      strides_of(strides, 7), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_role<T, kDqRole>(args, B, H, s);
  if (err != cudaSuccess) return err;
  err = launch_role<T, kDvRole>(args, B, H, s);
  if (err != cudaSuccess) return err;
  return launch_role<T, kDkRole>(args, B, H, s);
}

}  // namespace hd128
}  // namespace sm90
}  // namespace lt
