// Multi-head self-attention, backward, bf16 at head dim 128: K2 (flat
// layout) and K5 (per-head layout) as two persistent, TMA-fed kernels on
// Hopper's warpgroup tensor-core products, launched one after the other by
// flat_attention_bwd_sm90.cu for every N it takes (1 <= N <= 768). fp32
// stays on the three role kernels of attention_bwd_hd128.cuh.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel (K2)
// and ::_bwd_kernel (K5) at hd 128 in bf16: the 7B/16 student's backward.
// Tensors are read and written in place through three strides (batch,
// token, head); lse is the forward's (B, H, N) fp32 log-sum-exp; delta is a
// (B, H, N) fp32 scratch that the dq kernel writes for the dk/dv kernel.
//
// Numerics are the TPU kernel's, as attention_bwd_hd128.cuh states them:
//   p  = exp(s - lse)                 (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . do               dp = do . v^T
//   delta = rowsum(do * o)            (fp32, from the unrounded inputs)
//   ds = bf16((p * (dp - delta)) * scale)   (the fp32 p, not bf16(p))
//   dq = ds . k                       dk = ds^T . q
// with fp32 accumulation in every product; exp is 2^(s * scale log2 e -
// lse log2 e) with ex2.approx.ftz.
//
// What bounds it on an H100: at the 7B/16 student's (64, 201, 32, 128) the
// 843 MB that must move (q, k, v, o, do in; dq, dk, dv out), ~252 us at 3.35
// TB/s, against 66 GFLOP of necessary products (~67 us at the bf16 tensor
// peak). Two kernels move more: each reads its own tiles once and streams
// the head's other tiles once an item (the second item of a head mostly
// from L2), about 1.26 GB in all (~0.38 ms), and they run 7 passes of N^2 hd
// (5 are necessary): 195 GFLOP once the last walked tile is narrowed, ~0.20
// ms at the peak. The design:
//   - The dq kernel: a consumer warpgroup owns 64 query rows (Q and dO,
//     K-major A operands) and walks the head's key tiles: S = Q . K^T and
//     dP = dO . V^T, dS into the register A operand, then dQ += dS . K (K
//     read MN-major). 3 passes. It first forms delta of its rows from the
//     staged dO and O tiles (two threads a row) and writes it.
//   - The dk/dv kernel: a consumer warpgroup owns 64 key rows (K and V,
//     K-major A operands) and walks the head's query tiles: S^T = K . Q^T and
//     dP^T = V . dO^T once each, P^T and dS^T into register A operands, then
//     dV += bf16(P^T) . dO and dK += dS^T . Q (Q and dO read MN-major). 4
//     passes. dV and dK are 128 accumulators a thread and S^T and dP^T 64
//     more; S^T and dP^T are declared inside the step, so they are dead
//     while dV and dK accumulate.
//   - Persistent blocks, one an SM, walk work items blockIdx.x, + gridDim.x,
//     ...: an item is a pair of owned tiles of one head, one a consumer
//     warpgroup; item i is head i / pairs, pair i % pairs, so the items of
//     a head run side by side. Where a head has an odd number of tiles, the
//     second warpgroup has none in its last item and only releases the
//     ring's uses (at N <= 64 it never works).
//   - A producer warpgroup feeds both by TMA behind mbarriers; setmaxnreg
//     hands its registers to the consumers (40/232). Lane 0 of its warp 0
//     streams the walked tiles through a ring of 3 slots that both
//     consumers read (a slot: K and V, or Q and dO; in the dq kernel each
//     item's first slot holds the O tiles of its two query tiles); lane 0
//     of warps 2 and 3 loads each consumer's owned tiles into the second of
//     two buffers while it works on the first; in the dk/dv kernel warp 1
//     copies each slot's lse and delta by cp.async, the slot's full barrier
//     counting its lanes' arrivals (queries past N: lse = +inf by index, so
//     p = 0, and delta 0). Consumers wait on mbarriers only.
//   - Every tile is two TMA boxes of 64 rows x 64 columns in the 128-byte
//     swizzle (sm90.cuh's hd-128 tile); rows past N land as zeros. The
//     outputs are written into the owned tiles the products are done with,
//     in the same layout, and stored by TMA (rows past N are not written);
//     the tiles are released once the stores have read them.
//   - The last walked tile is read at the narrowest wgmma width that covers
//     its rows (16, 32, 48 or 64), a template parameter; keys past N get
//     p = 0 by index in the dq kernel (s = 0 on a zero row is not p = 0).
//     Owned rows past N are computed and not stored.
//   - Every dq, dk, dv and delta element is written by one warpgroup: no
//     atomics, and the result is bitwise repeatable.
// What its design taught, with the measurements, is in PERF.md: delta from
// o and do in global memory, the outputs stored from registers and the
// owned tiles loaded only once the last item was done took more than half
// of each kernel's time.
#pragma once

#include "attention_bwd_hd128.cuh"

namespace lt {
namespace sm90 {
namespace hd128 {

enum TmaKernel : int { kDqKernel = 0, kDkdvKernel = 1 };

constexpr int kBwdConsumers = 256;  // two warpgroups; the producer's after

// Registers a thread after setmaxnreg, producer and consumers: the block's
// 384 x 168 = 64,512 bound what setmaxnreg.inc can grant (40/232 as in
// attention_fwd_hd128_resident.cuh; at 24/240 ptxas spilled in the dk/dv
// kernel).
constexpr int kBwdProducerRegs = 40, kBwdConsumerRegs = 232;

// The block's shared memory: two buffers of each consumer's two owned
// tiles (Q and dO, or K and V), so that the next item's tiles load while
// this one's products run; the ring of walked tiles (a slot: K and V, or Q and
// dO; in the dq kernel an item's first slot holds the O tiles of its two
// query tiles); in the dk/dv kernel the statistics of each slot's queries
// (lse at float 0, delta at float 64); then the mbarriers. Use u of the
// ring is slot u % kSlots, in phase (u / kSlots) & 1 of its barriers; load
// n of a consumer's owned tiles is buffer n & 1, in phase (n / 2) & 1.
template <int R>
struct BwdRing {
  static constexpr int kTile = G::kTileBytes;
  static constexpr int kSlots = 3;
  static constexpr int kStatBytes = R == kDqKernel ? 0 : 2 * kRows * 4;
  static constexpr int kBars = 2 * kSlots + 8;
  static constexpr int kTiles = 8 + 2 * kSlots;
  static constexpr int kBytes =
      kTiles * kTile + kSlots * kStatBytes + 8 * kBars;
  // Arrivals that fill a slot: the tile copier's, and in the dk/dv kernel
  // one a lane of the warp that copies the statistics.
  static constexpr int kFullCount = R == kDqKernel ? 1 : 33;
  uint32_t base;
  __device__ uint32_t own(int wg, int n) const {
    return base + (4 * (n & 1) + 2 * wg) * kTile;
  }
  __device__ uint32_t slot(int u) const {
    return base + (8 + 2 * (u % kSlots)) * kTile;
  }
  __device__ uint32_t stats(int u) const {
    return base + kTiles * kTile + (u % kSlots) * kStatBytes;
  }
  __device__ uint32_t bar(int i) const {
    return base + kTiles * kTile + kSlots * kStatBytes + 8 * i;
  }
  __device__ uint32_t full(int u) const { return bar(u % kSlots); }
  __device__ uint32_t empty(int u) const { return bar(kSlots + u % kSlots); }
  __device__ uint32_t own_full(int wg, int n) const {
    return bar(2 * kSlots + 2 * wg + (n & 1));
  }
  __device__ uint32_t own_empty(int wg, int n) const {
    return bar(2 * kSlots + 4 + 2 * wg + (n & 1));
  }
  __device__ int parity(int u) const { return (u / kSlots) & 1; }
  __device__ void init() const {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full(i), kFullCount);
      mbar_init(empty(i), kBwdConsumers);
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(own_full(i / 2, i), 1);
      mbar_init(own_empty(i / 2, i), 128);
    }
  }
};

// A kernel's tensor maps (tensor_map): its owned tiles' (q, do, or k, v),
// its walked tiles' (k, v, or q, do), its outputs' (dq, or dk and dv) and
// in the dq kernel o's. Bit i of `swap` is set where map i (in this order)
// has its head dimension below its token dimension (tma_tile).
struct TmaMaps {
  CUtensorMap own[2], walk[2], out[2], o;
};

// What both kernels take beside their maps: the tensors (BwdArgs), the
// heads, the work items and the owned tiles' pairs a head.
struct TmaArgs {
  BwdArgs<bf16> a;
  int H, items, pairs, swap;
};

// Where work item `item` lies: head (b, h) and its pair of owned tiles.
struct Item {
  int b, h, pair;
};
__device__ __forceinline__ Item item_at(int item, const TmaArgs& x) {
  const int head = item / x.pairs;
  return Item{head / x.H, head % x.H, item % x.pairs};
}

// Arrives on `bar` once this thread's cp.async copies so far have landed,
// as one of the arrivals the barrier counts.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The producer warpgroup's warp pw (lane `lane`): 0 streams the walked
// tiles into the ring (in the dq kernel after each item's O tiles), 1 the
// dk/dv kernel's statistics (cp.async, zero past N), 2 and 3 the owned
// tiles of consumer warpgroup pw - 2.
template <int R>
__device__ __forceinline__ void bwd_producer(const BwdRing<R>& sm,
                                             const TmaMaps& m,
                                             const TmaArgs& x, int pw,
                                             int lane) {
  using Ring = BwdRing<R>;
  const int N = x.a.N, nt = (N + kRows - 1) / kRows;
  // One lane a stream, but the 32 of the statistics; the dq kernel has none.
  if ((R == kDqKernel && pw == 1) || (pw != 1 && lane != 0)) return;
  int u = 0, n = 0;
  for (int item = blockIdx.x; item < x.items; item += gridDim.x) {
    const Item it = item_at(item, x);
    if (pw == 0) {
      if constexpr (R == kDqKernel) {
        // The O tiles of the item's query tiles (one where the second has
        // no rows).
        const int tile = 2 * it.pair, tiles = tile + 1 < nt ? 2 : 1;
        if (u >= Ring::kSlots) mbar_wait(sm.empty(u), sm.parity(u) ^ 1);
        mbar_expect(sm.full(u), tiles * Ring::kTile);
        for (int i = 0; i < tiles; ++i)
          tma_tile<bf16>(m.o, sm.slot(u) + i * Ring::kTile, sm.full(u),
                         (tile + i) * kRows, it.h, it.b, x.swap & 64);
        ++u;
      }
      for (int j = 0; j < nt; ++j, ++u) {
        if (u >= Ring::kSlots) mbar_wait(sm.empty(u), sm.parity(u) ^ 1);
        mbar_expect(sm.full(u), 2 * Ring::kTile);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          tma_tile<bf16>(m.walk[i], sm.slot(u) + i * Ring::kTile, sm.full(u),
                         j * kRows, it.h, it.b, x.swap & (4 << i));
      }
    } else if (pw == 1) {
      if constexpr (R == kDkdvKernel) {
        const long bh = static_cast<long>(it.b) * x.H + it.h;
        for (int j = 0; j < nt; ++j, ++u) {
          if (u >= Ring::kSlots) mbar_wait(sm.empty(u), sm.parity(u) ^ 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = lane + 32 * (e & 1), r = j * kRows + col;
            const bool valid = r < N;
            const float* src = (e < 2 ? x.a.lse : x.a.delta) + bh * N;
            cp_async4(sm.stats(u) + 4 * (kRows * (e >> 1) + col),
                      src + (valid ? r : 0), valid);
          }
          cp_async_arrive(sm.full(u));
        }
      }
    } else {
      const int w = pw - 2, tile = 2 * it.pair + w;
      if (tile < nt) {
        if (n > 1) mbar_wait(sm.own_empty(w, n), ((n >> 1) - 1) & 1);
        mbar_expect(sm.own_full(w, n), 2 * Ring::kTile);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          tma_tile<bf16>(m.own[i], sm.own(w, n) + i * Ring::kTile,
                         sm.own_full(w, n), tile * kRows, it.h, it.b,
                         x.swap & (1 << i));
        ++n;
      }
    }
  }
}

// Releases the nt uses of the ring from u on, in order, without reading
// them: a consumer with no owned tile in an item.
template <int R>
__device__ __forceinline__ void pass_uses(const BwdRing<R>& sm, int u,
                                          int nt) {
  for (int j = 0; j < nt; ++j) {
    mbar_wait(sm.full(u + j), sm.parity(u + j));
    mbar_arrive(sm.empty(u + j));
  }
}

// This thread's rows (warp 16 + g and + 8 of the tile at `tile`) of a
// 64 x 128 accumulator as bf16 pairs, in the layout tma_tile<bf16> loads
// (the TMA box's 128-byte swizzle), for tma_store_tile.
__device__ __forceinline__ void stage_rows(uint32_t tile,
                                           const float (&acc)[kHD / 2],
                                           int row, int t) {
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) {
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     chunk_at<kHD>(tile, row, j) + 4 * t),
                 "r"(pack_bf16(acc[4 * j], acc[4 * j + 1]))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     chunk_at<kHD>(tile, row + 8, j) + 4 * t),
                 "r"(pack_bf16(acc[4 * j + 2], acc[4 * j + 3]))
                 : "memory");
  }
}

// do . o over columns [64 half, 64 half + 64) of row r of the staged tiles
// at sD and sO, in fp32, summed left to right.
__device__ __forceinline__ float staged_half_row_dot(uint32_t sD, uint32_t sO,
                                                     int r, int half) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 av = ld_shared4(chunk_at<kHD>(sO, r, 8 * half + c));
    const uint4 bv = ld_shared4(chunk_at<kHD>(sD, r, 8 * half + c));
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(ap[e]);
      const float2 y = __bfloat1622float2(bp[e]);
      sum += x.x * y.x;
      sum += x.y * y.y;
    }
  }
  return sum;
}

// The dq kernel, one key tile of NK keys from kv0 (K at sK, V a tile
// above): S and dP, dS into the register A operand, then dQ += dS . K. c0/c1
// are lse log2 e and d0/d1 delta of this thread's rows g and g + 8; with
// kMask keys at or past N get p = 0 (only the last tile has any).
template <int NK, bool kMask>
__device__ __forceinline__ void dq_tma_step(float (&acc)[kHD / 2],
                                            uint32_t sQ, uint32_t sD,
                                            uint32_t sK, int kv0, int N,
                                            float scale2, float scale, int t,
                                            float c0, float c1, float d0,
                                            float d1) {
  float s[32], dp[32];
  wgmma_fence();
  issue_scores<NK, kHD>(s, sQ, sK);
  issue_scores<NK, kHD>(dp, sD, sK + G::kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(first<NK>(s));
  fence_registers(first<NK>(dp));
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
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
  fence_registers(acc);
  fence_fragments<NK>(a);
  wgmma_fence();
  issue_pv<NK, kHD>(acc, a, sK);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(acc);
}

// The dq kernel's consumer warpgroup wg (wtid its thread) over the block's
// items; the last key tile is W keys wide.
template <int W>
__device__ __forceinline__ void dq_consumer(const BwdRing<kDqKernel>& sm,
                                            const TmaMaps& m,
                                            const TmaArgs& x, int wg,
                                            int wtid) {
  using Ring = BwdRing<kDqKernel>;
  const BwdArgs<bf16>& a = x.a;
  const int warp = wtid / 32, lane = wtid % 32, g = lane >> 2, t = lane & 3;
  const int N = a.N, nt = (N + kRows - 1) / kRows;
  const float scale = a.scale, scale2 = scale * kLog2e;
  int u = 0, n = 0;  // uses of the ring; loads of the owned tiles
#pragma unroll 1
  for (int item = blockIdx.x; item < x.items; item += gridDim.x) {
    const Item it = item_at(item, x);
    const int row0 = (2 * it.pair + wg) * kRows;
    if (row0 >= N) {
      pass_uses(sm, u, nt + 1);
      u += nt + 1;
      continue;
    }
    const long bh = static_cast<long>(it.b) * x.H + it.h;
    // lse log2 e (+inf past N) of this thread's rows g and g + 8, loaded
    // under the waits.
    const int g0 = warp * 16 + g, r0 = row0 + g0;
    const float l0 = r0 < N ? a.lse[bh * N + r0] : 0.f;
    const float l1 = r0 + 8 < N ? a.lse[bh * N + r0 + 8] : 0.f;
    mbar_wait(sm.own_full(wg, n), (n >> 1) & 1);
    const uint32_t sQ = here(sm.own(wg, n)), sD = sQ + Ring::kTile;
    // delta of the warpgroup's rows (two threads a row, from the staged do
    // and o), written for the dk/dv kernel; then delta of this thread's rows
    // g and g + 8. The item's first use of the ring holds its O tiles.
    mbar_wait(sm.full(u), sm.parity(u));
    const int rr = warp * 16 + (lane >> 1), r = row0 + rr;
    float dsum = staged_half_row_dot(sD, here(sm.slot(u)) + wg * Ring::kTile,
                                     rr, lane & 1);
    // The O tiles were read through the generic proxy and the slot is
    // refilled by TMA: order the reads before the release.
    fence_async_shared();
    mbar_arrive(sm.empty(u++));
    dsum += __shfl_xor_sync(0xffffffff, dsum, 1);
    dsum = r < N ? dsum : 0.f;
    if (r < N && (lane & 1) == 0) a.delta[bh * N + r] = dsum;
    const float d0 = __shfl_sync(0xffffffff, dsum, 2 * g);
    const float d1 = __shfl_sync(0xffffffff, dsum, 2 * g + 16);
    const float c0 = r0 < N ? l0 * kLog2e : INFINITY;
    const float c1 = r0 + 8 < N ? l1 * kLog2e : INFINITY;
    float acc[kHD / 2];
    zero(acc);
#pragma unroll 1
    for (int j = 0; j < nt; ++j, ++u) {
      mbar_wait(sm.full(u), sm.parity(u));
      const uint32_t sK = here(sm.slot(u));
      if (j + 1 < nt)
        dq_tma_step<kRows, false>(acc, sQ, sD, sK, j * kRows, N, scale2,
                                  scale, t, c0, c1, d0, d1);
      else
        dq_tma_step<W, true>(acc, sQ, sD, sK, j * kRows, N, scale2, scale,
                             t, c0, c1, d0, d1);
      mbar_arrive(sm.empty(u));
    }
    // dQ through the Q tile, which the products are done with, by TMA; the
    // owned tiles are released once the store has read it.
    stage_rows(sQ, acc, g0, t);
    fence_async_shared();
    warpgroup_sync(wg);
    if (wtid == 0) {
      tma_store_tile(m.out[0], sQ, row0, it.h, it.b, x.swap & 16);
      bulk_wait<true>();
    }
    mbar_arrive(sm.own_empty(wg, n));
    ++n;
  }
  if (wtid == 0) bulk_wait<false>();  // the last dQ tile is written
}

// The dk/dv kernel, one query tile of NK queries from q0 (Q at sQ, dO at
// sD, their lse and delta at st): S^T and dP^T, P^T and dS^T into register
// A operands (queries at or past N: lse = +inf, p = 0), then
// dV += P^T . dO and dK += dS^T . Q.
template <int NK>
__device__ __forceinline__ void dkdv_tma_step(float (&dk)[kHD / 2],
                                              float (&dv)[kHD / 2],
                                              uint32_t sK, uint32_t sV,
                                              uint32_t sQ, uint32_t sD,
                                              uint32_t st, int q0, int N,
                                              float scale2, float scale,
                                              int t) {
  float s[32], dp[32];
  wgmma_fence();
  issue_scores<NK, kHD>(s, sK, sQ);
  issue_scores<NK, kHD>(dp, sV, sD);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(first<NK>(s));
  fence_registers(first<NK>(dp));
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int col = j * 8 + 2 * t;  // this thread's two queries
    const float2 l = ld_shared2(st + 4 * col);
    const float2 d = ld_shared2(st + 4 * (kRows + col));
    const float c[2] = {q0 + col < N ? l.x * kLog2e : INFINITY,
                        q0 + col + 1 < N ? l.y * kLog2e : INFINITY};
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(fmaf(s[4 * j + e], scale2, -c[e & 1]));
      ds[e] = (p[e] * (dp[4 * j + e] - (e & 1 ? d.y : d.x))) * scale;
    }
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);      // key row g
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);  // g + 8
    da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
  }
  fence_registers(dk);
  fence_registers(dv);
  fence_fragments<NK>(pa);
  fence_fragments<NK>(da);
  wgmma_fence();
  issue_pv<NK, kHD>(dv, pa, sD);
  issue_pv<NK, kHD>(dk, da, sQ);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dk);
  fence_registers(dv);
}

// The dk/dv kernel's consumer warpgroup wg over the block's items; the
// last query tile is W queries wide.
template <int W>
__device__ __forceinline__ void dkdv_consumer(const BwdRing<kDkdvKernel>& sm,
                                              const TmaMaps& m,
                                              const TmaArgs& x, int wg,
                                              int wtid) {
  using Ring = BwdRing<kDkdvKernel>;
  const BwdArgs<bf16>& a = x.a;
  const int t = wtid % 4, g0 = (wtid / 32) * 16 + (wtid % 32) / 4;
  const int N = a.N, nt = (N + kRows - 1) / kRows;
  const float scale = a.scale, scale2 = scale * kLog2e;
  int u = 0, n = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < x.items; item += gridDim.x) {
    const Item it = item_at(item, x);
    const int row0 = (2 * it.pair + wg) * kRows;
    if (row0 >= N) {
      pass_uses(sm, u, nt);
      u += nt;
      continue;
    }
    mbar_wait(sm.own_full(wg, n), (n >> 1) & 1);
    const uint32_t sK = here(sm.own(wg, n)), sV = sK + Ring::kTile;
    float dk[kHD / 2], dv[kHD / 2];
    zero(dk);
    zero(dv);
#pragma unroll 1
    for (int i = 0; i < nt; ++i, ++u) {
      mbar_wait(sm.full(u), sm.parity(u));
      const uint32_t sQ = here(sm.slot(u));
      if (i + 1 < nt)
        dkdv_tma_step<kRows>(dk, dv, sK, sV, sQ, sQ + Ring::kTile,
                             sm.stats(u), i * kRows, N, scale2, scale, t);
      else
        dkdv_tma_step<W>(dk, dv, sK, sV, sQ, sQ + Ring::kTile, sm.stats(u),
                         i * kRows, N, scale2, scale, t);
      mbar_arrive(sm.empty(u));
    }
    // dK and dV through the K and V tiles, which the products are done
    // with, by TMA; the owned tiles are released once the stores have read
    // them.
    stage_rows(sK, dk, g0, t);
    stage_rows(sV, dv, g0, t);
    fence_async_shared();
    warpgroup_sync(wg);
    if (wtid == 0) {
      tma_store_tile(m.out[0], sK, row0, it.h, it.b, x.swap & 16);
      tma_store_tile(m.out[1], sV, row0, it.h, it.b, x.swap & 32);
      bulk_wait<true>();
    }
    mbar_arrive(sm.own_empty(wg, n));
    ++n;
  }
  if (wtid == 0) bulk_wait<false>();  // the last dK and dV tiles are written
}

// Kernel R (the dq or the dk/dv kernel), the last walked tile W rows wide.
// Threads 0-255: the two consumer warpgroups; 256-383: the producer
// warpgroup.
template <int R, int W>
__global__ void __launch_bounds__(kBwdConsumers + 128, 1)
    attention_bwd_hd128_tma_kernel(const __grid_constant__ TmaMaps m,
                                   const __grid_constant__ TmaArgs x) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window.
  const BwdRing<R> sm{(smem_addr(smem_raw) + 1023) & ~1023u};
  if (threadIdx.x == 0) {
    sm.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  // One if/else and no early return, so that ptxas holds each side to its
  // own setmaxnreg count.
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    bwd_producer<R>(sm, m, x, (threadIdx.x - kBwdConsumers) / 32,
                    threadIdx.x % 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kBwdConsumerRegs));
    if constexpr (R == kDqKernel)
      dq_consumer<W>(sm, m, x, wg, threadIdx.x % 128);
    else
      dkdv_consumer<W>(sm, m, x, wg, threadIdx.x % 128);
  }
}

using TmaKernelFn = void (*)(const TmaMaps, const TmaArgs);

template <int R>
TmaKernelFn tma_kernel(int w16) {
  switch (w16) {
    case 1: return attention_bwd_hd128_tma_kernel<R, 16>;
    case 2: return attention_bwd_hd128_tma_kernel<R, 32>;
    case 3: return attention_bwd_hd128_tma_kernel<R, 48>;
    default: return attention_bwd_hd128_tma_kernel<R, 64>;
  }
}

// The bf16 launch at hd 128 (N <= 768), as the C entry of the backward
// takes its arguments (strides: q, k, v, o, do, dq, dk, dv): the dq kernel
// (which writes delta), then the dk/dv kernel, each one block an SM (or an
// item, if fewer). A failed encode or launch returns its error.
inline int launch_bwd_tma(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const void* lse,
                          void* dq, void* dk, void* dv, void* delta, int B,
                          int N, int H, const long* strides, float scale,
                          void* stream) {
  const int nt = (N + kRows - 1) / kRows;
  if (N < 1 || nt > kMaxTiles) return cudaErrorInvalidValue;
  const int w16 = (N - (nt - 1) * kRows + 15) / 16;
  const TmaKernelFn kernels[2] = {tma_kernel<kDqKernel>(w16),
                                  tma_kernel<kDkdvKernel>(w16)};
  const size_t smem[2] = {1024 + BwdRing<kDqKernel>::kBytes,
                          1024 + BwdRing<kDkdvKernel>::kBytes};
  static_assert(1024 + BwdRing<kDqKernel>::kBytes <= 232448 &&
                    1024 + BwdRing<kDkdvKernel>::kBytes <= 232448,
                "a block's shared memory");
  // Runtime calls first: they make the device's context current in this
  // thread, which cuTensorMapEncodeTiled below needs (autograd runs the
  // backward on a thread of its own, which may not have one yet).
  for (int r = 0; r < 2; ++r) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[r], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem[r]));
    if (err != cudaSuccess) return err;
  }
  // The maps of q, k, v, o, do, dq, dk and dv, in the order of `strides`.
  CUtensorMap maps[8];
  const void* xs[8] = {q, k, v, o, dout, dq, dk, dv};
  int swapped[8];
  for (int i = 0; i < 8; ++i) {
    swapped[i] =
        tensor_map<bf16>(&maps[i], xs[i], B, N, H, strides_of(strides, i));
    if (swapped[i] < 0) return cudaErrorInvalidValue;
  }
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
  }
  const int pairs = (nt + 1) / 2, items = B * H * pairs;
  const BwdArgs<bf16> args{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N,
      strides_of(strides, 0), strides_of(strides, 1), strides_of(strides, 2),
      strides_of(strides, 3), strides_of(strides, 4), strides_of(strides, 5),
      strides_of(strides, 6), strides_of(strides, 7), scale};
  // Each kernel's maps (TmaMaps' order) by index into `maps`: the dq
  // kernel owns q, do, walks k, v, stores dq and reads o; the dk/dv kernel
  // owns k, v, walks q, do and stores dk, dv (-1: none).
  const int order[2][7] = {{0, 4, 1, 2, 5, -1, 3}, {1, 2, 0, 4, 6, 7, -1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r = 0; r < 2; ++r) {
    TmaMaps m = {};
    CUtensorMap* slots[7] = {&m.own[0], &m.own[1], &m.walk[0], &m.walk[1],
                             &m.out[0], &m.out[1], &m.o};
    int swap = 0;
    for (int i = 0; i < 7; ++i)
      if (order[r][i] >= 0) {
        *slots[i] = maps[order[r][i]];
        swap |= swapped[order[r][i]] << i;
      }
    kernels[r]<<<items < sms ? items : sms, kBwdConsumers + 128, smem[r],
                 s>>>(m, TmaArgs{args, H, items, pairs, swap});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace hd128
}  // namespace sm90
}  // namespace lt
