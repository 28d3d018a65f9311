// Multi-head self-attention, forward, at head dim 128 on Hopper's warpgroup
// tensor-core products: K1 (flat layout) and K4 (per-head layout), one
// kernel template for both dtypes, launched by flat_attention_fwd_sm90.cu
// (bf16) and flat_attention_fwd_f32_sm90.cu (fp32) when hd = 128 where
// attention_fwd_hd128_resident.cuh's kernel does not take the call: N <=
// 64, N > 304, or scale <= 0. No path of the port launches it at hd 128
// today (the 7B ViTs run N = 201 and 257).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel (K1)
// and ::_fwd_kernel (K4) at hd 128, the 7B ViTs' head dim (4096 / 32
// heads). Tensors are read and written in place through three strides
// (batch, token, head), as at hd 64; lse is (B, H, N) fp32.
//
// Numerics are those of the hd-64 kernels, which are the TPU kernel's: s =
// (q . k) * scale in fp32, m = max over ALL keys (a first pass over the
// same products as the second), p = bf16(exp(s - m)) as __expf's 2^(x log2
// e) with log2 e folded into one FFMA and subnormals flushed to 0, l = sum
// of the rounded p in fp32, o = (p . v) / l, lse = m + log(l). fp32 q/k/v
// enter the bf16 tensor cores as hi/lo planes (mma.cuh): q . k from three
// chains (hi.hi, hi.lo, lo.hi), p . v from two (p.v_hi, p.v_lo).
//
// What bounds it on an H100: at (16, 730, 32, 128) the products, 0.14 ms
// at the bf16 tensor peak (0.28 ms at TF32's), against 0.07 ms of bytes
// in bf16; at N <= 64 the bytes. Here q . k runs twice and fp32 runs 8
// bf16 passes of N^2 hd a head. The design keeps every row's bytes to one
// read and two warpgroups' products on each SM:
//   - A tile (64 rows x 128 bf16, 16 KB a plane) is two 64-column sub-tiles
//     in the 128-byte swizzle, 8 KB apart (sm90.cuh): Q and K are K-major
//     operands whose k16 steps 4 to 7 start in the second sub-tile, V the
//     MN-major B operand of P . V (m64n128k16) whose LBO steps between
//     them.
//   - Grid (query tiles / 2, H, B), two warpgroups a block, each owning 64
//     query rows (its Q tile in shared memory), so a K/V tile serves 128
//     queries. K and V stream through a ring of kAhead + 1 slots (a slot:
//     two tiles), kAhead loads in flight, one block barrier a step: bf16
//     5 slots of 32 KB, fp32 (hi/lo planes double every tile) 2 slots of
//     64 KB; with the Q tiles 193 KB in both.
//   - Every tile lands by 16-byte cp.async, rows at or past N zero-filled
//     without a read; fp32 rows land raw in the slots of their own hi and
//     lo planes and each thread splits the chunks it copied in place once
//     they have landed (copy_tile_f32, split_tile), before the barrier
//     that hands the tile to the products.
//   - Pass 1 takes two K tiles a step (one slot), both S issued at once and
//     the first tile's maxima taken while the second computes; pass 2 a
//     tile a step: S, then p, l and o += P . V (o: 64 fp32 accumulators a
//     thread). A step reads one slot.
//   - The last key tile runs first in both passes, on its own, at the
//     narrowest wgmma width that covers its keys (16, 32, 48 or 64): N =
//     201 is 3 x 64 + 9, N = 257 4 x 64 + 1. With it last and the next S
//     batched with P . V, as in the hd-64 kernels, ptxas serialized the
//     products (C7511) of one dtype's kernel or the other's in every
//     arrangement tried, and the fp32 form fit one warpgroup a block only
//     (three slots of 64 KB), which ran slower. N <= 64 (one key tile) is
//     its own instantiation with one warpgroup, S computed once for both
//     passes.
//   - The copies are branch-free and the warpgroup index is warp-uniform:
//     ptxas serializes products in a path it cannot prove uniform.
// A simple design: each warpgroup alternates products and softmax between
// block barriers and q . k runs twice; PERF.md has the measurements. The
// resident kernel (TMA loads from a producer warpgroup, S kept in
// registers, q . k once) replaced it for 64 < N <= 304 in both dtypes.
#pragma once

#include "sm90.cuh"

namespace lt {
namespace sm90 {
namespace hd128 {

constexpr int kHD = 128;
constexpr int kMaxTiles = 12;  // N <= 768, the kernels' range
using G = Geo<kHD>;

// Loads in flight ahead of a step, per dtype: a slot holds two tiles of P
// planes (32 KB in bf16, 64 KB in fp32), so both rings, with the block's
// two Q tiles, take 193 KB of the 227 KB a block may have.
template <typename T>
struct Config {
  static constexpr int kAhead = 4;  // bf16: a ring of 5 slots
};
template <>
struct Config<float> {
  static constexpr int kAhead = 1;  // a ring of 2 slots
};

// Rows [row0, row0 + 64) of one head as a tile's bf16 plane, or an fp32
// tile's hi and lo planes (raw until planes_ready splits them).
template <int kThreads>
__device__ __forceinline__ void stage(uint32_t tile, const bf16* head,
                                      long row_stride, int row0, int N,
                                      int tid) {
  load_tile<kThreads, kHD>(tile, head, row_stride, row0, N, tid);
}
template <int kThreads>
__device__ __forceinline__ void stage(uint32_t tile, const float* head,
                                      long row_stride, int row0, int N,
                                      int tid) {
  copy_tile_f32<kThreads, kHD>(tile, head, row_stride, row0, N, tid);
}

// Once this thread's copies of a staged tile have landed: nothing in bf16,
// the split into hi/lo planes in fp32.
template <int kThreads, typename T>
__device__ __forceinline__ void planes_ready(uint32_t tile, int tid) {
  if constexpr (Planes<T>::value == 2) split_tile<kThreads, kHD>(tile, tid);
}

// Pass 2, one key tile (width NK) at sK and its V at sV: S, then p and l
// from it and o += P . V.
template <int P, int NK, bool kMask>
__device__ __forceinline__ void output_tile(float (&s)[32],
                                            float (&acc)[kHD / 2],
                                            uint32_t sQ, uint32_t sK,
                                            uint32_t sV, int kv0, int N,
                                            float scale2, int t, float c0,
                                            float c1, float& l0, float& l1) {
  wgmma_fence();
  plane_scores<P, NK, kHD>(s, sQ, sK);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  fwd_output_step<P, kHD, NK, kMask, 0>(s, acc, sQ, 0, sV, kv0, N, scale2, t,
                                        c0, c1, l0, l1);
}

// kOneTile: N <= 64, one key tile and one warpgroup, S computed once for
// both passes; else two warpgroups and Config<T>'s ring.
template <typename T, bool kOneTile>
__global__ void __launch_bounds__(kOneTile ? 128 : 256, 1)
    attention_fwd_hd128_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int N, Strides qs,
                               Strides ks, Strides vs, Strides os,
                               float scale) {
  constexpr int P = Planes<T>::value;
  constexpr int kTile = P * G::kTileBytes;  // a tile's bf16 planes
  constexpr int n_wg = kOneTile ? 1 : 2;
  constexpr int kThreads = n_wg * 128;
  constexpr int kAhead = Config<T>::kAhead, kSlots = kAhead + 1;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window: the
  // block's Q tiles, then the ring (a slot: two tiles).
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform.
  const int wg =
      n_wg == 1 ? 0 : __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const uint32_t sQ = base + wg * kTile;
  const uint32_t ring = base + n_wg * kTile;
  const int q0 = (blockIdx.x * n_wg + wg) * kRows;
  const bool active = q0 < N;  // uniform over the warpgroup
  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width
  const int tid = threadIdx.x;

  // The block's Q tiles, with the first K/V load.
  for (int w = 0; w < n_wg; ++w)
    stage<kThreads>(base + w * kTile, qh, qs.n,
                    (blockIdx.x * n_wg + w) * kRows, N, tid);

  float acc[kHD / 2], s[32];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * kLog2e;

  if constexpr (kOneTile) {
    // One key tile: S once, kept for both passes.
    stage<kThreads>(ring, kh, ks.n, 0, N, tid);
    stage<kThreads>(ring + kTile, vh, vs.n, 0, N, tid);
    cp_async_commit();
    cp_async_wait<0>();
    planes_ready<kThreads, T>(sQ, tid);
    planes_ready<kThreads, T>(ring, tid);
    planes_ready<kThreads, T>(ring + kTile, tid);
    fence_async_shared();
    __syncthreads();
    zero(acc);
#define LT_ONE(W)                                                         \
  wgmma_fence();                                                          \
  plane_scores<P, W, kHD>(s, sQ, ring);                                   \
  wgmma_commit();                                                         \
  wgmma_wait<0>();                                                        \
  fence_registers(s);                                                     \
  row_max<W, true>(s, 0, N, scale, t, m0, m1);                            \
  quad_max(m0, m1);                                                       \
  fwd_output_step<P, kHD, W, true, 0>(s, acc, sQ, 0, ring + kTile, 0, N,  \
                                      scale2, t, m0 * kLog2e, m1 * kLog2e, \
                                      l0, l1)
    LT_BY_TAIL(tail16, LT_ONE);
#undef LT_ONE
  } else {
    // The masked last key tile (at its narrowest width) runs first in both
    // passes, on its own, so that every step of the passes' loops is a
    // whole tile. Load i of the ring: pass 1's key tiles (n1 loads: the
    // last tile alone, then two whole tiles a load), then pass 2's K and V
    // tiles (the last tile first); one commit group per load, empty past
    // the end. Step i reads load i alone, which has landed (and, in fp32,
    // been split) before it; kAhead - 1 more are in flight.
    const int n1 = 1 + nt / 2, n_loads = n1 + nt;
    auto slot = [&](int i) { return ring + (i % kSlots) * 2 * kTile; };
    auto issue = [&](int i) {
      if (i == 0) {
        stage<kThreads>(slot(i), kh, ks.n, (nt - 1) * kRows, N, tid);
      } else if (i < n1) {
        const int a = 2 * (i - 1);
        stage<kThreads>(slot(i), kh, ks.n, a * kRows, N, tid);
        stage<kThreads>(slot(i) + kTile, kh, ks.n, (a + 1) * kRows, N, tid);
      } else if (i < n_loads) {
        const int j = i - n1;
        const int row0 = (j == 0 ? nt - 1 : j - 1) * kRows;
        stage<kThreads>(slot(i), kh, ks.n, row0, N, tid);
        stage<kThreads>(slot(i) + kTile, vh, vs.n, row0, N, tid);
      }
      cp_async_commit();
    };
    auto arrive = [&](int i) {
      cp_async_wait<kAhead - 1>();
      if (i == 0)
        for (int w = 0; w < n_wg; ++w)
          planes_ready<kThreads, T>(base + w * kTile, tid);
      planes_ready<kThreads, T>(slot(i), tid);
      planes_ready<kThreads, T>(slot(i) + kTile, tid);
      fence_async_shared();
      // Every thread's copies are visible, and every warpgroup is done
      // with load i - 1, whose slot load i + kAhead refills.
      __syncthreads();
      issue(i + kAhead);
    };
#pragma unroll
    for (int i = 0; i < kAhead; ++i) issue(i);

    // Pass 1: the row maxima, the last tile alone, then two tiles a step.
    float s2[32];
    arrive(0);
    if (active) {
      const int kv0 = (nt - 1) * kRows;
      const uint32_t sKa = slot(0);
#define LT_STEP(W)                                                        \
  fwd_max_step<P, kHD, W, true, 0, false>(s, s2, sQ, sKa, 0, kv0, N, scale, \
                                          t, m0, m1)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    }
    for (int i = 1; i < n1; ++i) {
      arrive(i);
      if (!active) continue;
      const int a = 2 * (i - 1), kv0 = a * kRows;
      const uint32_t sKa = slot(i), sKb = sKa + kTile;
      if (a + 1 < nt - 1)
        fwd_max_step<P, kHD, 64, false, 64, false>(s, s2, sQ, sKa, sKb, kv0,
                                                   N, scale, t, m0, m1);
      else
        fwd_max_step<P, kHD, 64, false, 0, false>(s, s2, sQ, sKa, 0, kv0, N,
                                                  scale, t, m0, m1);
    }
    if (active) quad_max(m0, m1);

    // Pass 2: S, p and o += P . V a tile, the last tile first.
    zero(acc);
    const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;
    arrive(n1);
    if (active) {
      const uint32_t sK = slot(n1), sV = sK + kTile;
      const int kv0 = (nt - 1) * kRows;
#define LT_STEP(W)                                                        \
  output_tile<P, W, true>(s, acc, sQ, sK, sV, kv0, N, scale2, t, c0, c1, l0, \
                          l1)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    }
    for (int j = 1; j < nt; ++j) {
      const int i = n1 + j;
      arrive(i);
      if (!active) continue;
      const uint32_t sK = slot(i), sV = sK + kTile;
      output_tile<P, 64, false>(s, acc, sQ, sK, sV, (j - 1) * kRows, N,
                                scale2, t, c0, c1, l0, l1);
    }
    cp_async_wait<0>();
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  // This thread's rows of the warpgroup's 64: warp's 16, then g and g + 8;
  // its columns 8 j + 2 t and + 1.
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  T* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < N)
      store2(oh + r0 * os.n + col, acc[4 * j] / l0, acc[4 * j + 1] / l0);
    if (r1 < N)
      store2(oh + r1 * os.n + col, acc[4 * j + 2] / l1, acc[4 * j + 3] / l1);
  }
  if (t == 0) {
    float* lh = lse + (static_cast<long>(b) * gridDim.y + h) * N;
    if (r0 < N) lh[r0] = m0 + logf(l0);
    if (r1 < N) lh[r1] = m1 + logf(l1);
  }
}

// The launch at hd 128 (N <= 768), as the C entries of the forward sources
// take their arguments.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int N, int H, const long* strides, float scale,
           void* stream) {
  const int nt = (N + kRows - 1) / kRows;
  if (N < 1 || nt > kMaxTiles) return cudaErrorInvalidValue;
  constexpr int kTile = Planes<T>::value * G::kTileBytes;
  const bool one = nt == 1;
  const int n_wg = one ? 1 : 2;
  const int slots = one ? 1 : Config<T>::kAhead + 1;
  const size_t smem = 1024 + static_cast<size_t>(n_wg + 2 * slots) * kTile;
  auto kernel = one ? attention_fwd_hd128_kernel<T, true>
                    : attention_fwd_hd128_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nt + n_wg - 1) / n_wg, H, B);
  kernel<<<grid, n_wg * 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      N, strides_of(strides, 0), strides_of(strides, 1),
      strides_of(strides, 2), strides_of(strides, 3), scale);
  return cudaGetLastError();
}

}  // namespace hd128
}  // namespace sm90
}  // namespace lt
