// Multi-head self-attention, forward, at head dim 16 on Hopper's warpgroup
// tensor-core products: K1 (flat layout) and K4 (per-head layout), one
// kernel template for both dtypes, launched by flat_attention_fwd_sm90.cu
// (bf16) and flat_attention_fwd_f32_sm90.cu (fp32) when hd = 16.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel (K1)
// and ::_fwd_kernel (K4) at hd 16, the vittest ViTs' head dim. Tensors are
// read and written in place through three strides (batch, token, head), as
// at hd 64; lse is (B, H, N) fp32.
//
// Numerics are those of the hd-64 kernels, which are the TPU kernel's: s =
// (q . k) * scale in fp32, m = max over ALL keys (a first pass over the
// same products as the second), p = bf16(exp(s - m)) as __expf's 2^(x log2
// e) with log2 e folded into one FFMA and subnormals flushed to 0, l = sum
// of the rounded p in fp32, o = (p . v) / l, lse = m + log(l). fp32 q/k/v
// enter the bf16 tensor cores as hi/lo planes (mma.cuh): q . k from three
// chains (hi.hi, hi.lo, lo.hi), p . v from two (p.v_hi, p.v_lo).
//
// What bounds it on an H100: at (8, 257, 2, 16) q/k/v in and o out are
// 0.53 MB in bf16 (1.05 MB in fp32), 0.2-0.3 us at 3.35 TB/s, and the
// products 17 MFLOP: nothing. A launch, one round trip to device memory and
// the chain of dependent products a warpgroup runs set the time, so the
// design shortens that chain:
//   - Grid (query tiles, H, B), one warpgroup (128 threads) a block owning
//     64 query rows: (8, 257, 2, 16) is 80 blocks on 132 SMs, where two
//     warpgroups a block would leave 48. A single warpgroup has no index to
//     branch on, so every path around the products is warp-uniform.
//   - The block stages its Q tile and ALL of its head's K and V at once,
//     one commit group and one barrier (N <= 768: 12 key tiles of 2 KB per
//     bf16 plane, 49 KB in bf16 and 98 KB as fp32 hi/lo planes). Pass 1
//     and pass 2 then issue their products back to back, with no ring and
//     no block barrier between key tiles.
//   - bf16 rows land by cp.async; fp32 rows land raw by cp.async too, in
//     the slots of their own hi and lo planes, and each thread splits its
//     own chunks in place after the wait (copy_tile_f32, split_tile in
//     sm90.cuh): one round trip for every tile, where loads through
//     registers would take one per batch the registers hold.
//   - Shared memory in the 32-byte swizzle (a row of hd 16 bf16 is one
//     atom; sm90.cuh). V stays row-major, an MN-major B operand through the
//     transpose bit, as at hd 64: the copies stay 16-byte cp.async with no
//     transposing pass through registers, and P . V is m64n16k16 with the
//     probabilities as the register A operand.
//   - Pass 1 takes the last (masked) key tile on its own, then the whole
//     tiles two a step, both S issued at once and the first tile's maxima
//     taken while the second computes; pass 2 issues o += P . V and the
//     next tile's S in one batch. At N = 257: 1 + 2 + 1 + 5 waits on
//     products.
//   - The last key tile runs at the narrowest wgmma width that covers its
//     keys (16, 32, 48 or 64), and N <= 64 (one key tile, the local views)
//     is its own instantiation, S computed once for both passes.
//   - The copies are branch-free, so ptxas keeps the products asynchronous.
#pragma once

#include "sm90.cuh"

namespace lt {
namespace sm90 {
namespace hd16 {

// kOneTile: N <= 64, one key tile, S computed once for both passes.
template <typename T, bool kOneTile>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_hd16_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o,
                              float* __restrict__ lse, int N, Strides qs,
                              Strides ks, Strides vs, Strides os,
                              float scale) {
  constexpr int P = Planes<T>::value;
  constexpr int kPlanes = P * G::kTileBytes;  // a tile's bf16 planes
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window:
  // the Q tile, then key tile i's K planes and V planes at slot(i).
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  auto slot = [&](int i) { return base + kPlanes + i * 2 * kPlanes; };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;
  const int nt = kOneTile ? 1 : (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width

  // Q, and every K and V tile of the head, behind one barrier.
  stage(sQ, qh, qs.n, q0, N, tid);
  for (int i = 0; i < nt; ++i) {
    stage(slot(i), kh, ks.n, i * kRows, N, tid);
    stage(slot(i) + kPlanes, vh, vs.n, i * kRows, N, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (P == 2) {
    split_tile<kThreads, kHD>(sQ, tid);
    for (int i = 0; i < nt; ++i) {
      split_tile<kThreads, kHD>(slot(i), tid);
      split_tile<kThreads, kHD>(slot(i) + kPlanes, tid);
    }
  }
  fence_async_shared();
  __syncthreads();

  float acc[8], s[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * kLog2e;

  if constexpr (kOneTile) {
#define LT_ONE(W)                                                       \
  wgmma_fence();                                                        \
  scores<P, W>(s, sQ, slot(0));                                         \
  wgmma_commit();                                                       \
  wgmma_wait<0>();                                                      \
  fence_registers(s);                                                   \
  row_max<W, true>(s, 0, N, scale, t, m0, m1);                          \
  quad_max(m0, m1);                                                     \
  fwd_output_step<P, kHD, W, true, 0>(s, acc, sQ, 0, slot(0) + kPlanes, 0, \
                                      N, scale2, t, m0 * kLog2e,           \
                                      m1 * kLog2e, l0, l1)
    LT_BY_TAIL(tail16, LT_ONE);
#undef LT_ONE
  } else {
    // Pass 1: the row maxima. The last tile (masked, at its narrowest
    // width) first, on its own, then the whole tiles two a step, unmasked;
    // the maxima are exact in any order. With the masked step inside the
    // loop, ptxas serialized every product of the fp32 form (C7511).
    float s2[32];
    {
      const int kv0 = (nt - 1) * kRows;
#define LT_STEP(W)                                                         \
  fwd_max_step<P, kHD, W, true, 0, false>(s, s2, sQ, slot(nt - 1), 0, kv0, \
                                          N, scale, t, m0, m1)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    }
    for (int i = 0; i < nt - 1; i += 2) {
      const int kv0 = i * kRows;
      if (i + 1 < nt - 1)
        fwd_max_step<P, kHD, 64, false, 64, false>(
            s, s2, sQ, slot(i), slot(i + 1), kv0, N, scale, t, m0, m1);
      else
        fwd_max_step<P, kHD, 64, false, 0, false>(s, s2, sQ, slot(i), 0, kv0,
                                                  N, scale, t, m0, m1);
    }
    quad_max(m0, m1);

    // Pass 2: p from S, then P . V and the next tile's S in one batch.
    const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;
    wgmma_fence();
    scores<P, kRows>(s, sQ, slot(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(s);
    for (int j = 0; j < nt; ++j) {
      const uint32_t sKn = slot(j + 1), sV = slot(j) + kPlanes;
      const int kv0 = j * kRows;
      if (j < nt - 2) {
        fwd_output_step<P, kHD, 64, false, 64>(s, acc, sQ, sKn, sV, kv0, N,
                                               scale2, t, c0, c1, l0, l1);
      } else if (j == nt - 2) {
#define LT_STEP(W)                                                          \
  fwd_output_step<P, kHD, 64, false, W>(s, acc, sQ, sKn, sV, kv0, N,       \
                                        scale2, t, c0, c1, l0, l1)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      } else {
#define LT_STEP(W)                                                       \
  fwd_output_step<P, kHD, W, true, 0>(s, acc, sQ, 0, sV, kv0, N, scale2,   \
                                      t, c0, c1, l0, l1)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  // This thread's rows of the block's 64: warp's 16, then g and g + 8; its
  // columns 8 j + 2 t and + 1.
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

// The launch at hd 16 (N <= 768), as the C entries of the forward sources
// take their arguments.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int N, int H, const long* strides, float scale,
           void* stream) {
  const int nt = (N + kRows - 1) / kRows;
  if (N < 1 || nt > kMaxTiles) return cudaErrorInvalidValue;
  constexpr int P = Planes<T>::value;
  const size_t smem =
      1024 + static_cast<size_t>(P * (1 + 2 * nt)) * G::kTileBytes;
  auto kernel = nt == 1 ? attention_fwd_hd16_kernel<T, true>
                        : attention_fwd_hd16_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nt, H, B), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      N, strides_of(strides, 0), strides_of(strides, 1),
      strides_of(strides, 2), strides_of(strides, 3), scale);
  return cudaGetLastError();
}

}  // namespace hd16
}  // namespace sm90
}  // namespace lt
