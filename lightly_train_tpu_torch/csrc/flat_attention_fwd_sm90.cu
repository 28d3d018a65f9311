// Multi-head self-attention, forward, bf16: K1 (flat layout) and K4
// (per-head layout) on Hopper's warpgroup tensor-core products, at head dim
// 64 (this file's kernel), 16 (attention_fwd_hd16.cuh's, in bf16) and 128
// (attention_fwd_hd128_resident.cuh's for 64 < N <= 304 and scale > 0,
// else attention_fwd_hd128.cuh's, in bf16).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel (K1,
// q/k/v as (B, N, H * hd)) and ::_fwd_kernel (K4, q/k/v as (B, H, N, hd))
// for bf16 q/k/v; fp32 is flat_attention_fwd_f32_sm90.cu. Each tensor is
// read or written in place through three strides (batch, token, head; the
// column stride is 1), as there: the flat layout, a view of a fused qkv
// output, (B, N, H, hd) and (B, H, N, hd). lse is (B, H, N) fp32.
//
// Numerics are the TPU kernel's: s = (q . k) * scale in fp32, m = max over
// ALL keys (a first pass), p = bf16(exp(s - m)), l = sum of the rounded p in
// fp32, o = (p . v) / l, lse = m + log(l). exp is __expf's 2^(x log2 e) with
// log2 e folded into the one FFMA that forms the exponent and subnormal
// results flushed to 0; beside the plain version only that rounding and the
// order of the fp32 sums differ.
//
// The kernel below is the hd-64 one; its tiles, descriptors and products
// are sm90.cuh's at their default head dim, 64. At hd 16 the C entry
// launches attention_fwd_hd16.cuh's kernel, which takes the same helpers at
// hd 16 (the 32-byte swizzle) and stages a whole head at once; at hd 128
// attention_fwd_hd128.cuh's, whose tiles are two hd-64 sub-tiles a row.
//
// What bounds it on an H100: at the ViT-B/14 global shape (B=64, N=257,
// H=12) q/k/v in and o out are 101 MB, ~30 us at 3.35 TB/s; the three N^2 hd
// products per head (q . k twice, p . v once) are 20 GFLOP, ~20 us at the
// bf16 tensor peak, ~26 us once padded to 64-row tiles. Both are close, so
// the design keeps the tensor cores fed and the copies in flight:
//   - Grid (query tiles / 2, H, B): two warpgroups (4 warps each) a block,
//     each owning 64 query rows, so every K/V tile a block loads serves 128
//     queries. A warpgroup's Q tile sits in shared memory as the A operand
//     of wgmma m64nNk16 (fp32 accumulators in registers). N <= 64 (one key
//     tile, the local views) is its own instantiation with one warpgroup,
//     S computed once for both passes.
//   - K and V stream through a ring of kSlots slots (64 keys x 64 hd bf16,
//     8 KB each, K and V a slot), filled with cp.async.cg 16-byte copies
//     kAhead loads ahead of the products, one block barrier a step; rows at
//     or past N are zero-filled (src-size 0) without memory traffic. The
//     copies write the 128-byte swizzle (chunk c of row r at chunk
//     c ^ (r & 7)): a bf16 row of 64 is one swizzle atom, so a tile is a
//     wgmma operand as it lands.
//   - Pass 1 takes two K tiles a step (in one slot): both S issued at once,
//     the first tile's row maxima taken while the second computes.
//   - Pass 2: p and l from S in registers, then o += P . V and the next
//     tile's S in one batch of products. P is the register A operand (a
//     warp's 16 rows of an accumulator are laid out as the A operand once
//     packed); V is an MN-major B operand (transpose bit).
//   - The last key tile runs at the narrowest wgmma width that covers its
//     keys (16, 32, 48 or 64): N = 257 is 4 x 64 + 1.
//   - The copies are branch-free and the warpgroup index is warp-uniform:
//     the compiler serializes products in a path it cannot prove uniform.
// Each warpgroup still alternates products and softmax between block
// barriers, and q . k runs twice; PERF.md has the measurements. Later work:
// TMA loads from a warp-specialised producer.
#include "attention_fwd_hd128.cuh"
#include "attention_fwd_hd128_resident.cuh"
#include "attention_fwd_hd16.cuh"
#include "sm90.cuh"

namespace {

using lt::bf16;
using namespace lt::sm90;

constexpr int kAhead = 4;           // K/V loads in flight ahead of a step
constexpr int kSlots = kAhead + 1;  // ring slots, each a K and a V tile

// Pass 1, two key tiles (the second of width NKb, none if 0) of one ring
// slot: both S issued at once, the first folded into the row maxima while
// the second computes.
template <int NKa, bool kMaskA, int NKb, bool kMaskB>
__device__ __forceinline__ void max_step(float (&sa)[32], float (&sb)[32],
                                         uint32_t sQ, uint32_t slot, int kv0,
                                         int N, float scale, int t,
                                         float& m0, float& m1) {
  wgmma_fence();
  issue_scores<NKa>(sa, sQ, slot);
  wgmma_commit();
  if constexpr (NKb > 0) {
    issue_scores<NKb>(sb, sQ, slot + kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_registers(sa);
  row_max<NKa, kMaskA>(sa, kv0, N, scale, t, m0, m1);
  if constexpr (NKb > 0) {
    wgmma_wait<0>();
    fence_registers(sb);
    row_max<NKb, kMaskB>(sb, kv0 + kRows, N, scale, t, m0, m1);
  }
}

// Pass 2, one tile: S of this tile (width NK) is in s; p and l from it,
// then o += P . V and the next tile's S (width NKn, none if 0) into s in
// one batch of products.
template <int NK, bool kMask, int NKn>
__device__ __forceinline__ void output_step(float (&s)[32], float (&o)[32],
                                            uint32_t sQ, uint32_t sKn,
                                            uint32_t sV, int kv0, int N,
                                            float scale2, int t, float c0,
                                            float c1, float& l0, float& l1) {
  uint32_t a[4][4];
  probabilities<NK, kMask>(s, a, kv0, N, scale2, t, c0, c1, l0, l1);
  wgmma_fence();
  issue_pv<NK>(o, a, sV);
  if constexpr (NKn > 0) issue_scores<NKn>(s, sQ, sKn);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(o);
  fence_registers(s);
}

// kOneTile: N <= 64, one key tile and one warpgroup, in an instantiation of
// its own (as a branch beside the ring's path it measured slower); else two
// warpgroups.
template <bool kOneTile>
__global__ void __launch_bounds__(kOneTile ? 128 : 256, 1)
    attention_fwd_sm90_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o,
                              float* __restrict__ lse, int N, lt::Strides qs,
                              lt::Strides ks, lt::Strides vs, lt::Strides os,
                              float scale) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window.
  const uint32_t base = (lt::smem_addr(smem_raw) + 1023) & ~1023u;
  constexpr int n_wg = kOneTile ? 1 : 2, kThreads = n_wg * 128;
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform; it
  // serializes the products in a path it cannot prove uniform.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const uint32_t sQ = base + wg * kTileBytes;
  const uint32_t ring = base + n_wg * kTileBytes;  // slot: K tile, V tile
  const int q0 = (blockIdx.x * n_wg + wg) * kRows;
  const bool active = q0 < N;  // uniform over the warpgroup
  const bf16* qh = q + b * qs.b + h * qs.h;
  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width
  const int tid = threadIdx.x;

  // The block's Q tiles, with the first K/V load.
  for (int w = 0; w < n_wg; ++w)
    load_tile<kThreads>(base + w * kTileBytes, qh, qs.n,
                        (blockIdx.x * n_wg + w) * kRows, N, tid);

  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * kLog2e;

  if constexpr (kOneTile) {
    // One key tile: S once, kept for both passes.
    load_tile<kThreads>(ring, kh, ks.n, 0, N, tid);
    load_tile<kThreads>(ring + kTileBytes, vh, vs.n, 0, N, tid);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (active) {
#define LT_ONE(W)                                                        \
  wgmma_fence();                                                         \
  issue_scores<W>(s, sQ, ring);                                          \
  wgmma_commit();                                                        \
  wgmma_wait<0>();                                                       \
  fence_registers(s);                                                    \
  row_max<W, true>(s, 0, N, scale, t, m0, m1);                           \
  quad_max(m0, m1);                                                      \
  output_step<W, true, 0>(s, acc, sQ, ring, ring + kTileBytes, 0, N,     \
                          scale2, t, m0 * kLog2e, m1 * kLog2e, l0, l1)
      LT_BY_TAIL(tail16, LT_ONE);
#undef LT_ONE
    }
  } else {
    // Load i of the ring: K tiles 2 i and 2 i + 1 (pass 1, n1 loads), then
    // K and V tile i - n1 (pass 2); one commit group per load, empty past
    // the end. A pass-2 step also reads load i + 1, so loads i and i + 1
    // have landed before step i, and kAhead - 1 more are in flight.
    const int n1 = (nt + 1) / 2, n_loads = n1 + nt;
    auto slot = [&](int i) { return ring + (i % kSlots) * 2 * kTileBytes; };
    auto issue = [&](int i) {
      if (i < n1) {
        load_tile<kThreads>(slot(i), kh, ks.n, 2 * i * kRows, N, tid);
        load_tile<kThreads>(slot(i) + kTileBytes, kh, ks.n,
                            (2 * i + 1) * kRows, N, tid);
      } else if (i < n_loads) {
        const int row0 = (i - n1) * kRows;
        load_tile<kThreads>(slot(i), kh, ks.n, row0, N, tid);
        load_tile<kThreads>(slot(i) + kTileBytes, vh, vs.n, row0, N, tid);
      }
      cp_async_commit();
    };
    auto arrive = [&](int i) {
      cp_async_wait<kAhead - 2>();
      fence_async_shared();
      // Every thread's copies are visible, and every warpgroup is done
      // with load i - 1, whose slot load i + kAhead refills.
      __syncthreads();
      issue(i + kAhead);
    };
#pragma unroll
    for (int i = 0; i < kAhead; ++i) issue(i);

    // Pass 1: the row maxima, two key tiles a step.
    float s2[32];
    for (int i = 0; i < n1; ++i) {
      arrive(i);
      if (!active) continue;
      const int a = 2 * i, kv0 = a * kRows;
      if (a + 1 < nt - 1) {
        max_step<64, false, 64, false>(s, s2, sQ, slot(i), kv0, N, scale, t,
                                       m0, m1);
      } else if (a + 1 == nt - 1) {
#define LT_STEP(W)                                                        \
  max_step<64, false, W, true>(s, s2, sQ, slot(i), kv0, N, scale, t, m0, \
                               m1)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      } else {
#define LT_STEP(W) \
  max_step<W, true, 0, false>(s, s2, sQ, slot(i), kv0, N, scale, t, m0, m1)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      }
    }
    if (active) quad_max(m0, m1);

    // Pass 2: p from S, then P . V and the next tile's S in one batch.
    for (int j = 0; j < nt; ++j) {
      const int i = n1 + j;
      arrive(i);
      if (!active) continue;
      const uint32_t sK = slot(i), sKn = slot(i + 1), sV = sK + kTileBytes;
      const int kv0 = j * kRows;
      if (j == 0) {
        wgmma_fence();
        issue_scores<kRows>(s, sQ, sK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(s);
      }
      const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;
      if (j < nt - 2) {
        output_step<64, false, 64>(s, acc, sQ, sKn, sV, kv0, N, scale2, t,
                                   c0, c1, l0, l1);
      } else if (j == nt - 2) {
#define LT_STEP(W)                                                      \
  output_step<64, false, W>(s, acc, sQ, sKn, sV, kv0, N, scale2, t, c0, c1, \
                            l0, l1)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      } else {
#define LT_STEP(W)                                                    \
  output_step<W, true, 0>(s, acc, sQ, 0, sV, kv0, N, scale2, t, c0, c1, \
                          l0, l1)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      }
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
  bf16* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < N)
      lt::store2(oh + r0 * os.n + col, acc[4 * j] / l0, acc[4 * j + 1] / l0);
    if (r1 < N)
      lt::store2(oh + r1 * os.n + col, acc[4 * j + 2] / l1,
                 acc[4 * j + 3] / l1);
  }
  if (t == 0) {
    float* lh = lse + (static_cast<long>(b) * gridDim.y + h) * N;
    if (r0 < N) lh[r0] = m0 + logf(l0);
    if (r1 < N) lh[r1] = m1 + logf(l1);
  }
}

}  // namespace

// strides: (batch, token, head) for q, k, v, o. bf16 (fp32 = 0) at hd = 64,
// 16 or 128 (N <= 768).
extern "C" int lt_attention_fwd_sm90(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int fp32, int B, int N, int H, int hd,
                                     const long* strides, float scale,
                                     void* stream) {
  if (fp32 || N < 1) return cudaErrorInvalidValue;
  if (hd == 16)
    return lt::sm90::hd16::launch<bf16>(q, k, v, o, lse, B, N, H, strides,
                                        scale, stream);
  if (hd == 128) {
    if (N > kRows && N <= lt::sm90::hd128::kResidentMaxN && scale > 0.f)
      return lt::sm90::hd128::launch_resident<bf16>(q, k, v, o, lse, B, N, H,
                                                    strides, scale, stream);
    return lt::sm90::hd128::launch<bf16>(q, k, v, o, lse, B, N, H, strides,
                                         scale, stream);
  }
  if (hd != 64) return cudaErrorInvalidValue;
  const int q_tiles = (N + kRows - 1) / kRows;
  const bool one = q_tiles == 1;
  const int n_wg = one ? 1 : 2;
  const size_t smem =
      1024 + static_cast<size_t>(n_wg + 2 * (one ? 1 : kSlots)) * kTileBytes;
  auto kernel = one ? attention_fwd_sm90_kernel<true>
                    : attention_fwd_sm90_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((q_tiles + n_wg - 1) / n_wg, H, B);
  kernel<<<grid, n_wg * 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), N, lt::strides_of(strides, 0),
      lt::strides_of(strides, 1), lt::strides_of(strides, 2),
      lt::strides_of(strides, 3), scale);
  return cudaGetLastError();
}
