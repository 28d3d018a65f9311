// Multi-head self-attention, forward, fp32: K1 (flat layout) and K4
// (per-head layout) on Hopper's warpgroup tensor-core products, at head dim
// 64 (this file's kernel), 16 (attention_fwd_hd16.cuh's, in fp32) and 128
// (attention_fwd_hd128_resident.cuh's for 64 < N <= 304 and scale > 0,
// else attention_fwd_hd128.cuh's, in fp32).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel (K1,
// q/k/v as (B, N, H * hd)) and ::_fwd_kernel (K4, q/k/v as (B, H, N, hd))
// for fp32 q/k/v; bf16 is flat_attention_fwd_sm90.cu. Each tensor is read
// or written in place through three strides (batch, token, head; the
// column stride is 1), as there. o is fp32, lse is (B, H, N) fp32.
//
// Numerics are the TPU kernel's: s = (q . k) * scale in fp32, m = max over
// ALL keys (a first pass over the same products as the second), p =
// bf16(exp(s - m)), l = sum of the rounded p in fp32, o = (p . v) / l
// stored in fp32, lse = m + log(l). The fp32 operands go through the bf16
// tensor cores as hi/lo planes, hi = bf16_rn(x) and lo = bf16_rn(x - hi)
// (mma.cuh): q . k = hi.hi + hi.lo + lo.hi with lo.lo dropped, p . v =
// p.v_hi + p.v_lo (p is exact in bf16), fp32 accumulation throughout. exp
// is __expf's 2^(x log2 e) with log2 e folded into the one FFMA that forms
// the exponent and subnormal results flushed to 0 (as in the bf16 kernel);
// s sums its three products chain by chain over the whole depth (all of
// hi.hi, then hi.lo, then lo.hi), and o its two (p.v_hi over the tile's
// keys, then p.v_lo); l is summed per 64-key tile in this thread's pairs
// before the quad's shuffle; the order inside one wgmma is the hardware's.
//
// The kernel below is the hd-64 one; its tiles, descriptors and products
// are sm90.cuh's at their default head dim, 64. At hd 16 the C entry
// launches attention_fwd_hd16.cuh's kernel in fp32, which lands the rows
// by cp.async and splits them in shared memory instead (one round trip for
// a whole head); at hd 128, for 64 < N <= 304 and scale > 0 (the 7B
// ViTs' N = 201 and 257), attention_fwd_hd128_resident.cuh's: persistent
// blocks, TMA loads from a producer warpgroup whose warps split each tile
// into its planes once a load, S of every key tile in registers so that
// q . k runs once (bytes bound it, then shared memory's bandwidth: each
// tile is also split in it); else attention_fwd_hd128.cuh's two-pass
// kernel, which lands the rows by cp.async and splits them in shared
// memory through a ring.
//
// What bounds it on an H100: at the ViT-B/14 global shape (B=64, N=257,
// H=12) q/k/v in and o out are 202 MB, ~60 us at 3.35 TB/s; the products
// it runs are 8 bf16 passes of N^2 hd a head (3 for q . k, twice, and 2 for
// p . v), 52 GFLOP (68 once padded to 64-row query tiles), ~53 us (~69 us)
// at the bf16 tensor peak. The design keeps the tensor cores fed from
// planes split once:
//   - Grid (query tiles / 2, H, B): two warpgroups a block, each owning 64
//     query rows, whose Q is split once into its hi/lo planes (two K-major
//     swizzled 64 x 64 bf16 tiles, 16 KB). N <= 64 (one key tile, the local
//     views) is its own instantiation with one warpgroup, S computed once
//     for both passes.
//   - cp.async cannot convert, so the block's threads load K and V tiles
//     (fp32, 16 KB each) with 16-byte ld.global one load ahead into
//     registers, and split and store them (st.shared, the 128-byte swizzle)
//     while the products of the current step run; one block barrier a step.
//     Rows at or past N are zero in both planes, without a read.
//   - Resident (N <= 384): every K and V tile of the head gets a slot of
//     its own (32 KB: K hi, K lo, V hi, V lo), so each is read and split
//     once for both passes, and pass 2 runs without a barrier. Streamed
//     (N > 384): a ring of three slots; pass 1 loads K tiles, pass 2 K and
//     V again.
//   - Pass 1: S from three product chains into one accumulator, then the
//     row maxima. Pass 2: p and l from S in registers, then o += P . V_hi +
//     P . V_lo and the next tile's S in one batch. P is the register A
//     operand, both V planes MN-major B operands (transpose bit).
//   - The last key tile runs at the narrowest wgmma width that covers its
//     keys (16, 32, 48 or 64).
//   - The loads are predicated, not branched, and the warpgroup index is
//     warp-uniform: ptxas serializes products in a path it cannot prove
//     uniform.
// Each warpgroup still alternates products and arithmetic within a step;
// leaving P . V in flight under the next tile's probabilities made ptxas
// serialize the products (C7511, C7519), as did register fences before
// wgmma.fence. PERF.md has the measurements.
#include "attention_fwd_hd128.cuh"
#include "attention_fwd_hd128_resident.cuh"
#include "attention_fwd_hd16.cuh"
#include "sm90.cuh"

namespace {

using namespace lt::sm90;

constexpr int kSlotBytes = 4 * kTileBytes;  // K hi, K lo, V hi, V lo
constexpr int kStreamSlots = 3;  // streamed ring: steps read 2, 1 is filled
constexpr int kMaxResident = 6;  // key tiles held whole: 1 + 32 + 192 KB

// Pass 1, one key tile (width NK) at sK: S issued, `overlap` (this
// thread's part of the block's loads) run under the products, then the
// row maxima.
template <int NK, bool kMask, typename F>
__device__ __forceinline__ void max_step(float (&s)[32], uint32_t sQ,
                                         uint32_t sK, int kv0, int N,
                                         float scale, int t, float& m0,
                                         float& m1, F&& overlap) {
  wgmma_fence();
  issue_scores_split<NK>(s, sQ, sK);
  wgmma_commit();
  overlap();
  wgmma_wait<0>();
  fence_registers(s);
  row_max<NK, kMask>(s, kv0, N, scale, t, m0, m1);
}

// Pass 2, one tile: S of this tile (width NK) is in s; p and l from it,
// then o += P . V_hi + P . V_lo (V planes at sV) and the next tile's S
// (width NKn, none if 0; K planes at sKn) into s in one batch of products,
// with `overlap` under them.
template <int NK, bool kMask, int NKn, typename F>
__device__ __forceinline__ void output_step(float (&s)[32], float (&o)[32],
                                            uint32_t sQ, uint32_t sKn,
                                            uint32_t sV, int kv0, int N,
                                            float scale2, int t, float c0,
                                            float c1, float& l0, float& l1,
                                            F&& overlap) {
  uint32_t a[4][4];
  probabilities<NK, kMask>(s, a, kv0, N, scale2, t, c0, c1, l0, l1);
  wgmma_fence();
  issue_pv<NK>(o, a, sV);
  issue_pv<NK>(o, a, sV + kTileBytes);
  if constexpr (NKn > 0) issue_scores_split<NKn>(s, sQ, sKn);
  wgmma_commit();
  overlap();
  wgmma_wait<0>();
  fence_registers(o);
  fence_registers(s);
}

// kOneTile: N <= 64, one key tile and one warpgroup. Else two warpgroups,
// and kResident: every key tile of the head has a slot (N <= 384), or a
// streamed ring of kStreamSlots.
template <bool kOneTile, bool kResident>
__global__ void __launch_bounds__(kOneTile ? 128 : 256, 1)
    attention_fwd_f32_sm90_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  float* __restrict__ o,
                                  float* __restrict__ lse, int N,
                                  lt::Strides qs, lt::Strides ks,
                                  lt::Strides vs, lt::Strides os,
                                  float scale) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window.
  const uint32_t base = (lt::smem_addr(smem_raw) + 1023) & ~1023u;
  constexpr int n_wg = kOneTile ? 1 : 2, kThreads = n_wg * 128;
  constexpr int kPer = kRows * 16 / kThreads;  // float4 of a tile a thread
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const uint32_t sQ = base + wg * 2 * kTileBytes;  // Q hi, Q lo
  const uint32_t ring = base + n_wg * 2 * kTileBytes;
  const int q0 = (blockIdx.x * n_wg + wg) * kRows;
  const bool active = q0 < N;  // uniform over the warpgroup
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width
  const int tid = threadIdx.x;
  const float scale2 = scale * kLog2e;

  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float4 xk[kPer], xv[kPer];  // the K and V tiles of the next load

  if constexpr (kOneTile) {
    float4 xq[kPer];
    fetch<kThreads>(xq, qh, qs.n, 0, N, tid);
    fetch<kThreads>(xk, kh, ks.n, 0, N, tid);
    fetch<kThreads>(xv, vh, vs.n, 0, N, tid);
    store_planes<kThreads>(sQ, xq, tid);
    store_planes<kThreads>(ring, xk, tid);
    store_planes<kThreads>(ring + 2 * kTileBytes, xv, tid);
    fence_async_shared();
    __syncthreads();
    // One key tile: S once, kept for both passes.
#define LT_ONE(W)                                                          \
  fence_registers(s);                                                      \
  wgmma_fence();                                                           \
  issue_scores_split<W>(s, sQ, ring);                                      \
  wgmma_commit();                                                          \
  wgmma_wait<0>();                                                         \
  fence_registers(s);                                                      \
  row_max<W, true>(s, 0, N, scale, t, m0, m1);                             \
  quad_max(m0, m1);                                                        \
  output_step<W, true, 0>(s, acc, sQ, 0, ring + 2 * kTileBytes, 0, N,      \
                          scale2, t, m0 * kLog2e, m1 * kLog2e, l0, l1, [] {})
    LT_BY_TAIL(tail16, LT_ONE);
#undef LT_ONE
  } else {
    // Load i fills slot(i): K tile i and V tile i (resident), or K tile i
    // for pass 1 (i < nt) and K and V tile i - nt for pass 2 (streamed).
    const int n_loads = kResident ? nt : 2 * nt;
    auto slot = [&](int i) {
      return ring + (kResident ? i : i % kStreamSlots) * kSlotBytes;
    };
    auto fetch_load = [&](int i) {
      const int row0 = (kResident || i < nt ? i : i - nt) * kRows;
      fetch<kThreads>(xk, kh, ks.n, row0, N, tid);
      if (kResident || i >= nt) fetch<kThreads>(xv, vh, vs.n, row0, N, tid);
    };
    auto store_load = [&](int i) {
      store_planes<kThreads>(slot(i), xk, tid);
      if (kResident || i >= nt)
        store_planes<kThreads>(slot(i) + 2 * kTileBytes, xv, tid);
    };
    // Step `step` (pass 1: the step-th, pass 2: the (step - nt)-th) reads
    // loads step and step + 1 (pass 2, streamed) or fewer, which have
    // landed; under its products it stores load step + 2, fetched during
    // the step before, and fetches load step + 3. A slot is refilled three
    // loads after it was filled (streamed), after the barrier that ends
    // the last step that read it.
    int step = 0;
    auto overlap = [&] {
      if (step + 2 < n_loads) {
        store_load(step + 2);
        if (step + 3 < n_loads) fetch_load(step + 3);
      }
    };
    auto settle = [&] {
      if (step + 2 < n_loads) {
        fence_async_shared();
        __syncthreads();
      }
      ++step;
    };

    {  // The block's Q tiles and loads 0 and 1; load 2 in flight.
      float4 xq[n_wg][kPer];
      for (int w = 0; w < n_wg; ++w)
        fetch<kThreads>(xq[w], qh, qs.n, (blockIdx.x * n_wg + w) * kRows, N,
                        tid);
      fetch_load(0);
      for (int w = 0; w < n_wg; ++w)
        store_planes<kThreads>(base + w * 2 * kTileBytes, xq[w], tid);
      store_load(0);
    }
    fetch_load(1);
    store_load(1);
    if (n_loads > 2) fetch_load(2);
    fence_async_shared();
    __syncthreads();

    // Pass 1: the row maxima over every key.
    for (int i = 0; i < nt; ++i) {
      const uint32_t sK = slot(i);
      const int kv0 = i * kRows;
      if (!active) {
        overlap();
      } else if (i < nt - 1) {
        max_step<64, false>(s, sQ, sK, kv0, N, scale, t, m0, m1, overlap);
      } else {
#define LT_STEP(W) \
  max_step<W, true>(s, sQ, sK, kv0, N, scale, t, m0, m1, overlap)
        LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
      }
      settle();
    }
    if (active) quad_max(m0, m1);

    // Pass 2: p from S, then P . V and the next tile's S in one batch.
    const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;
    const int first_load = kResident ? 0 : nt;  // of pass 2's tile 0
    for (int j = 0; j < nt; ++j) {
      const uint32_t sK = slot(first_load + j);
      const uint32_t sKn = slot(first_load + j + 1), sV = sK + 2 * kTileBytes;
      const int kv0 = j * kRows;
      if (!active) {
        overlap();
      } else {
        if (j == 0) {
          fence_registers(s);
          wgmma_fence();
          issue_scores_split<kRows>(s, sQ, sK);
          wgmma_commit();
          wgmma_wait<0>();
          fence_registers(s);
        }
        if (j < nt - 2) {
          output_step<64, false, 64>(s, acc, sQ, sKn, sV, kv0, N, scale2, t,
                                     c0, c1, l0, l1, overlap);
        } else if (j == nt - 2) {
#define LT_STEP(W)                                                        \
  output_step<64, false, W>(s, acc, sQ, sKn, sV, kv0, N, scale2, t, c0, c1, \
                            l0, l1, overlap)
          LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
        } else {
#define LT_STEP(W)                                                    \
  output_step<W, true, 0>(s, acc, sQ, 0, sV, kv0, N, scale2, t, c0, c1, \
                          l0, l1, overlap)
          LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
        }
      }
      settle();
    }
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  // This thread's rows of the warpgroup's 64: warp's 16, then g and g + 8;
  // its columns 8 j + 2 t and + 1.
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  float* oh = o + b * os.b + h * os.h;
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

// strides: (batch, token, head) for q, k, v, o. fp32 (fp32 = 1) at hd = 64,
// 16 or 128 (N <= 768).
extern "C" int lt_attention_fwd_f32_sm90(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int fp32, int B, int N, int H,
                                         int hd, const long* strides,
                                         float scale, void* stream) {
  if (!fp32 || N < 1) return cudaErrorInvalidValue;
  if (hd == 16)
    return lt::sm90::hd16::launch<float>(q, k, v, o, lse, B, N, H, strides,
                                         scale, stream);
  if (hd == 128) {
    if (N > kRows && N <= lt::sm90::hd128::kResidentMaxN && scale > 0.f)
      return lt::sm90::hd128::launch_resident<float>(q, k, v, o, lse, B, N, H,
                                                     strides, scale, stream);
    return lt::sm90::hd128::launch<float>(q, k, v, o, lse, B, N, H, strides,
                                          scale, stream);
  }
  if (hd != 64) return cudaErrorInvalidValue;
  const int nt = (N + kRows - 1) / kRows;
  const bool one = nt == 1, resident = nt <= kMaxResident;
  const int n_wg = one ? 1 : 2;
  const int slots = one ? 1 : resident ? nt : kStreamSlots;
  const size_t smem = 1024 + static_cast<size_t>(2 * n_wg) * kTileBytes +
                      static_cast<size_t>(slots) * kSlotBytes;
  auto kernel = one        ? attention_fwd_f32_sm90_kernel<true, true>
                : resident ? attention_fwd_f32_sm90_kernel<false, true>
                           : attention_fwd_f32_sm90_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nt + n_wg - 1) / n_wg, H, B);
  kernel<<<grid, n_wg * 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), N, lt::strides_of(strides, 0),
      lt::strides_of(strides, 1), lt::strides_of(strides, 2),
      lt::strides_of(strides, 3), scale);
  return cudaGetLastError();
}
