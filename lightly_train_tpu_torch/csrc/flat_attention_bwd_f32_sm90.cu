// Multi-head self-attention, backward, fp32: K2 (flat layout) and K5
// (per-head layout) on Hopper's warpgroup tensor-core products, at head dim
// 64 (this file's kernels), 16 (attention_bwd_hd16.cuh's, in fp32) and 128
// (attention_bwd_hd128.cuh's, in fp32).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel (K2)
// and ::_bwd_kernel (K5) for fp32 q/k/v; bf16 is flat_attention_bwd_sm90.cu.
// Each tensor is read or written in place through three strides (batch,
// token, head; the column stride is 1), as there. dq, dk and dv are fp32; lse is
// the forward's (B, H, N) fp32 log-sum-exp; delta is a (B, H, N) fp32
// scratch that the dq kernel writes for the dk/dv kernel.
//
// Numerics are the TPU kernel's:
//   p  = exp(s - lse)                  (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . bf16(do)          dp = bf16(do) . v^T
//   delta = rowsum(do * o)             (fp32, from the unrounded inputs)
//   ds = bf16(p * (dp - delta) * scale)   (the fp32 p, not bf16(p))
//   dq = ds . k                        dk = ds^T . q
// with fp32 accumulation in every product. The fp32 q, k and v go through
// the bf16 tensor cores as hi/lo planes, hi = bf16_rn(x) and lo =
// bf16_rn(x - hi) (mma.cuh); do is rounded to bf16 once, as the TPU kernel
// rounds it. A pair of tiles runs these chains:
//   s  = q . k^T:   q_hi.k_hi + q_hi.k_lo + q_lo.k_hi   (lo.lo dropped)
//   dp = do16 . v^T: do16.v_hi + do16.v_lo
//   dv = p16^T . do16                    (exact in bf16)
//   dq = ds . k_hi + ds . k_lo           dk = ds^T . q_hi + ds^T . q_lo
// exp and ds are formed as in flat_attention_bwd_sm90.cu: 2^(s scale log2 e
// - lse log2 e) with ex2.approx.ftz (subnormal results flushed to 0), and
// ds = p * (dp * scale - delta * scale). The chains of one product run one
// after another into one accumulator; delta sums four columns a thread and
// then a half warp's 16 partial sums (shuffles), in fp32.
//
// What bounds it on an H100: at the ViT-B/14 global shape (B=64, N=257,
// H=12) in fp32 404 MB move (q, k, v, o, do in; dq, dk, dv out), ~121 us at
// 3.35 TB/s, against 32.5 GFLOP of necessary products (~66 us at the TF32
// peak). The kernels run 15 bf16 passes of N^2 hd a head (s and dp in both
// kernels, 3 + 2 each; dq 2, dv 1, dk 2), 151 GFLOP once padded to 64-row
// tiles, ~153 us at the bf16 tensor peak, so the products bound this
// design. As in the bf16 backward, s and dp are recomputed in both kernels
// so that no block adds into another's output and the result is
// deterministic:
//   - cp.async cannot convert, so the block's threads read fp32 tiles with
//     predicated 16-byte ld.global into registers, and split and store them
//     (st.shared, the 128-byte swizzle of sm90.cuh) into a ring of kSlots
//     slots under a step's products; one block barrier a step. Rows at or
//     past N are zero in every plane, without a read. No cp.async: the SASS
//     holds no LDGSTS. Registers are what limits this: ptxas serializes the
//     products (C7511) where a load in registers shares a batch of
//     products with all of its kernel's accumulators and fragments.
//   - dq kernel: grid (query tiles / 2, H, B), two warpgroups a block, each
//     owning 64 query rows, with Q (hi/lo) and dO16 resident as K-major A
//     operands (48 KB for the block). K and V (hi/lo, 32 KB a slot) stream.
//     Per key tile: dS from S and dP in registers, then dQ += dS . K_hi +
//     dS . K_lo (dS the register A operand, K read MN-major) and the next
//     tile's S (3 chains) and dP (2 chains) as two commit groups; once dQ's
//     is done (dS free), the block reads and stores its load of two tiles
//     ahead under S and dP, so no load stays in registers across a step.
//     delta of the block's rows comes from the o and do rows read once in
//     the prologue; the kernel writes it for the dk/dv kernel. 145 KB of
//     shared memory: one block an SM.
//   - dk/dv kernel: the same grid over key tiles, K and V (hi/lo, 64 KB for
//     the block) resident as A operands; Q (hi/lo), dO16 (24 KB a slot),
//     lse log2 e and delta * scale stream, each load read one step ahead
//     into registers (dO rounded to bf16 as it arrives, which is what keeps
//     the batch below ptxas's limit) and stored under the next step's
//     products. Per query tile: P^T and dS^T from S^T and dP^T in
//     registers, then dV += bf16(P^T) . dO16 and dK += dS^T . Q_hi +
//     dS^T . Q_lo (Q and dO MN-major) in one batch with the next tile's S^T
//     (3 chains) and dP^T (2 chains).
//   - N <= 64 (one tile, the ViT's local views) is one kernel with one
//     warpgroup a head, the TPU kernel's one-step form: q, k, v, do and o
//     read in one round trip, S^T and dP^T once, dV and dK from registers,
//     dS^T stored once to shared memory for dQ = dS . K_hi + dS . K_lo
//     (both operands MN-major), no delta scratch.
//   - Ragged N: the last streamed tile runs its products at the narrowest
//     wgmma width that covers it (16, 32, 48 or 64). Keys past N get p = 0
//     by index (dq kernel, one-tile kernel), queries past N lse = +inf
//     (dk/dv kernel, one-tile kernel), so p = 0.
//   - Fixed-count loads and a warp-uniform warpgroup index, or ptxas
//     serializes the products.
#include "attention_bwd_hd128.cuh"
#include "attention_bwd_hd16.cuh"
#include "sm90.cuh"

namespace {

using namespace lt::sm90;

constexpr int kWg = 2;  // warpgroups a block of the ring kernels
constexpr int kThreads = kWg * 128;
constexpr int kPer = kRows * 16 / kThreads;  // float4 of a tile a thread
constexpr int kSlots = 3;  // ring: a step reads 2 slots while 1 is filled
constexpr int kKvSlotBytes = 4 * kTileBytes;  // dq ring: K hi, K lo, V hi, V lo
constexpr int kQdSlotBytes = 3 * kTileBytes;  // dk/dv ring: Q hi, Q lo, dO16
constexpr int kStatsBytes = kThreads * 4;  // lse log2 e, delta scale, unused

// One fp32 at p, or 0 without a read where !valid.
__device__ __forceinline__ float load1(const float* p, bool valid) {
  float x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "mov.f32 %0, 0f00000000;\n"
      "@p ld.global.nc.f32 %0, [%1];\n}\n"
      : "=f"(x)
      : "l"(p), "r"(static_cast<int>(valid)));
  return x;
}

// fetch, with each float4 rounded to four bf16 as it arrives: 8 registers
// for a tile's share in place of 16.
template <int kThreads>
__device__ __forceinline__ void fetch_rounded(uint2 (&x)[kRows * 16 / kThreads],
                                              const float* head,
                                              long row_stride, int row0,
                                              int N, int tid) {
  float4 y[kRows * 16 / kThreads];
  fetch<kThreads>(y, head, row_stride, row0, N, tid);
#pragma unroll
  for (int n = 0; n < kRows * 16 / kThreads; ++n)
    x[n] = make_uint2(lt::pack_bf16(y[n].x, y[n].y),
                      lt::pack_bf16(y[n].z, y[n].w));
}

// What fetch_rounded read, into the one bf16 plane of a swizzled tile.
template <int kThreads>
__device__ __forceinline__ void store_rounded(
    uint32_t tile, const uint2 (&x)[kRows * 16 / kThreads], int tid) {
#pragma unroll
  for (int n = 0; n < kRows * 16 / kThreads; ++n)
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(
                     swizzled(tile, tid + n * kThreads)),
                 "r"(x[n].x), "r"(x[n].y)
                 : "memory");
}

// do . o of the row whose four columns this thread holds (fetch's layout),
// summed over the 16 threads of the half warp that hold the row: each of
// them returns the row's delta.
__device__ __forceinline__ float row_delta(float4 o, float4 d) {
  float sum = o.x * d.x;
  sum = fmaf(o.y, d.y, sum);
  sum = fmaf(o.z, d.z, sum);
  sum = fmaf(o.w, d.w, sum);
#pragma unroll
  for (int m = 1; m < 16; m *= 2) sum += __shfl_xor_sync(0xffffffff, sum, m);
  return sum;
}

// dq kernel, one key tile (K and V planes at sK): S and dP of its NK keys
// are in s and dp; dS from them into the register A operand, then dQ +=
// dS . K_hi + dS . K_lo and the next tile's S and dP (width NKn, none if
// 0; planes at sKn) as two commit groups, with `overlap` (this thread's
// part of the block's next load) under the second once the first is done.
// c0/c1 are lse log2 e and d0/d1 delta *
// scale of this thread's rows g and g + 8; with kMask keys at or past N get
// p = 0 (only the last tile has any).
template <int NK, bool kMask, int NKn, typename F>
__device__ __forceinline__ void dq_step(float (&s)[32], float (&dp)[32],
                                        float (&acc)[32], uint32_t sQ,
                                        uint32_t sD, uint32_t sK,
                                        uint32_t sKn, int kv0, int N,
                                        float scale2, float scale, int t,
                                        float c0, float c1, float d0,
                                        float d1, F&& overlap) {
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
    a[j / 2][2 * (j % 2)] = lt::pack_bf16(ds[0], ds[1]);      // row g
    a[j / 2][2 * (j % 2) + 1] = lt::pack_bf16(ds[2], ds[3]);  // row g + 8
  }
  wgmma_fence();
  issue_pv<NK>(acc, a, sK);
  issue_pv<NK>(acc, a, sK + kTileBytes);
  wgmma_commit();
  if constexpr (NKn > 0) {
    issue_scores_split<NKn>(s, sQ, sKn);
    issue_scores<NKn>(dp, sD, sKn + 2 * kTileBytes);
    issue_scores<NKn>(dp, sD, sKn + 3 * kTileBytes, false);
  }
  wgmma_commit();
  wgmma_wait<1>();
  fence_registers(acc);
  overlap();
  wgmma_wait<0>();
  fence_registers(s);
  fence_registers(dp);
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_f32_dq_sm90_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ o,
        const float* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ dq, float* __restrict__ delta, int N,
        lt::Strides qs, lt::Strides ks, lt::Strides vs, lt::Strides os,
        lt::Strides dos, lt::Strides dqs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = lt::smem_addr(smem_raw);
  // Swizzled tiles start on 1024-byte boundaries of the shared window.
  const uint32_t base = (raw + 1023) & ~1023u;
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  // Per warpgroup: Q hi, Q lo, dO16; then the ring; then the delta of the
  // block's 128 rows.
  const uint32_t sQ = base + wg * 3 * kTileBytes, sD = sQ + 2 * kTileBytes;
  const uint32_t ring = base + kWg * 3 * kTileBytes;
  float* block_delta = reinterpret_cast<float*>(
      smem_raw + (ring + kSlots * kKvSlotBytes - raw));
  const int q0 = (blockIdx.x * kWg + wg) * kRows;
  const bool active = q0 < N;  // uniform over the warpgroup
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  const float* oh = o + b * os.b + h * os.h;
  const float* doh = dout + b * dos.b + h * dos.h;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width

  // Load i: K and V tile i into slot i % kSlots.
  float4 xk[kPer], xv[kPer];
  auto slot = [&](int i) { return ring + (i % kSlots) * kKvSlotBytes; };
  auto fetch_load = [&](int i) {
    fetch<kThreads>(xk, kh, ks.n, i * kRows, N, tid);
    fetch<kThreads>(xv, vh, vs.n, i * kRows, N, tid);
  };
  auto store_load = [&](int i) {
    store_planes<kThreads>(slot(i), xk, tid);
    store_planes<kThreads>(slot(i) + 2 * kTileBytes, xv, tid);
  };

  // lse log2 e of this thread's rows g and g + 8.
  const int r0 = q0 + warp * 16 + g;
  const float c0 = lse[bh * N + min(r0, N - 1)] * kLog2e;
  const float c1 = lse[bh * N + min(r0 + 8, N - 1)] * kLog2e;
  {  // The block's Q and dO tiles, the delta of their rows, and load 0.
    float4 xq[kWg][kPer], xd[kWg][kPer], xo[kWg][kPer];
#pragma unroll
    for (int w = 0; w < kWg; ++w) {
      const int row0 = (blockIdx.x * kWg + w) * kRows;
      fetch<kThreads>(xq[w], qh, qs.n, row0, N, tid);
      fetch<kThreads>(xd[w], doh, dos.n, row0, N, tid);
      fetch<kThreads>(xo[w], oh, os.n, row0, N, tid);
    }
    fetch_load(0);
#pragma unroll
    for (int w = 0; w < kWg; ++w) {
      const int row0 = (blockIdx.x * kWg + w) * kRows;
      const uint32_t tile = base + w * 3 * kTileBytes;
      store_planes<kThreads>(tile, xq[w], tid);
      store_planes<kThreads, 1>(tile + 2 * kTileBytes, xd[w], tid);
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const float sum = row_delta(xo[w][n], xd[w][n]);
        const int r = (tid + n * kThreads) / 16;
        if ((tid & 15) == 0) {
          block_delta[w * kRows + r] = sum;
          if (row0 + r < N) delta[bh * N + row0 + r] = sum;
        }
      }
    }
    store_load(0);
  }
  fetch_load(1);
  store_load(1);
  fence_async_shared();
  __syncthreads();
  const float d0 = block_delta[wg * kRows + warp * 16 + g] * scale;
  const float d1 = block_delta[wg * kRows + warp * 16 + g + 8] * scale;

  // Step j reads loads j and j + 1, which have landed, and under its
  // products reads and stores load j + 2 into the slot of load j - 1, which
  // the barrier that ended step j - 1 freed.
  int step = 0;
  auto overlap = [&] {
    if (step + 2 < nt) {
      fetch_load(step + 2);
      store_load(step + 2);
    }
  };
  auto settle = [&] {
    if (step + 2 < nt) {
      fence_async_shared();
      __syncthreads();
    }
    ++step;
  };

  float acc[32], s[32], dp[32];
  zero(acc);
  const float scale2 = scale * kLog2e;
  if (active) {  // S and dP of key tile 0 (N > 64: a whole tile)
    wgmma_fence();
    issue_scores_split<kRows>(s, sQ, slot(0));
    issue_scores<kRows>(dp, sD, slot(0) + 2 * kTileBytes);
    issue_scores<kRows>(dp, sD, slot(0) + 3 * kTileBytes, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(s);
    fence_registers(dp);
  }
  for (int j = 0; j < nt; ++j) {
    const uint32_t sK = slot(j), sKn = slot(j + 1);
    const int kv0 = j * kRows;
    if (!active) {
      overlap();
    } else if (j < nt - 2) {
      dq_step<64, false, 64>(s, dp, acc, sQ, sD, sK, sKn, kv0, N, scale2,
                             scale, t, c0, c1, d0, d1, overlap);
    } else if (j == nt - 2) {
#define LT_STEP(W)                                                          \
  dq_step<64, false, W>(s, dp, acc, sQ, sD, sK, sKn, kv0, N, scale2, scale, \
                        t, c0, c1, d0, d1, overlap)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    } else {
#define LT_STEP(W)                                                        \
  dq_step<W, true, 0>(s, dp, acc, sQ, sD, sK, 0, kv0, N, scale2, scale, t, \
                      c0, c1, d0, d1, overlap)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    }
    settle();
  }
  if (!active) return;
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, acc, r0, N, t);
}

// dk/dv kernel, one query tile (Q planes and dO16 at sQ): S^T and dP^T of
// this tile (width NK) are in s and dp, lse log2 e and delta * scale of its
// queries in st (floats 0 and 64; lse +inf past N, so p = 0 there); P^T
// and dS^T from them into register A operands, then dV += P^T . dO16,
// dK += dS^T . Q_hi + dS^T . Q_lo and the next tile's S^T and dP^T (width
// NKn, none if 0; at sQn) in one batch, with `overlap` (this thread's part
// of the block's loads) under them.
template <int NK, int NKn, typename F>
__device__ __forceinline__ void dkdv_step(float (&s)[32], float (&dp)[32],
                                          float (&dk)[32], float (&dv)[32],
                                          uint32_t sK, uint32_t sV,
                                          uint32_t sQ, uint32_t sQn,
                                          const float* st, float scale2,
                                          float scale, int t, F&& overlap) {
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 c = *reinterpret_cast<const float2*>(st + col);
    const float2 d = *reinterpret_cast<const float2*>(st + kRows + col);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(fmaf(s[4 * j + e], scale2, e & 1 ? -c.y : -c.x));
      ds[e] = p[e] * fmaf(dp[4 * j + e], scale, e & 1 ? -d.y : -d.x);
    }
    pa[j / 2][2 * (j % 2)] = lt::pack_bf16(p[0], p[1]);      // key row g
    pa[j / 2][2 * (j % 2) + 1] = lt::pack_bf16(p[2], p[3]);  // g + 8
    da[j / 2][2 * (j % 2)] = lt::pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = lt::pack_bf16(ds[2], ds[3]);
  }
  wgmma_fence();
  issue_pv<NK>(dv, pa, sQ + 2 * kTileBytes);
  issue_pv<NK>(dk, da, sQ);
  issue_pv<NK>(dk, da, sQ + kTileBytes);
  if constexpr (NKn > 0) {
    issue_scores_split<NKn>(s, sK, sQn);
    issue_scores<NKn>(dp, sV, sQn + 2 * kTileBytes);
    issue_scores<NKn>(dp, sV + kTileBytes, sQn + 2 * kTileBytes, false);
  }
  wgmma_commit();
  overlap();
  wgmma_wait<0>();
  fence_registers(dk);
  fence_registers(dv);
  fence_registers(s);
  fence_registers(dp);
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_f32_dkdv_sm90_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int N,
        lt::Strides qs, lt::Strides ks, lt::Strides vs, lt::Strides dos,
        lt::Strides dks, lt::Strides dvs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = lt::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  // Per warpgroup: K hi, K lo, V hi, V lo; then the ring of Q hi, Q lo,
  // dO16; then its stats slots.
  const uint32_t sK = base + wg * 4 * kTileBytes, sV = sK + 2 * kTileBytes;
  const uint32_t ring = base + kWg * 4 * kTileBytes;
  const uint32_t stats = ring + kSlots * kQdSlotBytes;
  const int k0 = (blockIdx.x * kWg + wg) * kRows;
  const bool active = k0 < N;
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  const float* doh = dout + b * dos.b + h * dos.h;
  const float* lse_h = lse + bh * N;
  const float* delta_h = delta + bh * N;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;

  // Load i: Q and dO tile i (dO rounded to bf16 as it arrives), and lse
  // (threads 0-63) and delta (64-127) of its queries.
  float4 xq[kPer];
  uint2 xd[kPer];
  float xs;
  auto slot = [&](int i) { return ring + (i % kSlots) * kQdSlotBytes; };
  auto stats_slot = [&](int i) { return stats + (i % kSlots) * kStatsBytes; };
  auto fetch_load = [&](int i) {
    fetch<kThreads>(xq, qh, qs.n, i * kRows, N, tid);
    fetch_rounded<kThreads>(xd, doh, dos.n, i * kRows, N, tid);
    const int r = i * kRows + (tid & (kRows - 1));
    const bool valid = tid < 2 * kRows && r < N;
    xs = load1((tid < kRows ? lse_h : delta_h) + (valid ? r : 0), valid);
  };
  auto store_load = [&](int i) {
    store_planes<kThreads>(slot(i), xq, tid);
    store_rounded<kThreads>(slot(i) + 2 * kTileBytes, xd, tid);
    // lse log2 e (+inf past N) and delta * scale; threads past 128 write
    // zeros no step reads.
    const bool past = i * kRows + (tid & (kRows - 1)) >= N;
    const float st = tid < kRows ? (past ? INFINITY : xs * kLog2e)
                                 : xs * scale;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(stats_slot(i) + 4 * tid),
                 "f"(st)
                 : "memory");
  };

  {  // The block's K and V tiles, and load 0.
    float4 xk[kWg][kPer], xv[kWg][kPer];
#pragma unroll
    for (int w = 0; w < kWg; ++w) {
      const int row0 = (blockIdx.x * kWg + w) * kRows;
      fetch<kThreads>(xk[w], kh, ks.n, row0, N, tid);
      fetch<kThreads>(xv[w], vh, vs.n, row0, N, tid);
    }
    fetch_load(0);
#pragma unroll
    for (int w = 0; w < kWg; ++w) {
      const uint32_t tile = base + w * 4 * kTileBytes;
      store_planes<kThreads>(tile, xk[w], tid);
      store_planes<kThreads>(tile + 2 * kTileBytes, xv[w], tid);
    }
    store_load(0);
  }
  fetch_load(1);
  store_load(1);
  if (nt > 2) fetch_load(2);
  fence_async_shared();
  __syncthreads();

  // Step j reads loads j and j + 1, which have landed; under its products
  // it stores load j + 2, read during the step before, and reads load
  // j + 3. A slot is refilled three loads after it was filled, after the
  // barrier that ends the last step that read it.
  int step = 0;
  auto overlap = [&] {
    if (step + 2 < nt) {
      store_load(step + 2);
      if (step + 3 < nt) fetch_load(step + 3);
    }
  };
  auto settle = [&] {
    if (step + 2 < nt) {
      fence_async_shared();
      __syncthreads();
    }
    ++step;
  };

  float dka[32], dva[32], s[32], dp[32];
  zero(dka);
  zero(dva);
  const float scale2 = scale * kLog2e;
  if (active) {  // S^T and dP^T of query tile 0 (N > 64: a whole tile)
    wgmma_fence();
    issue_scores_split<kRows>(s, sK, slot(0));
    issue_scores<kRows>(dp, sV, slot(0) + 2 * kTileBytes);
    issue_scores<kRows>(dp, sV + kTileBytes, slot(0) + 2 * kTileBytes, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(s);
    fence_registers(dp);
  }
  for (int j = 0; j < nt; ++j) {
    const uint32_t sQ = slot(j), sQn = slot(j + 1);
    const float* st =
        reinterpret_cast<const float*>(smem_raw + (stats_slot(j) - raw));
    if (!active) {
      overlap();
    } else if (j < nt - 2) {
      dkdv_step<64, 64>(s, dp, dka, dva, sK, sV, sQ, sQn, st, scale2, scale,
                        t, overlap);
    } else if (j == nt - 2) {
#define LT_STEP(W)                                                        \
  dkdv_step<64, W>(s, dp, dka, dva, sK, sV, sQ, sQn, st, scale2, scale, t, \
                   overlap)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    } else {
#define LT_STEP(W)                                                            \
  dkdv_step<W, 0>(s, dp, dka, dva, sK, sV, sQ, 0, st, scale2, scale, t,      \
                  overlap)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    }
    settle();
  }
  if (!active) return;
  const int r0 = k0 + warp * 16 + g;
  store_rows(dk + b * dks.b + h * dks.h, dks.n, dka, r0, N, t);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.n, dva, r0, N, t);
}

// N <= 64, the whole head in one tile of W = 16 * ceil(N / 16) rows:
// S^T = K . Q^T (3 chains) and dP^T = V . dO16^T (2 chains), then dV =
// P^T . dO16 and dK = dS^T . Q_hi + dS^T . Q_lo from registers, and dQ =
// dS . K_hi + dS . K_lo with dS^T stored to the swizzled tile sS (rows are
// keys, the depth of the product; both operands MN-major). st holds lse
// log2 e (+inf past N) and delta * scale by query; keys past N (rows g,
// g + 8 of this thread: ok0, ok1) get p = 0.
template <int W>
__device__ __forceinline__ void one_tile(float (&s)[32], float (&dp)[32],
                                         float (&dq)[32], float (&dk)[32],
                                         float (&dv)[32], uint32_t sQ,
                                         uint32_t sD, uint32_t sK,
                                         uint32_t sV, uint32_t sS,
                                         const float* st, bool ok0, bool ok1,
                                         int key0, float scale2, float scale,
                                         int g, int t) {
  wgmma_fence();
  issue_scores_split<W>(s, sK, sQ);
  issue_scores<W>(dp, sV, sD);
  issue_scores<W>(dp, sV + kTileBytes, sD, false);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  fence_registers(dp);
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 c = *reinterpret_cast<const float2*>(st + col);
    const float2 d = *reinterpret_cast<const float2*>(st + kRows + col);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2_ftz(fmaf(s[4 * j + e], scale2, e & 1 ? -c.y : -c.x));
      p[e] = (e < 2 ? ok0 : ok1) ? x : 0.f;
      ds[e] = p[e] * fmaf(dp[4 * j + e], scale, e & 1 ? -d.y : -d.x);
    }
    pa[j / 2][2 * (j % 2)] = lt::pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = lt::pack_bf16(p[2], p[3]);
    const uint32_t r0 = lt::pack_bf16(ds[0], ds[1]);
    const uint32_t r1 = lt::pack_bf16(ds[2], ds[3]);
    da[j / 2][2 * (j % 2)] = r0;
    da[j / 2][2 * (j % 2) + 1] = r1;
    // Columns 8 j + 2 t, + 1 of key rows key0 and key0 + 8 (both g mod 8):
    // 16-byte chunk j ^ g of the row, bytes 4 t.
    const uint32_t at = sS + key0 * kRowBytes + ((j ^ g) << 4) + 4 * t;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(r0) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * kRowBytes),
                 "r"(r1)
                 : "memory");
  }
  // Every register the products read is defined before the fence.
  fence_registers(dv);
  fence_registers(dk);
  fence_fragments(pa);
  fence_fragments(da);
  wgmma_fence();
  issue_pv<W>(dv, pa, sD);
  issue_pv<W>(dk, da, sQ);
  issue_pv<W>(dk, da, sQ + kTileBytes);
  wgmma_commit();
  fence_async_shared();
  __syncthreads();  // every warp's part of dS^T is in sS
  fence_registers(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_ss_tt(dq, mn_major(sS, kk), mn_major(sK, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_ss_tt(dq, mn_major(sS, kk), mn_major(sK + kTileBytes, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dq);
  fence_registers(dk);
  fence_registers(dv);
}

__global__ void __launch_bounds__(128, 1)
    attention_bwd_f32_one_tile_sm90_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ o,
        const float* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ dq, float* __restrict__ dk,
        float* __restrict__ dv, int N, lt::Strides qs, lt::Strides ks,
        lt::Strides vs, lt::Strides os, lt::Strides dos, lt::Strides dqs,
        lt::Strides dks, lt::Strides dvs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kPer1 = kRows * 16 / 128;  // float4 of a tile a thread
  const uint32_t raw = lt::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // Q hi, Q lo, dO16, K hi, K lo, V hi, V lo, dS^T, then the stats.
  const uint32_t sQ = base, sD = sQ + 2 * kTileBytes, sK = sD + kTileBytes;
  const uint32_t sV = sK + 2 * kTileBytes, sS = sV + 2 * kTileBytes;
  float* st = reinterpret_cast<float*>(smem_raw + (sS + kTileBytes - raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  // lse log2 e by query (+inf past N), one thread a row.
  const float lse_row =
      tid < kRows && tid < N ? lse[bh * N + tid] * kLog2e : INFINITY;
  {
    float4 x0[kPer1], x1[kPer1], x2[kPer1], x3[kPer1], x4[kPer1];
    fetch<128>(x0, q + b * qs.b + h * qs.h, qs.n, 0, N, tid);
    fetch<128>(x1, k + b * ks.b + h * ks.h, ks.n, 0, N, tid);
    fetch<128>(x2, v + b * vs.b + h * vs.h, vs.n, 0, N, tid);
    fetch<128>(x3, dout + b * dos.b + h * dos.h, dos.n, 0, N, tid);
    fetch<128>(x4, o + b * os.b + h * os.h, os.n, 0, N, tid);
    store_planes<128>(sQ, x0, tid);
    store_planes<128>(sK, x1, tid);
    store_planes<128>(sV, x2, tid);
    store_planes<128, 1>(sD, x3, tid);
    // delta * scale by query (0 past N, where o and do read as zeros).
#pragma unroll
    for (int n = 0; n < kPer1; ++n) {
      const float sum = row_delta(x4[n], x3[n]);
      if ((tid & 15) == 0) st[kRows + (tid + n * 128) / 16] = sum * scale;
    }
  }
  if (tid < kRows) st[tid] = lse_row;
  fence_async_shared();
  __syncthreads();

  const int key0 = warp * 16 + g;
  float s[32], dp[32], dqa[32], dka[32], dva[32];
  zero(dqa);
  zero(dka);
  zero(dva);
  const float scale2 = scale * kLog2e;
#define LT_ONE(W)                                                        \
  one_tile<W>(s, dp, dqa, dka, dva, sQ, sD, sK, sV, sS, st, key0 < N,    \
              key0 + 8 < N, key0, scale2, scale, g, t)
  LT_BY_TAIL((N + 15) / 16, LT_ONE);
#undef LT_ONE
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, dqa, key0, N, t);
  store_rows(dk + b * dks.b + h * dks.h, dks.n, dka, key0, N, t);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.n, dva, key0, N, t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// strides: (batch, token, head) for q, k, v, o, do, dq, dk, dv. fp32
// (fp32 = 1) at hd = 64, 16 or 128 (N <= 768). At hd 64 and N > 64 the dq kernel
// writes delta (B, H, N) fp32 for the dk/dv kernel, at hd 128 the dq role
// for the dk role; hd 16 does not use it.
extern "C" int lt_attention_bwd_f32_sm90(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv,
                                         void* delta, int fp32, int B, int N,
                                         int H, int hd, const long* strides,
                                         float scale, void* stream) {
  if (!fp32 || N < 1) return cudaErrorInvalidValue;
  if (hd == 16)
    return lt::sm90::hd16::launch_bwd<float>(q, k, v, o, dout, lse, dq, dk,
                                             dv, B, N, H, strides, scale,
                                             stream);
  if (hd == 128)
    return lt::sm90::hd128::launch_bwd<float>(q, k, v, o, dout, lse, dq, dk,
                                              dv, delta, B, N, H, strides,
                                              scale, stream);
  if (hd != 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* o_ = static_cast<const float*>(o);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float *dq_ = static_cast<float*>(dq), *dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  float* delta_ = static_cast<float*>(delta);
  const lt::Strides qs = lt::strides_of(strides, 0),
                    ks = lt::strides_of(strides, 1),
                    vs = lt::strides_of(strides, 2),
                    os = lt::strides_of(strides, 3),
                    dos = lt::strides_of(strides, 4),
                    dqs = lt::strides_of(strides, 5),
                    dks = lt::strides_of(strides, 6),
                    dvs = lt::strides_of(strides, 7);
  cudaError_t err;
  if (N <= kRows) {
    const size_t smem = 1024 + 8 * kTileBytes + 2 * kRows * sizeof(float);
    err = allow_smem(attention_bwd_f32_one_tile_sm90_kernel, smem);
    if (err != cudaSuccess) return err;
    attention_bwd_f32_one_tile_sm90_kernel<<<dim3(1, H, B), 128, smem, s>>>(
        q_, k_, v_, o_, do_, lse_, dq_, dk_, dv_, N, qs, ks, vs, os, dos, dqs,
        dks, dvs, scale);
    return cudaGetLastError();
  }
  const dim3 grid((N + kWg * kRows - 1) / (kWg * kRows), H, B);
  const size_t smem_dq = 1024 + kWg * 3 * kTileBytes + kSlots * kKvSlotBytes +
                         kWg * kRows * sizeof(float);
  err = allow_smem(attention_bwd_f32_dq_sm90_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  attention_bwd_f32_dq_sm90_kernel<<<grid, kThreads, smem_dq, s>>>(
      q_, k_, v_, o_, do_, lse_, dq_, delta_, N, qs, ks, vs, os, dos, dqs,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv = 1024 + kWg * 4 * kTileBytes +
                         kSlots * (kQdSlotBytes + kStatsBytes);
  err = allow_smem(attention_bwd_f32_dkdv_sm90_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  attention_bwd_f32_dkdv_sm90_kernel<<<grid, kThreads, smem_kv, s>>>(
      q_, k_, v_, do_, lse_, delta_, dk_, dv_, N, qs, ks, vs, dos, dks, dvs,
      scale);
  return cudaGetLastError();
}
