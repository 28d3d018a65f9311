// Multi-head self-attention, backward, bf16: K2 (flat layout) and K5
// (per-head layout) on Hopper's warpgroup tensor-core products, at head dim
// 64 (this file's kernels), 16 (attention_bwd_hd16.cuh's, in bf16) and 128
// (attention_bwd_hd128_tma.cuh's two persistent TMA-fed kernels).
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_bwd_kernel (K2)
// and ::_bwd_kernel (K5) for bf16 q/k/v; fp32 is
// flat_attention_bwd_f32_sm90.cu. Each tensor is read or written in place
// through
// three strides (batch, token, head; the column stride is 1): the flat
// layout, views of a fused qkv output, (B, N, H, hd) and (B, H, N, hd). lse
// is the forward's (B, H, N) fp32 log-sum-exp; delta is a (B, H, N) fp32
// scratch that the dq kernel writes for the dk/dv kernel.
//
// Numerics are the TPU kernel's:
//   p  = exp(s - lse)                  (fp32, s = (q . k) * scale)
//   dv = bf16(p)^T . do                dp = do . v^T
//   delta = rowsum(do * o)             (fp32, from the unrounded inputs)
//   ds = bf16(p * (dp - delta) * scale)   (the fp32 p, not bf16(p))
//   dq = ds . k                        dk = ds^T . q
// with fp32 accumulation in every product. exp is 2^(s * scale log2 e -
// lse log2 e): ex2.approx.ftz with log2 e folded into the one FFMA that
// forms the exponent, subnormal results flushed to 0. ds is taken as
// p * (dp * scale - delta * scale), one FFMA and one FMUL: for a scale that
// is a power of two (hd 64's 1/8) that is p * (dp - delta) * scale to the
// bit, for another scale one fp32 rounding apart. The fp32 sums are taken
// in another order than the JAX kernel's: each product sums over 16
// columns a wgmma step and then across steps; delta is two 32-column halves
// of a row, each summed left to right, then added.
//
// What bounds it on an H100: at the ViT-B/14 global shape (B=64, N=257,
// H=12) in bf16 202 MB move (q, k, v, o, do in; dq, dk, dv out), ~60 us at
// 3.35 TB/s, against 32.5 GFLOP of necessary products (~33 us at the bf16
// tensor peak); at N = 730 the products bound it (65.5 GFLOP at B = 16,
// ~66 us). The design recomputes s and dp in both kernels (7 products of
// 64 x 64 x 64 a pair of tiles instead of 5) so that no block adds into
// another's output and the result is deterministic:
//   - dq kernel: grid (query tiles / 2, H, B), two warpgroups (4 warps
//     each) a block, each owning 64 query rows with Q and dO resident in
//     shared memory as K-major A operands. K and V stream through a ring of
//     kSlots slots (one K and one V tile a slot), filled with cp.async.cg
//     16-byte copies written in the 128-byte swizzle (sm90.cuh), kAhead
//     loads ahead, one block barrier a tile. Per half tile of 32 keys:
//     S = Q . K^T and dP = dO . V^T (wgmma, both from shared memory), dS in
//     registers, then dQ += dS . K (dS the register A operand, K the same
//     tile read MN-major) in one batch with the next half's S and dP. Half
//     tiles keep 64 accumulators live instead of 96: 106 registers, so two
//     blocks share an SM and one's products run under the other's
//     arithmetic. delta (and lse) of the warpgroup's rows are read once;
//     the kernel writes delta.
//   - dk/dv kernel: the same grid over key tiles, K and V resident as A
//     operands; Q, dO, lse and delta stream through the ring. Per query
//     tile: S^T = K . Q^T and dP^T = V . dO^T, P^T (fp32) and dS^T with lse
//     and delta read by column, then dV += bf16(P^T) . dO and dK += dS^T . Q
//     (Q and dO read MN-major) in one batch with the next S^T and dP^T.
//     Four 64 x 64 fp32 accumulators: 128 registers a thread (202 in all,
//     one block an SM; on half tiles it measured slower).
//   - N <= 64 (one tile, the ViT's local views) is one kernel with one
//     warpgroup a head, the TPU kernel's one-step form: S^T and dP^T once,
//     dV and dK from registers, dS^T stored once to shared memory for
//     dQ = dS . K (both operands MN-major), no delta scratch.
//   - Ragged N: rows at or past N are zero-filled by the copies; the last
//     streamed tile (or half tile) runs its products at the narrowest wgmma
//     width that covers it (16, 32, 48 or 64) and its register products
//     take only the 16-row steps that hold real rows. Keys past N get p = 0
//     by index in the dq kernel's last half, queries past N get lse = +inf
//     (p = 0) in the dk/dv kernel's last tile.
//   - As in the forward: fixed-count copy loops and a warp-uniform
//     warpgroup index, or ptxas serializes the products.
#include "attention_bwd_hd128_tma.cuh"
#include "attention_bwd_hd16.cuh"
#include "sm90.cuh"

namespace {

using lt::bf16;
using namespace lt::sm90;

constexpr int kAhead = 4;           // tile loads in flight ahead of a step
constexpr int kSlots = kAhead + 1;  // ring slots, each two 64-row tiles
constexpr int kWg = 2;              // warpgroups a block of the ring kernels
constexpr int kThreads = kWg * 128;

// lse and delta of query rows [row0, row0 + 64) into a stats slot (lse at
// float 0, delta at float 64), one 4-byte copy per thread of the block;
// threads past the first 128 and rows at or past N zero-fill without a
// read.
__device__ __forceinline__ void load_stats(uint32_t dst, const float* lse_h,
                                           const float* delta_h, int row0,
                                           int N, int tid) {
  const int r = tid & (kRows - 1);
  const bool valid = tid < 2 * kRows && row0 + r < N;
  const float* src = (tid < kRows ? lse_h : delta_h) + (valid ? row0 + r : 0);
  cp_async4(dst + 4 * tid, src, valid);
}

// do . o over 32 columns of one row, in fp32.
__device__ __forceinline__ float half_row_delta(const bf16* o_row,
                                                const bf16* do_row) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o_row + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(do_row + c);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(op[e]);
      const float2 d = __bfloat1622float2(dp[e]);
      sum += a.x * d.x;
      sum += a.y * d.y;
    }
  }
  return sum;
}

// dq kernel, one half tile of 32 keys (rows half * 32 of the K and V tiles
// at sK and sK + kTileBytes): S and dP of its NK keys are in s and dp; dS
// from them into the register A operand, then dQ += dS . K and the next
// half's S and dP (width NKn, none if 0; tiles at sKn) in one batch. c0/c1
// are lse log2 e and d0/d1 delta * scale of this thread's rows g and g + 8;
// with kMask keys at or past N get p = 0 (only the last half has any).
template <int NK, bool kMask, int NKn>
__device__ __forceinline__ void dq_step(float (&s)[16], float (&dp)[16],
                                        float (&acc)[32], uint32_t sQ,
                                        uint32_t sD, uint32_t sK, int half,
                                        uint32_t sKn, int half_n, int kv0,
                                        int N, float scale2, float scale,
                                        int t, float c0, float c1, float d0,
                                        float d1) {
  uint32_t a[2][4];
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
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs_tb(acc, a[kk], mn_major(sK, 2 * half + kk));
  if constexpr (NKn > 0) {
    const uint32_t rows = half_n * 32 * kRowBytes;
    issue_scores<NKn>(s, sQ, sKn + rows);
    issue_scores<NKn>(dp, sD, sKn + kTileBytes + rows);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(acc);
  fence_registers(s);
  fence_registers(dp);
}

__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dq_sm90_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ o,
        const bf16* __restrict__ dout, const float* __restrict__ lse,
        bf16* __restrict__ dq, float* __restrict__ delta, int N,
        lt::Strides qs, lt::Strides ks, lt::Strides vs, lt::Strides os,
        lt::Strides dos, lt::Strides dqs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries of the shared window.
  const uint32_t base = (lt::smem_addr(smem_raw) + 1023) & ~1023u;
  // The warpgroup's index through a shuffle, so that the compiler sees it
  // (and every branch on it around the products) as warp-uniform.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  const uint32_t sQ = base + wg * 2 * kTileBytes, sD = sQ + kTileBytes;
  const uint32_t ring = base + kWg * 2 * kTileBytes;  // slot: K, V tiles
  const int q0 = (blockIdx.x * kWg + wg) * kRows;
  const bool active = q0 < N;  // uniform over the warpgroup
  const bf16* qh = q + b * qs.b + h * qs.h;
  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;
  const bf16* oh = o + b * os.b + h * os.h;
  const bf16* doh = dout + b * dos.b + h * dos.h;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;  // last tile's width

  // The block's Q and dO tiles, with the first K/V load.
  for (int w = 0; w < kWg; ++w) {
    const int row0 = (blockIdx.x * kWg + w) * kRows;
    const uint32_t tile = base + w * 2 * kTileBytes;
    load_tile<kThreads>(tile, qh, qs.n, row0, N, tid);
    load_tile<kThreads>(tile + kTileBytes, doh, dos.n, row0, N, tid);
  }
  // Load i of the ring: K and V tile i, one commit group per load, empty
  // past the end. A step also reads load i + 1 (the next S and dP), so
  // loads i and i + 1 have landed before step i.
  auto slot = [&](int i) { return ring + (i % kSlots) * 2 * kTileBytes; };
  auto issue = [&](int i) {
    if (i < nt) {
      load_tile<kThreads>(slot(i), kh, ks.n, i * kRows, N, tid);
      load_tile<kThreads>(slot(i) + kTileBytes, vh, vs.n, i * kRows, N, tid);
    }
    cp_async_commit();
  };
  auto arrive = [&](int i) {
    cp_async_wait<kAhead - 2>();
    fence_async_shared();
    // Every thread's copies are visible, and every warpgroup is done with
    // load i - 1, whose slot load i + kAhead refills.
    __syncthreads();
    issue(i + kAhead);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue(i);

  // delta of the warpgroup's rows (two threads a row, while the copies
  // fly), written for the dk/dv kernel; lse and delta of this thread's rows
  // g and g + 8.
  float c0 = 0.f, c1 = 0.f, d0 = 0.f, d1 = 0.f;
  if (active) {
    const int r = q0 + warp * 16 + (lane >> 1), rc = min(r, N - 1);
    const int half = (lane & 1) * 32;
    float dsum =
        half_row_delta(oh + rc * os.n + half, doh + rc * dos.n + half);
    dsum += __shfl_xor_sync(0xffffffff, dsum, 1);
    dsum = r < N ? dsum : 0.f;
    if (r < N && (lane & 1) == 0) delta[bh * N + r] = dsum;
    d0 = __shfl_sync(0xffffffff, dsum, 2 * g) * scale;
    d1 = __shfl_sync(0xffffffff, dsum, 2 * g + 16) * scale;
    const int r0 = q0 + warp * 16 + g;
    c0 = lse[bh * N + min(r0, N - 1)] * kLog2e;
    c1 = lse[bh * N + min(r0 + 8, N - 1)] * kLog2e;
  }

  float acc[32], s[16], dp[16];
  zero(acc);
  const float scale2 = scale * kLog2e;
  // Half u = 2 j + part of the keys: rows 32 part of ring load j. The last
  // tile's W keys are one half (W <= 32) or two.
  const int n_half = 2 * (nt - 1) + (tail16 > 2 ? 2 : 1);
  const int tail_half = tail16 > 2 ? tail16 - 2 : tail16;  // its 16-key steps
  for (int j = 0; j < nt; ++j) {
    arrive(j);
    if (!active) continue;
    const uint32_t sK = slot(j);
    if (j == 0) {
      wgmma_fence();
      issue_scores<32>(s, sQ, sK);
      issue_scores<32>(dp, sD, sK + kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(s);
      fence_registers(dp);
    }
    for (int part = 0; part < 2; ++part) {
      const int u = 2 * j + part;
      if (u >= n_half) break;
      const uint32_t sKn = part ? slot(j + 1) : sK;
      const int kv0 = u * 32;
#define LT_STEP(NK, kMask, NKn)                                           \
  dq_step<NK, kMask, NKn>(s, dp, acc, sQ, sD, sK, part, sKn, 1 - part, kv0, \
                          N, scale2, scale, t, c0, c1, d0, d1)
      if (u == n_half - 2 && tail_half == 1)
        LT_STEP(32, false, 16);
      else if (u < n_half - 1)
        LT_STEP(32, false, 32);
      else if (tail_half == 1)
        LT_STEP(16, true, 0);
      else
        LT_STEP(32, true, 0);
#undef LT_STEP
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, acc, q0 + warp * 16 + g, N,
             t);
}

// dk/dv kernel, one query tile: S^T and dP^T of this tile (width NK) are in
// s and dp, lse and delta of its queries in st (floats 0 and 64); P^T and
// dS^T from them into register A operands, then dV += P^T . dO and
// dK += dS^T . Q and the next tile's S^T and dP^T (width NKn, none if 0)
// in one batch. With kMask queries at or past N get lse = +inf, p = 0
// (only the last tile has any).
template <int NK, bool kMask, int NKn>
__device__ __forceinline__ void dkdv_step(float (&s)[32], float (&dp)[32],
                                          float (&dk)[32], float (&dv)[32],
                                          uint32_t sK, uint32_t sV,
                                          uint32_t sQ, uint32_t sQn,
                                          const float* st, int q0, int N,
                                          float scale2, float scale, int t) {
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(st + col);
    const float2 dl = *reinterpret_cast<const float2*>(st + kRows + col);
    const float c[2] = {!kMask || q0 + col < N ? l.x * kLog2e : INFINITY,
                        !kMask || q0 + col + 1 < N ? l.y * kLog2e : INFINITY};
    const float d[2] = {dl.x * scale, dl.y * scale};
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(fmaf(s[4 * j + e], scale2, -c[e & 1]));
      ds[e] = p[e] * fmaf(dp[4 * j + e], scale, -d[e & 1]);
    }
    pa[j / 2][2 * (j % 2)] = lt::pack_bf16(p[0], p[1]);       // key row g
    pa[j / 2][2 * (j % 2) + 1] = lt::pack_bf16(p[2], p[3]);   // g + 8
    da[j / 2][2 * (j % 2)] = lt::pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = lt::pack_bf16(ds[2], ds[3]);
  }
  wgmma_fence();
  issue_pv<NK>(dv, pa, sQ + kTileBytes);
  issue_pv<NK>(dk, da, sQ);
  if constexpr (NKn > 0) {
    issue_scores<NKn>(s, sK, sQn);
    issue_scores<NKn>(dp, sV, sQn + kTileBytes);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dk);
  fence_registers(dv);
  fence_registers(s);
  fence_registers(dp);
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkdv_sm90_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int N, lt::Strides qs,
        lt::Strides ks, lt::Strides vs, lt::Strides dos, lt::Strides dks,
        lt::Strides dvs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = lt::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  constexpr int kStatsBytes = kThreads * 4;
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  const uint32_t sK = base + wg * 2 * kTileBytes, sV = sK + kTileBytes;
  const uint32_t ring = base + kWg * 2 * kTileBytes;  // slot: Q, dO tiles
  const uint32_t stats = ring + kSlots * 2 * kTileBytes;  // slot: lse, delta
  const int k0 = (blockIdx.x * kWg + wg) * kRows;
  const bool active = k0 < N;
  const bf16* qh = q + b * qs.b + h * qs.h;
  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;
  const bf16* doh = dout + b * dos.b + h * dos.h;
  const float* lse_h = lse + bh * N;
  const float* delta_h = delta + bh * N;
  const int nt = (N + kRows - 1) / kRows;
  const int tail16 = (N - (nt - 1) * kRows + 15) / 16;

  for (int w = 0; w < kWg; ++w) {
    const int row0 = (blockIdx.x * kWg + w) * kRows;
    const uint32_t tile = base + w * 2 * kTileBytes;
    load_tile<kThreads>(tile, kh, ks.n, row0, N, tid);
    load_tile<kThreads>(tile + kTileBytes, vh, vs.n, row0, N, tid);
  }
  auto slot = [&](int i) { return ring + (i % kSlots) * 2 * kTileBytes; };
  auto stats_slot = [&](int i) { return stats + (i % kSlots) * kStatsBytes; };
  auto issue = [&](int i) {
    if (i < nt) {
      load_tile<kThreads>(slot(i), qh, qs.n, i * kRows, N, tid);
      load_tile<kThreads>(slot(i) + kTileBytes, doh, dos.n, i * kRows, N,
                          tid);
      load_stats(stats_slot(i), lse_h, delta_h, i * kRows, N, tid);
    }
    cp_async_commit();
  };
  auto arrive = [&](int i) {
    cp_async_wait<kAhead - 2>();
    fence_async_shared();
    __syncthreads();
    issue(i + kAhead);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue(i);

  float dka[32], dva[32], s[32], dp[32];
  zero(dka);
  zero(dva);
  const float scale2 = scale * kLog2e;
  for (int j = 0; j < nt; ++j) {
    arrive(j);
    if (!active) continue;
    const uint32_t sQ = slot(j), sQn = slot(j + 1);
    const float* st =
        reinterpret_cast<const float*>(smem_raw + (stats_slot(j) - raw));
    const int q0 = j * kRows;
    if (j == 0) {
      wgmma_fence();
      issue_scores<kRows>(s, sK, sQ);
      issue_scores<kRows>(dp, sV, sQ + kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(s);
      fence_registers(dp);
    }
    if (j < nt - 2) {
      dkdv_step<64, false, 64>(s, dp, dka, dva, sK, sV, sQ, sQn, st, q0, N,
                               scale2, scale, t);
    } else if (j == nt - 2) {
#define LT_STEP(W)                                                      \
  dkdv_step<64, false, W>(s, dp, dka, dva, sK, sV, sQ, sQn, st, q0, N,  \
                          scale2, scale, t)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    } else {
#define LT_STEP(W)                                                           \
  dkdv_step<W, true, 0>(s, dp, dka, dva, sK, sV, sQ, 0, st, q0, N, scale2,  \
                        scale, t)
      LT_BY_TAIL(tail16, LT_STEP);
#undef LT_STEP
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  const int r0 = k0 + warp * 16 + g;
  store_rows(dk + b * dks.b + h * dks.h, dks.n, dka, r0, N, t);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.n, dva, r0, N, t);
}

// N <= 64, the whole head in one tile of W = 16 * ceil(N / 16) rows:
// S^T = K . Q^T and dP^T = V . dO^T, then dV = P^T . dO and dK = dS^T . Q
// from registers, and dQ = dS . K with dS^T stored to the swizzled tile sS
// (rows are keys, the depth of the product; both operands MN-major). st
// holds lse log2 e (+inf past N) and delta (0 past N) by query; keys past N
// (rows g, g + 8 of this thread: ok0, ok1) get p = 0.
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
  issue_scores<W>(s, sK, sQ);
  issue_scores<W>(dp, sV, sD);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  fence_registers(dp);
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 c = *reinterpret_cast<const float2*>(st + col);
    const float2 dl = *reinterpret_cast<const float2*>(st + kRows + col);
    const float cc[2] = {c.x, c.y}, d[2] = {dl.x * scale, dl.y * scale};
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2_ftz(fmaf(s[4 * j + e], scale2, -cc[e & 1]));
      p[e] = (e < 2 ? ok0 : ok1) ? x : 0.f;
      ds[e] = p[e] * fmaf(dp[4 * j + e], scale, -d[e & 1]);
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
  wgmma_commit();
  fence_async_shared();
  __syncthreads();  // every warp's part of dS^T is in sS
  fence_registers(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_ss_tt(dq, mn_major(sS, kk), mn_major(sK, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dq);
  fence_registers(dk);
  fence_registers(dv);
}

__global__ void __launch_bounds__(128, 1)
    attention_bwd_one_tile_sm90_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ o,
        const bf16* __restrict__ dout, const float* __restrict__ lse,
        bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
        int N, lt::Strides qs, lt::Strides ks, lt::Strides vs,
        lt::Strides os, lt::Strides dos, lt::Strides dqs, lt::Strides dks,
        lt::Strides dvs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = lt::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sD = sQ + kTileBytes, sK = sD + kTileBytes;
  const uint32_t sV = sK + kTileBytes, sS = sV + kTileBytes;
  float* st = reinterpret_cast<float*>(smem_raw + (sS + kTileBytes - raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long bh = static_cast<long>(b) * gridDim.y + h;
  const bf16* qh = q + b * qs.b + h * qs.h;
  const bf16* doh = dout + b * dos.b + h * dos.h;
  const bf16* oh = o + b * os.b + h * os.h;
  load_tile<128>(sQ, qh, qs.n, 0, N, tid);
  load_tile<128>(sD, doh, dos.n, 0, N, tid);
  load_tile<128>(sK, k + b * ks.b + h * ks.h, ks.n, 0, N, tid);
  load_tile<128>(sV, v + b * vs.b + h * vs.h, vs.n, 0, N, tid);
  cp_async_commit();

  // Per query row (two threads a row, while the copies fly): lse log2 e
  // (even thread) and delta (odd), +inf and 0 past N.
  {
    const int r = tid >> 1, rc = min(r, N - 1), odd = tid & 1;
    float dsum = half_row_delta(oh + rc * os.n + odd * 32,
                                doh + rc * dos.n + odd * 32);
    dsum += __shfl_xor_sync(0xffffffff, dsum, 1);
    const float val = odd ? dsum : lse[bh * N + rc] * kLog2e;
    st[odd * kRows + r] = r < N ? val : (odd ? 0.f : INFINITY);
  }
  cp_async_wait<0>();
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

// strides: (batch, token, head) for q, k, v, o, do, dq, dk, dv. bf16
// (fp32 = 0) at hd = 64, 16 or 128 (N <= 768). At hd 64 and N > 64, and at
// hd 128, the dq kernel writes delta (B, H, N) fp32 for the dk/dv kernel;
// hd 16 does not use it.
extern "C" int lt_attention_bwd_sm90(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* delta, int fp32, int B, int N,
                                     int H, int hd, const long* strides,
                                     float scale, void* stream) {
  if (fp32 || N < 1) return cudaErrorInvalidValue;
  if (hd == 16)
    return lt::sm90::hd16::launch_bwd<bf16>(q, k, v, o, dout, lse, dq, dk, dv,
                                            B, N, H, strides, scale, stream);
  if (hd == 128)
    return lt::sm90::hd128::launch_bwd_tma(q, k, v, o, dout, lse, dq, dk, dv,
                                           delta, B, N, H, strides, scale,
                                           stream);
  if (hd != 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* o_ = static_cast<const bf16*>(o);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  bf16 *dq_ = static_cast<bf16*>(dq), *dk_ = static_cast<bf16*>(dk);
  bf16* dv_ = static_cast<bf16*>(dv);
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
    const size_t smem = 1024 + 5 * kTileBytes + 2 * kRows * sizeof(float);
    err = allow_smem(attention_bwd_one_tile_sm90_kernel, smem);
    if (err != cudaSuccess) return err;
    attention_bwd_one_tile_sm90_kernel<<<dim3(1, H, B), 128, smem, s>>>(
        q_, k_, v_, o_, do_, lse_, dq_, dk_, dv_, N, qs, ks, vs, os, dos, dqs,
        dks, dvs, scale);
    return cudaGetLastError();
  }
  const dim3 grid((N + kWg * kRows - 1) / (kWg * kRows), H, B);
  const size_t smem_dq = 1024 + (2 * kWg + 2 * kSlots) * kTileBytes;
  err = allow_smem(attention_bwd_dq_sm90_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_sm90_kernel<<<grid, kThreads, smem_dq, s>>>(
      q_, k_, v_, o_, do_, lse_, dq_, delta_, N, qs, ks, vs, os, dos, dqs,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv = 1024 + (2 * kWg + 2 * kSlots) * kTileBytes +
                         kSlots * kThreads * sizeof(float);
  err = allow_smem(attention_bwd_dkdv_sm90_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_sm90_kernel<<<grid, kThreads, smem_kv, s>>>(
      q_, k_, v_, do_, lse_, delta_, dk_, dv_, N, qs, ks, vs, dos, dks, dvs,
      scale);
  return cudaGetLastError();
}
