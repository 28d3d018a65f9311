// Multi-head self-attention, forward, bf16 at head dim 64: K1 (flat layout)
// and K4 (per-head layout) on Hopper's warpgroup tensor-core products.
//
// Replaces lightly_train_tpu/ops/pallas/attention.py::_flat_fwd_kernel (K1,
// q/k/v as (B, N, H * hd)) and ::_fwd_kernel (K4, q/k/v as (B, H, N, hd))
// for bf16 q/k/v with hd = 64; fp32 and hd 16 stay on flat_attention_fwd.cu.
// Each tensor is read or written in place through three strides (batch,
// token, head; the column stride is 1), as there: the flat layout, a view
// of a fused qkv output, (B, N, H, hd) and (B, H, N, hd). lse is (B, H, N)
// fp32.
//
// Numerics are the TPU kernel's: s = (q . k) * scale in fp32, m = max over
// ALL keys (a first pass), p = bf16(exp(s - m)), l = sum of the rounded p in
// fp32, o = (p . v) / l, lse = m + log(l). exp is __expf's 2^(x log2 e) with
// log2 e folded into the one FFMA that forms the exponent and subnormal
// results flushed to 0; beside flat_attention_fwd.cu only that rounding and
// the order of the fp32 sums differ.
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
//     warp's 16 rows of an accumulator have mma.sync's C layout, the A
//     layout once packed); V is an MN-major B operand (transpose bit).
//   - The last key tile runs at the narrowest wgmma width that covers its
//     keys (16, 32, 48 or 64): N = 257 is 4 x 64 + 1.
//   - The copies are branch-free and the warpgroup index is warp-uniform:
//     the compiler serializes products in a path it cannot prove uniform.
// Each warpgroup still alternates products and softmax between block
// barriers, and q . k runs twice; PERF.md has the measurements. Later work:
// TMA loads from a warp-specialised producer.
#include "mma.cuh"

namespace {

using lt::bf16;

constexpr int kRows = 64;          // queries per warpgroup, keys per tile
constexpr int kRowBytes = 128;     // one bf16 row of hd 64: a swizzle atom
constexpr int kTileBytes = kRows * kRowBytes;
constexpr int kAhead = 4;          // K/V loads in flight ahead of a step
constexpr int kSlots = kAhead + 1;  // ring slots, each a K and a V tile

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching accumulators before a wait.
template <int R>
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// A K-major operand (Q, or K as the B of Q . K^T) at step kk of hd: rows
// 128 bytes apart, 8-row groups 1024 apart, 16 columns = 32 bytes a step.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return descriptor(tile + 32 * kk, 16, 1024);
}

// V as the MN-major B of P . V at step kk of the keys: 16 rows = 2048 bytes
// a step; hd 64 is a single swizzle atom wide, so only the 1024-byte stride
// between 8-key groups is read.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return descriptor(tile + 2048 * kk, 1024, 1024);
}

// One k16 step of d (64 x NK) += A . B^T, both from shared memory;
// accumulate = 0 overwrites d.
template <int NK>
__device__ void wgmma_ss(float (&d)[NK / 2], uint64_t a, uint64_t b,
                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One k16 step of d (64 x 64) += A . B, A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Rows [row0, row0 + 64) of one head into a swizzled tile, by the block's
// kThreads threads, the same number of copies each (no branch, so the
// products in flight around it stay asynchronous); rows at or past N are
// zero-filled without a read.
template <int kThreads>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* head,
                                          long row_stride, int row0, int N,
                                          int tid) {
#pragma unroll
  for (int n = 0; n < kRows * 8 / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < N;
    const bf16* src = valid ? head + (row0 + r) * row_stride + c * 8 : head;
    cp_async16(tile + r * kRowBytes + ((c ^ (r & 7)) << 4), src, valid);
  }
}

// The first NK / 2 accumulators of a 64-key tile's 32.
template <int NK>
__device__ __forceinline__ float (&first(float (&s)[32]))[NK / 2] {
  return *reinterpret_cast<float(*)[NK / 2]>(&s);
}

// Issues S (64 x NK, this thread's part) = Q . K[0 : NK]^T.
template <int NK>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t sQ,
                                             uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<NK>(first<NK>(s), k_major(sQ, kk), k_major(sK, kk), kk > 0);
}

// Issues o += P . V[0 : NK], P in registers.
template <int NK>
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs_tb(o, a[kk], mn_major(sV, kk));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (MUFU.EX2, as __expf uses it) with subnormal results flushed to 0:
// p below 2^-126 is nothing beside the row's largest p = 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Running maxima of this thread's rows g (m0) and g + 8 (m1) over the
// scaled scores of keys kv0 + [0, NK); with kMask keys at or past N are
// -inf (only the last tile has any).
template <int NK, bool kMask>
__device__ __forceinline__ void row_max(const float (&s)[32], int kv0, int N,
                                        float scale, int t, float& m0,
                                        float& m1) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + j * 8 + 2 * t + (e & 1);
      const float val =
          !kMask || key < N ? s[4 * j + e] * scale : -INFINITY;
      if (e < 2)
        m0 = fmaxf(m0, val);
      else
        m1 = fmaxf(m1, val);
    }
}

__device__ __forceinline__ void quad_max(float& m0, float& m1) {
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffff, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffff, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffff, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffff, m1, 2));
}

// p = bf16(exp(s * scale - m)) (0 past N) into the register A operand a,
// as 2^(s * scale2 - c) with scale2 = scale log2(e) and c = m log2(e),
// __expf's own base change folded into one FFMA; l += p. One conversion
// rounds and packs a pair of neighbouring p; l adds the rounded values.
template <int NK, bool kMask>
__device__ __forceinline__ void probabilities(const float (&s)[32],
                                              uint32_t (&a)[4][4], int kv0,
                                              int N, float scale2, int t,
                                              float c0, float c1, float& l0,
                                              float& l1) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + j * 8 + 2 * t + (e & 1);
      const float x = exp2_ftz(fmaf(s[4 * j + e], scale2, e < 2 ? -c0 : -c1));
      p[e] = !kMask || key < N ? x : 0.f;
    }
    const uint32_t r0 = lt::pack_bf16(p[0], p[1]);  // row g
    const uint32_t r1 = lt::pack_bf16(p[2], p[3]);  // row g + 8
    l0 += __uint_as_float(r0 << 16) + __uint_as_float(r0 & 0xffff0000u);
    l1 += __uint_as_float(r1 << 16) + __uint_as_float(r1 & 0xffff0000u);
    a[j / 2][2 * (j % 2)] = r0;
    a[j / 2][2 * (j % 2) + 1] = r1;
  }
}

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

// Calls CALL(W) with W the width of the last key tile (16, 32, 48 or 64)
// for w16 = 1..4 of its 16-key steps.
#define LT_BY_TAIL(w16, CALL) \
  switch (w16) {              \
    case 1: CALL(16); break;  \
    case 2: CALL(32); break;  \
    case 3: CALL(48); break;  \
    default: CALL(64);        \
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

#undef LT_BY_TAIL

}  // namespace

// strides: (batch, token, head) for q, k, v, o, as lt_attention_fwd takes
// them; bf16 (fp32 = 0) at hd = 64 only.
extern "C" int lt_attention_fwd_sm90(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int fp32, int B, int N, int H, int hd,
                                     const long* strides, float scale,
                                     void* stream) {
  if (fp32 || hd != 64 || N < 1) return cudaErrorInvalidValue;
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
