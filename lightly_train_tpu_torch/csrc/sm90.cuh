// Hopper (sm_90a) machinery shared by the attention kernels, all on wgmma
// (flat_attention_fwd_sm90.cu and flat_attention_bwd_sm90.cu in bf16,
// flat_attention_fwd_f32_sm90.cu and flat_attention_bwd_f32_sm90.cu in
// fp32, at hd 16 attention_fwd_hd16.cuh and attention_bwd_hd16.cuh and at
// hd 128 attention_fwd_hd128.cuh in both): the cp.async copies that fill
// shared-memory tiles, the predicated loads that split fp32 rows into hi/lo
// planes, the wgmma shared-memory descriptors, the warpgroup products, the
// forward's row maxima, probabilities and steps, the TMA loads and
// mbarriers of the persistent hd-128 kernels (attention_fwd_hd128_resident.cuh
// and attention_bwd_hd128_tma.cuh), and what the two hd-16 kernels share
// (namespace hd16).
//
// A tile is 64 rows of one head (queries or keys) by hd bf16, hd a template
// parameter HD (Geo<HD>; every helper's HD defaults to 64, the hd-64
// kernels' head dim). A swizzle atom is 8 rows of one atom row; the copies
// write the swizzle themselves, so a tile is a wgmma operand as it lands
// (an fp32 tile is written as two such bf16 tiles, its hi and lo planes):
//   hd 64: rows of 128 bytes, one atom row, the 128-byte swizzle
//     (descriptor mode 1): 16-byte chunk c of row r at chunk c ^ (r & 7);
//     8-row groups 1024 bytes apart (the SBO), a k16 step 2048 bytes of
//     rows (MN-major).
//   hd 16: rows of 32 bytes, the 32-byte swizzle (mode 3): chunk c of row r
//     at chunk c ^ ((r >> 2) & 1); 8-row groups 256 bytes apart (the SBO),
//     a k16 step 512 bytes of rows (MN-major).
//   hd 128: a bf16 row is 256 bytes, two atom rows, so the tile is two
//     hd-64 sub-tiles side by side, 8 KB apart: columns [0, 64) of every
//     row in the first, [64, 128) in the second, each laid out as at hd 64
//     (chunk c of row r at byte 8192 (c / 8) + 128 r + 16 ((c % 8) ^
//     (r & 7))).
// All are the swizzle of byte-offset bits 4.. by bits 7.. (chunk_at), so a
// tile starts on a 1024-byte boundary. A tile is read either way:
//   K-major: the row index is M or N of the product and hd is its depth
//     (Q, dO or K as A, or K, V, Q, dO as the B of X . Y^T); the LBO is not
//     read (the depth of a k16 step is the atom's 32 bytes, or within it).
//     At hd 128, k16 steps 4 to 7 start in the second sub-tile.
//   MN-major: the row index is the depth and hd is N (V in P . V, K in
//     dS . K, Q and dO in P^T . dO and dS^T . Q), through the transpose bit;
//     the SBO is the 8-row stride and the LBO the stride between atoms
//     along hd: at hd 64 and 16 hd is one atom wide, so the LBO is not read
//     and is given the 8-row stride too; at hd 128 (V of P . V, N = 128)
//     it is the 8 KB between the sub-tiles.
// Accumulators are laid out per warp as a warp's 16 rows, lane 4 g + t
// holding rows g and g + 8, columns 8 j + 2 t and + 1, so a packed pair of
// neighbouring accumulators is the register A operand of the next product.
#pragma once

#include <cuda.h>

#include "mma.cuh"

namespace lt {
namespace sm90 {

constexpr int kRows = 64;  // rows of a tile: queries or keys

// The shared-memory geometry of a tile at head dim HD (see above).
template <int HD>
struct Geo {
  static_assert(HD == 16 || HD == 64 || HD == 128, "head dim 16, 64 or 128");
  static constexpr int kAtomCols = HD == 16 ? 16 : 64;  // an atom row's bf16
  static constexpr int kAtoms = HD / kAtomCols;  // atoms across a row
  static constexpr int kRowBytes = 2 * kAtomCols;  // a row within one atom
  static constexpr int kAtomBytes = kRows * kRowBytes;  // a sub-tile
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: the SBO
  static constexpr int kChunks = HD / 8;             // 16-byte chunks a row
  static constexpr int kAtomChunks = kAtomCols / 8;  // ... an atom row
  static constexpr int kLogChunks = HD == 128 ? 4 : HD == 64 ? 3 : 1;
  static constexpr int kRowShift = HD == 16 ? 2 : 0;  // log2(128 / kRowBytes)
  static constexpr uint64_t kMode = HD == 16 ? 3 : 1;  // descriptor swizzle
};

// The hd-64 tile, which the hd-64 kernels use.
constexpr int kRowBytes = Geo<64>::kRowBytes;
constexpr int kTileBytes = Geo<64>::kTileBytes;

// Address of 16-byte chunk c of row r in the swizzled tile at `tile`.
template <int HD = 64>
__device__ __forceinline__ uint32_t chunk_at(uint32_t tile, int r, int c) {
  using G = Geo<HD>;
  if constexpr (G::kAtoms > 1) {
    tile += (c / G::kAtomChunks) * G::kAtomBytes;
    c %= G::kAtomChunks;
  }
  return tile + r * G::kRowBytes +
         ((c ^ ((r >> G::kRowShift) & (G::kAtomChunks - 1))) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 bytes (an fp32 row statistic), zero-filled without a read where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
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

// Shared-memory matrix descriptor in the swizzle mode of head dim HD; byte
// offsets.
template <int HD = 64>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | Geo<HD>::kMode << 62;
}

// A K-major operand at step kk of hd: 16 columns = 32 bytes a step (hd 16
// has one), 8-row groups kGroupBytes apart; at hd 128 steps 4 to 7 in the
// second sub-tile.
template <int HD = 64>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  using G = Geo<HD>;
  if constexpr (G::kAtoms > 1)
    return descriptor<HD>(tile + (kk / 4) * G::kAtomBytes + 32 * (kk % 4),
                          16, G::kGroupBytes);
  else
    return descriptor<HD>(tile + 32 * kk, 16, G::kGroupBytes);
}

// An MN-major operand at step kk of the rows: 16 rows a step, 8-row groups
// kGroupBytes apart (the SBO); the LBO steps from one atom to the next
// along hd (hd 128's sub-tiles), and is not read where hd is a single atom
// wide.
template <int HD = 64>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  using G = Geo<HD>;
  return descriptor<HD>(tile + 2 * G::kGroupBytes * kk,
                        G::kAtoms > 1 ? G::kAtomBytes : G::kGroupBytes,
                        G::kGroupBytes);
}

// One k16 step of d (64 x NK) += A . B^T, both from shared memory, K-major;
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

// One k16 step of d (64 x 64) = (or +=) A . B, both from shared memory and
// MN-major (transpose bits set).
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
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

// The same at N = 128 (d 64 x 128: P . V at hd 128).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same at N = 16 (d 64 x 16: P . V at hd 16).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Rows [row0, row0 + 64) of one head (hd HD) into a swizzled tile, by the
// block's kThreads threads, the same number of copies each (no branch, so
// the products in flight around it stay asynchronous); rows at or past N
// are zero-filled without a read.
template <int kThreads, int HD = 64>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* head,
                                          long row_stride, int row0, int N,
                                          int tid) {
  using G = Geo<HD>;
#pragma unroll
  for (int n = 0; n < kRows * G::kChunks / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i >> G::kLogChunks, c = i & (G::kChunks - 1);
    const bool valid = row0 + r < N;
    const bf16* src = valid ? head + (row0 + r) * row_stride + c * 8 : head;
    cp_async16(chunk_at<HD>(tile, r, c), src, valid);
  }
}

// fp32 rows [row0, row0 + 64) of one head (hd HD) as the hi and lo planes of
// a swizzled tile (lo kTileBytes above hi), with no register staging: the
// eight floats of bf16 chunk (r, c) land raw by cp.async, the first four in
// the chunk's hi slot and the last four in its lo slot (zero-filled without
// a read at or past N), and split_tile rewrites them in place once they
// have landed. Both walk the chunks in the same order, so a thread splits
// only what it copied itself: no barrier stands between the two.
template <int kThreads, int HD>
__device__ __forceinline__ void copy_tile_f32(uint32_t tile, const float* head,
                                              long row_stride, int row0,
                                              int N, int tid) {
  using G = Geo<HD>;
#pragma unroll
  for (int n = 0; n < kRows * G::kChunks / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i >> G::kLogChunks, c = i & (G::kChunks - 1);
    const bool valid = row0 + r < N;
    const float* src = valid ? head + (row0 + r) * row_stride + c * 8 : head;
    const uint32_t at = chunk_at<HD>(tile, r, c);
    cp_async16(at, src, valid);
    cp_async16(at + G::kTileBytes, src + 4, valid);
  }
}

// After copy_tile_f32's copies have landed (cp_async_wait): each chunk's
// eight floats as hi = bf16(x) in the hi plane and lo = bf16(x - hi) in the
// lo plane.
template <int kThreads, int HD>
__device__ __forceinline__ void split_tile(uint32_t tile, int tid) {
  using G = Geo<HD>;
#pragma unroll
  for (int n = 0; n < kRows * G::kChunks / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const uint32_t at =
        chunk_at<HD>(tile, i >> G::kLogChunks, i & (G::kChunks - 1));
    float x[8];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "r"(at)
                 : "memory");
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[4]), "=f"(x[5]), "=f"(x[6]), "=f"(x[7])
                 : "r"(at + G::kTileBytes)
                 : "memory");
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = lt::pack_bf16(x[2 * e], x[2 * e + 1]);
      lo[e] = lt::pack_bf16(x[2 * e] - __uint_as_float(hi[e] << 16),
                            x[2 * e + 1] - __uint_as_float(hi[e] & 0xffff0000u));
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                 "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     at + G::kTileBytes),
                 "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                 : "memory");
  }
}

// 16 bytes of fp32 at p, or zeros without a read where !valid.
__device__ __forceinline__ float4 load4(const float* p, bool valid) {
  float4 x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "mov.f32 %0, 0f00000000;\nmov.f32 %1, 0f00000000;\n"
      "mov.f32 %2, 0f00000000;\nmov.f32 %3, 0f00000000;\n"
      "@p ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
      : "l"(p), "r"(static_cast<int>(valid)));
  return x;
}

// Four fp32 as hi = bf16(x) and, with kPlanes = 2, lo = bf16(x - hi), each
// four packed bf16 stored at `at` of the hi plane and of the lo plane
// kTileBytes above it (kPlanes = 1: x rounded to bf16, the hi plane only).
template <int kPlanes>
__device__ __forceinline__ void store_split(uint32_t at, float4 x) {
  const uint32_t h01 = lt::pack_bf16(x.x, x.y);
  const uint32_t h23 = lt::pack_bf16(x.z, x.w);
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(at), "r"(h01),
               "r"(h23)
               : "memory");
  if constexpr (kPlanes == 2) {
    const uint32_t l01 =
        lt::pack_bf16(x.x - __uint_as_float(h01 << 16),
                      x.y - __uint_as_float(h01 & 0xffff0000u));
    const uint32_t l23 =
        lt::pack_bf16(x.z - __uint_as_float(h23 << 16),
                      x.w - __uint_as_float(h23 & 0xffff0000u));
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(at + kTileBytes),
                 "r"(l01), "r"(l23)
                 : "memory");
  }
}

// This thread's share of fp32 rows [row0, row0 + 64) of one head (hd 64),
// read by the block's kThreads threads: float4 i = tid + n kThreads is row
// i / 16, columns 4 (i % 16) + [0, 4), so a warp reads two whole rows and
// the 16 threads of a half warp hold one row.
template <int kThreads>
__device__ __forceinline__ void fetch(float4 (&x)[kRows * 16 / kThreads],
                                      const float* head, long row_stride,
                                      int row0, int N, int tid) {
#pragma unroll
  for (int n = 0; n < kRows * 16 / kThreads; ++n) {
    const int i = tid + n * kThreads, r = row0 + i / 16;
    const bool valid = r < N;
    x[n] = load4(valid ? head + r * row_stride + 4 * (i % 16) : head, valid);
  }
}

// Where float4 i of fetch's layout (row r = i / 16, columns 4 c .. 4 c + 3
// with c = i % 16) lies in the swizzled bf16 tile at `tile`: bytes 8 (c & 1)
// of 16-byte chunk (c / 2) ^ (r & 7) of row r.
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int i) {
  const int r = i / 16, c = i % 16;
  return tile + r * kRowBytes + ((((c >> 1) ^ (r & 7)) << 4) |
                                 ((c & 1) << 3));
}

// What fetch read, as kPlanes bf16 planes (hi and lo, or the rounded values
// alone) of a swizzled tile at `tile`.
template <int kThreads, int kPlanes = 2>
__device__ __forceinline__ void store_planes(
    uint32_t tile, const float4 (&x)[kRows * 16 / kThreads], int tid) {
#pragma unroll
  for (int n = 0; n < kRows * 16 / kThreads; ++n)
    store_split<kPlanes>(swizzled(tile, tid + n * kThreads), x[n]);
}

// The first NK / 2 accumulators of an array of R (32 for a 64-column
// tile, 16 for 32 columns).
template <int NK, int R>
__device__ __forceinline__ float (&first(float (&s)[R]))[NK / 2] {
  static_assert(NK / 2 <= R, "accumulators past the array");
  return *reinterpret_cast<float(*)[NK / 2]>(&s);
}

// Issues d (64 x NK, this thread's part) = A . B[0 : NK]^T over hd (HD / 16
// k16 steps), both tiles K-major (S = Q . K^T, dP = dO . V^T, and their
// transposes); with `overwrite` false the product is added to d (a further
// chain).
template <int NK, int HD = 64, int R>
__device__ __forceinline__ void issue_scores(float (&s)[R], uint32_t sA,
                                             uint32_t sB,
                                             bool overwrite = true) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<NK>(first<NK>(s), k_major<HD>(sA, kk), k_major<HD>(sB, kk),
                 !overwrite || kk > 0);
}

// Issues d (64 x NK) = A . B[0 : NK]^T of two fp32 tiles as three chains
// into one accumulator: A_hi . B_hi, A_hi . B_lo, A_lo . B_hi (the lo
// planes a tile above the hi ones; lo . lo is dropped).
template <int NK, int HD = 64>
__device__ __forceinline__ void issue_scores_split(float (&s)[32],
                                                   uint32_t sA, uint32_t sB) {
  constexpr int kLo = Geo<HD>::kTileBytes;
  issue_scores<NK, HD>(s, sA, sB);
  issue_scores<NK, HD>(s, sA, sB + kLo, false);
  issue_scores<NK, HD>(s, sA + kLo, sB, false);
}

// Issues d += A . B[0 : NK], A (64 x NK) in registers, B an MN-major tile
// of hd HD columns (o += P . V, dQ += dS . K, dV += P^T . dO,
// dK += dS^T . Q).
template <int NK, int HD = 64>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs_tb(o, a[kk], mn_major<HD>(sV, kk));
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Keeps the compiler from defining register A operands (the first NK / 16
// k16 steps') after a fence.
template <int NK = 64>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < NK / 4; ++i) asm volatile("" : "+r"(a[i / 4][i % 4]));
}

// This thread's rows of a 64 x 2R accumulator (r0 = its row g, and r0 + 8;
// columns 8 j + 2 t and + 1) into rows of a head of T, skipping rows at or
// past N.
template <typename T, int R>
__device__ __forceinline__ void store_rows(T* head, long row_stride,
                                           const float (&acc)[R], int r0,
                                           int N, int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < N)
      lt::store2(head + r0 * row_stride + col, acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < N)
      lt::store2(head + (r0 + 8) * row_stride + col, acc[4 * j + 2],
                 acc[4 * j + 3]);
  }
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

// S (64 x NK) = A . B^T of tiles of head dim HD at sA and sB (S = Q . K^T,
// and S^T = K . Q^T): one chain from bf16 planes (P = 1), three from fp32
// hi/lo planes (P = 2).
template <int P, int NK, int HD>
__device__ __forceinline__ void plane_scores(float (&s)[32], uint32_t sA,
                                             uint32_t sB) {
  if constexpr (P == 1)
    issue_scores<NK, HD>(s, sA, sB);
  else
    issue_scores_split<NK, HD>(s, sA, sB);
}

// The forward's steps at head dim HD over tiles of P bf16 planes, as the
// hd-16 and hd-128 kernels take them.
//
// Pass 1, key tiles at sKa and sKb (widths NKa and NKb, none if NKb is 0):
// both S issued at once, the first folded into the row maxima while the
// second computes.
template <int P, int HD, int NKa, bool kMaskA, int NKb, bool kMaskB>
__device__ __forceinline__ void fwd_max_step(float (&sa)[32],
                                             float (&sb)[32], uint32_t sQ,
                                             uint32_t sKa, uint32_t sKb,
                                             int kv0, int N, float scale,
                                             int t, float& m0, float& m1) {
  wgmma_fence();
  plane_scores<P, NKa, HD>(sa, sQ, sKa);
  wgmma_commit();
  if constexpr (NKb > 0) {
    plane_scores<P, NKb, HD>(sb, sQ, sKb);
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
// then o += P . V (one chain, or P . V_hi + P . V_lo) and the next tile's S
// (width NKn, none if 0) into s in one batch of products.
template <int P, int HD, int NK, bool kMask, int NKn>
__device__ __forceinline__ void fwd_output_step(
    float (&s)[32], float (&o)[HD / 2], uint32_t sQ, uint32_t sKn,
    uint32_t sV, int kv0, int N, float scale2, int t, float c0, float c1,
    float& l0, float& l1) {
  uint32_t a[4][4];
  probabilities<NK, kMask>(s, a, kv0, N, scale2, t, c0, c1, l0, l1);
  wgmma_fence();
  issue_pv<NK, HD>(o, a, sV);
  if constexpr (P == 2) issue_pv<NK, HD>(o, a, sV + Geo<HD>::kTileBytes);
  if constexpr (NKn > 0) plane_scores<P, NKn, HD>(s, sQ, sKn);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(o);
  fence_registers(s);
}

// TMA loads behind mbarriers, as the persistent hd-128 kernels use them
// (attention_fwd_hd128_resident.cuh, attention_bwd_hd128_tma.cuh): a
// barrier's phase completes when its count of arrivals and the bytes its
// copies announced have all come in; a waiter names the phase by its parity.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The producer's arrival on a full barrier, with the bytes its copies bring.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One tile (64 rows from row0, all 128 columns) of one head by TMA,
// completing on `bar`, in boxes of one 128-byte swizzle row: bf16, two
// boxes of 64 columns, 8 KB apart (the hd-128 tile above); fp32, four
// boxes of 32 columns, box 2 s + e at 16 KB e + 8 KB s (split_planes turns
// them into the hi and lo planes). The tensor map's dimensions are (column,
// token, head, batch), or (column, head, token, batch) where `swap` (the
// head stride below the token stride).
template <typename T>
__device__ __forceinline__ void tma_tile(const CUtensorMap& map, uint32_t dst,
                                         uint32_t bar, int row0, int h, int b,
                                         int swap) {
  using G = Geo<128>;
  constexpr int kBoxes = 128 * static_cast<int>(sizeof(T)) / 128;
  constexpr int kCols = 128 / kBoxes;
  const uint64_t desc = reinterpret_cast<uint64_t>(&map);
  const int c1 = swap ? h : row0, c2 = swap ? row0 : h;
#pragma unroll
  for (int box = 0; box < kBoxes; ++box) {
    const uint32_t at = kBoxes == 2 ? dst + box * G::kAtomBytes
                                    : dst + (box & 1) * G::kTileBytes +
                                          (box >> 1) * G::kAtomBytes;
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(at),
        "l"(desc), "r"(box * kCols), "r"(c1), "r"(c2), "r"(b), "r"(bar)
        : "memory");
  }
}

// A warpgroup's output tile (64 rows from row0, hd 128) by TMA: two boxes
// of 64 x 64 from the tile staged at src in the layout tma_tile<bf16> loads,
// one bulk group; rows past N are not written.
__device__ __forceinline__ void tma_store_tile(const CUtensorMap& map,
                                               uint32_t src, int row0, int h,
                                               int b, int swap) {
  const uint64_t desc = reinterpret_cast<uint64_t>(&map);
  const int c1 = swap ? h : row0, c2 = swap ? row0 : h;
#pragma unroll
  for (int half = 0; half < 2; ++half)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
        "[%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(desc),
        "r"(half * 64), "r"(c1), "r"(c2), "r"(b),
        "r"(src + half * Geo<128>::kAtomBytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory
// (kRead) or are done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A shared-memory address as an opaque value at this point of the program,
// so that the compiler derives no descriptor from it before the mbarrier
// wait ahead of it (and holds no descriptor of every tile in registers).
__device__ __forceinline__ uint32_t here(uint32_t addr) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(addr));
  return addr;
}

// bar.sync on warpgroup wg's own named barrier (1 or 2; 0 is the block's).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of one (B, H, N, 128) tensor of T with strides st (batch,
// token, head, in elements): boxes of one 128-byte swizzle row (64 bf16 or
// 32 fp32 columns) x 64 tokens of one head, in the 128-byte swizzle. The
// token and head dimensions go in the order of their strides; returns
// whether they were swapped, or -1 on an error.
template <typename T>
int tensor_map(CUtensorMap* map, const void* x, int B, int N, int H,
               Strides st) {
  constexpr cuuint64_t kBytes = sizeof(T);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const bool swap = st.h < st.n;
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(swap ? H : N),
                              static_cast<cuuint64_t>(swap ? N : H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      kBytes * static_cast<cuuint64_t>(swap ? st.h : st.n),
      kBytes * static_cast<cuuint64_t>(swap ? st.n : st.h),
      kBytes * static_cast<cuuint64_t>(st.b)};
  const cuuint32_t box[4] = {128 / kBytes, swap ? 1u : 64u, swap ? 64u : 1u,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult err = encode(
      map,
      kBytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return err == CUDA_SUCCESS ? static_cast<int>(swap) : -1;
}

// What the hd-16 forward (attention_fwd_hd16.cuh) and backward
// (attention_bwd_hd16.cuh) share: a warpgroup's copies of whole tiles, a
// whole head staged in shared memory at once, and the scores.
namespace hd16 {

constexpr int kHD = 16;
constexpr int kThreads = 128;  // a warpgroup
constexpr int kMaxTiles = 12;  // N <= 768, the kernels' range
using G = Geo<kHD>;

// Rows [row0, row0 + 64) of one head as a tile's bf16 plane, or an fp32
// tile's hi and lo planes (raw until split_tile).
__device__ __forceinline__ void stage(uint32_t tile, const bf16* head,
                                      long row_stride, int row0, int N,
                                      int tid) {
  load_tile<kThreads, kHD>(tile, head, row_stride, row0, N, tid);
}
__device__ __forceinline__ void stage(uint32_t tile, const float* head,
                                      long row_stride, int row0, int N,
                                      int tid) {
  copy_tile_f32<kThreads, kHD>(tile, head, row_stride, row0, N, tid);
}

// S (64 x NK) = A . B^T of the tiles at sA and sB (S = Q . K^T, and
// S^T = K . Q^T) at hd 16 (plane_scores).
template <int P, int NK>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t sA,
                                       uint32_t sB) {
  plane_scores<P, NK, kHD>(s, sA, sB);
}

}  // namespace hd16
}  // namespace sm90
}  // namespace lt

// Calls CALL(W) with W the width of the last tile (16, 32, 48 or 64) for
// w16 = 1..4 of its 16-row steps.
#define LT_BY_TAIL(w16, CALL) \
  switch (w16) {              \
    case 1: CALL(16); break;  \
    case 2: CALL(32); break;  \
    case 3: CALL(48); break;  \
    default: CALL(64);        \
  }
