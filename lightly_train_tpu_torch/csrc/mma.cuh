// Warp-level bf16 tensor-core helpers shared by the flat-attention kernels.
//
// mma.sync m16n8k16 (bf16 x bf16 -> fp32) and ldmatrix, written as inline
// PTX so the sources need no header beyond the CUDA toolkit's. Fragment
// layouts (lane = 4 * group + tid):
//   A 16x16 row-major: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)
//                      a3 (g+8, 8+2t..)
//   B 16x8 "col":      b0 (k=2t..2t+1, n=g)  b1 (k=8+2t.., n=g)
//   C 16x8 fp32:       c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// Two neighbouring C tiles (n and n+8) therefore hold exactly the A
// fragment of a 16x16 tile, which is how probabilities computed in
// registers feed the next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b  (16x8x16, bf16 operands, fp32 accumulator).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Row-major smem tile of bf16 with HD columns, padded by 8 elements per row
// so that the 8 row addresses of one ldmatrix fall in distinct bank groups.
template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;
};

// Copy rows [row0, row0 + rows) of one head (HD contiguous bf16 at column
// offset col0) from global memory into a padded smem tile; rows at or past
// n_valid are zero-filled. 16-byte vector loads: the wrapper checks that
// the base pointer is 16-byte aligned and the strides are multiples of 8.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* smem,
                                          const __nv_bfloat16* g,
                                          long row_stride, int row0, int rows,
                                          int n_valid) {
  constexpr int kVec = 8;
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += blockDim.x) {
    int r = i / kPerRow;
    int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    int gr = row0 + r;
    if (gr < n_valid) {
      val = *reinterpret_cast<const uint4*>(g + gr * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * Tile<HD>::kStride + c) = val;
  }
}

}  // namespace lt
