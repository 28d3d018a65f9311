// Helpers shared by the attention kernels (sm90.cuh builds on them): the
// element types, the strides of a tensor, and the packing of fp32 pairs to
// bf16 and their stores.
//
// Element types. A bf16 tile is staged in shared memory as it is: one bf16
// "plane". An fp32 tile is staged as two planes, hi = bf16(x) and
// lo = bf16(x - hi), which together keep 16 significant bits of x; a
// product of two fp32 operands is then hi.hi + hi.lo + lo.hi, and a product
// of a bf16 operand (p, ds, the rounded do) with an fp32 one is b.hi + b.lo,
// all on the bf16 tensor cores with fp32 accumulation. The dropped terms
// are below 2^-16 of each product, finer than TF32's 2^-11, and the
// kernels' error stays set by the bf16 rounding of p and ds, as on the TPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lt {

using bf16 = __nv_bfloat16;

// bf16 planes of a staged tile of T.
template <typename T>
struct Planes {
  static constexpr int value = 2;  // float: hi and lo
};
template <>
struct Planes<bf16> {
  static constexpr int value = 1;
};

// Strides of one tensor in elements: batch, token and head (the column
// stride is 1).
struct Strides {
  long b, n, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring elements of a global row, from fp32.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Strides of tensor i of a (batch, token, head) stride array.
inline Strides strides_of(const long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace lt
