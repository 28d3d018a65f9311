// Helpers shared by the attention kernels: warp-level tensor-core products,
// staging of tiles in shared memory, and the host's choice of configuration.
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
//
// Element types. A bf16 tile is staged in shared memory as it is: one bf16
// "plane". An fp32 tile is staged as two planes, hi = bf16(x) and
// lo = bf16(x - hi), which together keep 16 significant bits of x; a
// product of two fp32 operands is then hi.hi + hi.lo + lo.hi, and a product
// of a bf16 operand (p, ds, the rounded do) with an fp32 one is b.hi + b.lo,
// all on the same bf16 mma.sync with fp32 accumulation. The dropped terms
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

// Two neighbouring elements of a global row, as fp32.
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Host side: which configuration the mma.sync attention kernels launch.
// "Resident": one block per (batch, head) stages the whole walked operand (K
// and V, or Q and do) in shared memory once, and its warps walk every 16-row
// tile of the head. "Streamed": blocks of kMaxWarps tiles walk the operand in
// kStreamRows-row tiles, so a head's operand is read once per block (from
// L2 after the first), and an fp32 one is split into hi/lo planes again in
// every block.
// The rule, from a sweep of both configurations over N, B * H and dtype on
// an H100 80GB HBM3 at 700 W (PERF.md, findings): resident is faster wherever
// it fits, from B * H = 96 up (B * H = 16 at hd 16 ran 2x faster streamed:
// the resident grid leaves most SMs idle), in every backward and in the
// fp32 forward. The rule now serves the mma.sync kernels' one remaining
// route, the backward at hd 16 (flat_attention_bwd.cu). Every forward, and
// the backward at hd 64, runs on wgmma (flat_attention_fwd_sm90.cu and
// flat_attention_bwd_sm90.cu in bf16, flat_attention_fwd_f32_sm90.cu and
// flat_attention_bwd_f32_sm90.cu in fp32), and those choose their own
// configuration.
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have
constexpr int kStreamRows = 64;   // walked rows staged at once when streamed

// Whether `blocks` resident blocks of `smem` bytes pay.
inline bool resident_pays(size_t smem, long blocks) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  return smem <= static_cast<size_t>(kMaxSmem) && 2 * blocks >= sms;
}

// Launch geometry of one attention kernel.
struct Geom {
  int N, n_pad;
  int rows;   // walked rows staged at once (n_pad when resident)
  int tiles;  // 16-row tiles each block owns
};

// Resident where it pays, else streamed. smem(rows, n_warps) is the
// kernel's dynamic shared memory.
inline Geom pick_geometry(int N, long blocks, int n_warps,
                          size_t (*smem)(int, int)) {
  const int n_pad = (N + 15) / 16 * 16;
  const int rows =
      resident_pays(smem(n_pad, n_warps), blocks) ? n_pad : kStreamRows;
  return Geom{N, n_pad, rows, rows >= n_pad ? n_pad / 16 : n_warps};
}

// Strides of tensor i of a (batch, token, head) stride array.
inline Strides strides_of(const long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Row-major smem tile of bf16 with HD columns, padded by 8 elements per row
// so that the 8 row addresses of one ldmatrix fall in distinct bank groups.
template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;
};

// Copy rows [row0, row0 + rows) of one head (HD elements of T at unit
// stride, rows `row_stride` apart) from global memory into NP padded bf16
// planes in shared memory, `plane` elements apart; rows at or past n_valid
// are zero-filled. With NP = 1 an fp32 source is rounded to bf16 (the TPU
// kernel's do16). 16-byte vector loads: the wrapper checks that the base
// pointer is 16-byte aligned and the strides are multiples of 16 bytes.
template <int HD, int NP, typename T>
__device__ __forceinline__ void stage_rows(bf16* smem, int plane, const T* g,
                                           long row_stride, int row0,
                                           int rows, int n_valid, int tid,
                                           int n_threads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = tid; i < rows * kPerRow; i += n_threads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_valid) {
      raw = *reinterpret_cast<const uint4*>(g + (row0 + r) * row_stride + c);
    }
    bf16* dst = smem + r * Tile<HD>::kStride + c;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {
      const float* x = reinterpret_cast<const float*>(&raw);
      float hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[e] = bf16_round(x[e]);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]));
      if constexpr (NP == 2) {
        *reinterpret_cast<uint2*>(dst + plane) =
            make_uint2(pack_bf16(x[0] - hi[0], x[1] - hi[1]),
                       pack_bf16(x[2] - hi[2], x[3] - hi[3]));
      }
    }
  }
}

// A fragments (16 x HD) of each plane of a staged 16-row tile.
template <int HD, int NP>
__device__ __forceinline__ void a_frags(uint32_t (&f)[NP][HD / 16][4],
                                        const bf16* tile, int plane,
                                        int lane) {
  constexpr int S = Tile<HD>::kStride;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(f[p][kk], tile + p * plane +
                                ((lane % 8) + ((lane / 8) % 2) * 8) * S +
                                kk * 16 + (lane / 16) * 8);
}

// c[2] (16 x 16) = A (16 x HD, PA planes of fragments) . R[n0 : n0 + 16]^T,
// R row-major in PB planes; the lo.lo term is dropped.
template <int HD, int PA, int PB>
__device__ __forceinline__ void a_times_rows_t(
    float (&c)[2][4], const uint32_t (&a)[PA][HD / 16][4], const bf16* rows,
    int plane, int n0, int lane) {
  constexpr int S = Tile<HD>::kStride;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) {
      uint32_t r[4];
      ldmatrix_x4(r, rows + pb * plane +
                         (n0 + (lane % 8) + (lane / 16) * 8) * S + kk * 16 +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int pa = 0; pa < PA; ++pa) {
        if (pa + pb > 1) continue;
        mma_bf16(c[0], a[pa][kk], r[0], r[1]);
        mma_bf16(c[1], a[pa][kk], r[2], r[3]);
      }
    }
}

// acc (16 x HD) += P (16 x 16, one bf16 A fragment) . R[n0 : n0 + 16], R
// row-major in PB planes.
template <int HD, int PB>
__device__ __forceinline__ void p_times_rows(float (&acc)[HD / 8][4],
                                             const uint32_t (&p)[4],
                                             const bf16* rows, int plane,
                                             int n0, int lane) {
  constexpr int S = Tile<HD>::kStride;
#pragma unroll
  for (int nb = 0; nb < HD / 16; ++nb)
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, rows + pb * plane +
                               (n0 + (lane % 8) + ((lane / 8) % 2) * 8) * S +
                               nb * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * nb], p, r[0], r[1]);
      mma_bf16(acc[2 * nb + 1], p, r[2], r[3]);
    }
}

// 16 output rows (C fragments) into rows [row0, row0 + 16) of a head,
// skipping rows at or past N; rows g and g + 8 are divided by `div0` and
// `div1`.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* dst, long row_stride,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int N, int lane,
                                           float div0 = 1.f,
                                           float div1 = 1.f) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < N)
      store2(dst + r0 * row_stride + col, acc[j][0] / div0, acc[j][1] / div0);
    if (r1 < N)
      store2(dst + r1 * row_stride + col, acc[j][2] / div1, acc[j][3] / div1);
  }
}

}  // namespace lt
