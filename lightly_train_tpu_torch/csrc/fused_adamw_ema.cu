// Fused AdamW + EMA-teacher update of every parameter leaf, in place, in one
// launch (K3).
//
// Replaces lightly_train_tpu/_optim/fused_update.py::_kernel. Per element:
//   g' = g * cs
//   mu' = b1 * mu + (1 - b1) * g'
//   nu' = b2 * nu + (1 - b2) * g'^2
//   p'  = p - a * (mu' * bc1 / (sqrt(nu' * bc2) + eps) + wd * p)
//   t'  = m * t + (1 - m) * p'
// Each leaf has its own scalars (cs, bc1, bc2, a, wd, m), a row of a small
// device table, as the TPU kernel reads its (1, 8) scalar block. With a grad
// norm given, the clip scale cs = where(norm < max_norm, 1, max_norm / norm)
// is formed here from the norm on the card, so the host never waits on it.
// p, mu, nu and t are overwritten in place, as the TPU kernel aliases its
// outputs to its inputs. A null gradient pointer means a gradient of zeros.
//
// What bounds it on the H100: 5 fp32 reads and 4 fp32 writes per element,
// no reuse, ~15 flops: pure device-memory traffic (36 bytes per parameter;
// ViT-B/14 with its DINOv2 heads streams 4.78 GB, far beyond the 50 MB L2).
// The design keeps that stream flowing across every leaf of the model:
// - one launch for all leaves, from a chunk plan built once on the host:
//   each chunk is a run of up to chunk_elems elements of one leaf, so a
//   768-float LayerNorm leaf costs one chunk, not a launch;
// - a persistent grid (SMs x resident blocks per SM); block b walks chunks
//   b, b + grid, ...; per chunk it reads the leaf's five pointers and its
//   scalar row once;
// - 16-byte loads and stores with streaming cache hints (__ldcs / __stcs),
//   since no byte is read twice; the ragged tail (count % 4) of a leaf's
//   last chunk is done element by element.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

// One run of a leaf: elements [start, start + count) of leaf `leaf`. The
// layout of the host's plan (fused_update.CHUNK).
struct Chunk {
  long long start;
  int leaf;
  int count;
};
static_assert(sizeof(Chunk) == 16, "Chunk must match fused_update.CHUNK");

__device__ __forceinline__ void update(float g, float& p, float& mu, float& nu,
                                       float& t, const float* s,
                                       const Hyper& hp) {
  const float cs = s[0], bc1 = s[1], bc2 = s[2], a = s[3], wd = s[4],
              m = s[5];
  g = g * cs;
  mu = hp.b1 * mu + hp.one_minus_b1 * g;
  nu = hp.b2 * nu + hp.one_minus_b2 * (g * g);
  const float u = (mu * bc1) / (sqrtf(nu * bc2) + hp.eps) + wd * p;
  p = p - a * u;
  t = m * t + (1.f - m) * p;
}

// ptrs: (leaves, 5) addresses of g, p, mu, nu, t; scalars: (leaves, 8) rows
// (cs, bc1, bc2, a, wd, m, 0, 0); norm: the global grad norm or null (then
// cs is the row's).
__global__ void __launch_bounds__(kThreads) fused_adamw_ema_kernel(
    const Chunk* __restrict__ chunks, int n_chunks,
    const unsigned long long* __restrict__ ptrs,
    const float* __restrict__ scalars, const float* __restrict__ norm,
    float max_norm, Hyper hp) {
  float clip = 0.f;
  if (norm != nullptr) {
    const float n = *norm;
    clip = n < max_norm ? 1.f : max_norm / n;
  }
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunks[c];
    const unsigned long long* lp = ptrs + 5ll * ch.leaf;
    float s[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = scalars[8ll * ch.leaf + k];
    if (norm != nullptr) s[0] = clip;
    const float* g = reinterpret_cast<const float*>(lp[0]);
    if (g != nullptr) g += ch.start;
    float* p = reinterpret_cast<float*>(lp[1]) + ch.start;
    float* mu = reinterpret_cast<float*>(lp[2]) + ch.start;
    float* nu = reinterpret_cast<float*>(lp[3]) + ch.start;
    float* t = reinterpret_cast<float*>(lp[4]) + ch.start;
    const int n4 = ch.count >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 gv =
          g != nullptr ? __ldcs(reinterpret_cast<const float4*>(g) + i)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 pv = __ldcs(reinterpret_cast<const float4*>(p) + i);
      float4 mv = __ldcs(reinterpret_cast<const float4*>(mu) + i);
      float4 nv = __ldcs(reinterpret_cast<const float4*>(nu) + i);
      float4 tv = __ldcs(reinterpret_cast<const float4*>(t) + i);
      update(gv.x, pv.x, mv.x, nv.x, tv.x, s, hp);
      update(gv.y, pv.y, mv.y, nv.y, tv.y, s, hp);
      update(gv.z, pv.z, mv.z, nv.z, tv.z, s, hp);
      update(gv.w, pv.w, mv.w, nv.w, tv.w, s, hp);
      __stcs(reinterpret_cast<float4*>(p) + i, pv);
      __stcs(reinterpret_cast<float4*>(mu) + i, mv);
      __stcs(reinterpret_cast<float4*>(nu) + i, nv);
      __stcs(reinterpret_cast<float4*>(t) + i, tv);
    }
    // Ragged tail (only a leaf's last chunk): at most 3 elements.
    if (threadIdx.x < (ch.count & 3)) {
      const int i = n4 * 4 + threadIdx.x;
      float pv = p[i], mv = mu[i], nv = nu[i], tv = t[i];
      update(g != nullptr ? g[i] : 0.f, pv, mv, nv, tv, s, hp);
      p[i] = pv;
      mu[i] = mv;
      nu[i] = nv;
      t[i] = tv;
    }
  }
}

// Blocks of the persistent grid on the current device: SMs x resident
// blocks per SM, asked of the runtime once per device.
cudaError_t persistent_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_adamw_ema_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int lt_fused_adamw_ema(const void* chunks, int n_chunks,
                                  const void* ptrs, const void* scalars,
                                  const void* norm, float max_norm, float b1,
                                  float one_minus_b1, float b2,
                                  float one_minus_b2, float eps,
                                  void* stream) {
  if (n_chunks <= 0) return cudaSuccess;
  int blocks = 0;
  cudaError_t err = persistent_blocks(&blocks);
  if (err != cudaSuccess) return err;
  if (blocks > n_chunks) blocks = n_chunks;
  Hyper hp{b1, one_minus_b1, b2, one_minus_b2, eps};
  fused_adamw_ema_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Chunk*>(chunks), n_chunks,
      static_cast<const unsigned long long*>(ptrs),
      static_cast<const float*>(scalars), static_cast<const float*>(norm),
      max_norm, hp);
  return cudaGetLastError();
}
