// Fused AdamW + EMA-teacher update of one parameter leaf, in place (K3).
//
// Replaces lightly_train_tpu/_optim/fused_update.py::_kernel. Per element:
//   g' = g * cs
//   mu' = b1 * mu + (1 - b1) * g'
//   nu' = b2 * nu + (1 - b2) * g'^2
//   p'  = p - a * (mu' * bc1 / (sqrt(nu' * bc2) + eps) + wd * p)
//   t'  = m * t + (1 - m) * p'
// The per-leaf scalars (cs, bc1, bc2, a, wd, m) are read from a small device
// array, as the TPU kernel reads its (1, 8) scalar block, so the host never
// waits on the device (the clip scale comes from a grad norm computed on the
// card). p, mu, nu and t are overwritten in place, as the TPU kernel aliases
// its outputs to its inputs.
//
// What bounds it on the H100: 5 fp32 reads and 4 fp32 writes per element,
// no reuse, ~15 flops: pure device-memory traffic (36 bytes per parameter).
// The design is a grid-stride loop over 16-byte vectors so every access is
// a full coalesced 128-bit transaction; one launch per leaf (a multi-tensor
// launch over all leaves is later work).
#include <cuda_runtime.h>

namespace {

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

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

__global__ void fused_adamw_ema_kernel(const float* __restrict__ g,
                                       float* __restrict__ p,
                                       float* __restrict__ mu,
                                       float* __restrict__ nu,
                                       float* __restrict__ t,
                                       const float* __restrict__ scalars,
                                       long n, Hyper hp) {
  __shared__ float s[6];
  if (threadIdx.x < 6) s[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();
  const long n4 = n / 4;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < n4; i += stride) {
    float4 gv = reinterpret_cast<const float4*>(g)[i];
    float4 pv = reinterpret_cast<float4*>(p)[i];
    float4 mv = reinterpret_cast<float4*>(mu)[i];
    float4 nv = reinterpret_cast<float4*>(nu)[i];
    float4 tv = reinterpret_cast<float4*>(t)[i];
    update(gv.x, pv.x, mv.x, nv.x, tv.x, s, hp);
    update(gv.y, pv.y, mv.y, nv.y, tv.y, s, hp);
    update(gv.z, pv.z, mv.z, nv.z, tv.z, s, hp);
    update(gv.w, pv.w, mv.w, nv.w, tv.w, s, hp);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(mu)[i] = mv;
    reinterpret_cast<float4*>(nu)[i] = nv;
    reinterpret_cast<float4*>(t)[i] = tv;
  }
  // Ragged tail (n not a multiple of 4): at most 3 elements.
  for (long i = n4 * 4 + blockIdx.x * static_cast<long>(blockDim.x) +
                threadIdx.x;
       i < n; i += stride) {
    float pv = p[i], mv = mu[i], nv = nu[i], tv = t[i];
    update(g[i], pv, mv, nv, tv, s, hp);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = nv;
    t[i] = tv;
  }
}

}  // namespace

extern "C" int lt_fused_adamw_ema(const void* g, void* p, void* mu, void* nu,
                                  void* t, const void* scalars, long n,
                                  float b1, float one_minus_b1, float b2,
                                  float one_minus_b2, float eps,
                                  void* stream) {
  constexpr int kThreads = 256;
  // Enough blocks to fill 132 SMs several times over; the loop strides on.
  long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  Hyper hp{b1, one_minus_b1, b2, one_minus_b2, eps};
  fused_adamw_ema_kernel<<<static_cast<int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(p),
      static_cast<float*>(mu), static_cast<float*>(nu), static_cast<float*>(t),
      static_cast<const float*>(scalars), n, hp);
  return cudaGetLastError();
}
