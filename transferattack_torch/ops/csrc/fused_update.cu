// Fused sign step + eps-ball + image-bound projection for sign-based attacks:
//
//     out = clip(x + clip(delta + alpha * sign(m), -eps, eps), lo, hi) - x
//
// Replaces the Pallas TPU kernel transferattack_tpu/ops/pallas_update.py:_kernel
// (entered through fused_sign_update).
//
// Bound: device memory.  Each element reads delta, m and x and writes out,
// 16 bytes of fp32 traffic and a handful of flops.  At the main-path shape
// (128, 224, 224, 3) that is about 308 MB per call, about 92 us at the
// H100's 3.35 TB/s.  The design is one pass: 16-byte (float4) loads and
// stores where all four pointers are 16-byte aligned, a grid-stride loop, and
// a scalar tail, so any element count runs here (the Pallas kernel needed a
// multiple of its (512, 128) tile).  Written as plain torch ops the same
// update makes about six passes over device memory.
//
// alpha, eps, lo and hi arrive as fp32, as JAX and PyTorch round them, so
// alpha * sign(m) is exact and the result equals the plain version bit for
// bit.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (transferattack_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 65535;

__device__ __forceinline__ float update_one(float d, float m, float x, float alpha,
                                            float eps, float lo, float hi) {
  const float s = (m > 0.f) ? 1.f : ((m < 0.f) ? -1.f : 0.f);
  const float stepped = fminf(fmaxf(d + alpha * s, -eps), eps);
  return fminf(fmaxf(x + stepped, lo), hi) - x;
}

__global__ void __launch_bounds__(kThreads)
fused_sign_update_kernel(const float* __restrict__ delta, const float* __restrict__ m,
                         const float* __restrict__ x, float* __restrict__ out,
                         long n, bool vec, float alpha, float eps, float lo,
                         float hi) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  const long n_vec = vec ? n / 4 : 0;
  const float4* d4 = reinterpret_cast<const float4*>(delta);
  const float4* m4 = reinterpret_cast<const float4*>(m);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long i = tid; i < n_vec; i += stride) {
    const float4 d = d4[i], g = m4[i], v = x4[i];
    float4 r;
    r.x = update_one(d.x, g.x, v.x, alpha, eps, lo, hi);
    r.y = update_one(d.y, g.y, v.y, alpha, eps, lo, hi);
    r.z = update_one(d.z, g.z, v.z, alpha, eps, lo, hi);
    r.w = update_one(d.w, g.w, v.w, alpha, eps, lo, hi);
    o4[i] = r;
  }
  // the elements the float4 loop did not cover: all of them when a pointer
  // is misaligned, else fewer than four
  for (long i = 4 * n_vec + tid; i < n; i += stride) {
    out[i] = update_one(delta[i], m[i], x[i], alpha, eps, lo, hi);
  }
}

}  // namespace

extern "C" int fused_sign_update_f32(const float* delta, const float* m, const float* x,
                                     float* out, long n, float alpha, float eps,
                                     float lo, float hi, void* stream) {
  if (n <= 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(delta) | reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
                    15) == 0;
  const long work = vec ? (n + 3) / 4 : n;
  long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_sign_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      delta, m, x, out, n, vec, alpha, eps, lo, hi);
  return (int)cudaGetLastError();
}
