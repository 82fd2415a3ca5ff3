// Backward-input of a ResNet bottleneck's 1x1 convolutions, with the ReLU
// mask fused in as a prologue and the residual gradient as an epilogue (bf16
// in and out, fp32 accumulation):
//
//     out[p, :] = (g * mask)[p, :] @ wt  (+ skip[p, :])
//
// Replaces the Pallas TPU kernels _bwd_1x1_kernel (:50) and
// _bwd_1x1_kernel_noskip (:56) of transferattack_tpu/ops/fused_bwd.py,
// entered through fused_bwd_1x1 (:62).  The 3x3 (_bwd_3x3_kernel, :101) is
// csrc/fused_bwd_3x3.cu; bottleneck_bwd_input_pallas (:200) chains them.
//
// Bound: device memory.  At ResNet-50 stage 1 (batch 128, 56x56, bf16,
// M = 401,408 pixels) at the data sheet's 3.35 TB/s:
//     1x1 256->64          reads g and mask (2 x 205.5 MB), writes 51.4 MB:  462 MB, 0.138 ms
//     1x1 64->256 + skip   reads 51.4 + 51.4 + 205.5 MB, writes 205.5 MB:   514 MB, 0.153 ms
// Their products, 13.2 GFLOP each, take 0.013 ms at the 989 TFLOP/s of the
// bf16 tensor cores, so each is bound by the bytes.
//
// Design: one tiled GEMM that fetches each input from device memory once (the
// other column blocks find it in L1 or L2) and writes its output once.  The
// mask multiply happens while a tile is staged into shared memory, and the
// skip is added to the fp32 accumulators before the one rounding to bf16, so
// neither the masked gradient nor an unskipped sum ever goes to device memory.
// A block computes 128 pixels x 64 channels with 8 warps of 16x16x16 bf16
// tensor-core products (nvcuda::wmma); the reduction steps by 32 through two
// shared-memory buffers, and the next step's global loads are in flight in
// registers while the current step multiplies.  Any pixel count runs (a
// masked tail); channel counts are multiples of 8 here and of 16 in the
// wrapper.  TMA, wgmma, deeper pipelines and persistent blocks are left for
// later.  On an H100 80GB HBM3 at 700 W the two run at 1.7x and 1.9x their
// bound (PERF.md).
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (transferattack_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;           // pixels (GEMM rows) per block
constexpr int kBN = 64;            // output channels per block
constexpr int kBK = 32;            // reduction step
constexpr int kThreads = 256;      // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int kAStride = kBK + 8;  // padded row lengths, against bank conflicts
constexpr int kBStride = kBN + 8;
constexpr int kCStride = kBN + 4;
constexpr int kATile = kBM * kAStride;  // bf16 elements per buffer
constexpr int kBTile = kBK * kBStride;
constexpr int kTileBytes = 2 * (kATile + kBTile) * (int)sizeof(bf16);
constexpr int kEpilogueBytes = kBM * kCStride * (int)sizeof(float);
constexpr int kSmemBytes = kTileBytes > kEpilogueBytes ? kTileBytes : kEpilogueBytes;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory");

__device__ __forceinline__ uint4 mul8(uint4 a, uint4 b) {
  // eight bf16 products, each rounded once, as torch and jnp multiply bf16
  uint4 r;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = __hmul2(x[i], y[i]);
  return r;
}

// g, mask: (m, c); w: (c, n); skip (may be null) and out: (m, n).
__global__ void __launch_bounds__(kThreads)
bwd_gemm_kernel(const bf16* __restrict__ g, const bf16* __restrict__ mask,
                const bf16* __restrict__ w, const bf16* __restrict__ skip,
                bf16* __restrict__ out, long m, int c, int n) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // [2][kATile]
  bf16* b_s = a_s + 2 * kATile;               // [2][kBTile]
  float* c_s = reinterpret_cast<float*>(smem);  // the epilogue's, after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_tiles = (n + kBN - 1) / kBN;
  const long m0 = (long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int k_total = c;
  const int steps = (k_total + kBK - 1) / kBK;

  // A staging: this thread carries 8 reduction elements (16 bytes) of tile
  // rows a_row and a_row + 64
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 8;
  long pix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long p = m0 + a_row + 64 * i;
    pix[i] = p < m ? p : -1;
  }
  // B staging: one 16-byte chunk of the (kBK, kBN) weight tile
  const int b_row = tid >> 3;
  const int b_col = (tid & 7) * 8;

  uint4 ra[2], rb;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load = [&](int step) {
    const int k0 = step * kBK;
    const int kk = k0 + a_col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 v = zero;
      if (pix[i] >= 0 && kk < k_total) {
        const size_t off = (size_t)pix[i] * c + kk;
        v = mul8(__ldg(reinterpret_cast<const uint4*>(g + off)),
                 __ldg(reinterpret_cast<const uint4*>(mask + off)));
      }
      ra[i] = v;
    }
    const int kr = k0 + b_row, nc = n0 + b_col;
    rb = (kr < k_total && nc < n)
             ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)kr * n + nc))
             : zero;
  };

  auto store = [&](int buf) {
    bf16* a = a_s + buf * kATile;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(a + (a_row + 64 * i) * kAStride + a_col) = ra[i];
    *reinterpret_cast<uint4*>(b_s + buf * kBTile + b_row * kBStride + b_col) = rb;
  };

  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);  // in flight while this step multiplies
    const bf16* a = a_s + (s & 1) * kATile;
    const bf16* b = b_s + (s & 1) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + 16 * i) * kAStride + kk, kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * kBStride + wn + 16 * j, kBStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other buffer was last read in step s - 1, before the barrier below
    if (s + 1 < steps) store((s + 1) & 1);
    __syncthreads();
  }

  // epilogue: accumulators through shared memory, then rows of 8 channels
  // (16 bytes) with the skip added in fp32 and one rounding to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm + 16 * i) * kCStride + wn + 16 * j, acc[i][j],
                              kCStride, wmma::mem_row_major);
  __syncthreads();
  for (int q = tid; q < kBM * kBN / 8; q += kThreads) {
    const int r = q >> 3, col = (q & 7) * 8;
    const long p = m0 + r;
    const int nc = n0 + col;
    if (p >= m || nc >= n) continue;
    const float* src = c_s + r * kCStride + col;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e];
    const size_t off = (size_t)p * n + nc;
    if (skip != nullptr) {
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(skip + off));
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(s2[e]);
        v[2 * e] += f.x;
        v[2 * e + 1] += f.y;
      }
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + off) = o;
  }
}

}  // namespace

// g, mask: (m, cout); wt: (cout, cin); skip (or null) and out: (m, cin).
extern "C" int fused_bwd_1x1_bf16(const void* g, const void* mask, const void* wt,
                                  const void* skip, void* out, long m, int cout, int cin,
                                  void* stream) {
  if (m <= 0) return 0;
  const long blocks = ((m + kBM - 1) / kBM) * ((cin + kBN - 1) / kBN);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  bwd_gemm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(wt), static_cast<const bf16*>(skip), static_cast<bf16*>(out),
      m, cout, cin);
  return (int)cudaGetLastError();
}
