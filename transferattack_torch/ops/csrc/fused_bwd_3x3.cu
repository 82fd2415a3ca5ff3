// Backward-input of a SAME, stride-1 3x3 convolution with the ReLU mask fused
// in (bf16 in and out, fp32 sums):
//
//     out[b, y, x, :] = sum over taps (dy, dx) and channels c of
//                       (g * mask)[b, y + dy - 1, x + dx - 1, c] * w_col[(3 dy + dx) C + c, :]
//
// where a pixel outside the image reads as zero.  g and mask are (B, H, W, C),
// w_col is (9 C, N) tap-major (the forward kernel flipped and transposed),
// out is (B, H, W, N).
//
// Replaces the Pallas TPU kernel _bwd_3x3_kernel of
// transferattack_tpu/ops/fused_bwd.py (:101), entered through fused_bwd_3x3
// (:115).
//
// Bound, at ResNet-50's stride-1 3x3s, batch 128, inputs and output once, on
// an H100 at the data sheet's 3.35 TB/s and 989 TFLOP/s (bf16):
//     stage 1, 56x56,  64 ->  64: 154.2 MB, 0.0460 ms; 29.6 GFLOP, 0.0299 ms: bytes
//     stage 2, 28x28, 128 -> 128:  77.4 MB, 0.0231 ms; 29.6 GFLOP, 0.0299 ms: operations
//     stage 3, 14x14, 256 -> 256:  39.7 MB, 0.0119 ms; 29.6 GFLOP, 0.0299 ms: operations
//     stage 4,  7x 7, 512 -> 512:  24.0 MB, 0.0072 ms; 29.6 GFLOP, 0.0299 ms: operations
//
// Design.  Gathering each tap's shifted tile from device memory reads every
// pixel nine times through L2.  Instead, as the TPU kernel pads g * mask once
// into VMEM, a block stages g * mask once per 64-channel chunk of the reduction
// into a halo tile in shared memory and runs the nine taps from there:
//   - A block computes 256 consecutive flattened pixels p0 .. p0 + 255 (any B,
//     H and W; the last block is masked) x 64 output channels.  Its halo holds
//     the flattened pixels [p0 - W - 1, p0 + 256 + W + 1): every pixel a tap of
//     the block can reach.  Each is read once as 16 bytes of g and of mask and
//     multiplied with __hmul2 (one bf16 rounding, as torch and jnp multiply
//     bf16); pixels outside [0, M) are stored as zero.  Rows are padded to 72
//     channels (144 bytes) so that ldmatrix is free of bank conflicts, and one
//     more row holds zeros.
//   - A tap's A operand is read in place by ldmatrix.x4, one row address per
//     lane: output pixel p reads halo row (p - p0) + dy W + dx when its source
//     pixel lies inside the image and p < M, else the zero row.  That covers the
//     image edge, the wrap of x into the next row, blocks that span images and
//     the ragged tail, with no predicate in the inner loop and no im2col or
//     padded copy in device memory.  Each lane's y and x are computed once per
//     block.
//   - The weights of a (tap, chunk), 64 x 64 bf16 = 8 KB, come through a ring
//     of cp.async stages, so the next tap's weights arrive while this tap
//     multiplies; they are read with ldmatrix.trans.
//   - 8 warps of 64 x 32 each run mma.sync m16n8k16 bf16 with fp32 sums.  The
//     sums leave through shared memory (the halo's space) as 16-byte bf16
//     stores.
// L2->SM traffic at stage 1 falls from 925 MB (nine gathers) to about 264 MB:
// 1,568 blocks x 370 halo rows x 256 B, plus 1,568 x 73.7 KB of weights.
// Channel counts are multiples of 16 (a partial chunk runs fewer k-steps, a
// partial block of output channels is masked).  The halo needs
// (256 + 2 W + 3) x 144 + 18,432 bytes, within the 232,448 a block can have up
// to W = 613; fused_bwd_3x3_bf16 refuses wider images and the wrapper raises.
//
// On an H100 80GB HBM3 at 700 W it takes 0.146 ms at stage 1 (3.2x its bound,
// twice as fast as the gathering kernel it replaced, 1.7x one cuDNN
// convolution) and 0.127 to 0.150 ms at stages 2-4 (PERF.md): every stage
// runs its 29.6 GFLOP at 197 to 234 TFLOP/s, so the tap loop's rate, not the
// halo traffic, is the limit.  128-pixel blocks, 64 x 64 warp tiles and an L2
// prefetch of the next wave's halo were timed against this design and did not
// lift it at every stage (PERF.md).
//
// Plain C entry point, built with nvcc into a shared library of its own and
// called through ctypes (transferattack_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 256;                    // flattened pixels per block
constexpr int kBN = 64;                     // output channels per block
constexpr int kBK = 64;                     // reduction channels per chunk
constexpr int kStages = 2;                  // weight ring depth
constexpr int kWN = 32;                     // a warp's tile: 64 pixels x kWN channels
constexpr int kWarpsM = kBM / 64;
constexpr int kThreads = kWarpsM * (kBN / kWN) * 32;  // 8 warps
constexpr int kRow = kBK + 8;               // halo and ring row, in elements
constexpr int kRowBytes = kRow * 2;         // 144
constexpr int kRingBytes = kStages * kBK * kRowBytes;
constexpr int kCStride = kBN + 4;           // fp32 epilogue row
constexpr int kEpilogueBytes = kBM * kCStride * 4;
constexpr int kMaxSmem = 232448;            // what a block can have on sm_90

__host__ __device__ constexpr int halo_rows(int wd) { return kBM + 2 * wd + 2; }

__host__ __device__ constexpr long smem_bytes(int wd) {
  // the halo, its zero row, then the ring; the epilogue reuses the start
  return (long)(halo_rows(wd) + 1) * kRowBytes + kRingBytes > kEpilogueBytes
             ? (long)(halo_rows(wd) + 1) * kRowBytes + kRingBytes
             : kEpilogueBytes;
}
static_assert(smem_bytes(56) == 71856, "the halo at stage 1");
static_assert(smem_bytes(613) <= kMaxSmem && smem_bytes(614) > kMaxSmem, "W <= 613");

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes = 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// g, mask: (m, c) = (B, h, wd, c) flattened; w: (9 c, n); out: (m, n).
__global__ void __launch_bounds__(kThreads, 2)
bwd_3x3_halo_kernel(const bf16* __restrict__ g, const bf16* __restrict__ mask,
                    const bf16* __restrict__ w, bf16* __restrict__ out, long m, int c, int n,
                    int h, int wd) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = halo_rows(wd);
  bf16* halo = reinterpret_cast<bf16*>(smem);           // [rows + 1][kRow], last row zero
  unsigned char* ring = smem + (rows + 1) * kRowBytes;  // [kStages][kBK][kRow]
  float* c_s = reinterpret_cast<float*>(smem);          // the epilogue's, after the loop

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (n + kBN - 1) / kBN;
  const long p0 = (long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int wm = (warp % kWarpsM) * 64;
  const int wn = (warp / kWarpsM) * kWN;
  const int chunks = (c + kBK - 1) / kBK;
  const int steps = 9 * chunks;  // (chunk, tap) pairs, tap fastest
  const uint4 zero = make_uint4(0, 0, 0, 0);

  if (tid < kBK / 8) reinterpret_cast<uint4*>(halo + rows * kRow)[tid] = zero;

  // the rows this lane addresses in ldmatrix: pixel wm + 16 i + (lane & 15)
  // of the block; which of its taps fall inside the image, as bits
  // 1 (p < m), 2 (y > 0), 4 (y < h - 1), 8 (x > 0), 16 (x < wd - 1)
  int a_row[4], a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_row[i] = wm + 16 * i + (lane & 15);
    const long p = p0 + a_row[i];
    a_ok[i] = 0;
    if (p < m) {
      const long rem = p % ((long)h * wd);
      const int y = (int)(rem / wd), x = (int)(rem % wd);
      a_ok[i] = 1 | (y > 0 ? 2 : 0) | (y < h - 1 ? 4 : 0) | (x > 0 ? 8 : 0) |
                (x < wd - 1 ? 16 : 0);
    }
  }
  const uint32_t halo_s = smem_addr(halo);
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t a_col = (lane >> 4) * 16;  // bytes: k 0-7 or 8-15 of a k-step

  // the weights of step s, (tap t, chunk k): w rows t c + k kBK + [0, kc),
  // columns n0 + [0, kBN), into ring stage s % kStages
  auto load_weights = [&](int s) {
    if (s < steps) {
      const int k0 = (s / 9) * kBK, t = s % 9;
      const int kc = min(kBK, c - k0);
      const uint32_t dst = ring_s + (s % kStages) * kBK * kRowBytes;
#pragma unroll
      for (int v = tid; v < kBK * kBN / 8; v += kThreads) {
        const int kr = v >> 3, col = (v & 7) * 8;
        if (kr < kc) {
          const bool in = n0 + col < n;
          cp_async16(dst + kr * kRowBytes + col * 2,
                     in ? w + (size_t)(t * c + k0 + kr) * n + n0 + col : w, in ? 16 : 0);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float acc[4][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_weights(s);

  for (int k0 = 0; k0 < c; k0 += kBK) {
    const int kc = min(kBK, c - k0);
    if (k0 > 0) __syncthreads();  // the last chunk's taps are done with the halo
    {
      // g * mask for halo rows [0, rows) and channels k0 + [0, kc), four
      // 16-byte loads of each in flight per thread
      constexpr int kBatch = 4;
      const int vpr = kc >> 3;
      const int nvec = rows * vpr;
      const long first = p0 - wd - 1;
      for (int base = tid; base < nvec; base += kBatch * kThreads) {
        uint4 gv[kBatch], mv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          gv[u] = mv[u] = zero;
          const int v = base + u * kThreads;
          if (v < nvec) {
            const int r = v / vpr;
            const long p = first + r;
            if (p >= 0 && p < m) {
              const size_t off = (size_t)p * c + k0 + (v - r * vpr) * 8;
              gv[u] = __ldg(reinterpret_cast<const uint4*>(g + off));
              mv[u] = __ldg(reinterpret_cast<const uint4*>(mask + off));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int v = base + u * kThreads;
          if (v < nvec) {
            const int r = v / vpr;
            *reinterpret_cast<uint4*>(halo + r * kRow + (v - r * vpr) * 8) = mul8(gv[u], mv[u]);
          }
        }
      }
    }

    for (int t = 0; t < 9; ++t) {
      const int s = (k0 / kBK) * 9 + t;
      cp_async_wait<kStages - 2>();  // this step's weights have landed
      __syncthreads();               // for every thread; the halo too, and the
                                     // stage refilled below was read a step ago
      load_weights(s + kStages - 1);

      const int dy = t / 3, dx = t - 3 * (t / 3);
      const int need = 1 | (dy == 0 ? 2 : 0) | (dy == 2 ? 4 : 0) | (dx == 0 ? 8 : 0) |
                       (dx == 2 ? 16 : 0);
      uint32_t a_addr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (a_ok[i] & need) == need ? a_row[i] + dy * wd + dx : rows;
        a_addr[i] = halo_s + r * kRowBytes + a_col;
      }
      const uint32_t b_addr = ring_s + (s % kStages) * kBK * kRowBytes +
                              (lane & 15) * kRowBytes + (wn + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk * 16 >= kc) break;
        uint32_t a[4][4], b[kWN / 16][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], a_addr[i] + kk * 32);
#pragma unroll
        for (int j = 0; j < kWN / 16; ++j)
          ldmatrix_x4_trans(b[j], b_addr + kk * 16 * kRowBytes + j * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kWN / 8; ++j)
            mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }

  // epilogue: the sums through shared memory, then rows of 8 channels as
  // 16-byte bf16 stores
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int r = wm + 16 * i + (lane >> 2);
      const int col = wn + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(c_s + r * kCStride + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c_s + (r + 8) * kCStride + col) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  for (int q = tid; q < kBM * kBN / 8; q += kThreads) {
    const int r = q >> 3, col = (q & 7) * 8;
    const long p = p0 + r;
    const int nc = n0 + col;
    if (p >= m || nc >= n) continue;
    const float* src = c_s + r * kCStride + col;
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + (size_t)p * n + nc) = o;
  }
}

}  // namespace

// g, mask: (b, h, w, cout); w_col: (9 * cout, cin), tap-major; out: (b, h, w, cin).
// Channel counts are multiples of 16 and w is at most 613 (the halo's shared
// memory); anything else returns cudaErrorInvalidValue without a launch.
extern "C" int fused_bwd_3x3_bf16(const void* g, const void* mask, const void* w_col,
                                  void* out, int b, int h, int w, int cout, int cin,
                                  void* stream) {
  const long m = (long)b * h * w;
  if (m <= 0) return 0;
  if (cout <= 0 || cout % 16 || cin <= 0 || cin % 16) return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes(w);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long blocks = ((m + kBM - 1) / kBM) * ((cin + kBN - 1) / kBN);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_3x3_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_3x3_halo_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(w_col), static_cast<bf16*>(out), m, cout, cin, h, w);
  return (int)cudaGetLastError();
}
