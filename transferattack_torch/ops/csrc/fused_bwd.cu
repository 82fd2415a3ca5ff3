// Backward-input of a ResNet bottleneck's 1x1 convolutions, with the ReLU
// mask fused in as a prologue and the residual gradient as an epilogue (bf16
// in and out, fp32 sums):
//
//     out[p, :] = (g * mask)[p, :] @ wt  (+ skip[p, :])
//
// and, on request, g * mask itself as a second output (gm_out), which the
// bottleneck's chain takes as its skip.
//
// Replaces the Pallas TPU kernels _bwd_1x1_kernel (:50) and
// _bwd_1x1_kernel_noskip (:56) of transferattack_tpu/ops/fused_bwd.py,
// entered through fused_bwd_1x1 (:62).  The 3x3 (_bwd_3x3_kernel, :101) is
// csrc/fused_bwd_3x3.cu; bottleneck_bwd_input_pallas (:200) chains them.
//
// Bound: device memory.  At ResNet-50 stage 1 (batch 128, 56x56, bf16,
// M = 401,408 pixels) at the data sheet's 3.35 TB/s, inputs read once and
// outputs written once:
//     1x1 256->64            g, mask 2 x 205.5 MB in, 51.4 MB out:          462.4 MB, 0.1380 ms
//     1x1 256->64 + gm_out   and g * mask, 205.5 MB, out:                   667.9 MB, 0.1994 ms
//     1x1 64->256 + skip     51.4 + 51.4 + 205.5 MB in, 205.5 MB out:      513.8 MB, 0.1534 ms
// Their products, 13.2 GFLOP each, take 0.013 ms at the 989 TFLOP/s of the
// bf16 tensor cores: 28 operations a byte against the card's 295, so bytes in
// flight, and each byte read once, are all that matters.
//
// Design: a persistent, multi-stage cp.async GEMM.
//   - One block of 8 warps per SM (grid = min(tiles, SMs)) walks the tiles
//     t = block, block + grid, ...  Tile t is m-tile t / n_tiles and n-tile
//     t % n_tiles, so the n-tiles of one m-tile run at once on neighbouring
//     SMs and share g and mask through L2.
//   - A tile is 128 pixels x BN output channels, BN = 64 when cin <= 64 and
//     128 above (two instances each, with and without skip); warps are 4 (M)
//     x 2 (N), a warp tile 32 x BN/2.  The reduction steps by 64 channels, so
//     each pixel's chunk is one 128-byte row.
//   - A ring of S stages runs over the block's whole sequence of (tile,
//     k-step) pairs, so the next tile's loads are in flight while this one
//     multiplies and stores.  A stage holds the g and mask chunks (128 rows
//     padded to 72 channels, 144 bytes, so ldmatrix has no bank conflicts),
//     the weight chunk wt[k0 : k0 + 64, n0 : n0 + BN] (rows padded by 8) and,
//     with a skip, the skip tile (128 x BN, unpadded, its 16-byte chunks
//     XOR-swizzled by row), filled on a tile's last k-step only.  Everything
//     arrives by cp.async.cg, 16 bytes a copy, one commit group a stage, with
//     rows >= M and channels past the end zero-filled.  S = floor(200 KB /
//     stage bytes): 4 for BN = 64 without skip (46,080 B a stage), 2 for
//     BN = 128 with skip (87,040 B).
//   - After cp.async.wait_group each thread's own copies are visible to it:
//     it multiplies the 16-byte chunks of g and mask it copied with __hmul2
//     (one bf16 rounding, as torch and jnp multiply bf16), writes the product
//     over g's chunk and, on n-tile 0 when gm_out is given, stores the same 16
//     bytes to gm_out.  Then the one barrier the stage needs anyway, and the
//     warps' ldmatrix (x4 for g * mask, x4.trans for the weights) and
//     mma.sync m16n8k16 bf16 with fp32 sums.
//   - Epilogue: the skip is added in fp32 from the stage's skip slot before
//     the one rounding to bf16, the tile is staged through the stage's g and
//     mask slots and written as 16-byte rows.  No global load sits in it.
// Any M (the last m-tile is masked); channel counts are multiples of 16 (a
// partial k-step runs fewer 16-wide products, a partial n-tile is masked).
//
// On an H100 80GB HBM3 at 700 W (PERF.md, final run of the redesign) the
// three launches above take 0.1782, 0.2598 and 0.1928 ms: 2.6 to 2.7 TB/s,
// and 1.3 to 1.5x faster than the wmma kernel this replaces.  The
// bottleneck chain they serve takes 0.6051 ms against 0.878 before.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (transferattack_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                // pixels (GEMM rows) per tile
constexpr int kBK = 64;                 // reduction channels per k-step
constexpr int kThreads = 256;           // 8 warps: 4 along M x 2 along N
constexpr int kRow = kBK + 8;           // g and mask rows, elements (144 bytes)
constexpr int kStageBudget = 200 * 1024;
constexpr int kMaxSmem = 232448;        // what a block can have on sm_90

// the shared memory of one instance: BN output channels a tile, a skip or not
template <int BN, bool SKIP>
struct Plan {
  static constexpr int kWRow = BN + 8;                   // weight and output rows, elements
  static constexpr int kGBytes = kBM * kRow * 2;         // g or mask: 18,432
  static constexpr int kWBytes = kBK * kWRow * 2;        // weights
  static constexpr int kSkipBytes = SKIP ? kBM * BN * 2 : 0;
  static constexpr int kStageBytes = 2 * kGBytes + kWBytes + kSkipBytes;
  static constexpr int kStages =
      kStageBudget / kStageBytes < 2 ? 2 : kStageBudget / kStageBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};
// the chain's two launches: 256 -> 64 (BN 64, no skip), 64 -> 256 (BN 128, skip)
static_assert(Plan<64, false>::kStageBytes == 46080 && Plan<64, false>::kStages == 4 &&
                  Plan<64, false>::kSmem == 184320, "the chain's first launch");
static_assert(Plan<128, true>::kStageBytes == 87040 && Plan<128, true>::kStages == 2 &&
                  Plan<128, true>::kSmem == 174080, "the chain's last launch");
static_assert(Plan<64, true>::kSmem <= kMaxSmem && Plan<128, false>::kSmem <= kMaxSmem,
              "the other two instances");
// the epilogue stages a bf16 tile over a stage's g and mask slots
static_assert(kBM * Plan<128, true>::kWRow * 2 <= 2 * Plan<128, true>::kGBytes, "epilogue");

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

// g, mask, gm_out (may be null): (m, c); wt: (c, n); skip (SKIP only) and
// out: (m, n).  A stage is [g | mask | weights | skip]; tiles < 2^31.
template <int BN, bool SKIP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_1x1_kernel(const bf16* __restrict__ g, const bf16* __restrict__ mask,
               const bf16* __restrict__ wt, const bf16* __restrict__ skip,
               bf16* __restrict__ gm_out, bf16* __restrict__ out, long m, int c, int n) {
  using P = Plan<BN, SKIP>;
  constexpr int S = P::kStages;
  constexpr int kWN = BN / 2;   // a warp's columns
  constexpr int kNT = kWN / 8;  // its n8 tiles
  constexpr int kChunks = BN / 8;  // 16-byte chunks in a weight, skip or output row
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = (int)((m + kBM - 1) / kBM) * n_tiles;
  const int ksteps = (c + kBK - 1) / kBK;
  const int steps = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * ksteps;
  // this thread's 16-byte chunks of g and mask in a stage: rows c_row + 32 j,
  // channels c_col + [0, 8); eight threads cover a 128-byte row
  const int c_row = tid >> 3;
  const int c_col = (tid & 7) * 8;
  const uint32_t smem_s = smem_addr(smem);

  // the loads of step i (the block's i-th (tile, k-step) pair, in order)
  // into stage i % S; one commit group a step, empty past the end
  int ld_i = 0, ld_t = blockIdx.x, ld_ks = 0;
  auto load_next = [&]() {
    if (ld_i < steps) {
      const long m0 = (long)(ld_t / n_tiles) * kBM;
      const int n0 = (ld_t % n_tiles) * BN;
      const int k0 = ld_ks * kBK;
      const uint32_t st = smem_s + (ld_i % S) * P::kStageBytes;
      const bool k_in = k0 + c_col < c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = c_row + 32 * j;
        const bool in = k_in && m0 + r < m;
        const size_t off = in ? (size_t)(m0 + r) * c + k0 + c_col : 0;
        const uint32_t dst = st + (r * kRow + c_col) * 2;
        cp_async16(dst, g + off, in ? 16 : 0);
        cp_async16(dst + P::kGBytes, mask + off, in ? 16 : 0);
      }
#pragma unroll
      for (int v = tid; v < kBK * kChunks; v += kThreads) {
        const int kr = v / kChunks, col = (v % kChunks) * 8;
        const bool in = k0 + kr < c && n0 + col < n;
        cp_async16(st + 2 * P::kGBytes + (kr * P::kWRow + col) * 2,
                   in ? wt + (size_t)(k0 + kr) * n + n0 + col : wt, in ? 16 : 0);
      }
      if constexpr (SKIP) {
        if (ld_ks == ksteps - 1) {
#pragma unroll
          for (int v = tid; v < kBM * kChunks; v += kThreads) {
            const int r = v / kChunks, q = v % kChunks;
            const bool in = m0 + r < m && n0 + q * 8 < n;
            cp_async16(st + 2 * P::kGBytes + P::kWBytes + r * BN * 2 + ((q ^ (r & 7)) * 16),
                       in ? skip + (size_t)(m0 + r) * n + n0 + q * 8 : skip, in ? 16 : 0);
          }
        }
      }
      ++ld_i;
      if (++ld_ks == ksteps) {
        ld_ks = 0;
        ld_t += gridDim.x;
      }
    }
    cp_async_commit();
  };

  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * kWN;
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) load_next();

  int t = blockIdx.x, ks = 0;
  for (int i = 0; i < steps; ++i) {
    const long m0 = (long)(t / n_tiles) * kBM;
    const int n0 = (t % n_tiles) * BN;
    const int k0 = ks * kBK;
    unsigned char* st = smem + (i % S) * P::kStageBytes;
    bf16* gs = reinterpret_cast<bf16*>(st);
    const bf16* ms = reinterpret_cast<const bf16*>(st + P::kGBytes);

    cp_async_wait<S - 2>();  // this thread's copies of step i have landed
    {
      // g * mask over g's chunks, by the thread that copied them; n-tile 0
      // also writes it out
      const bool to_gm = gm_out != nullptr && n0 == 0 && k0 + c_col < c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = c_row + 32 * j;
        uint4* gp = reinterpret_cast<uint4*>(gs + r * kRow + c_col);
        const uint4 prod = mul8(*gp, *reinterpret_cast<const uint4*>(ms + r * kRow + c_col));
        *gp = prod;
        if (to_gm && m0 + r < m)
          *reinterpret_cast<uint4*>(gm_out + (size_t)(m0 + r) * c + k0 + c_col) = prod;
      }
    }
    __syncthreads();  // every product is in place, and stage (i - 1) % S,
                      // read in step i - 1, is free for step i + S - 1
    load_next();

    const uint32_t a_addr = smem_addr(gs) + ((wm + (lane & 15)) * kRow + (lane >> 4) * 8) * 2;
    const uint32_t b_addr = smem_addr(st + 2 * P::kGBytes) +
                            ((lane & 15) * P::kWRow + wn + (lane >> 4) * 8) * 2;
    const int kc = min(kBK, c - k0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk * 16 >= kc) break;
      uint32_t a[2][4], b[kNT / 2][4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) ldmatrix_x4(a[i2], a_addr + i2 * 16 * kRow * 2 + kk * 32);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        ldmatrix_x4_trans(b[j], b_addr + kk * 16 * P::kWRow * 2 + j * 32);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i2][j], a[i2], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }

    if (++ks < ksteps) continue;

    // epilogue of tile t: the skip added in fp32 and one rounding to bf16,
    // staged over this stage's g and mask slots, then 16-byte rows out
    __syncthreads();  // every warp is done reading this stage
    bf16* os = gs;    // [kBM][kWRow]
    const unsigned char* sk = st + 2 * P::kGBytes + P::kWBytes;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * i2 + 8 * h + (lane >> 2);
          const int col = wn + 8 * j + 2 * (lane & 3);
          float v0 = acc[i2][j][2 * h], v1 = acc[i2][j][2 * h + 1];
          if constexpr (SKIP) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                sk + r * BN * 2 + (((col >> 3) ^ (r & 7)) * 16) + (col & 7) * 2));
            v0 += f.x;
            v1 += f.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(os + r * P::kWRow + col) =
              __floats2bfloat162_rn(v0, v1);
          acc[i2][j][2 * h] = acc[i2][j][2 * h + 1] = 0.0f;
        }
    __syncthreads();
#pragma unroll
    for (int v = tid; v < kBM * kChunks; v += kThreads) {
      const int r = v / kChunks, col = (v % kChunks) * 8;
      if (m0 + r < m && n0 + col < n)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * n + n0 + col) =
            *reinterpret_cast<const uint4*>(os + r * P::kWRow + col);
    }
    ks = 0;
    t += gridDim.x;
  }
  cp_async_wait<0>();
}

// the SM count of the current device, read once per device
cudaError_t sm_count(int* count) {
  static int cached[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *count = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *count;
  return err;
}

template <int BN, bool SKIP>
int launch(const bf16* g, const bf16* mask, const bf16* wt, const bf16* skip, bf16* gm_out,
           bf16* out, long m, int cout, int cin, cudaStream_t stream) {
  using P = Plan<BN, SKIP>;
  const long tiles = ((m + kBM - 1) / kBM) * ((cin + BN - 1) / BN);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_1x1_kernel<BN, SKIP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  bwd_1x1_kernel<BN, SKIP><<<grid, kThreads, P::kSmem, stream>>>(g, mask, wt, skip, gm_out,
                                                                   out, m, cout, cin);
  return (int)cudaGetLastError();
}

}  // namespace

// g, mask and gm_out: (m, cout); wt: (cout, cin); skip and out: (m, cin).
// skip and gm_out may be null.  Channel counts are multiples of 16, else
// cudaErrorInvalidValue without a launch.
extern "C" int fused_bwd_1x1_bf16(const void* g, const void* mask, const void* wt,
                                  const void* skip, void* gm_out, void* out, long m, int cout,
                                  int cin, void* stream) {
  if (cout <= 0 || cout % 16 || cin <= 0 || cin % 16) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const bf16* gp = static_cast<const bf16*>(g);
  const bf16* mp = static_cast<const bf16*>(mask);
  const bf16* wp = static_cast<const bf16*>(wt);
  const bf16* sp = static_cast<const bf16*>(skip);
  bf16* gmp = static_cast<bf16*>(gm_out);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin <= 64)
    return sp ? launch<64, true>(gp, mp, wp, sp, gmp, op, m, cout, cin, s)
              : launch<64, false>(gp, mp, wp, sp, gmp, op, m, cout, cin, s);
  return sp ? launch<128, true>(gp, mp, wp, sp, gmp, op, m, cout, cin, s)
            : launch<128, false>(gp, mp, wp, sp, gmp, op, m, cout, cin, s);
}
