// Fused AdaLN block body: LayerNorm -> modulate -> SiLU -> dense, hand-written
// for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/adaln_pallas.py::_adaln_kernel (public entry
// adaln_dense). For h [B, T, D], per-batch scale and shift [B, D], the shared
// LayerNorm parameters [D] and the output projection w [D, Dout], b [Dout]:
//
//   n   = LayerNorm(h) (f32 statistics, eps 1e-6)
//   act = silu(n * (1 + scale) + shift)        f32, rounded once to w's dtype
//   out = act . w + b                          f32 sums, rounded once
//
// What bounds it on the card: device memory. At the flagship (B*T = 6272
// rows, D = Dout = 512, bf16) it reads h and writes out, 12.8 MB, plus w
// (0.5 MB): 4.0 us at 3.35 TB/s, against 3.29 GFLOP, 3.3 us at 989 TFLOP/s on
// the tensor cores. The TPU kernel's point holds here too: the normalised,
// modulated activations never reach device memory.
//
// Design (a simple first version, no TMA or wgmma): one block of 8 warps per
// 32-row tile of [B*T, D] (196 blocks at the flagship, two per SM). Each warp
// runs the row prologue for 4 rows (statistics by shuffles, all in f32) and
// writes the activations, rounded to w's dtype, into shared memory. The block
// then walks Dout in column chunks, staging each chunk of w through one shared
// buffer: bf16 multiplies on the tensor cores (mma.sync m16n8k16, f32 sums,
// the fragment packing of moe_dense_fused.cu, rows padded so every fragment
// load hits 32 banks); f32 with IEEE FMAs, not TF32, as the TPU kernel sums in
// f32. The bias is added to the f32 sum and the result rounded once. Every
// block re-reads w from L2 (0.5 MB a block at the flagship).

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kAdTile = 32;      // rows per block
constexpr int kAdThreads = 256;  // 8 warps
constexpr int kAdRowsPerWarp = kAdTile / (kAdThreads / 32);

// The prologue of one row, one warp: lane l holds columns [l*C, l*C + C).
// A row past the end (`valid` false, the same for the whole warp) is zeros.
template <typename T, int C>
__device__ __forceinline__ void adaln_row(const T* __restrict__ src,
                                          const T* __restrict__ scale,
                                          const T* __restrict__ shift,
                                          bool valid, const float (&g)[C],
                                          const float (&beta)[C], int lane,
                                          float (&a)[C]) {
  constexpr float kInvD = 1.0f / float(C * 32);
  if (!valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = 0.f;
    return;
  }
  float x[C];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = to_f32(src[lane * C + c]);
    s += x[c];
  }
  const float mu = warp_sum(s) * kInvD;
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float d = x[c] - mu;
    v = fmaf(d, d, v);
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) * kInvD + kLnEps);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float n = (x[c] - mu) * inv * g[c] + beta[c];
    const float m = n * (1.f + to_f32(scale[lane * C + c])) +
                    to_f32(shift[lane * C + c]);
    a[c] = m * (1.f / (1.f + expf(-m)));  // silu
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kAdChunkBf16 = 64;  // output columns per chunk

// Shared memory in 32-bit words, each two bf16 neighbours along D.
template <int D>
struct AdalnBf16Layout {
  static constexpr int kAs = D / 2 + 4;          // activation row stride
  static constexpr int kWs = kAdChunkBf16 + 8;   // w chunk [D/2][kWs]
  static constexpr size_t kBytes =
      4 * (size_t(kAdTile) * kAs + size_t(D / 2) * kWs);
};

template <int D>
__global__ void __launch_bounds__(kAdThreads) adaln_bf16_kernel(
    const __nv_bfloat16* __restrict__ h,
    const __nv_bfloat16* __restrict__ scale,
    const __nv_bfloat16* __restrict__ shift,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int rows, int seq_len, int dout) {
  using L = AdalnBf16Layout<D>;
  constexpr int C = D / 32;
  extern __shared__ __align__(16) uint32_t ad_smem[];
  uint32_t* as = ad_smem;
  uint32_t* ws = as + kAdTile * L::kAs;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * kAdTile;

  float gam[C], bet[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gam[c] = ln_scale[lane * C + c];
    bet[c] = ln_bias[lane * C + c];
  }
  for (int r = 0; r < kAdRowsPerWarp; ++r) {
    const int lr = warp * kAdRowsPerWarp + r, row = row0 + lr;
    const bool valid = row < rows;
    const size_t bo = valid ? size_t(row / seq_len) * D : 0;
    float a[C];
    adaln_row<__nv_bfloat16, C>(h + size_t(valid ? row : 0) * D, scale + bo,
                                shift + bo, valid, gam, bet, lane, a);
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      as[lr * L::kAs + (lane * C + c) / 2] = pack_bf16(a[c], a[c + 1]);
    }
  }

  // this warp's rows (mt) and column quarter (nq) of each chunk
  const int mt = warp % 2, nq = warp / 2;
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  for (int n0 = 0; n0 < dout; n0 += kAdChunkBf16) {
    __syncthreads();  // activations written; the previous chunk's reads done
    // w chunk: word (kp, n) = {w[2kp][n0 + n], w[2kp + 1][n0 + n]}
    constexpr int kItems = (D / 2) * (kAdChunkBf16 / 4);
    static_assert(kItems % kAdThreads == 0, "w staging");
#pragma unroll 8
    for (int it = 0; it < kItems / kAdThreads; ++it) {
      const int i = it * kAdThreads + tid;
      const int kp = i / (kAdChunkBf16 / 4), n4 = i % (kAdChunkBf16 / 4);
      const __nv_bfloat16* src = w + size_t(2 * kp) * dout + n0 + 4 * n4;
      *reinterpret_cast<uint4*>(ws + kp * L::kWs + 4 * n4) = interleave_rows(
          *reinterpret_cast<const uint2*>(src),
          *reinterpret_cast<const uint2*>(src + dout));
    }
    __syncthreads();

    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t* xa = as + r0 * L::kAs + ks * 8 + tq;
      const uint32_t a[4] = {xa[0], xa[8 * L::kAs], xa[4], xa[8 * L::kAs + 4]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t* wb = ws + (ks * 8 + tq) * L::kWs + (2 * nq + q) * 8 + g;
        mma_bf16(acc[q], a, wb[0], wb[4 * L::kWs]);
      }
    }
    // + b in f32 on the accumulator, one rounding, one store
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + (2 * nq + q) * 8 + 2 * tq;
      const float bb0 = __bfloat162float(bias[col]);
      const float bb1 = __bfloat162float(bias[col + 1]);
      if (row0 + r0 < rows) {
        *reinterpret_cast<uint32_t*>(out + size_t(row0 + r0) * dout + col) =
            pack_bf16(acc[q][0] + bb0, acc[q][1] + bb1);
      }
      if (row0 + r1 < rows) {
        *reinterpret_cast<uint32_t*>(out + size_t(row0 + r1) * dout + col) =
            pack_bf16(acc[q][2] + bb0, acc[q][3] + bb1);
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kAdChunkF32 = 32;  // output columns per chunk

template <int D>
struct AdalnF32Layout {
  static constexpr int kAs = D + 4;  // activation row stride (floats)
  static constexpr size_t kBytes =
      4 * (size_t(kAdTile) * kAs + size_t(D) * kAdChunkF32);
};

// Thread (r, cq) = (tid / 8, tid % 8) computes row r of the tile, columns
// 4cq .. 4cq+3 of each chunk, as one sequential f32 FMA chain over D.
template <int D>
__global__ void __launch_bounds__(kAdThreads) adaln_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int rows,
    int seq_len, int dout) {
  using L = AdalnF32Layout<D>;
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float ad_fsmem[];
  float* as = ad_fsmem;
  float* ws = as + kAdTile * L::kAs;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kAdTile;

  float gam[C], bet[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gam[c] = ln_scale[lane * C + c];
    bet[c] = ln_bias[lane * C + c];
  }
  for (int r = 0; r < kAdRowsPerWarp; ++r) {
    const int lr = warp * kAdRowsPerWarp + r, row = row0 + lr;
    const bool valid = row < rows;
    const size_t bo = valid ? size_t(row / seq_len) * D : 0;
    float a[C];
    adaln_row<float, C>(h + size_t(valid ? row : 0) * D, scale + bo,
                        shift + bo, valid, gam, bet, lane, a);
#pragma unroll
    for (int c = 0; c < C; ++c) as[lr * L::kAs + lane * C + c] = a[c];
  }

  const int r = tid / 8, cq = tid % 8;
  const float* ar = as + r * L::kAs;
  for (int n0 = 0; n0 < dout; n0 += kAdChunkF32) {
    __syncthreads();
    // w chunk [D][32]: ws[d][n] = w[d][n0 + n]
    for (int i = tid; i < D * (kAdChunkF32 / 4); i += kAdThreads) {
      const int d = i / (kAdChunkF32 / 4), c = i % (kAdChunkF32 / 4);
      *reinterpret_cast<float4*>(ws + d * kAdChunkF32 + 4 * c) =
          *reinterpret_cast<const float4*>(w + size_t(d) * dout + n0 + 4 * c);
    }
    __syncthreads();
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a = ar[d];
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + d * kAdChunkF32 + 4 * cq);
      o[0] = fmaf(a, wv.x, o[0]);
      o[1] = fmaf(a, wv.y, o[1]);
      o[2] = fmaf(a, wv.z, o[2]);
      o[3] = fmaf(a, wv.w, o[3]);
    }
    if (row0 + r < rows) {
      const int col = n0 + 4 * cq;
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
      *reinterpret_cast<float4*>(out + size_t(row0 + r) * dout + col) =
          make_float4(o[0] + bv.x, o[1] + bv.y, o[2] + bv.z, o[3] + bv.w);
    }
  }
}

template <typename Kernel, typename T>
cudaError_t launch_adaln(Kernel kernel, size_t smem, const void* h,
                         const void* scale, const void* shift,
                         const void* ln_scale, const void* ln_bias,
                         const void* w, const void* b, void* out, int rows,
                         int seq_len, int dout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kAdTile - 1) / kAdTile;
  kernel<<<blocks, kAdThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), rows, seq_len, dout);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_adaln(const void* h, const void* scale,
                           const void* shift, const void* ln_scale,
                           const void* ln_bias, const void* w, const void* b,
                           void* out, int rows, int seq_len, int dout,
                           int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    return launch_adaln<decltype(&adaln_bf16_kernel<D>), __nv_bfloat16>(
        &adaln_bf16_kernel<D>, AdalnBf16Layout<D>::kBytes, h, scale, shift,
        ln_scale, ln_bias, w, b, out, rows, seq_len, dout, stream);
  }
  return launch_adaln<decltype(&adaln_f32_kernel<D>), float>(
      &adaln_f32_kernel<D>, AdalnF32Layout<D>::kBytes, h, scale, shift,
      ln_scale, ln_bias, w, b, out, rows, seq_len, dout, stream);
}

}  // namespace
}  // namespace mdm

// C entry for ctypes. h: [B, T, D]; scale, shift: [B, D]; w: [D, Dout];
// b: [Dout]; out: [B, T, Dout]; all contiguous, 16-byte aligned, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); ln_scale, ln_bias: [D] f32. rows =
// B*T. Returns the CUDA error code of the launch (0 on success); a D other
// than 256, 512 or 768, or a Dout that is not a positive multiple of 64,
// returns cudaErrorInvalidValue.
extern "C" int mdm_adaln_dense(const void* h, const void* scale,
                               const void* shift, const void* ln_scale,
                               const void* ln_bias, const void* w,
                               const void* b, void* out, int rows,
                               int seq_len, int dim, int dout, int is_bf16,
                               void* stream) {
  if (rows <= 0 || seq_len <= 0 || dout <= 0 || dout % 64 != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_ADALN_CASE(D_)                                                   \
  if (dim == D_) {                                                           \
    return int(mdm::dispatch_adaln<D_>(h, scale, shift, ln_scale, ln_bias,   \
                                       w, b, out, rows, seq_len, dout,       \
                                       is_bf16, s));                         \
  }
  MDM_ADALN_CASE(256)
  MDM_ADALN_CASE(512)
  MDM_ADALN_CASE(768)
#undef MDM_ADALN_CASE
  return int(cudaErrorInvalidValue);
}
