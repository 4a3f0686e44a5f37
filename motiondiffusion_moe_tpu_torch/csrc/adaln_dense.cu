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
// bf16 design. One block of 8 warps per tile of 96 rows x NC output
// columns, NC = 256 where Dout is a multiple of 256, else 64: at the
// flagship 66 row tiles x 2 column slices = 132 blocks, one wave at one
// block per SM. So each block streams only its NC columns of w from L2
// (256 KB at the flagship, ~33 MB per call, a third of a design where
// every block reads all of w), and each weight byte it reads feeds 96 rows;
// h is read once per column slice, the second time mostly from L2.
//   1. The raw h tile [96 x D] is copied by cp.async straight into the
//      activation tile in shared memory (rows padded by 16 bytes), and the
//      first panels of w are issued behind it, so that the copies of w
//      overlap the prologue. Rows past the end are zeros and stay so.
//   2. The prologue, in place: warp w takes rows 12w .. 12w+11 of the
//      tile, two at a time (their loads and shuffles overlap), lane l the
//      columns 8l + 256j .. +7 (16-byte accesses); the statistics by
//      shuffles, LayerNorm, modulation with the row's own scale and shift
//      and SiLU in f32 (the exp and the divide of the SiLU by the fast
//      intrinsics, a few f32 ulps against the activation's bf16 rounding
//      next), the activations rounded once to bf16 over the raw row.
//   3. The product: w passes as panels [32 k-rows x NC] through a ring of
//      4 slots (common.cuh::ring_wait), filled 3 panels ahead. The 8 warps
//      form 2 (48 rows) x 4 (NC/4 columns); each runs common.cuh::warp_mma,
//      the routine of kernel 5 (moe_dense_fused.cu): 3 m-tiles x NC/32
//      n-tiles on mma.sync m16n8k16 (bf16 products summed in f32), A
//      fragments by ldmatrix from the activation tile, each feeding NC/32
//      mma, B fragments by ldmatrix.trans from the panel, each feeding 3.
//   4. The epilogue: + b on the f32 accumulator, one rounding, stores of
//      the rows before the end only.
// Shared memory: the tile, 96 (D + 8) bf16, and the ring, 4 slots of
// 32 (NC + 8): 163.5 KB at D = 512 and NC = 256, 211.5 KB at D = 768. At
// D = 1024 a tile of 96 rows does not fit: the tile is 64 rows (two m-tiles
// a warp), 195 KB, and the prologue takes one row at a time. No atomics:
// each output is one fixed sequence of mma, the same bits on every call.
// Not in this design: TMA multicast of a w panel to the blocks of a
// cluster, wgmma.
//
// f32 design (a simple first version): one block of 8 warps per 32-row
// tile. Each warp runs the row prologue for 4 rows and writes the
// activations into shared memory; the block then walks Dout in chunks of 32
// columns, staging each chunk of w through one shared buffer (in two parts
// of its rows at D = 1024), with IEEE FMAs, not TF32, as the TPU kernel
// sums in f32.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kAdThreads = 256;  // 8 warps
constexpr int kAdTile = 32;      // rows per block (f32)
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

constexpr int kAbPanelK = 32;  // k-rows of a w panel

template <int D, int NC>
struct AdalnBf16Plan {
  static_assert(D % 256 == 0 && D % kAbPanelK == 0, "D");
  static_assert(NC == 256 || NC == 64, "column slice");
  static constexpr int kRows = D <= 768 ? 96 : 64;  // rows per block
  static constexpr int kMT = kRows / 32;  // 16-row m-tiles of a warp (2 x)
  static constexpr int kPair = D <= 768 ? 2 : 1;  // rows of a prologue step
  // slots of the ring: 4 (7 at D <= 512, which the tile leaves room for,
  // ran 2.5% slower on the H100)
  static constexpr int kStages = 4;
  static constexpr int kAs = D + kRowPad;    // activation tile [96][kAs]
  static constexpr int kWs = NC + kRowPad;   // w panel [32][kWs]
  static constexpr int kSlot = kAbPanelK * kWs;
  static constexpr int kPanels = D / kAbPanelK;
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) *
      (size_t(kRows) * kAs + size_t(kStages) * kSlot);
  static_assert(kBytes <= 232448, "within an sm_90 block's shared memory");
};

template <int D, int NC>
__global__ void __launch_bounds__(kAdThreads, 1) adaln_bf16_kernel(
    const __nv_bfloat16* __restrict__ h,
    const __nv_bfloat16* __restrict__ scale,
    const __nv_bfloat16* __restrict__ shift,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int rows, int seq_len, int dout) {
  using P = AdalnBf16Plan<D, NC>;
  constexpr int kAbRows = P::kRows, kAbPair = P::kPair;
  constexpr int G = D / 256;     // 8-column groups of a lane
  constexpr int kNT = NC / 32;   // n-tiles of a warp
  constexpr int kRowsPerWarp = kAbRows / (kAdThreads / 32);
  extern __shared__ __align__(16) unsigned char ad_smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(ad_smem);
  __nv_bfloat16* ring = as + kAbRows * P::kAs;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * kAbRows, n0 = blockIdx.y * NC;
  const int valid = min(kAbRows, rows - row0);  // rows before the end

  // 1. the raw h tile as group 0, then panels 0 .. P::kStages - 2
  cp_async_tile<kAbRows, D, kAdThreads>(as, P::kAs, h + size_t(row0) * D, D,
                                        valid, tid);
  cp_async_commit();
  // panel p (k-rows 32p ..) into slot p % P::kStages, one group (empty past
  // the last panel, so that the count of groups in flight stays the same)
  auto load_panel = [&](int p) {
    if (p < P::kPanels) {
      cp_async_tile<kAbPanelK, NC, kAdThreads>(
          ring + (p % P::kStages) * P::kSlot, P::kWs,
          w + size_t(p) * kAbPanelK * dout + n0, dout, kAbPanelK, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < P::kStages - 1; ++p) load_panel(p);

  // 2. the prologue, in place, once the h tile has landed
  float gam[G][8], bet[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c = 256 * j + 8 * lane;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gam[j][e] = ln_scale[c + e];
      bet[j][e] = ln_bias[c + e];
    }
  }
  cp_async_wait<P::kStages - 1>();  // this thread's copies of the h tile
  __syncthreads();                  // and everyone's
  {
    constexpr float kInvD = 1.0f / float(D);
    const int r_end = min(valid, (warp + 1) * kRowsPerWarp);
    // kAbPair rows at a time, so that their loads and shuffles overlap; a
    // row at or past r_end (a zero row) is computed and not stored
    for (int lr0 = warp * kRowsPerWarp; lr0 < r_end; lr0 += kAbPair) {
      float x[kAbPair][G][8], s1[kAbPair][G][8], sh[kAbPair][G][8];
      float s[kAbPair], v[kAbPair], mu[kAbPair], inv[kAbPair];
#pragma unroll
      for (int q = 0; q < kAbPair; ++q) {
        // this row's batch row (the last row's where the row is past it)
        const int b = (row0 + min(lr0 + q, valid - 1)) / seq_len;
        s[q] = 0.f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const size_t o = size_t(b) * D + 256 * j + 8 * lane;
          unpack_bf16x8(*reinterpret_cast<const uint4*>(
                            as + (lr0 + q) * P::kAs + 256 * j + 8 * lane),
                        x[q][j]);
          unpack_bf16x8(*reinterpret_cast<const uint4*>(scale + o),
                        s1[q][j]);
          unpack_bf16x8(*reinterpret_cast<const uint4*>(shift + o),
                        sh[q][j]);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[q] += x[q][j][e];
        }
      }
#pragma unroll
      for (int q = 0; q < kAbPair; ++q) mu[q] = warp_sum(s[q]) * kInvD;
#pragma unroll
      for (int q = 0; q < kAbPair; ++q) {
        v[q] = 0.f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = x[q][j][e] - mu[q];
            v[q] = fmaf(d, d, v[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kAbPair; ++q) {
        inv[q] = 1.0f / sqrtf(warp_sum(v[q]) * kInvD + kLnEps);
      }
#pragma unroll
      for (int q = 0; q < kAbPair; ++q) {
        if (lr0 + q >= r_end) continue;  // the same for the whole warp
#pragma unroll
        for (int j = 0; j < G; ++j) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float n =
                (x[q][j][e] - mu[q]) * inv[q] * gam[j][e] + bet[j][e];
            const float m = n * (1.f + s1[q][j][e]) + sh[q][j][e];
            // silu with the fast exp and divide (a few f32 ulps; the
            // activation is rounded to bf16 next)
            x[q][j][e] = __fdividef(m, 1.f + __expf(-m));
          }
          *reinterpret_cast<uint4*>(as + (lr0 + q) * P::kAs + 256 * j +
                                    8 * lane) = pack_bf16x8(x[q][j]);
        }
      }
    }
  }

  // 3. the product: warp (wm, wn) owns rows kAbRows/2 wm .. and columns
  // NC/4 wn .. of the block's output tile
  const int wm = warp % 2, wn = warp / 2;
  const __nv_bfloat16* a_rows = as + kAbRows / 2 * wm * P::kAs;
  float acc[P::kMT][kNT][4];
  zero_tiles(acc);
  for (int p = 0; p < P::kPanels; ++p) {
    // panel p landed, every warp's activations are written (p = 0) and
    // panel p - 1 is no longer read
    ring_wait<P::kStages>();
    load_panel(p + P::kStages - 1);
    warp_mma<kAbPanelK>(acc, a_rows + p * kAbPanelK, P::kAs,
                        ring + (p % P::kStages) * P::kSlot + wn * (NC / 4),
                        P::kWs, lane);
  }
  cp_async_wait<0>();  // only empty groups remain

  // 4. + b in f32 on the accumulator, one rounding, one store
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + wn * (NC / 4) + 8 * nt + 2 * tq;
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int mi = 0; mi < P::kMT; ++mi) {
      const int r0 = kAbRows / 2 * wm + 16 * mi + g, r1 = r0 + 8;
      if (r0 < valid) {
        *reinterpret_cast<uint32_t*>(out + size_t(row0 + r0) * dout + col) =
            pack_bf16(acc[mi][nt][0] + bb.x, acc[mi][nt][1] + bb.y);
      }
      if (r1 < valid) {
        *reinterpret_cast<uint32_t*>(out + size_t(row0 + r1) * dout + col) =
            pack_bf16(acc[mi][nt][2] + bb.x, acc[mi][nt][3] + bb.y);
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kAdChunkF32 = 32;  // output columns per chunk

template <int D>
struct AdalnF32Layout {
  static constexpr int kAs = D + 4;  // activation row stride (floats)
  // parts a w chunk is staged in, by rows of D: at D = 1024 the tile and
  // a whole chunk do not both fit
  static constexpr int kParts = D <= 768 ? 1 : 2;
  static constexpr int kDp = D / kParts;
  static constexpr size_t kBytes =
      4 * (size_t(kAdTile) * kAs + size_t(kDp) * kAdChunkF32);
  static_assert(kBytes <= 232448, "within an sm_90 block's shared memory");
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

  constexpr int kDp = L::kDp;
  const int r = tid / 8, cq = tid % 8;
  const float* ar = as + r * L::kAs;
  for (int n0 = 0; n0 < dout; n0 += kAdChunkF32) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int part = 0; part < L::kParts; ++part) {
      __syncthreads();  // ws is no longer read
      // w chunk rows part kDp ..: ws[d][n] = w[part kDp + d][n0 + n]
      for (int i = tid; i < kDp * (kAdChunkF32 / 4); i += kAdThreads) {
        const int d = i / (kAdChunkF32 / 4), c = i % (kAdChunkF32 / 4);
        *reinterpret_cast<float4*>(ws + d * kAdChunkF32 + 4 * c) =
            *reinterpret_cast<const float4*>(
                w + size_t(part * kDp + d) * dout + n0 + 4 * c);
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDp; ++d) {
        const float a = ar[part * kDp + d];
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + d * kAdChunkF32 + 4 * cq);
        o[0] = fmaf(a, wv.x, o[0]);
        o[1] = fmaf(a, wv.y, o[1]);
        o[2] = fmaf(a, wv.z, o[2]);
        o[3] = fmaf(a, wv.w, o[3]);
      }
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
cudaError_t launch_adaln(Kernel kernel, dim3 grid, size_t smem, const void* h,
                         const void* scale, const void* shift,
                         const void* ln_scale, const void* ln_bias,
                         const void* w, const void* b, void* out, int rows,
                         int seq_len, int dout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kAdThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), rows, seq_len, dout);
  return cudaGetLastError();
}

template <int D, int NC>
cudaError_t launch_adaln_bf16(const void* h, const void* scale,
                              const void* shift, const void* ln_scale,
                              const void* ln_bias, const void* w,
                              const void* b, void* out, int rows, int seq_len,
                              int dout, cudaStream_t stream) {
  constexpr int kRows = AdalnBf16Plan<D, NC>::kRows;
  const dim3 grid((rows + kRows - 1) / kRows, dout / NC);
  return launch_adaln<decltype(&adaln_bf16_kernel<D, NC>), __nv_bfloat16>(
      &adaln_bf16_kernel<D, NC>, grid, AdalnBf16Plan<D, NC>::kBytes, h,
      scale, shift, ln_scale, ln_bias, w, b, out, rows, seq_len, dout,
      stream);
}

template <int D>
cudaError_t dispatch_adaln(const void* h, const void* scale,
                           const void* shift, const void* ln_scale,
                           const void* ln_bias, const void* w, const void* b,
                           void* out, int rows, int seq_len, int dout,
                           int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    return dout % 256 == 0
               ? launch_adaln_bf16<D, 256>(h, scale, shift, ln_scale, ln_bias,
                                           w, b, out, rows, seq_len, dout,
                                           stream)
               : launch_adaln_bf16<D, 64>(h, scale, shift, ln_scale, ln_bias,
                                          w, b, out, rows, seq_len, dout,
                                          stream);
  }
  return launch_adaln<decltype(&adaln_f32_kernel<D>), float>(
      &adaln_f32_kernel<D>, dim3((rows + kAdTile - 1) / kAdTile),
      AdalnF32Layout<D>::kBytes, h, scale, shift, ln_scale, ln_bias, w, b,
      out, rows, seq_len, dout, stream);
}

}  // namespace
}  // namespace mdm

// C entry for ctypes. h: [B, T, D]; scale, shift: [B, D]; w: [D, Dout];
// b: [Dout]; out: [B, T, Dout]; all contiguous, 16-byte aligned, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); ln_scale, ln_bias: [D] f32. rows =
// B*T. Returns the CUDA error code of the launch (0 on success); a D other
// than 256, 512, 768 or 1024, or a Dout that is not a positive multiple of
// 64, returns cudaErrorInvalidValue.
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
  MDM_ADALN_CASE(1024)
#undef MDM_ADALN_CASE
  return int(cudaErrorInvalidValue);
}
