// Fused MoE dense_fused expert chain, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/moe_pallas.py::_moe_kernel (public entry
// moe_dense_fused). For a tile of tokens x [S, D] with routing weights
// combine [S, E]:
//
//   h   = gelu_tanh(x . W1m + b1) * combine[:, expert of the column]   (f32)
//   out = round(h) . W2m + combine . b2                 (f32 sums, rounded)
//
// with W1m [D, E*hid] and W2m [E*hid, D] the experts' weights merged along
// the hidden axis. The kernel reads the stored w1 [E, D, hid] and
// w2 [E, hid, D] and indexes those merged views itself. The [S, E*hid]
// hidden tensor never leaves the block, as on the TPU.
//
// What bounds it on the card. The function: tensor-core throughput. At the
// flagship shape (S = 6272 tokens, D = 512, E*hid = 1024) the two products
// are 13.2 GFLOP against ~15 MB of inputs and output, ~870 flops per byte,
// far above the H100's ~295 flops/byte line for bf16: 13.3 us at
// 989 TFLOP/s. This design: the weights, which every token tile streams
// from L2 through cp.async (2 MiB per tile at the flagship, 262 MiB per
// call), at a rate per SM that leaves the copies about as long as the
// products; the products themselves, on mma.sync at 8 warps per SM, wait
// on fragment loads and reach a fraction of the rate that wgmma would.
// What would move it: weight panels shared by the SMs of a cluster (one L2
// read for several token tiles) through TMA multicast, and wgmma.
//
// bf16 design. One block of 8 warps per tile of 48 tokens: 131 blocks at
// the flagship, one wave on the 132 SMs at one block per SM, so every
// weight byte read from L2 feeds 48 rows. The 48-row output
// accumulator stays in registers, 3 m-tiles x D/64 n-tiles x 4 floats per
// thread (96 at D = 512, 144 at D = 768): that is what caps the tile at 255
// registers a thread (64-token tiles were measured slower: more products
// per SM for the same weight stream). The x tile stays in shared memory.
// The block walks the E*hid hidden columns in chunks of C = 256 (D <= 512
// and E*hid a multiple of 256; else C = 128, which hid % 128 == 0 keeps
// inside one expert; a 256-column chunk may span two experts, and each
// thread's 8 columns lie in one). Each chunk's weights arrive as panels:
// W1 in slices of 64 (C = 128 and D <= 512: 128) rows of D, [rows x C];
// W2 in slices of 32 hidden rows, [32 x D] (64 and 128 rows at D = 256 and
// 128; 16 at D > 512). They pass through a ring of 3 panel slots (4 at
// D > 512) filled by cp.async two (three) panels ahead of the one being
// multiplied, so the copies from L2 overlap the tensor cores; the panels
// of a chunk's second product arrive while its first product and the gelu
// are computed. Tiles are row-major in shared memory with rows padded by
// 16 bytes, so that the 8 row addresses of every ldmatrix hit distinct
// banks, and both products are one warp routine (common.cuh::warp_mma,
// shared with adaln_dense.cu):
//   h [48 x C] = x . W1c: warp w owns chunk columns w C/8 .. +C/8 for all
//     48 rows, x fragments by ldmatrix from the x tile, W1 fragments by
//     ldmatrix.trans from the [k][n] panel, each x fragment feeding C/64
//     mma and each W1 fragment 3. Then + b1, gelu_tanh and the combine
//     weight in f32 on the accumulator, rounded once to bf16 into the h
//     chunk in shared memory;
//   out [48 x D] += h . W2c: warp w owns output columns w D/8 .. +D/8, h
//     fragments by ldmatrix, W2 fragments by ldmatrix.trans, each h
//     fragment feeding D/64 mma and each W2 fragment all 3 m-tiles.
// Both on mma.sync m16n8k16 (bf16 products summed in f32: the reference's
// preferred_element_type=f32). Finally + combine . b2 in f32, one rounding,
// one store; rows past S are zeros in and are not stored. Shared memory:
// the x tile, the h chunk, the slots and the combine weights in f32:
// 173.25 KB at D = 512 (E = 4, C = 256), 185.5 KB at D = 768 (E = 16,
// C = 128), at most 194.5 KB (E = 64). At D = 1024 the tile is 32 tokens
// (2 m-tiles, 128 accumulators a thread; 48 tokens would need 192), 202 KB
// at E = 4. No atomics: each output is one fixed sequence of mma, the same
// bits on every call.
//
// f32 design: 32-token tiles, IEEE f32 FMAs (not TF32, so the f32 parity
// holds), the weight chunks staged by the threads themselves (at D = 1024,
// where the x tile and a whole chunk do not both fit, in two parts).

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kMoeThreads = 256;  // 8 warps
constexpr int kMaxExperts = 64;

// jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// ---------------------------------------------------------------- bf16

// The tile and the ring for one D and chunk width C (hidden columns per
// chunk). C = 256 where the output accumulator leaves room for the first
// product's (D <= 512, 48 + 96 floats a thread) and E*hid is a multiple of
// 256; else 128. Panels of ~32 KB in 3 slots up to D = 512; at D = 640 and
// 768, where the x tile is larger, ~16-24 KB panels in 4 slots.
template <int D, int C>
struct MoeBf16Plan {
  static constexpr int kMT = D <= 768 ? 3 : 2;  // 16-token m-tiles per block
  static constexpr int kTok = 16 * kMT;         // tokens per block
  static constexpr bool kWide = D > 512;
  static_assert(C == 128 || !kWide, "C = 256 only up to D = 512");
  static constexpr int kStages = kWide ? 4 : 3;      // slots of the ring
  static constexpr int kW1Rows = C == 256 || kWide ? 64 : 128;  // of D
  static constexpr int kW2Rows = kWide ? 16 : D <= 128 ? 128 : D <= 256 ? 64
                                                                  : 32;
  static constexpr int kXs = D + kRowPad;   // x tile [kTok][kXs]
  static constexpr int kHs = C + kRowPad;   // h chunk [kTok][kHs]
  static constexpr int kW1s = C + kRowPad;  // W1 panel [kW1Rows][kW1s]
  static constexpr int kW2s = D + kRowPad;  // W2 panel [kW2Rows][kW2s]
  static constexpr int kP1 = D / kW1Rows;  // W1 panels per chunk
  static constexpr int kP2 = C / kW2Rows;  // W2 panels per chunk
  static constexpr int kPanels = kP1 + kP2;
  static constexpr int kSlot = kW1Rows * kW1s > kW2Rows * kW2s
                                   ? kW1Rows * kW1s
                                   : kW2Rows * kW2s;
  static constexpr size_t bytes(int experts) {
    return sizeof(__nv_bfloat16) *
               (size_t(kTok) * (kXs + kHs) + size_t(kStages) * kSlot) +
           sizeof(float) * size_t(kTok) * experts;
  }
};

template <int D, int C>
__global__ void __launch_bounds__(kMoeThreads, 1) moe_bf16_kernel(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ combine,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, int S, int E, int hid) {
  using P = MoeBf16Plan<D, C>;
  constexpr int kMT = P::kMT, kTok = P::kTok;
  constexpr int kStages = P::kStages, kW1Rows = P::kW1Rows;
  constexpr int kW2Rows = P::kW2Rows;
  constexpr int kNT1 = C / 64, kNT2 = D / 64;  // n-tiles of a warp
  extern __shared__ __align__(16) unsigned char moe_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(moe_smem);
  __nv_bfloat16* hs = xs + kTok * P::kXs;
  __nv_bfloat16* ring = hs + kTok * P::kHs;
  float* cs = reinterpret_cast<float*>(ring + kStages * P::kSlot);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int s0 = blockIdx.x * kTok;
  const int valid = min(kTok, S - s0);  // rows of the tile before S
  const int panels = E * hid / C * P::kPanels;

  // panel p of the sequence (chunk p / kPanels: its W1 panels, then its W2
  // panels) into slot p % kStages, as one cp.async group (empty past the
  // end, so that the count of groups in flight stays the same)
  auto load_panel = [&](int p) {
    if (p < panels) {
      const int col0 = p / P::kPanels * C;  // the chunk's first merged column
      const int q = p % P::kPanels;
      __nv_bfloat16* dst = ring + (p % kStages) * P::kSlot;
      if (q < P::kP1) {
        // W1m rows q*kW1Rows + r, columns col0 + c: w1[e][row][h] for the
        // merged column e*hid + h (a chunk of 256 may span two experts;
        // a thread's 8 columns lie in one)
        constexpr int kRow = C / 8;  // 16-byte pieces of a row
        static_assert(kMoeThreads % kRow == 0 &&
                          kW1Rows * kRow % kMoeThreads == 0, "W1 panel");
        const int c = 8 * (tid % kRow), m = col0 + c, e = m / hid;
        const __nv_bfloat16* src =
            w1 + (size_t(e) * D + q * kW1Rows) * hid + (m - e * hid);
#pragma unroll
        for (int it = 0; it < kW1Rows * kRow / kMoeThreads; ++it) {
          const int r = it * (kMoeThreads / kRow) + tid / kRow;
          cp_async16(dst + r * P::kW1s + c, src + size_t(r) * hid, true);
        }
      } else {  // W2m rows col0 + (q - kP1) * kW2Rows + r
        cp_async_tile<kW2Rows, D, kMoeThreads>(
            dst, P::kW2s, w2 + (size_t(col0) + (q - P::kP1) * kW2Rows) * D,
            D, kW2Rows, tid);
      }
    }
    cp_async_commit();
  };

  // the x tile (zeros past S) joins the group of panel 0
  cp_async_tile<kTok, D, kMoeThreads>(xs, P::kXs, x + size_t(s0) * D, D,
                                      valid, tid);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) load_panel(p);
  // the combine weights, widened to f32 (zeros past S)
  for (int i = tid; i < kTok * E; i += kMoeThreads) {
    cs[i] = i / E < valid ? __bfloat162float(combine[size_t(s0) * E + i])
                          : 0.f;
  }

  int p = 0;  // the next panel to multiply
  // wait for panel p, refill the slot that panel p - 1 used, return p's
  auto next_panel = [&]() {
    ring_wait<kStages>();
    load_panel(p + kStages - 1);
    return ring + (p++ % kStages) * P::kSlot;
  };

  // out [kTok x D]: warp w owns output columns w D/8 .. for every row
  float acc[kMT][kNT2][4];
  zero_tiles(acc);
  for (int col0 = 0; col0 < E * hid; col0 += C) {
    // h = x . W1c: warp w owns the chunk's columns w C/8 ..
    float hacc[kMT][kNT1][4];
    zero_tiles(hacc);
    for (int q = 0; q < P::kP1; ++q) {
      const __nv_bfloat16* panel = next_panel();
      warp_mma<kW1Rows>(hacc, xs + q * kW1Rows, P::kXs,
                              panel + warp * (C / 8), P::kW1s, lane);
    }
    // + b1, gelu, * combine in f32 on the accumulator; one rounding to bf16.
    // The previous chunk's h was last read before the barrier of this
    // chunk's last W1 panel; this h is first read after the next barrier.
#pragma unroll
    for (int nt = 0; nt < kNT1; ++nt) {
      const int hc = warp * (C / 8) + 8 * nt + 2 * tq;  // column in the chunk
      const int e = (col0 + hc) / hid;
      const float2 bias = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1 + col0 + hc));
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int r0 = 16 * mi + g, r1 = r0 + 8;
        const float c0 = cs[r0 * E + e], c1 = cs[r1 * E + e];
        const float(&h)[4] = hacc[mi][nt];
        *reinterpret_cast<uint32_t*>(hs + r0 * P::kHs + hc) =
            pack_bf16(gelu_tanh(h[0] + bias.x) * c0,
                      gelu_tanh(h[1] + bias.y) * c0);
        *reinterpret_cast<uint32_t*>(hs + r1 * P::kHs + hc) =
            pack_bf16(gelu_tanh(h[2] + bias.x) * c1,
                      gelu_tanh(h[3] + bias.y) * c1);
      }
    }
    // out += h . W2c
    for (int q = 0; q < P::kP2; ++q) {
      const __nv_bfloat16* panel = next_panel();
      warp_mma<kW2Rows>(acc, hs + q * kW2Rows, P::kHs,
                              panel + warp * (D / 8), P::kW2s, lane);
    }
  }
  cp_async_wait<0>();  // only empty groups remain

  // + combine . b2 (f32), one rounding, one store
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    const int r0 = 16 * mi + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < kNT2; ++nt) {
      const int col = warp * (D / 8) + 8 * nt + 2 * tq;
      float cb[4] = {0.f, 0.f, 0.f, 0.f};
      for (int e = 0; e < E; ++e) {
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + size_t(e) * D +
                                                     col));
        const float ca = cs[r0 * E + e], cc = cs[r1 * E + e];
        cb[0] = fmaf(ca, bb.x, cb[0]);
        cb[1] = fmaf(ca, bb.y, cb[1]);
        cb[2] = fmaf(cc, bb.x, cb[2]);
        cb[3] = fmaf(cc, bb.y, cb[3]);
      }
      if (r0 < valid) {
        *reinterpret_cast<uint32_t*>(out + size_t(s0 + r0) * D + col) =
            pack_bf16(acc[mi][nt][0] + cb[0], acc[mi][nt][1] + cb[1]);
      }
      if (r1 < valid) {
        *reinterpret_cast<uint32_t*>(out + size_t(s0 + r1) * D + col) =
            pack_bf16(acc[mi][nt][2] + cb[2], acc[mi][nt][3] + cb[3]);
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kMoeTile = 32;   // tokens per block
constexpr int kChunkF32 = 32;  // hidden columns per chunk

template <int D>
struct MoeF32Layout {
  static constexpr int kXs = D + 4;  // x tile row stride (floats)
  static constexpr int kHs = kChunkF32 + 1;
  // parts a weight chunk is staged in (W1 by rows of D, W2 by columns):
  // at D = 1024 the x tile and a whole chunk do not both fit
  static constexpr int kParts = D <= 768 ? 1 : 2;
  static constexpr int kDp = D / kParts;
  static constexpr size_t bytes(int experts) {
    return 4 * (size_t(kMoeTile) * kXs + size_t(kDp) * kChunkF32 +
                size_t(kMoeTile) * kHs + size_t(kMoeTile) * experts);
  }
};

// Thread (r, cq) = (tid / 8, tid % 8) owns token row r of the tile: in the
// first product hidden columns 4cq .. 4cq+3 of the chunk, in the second the
// output columns 4cq + 32v .. +3 for v < D/32. Each sum is one sequential
// FMA chain, whatever the parts.
template <int D>
__global__ void __launch_bounds__(kMoeThreads) moe_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ combine,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int S, int E, int hid) {
  using L = MoeF32Layout<D>;
  constexpr int kParts = L::kParts, kDp = L::kDp;
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;
  float* ws = xs + kMoeTile * L::kXs;
  float* hs = ws + kDp * kChunkF32;
  float* cs = hs + kMoeTile * L::kHs;

  const int tid = threadIdx.x, r = tid / 8, cq = tid % 8;
  const int s0 = blockIdx.x * kMoeTile;
  constexpr int kRowVec = D / 4;
  for (int i = tid; i < kMoeTile * kRowVec; i += kMoeThreads) {
    const int rr = i / kRowVec, c = i % kRowVec;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + rr < S) {
      v = reinterpret_cast<const float4*>(x + size_t(s0 + rr) * D)[c];
    }
    *reinterpret_cast<float4*>(xs + rr * L::kXs + 4 * c) = v;
  }
  for (int i = tid; i < kMoeTile * E; i += kMoeThreads) {
    cs[i] = s0 + i / E < S ? combine[size_t(s0) * E + i] : 0.f;
  }

  constexpr int kV = D / 32;
  constexpr int kVp = kV / kParts;  // output column groups of a part
  float acc[kV][4];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[v][c] = 0.f;
  }

  for (int j0 = 0; j0 < E * hid; j0 += kChunkF32) {
    const int e = j0 / hid, h0 = j0 % hid;
    // W1 chunk rows part kDp ..: ws[d][n] = w1[e][part kDp + d][h0 + n]
    const float* w1e = w1 + size_t(e) * D * hid + h0;
    const float* xr = xs + r * L::kXs;
    float h[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      __syncthreads();  // ws is no longer read
      for (int i = tid; i < kDp * (kChunkF32 / 4); i += kMoeThreads) {
        const int d = i / (kChunkF32 / 4), c = i % (kChunkF32 / 4);
        *reinterpret_cast<float4*>(ws + d * kChunkF32 + 4 * c) =
            *reinterpret_cast<const float4*>(
                w1e + size_t(part * kDp + d) * hid + 4 * c);
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDp; ++d) {
        const float a = xr[part * kDp + d];
        const float4 w =
            *reinterpret_cast<const float4*>(ws + d * kChunkF32 + 4 * cq);
        h[0] = fmaf(a, w.x, h[0]);
        h[1] = fmaf(a, w.y, h[1]);
        h[2] = fmaf(a, w.z, h[2]);
        h[3] = fmaf(a, w.w, h[3]);
      }
    }
    const float cw = cs[r * E + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float bias = b1[size_t(e) * hid + h0 + 4 * cq + c];
      hs[r * L::kHs + 4 * cq + c] = gelu_tanh(h[c] + bias) * cw;
    }
    // W2 chunk columns part kDp ..: ws[k][n] = w2[e][h0 + k][part kDp + n]
    const float* w2e = w2 + (size_t(e) * hid + h0) * D;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      __syncthreads();  // h is written and ws no longer read
      for (int i = tid; i < kChunkF32 * (kDp / 4); i += kMoeThreads) {
        const int k = i / (kDp / 4), c = i % (kDp / 4);
        *reinterpret_cast<float4*>(ws + k * kDp + 4 * c) =
            *reinterpret_cast<const float4*>(w2e + size_t(k) * D +
                                             part * kDp + 4 * c);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunkF32; ++k) {
        const float a = hs[r * L::kHs + k];
#pragma unroll
        for (int v = 0; v < kVp; ++v) {
          const float4 w = *reinterpret_cast<const float4*>(
              ws + k * kDp + 4 * cq + 32 * v);
          float(&o)[4] = acc[part * kVp + v];
          o[0] = fmaf(a, w.x, o[0]);
          o[1] = fmaf(a, w.y, o[1]);
          o[2] = fmaf(a, w.z, o[2]);
          o[3] = fmaf(a, w.w, o[3]);
        }
      }
    }
  }

  if (s0 + r >= S) return;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int col = 4 * cq + 32 * v;
    float o[4] = {acc[v][0], acc[v][1], acc[v][2], acc[v][3]};
    float cb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = 0; e < E; ++e) {
      const float cw = cs[r * E + e];
      const float4 bv = *reinterpret_cast<const float4*>(b2 + size_t(e) * D +
                                                         col);
      cb[0] = fmaf(cw, bv.x, cb[0]);
      cb[1] = fmaf(cw, bv.y, cb[1]);
      cb[2] = fmaf(cw, bv.z, cb[2]);
      cb[3] = fmaf(cw, bv.w, cb[3]);
    }
    *reinterpret_cast<float4*>(out + size_t(s0 + r) * D + col) =
        make_float4(o[0] + cb[0], o[1] + cb[1], o[2] + cb[2], o[3] + cb[3]);
  }
}

template <typename Kernel, typename T>
cudaError_t launch_moe(Kernel kernel, int tile, size_t smem, const void* x,
                       const void* combine, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int S,
                       int E, int hid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (S + tile - 1) / tile;
  kernel<<<blocks, kMoeThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(combine),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(out), S, E, hid);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_moe(const void* x, const void* combine, const void* w1,
                         const void* b1, const void* w2, const void* b2,
                         void* out, int S, int E, int hid, int is_bf16,
                         cudaStream_t stream) {
  // within an sm_90 block's shared memory at the most experts
  static_assert(MoeBf16Plan<D, 128>::bytes(kMaxExperts) <= 232448 &&
                    MoeF32Layout<D>::bytes(kMaxExperts) <= 232448,
                "shared memory");
  if (is_bf16) {
    if constexpr (D <= 512) {
      static_assert(MoeBf16Plan<D, 256>::bytes(kMaxExperts) <= 232448,
                    "shared memory");
      if (E * hid % 256 == 0) {
        return launch_moe<decltype(&moe_bf16_kernel<D, 256>), __nv_bfloat16>(
            &moe_bf16_kernel<D, 256>, MoeBf16Plan<D, 256>::kTok,
            MoeBf16Plan<D, 256>::bytes(E), x,
            combine, w1, b1, w2, b2, out, S, E, hid, stream);
      }
    }
    return launch_moe<decltype(&moe_bf16_kernel<D, 128>), __nv_bfloat16>(
        &moe_bf16_kernel<D, 128>, MoeBf16Plan<D, 128>::kTok,
        MoeBf16Plan<D, 128>::bytes(E), x,
        combine, w1, b1, w2, b2, out, S, E, hid, stream);
  }
  return launch_moe<decltype(&moe_f32_kernel<D>), float>(
      &moe_f32_kernel<D>, kMoeTile, MoeF32Layout<D>::bytes(E), x, combine,
      w1, b1, w2, b2, out, S, E, hid, stream);
}

}  // namespace
}  // namespace mdm

// C entry for ctypes. x: [S, D]; combine: [S, E]; w1: [E, D, hid];
// b1: [E, hid]; w2: [E, hid, D]; b2: [E, D]; out: [S, D]; all contiguous,
// 16-byte aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Returns the CUDA
// error code of the launch (0 on success); a D other than the instantiated
// multiples of 128 up to 768 and 1024, hid not a multiple of 128, or E
// outside [1, 64] return cudaErrorInvalidValue.
extern "C" int mdm_moe_dense_fused(const void* x, const void* combine,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* out,
                                   int S, int dim, int num_experts, int hid,
                                   int is_bf16, void* stream) {
  if (S <= 0 || hid <= 0 || hid % 128 != 0 || num_experts < 1 ||
      num_experts > mdm::kMaxExperts) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_MOE_CASE(D_)                                                    \
  if (dim == D_) {                                                          \
    return int(mdm::dispatch_moe<D_>(x, combine, w1, b1, w2, b2, out, S,    \
                                     num_experts, hid, is_bf16, s));        \
  }
  MDM_MOE_CASE(128)
  MDM_MOE_CASE(256)
  MDM_MOE_CASE(384)
  MDM_MOE_CASE(512)
  MDM_MOE_CASE(640)
  MDM_MOE_CASE(768)
  MDM_MOE_CASE(1024)
#undef MDM_MOE_CASE
  return int(cudaErrorInvalidValue);
}
