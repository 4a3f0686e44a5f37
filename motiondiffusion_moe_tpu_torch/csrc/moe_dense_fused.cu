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
// w2 [E, hid, D] and indexes those merged views itself.
//
// What bounds it on the card: tensor-core throughput. At the flagship shape
// (S = 6272 tokens, D = 512, E*hid = 1024) the two products are 13.2 GFLOP
// against ~15 MB of inputs and output, ~870 flops per byte, far above the
// H100's ~295 flops/byte line for bf16: 13.3 us at 989 TFLOP/s. The TPU
// kernel's point, keeping the [S, E*hid] hidden tensor out of device memory,
// holds here too: it never leaves the block.
//
// Design (a simple first version, no TMA or wgmma yet): one block of 8
// warps per 32-token tile (196 blocks at the flagship). The x tile stays in
// shared memory; the block walks the E*hid hidden columns in chunks (64 in
// bf16, 32 in f32; a chunk lies inside one expert because hid % 128 == 0).
// Per chunk: stage the W1 chunk, h = x . W1 chunk, then bias, tanh-gelu and
// the combine weight in f32 on the accumulator, rounded once to the input
// dtype into shared memory; stage the W2 chunk into the same buffer and
// accumulate out += h . W2 chunk in registers (each warp owns a 16-row by
// D/4-column slab of the output). Finally add combine . b2 and store once.
// bf16 runs both products on the tensor cores (mma.sync m16n8k16, bf16
// products summed in f32: the reference's preferred_element_type=f32);
// f32 runs IEEE f32 FMAs, not TF32, so the f32 parity holds. Shared-memory
// rows are padded so that every fragment load of a warp hits 32 distinct
// banks. The weights are re-read from L2 by every block: at the flagship
// ~2 MB per block, which, not the tensor cores, bounds this version.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kMoeTile = 32;      // tokens per block
constexpr int kMoeThreads = 256;  // 8 warps
constexpr int kMaxExperts = 64;

// jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// ---------------------------------------------------------------- bf16

constexpr int kChunkBf16 = 64;  // hidden columns per chunk

// Shared memory of the bf16 kernel, in 32-bit words, each holding two bf16
// neighbours along the contracted axis of the product that reads them.
template <int D>
struct MoeBf16Layout {
  static constexpr int kXs = D / 2 + 4;          // x tile row stride
  static constexpr int kW1s = kChunkBf16 + 8;    // W1 chunk [D/2][kW1s]
  static constexpr int kW2s = D + 8;             // W2 chunk [32][kW2s]
  static constexpr int kHs = kChunkBf16 / 2 + 4;  // h chunk [32][kHs]
  static constexpr int kW = (D / 2) * kW1s > (kChunkBf16 / 2) * kW2s
                                ? (D / 2) * kW1s
                                : (kChunkBf16 / 2) * kW2s;
  static constexpr size_t bytes(int experts) {
    return 4 * (size_t(kMoeTile) * kXs + kW + size_t(kMoeTile) * kHs +
                size_t(kMoeTile) * experts);
  }
};

template <int D>
__global__ void __launch_bounds__(kMoeThreads) moe_bf16_kernel(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ combine,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, int S, int E, int hid) {
  using L = MoeBf16Layout<D>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;
  uint32_t* ws = xs + kMoeTile * L::kXs;
  uint32_t* hs = ws + L::kW;
  float* cs = reinterpret_cast<float*>(hs + kMoeTile * L::kHs);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int s0 = blockIdx.x * kMoeTile;

  // the x tile (zero rows past S) and its combine weights, widened to f32
  constexpr int kRowVec = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < kMoeTile * kRowVec; i += kMoeThreads) {
    const int r = i / kRowVec, c = i % kRowVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S) {
      v = reinterpret_cast<const uint4*>(x + size_t(s0 + r) * D)[c];
    }
    *reinterpret_cast<uint4*>(xs + r * L::kXs + 4 * c) = v;
  }
  for (int i = tid; i < kMoeTile * E; i += kMoeThreads) {
    const int r = i / E;
    cs[i] = s0 + r < S ? __bfloat162float(combine[size_t(s0) * E + i]) : 0.f;
  }

  // this warp's rows (mt) and column quarter (nq) of both products
  const int mt = warp % 2, nq = warp / 2;
  constexpr int kNT = D / 32;  // 8-column output tiles per warp
  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  const int r0 = mt * 16 + g, r1 = r0 + 8;

  for (int j0 = 0; j0 < E * hid; j0 += kChunkBf16) {
    const int e = j0 / hid, h0 = j0 % hid;
    __syncthreads();  // the previous chunk's readers of ws and hs are done
    // W1 chunk: word (kp, n) = {w1[e][2kp][h0 + n], w1[e][2kp + 1][h0 + n]};
    // 8-byte loads of 4 columns, unrolled so that many are in flight
    const __nv_bfloat16* w1e = w1 + size_t(e) * D * hid + h0;
    constexpr int kW1Items = (D / 2) * (kChunkBf16 / 4);
    static_assert(kW1Items % kMoeThreads == 0, "W1 staging");
#pragma unroll 8
    for (int it = 0; it < kW1Items / kMoeThreads; ++it) {
      const int i = it * kMoeThreads + tid;
      const int kp = i / (kChunkBf16 / 4), n4 = i % (kChunkBf16 / 4);
      const __nv_bfloat16* src = w1e + size_t(2 * kp) * hid + 4 * n4;
      *reinterpret_cast<uint4*>(ws + kp * L::kW1s + 4 * n4) = interleave_rows(
          *reinterpret_cast<const uint2*>(src),
          *reinterpret_cast<const uint2*>(src + hid));
    }
    __syncthreads();

    // h = x . W1 chunk: this warp's two 16x8 tiles (columns 16*nq .. +15)
    float hc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t* xa = xs + r0 * L::kXs + ks * 8 + tq;
      const uint32_t a[4] = {xa[0], xa[8 * L::kXs], xa[4],
                             xa[8 * L::kXs + 4]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t* wb = ws + (ks * 8 + tq) * L::kW1s + (2 * nq + q) * 8 + g;
        mma_bf16(hc[q], a, wb[0], wb[4 * L::kW1s]);
      }
    }
    // + b1, gelu, * combine in f32 on the accumulator; one rounding to bf16
    const float c0 = cs[r0 * E + e], c1 = cs[r1 * E + e];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = (2 * nq + q) * 8 + 2 * tq;
      const float bb0 = __bfloat162float(b1[size_t(e) * hid + h0 + col]);
      const float bb1 = __bfloat162float(b1[size_t(e) * hid + h0 + col + 1]);
      hs[r0 * L::kHs + col / 2] = pack_bf16(gelu_tanh(hc[q][0] + bb0) * c0,
                                            gelu_tanh(hc[q][1] + bb1) * c0);
      hs[r1 * L::kHs + col / 2] = pack_bf16(gelu_tanh(hc[q][2] + bb0) * c1,
                                            gelu_tanh(hc[q][3] + bb1) * c1);
    }
    __syncthreads();  // W1 chunk no longer read; h chunk complete

    // W2 chunk: word (kp, n) = {w2[e][h0 + 2kp][n], w2[e][h0 + 2kp + 1][n]}
    const __nv_bfloat16* w2e = w2 + (size_t(e) * hid + h0) * D;
    constexpr int kW2Items = (kChunkBf16 / 2) * (D / 4);
    static_assert(kW2Items % kMoeThreads == 0, "W2 staging");
#pragma unroll 8
    for (int it = 0; it < kW2Items / kMoeThreads; ++it) {
      const int i = it * kMoeThreads + tid;
      const int kp = i / (D / 4), n4 = i % (D / 4);
      const __nv_bfloat16* src = w2e + size_t(2 * kp) * D + 4 * n4;
      *reinterpret_cast<uint4*>(ws + kp * L::kW2s + 4 * n4) = interleave_rows(
          *reinterpret_cast<const uint2*>(src),
          *reinterpret_cast<const uint2*>(src + D));
    }
    __syncthreads();

    // out += h . W2 chunk
#pragma unroll
    for (int ks = 0; ks < kChunkBf16 / 16; ++ks) {
      const uint32_t* ha = hs + r0 * L::kHs + ks * 8 + tq;
      const uint32_t a[4] = {ha[0], ha[8 * L::kHs], ha[4],
                             ha[8 * L::kHs + 4]};
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const uint32_t* wb =
            ws + (ks * 8 + tq) * L::kW2s + (nq * kNT + i) * 8 + g;
        mma_bf16(acc[i], a, wb[0], wb[4 * L::kW2s]);
      }
    }
  }

  // + combine . b2 (f32), one rounding, one store
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int col = (nq * kNT + i) * 8 + 2 * tq;
    float cb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = 0; e < E; ++e) {
      const float ba = __bfloat162float(b2[size_t(e) * D + col]);
      const float bb = __bfloat162float(b2[size_t(e) * D + col + 1]);
      const float ca = cs[r0 * E + e], cc = cs[r1 * E + e];
      cb[0] = fmaf(ca, ba, cb[0]);
      cb[1] = fmaf(ca, bb, cb[1]);
      cb[2] = fmaf(cc, ba, cb[2]);
      cb[3] = fmaf(cc, bb, cb[3]);
    }
    if (s0 + r0 < S) {
      *reinterpret_cast<uint32_t*>(out + size_t(s0 + r0) * D + col) =
          pack_bf16(acc[i][0] + cb[0], acc[i][1] + cb[1]);
    }
    if (s0 + r1 < S) {
      *reinterpret_cast<uint32_t*>(out + size_t(s0 + r1) * D + col) =
          pack_bf16(acc[i][2] + cb[2], acc[i][3] + cb[3]);
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kChunkF32 = 32;  // hidden columns per chunk

template <int D>
struct MoeF32Layout {
  static constexpr int kXs = D + 4;  // x tile row stride (floats)
  static constexpr int kHs = kChunkF32 + 1;
  static constexpr size_t bytes(int experts) {
    return 4 * (size_t(kMoeTile) * kXs + size_t(D) * kChunkF32 +
                size_t(kMoeTile) * kHs + size_t(kMoeTile) * experts);
  }
};

// Thread (r, cq) = (tid / 8, tid % 8) owns token row r of the tile: in the
// first product hidden columns 4cq .. 4cq+3 of the chunk, in the second the
// output columns 4cq + 32v .. +3 for v < D/32.
template <int D>
__global__ void __launch_bounds__(kMoeThreads) moe_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ combine,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int S, int E, int hid) {
  using L = MoeF32Layout<D>;
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;
  float* ws = xs + kMoeTile * L::kXs;
  float* hs = ws + D * kChunkF32;
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
  float acc[kV][4];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[v][c] = 0.f;
  }

  for (int j0 = 0; j0 < E * hid; j0 += kChunkF32) {
    const int e = j0 / hid, h0 = j0 % hid;
    __syncthreads();
    // W1 chunk [D][32]: ws[d][n] = w1[e][d][h0 + n]
    const float* w1e = w1 + size_t(e) * D * hid + h0;
    for (int i = tid; i < D * (kChunkF32 / 4); i += kMoeThreads) {
      const int d = i / (kChunkF32 / 4), c = i % (kChunkF32 / 4);
      *reinterpret_cast<float4*>(ws + d * kChunkF32 + 4 * c) =
          *reinterpret_cast<const float4*>(w1e + size_t(d) * hid + 4 * c);
    }
    __syncthreads();
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    const float* xr = xs + r * L::kXs;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a = xr[d];
      const float4 w = *reinterpret_cast<const float4*>(ws + d * kChunkF32 +
                                                        4 * cq);
      h[0] = fmaf(a, w.x, h[0]);
      h[1] = fmaf(a, w.y, h[1]);
      h[2] = fmaf(a, w.z, h[2]);
      h[3] = fmaf(a, w.w, h[3]);
    }
    const float cw = cs[r * E + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float bias = b1[size_t(e) * hid + h0 + 4 * cq + c];
      hs[r * L::kHs + 4 * cq + c] = gelu_tanh(h[c] + bias) * cw;
    }
    __syncthreads();
    // W2 chunk [32][D]: ws[k][n] = w2[e][h0 + k][n]
    const float* w2e = w2 + (size_t(e) * hid + h0) * D;
    for (int i = tid; i < kChunkF32 * (D / 4); i += kMoeThreads) {
      reinterpret_cast<float4*>(ws)[i] =
          reinterpret_cast<const float4*>(w2e)[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunkF32; ++k) {
      const float a = hs[r * L::kHs + k];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float4 w = *reinterpret_cast<const float4*>(ws + k * D + 4 * cq +
                                                          32 * v);
        acc[v][0] = fmaf(a, w.x, acc[v][0]);
        acc[v][1] = fmaf(a, w.y, acc[v][1]);
        acc[v][2] = fmaf(a, w.z, acc[v][2]);
        acc[v][3] = fmaf(a, w.w, acc[v][3]);
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
cudaError_t launch_moe(Kernel kernel, size_t smem, const void* x,
                       const void* combine, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int S,
                       int E, int hid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (S + kMoeTile - 1) / kMoeTile;
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
  if (is_bf16) {
    return launch_moe<decltype(&moe_bf16_kernel<D>), __nv_bfloat16>(
        &moe_bf16_kernel<D>, MoeBf16Layout<D>::bytes(E), x, combine, w1, b1,
        w2, b2, out, S, E, hid, stream);
  }
  return launch_moe<decltype(&moe_f32_kernel<D>), float>(
      &moe_f32_kernel<D>, MoeF32Layout<D>::bytes(E), x, combine, w1, b1, w2,
      b2, out, S, E, hid, stream);
}

}  // namespace
}  // namespace mdm

// C entry for ctypes. x: [S, D]; combine: [S, E]; w1: [E, D, hid];
// b1: [E, hid]; w2: [E, hid, D]; b2: [E, D]; out: [S, D]; all contiguous,
// 16-byte aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Returns the CUDA
// error code of the launch (0 on success); a D other than the instantiated
// multiples of 128 up to 768, hid not a multiple of 128, or E outside
// [1, 64] return cudaErrorInvalidValue.
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
#undef MDM_MOE_CASE
  return int(cudaErrorInvalidValue);
}
