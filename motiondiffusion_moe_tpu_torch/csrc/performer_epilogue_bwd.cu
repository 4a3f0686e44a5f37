// Backward of the fused Performer epilogue, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/performer_pallas_bwd.py::_epilogue_bwd_kernel
// (public entry epilogue_bwd_pallas): for the forward of
// performer_epilogue.cu,
//
//   h1 = LN(y; post) -> h2 = h1 / max(|h1|, 1e-12) * sqrt(D)
//   -> h3 = LN(h2; style) -> h4 = h3 * (1 + scale[b]) + shift[b] -> SiLU,
//
// it recomputes the chain per row from y and returns dy, the per-batch-row
// d(scale) and d(shift), and the gradients of the four LayerNorm vectors.
// Gradient conventions follow performer_pallas_bwd.py:20-28 (the L2 max()
// passes gradient iff |h1| >= 1e-12).
//
// What bounds it on the card: device-memory bandwidth, as the forward: ~60
// flops and one exp per element against reading y and g and writing dy
// (6 bytes per element in bf16).
//
// Design: one warp per row, D/32 values per lane, lane-strided as in the
// forward; every row reduction is a warp shuffle. A block of 8 warps owns a
// chunk of 32 rows of one batch row b (grid: ceil(T/32) chunks x B, 224
// blocks at B = 32, T = 196, enough for the 132 SMs; one block per batch row
// would give only 32). Each lane accumulates its columns of the six
// parameter gradients over its rows in registers; the block reduces them
// across its warps in shared memory and writes one partial per chunk. A
// second small kernel sums the partials in a fixed order: over the chunks
// of b for d(scale) and d(shift), over all chunks for the LayerNorm vectors.
// No atomics, so repeated runs give identical bits.

#include <cstddef>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kEbThreads = 256;
constexpr int kEbWarps = kEbThreads / 32;
constexpr int kEbChunk = 32;  // rows of one batch row per block
constexpr int kEbParts = 6;   // dscale, dshift, dpost_s, dpost_b, dstyle_s,
                              // dstyle_b

// LayerNorm forward of one lane-strided row: z and 1/std.
template <int V>
__device__ __forceinline__ float ln_stats(const float (&x)[V], float (&z)[V]) {
  constexpr float kInvD = 1.0f / float(V * 32);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) s += x[k];
  const float mu = warp_sum(s) * kInvD;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = x[k] - mu;
    v = fmaf(d, d, v);
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) * kInvD + kLnEps);
#pragma unroll
  for (int k = 0; k < V; ++k) z[k] = (x[k] - mu) * inv;
  return inv;
}

template <typename T, int V>
__global__ void __launch_bounds__(kEbThreads) performer_epilogue_bwd_kernel(
    const T* __restrict__ y, const T* __restrict__ scale,
    const T* __restrict__ shift, const float* __restrict__ post_scale,
    const float* __restrict__ post_bias, const float* __restrict__ style_scale,
    const float* __restrict__ style_bias, const T* __restrict__ g,
    T* __restrict__ dy, float* __restrict__ part, int seq_len) {
  constexpr int D = V * 32;
  __shared__ float red[kEbWarps][D];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float sqrt_d = sqrtf(float(D));

  // the parameter vectors are read per row through the cache rather than
  // held in registers: the six accumulators and the row already take
  // ~180 of them at D = 512
  const T* sc = scale + size_t(b) * D;
  const T* sh = shift + size_t(b) * D;
  float acc[kEbParts][V];
#pragma unroll
  for (int q = 0; q < kEbParts; ++q) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[q][k] = 0.f;
  }

  constexpr float kInvD = 1.0f / float(D);
  const int t_end = min(seq_len, (chunk + 1) * kEbChunk);
  for (int t = chunk * kEbChunk + warp; t < t_end; t += kEbWarps) {
    const size_t row = size_t(b) * seq_len + t;
    float x[V], z1[V], h1[V], z3[V], dh[V];
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f32(y[row * D + lane + 32 * k]);
    const float i1 = ln_stats<V>(x, z1);
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      h1[k] = z1[k] * post_scale[c] + post_bias[c];
      sq = fmaf(h1[k], h1[k], sq);
    }
    const float n = sqrtf(warp_sum(sq));
    const float mx = fmaxf(n, 1e-12f);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = h1[k] / mx * sqrt_d;  // h2
    const float i3 = ln_stats<V>(x, z3);
    // SiLU and modulation backward, then the style LayerNorm backward:
    // dh holds d(h3), then d(h2)
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      const float gk = to_f32(g[row * D + c]);
      const float s1 = 1.f + to_f32(sc[c]);
      const float h3 = z3[k] * style_scale[c] + style_bias[c];
      const float h4 = h3 * s1 + to_f32(sh[c]);
      const float sig = 1.f / (1.f + expf(-h4));
      const float dh4 = gk * sig * (1.f + h4 * (1.f - sig));
      acc[0][k] = fmaf(dh4, h3, acc[0][k]);  // d(scale)
      acc[1][k] += dh4;                       // d(shift)
      dh[k] = dh4 * s1;
      acc[4][k] = fmaf(dh[k], z3[k], acc[4][k]);  // d(style_scale)
      acc[5][k] += dh[k];                         // d(style_bias)
      const float sg = style_scale[c] * dh[k];
      a1 += sg;
      a2 = fmaf(sg, z3[k], a2);
    }
    a1 = warp_sum(a1) * kInvD;
    a2 = warp_sum(a2) * kInvD;
    float t_dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      dh[k] = i3 * (style_scale[c] * dh[k] - a1 - z3[k] * a2);
      t_dot = fmaf(dh[k], h1[k], t_dot);
    }
    t_dot = warp_sum(t_dot);
    // L2 backward (dh becomes d(h1)), then the post LayerNorm backward
    const float inv_n = n > 0.f ? 1.f / n : 0.f;
    const float live = n >= 1e-12f ? 1.f : 0.f;
    const float kl2 = sqrt_d * t_dot / (mx * mx) * live * inv_n;
    a1 = 0.f;
    a2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      dh[k] = dh[k] * sqrt_d / mx - h1[k] * kl2;
      acc[2][k] = fmaf(dh[k], z1[k], acc[2][k]);  // d(post_scale)
      acc[3][k] += dh[k];                         // d(post_bias)
      const float sg = post_scale[c] * dh[k];
      a1 += sg;
      a2 = fmaf(sg, z1[k], a2);
    }
    a1 = warp_sum(a1) * kInvD;
    a2 = warp_sum(a2) * kInvD;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      dy[row * D + c] =
          from_f32<T>(i1 * (post_scale[c] * dh[k] - a1 - z1[k] * a2));
    }
  }

  // block partial of each of the six sums, reduced across warps in order
  float* out = part + (size_t(b) * gridDim.x + chunk) * kEbParts * D;
#pragma unroll
  for (int q = 0; q < kEbParts; ++q) {
#pragma unroll
    for (int k = 0; k < V; ++k) red[warp][lane + 32 * k] = acc[q][k];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kEbThreads) {
      float s = 0.f;
      for (int w = 0; w < kEbWarps; ++w) s += red[w][d];
      out[q * D + d] = s;
    }
    __syncthreads();
  }
}

// Second pass: d(scale)[b] and d(shift)[b] sum the chunks of batch row b;
// the four LayerNorm vectors sum every chunk of every batch row, in order.
template <typename T>
__global__ void epilogue_bwd_reduce_kernel(
    const float* __restrict__ part, T* __restrict__ dscale,
    T* __restrict__ dshift, float* __restrict__ dps, float* __restrict__ dpb,
    float* __restrict__ dss, float* __restrict__ dsb, int batch, int chunks,
    int dim) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_batch = 2 * batch * dim;
  if (j < per_batch) {
    const int q = j / (batch * dim);
    const int b = (j / dim) % batch;
    const int d = j % dim;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) {
      s += part[((size_t(b) * chunks + c) * kEbParts + q) * dim + d];
    }
    (q == 0 ? dscale : dshift)[size_t(b) * dim + d] = from_f32<T>(s);
    return;
  }
  if (j >= per_batch + 4 * dim) return;
  const int q = 2 + (j - per_batch) / dim;
  const int d = (j - per_batch) % dim;
  float s = 0.f;
  for (int bc = 0; bc < batch * chunks; ++bc) {
    s += part[(size_t(bc) * kEbParts + q) * dim + d];
  }
  float* dst[4] = {dps, dpb, dss, dsb};
  dst[q - 2][d] = s;
}

int epilogue_chunks(int seq_len) { return (seq_len + kEbChunk - 1) / kEbChunk; }

template <typename T, int V>
cudaError_t launch_epilogue_bwd(const void* y, const void* scale,
                                const void* shift, const void* post_scale,
                                const void* post_bias, const void* style_scale,
                                const void* style_bias, const void* g,
                                void* dy, void* dscale, void* dshift,
                                void* dps, void* dpb, void* dss, void* dsb,
                                void* scratch, int batch, int seq_len,
                                cudaStream_t stream) {
  constexpr int D = V * 32;
  const int chunks = epilogue_chunks(seq_len);
  float* part = static_cast<float*>(scratch);
  performer_epilogue_bwd_kernel<T, V>
      <<<dim3(chunks, batch), kEbThreads, 0, stream>>>(
          static_cast<const T*>(y), static_cast<const T*>(scale),
          static_cast<const T*>(shift), static_cast<const float*>(post_scale),
          static_cast<const float*>(post_bias),
          static_cast<const float*>(style_scale),
          static_cast<const float*>(style_bias), static_cast<const T*>(g),
          static_cast<T*>(dy), part, seq_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 2 * batch * D + 4 * D;
  epilogue_bwd_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dscale), static_cast<T*>(dshift),
      static_cast<float*>(dps), static_cast<float*>(dpb),
      static_cast<float*>(dss), static_cast<float*>(dsb), batch, chunks, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// Floats of scratch mdm_performer_epilogue_bwd needs (the caller allocates
// it).
extern "C" long long mdm_performer_epilogue_bwd_scratch_floats(int batch,
                                                               int seq_len,
                                                               int dim) {
  return static_cast<long long>(batch) * mdm::epilogue_chunks(seq_len) *
         mdm::kEbParts * dim;
}

// C entry for ctypes. y, g, dy: [B, T, D] contiguous; scale, shift, dscale,
// dshift: [B, D]; all in one dtype, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// The four LayerNorm vectors and their gradients: [D] f32. scratch: f32, of
// mdm_performer_epilogue_bwd_scratch_floats. Returns the CUDA error code of
// the launches (0 on success); widths other than the instantiated ones
// return cudaErrorInvalidValue.
extern "C" int mdm_performer_epilogue_bwd(
    const void* y, const void* scale, const void* shift,
    const void* post_scale, const void* post_bias, const void* style_scale,
    const void* style_bias, const void* g, void* dy, void* dscale,
    void* dshift, void* dps, void* dpb, void* dss, void* dsb, void* scratch,
    int batch, int seq_len, int dim, int is_bf16, void* stream) {
  using mdm::launch_epilogue_bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_EPILOGUE_BWD_CASE(D_)                                             \
  if (dim == D_) {                                                            \
    return int(is_bf16 ? launch_epilogue_bwd<__nv_bfloat16, D_ / 32>(        \
                             y, scale, shift, post_scale, post_bias,          \
                             style_scale, style_bias, g, dy, dscale, dshift,  \
                             dps, dpb, dss, dsb, scratch, batch, seq_len, s)  \
                       : launch_epilogue_bwd<float, D_ / 32>(                 \
                             y, scale, shift, post_scale, post_bias,          \
                             style_scale, style_bias, g, dy, dscale, dshift,  \
                             dps, dpb, dss, dsb, scratch, batch, seq_len,     \
                             s));                                             \
  }
  MDM_EPILOGUE_BWD_CASE(256)
  MDM_EPILOGUE_BWD_CASE(512)
  MDM_EPILOGUE_BWD_CASE(768)
#undef MDM_EPILOGUE_BWD_CASE
  return int(cudaErrorInvalidValue);
}
