// Fused Performer epilogue, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/performer_pallas.py::_epilogue_kernel
// (public entry performer_epilogue). Per row of y [B, T, D]:
//
//   LayerNorm(post) -> x / max(|x|, 1e-12) * sqrt(D) -> LayerNorm(style)
//   -> * (1 + scale[b]) + shift[b] -> SiLU
//
// all in f32, with one read of y and one write of the result in y's dtype.
//
// What bounds it on the card: device-memory bandwidth. Per element it does
// ~20 flops and one exp against 2 bytes read and 2 written (bf16), far below
// the H100's ~295 flops/byte line, so the only lever is to touch y once:
// the three normalisation passes run out of registers.
//
// Design: one warp per row (D/32 values per lane, lane-strided so that each
// load and store instruction of the warp covers consecutive addresses), 8
// rows per block of 256 threads; every reduction is a warp shuffle, so the
// kernel needs no shared memory and no block barrier.

#include <cstddef>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kEpiThreads = 256;
constexpr int kEpiRows = kEpiThreads / 32;

// LayerNorm of one row held lane-strided in x (column = lane + 32*k).
template <int V>
__device__ __forceinline__ void layer_norm_row(float (&x)[V],
                                               const float* __restrict__ w,
                                               const float* __restrict__ b,
                                               int lane) {
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
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    x[k] = (x[k] - mu) * inv * w[c] + b[c];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kEpiThreads) performer_epilogue_kernel(
    const T* __restrict__ y, const T* __restrict__ scale,
    const T* __restrict__ shift, const float* __restrict__ post_scale,
    const float* __restrict__ post_bias, const float* __restrict__ style_scale,
    const float* __restrict__ style_bias, T* __restrict__ out, int rows,
    int seq_len) {
  constexpr int D = V * 32;
  const int row = blockIdx.x * kEpiRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the same for all lanes of the warp
  const size_t b = size_t(row / seq_len);
  const T* yr = y + size_t(row) * D;

  float x[V];
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = to_f32(yr[lane + 32 * k]);
  layer_norm_row<V>(x, post_scale, post_bias, lane);

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) ss = fmaf(x[k], x[k], ss);
  const float norm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
  const float sqrt_d = sqrtf(float(D));
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = x[k] / norm * sqrt_d;
  layer_norm_row<V>(x, style_scale, style_bias, lane);

  const T* sc = scale + b * D;
  const T* sh = shift + b * D;
  T* dst = out + size_t(row) * D;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    const float hv = x[k] * (1.f + to_f32(sc[c])) + to_f32(sh[c]);
    dst[c] = from_f32<T>(hv / (1.f + expf(-hv)));
  }
}

template <typename T, int V>
cudaError_t launch_epilogue(const void* y, const void* scale,
                            const void* shift, const void* post_scale,
                            const void* post_bias, const void* style_scale,
                            const void* style_bias, void* out, int rows,
                            int seq_len, cudaStream_t stream) {
  const int blocks = (rows + kEpiRows - 1) / kEpiRows;
  performer_epilogue_kernel<T, V><<<blocks, kEpiThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<const float*>(post_scale),
      static_cast<const float*>(post_bias),
      static_cast<const float*>(style_scale),
      static_cast<const float*>(style_bias), static_cast<T*>(out), rows,
      seq_len);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// C entry for ctypes. y/out: [B, T, D] contiguous; scale, shift: [B, D] in
// y's dtype (f32 when is_bf16 = 0, bf16 when 1); the four LayerNorm vectors:
// [D] f32. rows = B * T. Returns the CUDA error code of the launch (0 on
// success); widths other than the instantiated ones return
// cudaErrorInvalidValue.
extern "C" int mdm_performer_epilogue(const void* y, const void* scale,
                                      const void* shift,
                                      const void* post_scale,
                                      const void* post_bias,
                                      const void* style_scale,
                                      const void* style_bias, void* out,
                                      int rows, int seq_len, int dim,
                                      int is_bf16, void* stream) {
  using mdm::launch_epilogue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_EPILOGUE_CASE(D_)                                                \
  if (dim == D_) {                                                           \
    return int(is_bf16 ? launch_epilogue<__nv_bfloat16, D_ / 32>(            \
                             y, scale, shift, post_scale, post_bias,         \
                             style_scale, style_bias, out, rows, seq_len, s) \
                       : launch_epilogue<float, D_ / 32>(                    \
                             y, scale, shift, post_scale, post_bias,         \
                             style_scale, style_bias, out, rows, seq_len,    \
                             s));                                            \
  }
  MDM_EPILOGUE_CASE(256)
  MDM_EPILOGUE_CASE(512)
  MDM_EPILOGUE_CASE(768)
#undef MDM_EPILOGUE_CASE
  return int(cudaErrorInvalidValue);
}
