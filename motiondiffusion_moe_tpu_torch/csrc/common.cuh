// Small device helpers shared by the hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mdm {

// LayerNorm epsilon of the JAX reference (flax.linen.LayerNorm default).
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round-to-nearest-even, the rounding of torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load N consecutive floats from shared memory with one vector access where
// the width allows it (a 16-byte access per lane is conflict-free across a
// warp); `p` must be aligned to the vector width.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// ---- bf16 tensor-core products (mma.sync m16n8k16), shared by the kernels
// that stage a bf16 operand in shared memory as 32-bit words, each holding
// two neighbours along the contracted axis (the lower k in the low half).

// Two rows of 4 bf16 each (lo: row k, hi: row k + 1, columns n .. n+3) ->
// the 4 words {row k, row k + 1} of columns n .. n+3.
__device__ __forceinline__ uint4 interleave_rows(uint2 lo, uint2 hi) {
  return make_uint4(__byte_perm(lo.x, hi.x, 0x5410),
                    __byte_perm(lo.x, hi.x, 0x7632),
                    __byte_perm(lo.y, hi.y, 0x5410),
                    __byte_perm(lo.y, hi.y, 0x7632));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, bf16, row-major) . B (16x8, bf16, col-major).
// a[0..3]: rows g / g+8, k 2t..2t+1 and 2t+8..2t+9; b0 / b1: k 2t..2t+1 and
// 2t+8..2t+9 of column g; c: rows g / g+8, columns 2t..2t+1 (g = lane / 4,
// t = lane % 4). Each 32-bit register holds the lower k in its low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The FAVOR+ feature map exp(clip(logit, -15, 15)) * 0.1.
__device__ __forceinline__ float feature(float logit) {
  return expf(fminf(fmaxf(logit, -15.f), 15.f)) * 0.1f;
}

// Statistics of one normalize_row call: LayerNorm mean and 1/std, the L2
// sum of squares n2 and factor r = 1/sqrt(max(n2, 1e-24)) (r = 1 without
// L2). All zero for a row past the sequence end.
struct RowStats {
  float mu, inv, n2, r;
};

// One warp normalizes one D-wide row: x * pre_scale -> LayerNorm(g, beta),
// then L2 when `l2`. Lane l holds columns [l*C, l*C + C). A row past the
// sequence end (`valid` false) is written as zeros. `valid` is the same for
// all lanes, so the early return keeps the shuffles convergent.
//
// The forward kernel (favor_qkv.cu) and its backward (favor_qkv_bwd.cu)
// both normalize through this one function, so the backward recomputes the
// forward's rows, and from them its feature logits, bit for bit: the clip
// pass-through masks of the backward agree with the loss that was computed.
template <typename T, int C>
__device__ __forceinline__ RowStats normalize_row(
    const T* __restrict__ src, bool valid, const float (&g)[C],
    const float (&beta)[C], float pre_scale, bool l2, float* dst, int lane) {
  constexpr float kInvD = 1.0f / float(C * 32);
  if (!valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[lane * C + c] = 0.f;
    return RowStats{0.f, 0.f, 0.f, 0.f};
  }
  float x[C];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = to_f32(src[lane * C + c]) * pre_scale;
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
  for (int c = 0; c < C; ++c) x[c] = (x[c] - mu) * inv * g[c] + beta[c];
  float n2 = 0.f, r = 1.f;
  if (l2) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) ss = fmaf(x[c], x[c], ss);
    n2 = warp_sum(ss);
    r = 1.0f / sqrtf(fmaxf(n2, 1e-24f));
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] *= r;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dst[lane * C + c] = x[c];
  return RowStats{mu, inv, n2, r};
}

// LayerNorm backward of one row held lane-strided (C values per lane):
// dx = inv * (s*g - mean(s*g) - z * mean(s*g*z)) for z the normalized
// input, s the LayerNorm scale, g the gradient of the LayerNorm output.
// Adds g*z and g to the scale and bias gradient accumulators.
template <int C>
__device__ __forceinline__ void layer_norm_bwd_row(
    const float (&g)[C], const float (&z)[C], const float (&s)[C], float inv,
    float (&dx)[C], float (&ds)[C], float (&dc)[C]) {
  constexpr float kInvD = 1.0f / float(C * 32);
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float sg = s[c] * g[c];
    a1 += sg;
    a2 = fmaf(sg, z[c], a2);
  }
  a1 = warp_sum(a1) * kInvD;
  a2 = warp_sum(a2) * kInvD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dx[c] = inv * (s[c] * g[c] - a1 - z[c] * a2);
    ds[c] = fmaf(g[c], z[c], ds[c]);
    dc[c] += g[c];
  }
}

}  // namespace mdm
