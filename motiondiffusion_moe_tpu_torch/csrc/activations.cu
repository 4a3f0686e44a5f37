// bf16 silu, gelu (tanh form) and sigmoid with the JAX package's roundings,
// hand-written for Hopper.
//
// Replaces no Pallas kernel: in the JAX package these are flax's nn.silu,
// nn.gelu and nn.sigmoid, which XLA fuses into the neighbouring elementwise
// code. In bf16 XLA takes each step in f32 and rounds it to bf16 (sigmoid as
// 1 / (1 + exp(-x)); gelu's weakly typed constants as bf16), and so does this
// kernel, with expf and tanhf rather than the fast intrinsics, so that it
// gives the bits of the plain version (ops/activations.py). Where the
// activation follows a Dense, the kernel also takes the un-biased product and
// the Dense bias [C]: y = act(bf16(x + bias[i % C])), the add that flax does
// in bf16 after rounding the product.
//
// The gradient pass takes the cotangent g as well and writes dx as jax.grad
// of the bf16 flax function computes it (its transposed program: the
// sigmoid of the forward, s * (1 - s), and each product and sum of the chain
// rule, every step in f32 rounded to bf16), the steps of
// ops/activations.py::activation_grad_plain.
//
// What bounds it on the card: memory (one bf16 read and one write per value;
// a few tens of f32 operations). Design: a grid-stride loop over 8-value
// (16-byte) chunks, one per thread and step, where the sizes and pointers
// allow it; otherwise one value per thread and step.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

enum Act : int { kSilu = 0, kGelu = 1, kSigmoid = 2 };

constexpr int kActThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 1 / (1 + exp(-x)), each step rounded but the last (the division).
__device__ __forceinline__ float sigmoid_steps(float x) {
  return 1.f / round_bf16(round_bf16(expf(round_bf16(-x))) + 1.f);
}

// The activation of one bf16 value x (already widened), before the final
// rounding, which the store does.
template <int kOp>
__device__ __forceinline__ float activation(float x) {
  if constexpr (kOp == kSigmoid) {
    return sigmoid_steps(x);
  } else if constexpr (kOp == kSilu) {
    return x * round_bf16(sigmoid_steps(x));
  } else {
    const float cube = round_bf16(round_bf16(x * x) * x);
    const float inner =
        round_bf16(round_bf16(x + round_bf16(cube * 0.044677734375f)) *
                   0.796875f);
    const float half =
        round_bf16(round_bf16(round_bf16(tanhf(inner)) + 1.f) * 0.5f);
    return x * half;
  }
}

// g times the derivative at the bf16 value e, before the final rounding,
// with JAX's steps: e.g. silu's dx is g * s + (e * g) * (s * (1 - s)).
template <int kOp>
__device__ __forceinline__ float gradient(float e, float g) {
  if constexpr (kOp == kGelu) {
    const float square = round_bf16(e * e);
    const float cube = round_bf16(square * e);
    const float th = round_bf16(tanhf(round_bf16(
        round_bf16(e + round_bf16(cube * 0.044677734375f)) * 0.796875f)));
    const float half = round_bf16(round_bf16(th + 1.f) * 0.5f);
    const float y =
        round_bf16(round_bf16(round_bf16(e * g) * 0.5f) * round_bf16(1.f - th));
    const float inner = round_bf16(round_bf16(y + round_bf16(y * th)) *
                                   0.796875f);
    return round_bf16(round_bf16(g * half) + inner) +
           round_bf16(round_bf16(inner * 0.044677734375f) *
                      round_bf16(square * 3.f));
  } else {
    const float s = round_bf16(sigmoid_steps(e));
    const float d = round_bf16(s * round_bf16(1.f - s));
    if constexpr (kOp == kSigmoid) {
      return g * d;
    } else {
      return round_bf16(g * s) + round_bf16(round_bf16(e * g) * d);
    }
  }
}

// One value: the activation of bf16(x + bias), or with a cotangent its
// gradient.
template <int kOp, bool kGrad>
__device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 x,
                                               const __nv_bfloat16* bias,
                                               long long col,
                                               __nv_bfloat16 g) {
  float v = __bfloat162float(x);
  if (bias != nullptr) v = round_bf16(v + __bfloat162float(bias[col]));
  if constexpr (kGrad) {
    return __float2bfloat16_rn(gradient<kOp>(v, __bfloat162float(g)));
  } else {
    return __float2bfloat16_rn(activation<kOp>(v));
  }
}

// kVec: 8 values per thread and step (n and C multiples of 8, 16-byte
// aligned pointers), else one. g: the cotangent of the gradient pass (kGrad)
// or unused.
template <int kOp, bool kGrad, bool kVec>
__global__ void __launch_bounds__(kActThreads) activation_kernel(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ y,
    long long n, int C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const __nv_bfloat16 none = __float2bfloat16_rn(0.f);
  if constexpr (kVec) {
    for (; i < n / 8; i += stride) {
      const uint4 in = reinterpret_cast<const uint4*>(x)[i];
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&in);
      uint4 cot = in;
      if constexpr (kGrad) cot = reinterpret_cast<const uint4*>(g)[i];
      const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&cot);
      uint4 out;
      __nv_bfloat16* yv = reinterpret_cast<__nv_bfloat16*>(&out);
      const long long col = (i * 8) % C;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yv[j] = apply<kOp, kGrad>(xv[j], bias, col + j, gv[j]);
      }
      reinterpret_cast<uint4*>(y)[i] = out;
    }
  } else {
    for (; i < n; i += stride) {
      y[i] = apply<kOp, kGrad>(x[i], bias, i % C, kGrad ? g[i] : none);
    }
  }
}

template <int kOp, bool kGrad>
cudaError_t launch_activation(const void* x, const void* bias, const void* g,
                              void* y, long long n, int C,
                              cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = n % 8 == 0 && C % 8 == 0 && aligned(x) && aligned(y) &&
                   (bias == nullptr || aligned(bias)) &&
                   (!kGrad || aligned(g));
  const long long items = vec ? n / 8 : n;
  const long long blocks = (items + kActThreads - 1) / kActThreads;
  const int grid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* bp = static_cast<const __nv_bfloat16*>(bias);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (vec) {
    activation_kernel<kOp, kGrad, true>
        <<<grid, kActThreads, 0, stream>>>(xp, bp, gp, yp, n, C);
  } else {
    activation_kernel<kOp, kGrad, false>
        <<<grid, kActThreads, 0, stream>>>(xp, bp, gp, yp, n, C);
  }
  return cudaGetLastError();
}

template <bool kGrad>
int dispatch(const void* x, const void* bias, const void* g, void* y,
             long long n, int C, int op, void* stream) {
  if (n <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSilu:
      return int(launch_activation<kSilu, kGrad>(x, bias, g, y, n, C, s));
    case kGelu:
      return int(launch_activation<kGelu, kGrad>(x, bias, g, y, n, C, s));
    case kSigmoid:
      return int(launch_activation<kSigmoid, kGrad>(x, bias, g, y, n, C, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace mdm

// C entries for ctypes. x, y: n contiguous bf16 values; bias: C bf16 values
// added to each row of C before the activation, or null; op 0 silu, 1 gelu,
// 2 sigmoid. Return the CUDA error code of the launch (0 on success);
// another op or a non-positive n or C returns cudaErrorInvalidValue.
extern "C" int mdm_activation(const void* x, const void* bias, void* y,
                              long long n, int C, int op, void* stream) {
  return mdm::dispatch<false>(x, bias, nullptr, y, n, C, op, stream);
}

// The gradient pass: g the cotangent (n bf16 values), dx written to y.
extern "C" int mdm_activation_grad(const void* x, const void* bias,
                                   const void* g, void* y, long long n, int C,
                                   int op, void* stream) {
  return mdm::dispatch<true>(x, bias, g, y, n, C, op, stream);
}
