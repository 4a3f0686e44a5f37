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
// What bounds it on the card: device-memory bandwidth by the count of
// bytes. Per element it does ~17 f32 operations and one exp against 2 bytes
// read and 2 written (bf16), far below the H100's ~295 operations a byte;
// at the flagship (B = 32, T = 196, D = 512, bf16) y and the output are
// 12.85 MB, 3.8 us at 3.35 TB/s. So the design reads y once, 16 bytes a
// lane, and does little else per row.
//
// Design. One warp per row; lane l holds the columns 32 E j + E l .. +E-1
// (E = 16 / sizeof(T): 8 in bf16, 4 in f32; j < D / (32 E)), so that every
// load and store of a row is 16 bytes a lane on consecutive addresses. The
// rows of one batch row b are cut into C chunks of ceil(T / C) rows, one
// block of 8 warps per chunk; warp w of a block takes rows t0 + w,
// t0 + w + 8, ... The wrapper picks C to fill the card once
// (ops/performer.py::epilogue_chunks from this kernel's occupancy: 8 at the
// flagship on an H100, two blocks an SM).
//   - Every row of a block shares scale[b] and shift[b]. The block reads
//     them and the four LayerNorm vectors once, with coalesced loads, and
//     forms four per-column factors in shared memory: the post
//     LayerNorm's scale and bias, and the style LayerNorm folded into the
//     modulation, h4 = z3 ma + mb with ma = ss (1 + scale[b]) and
//     mb = sb (1 + scale[b]) + shift[b] (the fold of kernel 4,
//     performer_epilogue_bwd.cu). Each lane then keeps its columns of the
//     four in registers for all its rows. scale and shift may be strided
//     views (a row stride of their own, column stride 1), such as the two
//     halves of the [B, 2D] output of the style block's Dense.
//   - Per row: one reciprocal square root for each LayerNorm and one for
//     the L2 step (h2 = h1 sqrt(D) min(rsqrt(|h1|^2), 1e12), which is
//     h1 sqrt(D) / max(|h1|, 1e-12)); the sum and the sum of squares of h1
//     are taken in one pass (the mean of h2 is the mean of h1 times the
//     same factor). No divide per element: in bf16 the SiLU takes the fast
//     exp and divide (a few f32 ulps, well inside one bf16 ulp). In f32 the
//     kernel keeps IEEE square roots, divides and expf: their few-ulp
//     biases, summed over every token of a train step, moved some
//     parameters' gradients by 1e-3 of their size (chip_smoke.py D2).
//   - The next row's y is loaded while this one is computed, where the
//     registers allow it (up to 64 bytes a lane: bf16 up to D = 1024, f32
//     up to D = 512); the first row's load is in flight while the block
//     forms its factors.
//   - Every sum has one fixed order (a lane's values in column order, then
//     warp_sum's butterfly) and there are no atomics: the same bits on
//     every call, whatever C. tests/test_torch_epilogue_order.py emulates
//     that arithmetic on the CPU.
// What is left (scripts/kernel_variants.py, PERF.md): at the flagship it
// runs at about twice the time of a plain copy of the same bytes, whether
// the factors live in registers or in shared memory and at two to four
// blocks an SM; by a count of the source a row costs a warp ~20 f32
// instructions a value and five dependent warp sums, and the SiLU's exp
// and reciprocal take a fifth of the time.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kEpiThreads = 256;
constexpr int kEpiWarps = kEpiThreads / 32;
// the style LayerNorm folded into the modulation; scripts/kernel_variants.py
// builds the unfolded form (ss and sb read for every row) beside it
constexpr bool kFoldStyle = true;
// a lane's columns of the four per-column factors in registers for all its
// rows (true) or read from shared memory for each row (false: a variant of
// scripts/kernel_variants.py, as fast at the flagship)
constexpr bool kParamRegs = true;

// 16 bytes of T <-> 16 / sizeof(T) floats
template <typename T>
struct Pack16;
template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 u, float (&v)[8]) {
    unpack_bf16x8(u, v);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    return pack_bf16x8(v);
  }
};
template <>
struct Pack16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// float k (0..3) of a float4, k known at compile time
__device__ __forceinline__ float f4(const float4& f, int k) {
  return k == 0 ? f.x : k == 1 ? f.y : k == 2 ? f.z : f.w;
}

// Blocks an SM must hold at once: the factors in registers cost occupancy,
// in shared memory they leave room for more warps.
template <typename T, int V>
__global__ void __launch_bounds__(kEpiThreads,
                                  kParamRegs ? (V <= 16 ? 2 : 1) : 3)
    performer_epilogue_kernel(const T* __restrict__ y,
                              const T* __restrict__ scale,
                              const T* __restrict__ shift,
                              long long scale_stride, long long shift_stride,
                              const float* __restrict__ post_scale,
                              const float* __restrict__ post_bias,
                              const float* __restrict__ style_scale,
                              const float* __restrict__ style_bias,
                              T* __restrict__ out, int seq_len, int chunks) {
  using P = Pack16<T>;
  constexpr int E = P::N;    // values of one 16-byte access of y
  constexpr int G = V / E;   // 16-byte groups of y a lane holds
  constexpr int F = V / 4;   // float4 groups of a lane's values
  constexpr int Q = E / 4;   // float4 groups per 16-byte group of y
  constexpr int D = V * 32;
  static_assert(V % E == 0, "D a multiple of 32 * 16 / sizeof(T)");
  constexpr bool kPrefetch = sizeof(T) * V <= 64;
  // bf16: the fast reciprocal square roots, exp and divide, whose few f32
  // ulps vanish in the one rounding to bf16; f32: IEEE square roots,
  // divides and expf, as the f32 reference computes them (a train step in
  // f32 sums their errors over every token into the gradients)
  constexpr bool kFastMath = sizeof(T) == 2;
  constexpr float kInvD = 1.0f / float(D);
  // the four factors of the block's batch row, each [F][32] float4: lane
  // l's float4 group g (its values 4g .. 4g+3, columns 32 E j + E l + 4q
  // .. +3 for g = Q j + q) at [g][l], so that a warp reads 512 contiguous
  // bytes, conflict-free
  __shared__ __align__(16) float4 fac[4][F * 32];

  const int b = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = (seq_len + chunks - 1) / chunks;
  const int t0 = chunk * per, t1 = min(seq_len, t0 + per);
  const bool busy = t0 + warp < t1;  // this warp has a row

  uint4 raw[G];
  auto load_row = [&](int t) {
    const uint4* src = reinterpret_cast<const uint4*>(
        y + (size_t(b) * seq_len + t) * D + E * lane);
#pragma unroll
    for (int j = 0; j < G; ++j) raw[j] = src[32 * j];
  };
  // the first row in flight while the block stages its factors
  if (kPrefetch && busy) load_row(t0 + warp);

  // the factors, read once per block with coalesced loads: the post
  // LayerNorm's scale and bias, and the style LayerNorm folded into the
  // modulation, ma = ss (1 + scale[b]), mb = sb (1 + scale[b]) + shift[b]
  {
    float* f = reinterpret_cast<float*>(&fac[0][0]);
    for (int c = tid; c < D; c += kEpiThreads) {
      const int j = c / (32 * E), l = c % (32 * E) / E, e = c % E;
      const int i = ((Q * j + e / 4) * 32 + l) * 4 + e % 4;
      const float m = 1.f + to_f32(scale[b * scale_stride + c]);
      const float sh = to_f32(shift[b * shift_stride + c]);
      f[i] = post_scale[c];
      f[D + i] = post_bias[c];
      if constexpr (kFoldStyle) {
        f[2 * D + i] = style_scale[c] * m;
        f[3 * D + i] = style_bias[c] * m + sh;
      } else {
        f[2 * D + i] = m;
        f[3 * D + i] = sh;
      }
    }
  }
  __syncthreads();
  if (!busy) return;
  float4 reg[kParamRegs ? 4 : 1][kParamRegs ? F : 1];
  if constexpr (kParamRegs) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int g = 0; g < F; ++g) reg[a][g] = fac[a][32 * g + lane];
    }
  }
  auto factor = [&](int a, int g) -> float4 {
    if constexpr (kParamRegs) {
      return reg[a][g];
    } else {
      return fac[a][32 * g + lane];
    }
  };
  const float sqrt_d = sqrtf(float(D));

  for (int t = t0 + warp; t < t1; t += kEpiWarps) {
    if (!kPrefetch) load_row(t);
    float x[V];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float a[E];
      P::unpack(raw[j], a);
#pragma unroll
      for (int e = 0; e < E; ++e) x[E * j + e] = a[e];
    }
    if (kPrefetch && t + kEpiWarps < t1) load_row(t + kEpiWarps);

    // the post LayerNorm: x becomes x - mu1, then h1 = (x - mu1) i1 ps + pb
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) s += x[v];
    const float mu1 = warp_sum(s) * kInvD;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x[v] -= mu1;
      var = fmaf(x[v], x[v], var);
    }
    var = warp_sum(var) * kInvD + kLnEps;
    const float i1 = kFastMath ? rsqrtf(var) : 1.f / sqrtf(var);
    float s1 = 0.f, q1 = 0.f;
#pragma unroll
    for (int g = 0; g < F; ++g) {
      const float4 ps = factor(0, g), pb = factor(1, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = 4 * g + k;
        x[v] = fmaf(x[v] * i1, f4(ps, k), f4(pb, k));
        s1 += x[v];
        q1 = fmaf(x[v], x[v], q1);
      }
    }
    s1 = warp_sum(s1);
    q1 = warp_sum(q1);
    // the L2 step, h2 = h1 rmx with rmx = sqrt(D) / max(|h1|, 1e-12), and
    // the style LayerNorm's mean of h2
    const float rmx = kFastMath ? sqrt_d * fminf(rsqrtf(q1), 1e12f)
                                : sqrt_d / fmaxf(sqrtf(q1), 1e-12f);
    const float mu3 = s1 * kInvD * rmx;
    var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x[v] = fmaf(x[v], rmx, -mu3);
      var = fmaf(x[v], x[v], var);
    }
    var = warp_sum(var) * kInvD + kLnEps;
    const float i3 = kFastMath ? rsqrtf(var) : 1.f / sqrtf(var);

    // the style LayerNorm's scale and bias with the modulation, then SiLU
    uint4* dst = reinterpret_cast<uint4*>(
        out + (size_t(b) * seq_len + t) * D + E * lane);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float o[E];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int g = Q * j + q;
        const float4 ma = factor(2, g), mb = factor(3, g);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int v = 4 * g + k;
          float h4;
          if constexpr (kFoldStyle) {
            h4 = fmaf(x[v] * i3, f4(ma, k), f4(mb, k));
          } else {
            const int c = 32 * E * j + E * lane + 4 * q + k;
            h4 = fmaf(fmaf(x[v] * i3, style_scale[c], style_bias[c]),
                      f4(ma, k), f4(mb, k));
          }
          if constexpr (kFastMath) {
            o[4 * q + k] = __fdividef(h4, 1.f + __expf(-h4));
          } else {
            o[4 * q + k] = h4 / (1.f + expf(-h4));
          }
        }
      }
      dst[32 * j] = P::pack(o);
    }
  }
}

template <typename T, int V>
cudaError_t launch_epilogue(const void* y, const void* scale,
                            const void* shift, long long scale_stride,
                            long long shift_stride, const void* post_scale,
                            const void* post_bias, const void* style_scale,
                            const void* style_bias, void* out, int batch,
                            int seq_len, int chunks, cudaStream_t stream) {
  performer_epilogue_kernel<T, V>
      <<<batch * chunks, kEpiThreads, 0, stream>>>(
          static_cast<const T*>(y), static_cast<const T*>(scale),
          static_cast<const T*>(shift), scale_stride, shift_stride,
          static_cast<const float*>(post_scale),
          static_cast<const float*>(post_bias),
          static_cast<const float*>(style_scale),
          static_cast<const float*>(style_bias), static_cast<T*>(out),
          seq_len, chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// The instantiated widths (D = 32 V): 256, 512, 768, 1024, in f32 and bf16.
#define MDM_EPILOGUE_DISPATCH(CALL)                                       \
  if (dim == 256) {                                                       \
    return int(is_bf16 ? CALL(__nv_bfloat16, 8) : CALL(float, 8));        \
  }                                                                       \
  if (dim == 512) {                                                       \
    return int(is_bf16 ? CALL(__nv_bfloat16, 16) : CALL(float, 16));      \
  }                                                                       \
  if (dim == 768) {                                                       \
    return int(is_bf16 ? CALL(__nv_bfloat16, 24) : CALL(float, 24));      \
  }                                                                       \
  if (dim == 1024) {                                                      \
    return int(is_bf16 ? CALL(__nv_bfloat16, 32) : CALL(float, 32));      \
  }

// Blocks of the kernel an SM holds at once for this width and dtype, in
// *blocks (the wrapper picks the blocks per batch row from it); returns
// the CUDA error code (0 on success).
extern "C" int mdm_performer_epilogue_blocks_per_sm(int dim, int is_bf16,
                                                    int* blocks) {
#define MDM_OCCUPANCY_CALL(T_, V_)                                        \
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(                          \
      blocks, mdm::performer_epilogue_kernel<T_, V_>, mdm::kEpiThreads, 0)
  MDM_EPILOGUE_DISPATCH(MDM_OCCUPANCY_CALL)
#undef MDM_OCCUPANCY_CALL
  return int(cudaErrorInvalidValue);
}

// C entry for ctypes. y/out: [B, T, D] contiguous, 16-byte aligned;
// scale, shift: [B, D] in y's dtype (f32 when is_bf16 = 0, bf16 when 1),
// column stride 1, row i at scale + i * scale_stride (shift likewise), each
// row 16-byte aligned; the four LayerNorm vectors: [D] f32. chunks: blocks
// per batch row, 1 <= chunks, batch * chunks < 2^31. Returns the CUDA error
// code of the launch (0 on success); widths other than the instantiated
// ones, or empty shapes, return cudaErrorInvalidValue.
extern "C" int mdm_performer_epilogue(
    const void* y, const void* scale, const void* shift,
    long long scale_stride, long long shift_stride, const void* post_scale,
    const void* post_bias, const void* style_scale, const void* style_bias,
    void* out, int batch, int seq_len, int dim, int is_bf16, int chunks,
    void* stream) {
  using mdm::launch_epilogue;
  if (batch <= 0 || seq_len <= 0 || chunks <= 0 ||
      static_cast<long long>(batch) * chunks > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_LAUNCH_CALL(T_, V_)                                              \
  launch_epilogue<T_, V_>(y, scale, shift, scale_stride, shift_stride,       \
                          post_scale, post_bias, style_scale, style_bias,    \
                          out, batch, seq_len, chunks, s)
  MDM_EPILOGUE_DISPATCH(MDM_LAUNCH_CALL)
#undef MDM_LAUNCH_CALL
  return int(cudaErrorInvalidValue);
}
#undef MDM_EPILOGUE_DISPATCH
