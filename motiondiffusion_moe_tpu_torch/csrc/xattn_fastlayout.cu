// Fast-layout exact cross-attention of f32 inputs, hand-written for Hopper.
//
// Replaces, for f32 inputs, the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/flash_attention.py::_xattn_fast_kernel (public
// entry xattn_fastlayout); bf16 inputs take csrc/cross_attention_mma.cu.
// q [B, T, H*D] and k, v [B, N, H*D] are read in the Dense output layout,
// heads as column slices; per (batch row, head):
//
//   scores = (q * scale) . k^T      [T, N], f32
//   probs  = softmax(scores)         f32, no key mask
//   out    = probs . v               f32
//
// What bounds it on the card: f32 FMA throughput. The reference keeps both
// products in f32, and so does the kernel, with IEEE f32 FMAs: at the
// flagship shape (B = 32, T = 196, N = 85, H = 4, D = 128) 1.09 GFLOP,
// 16.3 us at 67 TFLOP/s, against 36.8 MB of f32 inputs and output, 11 us at
// 3.35 TB/s.
//
// Design: one block of 8 warps per (batch row, head, 32-row tile of T): 896
// blocks at the flagship for 132 SMs. The block stages k_h and v_h [N, D]
// in shared memory (the k rows padded by 16 bytes so that 16-byte reads of
// different rows by the lanes of a warp hit distinct banks). Each warp owns
// 4 query rows and carries them together, so that every k and v value read
// from shared memory feeds 4 rows: the rows (times scale) go to shared
// memory; lane l scores keys l, l + 32, ... for all 4 rows with whole dot
// products; row max and sum are warp shuffles; the normalized probabilities
// go to shared memory; then lane l accumulates its D/32 adjacent output
// columns of the 4 rows over all N keys (one vector read of v per key) and
// stores them once.
// Each dot product is summed in order, one FMA at a time. Scores and
// probabilities never reach device memory.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kXaWarps = 8;
constexpr int kXaThreads = kXaWarps * 32;
constexpr int kXaRowsPerWarp = 4;
constexpr int kXaTile = kXaWarps * kXaRowsPerWarp;  // q rows per block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// The 16 bytes at p as 4 floats.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// C adjacent values at p (C = 2 or 4 in one vector access, else one by one),
// and C values stored at p.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = v[c];
  }
}

// Shared memory: q rows [8][4][D], probabilities [8][4][Np], then k
// [N][D + pad] and v [N][D], all f32.
template <int D>
struct XattnLayout {
  static constexpr int kVec = 4;            // floats per 16 bytes
  static constexpr int kKs = D + kVec;      // padded k row
  static constexpr int kRows = kXaWarps * kXaRowsPerWarp;
  static __host__ __device__ size_t padded_n(int n) {
    return (size_t(n) + 3) / 4 * 4;
  }
  static size_t bytes(int n) {
    return 4 * (size_t(kRows) * D + size_t(kRows) * padded_n(n)) +
           4 * size_t(n) * (kKs + D);
  }
};

template <int D>
__global__ void __launch_bounds__(kXaThreads) xattn_fastlayout_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int seq_len,
    int num_keys, int num_heads, float scale) {
  using L = XattnLayout<D>;
  constexpr int kVec = L::kVec;
  constexpr int R = kXaRowsPerWarp;
  constexpr int C = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char xa_smem[];
  const int N = num_keys;
  const size_t np = L::padded_n(N);
  float* qs = reinterpret_cast<float*>(xa_smem);
  float* ps = qs + L::kRows * D;
  float* ks = ps + L::kRows * np;
  float* vs = ks + size_t(N) * L::kKs;

  const int tiles = (seq_len + kXaTile - 1) / kXaTile;
  const int bh = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int b = bh / num_heads, h = bh % num_heads;
  const size_t HD = size_t(num_heads) * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // stage k_h and v_h, 16 bytes at a time
  constexpr int kRowVec = D / kVec;
  for (int i = tid; i < N * kRowVec; i += kXaThreads) {
    const int n = i / kRowVec, c = i % kRowVec;
    const size_t src = (size_t(b) * N + n) * HD + size_t(h) * D + c * kVec;
    *reinterpret_cast<uint4*>(ks + size_t(n) * L::kKs + c * kVec) =
        *reinterpret_cast<const uint4*>(k + src);
    *reinterpret_cast<uint4*>(vs + size_t(n) * D + c * kVec) =
        *reinterpret_cast<const uint4*>(v + src);
  }
  __syncthreads();

  const int t0 = tile * kXaTile + warp * R;
  if (t0 >= seq_len) return;  // no block barrier follows
  float* qw = qs + warp * R * D;
  float* pw = ps + warp * R * np;
  // this warp's rows times scale; rows past the sequence end are zeros
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + r;
    const float* qrow = q + (size_t(b) * seq_len + t) * HD + size_t(h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qw[r * D + lane + 32 * c] =
          t < seq_len ? qrow[lane + 32 * c] * scale : 0.f;
    }
  }
  __syncwarp();

  // scores of this lane's keys for the R rows, and the row maxima
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = __int_as_float(0xff800000);  // -inf
  for (int n = lane; n < N; n += 32) {
    const float* kr = ks + size_t(n) * L::kKs;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += kVec) {
      float kv[kVec];
      load16(kr + d, kv);
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qw + r * D + d + j);
          s[r] = fmaf(qv.x, kv[j], s[r]);
          s[r] = fmaf(qv.y, kv[j + 1], s[r]);
          s[r] = fmaf(qv.z, kv[j + 2], s[r]);
          s[r] = fmaf(qv.w, kv[j + 3], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pw[r * np + n] = s[r];
      m[r] = fmaxf(m[r], s[r]);
    }
  }
  float l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = warp_max(m[r]);
    l[r] = 0.f;
  }
  for (int n = lane; n < N; n += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = expf(pw[r * np + n] - m[r]);
      pw[r * np + n] = p;
      l[r] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = warp_sum(l[r]);
  for (int n = lane; n < N; n += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) pw[r * np + n] = pw[r * np + n] / l[r];
  }
  __syncwarp();

  // out = probs . v: lane l owns columns [l*C, l*C + C) of the R rows
  float o[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) o[r][c] = 0.f;
  }
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    float vv[C];
    load_cols<C>(vs + size_t(n) * D + lane * C, vv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = pw[r * np + n];
#pragma unroll
      for (int c = 0; c < C; ++c) o[r][c] = fmaf(p, vv[c], o[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + r;
    if (t < seq_len) {
      store_cols<C>(out + (size_t(b) * seq_len + t) * HD + size_t(h) * D +
                        lane * C,
                    o[r]);
    }
  }
}

template <int D>
cudaError_t launch_xattn(const void* q, const void* k, const void* v,
                         void* out, int batch, int seq_len, int num_keys,
                         int num_heads, float scale, cudaStream_t stream) {
  const size_t smem = XattnLayout<D>::bytes(num_keys);
  cudaError_t err = cudaFuncSetAttribute(
      xattn_fastlayout_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (seq_len + kXaTile - 1) / kXaTile;
  xattn_fastlayout_kernel<D>
      <<<batch * num_heads * tiles, kXaThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), seq_len,
          num_keys, num_heads, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// Shared memory one launch needs for num_keys keys of head_dim (64, 96, 128
// or 256); 0 for another head dim. At D = 256 k and v of 91 keys fill the
// 232,448 bytes a block may use (the text encoder emits 85).
extern "C" long long mdm_xattn_fastlayout_smem_bytes(int num_keys,
                                                     int head_dim) {
  switch (head_dim) {
    case 64:
      return static_cast<long long>(mdm::XattnLayout<64>::bytes(num_keys));
    case 96:
      return static_cast<long long>(mdm::XattnLayout<96>::bytes(num_keys));
    case 128:
      return static_cast<long long>(mdm::XattnLayout<128>::bytes(num_keys));
    case 256:
      return static_cast<long long>(mdm::XattnLayout<256>::bytes(num_keys));
    default:
      return 0;
  }
}

// C entry for ctypes. q, out: [B, T, H*D]; k, v: [B, N, H*D]; contiguous,
// 16-byte aligned, f32. Returns the CUDA error code of the launch (0 on
// success); a head dim other than 64, 96, 128 or 256 returns
// cudaErrorInvalidValue, and an N whose k and v do not fit in shared memory
// the error of the shared-memory request.
extern "C" int mdm_xattn_fastlayout(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq_len, int num_keys, int num_heads,
                                    int head_dim, float scale, void* stream) {
  if (batch <= 0 || seq_len <= 0 || num_keys <= 0 || num_heads <= 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return int(mdm::launch_xattn<64>(q, k, v, out, batch, seq_len,
                                       num_keys, num_heads, scale, s));
    case 96:
      return int(mdm::launch_xattn<96>(q, k, v, out, batch, seq_len,
                                       num_keys, num_heads, scale, s));
    case 128:
      return int(mdm::launch_xattn<128>(q, k, v, out, batch, seq_len,
                                        num_keys, num_heads, scale, s));
    case 256:
      return int(mdm::launch_xattn<256>(q, k, v, out, batch, seq_len,
                                        num_keys, num_heads, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
