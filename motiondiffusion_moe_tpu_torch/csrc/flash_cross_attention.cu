// Exact attention of f32 inputs with an online softmax over blocks of keys,
// hand-written for Hopper.
//
// Replaces, for f32 inputs, the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/flash_attention.py::_flash_kernel (public entry
// flash_cross_attention); bf16 inputs take csrc/cross_attention_mma.cu. For
// q [B, H, T, D] and k, v [B, H, N, D], any N, no mask, per (batch row,
// head):
//
//   scores = (q * scale) . k^T     f32, one block of keys at a time
//   running max m, running sum l, f32 accumulator acc (online softmax)
//   out    = acc / max(l, 1e-20)
//
// What bounds it on the card: f32 FMA throughput. The kernel keeps both
// products in IEEE f32 FMAs, as the TPU kernel computes them: at the
// flagship text length (B = 32, H = 4, T = 196, N = 85, D = 128) 1.09 GFLOP,
// 16.3 us at 67 TFLOP/s, against 36.8 MB of f32 inputs and output, 11 us at
// 3.35 TB/s.
//
// Design: one block of 8 warps per (batch row, head, 32-row tile of T). The
// keys and values pass through shared memory in blocks of block_n rows (k
// rows padded by 16 bytes so that the lanes' 16-byte row reads hit distinct
// banks), so any N fits, where
// xattn_fastlayout.cu keeps a whole head's k and v in shared memory and stops
// near 180 keys in f32. Each warp carries 4 query rows together, so every k
// and v value read from shared memory feeds 4 rows: lane l scores keys l,
// l + 32, ... of the block with whole dot products; the block maxima are warp
// shuffles; the running max, sum and the accumulator of the lane's D/32
// output columns are rescaled by exp(m_old - m_new) per block; the tail
// block is cut at N. Scores and probabilities never reach device memory.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kFlWarps = 8;
constexpr int kFlThreads = kFlWarps * 32;
constexpr int kFlRowsPerWarp = 4;
constexpr int kFlTile = kFlWarps * kFlRowsPerWarp;  // q rows per block

__device__ __forceinline__ float fl_warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// The 16 bytes at p as 4 floats.
__device__ __forceinline__ void fl_load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Shared memory: q rows [32][D], probabilities [32][bn], then k
// [bn][D + pad] and v [bn][D], all f32.
template <int D>
struct FlashLayout {
  static constexpr int kVec = 4;        // floats per 16 bytes
  static constexpr int kKs = D + kVec;  // padded k row
  static size_t bytes(int bn) {
    return 4 * (size_t(kFlTile) * D + size_t(kFlTile) * bn +
                size_t(bn) * (kKs + D));
  }
};

template <int D>
__global__ void __launch_bounds__(kFlThreads) flash_xattn_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int seq_len,
    int num_keys, int bn, float scale) {
  using L = FlashLayout<D>;
  constexpr int kVec = L::kVec;
  constexpr int R = kFlRowsPerWarp;
  constexpr int C = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char fl_smem[];
  float* qs = reinterpret_cast<float*>(fl_smem);
  float* ps = qs + kFlTile * D;
  float* ks = ps + size_t(kFlTile) * bn;
  float* vs = ks + size_t(bn) * L::kKs;

  const int tiles = (seq_len + kFlTile - 1) / kFlTile;
  const int bh = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const float* qh = q + size_t(bh) * seq_len * D;
  const float* kh = k + size_t(bh) * num_keys * D;
  const float* vh = v + size_t(bh) * num_keys * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this warp's rows times scale; rows past the sequence end are zeros (the
  // warp still takes part in every block barrier, and stores nothing)
  const int t0 = tile * kFlTile + warp * R;
  float* qw = qs + warp * R * D;
  float* pw = ps + size_t(warp) * R * bn;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qw[r * D + lane + 32 * c] =
          t < seq_len ? qh[size_t(t) * D + lane + 32 * c] * scale : 0.f;
    }
  }

  float m[R], l[R], o[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = __int_as_float(0xff800000);  // -inf
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) o[r][c] = 0.f;
  }

  constexpr int kRowVec = D / kVec;
  for (int n0 = 0; n0 < num_keys; n0 += bn) {
    const int nb = min(bn, num_keys - n0);
    __syncthreads();  // the previous block's k and v are no longer read
    for (int i = tid; i < nb * kRowVec; i += kFlThreads) {
      const int n = i / kRowVec, c = i % kRowVec;
      const size_t src = size_t(n0 + n) * D + c * kVec;
      *reinterpret_cast<uint4*>(ks + size_t(n) * L::kKs + c * kVec) =
          *reinterpret_cast<const uint4*>(kh + src);
      *reinterpret_cast<uint4*>(vs + size_t(n) * D + c * kVec) =
          *reinterpret_cast<const uint4*>(vh + src);
    }
    __syncthreads();  // and the q rows are written, before the first block

    // scores of this lane's keys of the block for the R rows
    float bmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bmax[r] = __int_as_float(0xff800000);
    for (int n = lane; n < nb; n += 32) {
      const float* kr = ks + size_t(n) * L::kKs;
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += kVec) {
        float kv[kVec];
        fl_load16(kr + d, kv);
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
        pw[r * bn + n] = s[r];
        bmax[r] = fmaxf(bmax[r], s[r]);
      }
    }
    // new running max; rescale factor of what was summed so far (0 on the
    // first block, where m is -inf)
    float alpha[R], lsum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mn = fmaxf(m[r], fl_warp_max(bmax[r]));
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
      lsum[r] = 0.f;
    }
    for (int n = lane; n < nb; n += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = expf(pw[r * bn + n] - m[r]);
        pw[r * bn + n] = p;
        lsum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = l[r] * alpha[r] + warp_sum(lsum[r]);
#pragma unroll
      for (int c = 0; c < C; ++c) o[r][c] *= alpha[r];
    }
    __syncwarp();

    // acc += p . v: lane l owns columns [l*C, l*C + C) of the R rows
#pragma unroll 2
    for (int n = 0; n < nb; ++n) {
      float vv[C];
      if constexpr (C % 4 == 0) {
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          float t[4];
          fl_load16(vs + size_t(n) * D + lane * C + c, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) vv[c + e] = t[e];
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) vv[c] = vs[size_t(n) * D + lane * C + c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pw[r * bn + n];
#pragma unroll
        for (int c = 0; c < C; ++c) o[r][c] = fmaf(p, vv[c], o[r][c]);
      }
    }
    __syncwarp();  // this warp's probabilities read before the next block
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + r;
    if (t >= seq_len) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    float* dst = out + (size_t(bh) * seq_len + t) * D + lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = o[r][c] * inv;
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int bh, int seq_len, int num_keys, int bn,
                         float scale, cudaStream_t stream) {
  const size_t smem = FlashLayout<D>::bytes(bn);
  cudaError_t err = cudaFuncSetAttribute(
      flash_xattn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (seq_len + kFlTile - 1) / kFlTile;
  flash_xattn_kernel<D><<<bh * tiles, kFlThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), seq_len,
      num_keys, bn, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// Shared memory one launch needs for key blocks of block_n rows at head_dim
// (64, 96, 128 or 256); 0 for another head dim. At D = 256 blocks of up to
// 91 keys fit (the wrapper halves block_n until the plan fits).
extern "C" long long mdm_flash_cross_attention_smem_bytes(int block_n,
                                                          int head_dim) {
  switch (head_dim) {
    case 64:
      return static_cast<long long>(mdm::FlashLayout<64>::bytes(block_n));
    case 96:
      return static_cast<long long>(mdm::FlashLayout<96>::bytes(block_n));
    case 128:
      return static_cast<long long>(mdm::FlashLayout<128>::bytes(block_n));
    case 256:
      return static_cast<long long>(mdm::FlashLayout<256>::bytes(block_n));
    default:
      return 0;
  }
}

// C entry for ctypes. q, out: [B, H, T, D]; k, v: [B, H, N, D]; contiguous,
// 16-byte aligned, f32; bh = B*H; keys pass through shared memory block_n
// rows at a time. Returns the CUDA error code of the launch (0 on success);
// a head dim other than 64, 96, 128 or 256 or an empty input returns
// cudaErrorInvalidValue.
extern "C" int mdm_flash_cross_attention(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int seq_len, int num_keys,
                                         int head_dim, int block_n,
                                         float scale, void* stream) {
  if (bh <= 0 || seq_len <= 0 || num_keys <= 0 || block_n <= 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return int(mdm::launch_flash<64>(q, k, v, out, bh, seq_len, num_keys,
                                       block_n, scale, s));
    case 96:
      return int(mdm::launch_flash<96>(q, k, v, out, bh, seq_len, num_keys,
                                       block_n, scale, s));
    case 128:
      return int(mdm::launch_flash<128>(q, k, v, out, bh, seq_len, num_keys,
                                        block_n, scale, s));
    case 256:
      return int(mdm::launch_flash<256>(q, k, v, out, bh, seq_len, num_keys,
                                        block_n, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
