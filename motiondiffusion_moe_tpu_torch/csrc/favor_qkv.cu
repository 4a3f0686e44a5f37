// Merged-QKV Performer (FAVOR+) attention core, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/performer_pallas.py::_favor_qkv_kernel_v2
// (public entry favor_attention_qkv). For each (batch row, head) of the
// merged [B, T, 3*H*D] qkv panel (column order q|k|v):
//
//   x * pre_scale -> one shared LayerNorm for q, k and v -> L2 of q and k
//   -> phi(x) = exp(clip(x @ proj, -15, 15)) * 0.1, in f32
//   -> phi(k) rows multiplied by the frame mask
//   -> kv = phi(k)^T v * 0.1
//   -> phi(q) kv * 0.1 / max(sum_m phi(q)_t phi(k)_t, eps)  (the reference's
//      same-position denominator)
//   -> output LayerNorm with the same LayerNorm parameters -> [B, T, H*D].
//
// What bounds it on the card: f32 FMA throughput. At the flagship shape
// (T = 196, D = m = 128) one (b, h) pair does five [T, 128] x [128, 128]
// products (phi(k) and kv in pass 1; phi(q), phi(k) again and phi(q) kv in
// pass 2), about 16 M FMAs, against reading 3*T*D inputs twice and writing
// T*D outputs once (under 1 MB): far above the bandwidth line. The products
// stay IEEE f32 FMAs on purpose: the TPU kernel runs them in full f32, and
// TF32 would drop to ~3 decimal digits in front of the exp.
//
// Design: one block of 8 warps per (b, h). Blocks run in no order, so the kv
// reduction over T stays inside the block: pass 1 walks T in tiles of 32 rows
// and accumulates kv in registers (each thread owns an (M/16) x (D/16)
// piece); pass 2 walks the tiles again, recomputes phi(k) for the
// denominator and finishes every row. The projection and kv (64 KB each at
// the flagship shape) stay in shared memory. Each row-wise step (LayerNorm,
// L2, denominator, output LayerNorm) is one warp per row, reduced with
// shuffles; pass 2 needs no block barrier because a warp only reads the rows
// it wrote. No atomics, so the output is deterministic.

#include <cstddef>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTile = kWarps * kRowsPerWarp;  // rows of T per tile

template <int D, int M>
constexpr size_t favor_smem_bytes() {
  return sizeof(float) *
         (size_t(D) * M + size_t(M) * D + 2 * size_t(kTile) * D +
          size_t(kTile) * M);
}

__device__ __forceinline__ float feature(float logit) {
  return expf(fminf(fmaxf(logit, -15.f), 15.f)) * 0.1f;
}

// One warp normalizes one D-wide row: x * pre_scale -> LayerNorm(g, beta),
// then L2 when `l2`. Lane l holds columns [l*C, l*C + C). A row past the
// sequence end (`valid` false) is written as zeros. `valid` is the same for
// all lanes, so the early return keeps the shuffles convergent.
template <typename T, int C>
__device__ __forceinline__ void norm_row(const T* __restrict__ src, bool valid,
                                         const float (&g)[C],
                                         const float (&beta)[C],
                                         float pre_scale, bool l2, float* dst,
                                         int lane) {
  constexpr float kInvD = 1.0f / float(C * 32);
  if (!valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[lane * C + c] = 0.f;
    return;
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
  if (l2) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) ss = fmaf(x[c], x[c], ss);
    const float r = 1.0f / sqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] *= r;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dst[lane * C + c] = x[c];
}

// acc[r][c] = rows[r] . proj[:, lane*CM + c] for the warp's kRowsPerWarp
// rows (rows: [kRowsPerWarp][D] in shared memory; proj: [D][M]).
template <int D, int M>
__device__ __forceinline__ void feature_logits(
    const float* rows, const float* s_proj, int lane,
    float (&acc)[kRowsPerWarp][M / 32]) {
  constexpr int CM = M / 32;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[r][c] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float w[CM];
    load_vec<CM>(s_proj + d * M + lane * CM, w);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float a = rows[r * D + d];
#pragma unroll
      for (int c = 0; c < CM; ++c) acc[r][c] = fmaf(a, w[c], acc[r][c]);
    }
  }
}

template <typename T, int D, int M>
__global__ void __launch_bounds__(kThreads, 1)
    favor_qkv_kernel(const T* __restrict__ qkv,
                     const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias,
                     const float* __restrict__ proj,
                     const float* __restrict__ mask, T* __restrict__ out,
                     int seq_len, int num_heads, float eps, float pre_scale) {
  static_assert(D % 32 == 0 && M % 32 == 0, "D and M must be multiples of 32");
  constexpr int CD = D / 32;  // columns of a D-row held by one lane
  constexpr int CM = M / 32;  // columns of an M-row held by one lane
  constexpr int MI = M / 16;  // kv rows owned by one thread in pass 1
  constexpr int DJ = D / 16;  // kv columns owned by one thread in pass 1
  constexpr float kInvD = 1.0f / float(D);

  extern __shared__ __align__(16) float smem[];
  float* s_proj = smem;           // [D][M]
  float* s_kv = s_proj + D * M;   // [M][D], kv * 0.1 once pass 1 is done
  float* s_a = s_kv + M * D;      // [kTile][D]: k rows
  float* s_b = s_a + kTile * D;   // [kTile][D]: v rows (pass 1), q (pass 2)
  float* s_phi = s_b + kTile * D; // [kTile][M]: phi(k) (pass 1), phi(q) (2)

  const int b = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hd = num_heads * D;
  const size_t row_stride = 3 * size_t(hd);
  const T* q_base = qkv + size_t(b) * seq_len * row_stride + size_t(h) * D;
  const T* k_base = q_base + hd;
  const T* v_base = q_base + 2 * hd;
  const float* mask_row =
      mask == nullptr ? nullptr : mask + size_t(b) * seq_len;

  float g[CD], beta[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    g[c] = ln_scale[lane * CD + c];
    beta[c] = ln_bias[lane * CD + c];
  }
  for (int i = threadIdx.x; i < D * M; i += kThreads) s_proj[i] = proj[i];
  __syncthreads();

  float* my_a = s_a + warp * kRowsPerWarp * D;
  float* my_b = s_b + warp * kRowsPerWarp * D;
  float* my_phi = s_phi + warp * kRowsPerWarp * M;

  // ---- pass 1: kv = phi(k)^T v, accumulated over all tiles of T ----------
  const int ig = threadIdx.x / 16;
  const int jg = threadIdx.x % 16;
  float kv[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) kv[i][j] = 0.f;
  }
  for (int t0 = 0; t0 < seq_len; t0 += kTile) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      const bool valid = t < seq_len;
      norm_row<T, CD>(k_base + size_t(t) * row_stride, valid, g, beta,
                      pre_scale, true, my_a + r * D, lane);
      norm_row<T, CD>(v_base + size_t(t) * row_stride, valid, g, beta,
                      pre_scale, false, my_b + r * D, lane);
    }
    __syncwarp();
    float acc[kRowsPerWarp][CM];
    feature_logits<D, M>(my_a, s_proj, lane, acc);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      const float mk =
          t < seq_len ? (mask_row == nullptr ? 1.f : mask_row[t]) : 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        my_phi[r * M + lane * CM + c] = feature(acc[r][c]) * mk;
      }
    }
    __syncthreads();
    for (int tt = 0; tt < kTile; ++tt) {
      float p[MI], v[DJ];
      load_vec<MI>(s_phi + tt * M + ig * MI, p);
      load_vec<DJ>(s_b + tt * D + jg * DJ, v);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) kv[i][j] = fmaf(p[i], v[j], kv[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      s_kv[(ig * MI + i) * D + jg * DJ + j] = kv[i][j] * 0.1f;
    }
  }
  __syncthreads();

  // ---- pass 2: every row of the output ----------------------------------
  for (int t0 = 0; t0 < seq_len; t0 += kTile) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      const bool valid = t < seq_len;
      norm_row<T, CD>(q_base + size_t(t) * row_stride, valid, g, beta,
                      pre_scale, true, my_b + r * D, lane);
      norm_row<T, CD>(k_base + size_t(t) * row_stride, valid, g, beta,
                      pre_scale, true, my_a + r * D, lane);
    }
    __syncwarp();
    float aq[kRowsPerWarp][CM], ak[kRowsPerWarp][CM];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < CM; ++c) aq[r][c] = ak[r][c] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float w[CM];
      load_vec<CM>(s_proj + d * M + lane * CM, w);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qa = my_b[r * D + d];
        const float ka = my_a[r * D + d];
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          aq[r][c] = fmaf(qa, w[c], aq[r][c]);
          ak[r][c] = fmaf(ka, w[c], ak[r][c]);
        }
      }
    }
    float den[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      const float mk =
          t < seq_len ? (mask_row == nullptr ? 1.f : mask_row[t]) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const float pq = feature(aq[r][c]);
        part = fmaf(pq, feature(ak[r][c]) * mk, part);
        my_phi[r * M + lane * CM + c] = pq;
      }
      den[r] = fmaxf(warp_sum(part), eps);
    }
    __syncwarp();
    float o[kRowsPerWarp][CD];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < CD; ++c) o[r][c] = 0.f;
    }
#pragma unroll 2
    for (int i = 0; i < M; ++i) {
      float kvv[CD];
      load_vec<CD>(s_kv + i * D + lane * CD, kvv);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float a = my_phi[r * M + i];
#pragma unroll
        for (int c = 0; c < CD; ++c) o[r][c] = fmaf(a, kvv[c], o[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      if (t >= seq_len) continue;  // the same for all lanes of the warp
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        o[r][c] = o[r][c] * 0.1f / den[r];
        s += o[r][c];
      }
      const float mu = warp_sum(s) * kInvD;
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float d = o[r][c] - mu;
        v = fmaf(d, d, v);
      }
      const float inv = 1.0f / sqrtf(warp_sum(v) * kInvD + kLnEps);
      T* dst = out + (size_t(b) * seq_len + t) * hd + size_t(h) * D + lane * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[c] = from_f32<T>((o[r][c] - mu) * inv * g[c] + beta[c]);
      }
    }
    __syncwarp();
  }
}

template <typename T, int D, int M>
cudaError_t launch_favor_qkv(const void* qkv, const void* ln_scale,
                             const void* ln_bias, const void* proj,
                             const void* mask, void* out, int batch,
                             int seq_len, int num_heads, float eps,
                             float pre_scale, cudaStream_t stream) {
  constexpr size_t smem = favor_smem_bytes<D, M>();
  auto kernel = favor_qkv_kernel<T, D, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * num_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(proj),
      static_cast<const float*>(mask), static_cast<T*>(out), seq_len,
      num_heads, eps, pre_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// C entry for ctypes. qkv/out: [B, T, 3*H*D] / [B, T, H*D], contiguous, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); ln_scale, ln_bias: [D] f32; proj:
// [D, M] f32; mask: [B, T] f32 or null (all frames valid). Returns the CUDA
// error code of the launch (0 on success); (head_dim, num_features) pairs
// other than the instantiated ones return cudaErrorInvalidValue.
extern "C" int mdm_favor_qkv(const void* qkv, const void* ln_scale,
                             const void* ln_bias, const void* proj,
                             const void* mask, void* out, int batch,
                             int seq_len, int num_heads, int head_dim,
                             int num_features, int is_bf16, float eps,
                             float pre_scale, void* stream) {
  using mdm::launch_favor_qkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(is_bf16 ? launch_favor_qkv<__nv_bfloat16, D_, M_>(           \
                             qkv, ln_scale, ln_bias, proj, mask, out, batch, \
                             seq_len, num_heads, eps, pre_scale, s)          \
                       : launch_favor_qkv<float, D_, M_>(                   \
                             qkv, ln_scale, ln_bias, proj, mask, out, batch, \
                             seq_len, num_heads, eps, pre_scale, s));        \
  }
  MDM_FAVOR_CASE(64, 128)
  MDM_FAVOR_CASE(96, 128)
  MDM_FAVOR_CASE(128, 128)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}
