// Performer (FAVOR+) attention core, hand-written for Hopper: one kernel,
// three TPU kernels.
//
// Replaces the Pallas TPU kernels of motiondiffusion_moe_tpu/ops/
// performer_pallas.py:
//
// - _favor_qkv_kernel_v2 (kernel 1, public entry favor_attention_qkv): q, k
//   and v are column blocks of the merged [B, T, 3*H*D] qkv panel (column
//   order q|k|v);
// - _favor_full_kernel (kernel 10, favor_attention_full): the same math on
//   three separate [B, T, H*D] tensors;
// - _favor_kernel (kernel 8, favor_attention): the core alone, on q, k and v
//   [B, H, T, D] that the caller has already normalised, f32 in and out.
//
// For each (batch row, head):
//
//   [normalised kernels] x * pre_scale -> one shared LayerNorm for q, k and v
//   -> L2 of q and k
//   -> phi(x) = exp(clip(x @ proj, -15, 15)) * 0.1, in f32
//   -> phi(k) rows multiplied by the frame mask
//   -> kv = phi(k)^T v * 0.1
//   -> phi(q) kv * 0.1 / max(sum_m phi(q)_t phi(k)_t, eps)  (the reference's
//      same-position denominator)
//   -> [normalised kernels] output LayerNorm with the same parameters.
//
// The kernels differ only in where a head's rows lie (FavorLayout: the
// element strides of a batch row, a head and a sequence step, and the three
// base pointers) and in whether the normalisation steps are compiled in
// (kNorm). Kernel 1's instantiation does the same arithmetic, in the same
// order, as before kernels 8 and 10 joined it.
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
// shuffles (the normalisation is common.cuh::normalize_row, shared with the
// backward); pass 2 needs no block barrier because a warp only reads the rows
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

// Element strides of one batch row, one head and one sequence step, for
// the inputs (q, k and v alike) and for the output.
struct FavorLayout {
  long long in_batch, in_head, in_row;
  long long out_batch, out_head, out_row;
};

// One warp stages one D-wide row: normalised (common.cuh::normalize_row)
// when kNorm, else widened to f32 as it is. A row past the sequence end is
// zeros.
template <typename T, int CD, bool kNorm>
__device__ __forceinline__ void stage_row(const T* __restrict__ src,
                                          bool valid, const float (&g)[CD],
                                          const float (&beta)[CD],
                                          float pre_scale, bool l2, float* dst,
                                          int lane) {
  if constexpr (kNorm) {
    normalize_row<T, CD>(src, valid, g, beta, pre_scale, l2, dst, lane);
  } else {
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dst[lane * CD + c] = valid ? to_f32(src[lane * CD + c]) : 0.f;
    }
  }
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

template <typename T, int D, int M, bool kNorm>
__global__ void __launch_bounds__(kThreads, 1)
    favor_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ln_scale,
                 const float* __restrict__ ln_bias,
                 const float* __restrict__ proj,
                 const float* __restrict__ mask, T* __restrict__ out,
                 FavorLayout lay, int seq_len, int num_heads, float eps,
                 float pre_scale) {
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
  const long long in_off = b * lay.in_batch + h * lay.in_head;
  const size_t row_stride = size_t(lay.in_row);
  const T* q_base = q + in_off;
  const T* k_base = k + in_off;
  const T* v_base = v + in_off;
  T* out_base = out + b * lay.out_batch + h * lay.out_head;
  const float* mask_row =
      mask == nullptr ? nullptr : mask + size_t(b) * seq_len;

  float g[CD] = {}, beta[CD] = {};
  if constexpr (kNorm) {
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      g[c] = ln_scale[lane * CD + c];
      beta[c] = ln_bias[lane * CD + c];
    }
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
      stage_row<T, CD, kNorm>(k_base + size_t(t) * row_stride, valid, g,
                              beta, pre_scale, true, my_a + r * D, lane);
      stage_row<T, CD, kNorm>(v_base + size_t(t) * row_stride, valid, g,
                              beta, pre_scale, false, my_b + r * D, lane);
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
      stage_row<T, CD, kNorm>(q_base + size_t(t) * row_stride, valid, g,
                              beta, pre_scale, true, my_b + r * D, lane);
      stage_row<T, CD, kNorm>(k_base + size_t(t) * row_stride, valid, g,
                              beta, pre_scale, true, my_a + r * D, lane);
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
      T* dst = out_base + t * lay.out_row + lane * CD;
      if constexpr (!kNorm) {
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dst[c] = from_f32<T>(o[r][c] * 0.1f / den[r]);
        }
        continue;
      }
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
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[c] = from_f32<T>((o[r][c] - mu) * inv * g[c] + beta[c]);
      }
    }
    __syncwarp();
  }
}

template <typename T, int D, int M, bool kNorm>
cudaError_t launch_favor(const void* q, const void* k, const void* v,
                         const void* ln_scale, const void* ln_bias,
                         const void* proj, const void* mask, void* out,
                         const FavorLayout& lay, int batch, int seq_len,
                         int num_heads, float eps, float pre_scale,
                         cudaStream_t stream) {
  constexpr size_t smem = favor_smem_bytes<D, M>();
  auto kernel = favor_kernel<T, D, M, kNorm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * num_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(proj),
      static_cast<const float*>(mask), static_cast<T*>(out), lay, seq_len,
      num_heads, eps, pre_scale);
  return cudaGetLastError();
}

// (q, k, v) of the merged panel (merged = true) or of three [B, T, H*D]
// tensors, normalised, in f32 or bf16; the output [B, T, H*D].
template <int D, int M>
cudaError_t launch_favor_rows(const void* q, const void* k, const void* v,
                              const void* ln_scale, const void* ln_bias,
                              const void* proj, const void* mask, void* out,
                              bool merged, int batch, int seq_len,
                              int num_heads, int is_bf16, float eps,
                              float pre_scale, cudaStream_t stream) {
  const long long hd = (long long)num_heads * D;
  const long long in_row = merged ? 3 * hd : hd;
  const FavorLayout lay{seq_len * in_row, D, in_row, seq_len * hd, D, hd};
  if (is_bf16) {
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(q);
    return launch_favor<__nv_bfloat16, D, M, true>(
        q, merged ? base + hd : k, merged ? base + 2 * hd : v, ln_scale,
        ln_bias, proj, mask, out, lay, batch, seq_len, num_heads, eps,
        pre_scale, stream);
  }
  const float* base = static_cast<const float*>(q);
  return launch_favor<float, D, M, true>(
      q, merged ? base + hd : k, merged ? base + 2 * hd : v, ln_scale,
      ln_bias, proj, mask, out, lay, batch, seq_len, num_heads, eps,
      pre_scale, stream);
}

}  // namespace
}  // namespace mdm

// The (head_dim, num_features) pairs instantiated: those of the config
// presets small_dense (64, 128), moe_big (96, 128) and moe_small (128, 128).
#define MDM_FAVOR_SHAPES(X) X(64, 128) X(96, 128) X(128, 128)

// C entry for ctypes, kernel 1. qkv/out: [B, T, 3*H*D] / [B, T, H*D],
// contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); ln_scale, ln_bias:
// [D] f32; proj: [D, M] f32; mask: [B, T] f32 or null (all frames valid).
// Returns the CUDA error code of the launch (0 on success); (head_dim,
// num_features) pairs other than the instantiated ones return
// cudaErrorInvalidValue.
extern "C" int mdm_favor_qkv(const void* qkv, const void* ln_scale,
                             const void* ln_bias, const void* proj,
                             const void* mask, void* out, int batch,
                             int seq_len, int num_heads, int head_dim,
                             int num_features, int is_bf16, float eps,
                             float pre_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor_rows<D_, M_>(                              \
        qkv, nullptr, nullptr, ln_scale, ln_bias, proj, mask, out, true,    \
        batch, seq_len, num_heads, is_bf16, eps, pre_scale, s));            \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

// C entry for ctypes, kernel 10. q, k, v, out: [B, T, H*D], contiguous, one
// dtype, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); the rest as for
// mdm_favor_qkv.
extern "C" int mdm_favor_attention_full(const void* q, const void* k,
                                        const void* v, const void* ln_scale,
                                        const void* ln_bias, const void* proj,
                                        const void* mask, void* out,
                                        int batch, int seq_len, int num_heads,
                                        int head_dim, int num_features,
                                        int is_bf16, float eps,
                                        float pre_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor_rows<D_, M_>(                              \
        q, k, v, ln_scale, ln_bias, proj, mask, out, false, batch, seq_len, \
        num_heads, is_bf16, eps, pre_scale, s));                            \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

// C entry for ctypes, kernel 8. q, k, v, out: [B, H, T, D] f32, contiguous
// (q and k already L2-normalised by the caller, no normalisation inside);
// proj: [D, M] f32; mask: [B, 1, T] f32 or null. Returns as mdm_favor_qkv.
extern "C" int mdm_favor_attention(const void* q, const void* k,
                                   const void* v, const void* proj,
                                   const void* mask, void* out, int batch,
                                   int num_heads, int seq_len, int head_dim,
                                   int num_features, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long td = (long long)seq_len * head_dim;
  const mdm::FavorLayout lay{num_heads * td, td, head_dim,
                             num_heads * td, td, head_dim};
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor<float, D_, M_, false>(                     \
        q, k, v, nullptr, nullptr, proj, mask, out, lay, batch, seq_len,    \
        num_heads, eps, 1.f, s));                                           \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

#undef MDM_FAVOR_SHAPES
