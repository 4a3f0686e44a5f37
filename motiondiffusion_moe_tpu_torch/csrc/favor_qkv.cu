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
// (kNorm).
//
// Under a seq mesh each rank holds its own frames of T, and kv is the only
// sum over T. So kernels 1 and 8 also run in two launches (kMode), with the
// seq ranks' all-reduce of kv between them (models/attention.py):
//   moments  pass 1 on the rank's rows without q: phi(k) (masked), its
//            share of kv, the cluster sum times 0.1, written to kv_buf
//            [B, H, M, D] f32. The 0.1 falls on each rank's partial sum
//            (linear: only the rounding differs from scaling the total).
//   apply    pass 1 without v and kv: phi(q) and the denominator (phi(k)
//            of its own rows again) to the scratch; then kv_buf, the seq
//            ranks' summed kv, in place of the projection; then pass 2.
// The whole-T kernels (kMode kWhole) are the instances they were.
//
// What bounds it on the card: its products. At the flagship shape
// (B = 32, H = 4, T = 196, D = m = 128) the four [T, 128] x [128, 128]
// products of every (b, h) (phi(q) and phi(k) logits, kv, phi(q) kv) are
// 3.3 GFLOP against 26 MB of inputs and outputs. The TPU kernel runs them in
// multi-pass f32 on the MXU; a single TF32 pass keeps ~3 decimal digits,
// too few in front of the exp. So every product runs on the tensor cores as
// 3xTF32 (common.cuh::warp_product: hi/lo split operands, three mma.sync
// m16n8k8 per k step, f32 accumulation, ~2^-21 of each product), and the
// floor is three TF32 passes at 494 TFLOP/s, ~0.02 ms. With FAVOR_MXU_BF16=1
// (kernel 1 only, as the JAX package) the operands are rounded to bf16 and
// each k step of 16 is one bf16 mma, the TPU kernel's single MXU pass.
//
// Design: all of the card. The T rows of a (b, h) are split, in tiles of 16
// rows, over the C CTAs of a thread-block cluster (C = 4 from the wrapper:
// 512 CTAs of 8 warps at the flagship shape); every CTA stages the
// projection in shared memory.
//   pass 1  per tile: LayerNorm and L2 of k, LayerNorm of v (a warp per
//           row, common.cuh::normalize_loaded); the phi(k) logits
//           (common.cuh::feature_logits), exp, mask; kv += phi(k)^T v,
//           each warp owning 16 rows of kv as mma accumulators.
//   sum     the CTAs' partial kv through distributed shared memory, added
//           in rank order (common.cuh::cluster_sum: no atomics, so
//           repeated calls give identical bits), times 0.1.
//   pass 2  per tile: q (and k again, unless the CTA holds one tile, whose
//           phi(k) is still in shared memory) normalised, the logits,
//           phi(q); the denominator max(sum_m phi(q) phi(k), eps) a warp per
//           row; phi(q) kv * 0.1 / den on the tensor cores; the output
//           LayerNorm a warp per row.
// Shared memory (113 KB at D = m = 128, two CTAs per SM; 207 KB at D = 256,
// one) holds the projection and kv in f32 (split on the fly at each fragment
// load) and the tile's rows, each with a padded leading dimension chosen for
// the way the products read it (4 mod 32 for an A operand, 8 mod 32 for a B
// operand or a transposed A: no bank conflicts). At D = 256 each warp's
// share of kv is 128 accumulators a thread: one CTA an SM, up to 255
// registers a thread (ops/performer.py::favor_per_sm).

#include <cstddef>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // rows of T per tile: one mma row tile

// Leading dimensions and offsets (floats) of the shared-memory arrays.
template <int D, int M>
struct FavorSmem {
  static constexpr int kLdP = M + 8;   // projection [D][M], B operand
  static constexpr int kLdKv = D + 8;  // kv [M][D], B operand
  static constexpr int kLdX = D + 4;   // q / k rows [kRows][D], A operand
  static constexpr int kLdV = D + 8;   // v rows, B operand; then the output
  static constexpr int kLdPq = M + 4;  // phi(q) [kRows][M], A operand
  static constexpr int kLdPk = M + 8;  // phi(k) [kRows][M], transposed A
  // pass 1 holds the projection, pass 2 kv, in one buffer
  static constexpr int kBig = D * kLdP > M * kLdKv ? D * kLdP : M * kLdKv;
  static constexpr int kQ = kBig;
  static constexpr int kK = kQ + kRows * kLdX;
  static constexpr int kV = kK + kRows * kLdX;
  static constexpr int kPq = kV + kRows * kLdV;
  static constexpr int kPk = kPq + kRows * kLdPq;
  static constexpr int kDenPart = kPk + kRows * kLdPk;  // [kWarps][kRows]
  static constexpr int kDen = kDenPart + kWarps * kRows;
  static constexpr int kMask = kDen + kRows;
  static constexpr size_t kBytes = sizeof(float) * size_t(kMask + kRows);
  static_assert(kBytes <= 232448, "within an sm_90 block's shared memory");
};

// Element strides of one batch row, one head and one sequence step, for
// the inputs (q, k and v alike) and for the output.
struct FavorLayout {
  long long in_batch, in_head, in_row;
  long long out_batch, out_head, out_row;
};

// kMode: what one launch runs (see the file's head).
constexpr int kWhole = 0;    // both passes
constexpr int kMoments = 1;  // pass 1's kv alone, to kv_buf
constexpr int kApply = 2;    // pass 1 without kv, kv from kv_buf, pass 2

// kNorm: kernels 1 and 10 (normalisation and output LayerNorm in the
// kernel); else kernel 8. kBf16: FAVOR_MXU_BF16 products. phi_buf [B*H, T,
// M] and den_buf [B*H, T]: scratch that carries phi(q) and the denominators
// from pass 1 to pass 2 (the CTA reads back only what it wrote). logits_q /
// logits_k, when not null, receive the raw feature logits [B, T, H, M] of
// the valid rows (the card tests hold the backward's to them). kv_buf [B*H,
// M, D] f32: kMoments writes it, kApply reads it, kWhole ignores it.
template <typename T, int D, int M, bool kNorm, bool kBf16, int kMode>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
    favor_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ln_scale,
                 const float* __restrict__ ln_bias,
                 const float* __restrict__ proj,
                 const float* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ phi_buf, float* __restrict__ den_buf,
                 float* __restrict__ logits_q, float* __restrict__ logits_k,
                 float* __restrict__ kv_buf, FavorLayout lay, int seq_len,
                 int num_heads, float eps, float pre_scale) {
  static_assert(D % 32 == 0 && M % 32 == 0, "D and M must be multiples of 32");
  static_assert(M == 16 * kWarps, "kv, logits: 16 rows / columns a warp");
  using S = FavorSmem<D, M>;
  constexpr int CD = D / 32;  // columns of a D-row held by one lane
  constexpr int NKV = D / 8;  // kv n-tiles of a warp
  // n-tiles of 8 output columns a warp takes at a time in phi(q) kv
  constexpr int NO = (D / 8) % (2 * kWarps) == 0 ? 2 : 1;
  constexpr float kInvD = 1.0f / float(D);

  extern __shared__ __align__(16) float smem[];
  float* s_p = smem;   // pass 1: the projection
  float* s_kv = smem;  // pass 2: kv * 0.1
  float* s_q = smem + S::kQ;
  float* s_k = smem + S::kK;
  float* s_v = smem + S::kV;
  float* s_pq = smem + S::kPq;
  float* s_pk = smem + S::kPk;
  float* s_den_part = smem + S::kDenPart;
  float* s_den = smem + S::kDen;
  float* s_mask = smem + S::kMask;

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int n_rank = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int bh = blockIdx.x / n_rank;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column
  const long long in_off = b * lay.in_batch + h * lay.in_head;
  const size_t row_stride = size_t(lay.in_row);
  const T* q_base = q + in_off;
  const T* k_base = k + in_off;
  const T* v_base = v + in_off;
  T* out_base = out + b * lay.out_batch + h * lay.out_head;
  const float* mask_row =
      mask == nullptr ? nullptr : mask + size_t(b) * seq_len;
  float* phi_rows = phi_buf + size_t(bh) * seq_len * M;
  float* den_row = den_buf + size_t(bh) * seq_len;
  const int n_tiles = (seq_len + kRows - 1) / kRows;
  const int tile0 = rank * n_tiles / n_rank;
  const int tile1 = (rank + 1) * n_tiles / n_rank;

  float g[CD] = {}, beta[CD] = {};
  if constexpr (kNorm) {
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      g[c] = ln_scale[lane * CD + c];
      beta[c] = ln_bias[lane * CD + c];
    }
  }
  for (int i = threadIdx.x; i < D * M / 4; i += kThreads) {
    const int e = 4 * i;
    *reinterpret_cast<float4*>(s_p + (e / M) * S::kLdP + e % M) =
        reinterpret_cast<const float4*>(proj)[i];
  }

  // One warp stages rows 2 warp and 2 warp + 1 of a tile: loaded
  // (common.cuh::load_row), then normalised (normalize_loaded) when kNorm,
  // else written as they are.
  using Rows = float[2][CD];
  auto load = [&](const T* base, int t0, Rows& x) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 2 * warp + r;
      load_row<T, CD>(base + size_t(t) * row_stride, t < seq_len, lane, x[r]);
    }
  };
  auto finish = [&](const Rows& x, int t0, bool l2, float* dst, int ld) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * warp + r;
      if constexpr (kNorm) {
        normalize_loaded<CD>(x[r], t0 + row < seq_len, g, beta, pre_scale,
                             l2, dst + row * ld, lane);
      } else {
#pragma unroll
        for (int c = 0; c < CD; ++c) dst[row * ld + lane * CD + c] = x[r][c];
      }
    }
  };
  auto raw_out = [&](float* dst, int t, int col) -> float* {
    return dst + ((size_t(b) * seq_len + t) * num_heads + h) * M + col;
  };

  // ---- pass 1: phi(q), phi(k), den, and this CTA's share of kv ----------
  float kv[NKV][4];
#pragma unroll
  for (int j = 0; j < NKV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) kv[j][e] = 0.f;
  }
  for (int tile = tile0; tile < tile1; ++tile) {
    const int t0 = tile * kRows;
    Rows xq, xk, xv;
    if constexpr (kMode != kMoments) load(q_base, t0, xq);
    load(k_base, t0, xk);
    if constexpr (kMode != kApply) load(v_base, t0, xv);
    if (threadIdx.x < kRows) {
      const int t = t0 + threadIdx.x;
      s_mask[threadIdx.x] =
          t < seq_len ? (mask_row == nullptr ? 1.f : mask_row[t]) : 0.f;
    }
    if constexpr (kMode != kMoments) finish(xq, t0, true, s_q, S::kLdX);
    finish(xk, t0, true, s_k, S::kLdX);
    if constexpr (kMode != kApply) finish(xv, t0, false, s_v, S::kLdV);
    __syncthreads();
    {
      // columns 16 warp .. + 16 of the q and k logits (common.cuh::
      // feature_logits); phi(q) to the scratch, the masked phi(k) to
      // s_pk, and this warp's part of each row's sum_m phi(q) phi(k)
      const int n0 = 16 * warp;
      float lq[2][4], lk[2][4];
      if constexpr (kMode != kMoments) {
        feature_logits<kBf16, D, 2>(s_q, S::kLdX, s_p, S::kLdP, n0, lq,
                                    lane);
      }
      feature_logits<kBf16, D, 2>(s_k, S::kLdX, s_p, S::kLdP, n0, lk, lane);
      float part[2] = {0.f, 0.f};  // rows gq, gq + 8
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gq + (e >> 1) * 8;
          const int col = n0 + 8 * j + 2 * tq + (e & 1);
          const int t = t0 + row;
          const float pk = feature(lk[j][e]) * s_mask[row];
          s_pk[row * S::kLdPk + col] = pk;
          if constexpr (kMode != kMoments) {
            const float pq = feature(lq[j][e]);
            part[e >> 1] = fmaf(pq, pk, part[e >> 1]);
            if (t < seq_len) {
              phi_rows[size_t(t) * M + col] = pq;
              if (logits_q != nullptr) *raw_out(logits_q, t, col) = lq[j][e];
              if (logits_k != nullptr) *raw_out(logits_k, t, col) = lk[j][e];
            }
          }
        }
      }
      if constexpr (kMode != kMoments) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
        }
        if (tq == 0) {
          s_den_part[warp * kRows + gq] = part[0];
          s_den_part[warp * kRows + gq + 8] = part[1];
        }
      }
    }
    __syncthreads();
    if constexpr (kMode != kMoments) {
      if (threadIdx.x < kRows) {  // warps' parts in order: a fixed sum
        const int t = t0 + threadIdx.x;
        float d = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          d += s_den_part[w * kRows + threadIdx.x];
        }
        if (t < seq_len) den_row[t] = fmaxf(d, eps);
      }
    }
    if constexpr (kMode != kApply) {
      warp_product<kBf16, NKV, true, false>(kv, s_pk + 16 * warp, S::kLdPk,
                                            s_v, S::kLdV, kRows, lane);
    }
    __syncthreads();
  }
  // kv replaces the projection (a CTA without a tile has not waited for
  // its staging yet)
  __syncthreads();
  if constexpr (kMode == kApply) {
    // the seq ranks' summed kv (each partial times 0.1 already)
    const float4* src =
        reinterpret_cast<const float4*>(kv_buf + size_t(bh) * M * D);
    for (int i = threadIdx.x; i < M * D / 4; i += kThreads) {
      const int e = 4 * i;
      *reinterpret_cast<float4*>(s_kv + (e / D) * S::kLdKv + e % D) = src[i];
    }
    __syncthreads();
  } else {
    // the cluster's sum, times 0.1
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_kv[(16 * warp + gq + (e >> 1) * 8) * S::kLdKv + 8 * j + 2 * tq +
             (e & 1)] = kv[j][e];
      }
    }
    if constexpr (kMode == kMoments) {
      // each CTA writes its slice of the sum: the rank's kv, and done
      cluster_sum(s_kv, S::kLdKv, M, D, 0.1f, false,
                  kv_buf + size_t(bh) * M * D);
      return;
    } else {
      cluster_sum(s_kv, S::kLdKv, M, D, 0.1f, true, nullptr);
    }
  }

  // ---- pass 2: every row of the CTA's share of the output ----------------
  for (int tile = tile0; tile < tile1; ++tile) {
    const int t0 = tile * kRows;
    for (int i = threadIdx.x; i < kRows * M / 4; i += kThreads) {
      const int row = (4 * i) / M, col = (4 * i) % M;
      const int t = t0 + row;
      *reinterpret_cast<float4*>(s_pq + row * S::kLdPq + col) =
          t < seq_len ? *reinterpret_cast<const float4*>(
                            phi_rows + size_t(t) * M + col)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (threadIdx.x < kRows) {
      const int t = t0 + threadIdx.x;
      s_den[threadIdx.x] = t < seq_len ? den_row[t] : 1.f;
    }
    __syncthreads();
    for (int j0 = NO * warp; j0 < D / 8; j0 += NO * kWarps) {
      float o[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      }
      warp_product<kBf16, NO, false, false>(o, s_pq, S::kLdPq, s_kv + 8 * j0,
                                            S::kLdKv, M, lane);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gq + (e >> 1) * 8;
          s_v[row * S::kLdV + 8 * (j0 + j) + 2 * tq + (e & 1)] =
              o[j][e] * 0.1f / s_den[row];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * warp + r;
      const int t = t0 + row;
      if (t >= seq_len) continue;  // the same for all lanes of the warp
      float x[CD];
      load_vec<CD>(s_v + row * S::kLdV + lane * CD, x);
      T* dst = out_base + t * lay.out_row + lane * CD;
      if constexpr (!kNorm) {
#pragma unroll
        for (int c = 0; c < CD; ++c) dst[c] = from_f32<T>(x[c]);
        continue;
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) s += x[c];
      const float mu = warp_sum(s) * kInvD;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float d = x[c] - mu;
        var = fmaf(d, d, var);
      }
      const float inv = 1.0f / sqrtf(warp_sum(var) * kInvD + kLnEps);
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[c] = from_f32<T>((x[c] - mu) * inv * g[c] + beta[c]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int D, int M, bool kNorm, bool kBf16,
          int kMode = kWhole>
cudaError_t launch_favor(const void* q, const void* k, const void* v,
                         const void* ln_scale, const void* ln_bias,
                         const void* proj, const void* mask, void* out,
                         float* scratch, float* logits_q, float* logits_k,
                         const FavorLayout& lay, int batch, int seq_len,
                         int num_heads, float eps, float pre_scale,
                         int cluster, cudaStream_t stream,
                         float* kv_buf = nullptr) {
  if (cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
  constexpr size_t smem = FavorSmem<D, M>::kBytes;
  auto kernel = favor_kernel<T, D, M, kNorm, kBf16, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch * num_heads * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(proj),
      static_cast<const float*>(mask), static_cast<T*>(out), scratch,
      scratch == nullptr ? nullptr
                         : scratch + size_t(batch) * num_heads * seq_len * M,
      logits_q, logits_k, kv_buf, lay, seq_len, num_heads, eps, pre_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// (q, k, v) of the merged panel (merged = true) or of three [B, T, H*D]
// tensors, normalised, in f32 or bf16; the output [B, T, H*D].
template <int D, int M, bool kBf16>
cudaError_t launch_favor_rows(const void* q, const void* k, const void* v,
                              const void* ln_scale, const void* ln_bias,
                              const void* proj, const void* mask, void* out,
                              float* scratch, float* logits_q,
                              float* logits_k, bool merged,
                              int batch, int seq_len, int num_heads,
                              int is_bf16, float eps, float pre_scale,
                              int cluster, cudaStream_t stream) {
  const long long hd = (long long)num_heads * D;
  const long long in_row = merged ? 3 * hd : hd;
  const FavorLayout lay{seq_len * in_row, D, in_row, seq_len * hd, D, hd};
  if (is_bf16) {
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(q);
    return launch_favor<__nv_bfloat16, D, M, true, kBf16>(
        q, merged ? base + hd : k, merged ? base + 2 * hd : v, ln_scale,
        ln_bias, proj, mask, out, scratch, logits_q, logits_k, lay, batch,
        seq_len, num_heads, eps, pre_scale, cluster, stream);
  }
  const float* base = static_cast<const float*>(q);
  return launch_favor<float, D, M, true, kBf16>(
      q, merged ? base + hd : k, merged ? base + 2 * hd : v, ln_scale,
      ln_bias, proj, mask, out, scratch, logits_q, logits_k, lay, batch,
      seq_len, num_heads, eps, pre_scale, cluster, stream);
}

// Kernel 1 in two launches (kMode kMoments or kApply) on the merged panel:
// kv_buf [B, H, M, D] f32 is the moments' output and the apply's input;
// out and scratch are the apply's (null for the moments).
template <int D, int M, bool kBf16, int kMode>
cudaError_t launch_favor_split(const void* qkv, float* kv_buf,
                               const void* ln_scale, const void* ln_bias,
                               const void* proj, const void* mask, void* out,
                               float* scratch, int batch, int seq_len,
                               int num_heads, int is_bf16, float eps,
                               float pre_scale, int cluster,
                               cudaStream_t stream) {
  const long long hd = (long long)num_heads * D;
  const FavorLayout lay{seq_len * 3 * hd, D, 3 * hd, seq_len * hd, D, hd};
  if (is_bf16) {
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
    return launch_favor<__nv_bfloat16, D, M, true, kBf16, kMode>(
        qkv, base + hd, base + 2 * hd, ln_scale, ln_bias, proj, mask, out,
        scratch, nullptr, nullptr, lay, batch, seq_len, num_heads, eps,
        pre_scale, cluster, stream, kv_buf);
  }
  const float* base = static_cast<const float*>(qkv);
  return launch_favor<float, D, M, true, kBf16, kMode>(
      qkv, base + hd, base + 2 * hd, ln_scale, ln_bias, proj, mask, out,
      scratch, nullptr, nullptr, lay, batch, seq_len, num_heads, eps,
      pre_scale, cluster, stream, kv_buf);
}

}  // namespace
}  // namespace mdm

// The (head_dim, num_features) pairs instantiated: those of the config
// presets small_dense (64, 128), moe_big (96, 128) and moe_small (128, 128),
// and of tools/train.py --model_size big (256, 128).
#define MDM_FAVOR_SHAPES(X) X(64, 128) X(96, 128) X(128, 128) X(256, 128)

// C entry for ctypes, kernel 1. qkv/out: [B, T, 3*H*D] / [B, T, H*D],
// contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); ln_scale, ln_bias:
// [D] f32; proj: [D, M] f32; mask: [B, T] f32 or null (all frames valid);
// scratch: f32, B*H*T*(M + 1) floats; mxu_bf16: the products on bf16
// operands (FAVOR_MXU_BF16=1); cluster: the CTAs that share one (b, h), 1
// to 8; logits_q / logits_k: null, or f32 [B, T, H, M] that receive the
// feature logits. Returns the CUDA error code
// of the launch (0 on success); (head_dim, num_features) pairs other than
// the instantiated ones return cudaErrorInvalidValue.
extern "C" int mdm_favor_qkv(const void* qkv, const void* ln_scale,
                             const void* ln_bias, const void* proj,
                             const void* mask, void* out, void* scratch,
                             void* logits_q, void* logits_k, int batch,
                             int seq_len,
                             int num_heads, int head_dim, int num_features,
                             int is_bf16, int mxu_bf16, float eps,
                             float pre_scale, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  float* lq = static_cast<float*>(logits_q);
  float* lk = static_cast<float*>(logits_k);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mxu_bf16 ? mdm::launch_favor_rows<D_, M_, true>(             \
                              qkv, nullptr, nullptr, ln_scale, ln_bias,     \
                              proj, mask, out, sc, lq, lk, true, batch,     \
                              seq_len, num_heads, is_bf16, eps, pre_scale,  \
                              cluster, s)                                   \
                        : mdm::launch_favor_rows<D_, M_, false>(            \
                              qkv, nullptr, nullptr, ln_scale, ln_bias,     \
                              proj, mask, out, sc, lq, lk, true, batch,     \
                              seq_len, num_heads, is_bf16, eps, pre_scale,  \
                              cluster, s));                                 \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

// C entry for ctypes, kernel 10. q, k, v, out: [B, T, H*D], contiguous, one
// dtype, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); the rest as for
// mdm_favor_qkv (the JAX kernel takes no FAVOR_MXU_BF16: f32 products).
extern "C" int mdm_favor_attention_full(const void* q, const void* k,
                                        const void* v, const void* ln_scale,
                                        const void* ln_bias, const void* proj,
                                        const void* mask, void* out,
                                        void* scratch, int batch,
                                        int seq_len, int num_heads,
                                        int head_dim, int num_features,
                                        int is_bf16, float eps,
                                        float pre_scale, int cluster,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor_rows<D_, M_, false>(                       \
        q, k, v, ln_scale, ln_bias, proj, mask, out,                        \
        static_cast<float*>(scratch), nullptr, nullptr, false, batch,       \
        seq_len, num_heads, is_bf16, eps, pre_scale, cluster, s));          \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

// C entry for ctypes, kernel 8. q, k, v, out: [B, H, T, D] f32, contiguous
// (q and k already L2-normalised by the caller, no normalisation inside);
// proj: [D, M] f32; mask: [B, 1, T] f32 or null; scratch and cluster as
// for mdm_favor_qkv. Returns as mdm_favor_qkv.
extern "C" int mdm_favor_attention(const void* q, const void* k,
                                   const void* v, const void* proj,
                                   const void* mask, void* out,
                                   void* scratch, int batch, int num_heads,
                                   int seq_len, int head_dim,
                                   int num_features, float eps, int cluster,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long td = (long long)seq_len * head_dim;
  const mdm::FavorLayout lay{num_heads * td, td, head_dim,
                             num_heads * td, td, head_dim};
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor<float, D_, M_, false, false>(              \
        q, k, v, nullptr, nullptr, proj, mask, out,                         \
        static_cast<float*>(scratch), nullptr, nullptr, lay, batch,         \
        seq_len, num_heads, eps, 1.f, cluster, s));                         \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

// C entries for ctypes, kernel 1 in two launches around the seq ranks'
// all-reduce of kv (see the file's head). mdm_favor_qkv_moments: qkv, mask
// (the rank's rows: [B, T_rank, 3*H*D] and [B, T_rank] or null), ln_scale,
// ln_bias, proj, mxu_bf16 and cluster as for mdm_favor_qkv; kv: f32 [B, H,
// M, D], written. mdm_favor_qkv_apply: the same inputs and kv (the seq
// ranks' sum), out [B, T_rank, H*D] in qkv's dtype, scratch as for
// mdm_favor_qkv. Both return the CUDA error code of the launch.
extern "C" int mdm_favor_qkv_moments(const void* qkv, const void* ln_scale,
                                     const void* ln_bias, const void* proj,
                                     const void* mask, void* kv, int batch,
                                     int seq_len, int num_heads,
                                     int head_dim, int num_features,
                                     int is_bf16, int mxu_bf16,
                                     float pre_scale, int cluster,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* kvp = static_cast<float*>(kv);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mxu_bf16                                                     \
                   ? mdm::launch_favor_split<D_, M_, true, mdm::kMoments>(  \
                         qkv, kvp, ln_scale, ln_bias, proj, mask, nullptr,  \
                         nullptr, batch, seq_len, num_heads, is_bf16,       \
                         1e-6f, pre_scale, cluster, s)                      \
                   : mdm::launch_favor_split<D_, M_, false, mdm::kMoments>( \
                         qkv, kvp, ln_scale, ln_bias, proj, mask, nullptr,  \
                         nullptr, batch, seq_len, num_heads, is_bf16,       \
                         1e-6f, pre_scale, cluster, s));                    \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

extern "C" int mdm_favor_qkv_apply(const void* qkv, const void* kv,
                                   const void* ln_scale, const void* ln_bias,
                                   const void* proj, const void* mask,
                                   void* out, void* scratch, int batch,
                                   int seq_len, int num_heads, int head_dim,
                                   int num_features, int is_bf16,
                                   int mxu_bf16, float eps, float pre_scale,
                                   int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* kvp = static_cast<float*>(const_cast<void*>(kv));
  float* sc = static_cast<float*>(scratch);
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mxu_bf16                                                     \
                   ? mdm::launch_favor_split<D_, M_, true, mdm::kApply>(    \
                         qkv, kvp, ln_scale, ln_bias, proj, mask, out, sc,  \
                         batch, seq_len, num_heads, is_bf16, eps,           \
                         pre_scale, cluster, s)                             \
                   : mdm::launch_favor_split<D_, M_, false, mdm::kApply>(   \
                         qkv, kvp, ln_scale, ln_bias, proj, mask, out, sc,  \
                         batch, seq_len, num_heads, is_bf16, eps,           \
                         pre_scale, cluster, s));                           \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

// C entries for ctypes, kernel 8 in the same two launches: k, v (and the
// apply's q) [B, H, T_rank, D] f32, normalised by the caller; proj; mask
// [B, 1, T_rank] or null; kv f32 [B, H, M, D]; the apply's out [B, H,
// T_rank, D] f32 and scratch as for mdm_favor_attention.
extern "C" int mdm_favor_attention_moments(const void* k, const void* v,
                                           const void* proj,
                                           const void* mask, void* kv,
                                           int batch, int num_heads,
                                           int seq_len, int head_dim,
                                           int num_features, int cluster,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long td = (long long)seq_len * head_dim;
  const mdm::FavorLayout lay{num_heads * td, td, head_dim,
                             num_heads * td, td, head_dim};
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor<float, D_, M_, false, false,               \
                                 mdm::kMoments>(                            \
        nullptr, k, v, nullptr, nullptr, proj, mask, nullptr, nullptr,      \
        nullptr, nullptr, lay, batch, seq_len, num_heads, 1e-6f, 1.f,       \
        cluster, s, static_cast<float*>(kv)));                              \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

extern "C" int mdm_favor_attention_apply(const void* q, const void* k,
                                         const void* kv, const void* proj,
                                         const void* mask, void* out,
                                         void* scratch, int batch,
                                         int num_heads, int seq_len,
                                         int head_dim, int num_features,
                                         float eps, int cluster,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long td = (long long)seq_len * head_dim;
  const mdm::FavorLayout lay{num_heads * td, td, head_dim,
                             num_heads * td, td, head_dim};
#define MDM_FAVOR_CASE(D_, M_)                                              \
  if (head_dim == D_ && num_features == M_) {                               \
    return int(mdm::launch_favor<float, D_, M_, false, false, mdm::kApply>( \
        q, k, nullptr, nullptr, nullptr, proj, mask, out,                   \
        static_cast<float*>(scratch), nullptr, nullptr, lay, batch,         \
        seq_len, num_heads, eps, 1.f, cluster, s,                           \
        static_cast<float*>(const_cast<void*>(kv))));                       \
  }
  MDM_FAVOR_SHAPES(MDM_FAVOR_CASE)
#undef MDM_FAVOR_CASE
  return int(cudaErrorInvalidValue);
}

#undef MDM_FAVOR_SHAPES
