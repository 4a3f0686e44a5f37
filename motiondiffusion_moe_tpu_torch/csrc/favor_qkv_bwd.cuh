// Backward of the merged-QKV Performer (FAVOR+) core, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/performer_pallas_bwd.py::_favor_qkv_bwd_kernel
// (public entry favor_qkv_bwd_pallas): the full backward of favor_qkv.cu,
// d(qkv), d(ln_scale), d(ln_bias) and, when asked, d(proj). Every forward
// intermediate is recomputed from the inputs (the autograd Function saves
// only the inputs, as the JAX custom_vjp does). Gradient conventions follow
// performer_pallas_bwd.py:20-28: LayerNorm dx = istd (s g - mean(s g) -
// z mean(s g z)); the L2 cutoff and max(den, eps) pass gradient iff the
// argument reached the cutoff; clip passes iff -15 <= logit <= 15.
//
// What bounds it on the card: its products, as the forward. Per (b, h) at
// T = 196, D = m = 128: the forward's four [T, 128] x [128, 128] products
// recomputed once and six of the backward (8.2 GFLOP at the flagship
// shape, two more with d(proj)) against ~45 MB of reads and writes. All
// run on the tensor cores as the forward's: 3xTF32
// (common.cuh::warp_product), or one bf16 mma per k step with
// FAVOR_MXU_BF16=1 when the forward took it.
//
// Design: the forward's. The T rows of a (b, h) are split in tiles of 16
// over the C CTAs of a thread-block cluster, 8 warps each, and three passes
// walk this CTA's tiles:
//   pass 1  kv = phi(k)^T v as the forward's pass 1; the cluster's sum in
//           rank order (common.cuh::cluster_sum), times 0.1.
//   pass 2  per tile: q and phi(q), phi(k) from pass 1's logits, den, the
//           output and its LayerNorm; then g_u, g_o, g_den and the whole q
//           side (g_phi(q) = g_o kv^T, clip mask, g_q2 = dqlin proj^T, L2
//           and LayerNorm backward, d(q)); g_kv += phi(q)^T g_o in mma
//           accumulators.
//           Then the cluster's g_kv in rank order, times 0.1.
//   pass 3  per tile: the k and v side, which needs the whole g_kv
//           (g_phi(k) = v1 g_kv^T, g_v1 = phi(k) g_kv, clip mask, g_k2, L2
//           and LayerNorm backward, d(k), d(v)); with d(proj) asked for,
//           q2^T dqlin + k2^T dklin in mma accumulators, summed over the
//           cluster at the end.
// The rows are normalized by common.cuh::normalize_loaded and their logits
// taken by common.cuh::feature_logits, the forward's own routines: the
// logits, and with them the clip masks, are the forward's bit for bit.
// Each tile's logits are taken once: the k logits of pass 1 and phi(q) of
// pass 2 go to a global scratch, with g_den and dqlin, for the later passes
// (the same CTA writes and reads them), so each of the ten products is
// taken once. d(ln_scale) and d(ln_bias) are per-CTA partials, d(proj) one
// partial per (b, h), all summed by a second small kernel in a fixed
// order: no atomics, so repeated runs give identical bits.
// Shared memory: 208 KB at D = m = 128 (the projection, kv / g_kv, nine row
// tiles with padded leading dimensions), one CTA per SM. At D = 256 the
// projection and kv do not both fit (375 KB): the products read the
// projection from device memory (128 KB, L2-resident) and kv is held
// unpadded, 232 KB in all, with bank conflicts on its reads; a simple
// first version of that width.
//
// Under a seq mesh each rank holds its own frames of T, and kv and g_kv
// are the two sums over T. So the kernel also runs as three launches of
// the same template (kPass), with the seq ranks' all-reduces between them
// (ops/performer.py::_FavorQKVSplit):
//   kPassKv pass 1 on the rank's rows: the k logits to the scratch, the
//        cluster's kv times 0.1 to kv_io [B, H, M, D] f32; nothing else.
//   kPassQ  kv from kv_io (the seq ranks' sum) in place of pass 1's; pass 2:
//        d(q) of the rank's rows, phi(q), g_den and dqlin to the scratch,
//        the cluster's g_kv times 0.1 to gkv_io; each thread's d(ln)
//        accumulators to the scratch.
//   kPassK  g_kv from gkv_io (the seq ranks' sum); the accumulators back from
//        the scratch; pass 3 and the partials' sums: d(k), d(v) and the
//        rank's d(ln_scale), d(ln_bias), d(proj).
// The 0.1 falls on each rank's partial kv and g_kv, before the seq sum, as
// in the forward's moments. All three take the same grid and cluster (the
// scratch is read back by the CTA that wrote it) and one scratch
// (favor_bwd_scratch_floats with split). The whole-T kernel (kPass kPassWhole)
// is the instance it was; the C entries are favor_qkv_bwd.cu (whole T) and
// favor_qkv_bwd_split.cu (the three launches).
#pragma once

#include <cstddef>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kRows = 16;  // rows of T per tile: one mma row tile

// kPass: what one launch runs (see the file's head)
constexpr int kPassWhole = 0;
constexpr int kPassKv = 1;
constexpr int kPassQ = 2;
constexpr int kPassK = 3;

template <int D, int M>
struct BwdSmem {
  // the projection staged in shared memory (else read where it lies)
  static constexpr bool kProjSmem = D <= 128;
  static constexpr int kLdP = kProjSmem ? M + 8 : M;  // projection [D][M]
  // kv, g_kv [M][D]; d(proj) [D][M]
  static constexpr int kLdKv = kProjSmem ? D + 8 : D;
  static constexpr int kLdX = D + 4;    // q2, k2 rows; g_q2 (pass 2)
  // v1 rows; u, g_o (pass 2); g_k2 (pass 3)
  static constexpr int kLdV = D + 8;
  static constexpr int kLdW = D + 4;    // g_v1 * 0.1 (pass 3)
  static constexpr int kLdPq = M + 4;   // phi(q)
  static constexpr int kLdPk = M + 8;   // masked phi(k)
  static constexpr int kLdDq = M + 4;   // q logits, then dqlin
  static constexpr int kLdDk = M + 4;   // k logits, then dklin (pass 3)
  static constexpr int kP = 0;
  static constexpr int kKv = kP + (kProjSmem ? D * kLdP : 0);
  static constexpr int kQ = kKv + M * kLdKv;
  static constexpr int kK = kQ + kRows * kLdX;
  static constexpr int kV = kK + kRows * kLdX;
  static constexpr int kW = kV + kRows * kLdV;
  static constexpr int kPq = kW + kRows * kLdW;
  static constexpr int kPk = kPq + kRows * kLdPq;
  static constexpr int kDq = kPk + kRows * kLdPk;
  static constexpr int kDk = kDq + kRows * kLdDq;
  static constexpr int kDen = kDk + kRows * kLdDk;  // den before the eps floor
  static constexpr int kGden = kDen + kRows;
  static constexpr int kMask = kGden + kRows;
  static constexpr size_t kBytes = sizeof(float) * size_t(kMask + kRows);
  static_assert(kBytes <= 232448, "within an sm_90 block's shared memory");
  static_assert(D * M <= M * kLdKv, "d(proj) fits where g_kv was");
  static_assert(2 * kBwdWarps * D <= 2 * kRows * kLdX, "ds / dc reduction");
};

// The pre-LayerNorm input of one row, lane-strided: x[c] = src[lane + 32c]
// * pre_scale; z the normalized input and y = z * s + beta, from the row's
// statistics.
template <typename T, int C>
__device__ __forceinline__ void ln_recompute(const T* __restrict__ src,
                                             const RowStats& st,
                                             const float (&s)[C],
                                             const float (&beta)[C],
                                             float pre_scale, int lane,
                                             float (&z)[C], float (&y)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float x = to_f32(src[lane + 32 * c]) * pre_scale;
    z[c] = (x - st.mu) * st.inv;
    y[c] = z[c] * s[c] + beta[c];
  }
}

// L2 backward (the max(n2, 1e-24) cutoff in rsqrt form, as the TPU kernel):
// g1 = g2 r - y r^3 (g2 . y) [n2 >= 1e-24].
template <int C>
__device__ __forceinline__ void l2_bwd_row(const float (&g2)[C],
                                           const float (&y)[C],
                                           const RowStats& st,
                                           float (&g1)[C]) {
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) t = fmaf(g2[c], y[c], t);
  t = warp_sum(t);
  const float live = st.n2 >= 1e-24f ? 1.f : 0.f;
  const float k = st.r * st.r * st.r * t * live;
#pragma unroll
  for (int c = 0; c < C; ++c) g1[c] = g2[c] * st.r - y[c] * k;
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
}

// kv_io, gkv_io [B*H, M, D] f32 and acc_buf (2 * CD floats a thread): the
// split's hand-over between launches (null for kPassWhole).
template <typename T, int D, int M, bool kBf16, int kPass>
__global__ void __launch_bounds__(kBwdThreads, 1) favor_qkv_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ proj,
    const float* __restrict__ mask, const T* __restrict__ gout,
    T* __restrict__ dqkv, float* __restrict__ gden_buf,
    float* __restrict__ dqlin_buf, float* __restrict__ ds_part,
    float* __restrict__ dc_part, float* __restrict__ dp_part,
    float* __restrict__ kl_buf, float* __restrict__ pq_buf,
    float* __restrict__ logits_q, float* __restrict__ logits_k,
    float* __restrict__ kv_io, float* __restrict__ gkv_io,
    float* __restrict__ acc_buf, int seq_len, int num_heads, float eps,
    float pre_scale) {
  static_assert(D % 32 == 0 && M % 32 == 0, "D and M must be multiples of 32");
  static_assert(M == 16 * kBwdWarps, "kv: one 16-row mma tile per warp");
  using S = BwdSmem<D, M>;
  constexpr int CD = D / 32;  // columns of a D-row held by one lane
  constexpr int NKV = D / 8;  // kv / g_kv n-tiles of a warp
  // n-tiles of 8 columns a warp takes at a time in a [16 x D] product
  constexpr int NO = (D / 8) % (2 * kBwdWarps) == 0 ? 2 : 1;
  constexpr float kInvD = 1.0f / float(D);
  const bool want_dp = dp_part != nullptr;

  extern __shared__ __align__(16) float smem[];
  const float* s_p = S::kProjSmem ? smem + S::kP : proj;
  float* s_kv = smem + S::kKv;
  float* s_q = smem + S::kQ;
  float* s_k = smem + S::kK;
  float* s_v = smem + S::kV;
  float* s_w = smem + S::kW;
  float* s_pq = smem + S::kPq;
  float* s_pk = smem + S::kPk;
  float* s_dq = smem + S::kDq;
  float* s_dk = smem + S::kDk;
  float* s_den = smem + S::kDen;
  float* s_gden = smem + S::kGden;
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
  const int hd = num_heads * D;
  const size_t row_stride = 3 * size_t(hd);
  const size_t base = size_t(b) * seq_len * row_stride + size_t(h) * D;
  const T* q_base = qkv + base;
  const T* k_base = q_base + hd;
  const T* v_base = q_base + 2 * hd;
  T* dq_base = dqkv + base;
  T* dk_base = dq_base + hd;
  T* dv_base = dq_base + 2 * hd;
  const T* g_base = gout + size_t(b) * seq_len * hd + size_t(h) * D;
  const float* mask_row =
      mask == nullptr ? nullptr : mask + size_t(b) * seq_len;
  float* gden_row = gden_buf + size_t(bh) * seq_len;
  float* dqlin_rows =
      want_dp ? dqlin_buf + size_t(bh) * seq_len * M : nullptr;
  float* kl_rows = kl_buf + size_t(bh) * seq_len * M;  // pass 1 -> 2, 3
  float* pq_rows = pq_buf + size_t(bh) * seq_len * M;  // pass 2 -> 3
  const int n_tiles = (seq_len + kRows - 1) / kRows;
  const int tile0 = rank * n_tiles / n_rank;
  const int tile1 = (rank + 1) * n_tiles / n_rank;

  // LayerNorm parameters: contiguous for normalize_loaded, lane-strided for
  // the backward
  float gC[CD], bC[CD], gS[CD], bS[CD], ds_acc[CD], dc_acc[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    gC[c] = ln_scale[lane * CD + c];
    bC[c] = ln_bias[lane * CD + c];
    gS[c] = ln_scale[lane + 32 * c];
    bS[c] = ln_bias[lane + 32 * c];
    ds_acc[c] = 0.f;
    dc_acc[c] = 0.f;
  }
  if constexpr (S::kProjSmem) {
    for (int i = threadIdx.x; i < D * M / 4; i += kBwdThreads) {
      const int e = 4 * i;
      *reinterpret_cast<float4*>(smem + S::kP + (e / M) * S::kLdP + e % M) =
          reinterpret_cast<const float4*>(proj)[i];
    }
  }

  // One warp stages rows 2 warp and 2 warp + 1 of a tile: loaded
  // (common.cuh::load_row), then normalised (normalize_loaded).
  using Rows = float[2][CD];
  auto load = [&](const T* src, int t0, Rows& x) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 2 * warp + r;
      load_row<T, CD>(src + size_t(t) * row_stride, t < seq_len, lane, x[r]);
    }
  };
  auto finish = [&](const Rows& x, int t0, bool l2, float* dst, int ld,
                    RowStats (&st)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * warp + r;
      st[r] = normalize_loaded<CD>(x[r], t0 + row < seq_len, gC, bC,
                                   pre_scale, l2, dst + row * ld, lane);
    }
  };
  auto stage_mask = [&](int t0) {
    if (threadIdx.x < kRows) {
      const int t = t0 + threadIdx.x;
      s_mask[threadIdx.x] =
          t < seq_len ? (mask_row == nullptr ? 1.f : mask_row[t]) : 0.f;
    }
  };
  auto frame_mask = [&](int t) {
    return t < seq_len ? (mask_row == nullptr ? 1.f : mask_row[t]) : 0.f;
  };
  // A 16 x 16 block of logits (the rows in src, columns n0 .. n0+15): phi,
  // times the frame mask when `masked`, into dst; the logits into `raw`
  // (shared memory) when not null; for the valid rows, the logits into
  // `raw_rows` ([T][M] of this (b, h)), phi into `phi_rows` and the logits
  // into `out` (global [B, T, H, M]), each when not null.
  auto features = [&](const float* src, int n0, bool masked, float* dst,
                      int ld, float* raw, int ld_raw, float* raw_rows,
                      float* phi_rows, float* out, int t0) {
    float acc[2][4];
    feature_logits<kBf16, D, 2>(src, S::kLdX, s_p, S::kLdP, n0, acc, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gq + (e >> 1) * 8;
        const int col = n0 + 8 * j + 2 * tq + (e & 1);
        const int t = t0 + row;
        const float phi = feature(acc[j][e]);
        dst[row * ld + col] = phi * (masked ? s_mask[row] : 1.f);
        if (raw != nullptr) raw[row * ld_raw + col] = acc[j][e];
        if (t < seq_len) {
          if (raw_rows != nullptr) raw_rows[size_t(t) * M + col] = acc[j][e];
          if (phi_rows != nullptr) phi_rows[size_t(t) * M + col] = phi;
          if (out != nullptr) {
            out[((size_t(b) * seq_len + t) * num_heads + h) * M + col] =
                acc[j][e];
          }
        }
      }
    }
  };
  // The masked phi(k) of a tile into s_pk from pass 1's k logits (the same
  // feature() of the same values: pass 1's bits), and with `raw` the logits
  // themselves into s_dk.
  // A tile of a [T][M] scratch as float4, all of a thread's loads issued
  // before any is used; rows past the sequence end read as zeros.
  constexpr int kTile4 = kRows * M / 4 / kBwdThreads;
  static_assert(kRows * M / 4 % kBwdThreads == 0, "whole float4 tiles");
  auto load_tile = [&](const float* rows, int t0, float4 (&x)[kTile4]) {
#pragma unroll
    for (int j = 0; j < kTile4; ++j) {
      const int e = 4 * (threadIdx.x + j * kBwdThreads);
      const int t = t0 + e / M;
      x[j] = t < seq_len ? *reinterpret_cast<const float4*>(
                               rows + size_t(t) * M + e % M)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_tile = [&](const float4 (&x)[kTile4], float* dst, int ld) {
#pragma unroll
    for (int j = 0; j < kTile4; ++j) {
      const int e = 4 * (threadIdx.x + j * kBwdThreads);
      *reinterpret_cast<float4*>(dst + (e / M) * ld + e % M) = x[j];
    }
  };
  auto load_k_features = [&](int t0, bool raw) {
    float4 kl[kTile4];
    load_tile(kl_rows, t0, kl);
#pragma unroll
    for (int j = 0; j < kTile4; ++j) {
      const int e = 4 * (threadIdx.x + j * kBwdThreads);
      const float mk = frame_mask(t0 + e / M);
      *reinterpret_cast<float4*>(s_pk + (e / M) * S::kLdPk + e % M) =
          make_float4(feature(kl[j].x) * mk, feature(kl[j].y) * mk,
                      feature(kl[j].z) * mk, feature(kl[j].w) * mk);
    }
    if (raw) store_tile(kl, s_dk, S::kLdDk);
  };
  RowStats st_q[2], st_k[2], st_v[2];
  // the split's hand-over: [M][D] f32 of this (b, h); each thread's d(ln)
  // accumulators, CD of ds then CD of dc, thread-minor
  auto load_kv = [&](const float* src) {
    const float4* s4 =
        reinterpret_cast<const float4*>(src + size_t(bh) * M * D);
    for (int i = threadIdx.x; i < M * D / 4; i += kBwdThreads) {
      const int e = 4 * i;
      *reinterpret_cast<float4*>(s_kv + (e / D) * S::kLdKv + e % D) = s4[i];
    }
    __syncthreads();
  };
  float* acc_cta = acc_buf == nullptr
                       ? nullptr
                       : acc_buf + size_t(blockIdx.x) * 2 * CD * kBwdThreads;

  // ---- pass 1: kv = phi(k)^T v -------------------------------------------
  if constexpr (kPass == kPassQ) {
    load_kv(kv_io);  // the seq ranks' summed kv, each partial times 0.1
  } else if constexpr (kPass != kPassK) {
    float kv[NKV][4];
    zero(kv);
    for (int tile = tile0; tile < tile1; ++tile) {
      const int t0 = tile * kRows;
      Rows xk, xv;
      load(k_base, t0, xk);
      load(v_base, t0, xv);
      stage_mask(t0);
      finish(xk, t0, true, s_k, S::kLdX, st_k);
      finish(xv, t0, false, s_v, S::kLdV, st_v);
      __syncthreads();
      features(s_k, 16 * warp, true, s_pk, S::kLdPk, nullptr, 0, kl_rows,
               nullptr, logits_k, t0);
      __syncthreads();
      warp_product<kBf16, NKV, true, false>(kv, s_pk + 16 * warp, S::kLdPk,
                                            s_v, S::kLdV, kRows, lane);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_kv[(16 * warp + gq + (e >> 1) * 8) * S::kLdKv + 8 * j + 2 * tq +
             (e & 1)] = kv[j][e];
      }
    }
    if constexpr (kPass == kPassKv) {
      // each CTA writes its slice of the cluster's sum, and done
      cluster_sum(s_kv, S::kLdKv, M, D, 0.1f, false,
                  kv_io + size_t(bh) * M * D);
      return;
    } else {
      cluster_sum(s_kv, S::kLdKv, M, D, 0.1f, true, nullptr);
    }
  }

  // ---- pass 2: output recompute, g_o, g_den, the q side, g_kv -------------
  if constexpr (kPass == kPassK) {
    load_kv(gkv_io);  // the seq ranks' summed g_kv, each partial times 0.1
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      ds_acc[c] = acc_cta[c * kBwdThreads + threadIdx.x];
      dc_acc[c] = acc_cta[(CD + c) * kBwdThreads + threadIdx.x];
    }
  } else if constexpr (kPass != kPassKv) {
    float gkv[NKV][4];
    zero(gkv);
    for (int tile = tile0; tile < tile1; ++tile) {
      const int t0 = tile * kRows;
      Rows xq;
      load(q_base, t0, xq);
      stage_mask(t0);
      finish(xq, t0, true, s_q, S::kLdX, st_q);
      load_k_features(t0, false);
      __syncthreads();
      for (int job = warp; job < M / 16; job += kBwdWarps) {
        features(s_q, 16 * job, false, s_pq, S::kLdPq, s_dq, S::kLdDq, nullptr,
                 pq_rows, logits_q, t0);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 2 * warp + r;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < M / 32; ++c) {
          part = fmaf(s_pq[row * S::kLdPq + lane + 32 * c],
                      s_pk[row * S::kLdPk + lane + 32 * c], part);
        }
        part = warp_sum(part);
        if (lane == 0) s_den[row] = part;
      }
      __syncthreads();
      // u = phi(q) kv * 0.1 / den (kv already carries its 0.1)
      for (int j0 = NO * warp; j0 < D / 8; j0 += NO * kBwdWarps) {
        float o[NO][4];
        zero(o);
        warp_product<kBf16, NO, false, false>(o, s_pq, S::kLdPq, s_kv + 8 * j0,
                                              S::kLdKv, M, lane);
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gq + (e >> 1) * 8;
            s_v[row * S::kLdV + 8 * (j0 + j) + 2 * tq + (e & 1)] =
                o[j][e] * 0.1f / fmaxf(s_den[row], eps);
          }
        }
      }
      __syncthreads();
      // per row: the output LayerNorm backward, g_den and g_o = g_u / den
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 2 * warp + r;
        const int t = t0 + row;
        float* u_row = s_v + row * S::kLdV;
        if (t >= seq_len) {  // the same for all lanes of the warp
#pragma unroll
          for (int c = 0; c < CD; ++c) u_row[lane + 32 * c] = 0.f;
          if (lane == 0) s_gden[row] = 0.f;
          continue;
        }
        const float den_raw = s_den[row];
        const float den = fmaxf(den_raw, eps);
        float u[CD], s = 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          u[c] = u_row[lane + 32 * c];
          s += u[c];
        }
        const float mu = warp_sum(s) * kInvD;
        float var = 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float d = u[c] - mu;
          var = fmaf(d, d, var);
        }
        const float inv = 1.0f / sqrtf(warp_sum(var) * kInvD + kLnEps);
        float z[CD], g[CD], gu[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          z[c] = (u[c] - mu) * inv;
          g[c] = to_f32(g_base[size_t(t) * hd + lane + 32 * c]);
        }
        layer_norm_bwd_row<CD>(g, z, gS, inv, gu, ds_acc, dc_acc);
        float gu_u = 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) gu_u = fmaf(gu[c], u[c], gu_u);
        gu_u = warp_sum(gu_u);
        const float gden = den_raw >= eps ? -gu_u / den : 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) u_row[lane + 32 * c] = gu[c] / den;
        if (lane == 0) {
          s_gden[row] = gden;
          gden_row[t] = gden;
        }
      }
      __syncthreads();
      // dqlin = [clip passes] (g_o kv^T * 0.1 + g_den phi(k)) phi(q), over the
      // q logits kept in s_dq
      {
        const int n0 = 16 * warp;
        float gqa[2][4];
        zero(gqa);
        warp_product<kBf16, 2, false, true>(gqa, s_v, S::kLdV,
                                            s_kv + n0 * S::kLdKv, S::kLdKv, D,
                                            lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gq + (e >> 1) * 8;
            const int col = n0 + 8 * j + 2 * tq + (e & 1);
            const int t = t0 + row;
            const float gqp = gqa[j][e] * 0.1f +
                              s_gden[row] * s_pk[row * S::kLdPk + col];
            const float ql = s_dq[row * S::kLdDq + col];
            const bool pass = ql >= -15.f && ql <= 15.f;
            const float dq = (t < seq_len && pass)
                                 ? gqp * s_pq[row * S::kLdPq + col]
                                 : 0.f;
            s_dq[row * S::kLdDq + col] = dq;
            if (want_dp && t < seq_len) dqlin_rows[size_t(t) * M + col] = dq;
          }
        }
      }
      // g_kv += phi(q)^T g_o
      warp_product<kBf16, NKV, true, false>(gkv, s_pq + 16 * warp, S::kLdPq,
                                            s_v, S::kLdV, kRows, lane);
      __syncthreads();
      // g_q2 = dqlin proj^T into s_k
      for (int j0 = NO * warp; j0 < D / 8; j0 += NO * kBwdWarps) {
        float o[NO][4];
        zero(o);
        warp_product<kBf16, NO, false, true>(o, s_dq, S::kLdDq,
                                             s_p + 8 * j0 * S::kLdP, S::kLdP,
                                             M, lane);
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s_k[(gq + (e >> 1) * 8) * S::kLdX + 8 * (j0 + j) + 2 * tq +
                (e & 1)] = o[j][e];
          }
        }
      }
      __syncthreads();
      // per row: the q side's L2 and LayerNorm backward, d(q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 2 * warp + r;
        const int t = t0 + row;
        if (t >= seq_len) continue;
        float z[CD], y[CD], g2[CD], g1[CD], g0[CD];
        ln_recompute<T, CD>(q_base + size_t(t) * row_stride, st_q[r], gS, bS,
                            pre_scale, lane, z, y);
#pragma unroll
        for (int c = 0; c < CD; ++c) g2[c] = s_k[row * S::kLdX + lane + 32 * c];
        l2_bwd_row<CD>(g2, y, st_q[r], g1);
        layer_norm_bwd_row<CD>(g1, z, gS, st_q[r].inv, g0, ds_acc, dc_acc);
        T* dst = dq_base + size_t(t) * row_stride;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dst[lane + 32 * c] = from_f32<T>(g0[c] * pre_scale);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_kv[(16 * warp + gq + (e >> 1) * 8) * S::kLdKv + 8 * j + 2 * tq +
             (e & 1)] = gkv[j][e];
      }
    }
    if constexpr (kPass == kPassQ) {
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        acc_cta[c * kBwdThreads + threadIdx.x] = ds_acc[c];
        acc_cta[(CD + c) * kBwdThreads + threadIdx.x] = dc_acc[c];
      }
      cluster_sum(s_kv, S::kLdKv, M, D, 0.1f, false,
                  gkv_io + size_t(bh) * M * D);
      return;
    } else {
      cluster_sum(s_kv, S::kLdKv, M, D, 0.1f, true, nullptr);
    }
  }

  // ---- pass 3: the k and v side; d(proj) ----------------------------------
  constexpr int DI = D / 16;  // d(proj) row tiles, all in every warp
  float dp[DI][2][4];
#pragma unroll
  for (int i = 0; i < DI; ++i) zero(dp[i]);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int t0 = tile * kRows;
    Rows xq, xk, xv;
    if (want_dp) load(q_base, t0, xq);  // q2 only for d(proj)
    load(k_base, t0, xk);
    load(v_base, t0, xv);
    stage_mask(t0);
    if (want_dp) finish(xq, t0, true, s_q, S::kLdX, st_q);
    finish(xk, t0, true, s_k, S::kLdX, st_k);
    finish(xv, t0, false, s_v, S::kLdV, st_v);
    if (threadIdx.x < kRows) {
      const int t = t0 + threadIdx.x;
      s_gden[threadIdx.x] = t < seq_len ? gden_row[t] : 0.f;
    }
    // pass 1's k logits and pass 2's phi(q): no logits computed here
    {
      float4 pq[kTile4], dq[kTile4];
      load_tile(pq_rows, t0, pq);
      if (want_dp) load_tile(dqlin_rows, t0, dq);
      load_k_features(t0, true);
      store_tile(pq, s_pq, S::kLdPq);
      if (want_dp) store_tile(dq, s_dq, S::kLdDq);
    }
    __syncthreads();
    for (int job = warp; job < M / 16 + D / 16; job += kBwdWarps) {
      float acc[2][4];
      zero(acc);
      if (job < M / 16) {
        // dklin = [clip passes] (v1 g_kv^T * 0.1 + g_den phi(q)) mask
        // phi(k), over the k logits kept in s_dk
        const int n0 = 16 * job;
        warp_product<kBf16, 2, false, true>(acc, s_v, S::kLdV,
                                            s_kv + n0 * S::kLdKv, S::kLdKv, D,
                                            lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gq + (e >> 1) * 8;
            const int col = n0 + 8 * j + 2 * tq + (e & 1);
            const float gkp = acc[j][e] * 0.1f +
                              s_gden[row] * s_pq[row * S::kLdPq + col];
            const float kl = s_dk[row * S::kLdDk + col];
            const bool pass = kl >= -15.f && kl <= 15.f;
            s_dk[row * S::kLdDk + col] =
                pass ? gkp * s_mask[row] * feature(kl) : 0.f;
          }
        }
      } else {
        // g_v1 = phi(k) g_kv * 0.1 into s_w
        const int n0 = 16 * (job - M / 16);
        warp_product<kBf16, 2, false, false>(acc, s_pk, S::kLdPk, s_kv + n0,
                                             S::kLdKv, M, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s_w[(gq + (e >> 1) * 8) * S::kLdW + n0 + 8 * j + 2 * tq +
                (e & 1)] = acc[j][e] * 0.1f;
          }
        }
      }
    }
    __syncthreads();
    // g_k2 = dklin proj^T into s_v (D wide; v1 is no longer read)
    for (int j0 = NO * warp; j0 < D / 8; j0 += NO * kBwdWarps) {
      float o[NO][4];
      zero(o);
      warp_product<kBf16, NO, false, true>(o, s_dk, S::kLdDk,
                                           s_p + 8 * j0 * S::kLdP, S::kLdP,
                                           M, lane);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_v[(gq + (e >> 1) * 8) * S::kLdV + 8 * (j0 + j) + 2 * tq +
               (e & 1)] = o[j][e];
        }
      }
    }
    if (want_dp) {  // the same for the whole grid
      // d(proj) += q2^T dqlin + k2^T dklin, columns 16 warp .. + 16
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        warp_product<kBf16, 2, true, false>(dp[i], s_q + 16 * i, S::kLdX,
                                            s_dq + 16 * warp, S::kLdDq, kRows,
                                            lane);
        warp_product<kBf16, 2, true, false>(dp[i], s_k + 16 * i, S::kLdX,
                                            s_dk + 16 * warp, S::kLdDk, kRows,
                                            lane);
      }
    }
    __syncthreads();
    // per row: the k side's L2 and LayerNorm backward and the v side's
    // LayerNorm backward, d(k) and d(v)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * warp + r;
      const int t = t0 + row;
      if (t >= seq_len) continue;
      float z[CD], y[CD], g2[CD], g1[CD], g0[CD];
      ln_recompute<T, CD>(k_base + size_t(t) * row_stride, st_k[r], gS, bS,
                          pre_scale, lane, z, y);
#pragma unroll
      for (int c = 0; c < CD; ++c) g2[c] = s_v[row * S::kLdV + lane + 32 * c];
      l2_bwd_row<CD>(g2, y, st_k[r], g1);
      layer_norm_bwd_row<CD>(g1, z, gS, st_k[r].inv, g0, ds_acc, dc_acc);
      T* dst = dk_base + size_t(t) * row_stride;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[lane + 32 * c] = from_f32<T>(g0[c] * pre_scale);
      }
      ln_recompute<T, CD>(v_base + size_t(t) * row_stride, st_v[r], gS, bS,
                          pre_scale, lane, z, y);
#pragma unroll
      for (int c = 0; c < CD; ++c) g1[c] = s_w[row * S::kLdW + lane + 32 * c];
      layer_norm_bwd_row<CD>(g1, z, gS, st_v[r].inv, g0, ds_acc, dc_acc);
      dst = dv_base + size_t(t) * row_stride;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[lane + 32 * c] = from_f32<T>(g0[c] * pre_scale);
      }
    }
    __syncthreads();
  }

  // ---- d(proj): the cluster's sum, one partial per (b, h) ----------------
  if (want_dp) {
#pragma unroll
    for (int i = 0; i < DI; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_kv[(16 * i + gq + (e >> 1) * 8) * M + 16 * warp + 8 * j + 2 * tq +
               (e & 1)] = dp[i][j][e];
        }
      }
    }
    cluster_sum(s_kv, M, D, M, 1.f, false, dp_part + size_t(bh) * D * M);
  }

  // ---- d(ln_scale), d(ln_bias): per-CTA partials --------------------------
  float* red = s_q;  // [2][kBwdWarps][D]
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    red[warp * D + lane + 32 * c] = ds_acc[c];
    red[(kBwdWarps + warp) * D + lane + 32 * c] = dc_acc[c];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kBwdThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) {
      s1 += red[w * D + d];
      s2 += red[(kBwdWarps + w) * D + d];
    }
    ds_part[size_t(blockIdx.x) * D + d] = s1;
    dc_part[size_t(blockIdx.x) * D + d] = s2;
  }
}

// out[j] = sum over p < n_part of part[p * n + j], in the order p = 0, 1, ...
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int n_part,
                                    int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += part[size_t(p) * n + j];
  out[j] = s;
}

cudaError_t sum_partials(const float* part, float* out, int n_part, int n,
                         cudaStream_t stream) {
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, out, n_part,
                                                          n);
  return cudaGetLastError();
}

size_t favor_bwd_scratch_floats(int batch, int seq_len, int num_heads,
                                int head_dim, int num_features, bool want_dp,
                                int cluster, bool split = false) {
  const size_t bh = size_t(batch) * num_heads;
  // g_den; the ds and dc partials of every CTA; the k logits and phi(q)
  size_t n = bh * seq_len + 2 * bh * cluster * head_dim +
             2 * bh * seq_len * num_features;
  if (want_dp) n += bh * seq_len * num_features + bh * head_dim * num_features;
  // the split's d(ln) accumulators: 2 * head_dim / 32 a thread
  if (split) n += 2 * bh * cluster * (kBwdThreads / 32) * head_dim;
  return n;
}

// One launch of kPass (kPassWhole: the whole backward) and, for kPassWhole
// and kPassK, the partials' sums. want_dp: d(proj) asked for (d_proj is
// then written by kPassWhole / kPassK). kv_io, gkv_io: the split's kv and
// g_kv [B*H, M, D] f32 (null for kPassWhole).
template <typename T, int D, int M, bool kBf16, int kPass = kPassWhole>
cudaError_t launch_favor_qkv_bwd(const void* qkv, const void* ln_scale,
                                 const void* ln_bias, const void* proj,
                                 const void* mask, const void* g, void* dqkv,
                                 void* d_scale, void* d_bias, void* d_proj,
                                 void* scratch, float* logits_q,
                                 float* logits_k, int batch, int seq_len,
                                 int num_heads, float eps, float pre_scale,
                                 int cluster, cudaStream_t stream,
                                 bool want_dp, float* kv_io = nullptr,
                                 float* gkv_io = nullptr) {
  if (cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
  constexpr size_t smem = BwdSmem<D, M>::kBytes;
  auto kernel = favor_qkv_bwd_kernel<T, D, M, kBf16, kPass>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int bh = batch * num_heads;
  const int n_cta = bh * cluster;
  // the [.., M] arrays first, so that each starts 16-byte aligned
  const size_t rows = size_t(bh) * seq_len * M;
  float* kl = static_cast<float*>(scratch);
  float* pq = kl + rows;
  float* dqlin = want_dp ? pq + rows : nullptr;
  float* dp_part = want_dp ? dqlin + rows : nullptr;
  float* gden = want_dp ? dp_part + size_t(bh) * D * M : pq + rows;
  float* ds_part = gden + size_t(bh) * seq_len;
  float* dc_part = ds_part + size_t(n_cta) * D;
  float* acc = kPass == kPassWhole ? nullptr : dc_part + size_t(n_cta) * D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_cta));
  cfg.blockDim = dim3(kBwdThreads);
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
      &cfg, kernel, static_cast<const T*>(qkv),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const float*>(proj), static_cast<const float*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dqkv), gden, dqlin, ds_part,
      dc_part, dp_part, kl, pq, logits_q, logits_k, kv_io, gkv_io, acc,
      seq_len, num_heads, eps, pre_scale);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || kPass == kPassKv || kPass == kPassQ) return err;
  err = sum_partials(ds_part, static_cast<float*>(d_scale), n_cta, D, stream);
  if (err != cudaSuccess) return err;
  err = sum_partials(dc_part, static_cast<float*>(d_bias), n_cta, D, stream);
  if (err != cudaSuccess || !want_dp) return err;
  return sum_partials(dp_part, static_cast<float*>(d_proj), bh, D * M, stream);
}

}  // namespace
}  // namespace mdm
