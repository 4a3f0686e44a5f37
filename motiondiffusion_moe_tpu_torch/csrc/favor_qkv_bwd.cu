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
// What bounds it on the card: f32 FMA throughput, as the forward. Per
// (b, h) at T = 196, D = m = 128: eleven [T, 128] x [128, 128] row products
// and four outer-product accumulations over T, ~50 M FMAs, against ~1 MB of
// reads and writes. All products are IEEE f32 FMAs, as in the forward.
//
// Design: one block of 8 warps per (b, h) and three passes over T in tiles
// of 16 rows (2 per warp).
//   pass 1  kv = phi(k)^T v * 0.1, as the forward's pass 1.
//   pass 2  per row: q, k, phi(q), phi(k), den, the output and its
//           LayerNorm; then g_u, g_o, g_den and the whole q side
//           (g_phi(q), clip mask, g_q2 = dqlin proj^T, L2 and LayerNorm
//           backward, d(q)). g_kv = phi(q)^T g_o * 0.1 accumulates in
//           registers over the tiles.
//   pass 3  per row: the k and v side, which needs the finished g_kv
//           (g_phi(k), g_v1, clip mask, g_k2, L2 and LayerNorm backward,
//           d(k), d(v)); with d(proj) asked for, q2^T dqlin + k2^T dklin
//           accumulates in registers.
// The rows are normalized by common.cuh::normalize_row, the forward's own
// function, so the logits, and with them the clip masks, are the forward's
// bit for bit. proj and kv (g_kv after pass 2) sit in shared memory with a
// padded row stride (width + 1 floats): a warp reads either matrix along a
// row or along a column without bank conflicts, so no transposed copy is
// needed. That is 132 KB at D = m = 128, plus 48 KB of row tiles, which
// leaves no room for a third [128, 128] matrix: d(proj) lives in registers
// (each thread owns an 8 x 8 piece), and g_den and dqlin go from pass 2 to
// pass 3 through a global scratch. Sums across blocks (d(ln_scale),
// d(ln_bias), d(proj)) are per-block partials in the scratch, summed by a
// second small kernel in a fixed order: no atomics, so repeated runs give
// identical bits.

#include <cstddef>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdRows = 2;                     // rows per warp per tile
constexpr int kBwdTile = kBwdWarps * kBwdRows;  // rows of T per tile

template <int D, int M>
constexpr size_t favor_bwd_smem_bytes() {
  return sizeof(float) * (size_t(D) * (M + 1) + size_t(M) * (D + 1) +
                          3 * size_t(kBwdTile) * D +
                          3 * size_t(kBwdTile) * M);
}

// out[r][c] = sum_k rows[r][k] * mat[k][lane + 32 c]: R rows, each K wide in
// shared memory (read as broadcasts), against a matrix read along its rows
// (row stride `stride`). For the feature logits this is the forward's
// summation order (one fmaf chain over k), so the logits match it exactly.
template <int K, int C, int R>
__device__ __forceinline__ void rows_times_mat(const float* rows,
                                               const float* mat, int stride,
                                               int lane, float (&out)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[r][c] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = mat[k * stride + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float a = rows[r * K + k];
#pragma unroll
      for (int c = 0; c < C; ++c) out[r][c] = fmaf(a, w[c], out[r][c]);
    }
  }
}

// out[r][c] = sum_k rows[r][k] * mat[lane + 32 c][k]: the same against the
// matrix's transpose, read along its columns (conflict-free: the padded
// stride is 1 mod 32).
template <int K, int C, int R>
__device__ __forceinline__ void rows_times_mat_t(const float* rows,
                                                 const float* mat, int stride,
                                                 int lane,
                                                 float (&out)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[r][c] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = mat[(lane + 32 * c) * stride + k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float a = rows[r * K + k];
#pragma unroll
      for (int c = 0; c < C; ++c) out[r][c] = fmaf(a, w[c], out[r][c]);
    }
  }
}

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

template <typename T, int D, int M>
__global__ void __launch_bounds__(kBwdThreads, 1) favor_qkv_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ proj,
    const float* __restrict__ mask, const T* __restrict__ gout,
    T* __restrict__ dqkv, float* __restrict__ gden_buf,
    float* __restrict__ dqlin_buf, float* __restrict__ ds_part,
    float* __restrict__ dc_part, float* __restrict__ dp_part, int seq_len,
    int num_heads, float eps, float pre_scale) {
  static_assert(D % 32 == 0 && M % 32 == 0, "D and M must be multiples of 32");
  constexpr int R = kBwdRows;
  constexpr int CD = D / 32;  // lane-strided columns of a D-row per lane
  constexpr int CM = M / 32;  // lane-strided columns of an M-row per lane
  constexpr int MI = M / 16;  // kv / g_kv rows owned by one thread
  constexpr int DJ = D / 16;  // kv / g_kv columns owned by one thread
  constexpr int DI = D / 16;  // d(proj) rows owned by one thread
  constexpr int MJ = M / 16;  // d(proj) columns owned by one thread
  constexpr int PS = M + 1;   // padded row stride of proj
  constexpr int KS = D + 1;   // padded row stride of kv and g_kv
  constexpr float kInvD = 1.0f / float(D);
  const bool want_dp = dp_part != nullptr;

  extern __shared__ __align__(16) float smem[];
  float* s_proj = smem;               // [D][PS]
  float* s_kv = s_proj + D * PS;      // [M][KS]: kv * 0.1, then g_kv * 0.1
  float* t_a = s_kv + M * KS;         // [tile][D]: q2
  float* t_b = t_a + kBwdTile * D;    // [tile][D]: k2
  float* t_c = t_b + kBwdTile * D;    // [tile][D]: v1 (passes 1, 3), g_o (2)
  float* t_p = t_c + kBwdTile * D;    // [tile][M]: masked phi(k) (1, 3),
                                      //            phi(q) (2)
  float* t_q = t_p + kBwdTile * M;    // [tile][M]: dqlin
  float* t_k = t_q + kBwdTile * M;    // [tile][M]: dklin

  const int bh = blockIdx.x;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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

  // LayerNorm parameters: contiguous for normalize_row, lane-strided for
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
  for (int i = threadIdx.x; i < D * M; i += kBwdThreads) {
    s_proj[(i / M) * PS + i % M] = proj[i];
  }
  __syncthreads();

  float* my_a = t_a + warp * R * D;
  float* my_b = t_b + warp * R * D;
  float* my_c = t_c + warp * R * D;
  float* my_p = t_p + warp * R * M;
  float* my_q = t_q + warp * R * M;
  float* my_k = t_k + warp * R * M;
  const int ig = threadIdx.x / 16;
  const int jg = threadIdx.x % 16;
  auto frame_mask = [&](int t) {
    return t < seq_len ? (mask_row == nullptr ? 1.f : mask_row[t]) : 0.f;
  };

  // ---- pass 1: kv = phi(k)^T v, over all tiles of T ----------------------
  float acc[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  for (int t0 = 0; t0 < seq_len; t0 += kBwdTile) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      const bool valid = t < seq_len;
      normalize_row<T, CD>(k_base + size_t(t) * row_stride, valid, gC, bC,
                           pre_scale, true, my_b + r * D, lane);
      normalize_row<T, CD>(v_base + size_t(t) * row_stride, valid, gC, bC,
                           pre_scale, false, my_c + r * D, lane);
    }
    __syncwarp();
    float kl[R][CM];
    rows_times_mat<D, CM, R>(my_b, s_proj, PS, lane, kl);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mk = frame_mask(t0 + warp * R + r);
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        my_p[r * M + lane + 32 * c] = feature(kl[r][c]) * mk;
      }
    }
    __syncthreads();
    for (int tt = 0; tt < kBwdTile; ++tt) {
      float p[MI], v[DJ];
      load_vec<MI>(t_p + tt * M + ig * MI, p);
      load_vec<DJ>(t_c + tt * D + jg * DJ, v);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      s_kv[(ig * MI + i) * KS + jg * DJ + j] = acc[i][j] * 0.1f;
      acc[i][j] = 0.f;  // g_kv from here on
    }
  }
  __syncthreads();

  // ---- pass 2: output recompute, g_o, g_den, the q side, g_kv -------------
  for (int t0 = 0; t0 < seq_len; t0 += kBwdTile) {
    RowStats sq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      const bool valid = t < seq_len;
      sq[r] = normalize_row<T, CD>(q_base + size_t(t) * row_stride, valid, gC,
                                   bC, pre_scale, true, my_a + r * D, lane);
      normalize_row<T, CD>(k_base + size_t(t) * row_stride, valid, gC, bC,
                           pre_scale, true, my_b + r * D, lane);
    }
    __syncwarp();
    float ql[R][CM], kl[R][CM];
    rows_times_mat<D, CM, R>(my_a, s_proj, PS, lane, ql);
    rows_times_mat<D, CM, R>(my_b, s_proj, PS, lane, kl);
    float qp[R][CM], kp[R][CM], den_raw[R], den[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mk = frame_mask(t0 + warp * R + r);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        qp[r][c] = feature(ql[r][c]);
        kp[r][c] = feature(kl[r][c]) * mk;
        part = fmaf(qp[r][c], kp[r][c], part);
        my_p[r * M + lane + 32 * c] = qp[r][c];
      }
      den_raw[r] = warp_sum(part);
      den[r] = fmaxf(den_raw[r], eps);
    }
    __syncwarp();
    float o[R][CD];
    rows_times_mat<M, CD, R>(my_p, s_kv, KS, lane, o);
    float gden[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      if (t >= seq_len) {  // the same for all lanes of the warp
        gden[r] = 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) my_c[r * D + lane + 32 * c] = 0.f;
        continue;
      }
      float u[CD], s = 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        u[c] = o[r][c] * 0.1f / den[r];
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
      gden[r] = den_raw[r] >= eps ? -gu_u / den[r] : 0.f;
#pragma unroll
      for (int c = 0; c < CD; ++c) my_c[r * D + lane + 32 * c] = gu[c] / den[r];
      if (lane == 0) gden_row[t] = gden[r];
    }
    __syncwarp();
    float gq[R][CM];  // g_o kv^T (kv already carries its 0.1)
    rows_times_mat_t<D, CM, R>(my_c, s_kv, KS, lane, gq);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      const bool valid = t < seq_len;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const float gqp = gq[r][c] * 0.1f + gden[r] * kp[r][c];
        const bool pass = ql[r][c] >= -15.f && ql[r][c] <= 15.f;
        const float dq = (valid && pass) ? gqp * qp[r][c] : 0.f;
        my_q[r * M + lane + 32 * c] = dq;
        if (want_dp && valid) {
          dqlin_rows[size_t(t) * M + lane + 32 * c] = dq;
        }
      }
    }
    __syncwarp();
    float gq2[R][CD];  // dqlin proj^T
    rows_times_mat_t<M, CD, R>(my_q, s_proj, PS, lane, gq2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      if (t >= seq_len) continue;
      float z[CD], y[CD], g1[CD], g0[CD];
      ln_recompute<T, CD>(q_base + size_t(t) * row_stride, sq[r], gS, bS,
                          pre_scale, lane, z, y);
      l2_bwd_row<CD>(gq2[r], y, sq[r], g1);
      layer_norm_bwd_row<CD>(g1, z, gS, sq[r].inv, g0, ds_acc, dc_acc);
      T* dst = dq_base + size_t(t) * row_stride;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[lane + 32 * c] = from_f32<T>(g0[c] * pre_scale);
      }
    }
    __syncthreads();
    for (int tt = 0; tt < kBwdTile; ++tt) {  // g_kv += phi(q)^T g_o
      float p[MI], v[DJ];
      load_vec<MI>(t_p + tt * M + ig * MI, p);
      load_vec<DJ>(t_c + tt * D + jg * DJ, v);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      s_kv[(ig * MI + i) * KS + jg * DJ + j] = acc[i][j] * 0.1f;
    }
  }
  __syncthreads();

  // ---- pass 3: the k and v side; d(proj) ----------------------------------
  float dp[DI][MJ];
#pragma unroll
  for (int i = 0; i < DI; ++i) {
#pragma unroll
    for (int j = 0; j < MJ; ++j) dp[i][j] = 0.f;
  }
  for (int t0 = 0; t0 < seq_len; t0 += kBwdTile) {
    RowStats sk[R], sv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      const bool valid = t < seq_len;
      normalize_row<T, CD>(q_base + size_t(t) * row_stride, valid, gC, bC,
                           pre_scale, true, my_a + r * D, lane);
      sk[r] = normalize_row<T, CD>(k_base + size_t(t) * row_stride, valid, gC,
                                   bC, pre_scale, true, my_b + r * D, lane);
      sv[r] = normalize_row<T, CD>(v_base + size_t(t) * row_stride, valid, gC,
                                   bC, pre_scale, false, my_c + r * D, lane);
    }
    __syncwarp();
    float ql[R][CM], kl[R][CM];
    rows_times_mat<D, CM, R>(my_a, s_proj, PS, lane, ql);
    rows_times_mat<D, CM, R>(my_b, s_proj, PS, lane, kl);
    float mk[R], gden[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      const bool valid = t < seq_len;
      mk[r] = frame_mask(t);
      gden[r] = valid ? gden_row[t] : 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        my_p[r * M + lane + 32 * c] = feature(kl[r][c]) * mk[r];
        if (want_dp) {
          my_q[r * M + lane + 32 * c] =
              valid ? dqlin_rows[size_t(t) * M + lane + 32 * c] : 0.f;
        }
      }
    }
    __syncwarp();
    float gk[R][CM], gv[R][CD];
    rows_times_mat_t<D, CM, R>(my_c, s_kv, KS, lane, gk);  // v1 g_kv^T
    rows_times_mat<M, CD, R>(my_p, s_kv, KS, lane, gv);    // phi(k) g_kv
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const float kpu = feature(kl[r][c]);
        const float gkp = gk[r][c] * 0.1f + gden[r] * feature(ql[r][c]);
        const bool pass = kl[r][c] >= -15.f && kl[r][c] <= 15.f;
        my_k[r * M + lane + 32 * c] = pass ? gkp * mk[r] * kpu : 0.f;
      }
    }
    __syncwarp();
    float gk2[R][CD];  // dklin proj^T
    rows_times_mat_t<M, CD, R>(my_k, s_proj, PS, lane, gk2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + warp * R + r;
      if (t >= seq_len) continue;
      float z[CD], y[CD], g1[CD], g0[CD];
      ln_recompute<T, CD>(k_base + size_t(t) * row_stride, sk[r], gS, bS,
                          pre_scale, lane, z, y);
      l2_bwd_row<CD>(gk2[r], y, sk[r], g1);
      layer_norm_bwd_row<CD>(g1, z, gS, sk[r].inv, g0, ds_acc, dc_acc);
      T* dst = dk_base + size_t(t) * row_stride;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[lane + 32 * c] = from_f32<T>(g0[c] * pre_scale);
      }
      ln_recompute<T, CD>(v_base + size_t(t) * row_stride, sv[r], gS, bS,
                          pre_scale, lane, z, y);
#pragma unroll
      for (int c = 0; c < CD; ++c) g1[c] = gv[r][c] * 0.1f;
      layer_norm_bwd_row<CD>(g1, z, gS, sv[r].inv, g0, ds_acc, dc_acc);
      dst = dv_base + size_t(t) * row_stride;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dst[lane + 32 * c] = from_f32<T>(g0[c] * pre_scale);
      }
    }
    if (want_dp) {  // the same for the whole block
      __syncthreads();
      for (int tt = 0; tt < kBwdTile; ++tt) {  // q2^T dqlin + k2^T dklin
        float a[DI], bk[DI], gqv[MJ], gkv[MJ];
        load_vec<DI>(t_a + tt * D + ig * DI, a);
        load_vec<DI>(t_b + tt * D + ig * DI, bk);
        load_vec<MJ>(t_q + tt * M + jg * MJ, gqv);
        load_vec<MJ>(t_k + tt * M + jg * MJ, gkv);
#pragma unroll
        for (int i = 0; i < DI; ++i) {
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            dp[i][j] = fmaf(a[i], gqv[j], dp[i][j]);
            dp[i][j] = fmaf(bk[i], gkv[j], dp[i][j]);
          }
        }
      }
      __syncthreads();
    } else {
      __syncwarp();
    }
  }

  // ---- per-block partial sums -------------------------------------------
  __syncthreads();
  float* red = t_a;  // [2][kBwdWarps][D]
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
    ds_part[size_t(bh) * D + d] = s1;
    dc_part[size_t(bh) * D + d] = s2;
  }
  if (want_dp) {
#pragma unroll
    for (int i = 0; i < DI; ++i) {
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        dp_part[(size_t(bh) * D + ig * DI + i) * M + jg * MJ + j] = dp[i][j];
      }
    }
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
                                int head_dim, int num_features, bool want_dp) {
  const size_t bh = size_t(batch) * num_heads;
  size_t n = bh * seq_len + 2 * bh * head_dim;  // g_den, ds and dc partials
  if (want_dp) n += bh * seq_len * num_features + bh * head_dim * num_features;
  return n;
}

template <typename T, int D, int M>
cudaError_t launch_favor_qkv_bwd(const void* qkv, const void* ln_scale,
                                 const void* ln_bias, const void* proj,
                                 const void* mask, const void* g, void* dqkv,
                                 void* d_scale, void* d_bias, void* d_proj,
                                 void* scratch, int batch, int seq_len,
                                 int num_heads, float eps, float pre_scale,
                                 cudaStream_t stream) {
  constexpr size_t smem = favor_bwd_smem_bytes<D, M>();
  auto kernel = favor_qkv_bwd_kernel<T, D, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const bool want_dp = d_proj != nullptr;
  const int bh = batch * num_heads;
  float* gden = static_cast<float*>(scratch);
  float* ds_part = gden + size_t(bh) * seq_len;
  float* dc_part = ds_part + size_t(bh) * D;
  float* dqlin = want_dp ? dc_part + size_t(bh) * D : nullptr;
  float* dp_part = want_dp ? dqlin + size_t(bh) * seq_len * M : nullptr;
  kernel<<<bh, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(proj),
      static_cast<const float*>(mask), static_cast<const T*>(g),
      static_cast<T*>(dqkv), gden, dqlin, ds_part, dc_part, dp_part, seq_len,
      num_heads, eps, pre_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_partials(ds_part, static_cast<float*>(d_scale), bh, D, stream);
  if (err != cudaSuccess) return err;
  err = sum_partials(dc_part, static_cast<float*>(d_bias), bh, D, stream);
  if (err != cudaSuccess || !want_dp) return err;
  return sum_partials(dp_part, static_cast<float*>(d_proj), bh, D * M, stream);
}

}  // namespace
}  // namespace mdm

// Floats of scratch mdm_favor_qkv_bwd needs (the caller allocates it).
extern "C" long long mdm_favor_qkv_bwd_scratch_floats(int batch, int seq_len,
                                                      int num_heads,
                                                      int head_dim,
                                                      int num_features,
                                                      int want_dproj) {
  return static_cast<long long>(mdm::favor_bwd_scratch_floats(
      batch, seq_len, num_heads, head_dim, num_features, want_dproj != 0));
}

// C entry for ctypes. qkv/dqkv: [B, T, 3*H*D] and g: [B, T, H*D], contiguous,
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); ln_scale, ln_bias,
// d_scale, d_bias: [D] f32; proj, d_proj: [D, M] f32, d_proj null when
// d(proj) is not wanted; mask: [B, T] f32 or null; scratch: f32, of
// mdm_favor_qkv_bwd_scratch_floats. Returns the CUDA error code of the
// launches (0 on success); (head_dim, num_features) pairs other than the
// instantiated ones return cudaErrorInvalidValue.
extern "C" int mdm_favor_qkv_bwd(const void* qkv, const void* ln_scale,
                                 const void* ln_bias, const void* proj,
                                 const void* mask, const void* g, void* dqkv,
                                 void* d_scale, void* d_bias, void* d_proj,
                                 void* scratch, int batch, int seq_len,
                                 int num_heads, int head_dim, int num_features,
                                 int is_bf16, float eps, float pre_scale,
                                 void* stream) {
  using mdm::launch_favor_qkv_bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_FAVOR_BWD_CASE(D_, M_)                                            \
  if (head_dim == D_ && num_features == M_) {                                 \
    return int(is_bf16                                                        \
                   ? launch_favor_qkv_bwd<__nv_bfloat16, D_, M_>(             \
                         qkv, ln_scale, ln_bias, proj, mask, g, dqkv,         \
                         d_scale, d_bias, d_proj, scratch, batch, seq_len,    \
                         num_heads, eps, pre_scale, s)                        \
                   : launch_favor_qkv_bwd<float, D_, M_>(                     \
                         qkv, ln_scale, ln_bias, proj, mask, g, dqkv,         \
                         d_scale, d_bias, d_proj, scratch, batch, seq_len,    \
                         num_heads, eps, pre_scale, s));                      \
  }
  MDM_FAVOR_BWD_CASE(64, 128)
  MDM_FAVOR_BWD_CASE(96, 128)
  MDM_FAVOR_BWD_CASE(128, 128)
#undef MDM_FAVOR_BWD_CASE
  return int(cudaErrorInvalidValue);
}
