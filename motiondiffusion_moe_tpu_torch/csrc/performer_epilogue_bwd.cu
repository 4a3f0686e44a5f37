// Backward of the fused Performer epilogue, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/performer_pallas_bwd.py::_epilogue_bwd_kernel
// (public entry epilogue_bwd_pallas): for the forward of
// performer_epilogue.cu,
//
//   h1 = LN(y; post) -> h2 = h1 / max(|h1|, 1e-12) * sqrt(D)
//   -> h3 = LN(h2; style) -> h4 = h3 * (1 + scale[b]) + shift[b] -> SiLU,
//
// it recomputes the chain per row from y and returns dy, the per-batch-row
// d(scale) and d(shift), and the gradients of the four LayerNorm vectors.
// Gradient conventions follow performer_pallas_bwd.py:20-28 (the L2 max()
// passes gradient iff |h1| >= 1e-12).
//
// What bounds it on the card: device-memory bandwidth by the count of
// bytes: y and g read, dy written (6 bytes per element in bf16) against
// ~50 f32 operations and one exp per element. At the flagship (B = 32,
// T = 196, D = 512, bf16) that is 19.3 MB, 5.8 us at 3.35 TB/s. Its
// instruction count comes close, though, so the design keeps the work per
// row down: no parameter is read per row, and the sums a lane keeps are
// four, not six.
//
// Design. One warp per row; lane l holds the columns 256j + 8l .. +7
// (j < D/256), so that every load and store of y, g and dy is 16 bytes a
// lane. The ceil(T/C) rows of one batch row b and one chunk go to a block of
// 8 warps, and the C chunk blocks of b form a thread-block cluster; C is the
// largest cluster size (up to 8, at most T) for which all B clusters are
// resident on the card at once (cudaOccupancyMaxActiveClusters): 3 at the
// flagship on an H100 (96 blocks, one wave at one block per SM; 32
// clusters of 4 do not fit at once).
//   - Each lane holds its columns of the parameters in registers for all
//     its rows: the post LayerNorm's scale and bias, and the style
//     LayerNorm folded into the modulation (every row of a block shares
//     scale[b] and shift[b]): h4 = z3 ma + mb, ma = ss (1 + scale[b]),
//     mb = sb (1 + scale[b]) + shift[b].
//   - For the same reason the six parameter gradients of a block follow
//     from four per-column sums over its rows, sum dh4 z3, sum dh4,
//     sum d(h1) z1 and sum d(h1) (64 registers a lane at D = 512): d(scale)
//     = ss sum dh4 z3 + sb sum dh4, d(shift) = sum dh4, d(style_scale) =
//     (1 + scale[b]) sum dh4 z3, d(style_bias) = (1 + scale[b]) sum dh4.
//     The row itself lives in three arrays (z1, z3, the running gradient);
//     h1 is recomputed from z1 where needed, so nothing spills at
//     D = 512. At D = 1024 the same design holds more values than a
//     thread's 255 registers, and ptxas puts the rest in local memory: a
//     simple first version of that width. In bf16 up to D = 512 the next
//     row's y and g are loaded while this one is computed. The sigmoid
//     takes the fast exp and divide (a few f32 ulps).
//   - The block adds its warps' sums in warp order in shared memory and
//     forms the six partials. The cluster then adds its blocks' partials in
//     rank order through distributed shared memory, each rank a slice:
//     d(scale) and d(shift) of b are written from there, and the four
//     LayerNorm gradients of b go to a per-batch-row partial [B][4][D] in
//     device memory.
//   - A second kernel adds those B partials for each of the 4D outputs, 8
//     threads an output (each a fixed range of batch rows, in order, then
//     the 8 sums in order).
// No atomics: every sum has one fixed order, the same bits on every call.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kEbThreads = 256;
constexpr int kEbWarps = kEbThreads / 32;
constexpr int kEbParts = 6;   // dscale, dshift, dpost_s, dpost_b, dstyle_s,
                              // dstyle_b
constexpr int kEbAcc = 4;     // per-column sums a lane keeps over its rows
constexpr int kEbSplit = 8;   // second pass: threads per output
constexpr int kEbMaxCluster = 8;

// Shared memory, in floats: the warps' sums [8][4][D] and the block's six
// partials [6][D].
constexpr size_t eb_smem_bytes(int D) {
  return sizeof(float) * size_t(D) * (kEbWarps * kEbAcc + kEbParts);
}

// 8 consecutive values of T as raw 16-byte words, loaded ahead of use.
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < int(sizeof(T)) / 2; ++i) {
    r.u[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  return r;
}

__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r,
                                        float (&v)[8]) {
  unpack_bf16x8(r.u[0], v);
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(r.u[i].x);
    v[4 * i + 1] = __uint_as_float(r.u[i].y);
    v[4 * i + 2] = __uint_as_float(r.u[i].z);
    v[4 * i + 3] = __uint_as_float(r.u[i].w);
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kEbThreads, 1) performer_epilogue_bwd_kernel(
    const T* __restrict__ y, const T* __restrict__ scale,
    const T* __restrict__ shift, const float* __restrict__ post_scale,
    const float* __restrict__ post_bias, const float* __restrict__ style_scale,
    const float* __restrict__ style_bias, const T* __restrict__ g,
    T* __restrict__ dy, T* __restrict__ dscale, T* __restrict__ dshift,
    float* __restrict__ ln_part, int seq_len) {
  constexpr int D = V * 32;
  constexpr int G = V / 8;  // 8-column groups of a lane
  static_assert(V % 8 == 0, "D a multiple of 256");
  // the next row's y and g in flight beside this row's, where the
  // registers allow it (bf16 up to D = 512)
  constexpr bool kPrefetch = sizeof(T) * V <= 32;
  constexpr float kInvD = 1.0f / float(D);
  extern __shared__ __align__(16) float eb_smem[];
  float* red = eb_smem;                      // [8 warps][kEbAcc][D]
  float* part = red + kEbWarps * kEbAcc * D;  // [kEbParts][D]

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float sqrt_d = sqrtf(float(D));
  const int per = (seq_len + C - 1) / C;
  const int t0 = rank * per, t1 = min(seq_len, t0 + per);

  // this lane's columns of the parameters, in registers for all rows:
  // the post LayerNorm's, and the style LayerNorm folded into the
  // modulation, h4 = z3 ma + mb with ma = ss (1 + scale[b]) and
  // mb = sb (1 + scale[b]) + shift[b]
  float ps[V], pb[V], ma[V], mb[V];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int v = 8 * j + e, c = 256 * j + 8 * lane + e;
      const float s1 = 1.f + to_f32(scale[size_t(b) * D + c]);
      ps[v] = post_scale[c];
      pb[v] = post_bias[c];
      ma[v] = style_scale[c] * s1;
      mb[v] = style_bias[c] * s1 + to_f32(shift[size_t(b) * D + c]);
    }
  }

  // per column, over this warp's rows: sum dh4 z3, sum dh4, and the post
  // LayerNorm's sum d(h1) z1 and sum d(h1); the six parameter gradients
  // follow from them, as every row of the block shares scale[b] and
  // shift[b]
  float acc[kEbAcc][V];
#pragma unroll
  for (int q = 0; q < kEbAcc; ++q) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[q][v] = 0.f;
  }

  Raw8<T> yn[G], gn[G];
  auto load_row = [&](int t) {
    const size_t o = (size_t(b) * seq_len + t) * D + 8 * lane;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      yn[j] = load8(y + o + 256 * j);
      gn[j] = load8(g + o + 256 * j);
    }
  };
  if (kPrefetch && t0 + warp < t1) load_row(t0 + warp);
  for (int t = t0 + warp; t < t1; t += kEbWarps) {
    if (!kPrefetch) load_row(t);
    float z1[V], z3[V], dh[V];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float a[8], c[8];
      unpack8(yn[j], a);
      unpack8(gn[j], c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        z1[8 * j + e] = a[e];
        dh[8 * j + e] = c[e];
      }
    }
    if (kPrefetch && t + kEbWarps < t1) load_row(t + kEbWarps);

    // the forward: z1, the L2 norm of h1 = z1 ps + pb, z3
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) s += z1[v];
    const float mu1 = warp_sum(s) * kInvD;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = z1[v] - mu1;
      var = fmaf(d, d, var);
    }
    const float i1 = 1.0f / sqrtf(warp_sum(var) * kInvD + kLnEps);
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      z1[v] = (z1[v] - mu1) * i1;
      const float h1 = z1[v] * ps[v] + pb[v];
      sq = fmaf(h1, h1, sq);
    }
    const float n = sqrtf(warp_sum(sq));
    const float mx = fmaxf(n, 1e-12f);
    const float rmx = sqrt_d / mx;  // h2 = h1 rmx
    s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      z3[v] = (z1[v] * ps[v] + pb[v]) * rmx;
      s += z3[v];
    }
    const float mu3 = warp_sum(s) * kInvD;
    var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = z3[v] - mu3;
      var = fmaf(d, d, var);
    }
    const float i3 = 1.0f / sqrtf(warp_sum(var) * kInvD + kLnEps);

    // SiLU and modulation backward: dh holds g, then ss d(h3) = dh4 ma
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      z3[v] = (z3[v] - mu3) * i3;
      const float h4 = z3[v] * ma[v] + mb[v];
      // the sigmoid by the fast exp and divide: a few f32 ulps
      const float sig = __fdividef(1.f, 1.f + __expf(-h4));
      const float dh4 = dh[v] * sig * (1.f + h4 * (1.f - sig));
      acc[0][v] = fmaf(dh4, z3[v], acc[0][v]);
      acc[1][v] += dh4;
      dh[v] = dh4 * ma[v];
      a1 += dh[v];
      a2 = fmaf(dh[v], z3[v], a2);
    }
    a1 = warp_sum(a1) * kInvD;
    a2 = warp_sum(a2) * kInvD;
    // the style LayerNorm backward: dh becomes d(h2)
    float t_dot = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      dh[v] = i3 * (dh[v] - a1 - z3[v] * a2);
      t_dot = fmaf(dh[v], z1[v] * ps[v] + pb[v], t_dot);
    }
    t_dot = warp_sum(t_dot);
    // the L2 backward (dh becomes d(h1)), then the post LayerNorm backward
    const float inv_n = n > 0.f ? 1.f / n : 0.f;
    const float live = n >= 1e-12f ? 1.f : 0.f;
    const float kl2 = sqrt_d * t_dot / (mx * mx) * live * inv_n;
    a1 = 0.f;
    a2 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      dh[v] = dh[v] * rmx - (z1[v] * ps[v] + pb[v]) * kl2;
      acc[2][v] = fmaf(dh[v], z1[v], acc[2][v]);  // d(post_scale)
      acc[3][v] += dh[v];                         // d(post_bias)
      const float sg = ps[v] * dh[v];
      a1 += sg;
      a2 = fmaf(sg, z1[v], a2);
    }
    a1 = warp_sum(a1) * kInvD;
    a2 = warp_sum(a2) * kInvD;
    const size_t o = (size_t(b) * seq_len + t) * D + 8 * lane;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int v = 8 * j + e;
        out[e] = i1 * (ps[v] * dh[v] - a1 - z1[v] * a2);
      }
      store8(dy + o + 256 * j, out);
    }
  }

  // the block's sums: the warps' in warp order, then the six partials
  // d(scale) = ss sum dh4 z3 + sb sum dh4 (h3 = z3 ss + sb), d(shift) =
  // sum dh4, d(post_scale), d(post_bias), d(style_scale) = (1 + scale[b])
  // sum dh4 z3 and d(style_bias) = (1 + scale[b]) sum dh4
#pragma unroll
  for (int q = 0; q < kEbAcc; ++q) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = acc[q][8 * j + e];
      store8(red + (warp * kEbAcc + q) * D + 256 * j + 8 * lane, a);
    }
  }
  __syncthreads();
  for (int i = tid; i < D; i += kEbThreads) {
    float sum[kEbAcc];
#pragma unroll
    for (int q = 0; q < kEbAcc; ++q) {
      sum[q] = 0.f;
#pragma unroll
      for (int w = 0; w < kEbWarps; ++w) {
        sum[q] += red[(w * kEbAcc + q) * D + i];
      }
    }
    const float s1 = 1.f + to_f32(scale[size_t(b) * D + i]);
    part[i] = style_scale[i] * sum[0] + style_bias[i] * sum[1];
    part[D + i] = sum[1];
    part[2 * D + i] = sum[2];
    part[3 * D + i] = sum[3];
    part[4 * D + i] = s1 * sum[0];
    part[5 * D + i] = s1 * sum[1];
  }
  // the cluster's: rank r sums its slice of the 6D values over the ranks
  // in rank order
  cluster.sync();
  constexpr int n4 = kEbParts * D / 4;
  for (int i = rank * n4 / C + tid; i < (rank + 1) * n4 / C;
       i += kEbThreads) {
    float4 p[kEbMaxCluster];  // every rank's partial in flight at once
#pragma unroll
    for (int q = 0; q < kEbMaxCluster; ++q) {
      if (q < C) {
        p[q] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q))[i];
      }
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kEbMaxCluster; ++q) {
      if (q < C) {
        s.x += p[q].x;
        s.y += p[q].y;
        s.z += p[q].z;
        s.w += p[q].w;
      }
    }
    const int which = 4 * i / D, d = 4 * i % D;
    if (which < 2) {
      store4((which == 0 ? dscale : dshift) + size_t(b) * D + d, s);
    } else {
      store4(ln_part + (size_t(b) * 4 + which - 2) * D + d, s);
    }
  }
  cluster.sync();  // no block reads another's shared memory after this
}

// Second pass: each of the 4D LayerNorm gradients sums the B per-batch-row
// partials, kEbSplit threads an output: thread s sums batch rows
// [s B / 8, (s + 1) B / 8) in order, then the 8 sums are added in order.
__global__ void __launch_bounds__(32 * kEbSplit) epilogue_bwd_reduce_kernel(
    const float* __restrict__ ln_part, float* __restrict__ dps,
    float* __restrict__ dpb, float* __restrict__ dss,
    float* __restrict__ dsb, int batch, int dim) {
  __shared__ float red[kEbSplit][32];
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;  // of 4 * dim
  const int which = col / dim, d = col % dim;
  float acc = 0.f;
  for (int b = s * batch / kEbSplit; b < (s + 1) * batch / kEbSplit; ++b) {
    acc += ln_part[(size_t(b) * 4 + which) * dim + d];
  }
  red[s][lane] = acc;
  __syncthreads();
  if (s != 0) return;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kEbSplit; ++k) sum += red[k][lane];
  float* dst[4] = {dps, dpb, dss, dsb};
  dst[which][d] = sum;
}

// The cluster size: the largest C <= min(8, T) for which all `batch`
// clusters of C blocks are resident at once; 1 where none is.
template <typename T, int V>
cudaError_t epilogue_bwd_cluster(int batch, int seq_len, int* out) {
  auto kernel = &performer_epilogue_bwd_kernel<T, V>;
  const size_t smem = eb_smem_bytes(V * 32);
  static int fits[kEbMaxCluster + 1] = {0};  // clusters resident, per C
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  *out = 1;
  for (int c = std::min(kEbMaxCluster, seq_len); c > 1; --c) {
    if (fits[c] == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(unsigned(c), 1);
      cfg.blockDim = dim3(kEbThreads);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = unsigned(c);
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return err;
      fits[c] = n > 0 ? n : -1;
    }
    if (fits[c] >= batch) {
      *out = c;
      break;
    }
  }
  return cudaSuccess;
}

template <typename T, int V>
cudaError_t launch_epilogue_bwd(const void* y, const void* scale,
                                const void* shift, const void* post_scale,
                                const void* post_bias, const void* style_scale,
                                const void* style_bias, const void* g,
                                void* dy, void* dscale, void* dshift,
                                void* dps, void* dpb, void* dss, void* dsb,
                                void* scratch, int batch, int seq_len,
                                cudaStream_t stream) {
  constexpr int D = V * 32;
  int c = 1;
  cudaError_t err = epilogue_bwd_cluster<T, V>(batch, seq_len, &c);
  if (err != cudaSuccess) return err;
  float* ln_part = static_cast<float*>(scratch);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(c), unsigned(batch));
  cfg.blockDim = dim3(kEbThreads);
  cfg.dynamicSmemBytes = eb_smem_bytes(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, performer_epilogue_bwd_kernel<T, V>, static_cast<const T*>(y),
      static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<const float*>(post_scale),
      static_cast<const float*>(post_bias),
      static_cast<const float*>(style_scale),
      static_cast<const float*>(style_bias), static_cast<const T*>(g),
      static_cast<T*>(dy), static_cast<T*>(dscale), static_cast<T*>(dshift),
      ln_part, seq_len);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  epilogue_bwd_reduce_kernel<<<4 * D / 32, 32 * kEbSplit, 0, stream>>>(
      ln_part, static_cast<float*>(dps), static_cast<float*>(dpb),
      static_cast<float*>(dss), static_cast<float*>(dsb), batch, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdm

// Floats of scratch mdm_performer_epilogue_bwd needs (the caller allocates
// it): the per-batch-row partials of the four LayerNorm gradients.
extern "C" long long mdm_performer_epilogue_bwd_scratch_floats(int batch,
                                                               int seq_len,
                                                               int dim) {
  (void)seq_len;
  return static_cast<long long>(batch) * 4 * dim;
}

#define MDM_EPILOGUE_BWD_DISPATCH(D_, CALL)                           \
  if (dim == D_) {                                                    \
    return int(is_bf16 ? CALL(__nv_bfloat16, D_ / 32)                 \
                       : CALL(float, D_ / 32));                       \
  }

// The thread-block cluster size (blocks per batch row) that
// mdm_performer_epilogue_bwd launches for these shapes and dtype, in
// *cluster; returns the CUDA error code (0 on success).
extern "C" int mdm_performer_epilogue_bwd_cluster(int batch, int seq_len,
                                                  int dim, int is_bf16,
                                                  int* cluster) {
  if (batch <= 0 || seq_len <= 0) return int(cudaErrorInvalidValue);
#define MDM_CLUSTER_CALL(T_, V_) \
  mdm::epilogue_bwd_cluster<T_, V_>(batch, seq_len, cluster)
  MDM_EPILOGUE_BWD_DISPATCH(256, MDM_CLUSTER_CALL)
  MDM_EPILOGUE_BWD_DISPATCH(512, MDM_CLUSTER_CALL)
  MDM_EPILOGUE_BWD_DISPATCH(768, MDM_CLUSTER_CALL)
  MDM_EPILOGUE_BWD_DISPATCH(1024, MDM_CLUSTER_CALL)
#undef MDM_CLUSTER_CALL
  return int(cudaErrorInvalidValue);
}

// C entry for ctypes. y, g, dy: [B, T, D] contiguous; scale, shift, dscale,
// dshift: [B, D]; all in one dtype, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// The four LayerNorm vectors and their gradients: [D] f32. scratch: f32, of
// mdm_performer_epilogue_bwd_scratch_floats. All 16-byte aligned. Returns
// the CUDA error code of the launches (0 on success); widths other than the
// instantiated ones return cudaErrorInvalidValue.
extern "C" int mdm_performer_epilogue_bwd(
    const void* y, const void* scale, const void* shift,
    const void* post_scale, const void* post_bias, const void* style_scale,
    const void* style_bias, const void* g, void* dy, void* dscale,
    void* dshift, void* dps, void* dpb, void* dss, void* dsb, void* scratch,
    int batch, int seq_len, int dim, int is_bf16, void* stream) {
  if (batch <= 0 || seq_len <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDM_LAUNCH_CALL(T_, V_)                                          \
  mdm::launch_epilogue_bwd<T_, V_>(y, scale, shift, post_scale, post_bias, \
                                   style_scale, style_bias, g, dy, dscale, \
                                   dshift, dps, dpb, dss, dsb, scratch,    \
                                   batch, seq_len, s)
  MDM_EPILOGUE_BWD_DISPATCH(256, MDM_LAUNCH_CALL)
  MDM_EPILOGUE_BWD_DISPATCH(512, MDM_LAUNCH_CALL)
  MDM_EPILOGUE_BWD_DISPATCH(768, MDM_LAUNCH_CALL)
  MDM_EPILOGUE_BWD_DISPATCH(1024, MDM_LAUNCH_CALL)
#undef MDM_LAUNCH_CALL
  return int(cudaErrorInvalidValue);
}
#undef MDM_EPILOGUE_BWD_DISPATCH
