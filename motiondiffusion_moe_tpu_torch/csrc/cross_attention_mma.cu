// Exact softmax cross-attention of bf16 inputs on the tensor cores,
// hand-written for Hopper.
//
// Replaces, for bf16 inputs, two Pallas TPU kernels that compute the same
// function in two layouts:
//   motiondiffusion_moe_tpu/ops/flash_attention.py::_xattn_fast_kernel
//     (xattn_fastlayout): q [B, T, H*D], k, v [B, N, H*D], heads as column
//     slices;
//   motiondiffusion_moe_tpu/ops/flash_attention.py::_flash_kernel
//     (flash_cross_attention): q [B*H, T, D], k, v [B*H, N, D].
// One kernel template serves both through a layout of strides (AttnLayout),
// as csrc/favor_qkv.cu's FavorLayout serves kernels 1, 8 and 10. Per (batch
// row, head), no mask, any N:
//
//   s   = (q . k^T) * scale              bf16 products, f32 sums, then scale
//   p   = exp(s - m), online over blocks of 32 keys (running max m, sum l)
//   out = (p_hi . v + p_lo . v) / l      rounded once to bf16
//
// What bounds it on the card: memory. At the flagship (B = 32, T = 196,
// N = 85, H = 4, D = 128) the 18.4 MB of bf16 inputs and output take 5.5 us
// at 3.35 TB/s; the 1.09 GFLOP take 1.1 us on the bf16 tensor cores. The
// IEEE f32 FMA designs of the f32 paths (xattn_fastlayout.cu,
// flash_cross_attention.cu) cannot go below 16.3 us at 67 TFLOP/s.
//
// Accuracy: the products q . k of bf16 values are exact in the f32
// accumulators, with the scale applied after the sum, as a score of the
// plain version is (q * scale) . k in f32. The probabilities are not rounded
// to bf16 (scaled_dot_product_attention rounds them, and lands up to ~40
// ulps from the f32 result): p is split into p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), and both terms go through the tensor cores, so p
// keeps ~16 bits and out ~1e-5 of relative accuracy before its one
// rounding, far below bf16's half-ulp of 2^-9. exp2f of log2(e)-scaled
// scores and one reciprocal of the row sum stay within a few f32 ulps.
//
// Design: one CTA of 4 warps per (batch row, head, 128 query rows): 256 CTAs
// at the flagship, two per SM, one wave. Each warp owns 32 rows as two
// mma.sync m16n8k16 row tiles, so that every k and v fragment read from
// shared memory feeds both (up to D = 128; at D = 256 the two tiles'
// accumulators, 2 x 32 n-tiles x 4 floats a thread, would not fit in the
// registers, so each warp owns one 16-row tile, 128 floats a thread, and a
// CTA 64 query rows: AmShape); q stays in shared memory and its A fragments are
// read with ldmatrix at each k-step (measured faster on the H100 than
// holding them in registers, which costs two CTAs' worth of registers). k
// and v stream through shared memory in blocks of 32 keys with cp.async,
// double-buffered, so the copy of block j + 1 overlaps the products of
// block j; n-tiles past N take no products and are masked with -inf; rows
// are padded by 16 bytes so that the 8 row addresses of every ldmatrix hit
// distinct banks; k is read with ldmatrix, v with ldmatrix.trans. The score
// accumulators become the A fragments of p . v in registers: scores and
// probabilities never touch shared or device memory. The output goes
// through the warp's own rows of the q tile to 16-byte stores.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace mdm {
namespace {

constexpr int kAmWarps = 4;
constexpr int kAmThreads = kAmWarps * 32;
constexpr int kAmKeys = 32;                     // keys per block
constexpr int kAmStages = 2;                    // key blocks in flight
constexpr int kAmPad = 8;                       // bf16 padding of a smem row

// The query rows of a warp and of a CTA at head dim D: two 16-row tiles a
// warp up to D = 128, one at D = 256, where the output accumulator of a
// thread (kTiles x D/8 n-tiles x 4 floats) would otherwise be 256 floats.
template <int D>
struct AmShape {
  static constexpr int kTiles = D <= 128 ? 2 : 1;  // 16-row tiles per warp
  static constexpr int kWarpRows = 16 * kTiles;
  static constexpr int kRows = kWarpRows * kAmWarps;  // query rows per CTA
};

// Element strides of one launch: q and out share theirs, k and v theirs.
// The (batch row, head) of a CTA starts at batch * b + head * h; rows are
// row apart. l_floor > 0 bounds the softmax denominator from below.
struct AttnLayout {
  long long q_b, q_h, q_row;
  long long kv_b, kv_h, kv_row;
  int heads;
  float l_floor;
};

// Shared memory: the q tile (AmShape<D>::kRows padded rows of D bf16), then
// k and v,
// kAmStages key blocks each (kAmKeys padded rows).
template <int D>
struct AmSmem {
  static constexpr int kStride = D + kAmPad;
  static constexpr size_t kTile = size_t(AmShape<D>::kRows) * kStride;
  static constexpr size_t kBlock = size_t(kAmKeys) * kStride;
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kTile + 2 * kAmStages * kBlock);
  // two CTAs an SM (__launch_bounds__ below) at every instance: 2 x 101,376
  // bytes at D = 256
  static_assert(kBytes <= 232448, "within an sm_90 block's shared memory");
  static_assert(2 * kBytes <= 233472, "two CTAs within an SM's 228 KB");
};

// Rows [0, valid) of an R-row tile from global memory (rows `row` elements
// apart) into padded shared rows, by cp.async; rows past `valid` are zeros.
// Where the threads split evenly over the 16-byte chunks of a row, each
// thread copies one column chunk of every few rows.
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row, int valid, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = AmSmem<D>::kStride;
  if constexpr (kAmThreads % kChunks == 0) {
    constexpr int kRowStep = kAmThreads / kChunks;
    const int r0 = tid / kChunks, c = (tid % kChunks) * 8;
    __nv_bfloat16* d = dst + r0 * kStride + c;
#pragma unroll
    for (int r = r0; r < R; r += kRowStep, d += kRowStep * kStride) {
      const bool ok = r < valid;
      cp_async16(d, src + (ok ? r : 0) * row + c, ok);
    }
  } else {
    for (int i = tid; i < R * kChunks; i += kAmThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = r < valid;
      cp_async16(dst + r * kStride + c, src + (ok ? r : 0) * row + c, ok);
    }
  }
}

// p (two neighbours along the key axis) -> p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), each packed as one A-fragment register.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

template <int D>
__global__ void __launch_bounds__(kAmThreads, 2) cross_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int seq_len, int num_keys, float scale, AttnLayout lay) {
  using S = AmSmem<D>;
  constexpr int kStride = S::kStride;
  constexpr int kDSteps = D / 16;  // k-steps of q . k^T
  constexpr int kDTiles = D / 8;   // n-tiles of the output
  constexpr int kKeyTiles = kAmKeys / 8;
  constexpr int M = AmShape<D>::kTiles;
  constexpr int kAmWarpRows = AmShape<D>::kWarpRows;
  constexpr int kAmRows = AmShape<D>::kRows;
  extern __shared__ __align__(16) unsigned char am_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(am_smem);
  __nv_bfloat16* ks = qs + S::kTile;
  __nv_bfloat16* vs = ks + kAmStages * S::kBlock;

  const int tiles = (seq_len + kAmRows - 1) / kAmRows;
  const int bh = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * kAmRows;
  const int b = bh / lay.heads, h = bh % lay.heads;
  const long long q_off = b * lay.q_b + h * lay.q_h + t0 * lay.q_row;
  const long long kv_off = b * lay.kv_b + h * lay.kv_h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tq = lane % 4;  // the lane's column pair within a fragment
  const int wr0 = warp * kAmWarpRows;  // the warp's first row in the tile
  const bool active = t0 + wr0 < seq_len;
  const float kNegInf = __int_as_float(0xff800000);
  // scores in log2 units: exp(x * scale - m) = exp2(x * scale2 - m2)
  const float scale2 = scale * 1.4426950408889634f;
  const int blocks = (num_keys + kAmKeys - 1) / kAmKeys;

  // key block j into its stage, as one cp.async group (empty past the end)
  auto load_block = [&](int j) {
    if (j < blocks) {
      const int valid = min(kAmKeys, num_keys - j * kAmKeys);
      const long long off = kv_off + j * kAmKeys * lay.kv_row;
      const size_t st = (j % kAmStages) * S::kBlock;
      load_tile<D, kAmKeys>(ks + st, k + off, lay.kv_row, valid, tid);
      load_tile<D, kAmKeys>(vs + st, v + off, lay.kv_row, valid, tid);
    }
    cp_async_commit();
  };
  // group 0: the q tile and key block 0; groups 1 ..: the next blocks
  load_tile<D, kAmRows>(qs, q + q_off, lay.q_row, min(kAmRows, seq_len - t0),
                        tid);
#pragma unroll
  for (int j = 0; j < kAmStages; ++j) load_block(j);

  float o[M][kDTiles][4];
  // running max (log2 units) and this lane's part of the running sum, of
  // rows g and g + 8 of each row tile
  float m[M][2], l[M][2];
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;
    }
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < blocks; ++j) {
    cp_async_wait<kAmStages - 1>();  // group j landed (later ones may fly)
    __syncthreads();
    const __nv_bfloat16* kt = ks + (j % kAmStages) * S::kBlock;
    const __nv_bfloat16* vt = vs + (j % kAmStages) * S::kBlock;
    // keys of this block before N; tiles past them take no products
    const int valid = min(kAmKeys, num_keys - j * kAmKeys);
    if (active) {
      // scores of the warp's rows against the block's keys
      float s[M][kKeyTiles][4];
#pragma unroll
      for (int mt = 0; mt < M; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
        }
      }
#pragma unroll
      for (int ds = 0; ds < kDSteps; ds += 2) {
        uint32_t qf[M][2][4];
#pragma unroll
        for (int mt = 0; mt < M; ++mt) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            ldmatrix_x4(qf[mt][u], qs + (wr0 + mt * 16 + lane % 16) * kStride +
                                       (ds + u) * 16 + (lane / 16) * 8);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
          if (nt * 8 >= valid) continue;
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + (nt * 8 + lane % 8) * kStride + ds * 16 +
                              (lane / 8) * 8);
#pragma unroll
          for (int mt = 0; mt < M; ++mt) {
            mma_bf16(s[mt][nt], qf[mt][0], kf[0], kf[1]);
            mma_bf16(s[mt][nt], qf[mt][1], kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < M; ++mt) {
        // scale, mask the keys past N, new running max (over the quad)
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live =
                valid == kAmKeys || nt * 8 + 2 * tq + (e & 1) < valid;
            const float x = live ? s[mt][nt][e] * scale2 : kNegInf;
            s[mt][nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[mt][r], mx[r]);
          alpha[r] = exp2f(m[mt][r] - mn);  // 0 on the first block
          m[mt][r] = mn;
          l[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[mt][nt][e] - m[mt][e >> 1]);
            s[mt][nt][e] = p;
            l[mt][e >> 1] += p;
          }
        }
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          o[mt][dt][0] *= alpha[0];
          o[mt][dt][1] *= alpha[0];
          o[mt][dt][2] *= alpha[1];
          o[mt][dt][3] *= alpha[1];
        }
      }
      // out += p_hi . v + p_lo . v, 16 keys at a time
#pragma unroll
      for (int kk = 0; kk < kAmKeys / 16; ++kk) {
        if (kk * 16 >= valid) continue;
        uint32_t ph[M][4], pl[M][4];
#pragma unroll
        for (int mt = 0; mt < M; ++mt) {
          const float(&s0)[4] = s[mt][2 * kk];
          const float(&s1)[4] = s[mt][2 * kk + 1];
          split_bf16(s0[0], s0[1], ph[mt][0], pl[mt][0]);
          split_bf16(s0[2], s0[3], ph[mt][1], pl[mt][1]);
          split_bf16(s1[0], s1[1], ph[mt][2], pl[mt][2]);
          split_bf16(s1[2], s1[3], ph[mt][3], pl[mt][3]);
        }
#pragma unroll
        for (int dt = 0; dt < kDTiles; dt += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + (kk * 16 + lane % 16) * kStride +
                                    dt * 8 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < M; ++mt) {
            mma_bf16(o[mt][dt], ph[mt], vf[0], vf[1]);
            mma_bf16(o[mt][dt], pl[mt], vf[0], vf[1]);
            mma_bf16(o[mt][dt + 1], ph[mt], vf[2], vf[3]);
            mma_bf16(o[mt][dt + 1], pl[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    load_block(j + kAmStages);
  }
  if (!active) return;  // no block barrier follows

  // epilogue: the row sums over the quad, one reciprocal, one rounding; the
  // warp's rows of the q tile (read for the last time in the last block)
  // stage the output for 16-byte stores
  const int g = lane / 4;
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[mt][r] + __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[r] = __frcp_rn(lay.l_floor > 0.f ? fmaxf(lt, lay.l_floor) : lt);
    }
    __nv_bfloat16* ow = qs + (wr0 + mt * 16) * kStride;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const int c = dt * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(ow + g * kStride + c) =
          pack_bf16(o[mt][dt][0] * inv[0], o[mt][dt][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * kStride + c) =
          pack_bf16(o[mt][dt][2] * inv[1], o[mt][dt][3] * inv[1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int i = lane; i < kAmWarpRows * kChunks; i += 32) {
    const int row = wr0 + i / kChunks, c = (i % kChunks) * 8;
    if (t0 + row < seq_len) {
      *reinterpret_cast<uint4*>(out + q_off + row * lay.q_row + c) =
          *reinterpret_cast<const uint4*>(qs + row * kStride + c);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int batch_heads, int seq_len, int num_keys,
                       float scale, const AttnLayout& lay,
                       cudaStream_t stream) {
  const size_t smem = AmSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  constexpr int kRows = AmShape<D>::kRows;
  const int tiles = (seq_len + kRows - 1) / kRows;
  cross_attention_mma_kernel<D><<<batch_heads * tiles, kAmThreads, smem,
                                  stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      seq_len, num_keys, scale, lay);
  return cudaGetLastError();
}

cudaError_t launch_for_head_dim(int head_dim, const void* q, const void* k,
                                const void* v, void* out, int batch_heads,
                                int seq_len, int num_keys, float scale,
                                const AttnLayout& lay, cudaStream_t stream) {
  if (batch_heads <= 0 || seq_len <= 0 || num_keys <= 0) {
    return cudaErrorInvalidValue;
  }
  switch (head_dim) {
    case 64:
      return launch_mma<64>(q, k, v, out, batch_heads, seq_len, num_keys,
                            scale, lay, stream);
    case 96:
      return launch_mma<96>(q, k, v, out, batch_heads, seq_len, num_keys,
                            scale, lay, stream);
    case 128:
      return launch_mma<128>(q, k, v, out, batch_heads, seq_len, num_keys,
                             scale, lay, stream);
    case 256:
      return launch_mma<256>(q, k, v, out, batch_heads, seq_len, num_keys,
                             scale, lay, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mdm

// C entries for ctypes; bf16 tensors, contiguous and 16-byte aligned. Each
// returns the CUDA error code of the launch (0 on success); a head dim other
// than 64, 96, 128 or 256 or an empty input returns cudaErrorInvalidValue.
//
// Kernel 6's layout: q, out [B, T, H*D]; k, v [B, N, H*D]; out = p . v / l.
extern "C" int mdm_xattn_fastlayout_bf16(const void* q, const void* k,
                                         const void* v, void* out, int batch,
                                         int seq_len, int num_keys,
                                         int num_heads, int head_dim,
                                         float scale, void* stream) {
  const long long hd = static_cast<long long>(num_heads) * head_dim;
  const mdm::AttnLayout lay{seq_len * hd, head_dim, hd, num_keys * hd,
                            head_dim, hd, num_heads, 0.f};
  return int(mdm::launch_for_head_dim(
      head_dim, q, k, v, out, batch * num_heads, seq_len, num_keys, scale,
      lay, static_cast<cudaStream_t>(stream)));
}

// Kernel 9's layout: q, out [B*H, T, D]; k, v [B*H, N, D];
// out = p . v / max(l, 1e-20), as _flash_kernel divides.
extern "C" int mdm_flash_cross_attention_bf16(const void* q, const void* k,
                                              const void* v, void* out,
                                              int batch_heads, int seq_len,
                                              int num_keys, int head_dim,
                                              float scale, void* stream) {
  const long long d = head_dim;
  const mdm::AttnLayout lay{seq_len * d, 0, d, num_keys * d, 0, d, 1, 1e-20f};
  return int(mdm::launch_for_head_dim(
      head_dim, q, k, v, out, batch_heads, seq_len, num_keys, scale, lay,
      static_cast<cudaStream_t>(stream)));
}
