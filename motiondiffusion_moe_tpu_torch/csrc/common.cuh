// Small device helpers shared by the hand-written Hopper kernels.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mdm {

// LayerNorm epsilon of the JAX reference (flax.linen.LayerNorm default).
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round-to-nearest-even, the rounding of torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load N consecutive floats from shared memory with one vector access where
// the width allows it (a 16-byte access per lane is conflict-free across a
// warp); `p` must be aligned to the vector width.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// ---- bf16 tensor-core products (mma.sync m16n8k16), shared by the kernels
// that stage a bf16 operand in shared memory as 32-bit words, each holding
// two neighbours along the contracted axis (the lower k in the low half).

// Two rows of 4 bf16 each (lo: row k, hi: row k + 1, columns n .. n+3) ->
// the 4 words {row k, row k + 1} of columns n .. n+3.
__device__ __forceinline__ uint4 interleave_rows(uint2 lo, uint2 hi) {
  return make_uint4(__byte_perm(lo.x, hi.x, 0x5410),
                    __byte_perm(lo.x, hi.x, 0x7632),
                    __byte_perm(lo.y, hi.y, 0x5410),
                    __byte_perm(lo.y, hi.y, 0x7632));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 bf16 (16 bytes) <-> 8 f32, for kernels that load and store rows 16 bytes
// a lane.
__device__ __forceinline__ void unpack_bf16x8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// D (16x8, f32) += A (16x16, bf16, row-major) . B (16x8, bf16, col-major).
// a[0..3]: rows g / g+8, k 2t..2t+1 and 2t+8..2t+9; b0 / b1: k 2t..2t+1 and
// 2t+8..2t+9 of column g; c: rows g / g+8, columns 2t..2t+1 (g = lane / 4,
// t = lane % 4). Each 32-bit register holds the lower k in its low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- asynchronous copies and ldmatrix, for the kernels that stage bf16
// tiles row-major in shared memory (cross_attention_mma.cu,
// moe_dense_fused.cu)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and r[i] holds row lane / 4, columns 2 (lane % 4) and + 1 of
// it (with .trans: column lane / 4, rows 2 (lane % 4) and + 1), the lower
// column (row) in the low half.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// ---- bf16 tiles streamed through shared memory and multiplied there, the
// routine of the fused MoE chain (moe_dense_fused.cu) and the fused AdaLN
// dense (adaln_dense.cu)

// bf16 padding of a shared-memory row: 16 bytes, so that the 8 row
// addresses of every ldmatrix hit distinct banks.
constexpr int kRowPad = 8;

// A [ROWS x COLS] bf16 tile from global memory (rows `lds` apart) into
// shared memory (rows `ldd` apart) by cp.async, 16 bytes a copy, spread
// over the THREADS threads of the block (`tid`); rows at or past `valid`
// are zeros and are not read. The caller commits the group.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst, int ldd,
                                              const __nv_bfloat16* src,
                                              size_t lds, int valid,
                                              int tid) {
  constexpr int kRow = COLS / 8;  // 16-byte pieces of a row
  static_assert(COLS % 8 == 0 && ROWS * kRow % THREADS == 0, "tile copy");
#pragma unroll
  for (int it = 0; it < ROWS * kRow / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / kRow, c = 8 * (i % kRow);
    const bool ok = r < valid;
    cp_async16(dst + r * ldd + c, src + size_t(ok ? r : 0) * lds + c, ok);
  }
}

// A ring of S panel slots in shared memory, filled by cp.async with one
// commit group per panel, S - 1 panels ahead of the one multiplied. Before
// panel p is read: wait until this thread's copies of it have landed (the
// S - 2 later groups may still fly), then a barrier, after which every
// thread's copies have landed and no warp still reads panel p - 1, whose
// slot the caller may then refill with panel p + S - 1.
template <int S>
__device__ __forceinline__ void ring_wait() {
  static_assert(S >= 2, "ring of at least two slots");
  cp_async_wait<S - 2>();
  __syncthreads();
}

template <int MT, int NT>
__device__ __forceinline__ void zero_tiles(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nt][c] = 0.f;
    }
  }
}

// One warp: acc[mi][nt] += A[16 mi + i][k] . B[k][8 nt + j] for the 16 MT
// rows of A, 8 NT columns of B and k < K. A: bf16 rows of length >= K in
// shared memory, `lda` apart (a token or row tile), fragments by ldmatrix;
// B: K bf16 rows `ldb` apart (a weight panel, [k][n]), fragments by
// ldmatrix.trans. Each A fragment feeds NT mma, each B fragment MT; each
// output element is one fixed sequence of mma over k.
template <int K, int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb,
                                         int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "warp tile");
  // ldmatrix row addresses: lanes 8i .. 8i+7 give matrix i, whose rows are
  // (i & 1) 8 rows down and whose columns (i >> 1) 8 columns on
  const int row = (lane & 7) + 8 * ((lane >> 3) & 1), col = 8 * (lane >> 4);
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      ldmatrix_x4(af[mi], a + (16 * mi + row) * lda + k + col);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];  // n-tiles 2 np and 2 np + 1
      ldmatrix_x4_trans(bf, b + (k + row) * ldb + 16 * np + col);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// ---- f32-accurate products on the tensor cores (3xTF32) -----------------
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits, about three decimal
// digits: too few in front of the FAVOR+ exp. Split each operand x into
// hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in f32, and lo keeps
// the next 11 bits), and a . b = a_lo b_hi + a_hi b_lo + a_hi b_hi, each
// product of two TF32 values exact in f32, with f32 accumulation: the
// dropped a_lo b_lo and the rounding of lo leave ~2^-21 of each product.

// x rounded to TF32 (cvt.rna: to nearest, ties away from zero) as the bits
// of an f32 value whose low 13 mantissa bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// D (16x8, f32) += A (16x8, tf32, row-major) . B (8x8, tf32, col-major).
// a[0..3]: (row g, k t), (row g+8, k t), (row g, k t+4), (row g+8, k t+4);
// b0 / b1: k t / t+4 of column g; c as for mma_bf16 (g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element (r, c) of a matrix in shared memory, row-major with leading
// dimension ld, or (kT) of the transpose of such a matrix.
template <bool kT>
__device__ __forceinline__ float mat_at(const float* p, int ld, int r,
                                        int c) {
  return kT ? p[c * ld + r] : p[r * ld + c];
}

// One warp: acc[j] += A . B[:, 8j .. 8j+8) for j < NT, where A (16 x K) and
// B (K x 8 NT) are f32 matrices in shared memory read through mat_at<kTA>
// and mat_at<kTB>. acc[j][0..1] is row g, columns 8j + 2t, 8j + 2t + 1;
// acc[j][2..3] the same columns of row g + 8 (g = lane / 4, t = lane % 4).
//
// kBf16 false: 3xTF32 (above), per k step of 8 the three mma lo.hi, hi.lo,
// hi.hi. kBf16 true (FAVOR_MXU_BF16=1): the operands rounded to bf16 (to
// nearest even, as .astype(bfloat16)), one bf16 mma per k step of 16, f32
// accumulation: the JAX kernels' single MXU pass.
//
// An mma waits for the one before it on the same accumulator. With few
// output tiles (NT <= 4) each tile's sum is therefore taken in independent
// chains, even and odd k steps apart and (3xTF32) the two small terms apart
// from hi.hi, added at the end in a fixed order; with more tiles the tiles
// themselves keep the tensor cores busy and each is one chain. Either way
// each output element is a fixed sequence of mma over k that depends on its
// own row of A only: the same row and the same B give the same bits in any
// tile of any caller with the same NT.
template <bool kBf16, int NT, bool kTA, bool kTB>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4],
                                             const float* a, int lda,
                                             const float* b, int ldb, int K,
                                             int lane) {
  constexpr bool kChains = NT <= 4;
  constexpr int kP = kChains ? 2 : 1;  // k-step parities
  constexpr int kStep = kBf16 ? 16 : 8;
  const int g = lane >> 2, t = lane & 3;
  float big[kP][NT][4], small[kP][NT][4];
  if constexpr (kChains) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) big[p][j][e] = small[p][j][e] = 0.f;
      }
    }
  }
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += kStep) {
    const int p = kChains ? (k0 / kStep) & 1 : 0;
    if constexpr (kBf16) {
      const int k = k0 + 2 * t;
      const uint32_t af[4] = {
          pack_bf16(mat_at<kTA>(a, lda, g, k), mat_at<kTA>(a, lda, g, k + 1)),
          pack_bf16(mat_at<kTA>(a, lda, g + 8, k),
                    mat_at<kTA>(a, lda, g + 8, k + 1)),
          pack_bf16(mat_at<kTA>(a, lda, g, k + 8),
                    mat_at<kTA>(a, lda, g, k + 9)),
          pack_bf16(mat_at<kTA>(a, lda, g + 8, k + 8),
                    mat_at<kTA>(a, lda, g + 8, k + 9))};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        const uint32_t b0 = pack_bf16(mat_at<kTB>(b, ldb, k, n),
                                      mat_at<kTB>(b, ldb, k + 1, n));
        const uint32_t b1 = pack_bf16(mat_at<kTB>(b, ldb, k + 8, n),
                                      mat_at<kTB>(b, ldb, k + 9, n));
        if constexpr (kChains) {
          mma_bf16(big[p][j], af, b0, b1);
        } else {
          mma_bf16(acc[j], af, b0, b1);
        }
      }
    } else {
      uint32_t ah[4], al[4];
      split_tf32(mat_at<kTA>(a, lda, g, k0 + t), ah[0], al[0]);
      split_tf32(mat_at<kTA>(a, lda, g + 8, k0 + t), ah[1], al[1]);
      split_tf32(mat_at<kTA>(a, lda, g, k0 + t + 4), ah[2], al[2]);
      split_tf32(mat_at<kTA>(a, lda, g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(mat_at<kTB>(b, ldb, k0 + t, n), bh0, bl0);
        split_tf32(mat_at<kTB>(b, ldb, k0 + t + 4, n), bh1, bl1);
        if constexpr (kChains) {
          mma_tf32(small[p][j], al, bh0, bh1);
          mma_tf32(small[p][j], ah, bl0, bl1);
          mma_tf32(big[p][j], ah, bh0, bh1);
        } else {
          mma_tf32(acc[j], al, bh0, bh1);
          mma_tf32(acc[j], ah, bl0, bl1);
          mma_tf32(acc[j], ah, bh0, bh1);
        }
      }
    }
  }
  if constexpr (kChains) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] += (small[0][j][e] + big[0][j][e]) +
                     (small[1][j][e] + big[1][j][e]);
      }
    }
  }
}

// The FAVOR+ feature logits of one 16-row tile: acc[j] = rows (16 x D,
// leading dimension ld_rows) . proj[:, n0 + 8j .. + 8) (proj [D][M],
// leading dimension ld_proj). Kernel 1 (favor_qkv.cu) and its backward
// (favor_qkv_bwd.cu) both take their logits from this one routine with
// NT = 2, on rows from normalize_loaded: the backward's clip masks are the
// forward's, bit for bit.
template <bool kBf16, int D, int NT>
__device__ __forceinline__ void feature_logits(const float* rows, int ld_rows,
                                               const float* proj, int ld_proj,
                                               int n0, float (&acc)[NT][4],
                                               int lane) {
  static_assert(NT == 2, "one summation structure for every caller");
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  warp_product<kBf16, NT, false, false>(acc, rows, ld_rows, proj + n0,
                                        ld_proj, D, lane);
}

// The cluster's sum of a [rows x cols] f32 matrix of which every CTA of the
// thread-block cluster holds a partial at the same place `buf` of its
// shared memory (leading dimension ld; cols and ld multiples of 4), read
// through distributed shared memory and added in rank order 0, 1, ..., C-1:
// no atomics, so repeated runs give the same bits. Rank r sums rows
// [r rows / C, (r + 1) rows / C), times `scale`, into its own buf and, when
// dst is not null, into dst (global, rows x cols, 16-byte aligned). With
// `gather`, every CTA then copies the other ranks' sums, so that each holds
// the whole sum. Every thread of every CTA of the cluster (C <= 8) calls
// it after writing its partial; on return no CTA reads another's shared
// memory.
__device__ __forceinline__ void cluster_sum(float* buf, int ld, int rows,
                                            int cols, float scale,
                                            bool gather, float* dst) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = int(cluster.num_blocks());
  const int me = int(cluster.block_rank());
  const int c4 = cols / 4;
  cluster.sync();  // every partial is written
  const int r0 = me * rows / C, r1 = (me + 1) * rows / C;
  for (int i = threadIdx.x; i < (r1 - r0) * c4; i += blockDim.x) {
    const int off = (r0 + i / c4) * ld + 4 * (i % c4);
    float4 p[8];  // every rank's partial in flight at once
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < C) {
        p[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(buf, q) + off);
      }
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < C) {
        s.x += p[q].x;
        s.y += p[q].y;
        s.z += p[q].z;
        s.w += p[q].w;
      }
    }
    s = make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
    *reinterpret_cast<float4*>(buf + off) = s;
    if (dst != nullptr) {
      *reinterpret_cast<float4*>(dst + (r0 + i / c4) * cols + 4 * (i % c4)) =
          s;
    }
  }
  cluster.sync();  // every slice is summed
  if (!gather) return;
  for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
    const int r = i / c4;
    int owner = 0;
    while (r >= (owner + 1) * rows / C) ++owner;
    if (owner == me) continue;
    const int off = r * ld + 4 * (i % c4);
    *reinterpret_cast<float4*>(buf + off) = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(buf, owner) + off);
  }
  cluster.sync();  // no CTA reads another's buf after this
}

// The FAVOR+ feature map exp(clip(logit, -15, 15)) * 0.1.
__device__ __forceinline__ float feature(float logit) {
  return expf(fminf(fmaxf(logit, -15.f), 15.f)) * 0.1f;
}

// Statistics of one normalize_loaded call: LayerNorm mean and 1/std, the L2
// sum of squares n2 and factor r = 1/sqrt(max(n2, 1e-24)) (r = 1 without
// L2). All zero for a row past the sequence end.
struct RowStats {
  float mu, inv, n2, r;
};

// One lane's C columns [lane*C, lane*C + C) of a row, widened to f32; zeros
// for a row past the sequence end. Issued for all of a tile's rows before
// any is normalized, so that their loads are in flight together.
template <typename T, int C>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         bool valid, int lane,
                                         float (&x)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = valid ? to_f32(src[lane * C + c]) : 0.f;
}

// One warp normalizes one D-wide row loaded by load_row: x * pre_scale ->
// LayerNorm(g, beta), then L2 when `l2`, written to dst (lane l holds
// columns [l*C, l*C + C)). A row past the sequence end (`valid` false) is
// written as zeros. `valid` is the same for all lanes, so the early return
// keeps the shuffles convergent.
//
// The forward kernel (favor_qkv.cu) and its backward (favor_qkv_bwd.cu)
// both normalize through this one function, so the backward recomputes the
// forward's rows, and from them its feature logits, bit for bit: the clip
// pass-through masks of the backward agree with the loss that was computed.
template <int C>
__device__ __forceinline__ RowStats normalize_loaded(
    const float (&raw)[C], bool valid, const float (&g)[C],
    const float (&beta)[C], float pre_scale, bool l2, float* dst, int lane) {
  constexpr float kInvD = 1.0f / float(C * 32);
  if (!valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[lane * C + c] = 0.f;
    return RowStats{0.f, 0.f, 0.f, 0.f};
  }
  float x[C];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = raw[c] * pre_scale;
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
  float n2 = 0.f, r = 1.f;
  if (l2) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) ss = fmaf(x[c], x[c], ss);
    n2 = warp_sum(ss);
    r = 1.0f / sqrtf(fmaxf(n2, 1e-24f));
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] *= r;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dst[lane * C + c] = x[c];
  return RowStats{mu, inv, n2, r};
}

// LayerNorm backward of one row held lane-strided (C values per lane):
// dx = inv * (s*g - mean(s*g) - z * mean(s*g*z)) for z the normalized
// input, s the LayerNorm scale, g the gradient of the LayerNorm output.
// Adds g*z and g to the scale and bias gradient accumulators.
template <int C>
__device__ __forceinline__ void layer_norm_bwd_row(
    const float (&g)[C], const float (&z)[C], const float (&s)[C], float inv,
    float (&dx)[C], float (&ds)[C], float (&dc)[C]) {
  constexpr float kInvD = 1.0f / float(C * 32);
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float sg = s[c] * g[c];
    a1 += sg;
    a2 = fmaf(sg, z[c], a2);
  }
  a1 = warp_sum(a1) * kInvD;
  a2 = warp_sum(a2) * kInvD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dx[c] = inv * (s[c] * g[c] - a1 - z[c] * a2);
    ds[c] = fmaf(g[c], z[c], ds[c]);
    dc[c] += g[c];
  }
}

}  // namespace mdm
