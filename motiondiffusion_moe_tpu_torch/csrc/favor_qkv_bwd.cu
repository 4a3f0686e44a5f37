// Backward of the merged-QKV Performer (FAVOR+) core, hand-written for
// Hopper: the C entries of the whole-T kernel (kernel 3).
//
// Replaces the Pallas TPU kernel
// motiondiffusion_moe_tpu/ops/performer_pallas_bwd.py::_favor_qkv_bwd_kernel
// (public entry favor_qkv_bwd_pallas). The kernel, its design and what
// bounds it on the card are in favor_qkv_bwd.cuh; favor_qkv_bwd_split.cu
// has the entries of its three launches over a seq rank's frames.

#include "favor_qkv_bwd.cuh"

// Floats of scratch mdm_favor_qkv_bwd needs (the caller allocates it).
extern "C" long long mdm_favor_qkv_bwd_scratch_floats(int batch, int seq_len,
                                                      int num_heads,
                                                      int head_dim,
                                                      int num_features,
                                                      int want_dproj,
                                                      int cluster) {
  return static_cast<long long>(mdm::favor_bwd_scratch_floats(
      batch, seq_len, num_heads, head_dim, num_features, want_dproj != 0,
      cluster));
}

// C entry for ctypes. qkv/dqkv: [B, T, 3*H*D] and g: [B, T, H*D], contiguous,
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); ln_scale, ln_bias,
// d_scale, d_bias: [D] f32; proj, d_proj: [D, M] f32, d_proj null when
// d(proj) is not wanted; mask: [B, T] f32 or null; scratch: f32, of
// mdm_favor_qkv_bwd_scratch_floats; logits_q / logits_k: null, or f32
// [B, T, H, M] that receive the feature logits; mxu_bf16: the
// products on bf16 operands (FAVOR_MXU_BF16=1, taken by the forward);
// cluster: the CTAs that share one (b, h), 1 to 8. Returns the CUDA error
// code of the launches (0 on success); (head_dim, num_features) pairs other
// than the instantiated ones return cudaErrorInvalidValue.
extern "C" int mdm_favor_qkv_bwd(const void* qkv, const void* ln_scale,
                                 const void* ln_bias, const void* proj,
                                 const void* mask, const void* g, void* dqkv,
                                 void* d_scale, void* d_bias, void* d_proj,
                                 void* scratch, void* logits_q,
                                 void* logits_k, int batch, int seq_len,
                                 int num_heads, int head_dim, int num_features,
                                 int is_bf16, int mxu_bf16, float eps,
                                 float pre_scale, int cluster, void* stream) {
  using mdm::launch_favor_qkv_bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lq = static_cast<float*>(logits_q);
  float* lk = static_cast<float*>(logits_k);
#define MDM_FAVOR_BWD_LAUNCH(T_, D_, M_, B_)                                  \
  launch_favor_qkv_bwd<T_, D_, M_, B_>(qkv, ln_scale, ln_bias, proj, mask, g, \
                                       dqkv, d_scale, d_bias, d_proj,         \
                                       scratch, lq, lk, batch, seq_len,       \
                                       num_heads, eps, pre_scale, cluster, s, \
                                       d_proj != nullptr)
#define MDM_FAVOR_BWD_CASE(D_, M_)                                            \
  if (head_dim == D_ && num_features == M_) {                                 \
    if (is_bf16) {                                                            \
      return int(mxu_bf16                                                     \
                     ? MDM_FAVOR_BWD_LAUNCH(__nv_bfloat16, D_, M_, true)      \
                     : MDM_FAVOR_BWD_LAUNCH(__nv_bfloat16, D_, M_, false));   \
    }                                                                         \
    return int(mxu_bf16 ? MDM_FAVOR_BWD_LAUNCH(float, D_, M_, true)           \
                        : MDM_FAVOR_BWD_LAUNCH(float, D_, M_, false));        \
  }
  MDM_FAVOR_BWD_CASE(64, 128)
  MDM_FAVOR_BWD_CASE(96, 128)
  MDM_FAVOR_BWD_CASE(128, 128)
  MDM_FAVOR_BWD_CASE(256, 128)
#undef MDM_FAVOR_BWD_CASE
#undef MDM_FAVOR_BWD_LAUNCH
  return int(cudaErrorInvalidValue);
}
