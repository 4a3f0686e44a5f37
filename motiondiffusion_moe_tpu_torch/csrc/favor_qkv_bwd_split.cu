// Kernel 3 (the backward of the merged-QKV Performer core) in three
// launches over a seq rank's frames, with the seq ranks' all-reduces of kv
// and g_kv between them (ops/performer.py::_FavorQKVSplit):
//   mdm_favor_qkv_bwd_kv  pass 1: kv of the rank's rows, times 0.1;
//   mdm_favor_qkv_bwd_q   pass 2 from the summed kv: d(q), and g_kv of the
//                         rank's rows, times 0.1;
//   mdm_favor_qkv_bwd_k   pass 3 from the summed g_kv: d(k), d(v), and the
//                         rank's d(ln_scale), d(ln_bias), d(proj).
// The kernel is the template of favor_qkv_bwd.cuh (kPass), every instance
// of the whole one's: the (head_dim, num_features) pairs below, f32 and
// bf16 tensors, with and without FAVOR_MXU_BF16.

#include "favor_qkv_bwd.cuh"

namespace mdm {
namespace {

// One of the three launches at a (head_dim, num_features) pair the library
// holds; cudaErrorInvalidValue for any other.
template <int kPass>
int launch_split(const void* qkv, const void* ln_scale, const void* ln_bias,
                 const void* proj, const void* mask, const void* g,
                 void* dqkv, void* d_scale, void* d_bias, void* d_proj,
                 void* scratch, void* kv, void* g_kv, int batch, int seq_len,
                 int num_heads, int head_dim, int num_features, int is_bf16,
                 int mxu_bf16, float eps, float pre_scale, int want_dproj,
                 int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* kvp = static_cast<float*>(kv);
  float* gkvp = static_cast<float*>(g_kv);
#define MDM_SPLIT_LAUNCH(T_, D_, M_, B_)                                     \
  launch_favor_qkv_bwd<T_, D_, M_, B_, kPass>(                               \
      qkv, ln_scale, ln_bias, proj, mask, g, dqkv, d_scale, d_bias, d_proj,  \
      scratch, nullptr, nullptr, batch, seq_len, num_heads, eps, pre_scale,  \
      cluster, s, want_dproj != 0, kvp, gkvp)
#define MDM_SPLIT_CASE(D_, M_)                                               \
  if (head_dim == D_ && num_features == M_) {                                \
    if (is_bf16) {                                                           \
      return int(mxu_bf16                                                    \
                     ? MDM_SPLIT_LAUNCH(__nv_bfloat16, D_, M_, true)         \
                     : MDM_SPLIT_LAUNCH(__nv_bfloat16, D_, M_, false));      \
    }                                                                        \
    return int(mxu_bf16 ? MDM_SPLIT_LAUNCH(float, D_, M_, true)              \
                        : MDM_SPLIT_LAUNCH(float, D_, M_, false));           \
  }
  MDM_SPLIT_CASE(64, 128)
  MDM_SPLIT_CASE(96, 128)
  MDM_SPLIT_CASE(128, 128)
  MDM_SPLIT_CASE(256, 128)
#undef MDM_SPLIT_CASE
#undef MDM_SPLIT_LAUNCH
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace mdm

// Floats of the scratch the three launches share (the caller allocates it
// once, for all three): mdm_favor_qkv_bwd_scratch_floats' and the d(ln)
// accumulators that pass 2 hands to pass 3.
extern "C" long long mdm_favor_qkv_bwd_split_scratch_floats(
    int batch, int seq_len, int num_heads, int head_dim, int num_features,
    int want_dproj, int cluster) {
  return static_cast<long long>(mdm::favor_bwd_scratch_floats(
      batch, seq_len, num_heads, head_dim, num_features, want_dproj != 0,
      cluster, true));
}

// C entries for ctypes. qkv [B, T_rank, 3*H*D], mask [B, T_rank] or null,
// ln_scale, ln_bias, proj, mxu_bf16 and cluster as for mdm_favor_qkv_bwd;
// want_dproj as the three launches' d(proj) (the same in all three, as
// scratch and cluster). kv, g_kv: f32 [B, H, M, D]. mdm_favor_qkv_bwd_kv
// writes kv (the rank's rows). mdm_favor_qkv_bwd_q reads kv (the seq
// ranks' sum) and g [B, T_rank, H*D] in qkv's dtype, writes the q third of
// dqkv [B, T_rank, 3*H*D] and g_kv (the rank's rows). mdm_favor_qkv_bwd_k
// reads g_kv (the seq ranks' sum), writes the k and v thirds of dqkv and
// d_scale, d_bias [D] and, with want_dproj, d_proj [D, M], f32: the
// rank's frames' shares. Each returns the CUDA error code of its launches.
extern "C" int mdm_favor_qkv_bwd_kv(const void* qkv, const void* ln_scale,
                                    const void* ln_bias, const void* proj,
                                    const void* mask, void* kv, void* scratch,
                                    int batch, int seq_len, int num_heads,
                                    int head_dim, int num_features,
                                    int is_bf16, int mxu_bf16,
                                    float pre_scale, int want_dproj,
                                    int cluster, void* stream) {
  return mdm::launch_split<mdm::kPassKv>(
      qkv, ln_scale, ln_bias, proj, mask, nullptr, nullptr, nullptr, nullptr,
      nullptr, scratch, kv, nullptr, batch, seq_len, num_heads, head_dim,
      num_features, is_bf16, mxu_bf16, 1e-6f, pre_scale, want_dproj, cluster,
      stream);
}

extern "C" int mdm_favor_qkv_bwd_q(const void* qkv, const void* ln_scale,
                                   const void* ln_bias, const void* proj,
                                   const void* mask, const void* g,
                                   const void* kv, void* dqkv, void* g_kv,
                                   void* scratch, int batch, int seq_len,
                                   int num_heads, int head_dim,
                                   int num_features, int is_bf16,
                                   int mxu_bf16, float eps, float pre_scale,
                                   int want_dproj, int cluster,
                                   void* stream) {
  return mdm::launch_split<mdm::kPassQ>(
      qkv, ln_scale, ln_bias, proj, mask, g, dqkv, nullptr, nullptr, nullptr,
      scratch, const_cast<void*>(kv), g_kv, batch, seq_len, num_heads,
      head_dim, num_features, is_bf16, mxu_bf16, eps, pre_scale, want_dproj,
      cluster, stream);
}

extern "C" int mdm_favor_qkv_bwd_k(const void* qkv, const void* ln_scale,
                                   const void* ln_bias, const void* proj,
                                   const void* mask, const void* g_kv,
                                   void* dqkv, void* d_scale, void* d_bias,
                                   void* d_proj, void* scratch, int batch,
                                   int seq_len, int num_heads, int head_dim,
                                   int num_features, int is_bf16,
                                   int mxu_bf16, float eps, float pre_scale,
                                   int cluster, void* stream) {
  return mdm::launch_split<mdm::kPassK>(
      qkv, ln_scale, ln_bias, proj, mask, nullptr, dqkv, d_scale, d_bias,
      d_proj, scratch, nullptr, const_cast<void*>(g_kv), batch, seq_len,
      num_heads, head_dim, num_features, is_bf16, mxu_bf16, eps, pre_scale,
      d_proj != nullptr, cluster, stream);
}
