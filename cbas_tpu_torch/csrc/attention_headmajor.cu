// K3: fused attention forward over the head-major (B, H, N, d) layout, for
// Hopper (sm_90a), d any multiple of 8 up to 128.
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention): the JAX package's route for every head dim other
// than 64 and for odd head counts. Same function as K1 and K2, read at row
// stride d with head h at h * N * d of its image (H groups of one head; the
// tensors are contiguous, as the wrapper requires).
//
// What bounds it on this card: at d = 128 (DINOv3 ViT-7B's 32 heads) the
// bytes of q, k, v and o at N = 261 and the N^2 score work on the tensor
// cores at N = 1205. bfloat16 at d = 64 and 128 takes the Hopper body
// (attention_sm90.cuh: TMA ring, wgmma, RoPE once per token and head). The
// other head dims, and float32 at every head dim, keep attention_common.cuh's
// body: its tiles outgrow static shared memory above d = 64 (dynamic, 52 KB
// in bf16 at d = 128), head dims that are not a multiple of 16 are
// zero-filled to one in shared memory, and those whose half is not a
// multiple of 8 gather RoPE partners one element at a time: both cost only
// such rare widths.

#include "attention_sm90.cuh"

namespace {

template <int HD>
int run(const void* q, const void* k, const void* v, void* o, const void* cos_t,
        const void* sin_t, void* k_scratch, int B, int N, int H, const cbas_attention::Layout& L,
        int n_valid, float scale, int dtype, void* stream, int* body) {
  using namespace cbas_attention;
  *body = sm90_route(dtype, HD);
  if constexpr (HD == 64 || HD == 128) {
    if (*body)
      return static_cast<int>(sm90::launch<HD>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, L,
                                               n_valid, scale, stream));
  }
  return static_cast<int>(launch<HD>(q, k, v, o, cos_t, sin_t, B, N, H, L, n_valid, scale, dtype,
                                     stream));
}

}  // namespace

// C entry, bound with ctypes, with the flat and packed entries' signature.
// head_dim is d (a multiple of 8, at most 128). batch_stride, group_stride
// (between heads) and row_stride are q's (k's, v's and o's) element strides.
// dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, d) fp32 tables or
// both null. k_scratch is a buffer laid out like k for the roped keys, needed
// by the Hopper body with tables (null otherwise). *body is set to the body
// that ran (sm90_route). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int cbas_attention_headmajor(const void* q, const void* k, const void* v, void* o,
                                        const void* cos_t, const void* sin_t, void* k_scratch,
                                        int B, int N, int H, int head_dim, long long batch_stride,
                                        long long group_stride, long long row_stride, int n_valid,
                                        float scale, int dtype, void* stream, int* body) {
  const cbas_attention::Layout L{batch_stride, group_stride, 1, row_stride};
#define CBAS_HEAD_DIM(D)                                                                     \
  case D:                                                                                    \
    return run<D>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, L, n_valid, scale, dtype,    \
                  stream, body);
  switch (head_dim) {
    CBAS_HEAD_DIM(8)
    CBAS_HEAD_DIM(16)
    CBAS_HEAD_DIM(24)
    CBAS_HEAD_DIM(32)
    CBAS_HEAD_DIM(40)
    CBAS_HEAD_DIM(48)
    CBAS_HEAD_DIM(56)
    CBAS_HEAD_DIM(64)
    CBAS_HEAD_DIM(72)
    CBAS_HEAD_DIM(80)
    CBAS_HEAD_DIM(88)
    CBAS_HEAD_DIM(96)
    CBAS_HEAD_DIM(104)
    CBAS_HEAD_DIM(112)
    CBAS_HEAD_DIM(120)
    CBAS_HEAD_DIM(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CBAS_HEAD_DIM
}
