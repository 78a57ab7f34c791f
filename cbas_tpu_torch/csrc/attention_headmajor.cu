// K3: fused attention forward over the head-major (B, H, N, d) layout, for
// Hopper (sm_90a), built at every multiple of 8 up to 128, and 192 and 256,
// with a wide body for any d above 256 (d a run-time argument).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention): the JAX package's route for every head dim other
// than 64 and for odd head counts. Same function as K1 and K2, read where
// the caller's strides put each head (H groups of one head): contiguous
// (B, H, N, d) tensors, or the head-major views (B, N, H, d).transpose(1, 2)
// of the flat projections that the model's route passes, so no copy
// surrounds the kernel; the output is written with the same strides.
//
// What bounds it on this card: at d = 128 (DINOv3 ViT-7B's 32 heads) the
// bytes of q, k, v and o at N = 261 and the N^2 score work on the tensor
// cores at N = 1205. Three bodies:
// - bfloat16 at d = 64, 128, 192 and 256: the Hopper body
//   (attention_sm90.cuh: TMA ring, wgmma, RoPE once per token and head);
//   and bfloat16 at any other d % 8 == 0 from 136 to 248, on the same body
//   at the next of 192 and 256, its tensor maps at the head's own width
//   (columns beyond it load as zeros, the store clips them);
// - float32 at every d up to 256, and bfloat16 at the other multiples of 8
//   up to 128: attention_common.cuh's body (its tiles outgrow static shared
//   memory above d = 64, head dims that are not a multiple of 16 are
//   zero-filled to one in shared memory, and those whose half is not a
//   multiple of 8 gather RoPE partners one element at a time: both cost only
//   such rare widths);
// - any d above 256, both dtypes: the wide body (attention_wide.cuh: O in
//   384-column slices, the scores formed once a slice; bf16 on wgmma with
//   two consumer warpgroups, fp32 on FMAs). It takes d at run time, so it
//   adds two kernels to the build, not one per width.
// Each instantiated width adds to the build, so the wrapper
// (ops/flash_attention.py::fused_attention) zero-pads, in one copy, a head
// of the widths no body reads in place (float32 at an unbuilt width up to
// 256, bfloat16 at one that is not a multiple of 8) to the next built one.
//
// An odd d with RoPE tables: rotate-half pairs element i with i + d/2
// rounded down (cbas_tpu/models/vit.py's concat(-t[d//2:], t[:d//2])), a
// pairing no zero pad keeps. The wrapper ropes q and k itself (fp32, q's
// scale folded in, one rounding to the input dtype, the plain version's
// rounding points) and launches this kernel without tables and at scale 1.

#include "attention_wide.cuh"

namespace {

template <int HD>
int run(const void* q, const void* k, const void* v, void* o, const void* cos_t,
        const void* sin_t, void* q_scratch, void* k_scratch, int B, int N, int H,
        const cbas_attention::Layout& L, int n_valid, float scale, int dtype, void* stream,
        int* body) {
  using namespace cbas_attention;
  *body = sm90_route(dtype, HD);
  if constexpr (HD == 64 || HD == 128 || HD == 192 || HD == 256) {
    if (*body)
      return static_cast<int>(sm90::launch<HD>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B,
                                               N, H, HD, L, n_valid, scale, stream));
  }
  return static_cast<int>(launch<HD>(q, k, v, o, cos_t, sin_t, B, N, H, L, n_valid, scale, dtype,
                                     stream));
}

}  // namespace

// C entry, bound with ctypes, with the flat and packed entries' signature.
// head_dim is d: a multiple of 8 up to 128, 192 or 256; in bfloat16 any
// other multiple of 8 from 136 to 248 (the Hopper body at the next built
// width, maps at d); or any d above 256 (the wide body, which takes tables
// only at an even d). batch_stride, group_stride (between heads) and
// row_stride are q's (k's, v's and o's) element strides. dtype: 0 = float32,
// 1 = bfloat16. cos_t/sin_t are (N, d) fp32 tables or both null. With
// tables the Hopper body needs k_scratch, and at a padded width and in the
// wide body also q_scratch: buffers laid out like q for the roped keys and
// queries (null otherwise). *body is set to the body that ran: 0 the common
// body, 1 the Hopper body (sm90_route), 2 the wide body. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int cbas_attention_headmajor(const void* q, const void* k, const void* v, void* o,
                                        const void* cos_t, const void* sin_t, void* q_scratch,
                                        void* k_scratch, int B, int N, int H, int head_dim,
                                        long long batch_stride, long long group_stride,
                                        long long row_stride, int n_valid, float scale, int dtype,
                                        void* stream, int* body) {
  using namespace cbas_attention;
  const Layout L{batch_stride, group_stride, 1, row_stride};
#define CBAS_HEAD_DIM(D)                                                                      \
  case D:                                                                                     \
    return run<D>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, L, n_valid, scale, \
                  dtype, stream, body);
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
    CBAS_HEAD_DIM(192)
    CBAS_HEAD_DIM(256)
    default:
      if (head_dim > kMaxHeadDim) {
        *body = 2;
        return static_cast<int>(wide::launch(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B,
                                             N, H, head_dim, L, n_valid, scale, dtype, stream));
      }
      if (dtype != 1 || head_dim <= 128 || head_dim % kChunk)
        return static_cast<int>(cudaErrorInvalidValue);
      *body = 1;
      return static_cast<int>(
          head_dim < 192 ? sm90::launch<192>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N,
                                             H, head_dim, L, n_valid, scale, stream)
                         : sm90::launch<256>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N,
                                             H, head_dim, L, n_valid, scale, stream));
  }
#undef CBAS_HEAD_DIM
}
