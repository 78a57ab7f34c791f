// K3: fused attention forward over the head-major (B, H, N, d) layout, for
// Hopper (sm_90a), built at every multiple of 8 up to 128, and 192 and 256,
// with a wide body in each dtype for any d above 256 (d a run-time argument).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention): the JAX package's route for every head dim other
// than 64 and for odd head counts. Same function as K1 and K2, read where
// the caller's strides put each head (H groups of one head): contiguous
// (B, H, N, d) tensors, or the head-major views (B, N, H, d).transpose(1, 2)
// of one fused (B, N, 3*H*d) q|k|v projection that the model's route
// passes, so no copy surrounds the kernel; the output is written with
// strides of its own, dense in q's dim order (empty(B, N, H, d).transpose(1,
// 2) for those views).
//
// What bounds it on this card: at d = 128 (DINOv3 ViT-7B's 32 heads) the
// bytes of q, k, v and o at N = 261 and the N^2 score work on the tensor
// cores at N = 1205. Six bodies:
// - bfloat16 at d = 64, 128, 192 and 256: the Hopper body
//   (attention_sm90.cuh: TMA ring, wgmma, RoPE once per token and head);
//   and bfloat16 at any other d % 8 == 0 from 136 to 248, on the same body
//   at the next of 192 and 256, its tensor maps at the head's own width
//   (columns beyond it load as zeros, the store clips them);
// - float32 at every multiple of 4 up to 128: its fp32 counterpart
//   (attention_sm90_tf32.cuh: the same ring and maps, 3xTF32 on wgmma, K and
//   V split and roped once a call by a prologue), at 64 or 128, maps at d;
// - float32 at every multiple of 4 from 132 to 256: that body's wide form
//   (attention_sm90_tf32_wide.cuh: two warpgroups, each owning half of d),
//   at 192 or 256, maps at d;
// - float32 at any d above 256: its slices body
//   (attention_sm90_tf32_slices.cuh: the same arithmetic, O in 384-column
//   slices, d at run time, Q staged without the TMA);
// - bfloat16 at the other multiples of 8 up to 128: attention_common.cuh's
//   body (its tiles outgrow static shared memory above d = 64, head dims
//   that are not a multiple of 16 are zero-filled to one in shared memory,
//   and those whose half is not a multiple of 8 gather RoPE partners one
//   element at a time: both cost only such rare widths);
// - bfloat16 at any d above 256: the wide body (attention_wide.cuh: O in
//   384-column slices, the scores formed once a slice, on wgmma with two
//   consumer warpgroups). It and the slices body take d at run time, so each
//   adds two kernels to the build, not one per width.
// Each instantiated width adds to the build, so the wrapper
// (ops/flash_attention.py::fused_attention) zero-pads, in one copy, a head
// of the widths no body reads in place (up to 256, float32 at one that is
// not a multiple of 4, bfloat16 at one that is not a multiple of 8) to the
// next built one.
//
// An odd d with RoPE tables: rotate-half pairs element i with i + d/2
// rounded down (cbas_tpu/models/vit.py's concat(-t[d//2:], t[:d//2])), a
// pairing no zero pad keeps. The wrapper ropes q and k itself (fp32, q's
// scale folded in, one rounding to the input dtype, the plain version's
// rounding points) and launches this kernel without tables and at scale 1.

#include "attention_sm90_tf32_slices.cuh"
#include "attention_wide.cuh"

namespace {

// bfloat16 up to 256: the common body, or at 64, 128, 192 and 256 the
// Hopper body (sm90_route). float32 never reaches this: the entry launches
// the fp32 Hopper bodies first.
template <int HD>
int run(const void* q, const void* k, const void* v, void* o, const void* cos_t,
        const void* sin_t, void* q_scratch, void* k_scratch, int B, int N, int H,
        const cbas_attention::Layout& L, const cbas_attention::Layout& Lo, int n_valid,
        float scale, int dtype, void* stream, int* body) {
  using namespace cbas_attention;
  *body = sm90_route(dtype, HD);
  if constexpr (HD % 64 == 0) {  // 64, 128, 192, 256: the Hopper body's, nothing else
    if (*body != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(sm90::launch<HD>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N,
                                             H, HD, L, Lo, n_valid, scale, stream));
  } else {
    if (*body != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<HD>(q, k, v, o, cos_t, sin_t, B, N, H, L, Lo, n_valid, scale,
                                       dtype, stream));
  }
}

// float32 on an fp32 Hopper body (sm90_route 3, 4 or 5), at the width
// tf32_width(d) it is built at, maps at d; above 256 the slices body at d.
int run_tf32(const void* q, const void* k, const void* v, void* o, const void* cos_t,
             const void* sin_t, void* k_scratch, int B, int N, int H, int d,
             const cbas_attention::Layout& L, const cbas_attention::Layout& Lo, int n_valid,
             float scale, void* stream, int* prologues) {
  using namespace cbas_attention;
  switch (tf32_width(d)) {
    case 64:
      return static_cast<int>(tf32::launch<64>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, d, L,
                                               Lo, n_valid, scale, stream, prologues));
    case 128:
      return static_cast<int>(tf32::launch<128>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, d, L,
                                                Lo, n_valid, scale, stream, prologues));
    case 192:
      return static_cast<int>(tf32_wide::launch<192>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H,
                                                     d, L, Lo, n_valid, scale, stream, prologues));
    case 256:
      return static_cast<int>(tf32_wide::launch<256>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H,
                                                     d, L, Lo, n_valid, scale, stream, prologues));
  }
  return static_cast<int>(tf32_slices::launch(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, d, L,
                                              Lo, n_valid, scale, stream, prologues));
}

}  // namespace

// C entry, bound with ctypes, with the flat and packed entries' signature.
// head_dim is d: in bfloat16 a multiple of 8 up to 128, 192 or 256, or any
// other multiple of 8 from 136 to 248 (the Hopper body at the next built
// width, maps at d); in float32 any multiple of 4 up to 256 (body 3 at 64
// or 128, body 4 at 192 or 256, maps at d); or any d above 256 (bf16 the
// wide body, fp32 body 5; both take tables only at an even d).
// batch_stride, group_stride (between heads) and row_stride are q's (k's and
// v's) element strides, the o_ ones o's (its dims in q's order).
// dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, d) fp32 tables or
// both null. With tables the bf16 Hopper body needs k_scratch, and at a
// padded width and in the wide body also q_scratch: buffers laid out like
// o for the roped keys and queries (null otherwise). In float32 (bodies 3,
// 4 and 5), k_scratch is the prologue's scratch, 4 * B * H *
// tf32::scratch_keys(n_valid) * tf32_width(d) floats, needed with or
// without tables. *body is set to the body that ran: 0 the
// common body, 1 the Hopper body (sm90_route), 2 the wide body, 3 the fp32
// Hopper body, 4 its wide form (attention_sm90_tf32_wide.cuh), 5 its slices
// body (attention_sm90_tf32_slices.cuh); *prologues
// to the fp32 bodies' prologue launches it queued (0 or 1). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int cbas_attention_headmajor(const void* q, const void* k, const void* v, void* o,
                                        const void* cos_t, const void* sin_t, void* q_scratch,
                                        void* k_scratch, int B, int N, int H, int head_dim,
                                        long long batch_stride, long long group_stride,
                                        long long row_stride, long long o_batch_stride,
                                        long long o_group_stride, long long o_row_stride,
                                        int n_valid, float scale, int dtype, void* stream,
                                        int* body, int* prologues) {
  using namespace cbas_attention;
  *prologues = 0;
  const Layout L{batch_stride, group_stride, 1, row_stride};
  const Layout Lo{o_batch_stride, o_group_stride, 1, o_row_stride};
  const int route = sm90_route(dtype, head_dim);
  if (route >= 3) {
    *body = route;
    return run_tf32(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, head_dim, L, Lo, n_valid, scale,
                    stream, prologues);
  }
#define CBAS_HEAD_DIM(D)                                                                         \
  case D:                                                                                        \
    return run<D>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, L, Lo, n_valid, scale, \
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
        if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
        return static_cast<int>(wide::launch(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B,
                                             N, H, head_dim, L, Lo, n_valid, scale, stream));
      }
      if (dtype != 1 || head_dim <= 128 || head_dim % kChunk)
        return static_cast<int>(cudaErrorInvalidValue);
      *body = 1;
      return static_cast<int>(
          head_dim < 192 ? sm90::launch<192>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N,
                                             H, head_dim, L, Lo, n_valid, scale, stream)
                         : sm90::launch<256>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N,
                                             H, head_dim, L, Lo, n_valid, scale, stream));
  }
#undef CBAS_HEAD_DIM
}

// C entry of the fp32 Hopper bodies' prologue alone (tf32::split_kv), bound
// with ctypes: k and v head-major (B, H, N, head_dim) fp32 at the given
// element strides (batch, head, row; the last dim contiguous), head_dim a
// multiple of 4 up to 256 or any above (split_kv_wide), split (and roped,
// with (N, head_dim) fp32 tables, which need an even head_dim)
// into `scratch`, 4 * B * H * tf32::scratch_keys(n_valid) *
// tf32_width(head_dim) floats, as K3's fp32 launches at that width write it
// before their attention kernel. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int cbas_attention_tf32_prologue(const void* k, const void* v, void* scratch,
                                            const void* cos_t, const void* sin_t, int B, int N,
                                            int H, int head_dim, long long batch_stride,
                                            long long group_stride, long long row_stride,
                                            int n_valid, void* stream) {
  using namespace cbas_attention;
  const Layout L{batch_stride, group_stride, 1, row_stride};
  const auto st = static_cast<cudaStream_t>(stream);
  const int d = head_dim;
  if (N <= 0 || n_valid > N) return static_cast<int>(cudaErrorInvalidValue);
  switch (tf32_width(d)) {
    case 64:
      return static_cast<int>(tf32::launch_split<64>(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st));
    case 128:
      return static_cast<int>(tf32::launch_split<128>(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st));
    case 192:
      return static_cast<int>(tf32::launch_split<192>(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st));
    case 256:
      return static_cast<int>(tf32::launch_split<256>(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st));
  }
  return static_cast<int>(tf32_slices::launch_split(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st));
}
