// K3: fused attention forward over the head-major (B, H, N, d) layout, for
// Hopper (sm_90a), built at every multiple of 8 up to 128, and 192 and 256,
// with a wide body for any d above 256 (d a run-time argument).
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
// such rare widths. Above d = 128 (no shipped preset has such heads) the
// bf16 body reads Q's fragments from shared memory once per key tile; only
// 192 and 256 are instantiated there, since each width adds to the build.
// The wrapper (ops/flash_attention.py::fused_attention) zero-pads a head of
// any other width up to 256 to the next instantiated one.
//
// Above d = 256 a 64-row fp32 tile of a head outgrows the 227 KB of shared
// memory a block may use: the wide body (attention_common.cuh's
// attention_wide) gives each block one 64-column slice of O and accumulates
// the scores over d in 64-column slices of Q and K through shared memory,
// recomputing them for every slice. It takes d at run time, in fp32 and bf16,
// so it adds two kernels to the build, not one per width. Simple and right,
// not fast: each slice of a head repeats the q.k^T work.
//
// An odd d with RoPE tables: rotate-half pairs element i with i + d/2
// rounded down (cbas_tpu/models/vit.py's concat(-t[d//2:], t[:d//2])), a
// pairing no zero pad keeps. The wrapper ropes q and k itself (fp32, q's
// scale folded in, one rounding to the input dtype, the plain version's
// rounding points) and launches this kernel without tables and at scale 1.

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

// Launch the wide body (attention_common.cuh's attention_wide: any head dim
// hd above kMaxHeadDim, as a run-time argument) on `stream`. It is launched
// from here only, so the flat and packed libraries do not build it. dtype:
// 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, hd) fp32 tables, which
// need an even hd, or both null. Returns the CUDA error of the launch
// (cudaSuccess when it was queued).
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                        const void* sin_t, int B, int N, int H, int hd,
                        const cbas_attention::Layout& L, int n_valid, float scale, int dtype,
                        void* stream) {
  using namespace cbas_attention;
  const cudaError_t bad = check_args(B, N, H, L, n_valid);
  if (bad != cudaSuccess) return bad;
  const int n_slices = (hd + kWideSlice - 1) / kWideSlice;
  if (hd <= kMaxHeadDim || (cos_t != nullptr && hd % 2) || (cos_t == nullptr) != (sin_t == nullptr) ||
      static_cast<long long>(B) * n_slices > 65535)
    return cudaErrorInvalidValue;
  const auto* c = static_cast<const float*>(cos_t);
  const auto* s = static_cast<const float*>(sin_t);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTile - 1) / kTile, H, B * n_slices);
  constexpr size_t bytes = WideTiles::kSmemBytes;
  if (dtype == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_wide<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    attention_wide<float><<<grid, kF32Threads, bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), c, s, N, hd, n_slices, L, n_valid, scale);
  } else if (dtype == 1) {
    const cudaError_t err = cudaFuncSetAttribute(attention_wide<__nv_bfloat16>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    attention_wide<__nv_bfloat16><<<grid, kF32Threads, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), c, s, N, hd,
        n_slices, L, n_valid, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes, with the flat and packed entries' signature.
// head_dim is d (a multiple of 8 up to 128, 192, 256, or any d above 256:
// the wide body, which takes tables only at an even d). batch_stride,
// group_stride (between heads) and row_stride are q's (k's, v's and o's)
// element strides.
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
    CBAS_HEAD_DIM(192)
    CBAS_HEAD_DIM(256)
    default:
      if (head_dim <= cbas_attention::kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
      *body = 0;
      return static_cast<int>(
          launch_wide(q, k, v, o, cos_t, sin_t, B, N, H, head_dim, L, n_valid, scale, dtype, stream));
  }
#undef CBAS_HEAD_DIM
}
