// K1: fused attention forward over the flat (B, N, H*64) layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_fat_kernel (entry
// fused_attention_fat). Same function, not the same blocking; the rounding
// points are attention_common.cuh's, which K2 and K3 share.
//
// Layout: q, k, v and o are read and written at [b, n, h*64 + d], the layout
// the 2-D projection matmuls produce and the out-projection consumes, so no
// transpose surrounds the kernel. One group of H heads, head offset h*64, at
// the row stride the caller's tensors have: H*64 for contiguous ones, 3*H*64
// for the q, k and v views of one fused (B, N, 3D) q|k|v projection, which
// the model's route passes (the TPU kernel benchmarks/attn_probes/
// probe22_qkvfused_256.py::make_qkv_kernel read the same offsets 0, D and 2D
// of one row). The output has strides of its own: dense (B, N, H*64), so a
// fused projection's context lands at row stride D, not 3D.
//
// What bounds it on this card: at N = 261 (ViT-B at 256x256) the bytes of q,
// k, v and o (memory-bound: 205 MB at batch 128); at N = 1205 (640x480) the
// N^2 score work on the tensor cores. bfloat16 takes the Hopper body
// (attention_sm90.cuh: TMA ring, wgmma, RoPE once per token and head);
// float32 takes its fp32 counterpart (attention_sm90_tf32.cuh: the same ring
// and wgmma in 3xTF32, K and V split and roped once a call by a prologue).

#include "attention_sm90_tf32.cuh"

// C entry, bound with ctypes, with the packed and head-major entries'
// signature. dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, 64) fp32
// tables or both null (no RoPE). head_dim must be 64. batch_stride and
// row_stride are q's (k's and v's) element strides, o_batch_stride and
// o_row_stride o's; the group strides are unused (one group of H heads), and
// so is q_scratch. k_scratch is, in bfloat16, a buffer laid out like o for
// the roped keys, needed with tables (null otherwise); in float32 the fp32
// body's scratch, 4 * B * H * tf32::scratch_keys(n_valid) * 64 floats,
// needed with or without tables. *body is set to the body that ran
// (sm90_route: 1 or 3; the entry takes nothing else), *prologues to the
// fp32 body's prologue launches it queued (0 or 1). Returns the CUDA error
// code of the launch (0 on success); the caller raises on anything else.
extern "C" int cbas_attention_fat(const void* q, const void* k, const void* v, void* o,
                                  const void* cos_t, const void* sin_t, void* /*q_scratch*/,
                                  void* k_scratch, int B, int N, int H, int head_dim,
                                  long long batch_stride,
                                  long long /*group_stride*/, long long row_stride,
                                  long long o_batch_stride, long long /*o_group_stride*/,
                                  long long o_row_stride, int n_valid, float scale, int dtype,
                                  void* stream, int* body, int* prologues) {
  using namespace cbas_attention;
  *prologues = 0;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, 0, H, row_stride};
  const Layout Lo{o_batch_stride, 0, H, o_row_stride};
  *body = sm90_route(dtype, head_dim);
  if (*body == 1)
    return static_cast<int>(sm90::launch<64>(q, k, v, o, cos_t, sin_t, nullptr, k_scratch, B, N, H,
                                             64, L, Lo, n_valid, scale, stream));
  if (*body == 3)
    return static_cast<int>(tf32::launch<64>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, 64, L,
                                             Lo, n_valid, scale, stream, prologues));
  return static_cast<int>(cudaErrorInvalidValue);
}
