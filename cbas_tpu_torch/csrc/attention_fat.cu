// K1: fused attention forward over the flat (B, N, H*64) layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_fat_kernel (entry
// fused_attention_fat). Same function, not the same blocking; the rounding
// points are attention_common.cuh's, which K2 and K3 share.
//
// Layout: q, k, v and o are read and written at [b, n, h*64 + d], the layout
// the 2-D projection matmuls produce and the out-projection consumes, so no
// transpose surrounds the kernel. One group of H heads: row stride H*64 (as
// the wrapper passes it; the tensors are contiguous), head offset h*64.
//
// What bounds it on this card: at N = 261 (ViT-B at 256x256) the bytes of q,
// k, v and o (memory-bound: 205 MB at batch 128); at N = 1205 (640x480) the
// N^2 score work on the tensor cores. bfloat16 takes the Hopper body
// (attention_sm90.cuh: TMA ring, wgmma, RoPE once per token and head);
// float32, the parity instantiation, keeps attention_common.cuh's body.

#include "attention_sm90.cuh"

// C entry, bound with ctypes, with the packed and head-major entries'
// signature. dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, 64) fp32
// tables or both null (no RoPE). head_dim must be 64. batch_stride and
// row_stride are q's (k's, v's and o's) element strides; group_stride is
// unused (one group of H heads), and so is q_scratch. k_scratch is a buffer
// laid out like k for the roped keys, needed by the Hopper body with tables
// (null otherwise).
// *body is set to the body that ran (sm90_route). Returns the CUDA error code
// of the launch (0 on success); the caller raises on anything else.
extern "C" int cbas_attention_fat(const void* q, const void* k, const void* v, void* o,
                                  const void* cos_t, const void* sin_t, void* /*q_scratch*/,
                                  void* k_scratch, int B, int N, int H, int head_dim,
                                  long long batch_stride,
                                  long long /*group_stride*/, long long row_stride, int n_valid,
                                  float scale, int dtype, void* stream, int* body) {
  using namespace cbas_attention;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, 0, H, row_stride};
  *body = sm90_route(dtype, head_dim);
  if (*body)
    return static_cast<int>(sm90::launch<64>(q, k, v, o, cos_t, sin_t, nullptr, k_scratch, B, N, H,
                                             64, L, n_valid, scale, stream));
  return static_cast<int>(launch<64>(q, k, v, o, cos_t, sin_t, B, N, H, L, n_valid, scale, dtype,
                                     stream));
}
