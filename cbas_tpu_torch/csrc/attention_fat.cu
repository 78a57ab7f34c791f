// K1: fused attention forward over the flat (B, N, H*64) layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_fat_kernel (entry
// fused_attention_fat). Same function, not the same blocking; the body, its
// two dtype instantiations and the rounding points are in
// attention_common.cuh, which K2 and K3 share.
//
// Layout: q, k, v and o are read and written at [b, n, h*64 + d], the layout
// the 2-D projection matmuls produce and the out-projection consumes, so no
// transpose surrounds the kernel. Row stride H*64, head offset h*64.
//
// What bounds it on this card: at N = 261 and d = 64 attention is a small
// share of a ViT-B forward's FLOPs (the projections and the MLP dominate) and
// a (64-query tile, head, image) block holds little work, so the kernel is
// bound by instruction throughput and on-chip data movement, not by device memory:
// each block reads its Q tile once and each K/V tile once, and the (N, N)
// scores never reach device memory. One block per (64-query tile, head,
// image) gives thousands of blocks at production batch sizes, which fills the
// 132 SMs; a loop over 64-key tiles with an online softmax replaces the TPU
// kernel's whole-row softmax. Tiles load in 16-byte chunks and are not yet
// double-buffered, and RoPE on K is recomputed by every query tile: those,
// wgmma, TMA and warp specialisation are later work.

#include "attention_common.cuh"

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t
// are (N, 64) fp32 tables or both null (no RoPE). head_dim must be 64.
// Returns the CUDA error code of the launch (0 on success); the caller
// raises on anything else.
extern "C" int cbas_attention_fat(const void* q, const void* k, const void* v, void* o,
                                  const void* cos_t, const void* sin_t, int B, int N, int H,
                                  int head_dim, int n_valid, float scale, int dtype,
                                  void* stream) {
  using namespace cbas_attention;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<64>(q, k, v, o, cos_t, sin_t, B, N, H, flat_layout(N, H, 64),
                                     n_valid, scale, dtype, stream));
}
