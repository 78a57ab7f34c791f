// K2: fused attention forward over the head-pair packed (B, H/2, N, 128)
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_packed_attn_kernel
// (entry fused_attention_packed): two 64-wide heads side by side on the last
// dim, (N, 64) RoPE tables shared by both. Same function as K1 and K3; the
// body is attention_common.cuh's, read at row stride 128 with head h at
// (h / 2) * N * 128 + (h % 2) * 64 of its image.
//
// What bounds it on this card: the same as K1 (instruction throughput and on-chip
// data movement at N = 261, the N^2 score work at N = 1205), since a block
// reads the same 64 x 64 tiles; only the row stride differs. On the TPU the
// packing filled 128-lane DMA tiles; here 16-byte loads are full width at any
// stride, so packing buys nothing and costs the caller a transpose of q, k,
// v and the output. The port keeps it because the JAX package routes 64-wide
// heads here when the flat kernel is switched off (CBAS_ATTN_FAT=0). The
// TPU-only transposed score orientation (pvt) is not ported: one orientation
// serves.

#include "attention_common.cuh"

// C entry, bound with ctypes, with the flat and head-major entries'
// signature. H is the head count (twice the pairs, so even); head_dim must be
// 64. dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, 64) fp32 tables
// or both null. k_scratch is unused; *body is set to 0 (this body). Returns
// the CUDA error code of the launch.
extern "C" int cbas_attention_packed(const void* q, const void* k, const void* v, void* o,
                                     const void* cos_t, const void* sin_t, void* /*k_scratch*/,
                                     int B, int N, int H, int head_dim, int n_valid, float scale,
                                     int dtype, void* stream, int* body) {
  using namespace cbas_attention;
  if (head_dim != 64 || H % 2) return static_cast<int>(cudaErrorInvalidValue);
  *body = 0;
  return static_cast<int>(launch<64>(q, k, v, o, cos_t, sin_t, B, N, H,
                                     packed_layout(N, H, 64), n_valid, scale, dtype, stream));
}
