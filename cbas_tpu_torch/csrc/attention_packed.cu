// K2: fused attention forward over the head-pair packed (B, H/2, N, 128)
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_packed_attn_kernel
// (entry fused_attention_packed): two 64-wide heads side by side on the last
// dim, (N, 64) RoPE tables shared by both. Same function as K1 and K3.
//
// Layout: H/2 groups of two heads; the caller's strides say where they lie.
// Contiguous packed tensors have row stride 128 and group stride N*128. The
// port's own caller passes strided views of the flat (B, N, H*64)
// projections instead (group stride 128, row stride H*64), so it copies
// neither q, k and v in nor the output out: o is written with q's strides.
// The rows of a head are 128 bytes wherever they lie, so the tiles a block
// reads are K1's.
//
// bfloat16 takes the Hopper body (attention_sm90.cuh: TMA ring, wgmma, RoPE
// once per token and head), whose tensor maps are built from the same
// strides: the packed view of a flat tensor gets K1's map with its heads in
// pairs. float32, the parity instantiation, keeps attention_common.cuh's
// body, which reads through the same Layout.
//
// What bounds it on this card: what bounds K1, whose times it matches on
// contiguous tensors and on views alike (chip_smoke.py, PERF.md §6): a
// block reads the same 64 x 64 tiles through the same body. The bound is
// the bytes of q, k, v and o at N = 261 and the N^2 score work at N = 1205;
// the kernel reaches about a third of either, held back by the latency of
// one warpgroup's chain of wgmma, softmax and wgmma a key tile, and by the
// RoPE prologue's pass over K (attention_sm90.cuh). Before this body, the
// common one ran it at 12-18% of the bound, and the caller's four copies
// cost about as much again. On the TPU the packing filled 128-lane DMA
// tiles; here it buys nothing, and the port keeps it because the JAX
// package routes 64-wide heads here when the flat kernel is switched off
// (CBAS_ATTN_FAT=0). The TPU-only transposed score orientation (pvt) is
// not ported: one orientation serves.

#include "attention_sm90.cuh"

// C entry, bound with ctypes, with the flat and head-major entries'
// signature. H is the head count (twice the pairs, so even); head_dim must be
// 64. batch_stride, group_stride (between pairs) and row_stride are q's (k's,
// v's and o's) element strides: 16-byte multiples, the last dim contiguous.
// dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, 64) fp32 tables or
// both null. q_scratch is unused; k_scratch is a buffer laid out like k for
// the roped keys, needed by the Hopper body with tables (null otherwise).
// *body is set to the body that ran (sm90_route). Returns the CUDA error
// code of the launch.
extern "C" int cbas_attention_packed(const void* q, const void* k, const void* v, void* o,
                                     const void* cos_t, const void* sin_t, void* /*q_scratch*/,
                                     void* k_scratch, int B, int N, int H, int head_dim,
                                     long long batch_stride,
                                     long long group_stride, long long row_stride, int n_valid,
                                     float scale, int dtype, void* stream, int* body) {
  using namespace cbas_attention;
  if (head_dim != 64 || H % 2) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, group_stride, 2, row_stride};
  *body = sm90_route(dtype, head_dim);
  if (*body)
    return static_cast<int>(sm90::launch<64>(q, k, v, o, cos_t, sin_t, nullptr, k_scratch, B, N, H,
                                             64, L, n_valid, scale, stream));
  return static_cast<int>(launch<64>(q, k, v, o, cos_t, sin_t, B, N, H, L, n_valid, scale, dtype,
                                     stream));
}
