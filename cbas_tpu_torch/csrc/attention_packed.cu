// K2: fused attention forward over the head-pair packed (B, H/2, N, 128)
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_packed_attn_kernel
// (entry fused_attention_packed): two 64-wide heads side by side on the last
// dim, (N, 64) RoPE tables shared by both. Same function as K1 and K3.
//
// Layout: H/2 groups of two heads; the caller's strides say where they lie.
// Contiguous packed tensors have row stride 128 and group stride N*128. The
// port's own caller passes strided views of one fused (B, N, 3*H*64) q|k|v
// projection instead (group stride 128, row stride 3*H*64), so it copies
// neither q, k and v in nor the output out: o is written dense in q's dim
// order, empty(B, N, H/2, 128).transpose(1, 2), whose flat (B, N, H*64)
// view feeds the out-projection.
// The rows of a head are 128 bytes wherever they lie, so the tiles a block
// reads are K1's.
//
// bfloat16 takes the Hopper body (attention_sm90.cuh: TMA ring, wgmma, RoPE
// once per token and head), whose tensor maps are built from the same
// strides: the packed view of a flat tensor gets K1's map with its heads in
// pairs. float32 takes its fp32 counterpart (attention_sm90_tf32.cuh: the
// same ring and maps, 3xTF32 on wgmma, K and V split once a call by a
// prologue that reads them through the same Layout).
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

#include "attention_sm90_tf32.cuh"

// C entry, bound with ctypes, with the flat and head-major entries'
// signature. H is the head count (twice the pairs, so even); head_dim must be
// 64. batch_stride, group_stride (between pairs) and row_stride are q's (k's
// and v's) element strides, the o_ ones o's: 16-byte multiples, the last dim
// contiguous, o's dims in q's order. dtype: 0 = float32, 1 = bfloat16.
// cos_t/sin_t are (N, 64) fp32 tables or both null. q_scratch is unused;
// k_scratch is, in bfloat16, a buffer laid out like o for the roped keys,
// needed with tables (null otherwise); in float32 the fp32 body's scratch
// (attention_fat.cu's entry says its size), needed either way.
// *body is set to the body that ran (sm90_route: 1 or 3; the entry takes
// nothing else), *prologues to the fp32 body's prologue launches it queued
// (0 or 1). Returns the CUDA error code of the launch.
extern "C" int cbas_attention_packed(const void* q, const void* k, const void* v, void* o,
                                     const void* cos_t, const void* sin_t, void* /*q_scratch*/,
                                     void* k_scratch, int B, int N, int H, int head_dim,
                                     long long batch_stride,
                                     long long group_stride, long long row_stride,
                                     long long o_batch_stride, long long o_group_stride,
                                     long long o_row_stride, int n_valid, float scale, int dtype,
                                     void* stream, int* body, int* prologues) {
  using namespace cbas_attention;
  *prologues = 0;
  if (head_dim != 64 || H % 2) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, group_stride, 2, row_stride};
  const Layout Lo{o_batch_stride, o_group_stride, 2, o_row_stride};
  *body = sm90_route(dtype, head_dim);
  if (*body == 1)
    return static_cast<int>(sm90::launch<64>(q, k, v, o, cos_t, sin_t, nullptr, k_scratch, B, N, H,
                                             64, L, Lo, n_valid, scale, stream));
  if (*body == 3)
    return static_cast<int>(tf32::launch<64>(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, 64, L,
                                             Lo, n_valid, scale, stream, prologues));
  return static_cast<int>(cudaErrorInvalidValue);
}
