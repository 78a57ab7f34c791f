// The persistent Hopper body (attention_sm90_persistent.cuh) for Hopper
// (sm_90a): one entry that runs it at head dims 64 and 128 in the three
// layouts of K1, K2 and K3; a timing case that no route calls.
//
// Replaces, as K1-K3 do at those widths, the TPU kernels cbas_tpu/ops/
// flash_attention.py::_fat_kernel, ::_packed_attn_kernel and ::_attn_kernel
// (pallas_call :728, :522, :393). What bounds it, and what the persistent
// body's design does about it: attention_sm90_persistent.cuh. No route calls
// this entry: the persistent body ran slower than the one-warpgroup body
// K1-K3 run at every main shape (PERF.md §6, PR 24), so it stays a timing
// case beside their entries.

#include "attention_sm90_persistent.cuh"

// C entry, bound with ctypes: K3's signature (attention_headmajor.cu) up to
// the stream, bf16 only, then heads_per_group (H for flat (B, N, H*64)
// tensors, 2 for head-pair packed ones, 1 for head-major), 4 bytes of device
// memory for the work counter and where to write the grid's blocks. head_dim
// d: 64 - 48 .. 64 or 128 - 48 .. 128, a multiple of 16 (64 only unless
// head-major); maps at d, as K3's in-place calls. Scratch as K3's at that
// width: with tables k_scratch, and at d below the width also q_scratch,
// laid out like o. Returns the CUDA error code of the launches (0 on
// success; cudaErrorInvalidValue for what it does not take).
extern "C" int cbas_attention_persistent(const void* q, const void* k, const void* v, void* o,
                                         const void* cos_t, const void* sin_t, void* q_scratch,
                                         void* k_scratch, int B, int N, int H, int head_dim,
                                         long long batch_stride, long long group_stride,
                                         long long row_stride, long long o_batch_stride,
                                         long long o_group_stride, long long o_row_stride,
                                         int n_valid, float scale, void* stream,
                                         int heads_per_group, void* counter, int* blocks) {
  using namespace cbas_attention;
  const int d = head_dim;
  const int width = d <= 64 ? 64 : 128;
  const bool grouped = heads_per_group == 1 || heads_per_group == 2 ||
                       (heads_per_group == H && group_stride == 0);
  if (d <= 0 || d > 128 || d % sm90::kStageUnit || bf16_width(d) != width || !grouped ||
      H % heads_per_group || (heads_per_group != 1 && d != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, group_stride, heads_per_group, row_stride};
  const Layout Lo{o_batch_stride, o_group_stride, heads_per_group, o_row_stride};
  int* const n = static_cast<int*>(counter);
  const cudaError_t err =
      width == 64 ? sm90p::launch<64>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, n, B, N, H,
                                      d, L, Lo, n_valid, scale, stream, blocks)
                  : sm90p::launch<128>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, n, B, N,
                                       H, d, L, Lo, n_valid, scale, stream, blocks);
  return static_cast<int>(err);
}
