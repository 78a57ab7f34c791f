// K3: fused attention forward over the head-major (B, H, N, d) layout, for
// Hopper (sm_90a), at any d: the bf16 bodies built at 64, 96, 128, 160 and
// 192 (one consumer warpgroup) and 224 and 256 (two), the fp32 bodies at
// 64, 128, 192 and 256, and in each dtype a body that takes d at run time
// above 256.
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
// - bfloat16 at every d up to 192: the Hopper body (attention_sm90.cuh: TMA
//   ring, wgmma, RoPE once per token and head) at the next of 64, 96, 128,
//   160 and 192 (bf16_width: each product at d rounded up to 32 columns),
//   in place; from 193 to 256 the two-consumer body (attention_sm90_ws.cuh:
//   a producer warpgroup handing its registers by setmaxnreg to two
//   consumer warpgroups of 64 rows that take turns on the tensor cores) at
//   224 or 256; at 256 it ran 20-34% faster at every timed row, so the
//   one-warpgroup body is not built above 192. The rule is measured
//   (PERF.md): at 192 the two-consumer body tied at N = 1205 and lost 5-9%
//   of device time at N = 261, where the last 128-row block of each head
//   has one live consumer. Both read the same input forms: their tensor
//   maps read the heads at d (columns beyond load as zeros, the store clips
//   them; with tables the RoPE prologue ropes q and k first where d is
//   below the built width) where the body reads such rows fast: the Hopper
//   body at d % 16 == 0, the two-consumer body at d % 8 == 0 (rows off 32
//   bytes, d % 16 == 8, ran there within 5% of the staged route's body; O
//   by TMA stores at 256, by 16-byte stores at 224). At any other d one
//   staging launch (stage_rows, attention_common.cuh) copies q, k and v,
//   roped with tables, into scratch rows of d rounded up to 16, and the
//   body's epilogue writes O with plain stores (launch_staged);
// - float32 at every multiple of 4 up to 128: its fp32 counterpart
//   (attention_sm90_tf32.cuh: the same ring and maps, 3xTF32 on wgmma, K and
//   V split and roped once a call by a prologue), at 64 or 128, maps at d;
// - float32 at every multiple of 4 from 132 to 256: that body's wide form
//   (attention_sm90_tf32_wide.cuh: two warpgroups, each owning half of d),
//   at 192 or 256, maps at d;
// - float32 at any d above 256: its slices body
//   (attention_sm90_tf32_slices.cuh: the same arithmetic, O in 384-column
//   slices, d at run time, Q staged without the TMA);
// - bfloat16 at any d above 256: the wide body (attention_wide.cuh: O in
//   384-column slices, the scores formed once a slice, on wgmma with two
//   consumer warpgroups; an odd d's RoPE by the staging launch).
// The wrapper (ops/flash_attention.py::fused_attention) still copies one
// case first: float32 up to 256 at a d that is no multiple of 4, zero-padded
// to the next one (and, with RoPE tables at an odd d, roped there first:
// rotate-half pairs element i with i + d/2 rounded down, a pairing no zero
// pad keeps).

#include "attention_sm90_tf32_slices.cuh"
#include "attention_sm90_ws.cuh"
#include "attention_wide.cuh"

namespace {

// bfloat16 at HD = bf16_width(d): up to 192 on the Hopper body, from 193 to
// 256 on the two-consumer body (sm90_route 1 and 6); in place on maps at d
// where the body reads such rows fast (the Hopper body at d % 16 == 0, the
// two-consumer body at d % 8 == 0: sm90_ws::kRowUnit), or through the
// staging launch, which *prologues counts.
template <int HD>
int run(const void* q, const void* k, const void* v, void* o, const void* cos_t,
        const void* sin_t, void* q_scratch, void* k_scratch, int B, int N, int H, int d,
        const cbas_attention::Layout& L, const cbas_attention::Layout& Lo, int n_valid,
        float scale, void* stream, int* prologues) {
  using namespace cbas_attention;
  constexpr bool ws = HD > 192;
  cudaError_t err;
  if (d % (ws ? sm90_ws::kRowUnit : sm90::kStageUnit) == 0) {
    if constexpr (ws)
      err = sm90_ws::launch<HD>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                                n_valid, scale, stream);
    else
      err = sm90::launch<HD>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                             n_valid, scale, stream);
  } else {
    *prologues = 1;
    if constexpr (ws)
      err = sm90_ws::launch_staged<HD>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d,
                                       L, Lo, n_valid, scale, stream);
    else
      err = sm90::launch_staged<HD>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L,
                                    Lo, n_valid, scale, stream);
  }
  return static_cast<int>(err);
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
// head_dim is d, any d >= 1 (float32 up to 256 a multiple of 4). Tables at
// an odd d: bfloat16 only. batch_stride, group_stride (between heads) and
// row_stride are q's (k's and v's) element strides, the o_ ones o's (its
// dims in q's order, dense). dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t
// are (N, d) fp32 tables or both null. Scratch, by body:
// - bfloat16 up to 256 read in place (d % 16 == 0 up to 192, d % 8 == 0
//   above): with tables k_scratch, and at d below bf16_width(d) also
//   q_scratch, laid out like o (roped keys and queries); null otherwise;
// - bfloat16 up to 256 at any other d: q_scratch of B * H * N * w and
//   k_scratch of 2 * B * H * N * w elements, w = d rounded up to 16 (the
//   staged q, and k and v), with tables or without;
// - bfloat16 above 256: with tables q_scratch and k_scratch laid out like o;
// - float32 (bodies 3, 4 and 5): k_scratch is the prologue's scratch,
//   4 * B * H * tf32::scratch_keys(n_valid) * tf32_width(d) floats, with
//   tables or without.
// *body is set to the body that ran (sm90_route): 1 the Hopper body, 2 the
// wide body, 3 the fp32 Hopper body, 4 its wide form
// (attention_sm90_tf32_wide.cuh), 5 its slices body
// (attention_sm90_tf32_slices.cuh), 6 the two-consumer body
// (attention_sm90_ws.cuh); *prologues to the launches it queued
// before the attention kernel besides the RoPE prologue (0 or 1): the fp32
// bodies' split_kv, or bf16's staging pass (stage_rows). Returns the CUDA
// error code of the launch (0 on success).
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
  const int d = head_dim;
  *body = sm90_route(dtype, d);
  switch (*body) {
    case 1:
    case 6:
      switch (bf16_width(d)) {
        case 64:
          return run<64>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                         n_valid, scale, stream, prologues);
        case 96:
          return run<96>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                         n_valid, scale, stream, prologues);
        case 128:
          return run<128>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                          n_valid, scale, stream, prologues);
        case 160:
          return run<160>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                          n_valid, scale, stream, prologues);
        case 192:
          return run<192>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                          n_valid, scale, stream, prologues);
        case 224:
          return run<224>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                          n_valid, scale, stream, prologues);
        case 256:
          return run<256>(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L, Lo,
                          n_valid, scale, stream, prologues);
      }
      break;
    case 2:
      return static_cast<int>(wide::launch(q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H,
                                           d, L, Lo, n_valid, scale, stream, prologues));
    case 3:
    case 4:
    case 5:
      return run_tf32(q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, d, L, Lo, n_valid, scale,
                      stream, prologues);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// C entry of the bf16 staging pass alone (stage_rows, as launch_staged runs
// it before the Hopper body), bound with ctypes: q, k and v head-major
// (B, H, N, head_dim) bf16 at the given element strides (batch, head, row;
// the last dim contiguous), at any alignment, into `out`, a contiguous
// (3, B, H, N, w) bf16 tensor, w = head_dim rounded up to 16: q roped with
// the (N, head_dim) fp32 tables (or not, both null) and times `scale`, k
// roped, v as it is, rows of k and v at or beyond n_valid not written, the
// columns from head_dim on zeros. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int cbas_attention_bf16_stage(const void* q, const void* k, const void* v, void* out,
                                         const void* cos_t, const void* sin_t, int B, int N, int H,
                                         int head_dim, long long batch_stride,
                                         long long group_stride, long long row_stride,
                                         int n_valid, float scale, void* stream) {
  using namespace cbas_attention;
  using T = __nv_bfloat16;
  const int d = head_dim;
  const int w = (d + sm90::kStageUnit - 1) / sm90::kStageUnit * sm90::kStageUnit;
  const Layout L{batch_stride, group_stride, 1, row_stride};
  const Layout Ls{static_cast<long long>(H) * N * w, static_cast<long long>(N) * w, 1, w};
  if (check_args(B, N, H, L, Ls, n_valid) != cudaSuccess || d <= 0 ||
      (cos_t == nullptr) != (sin_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = static_cast<size_t>(B) * H * N * w;
  T* qs = static_cast<T*>(out);
  const bool rope = cos_t != nullptr;
  return static_cast<int>(launch_stage<T>(
      StageJob<T>{static_cast<const T*>(q), qs, N, scale, rope},
      StageJob<T>{static_cast<const T*>(k), qs + plane, n_valid, 1.f, rope},
      StageJob<T>{static_cast<const T*>(v), qs + 2 * plane, n_valid, 1.f, false}, 3,
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), B, H, d, w, L, Ls,
      static_cast<cudaStream_t>(stream)));
}
