// The stage variants of the Hopper attention body (attention_sm90.cuh,
// enum Variant), for Hopper (sm_90a): timing cases of K1's, K2's and K3's
// inner loop, not a route of the model.
//
// Replaces the TPU kernels of two probes of benchmarks/attn_probes/, which
// time the packed kernel's stages at its 640x480 shape ((320 * 6, 1216, 128)
// bf16, 1205 live rows, RoPE on):
// - probe2.py:45 (make_variant's pallas_call) with its four bodies:
//   dma_kernel (:63, loads and stores only) as kDma, qk_kernel (:67, RoPE and
//   q.k^T) as kQk, nosm_kernel (:95, q.k^T then p = bf16(s) then p.V) as
//   kNoSoftmax, pipe_kernel (:126, the full function with the next pair's
//   q.k^T issued before this pair's softmax) as kPipe, redesigned for Hopper
//   as FA3's in-warpgroup overlap (q.k^T(t + 1) and p.V(t) in flight under
//   tile t + 1's softmax, a 4-stage ring, its own register budget: 2 blocks
//   an SM at d 64, 1 at 128, where ptxas builds it without spills);
// - probe4.py:46 (make_variant) with vext_kernel (:64): V extended by a
//   ones column so that p.V also gives the row sums, as kVext, and with its
//   bf16 exponential (bf16exp=True) as kVextBf16Exp.
// On the TPU a variant was a kernel of its own; here each is a compile-time
// branch of the one-warpgroup Hopper body, so the producer warp, the tensor
// maps and the store are the same in all and the difference of two
// variants' times is the cost of the stage one has and the other lacks
// (the pipe loop's ring and blocks an SM are its own: attention_sm90.cuh's
// Launch, which cbas_attention_variant_launch reports). They time that
// body's loop, the one K1-K3 run, and not the persistent body's
// (attention_sm90_persistent.cuh, a timing case). The pipe loop ran at
// 1.18-1.30x variant 0's time at the main shapes at d 64 and 1.43-1.68x at
// 128 (PERF.md), so no route takes it.
//
// What bounds it on this card: what bounds K1-K3 (attention_sm90.cuh): the
// latency of one warpgroup's chain of wgmma, softmax and wgmma a key tile.
// The variants measure that chain's links; their own bounds are the bytes of
// q, k, v and o (kDma), with the q.k^T FLOP (kQk) and with the p.V FLOP too
// (the rest).
//
// Built at head dims 64 (K1's flat and K2's packed layouts, K3's head-major)
// and 128 (K3), bfloat16 only: the widths the main path's variant-0 body runs
// at the probes' and the encoders' shapes.
//
// Beside them, the two-consumer body (attention_sm90_ws.cuh) at 128 as a
// timing case no route calls (cbas_attention_ws_variant): K3 runs the
// one-warpgroup body there, and this times the two side by side.

#include "attention_sm90_ws.cuh"

namespace {

template <int HD>
cudaError_t run(int variant, const void* q, const void* k, const void* v, void* o,
                const void* cos_t, const void* sin_t, void* k_scratch, int B, int N, int H,
                const cbas_attention::Layout& L, const cbas_attention::Layout& Lo, int n_valid,
                float scale, void* stream) {
  using namespace cbas_attention::sm90;
#define CBAS_VARIANT(V)                                                                          \
  case V:                                                                                        \
    return launch<HD, V>(q, k, v, o, cos_t, sin_t, nullptr, k_scratch, B, N, H, HD, L, Lo,     \
                         n_valid, scale, stream);
  switch (variant) {
    CBAS_VARIANT(kDma)
    CBAS_VARIANT(kQk)
    CBAS_VARIANT(kNoSoftmax)
    CBAS_VARIANT(kPipe)
    CBAS_VARIANT(kVext)
    CBAS_VARIANT(kVextBf16Exp)
    default:
      return cudaErrorInvalidValue;
  }
#undef CBAS_VARIANT
}

// Variant V's build at HD as it is launched (Launch): its threads, its
// ring's stages, the blocks an SM its registers are capped for, its dynamic
// shared memory and the blocks of its rank-4 kernel the card keeps resident
// on an SM.
template <int HD, int V>
cudaError_t traits(int* threads, int* stages, int* min_blocks, int* smem_bytes, int* resident) {
  using namespace cbas_attention::sm90;
  using T = Launch<HD, V>;
  *threads = Config<HD>::kThreads, *stages = T::kSlots, *min_blocks = T::kMinBlocks;
  *smem_bytes = static_cast<int>(T::kSmemBytes);
  const auto kernel = attention_sm90<HD, 4, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, Config<HD>::kThreads,
                                                       T::kSmemBytes);
}

template <int HD>
cudaError_t traits_at(int variant, int* threads, int* stages, int* min_blocks, int* smem_bytes,
                      int* resident) {
  using namespace cbas_attention::sm90;
#define CBAS_TRAITS(V) \
  case V:              \
    return traits<HD, V>(threads, stages, min_blocks, smem_bytes, resident);
  switch (variant) {
    CBAS_TRAITS(kFull)
    CBAS_TRAITS(kDma)
    CBAS_TRAITS(kQk)
    CBAS_TRAITS(kNoSoftmax)
    CBAS_TRAITS(kPipe)
    CBAS_TRAITS(kVext)
    CBAS_TRAITS(kVextBf16Exp)
    default:
      return cudaErrorInvalidValue;
  }
#undef CBAS_TRAITS
}

// out[i] = 2^y by ex2.approx.ftz.bf16x2 for the bf16 bit pattern y = i, every
// pattern once (two a thread, as kVextBf16Exp takes them).
__global__ void ex2_bf16x2_table(uint32_t* out) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 32768u) out[i] = cbas_attention::sm90::ex2_bf16x2((2u * i + 1u) << 16 | 2u * i);
}

}  // namespace

// C entry, bound with ctypes: K3's signature (attention_headmajor.cu) up to
// the stream, bf16 head-major (B, H, N, d) only, on the two-consumer body
// built at 128: 64 < d <= 128, d % 16 == 0 (maps at d, no staging), maps of
// rank 4 (every head-major layout K3 takes but contiguous packed). Scratch
// as K3's at that width. Returns the CUDA error code of the launches (0 on
// success; cudaErrorInvalidValue for what it does not take).
extern "C" int cbas_attention_ws_variant(const void* q, const void* k, const void* v, void* o,
                                         const void* cos_t, const void* sin_t, void* q_scratch,
                                         void* k_scratch, int B, int N, int H, int head_dim,
                                         long long batch_stride, long long group_stride,
                                         long long row_stride, long long o_batch_stride,
                                         long long o_group_stride, long long o_row_stride,
                                         int n_valid, float scale, void* stream) {
  using namespace cbas_attention;
  const int d = head_dim;
  if (d <= 64 || d > 128 || d % sm90::kStageUnit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, group_stride, 1, row_stride};
  const Layout Lo{o_batch_stride, o_group_stride, 1, o_row_stride};
  const auto st = static_cast<cudaStream_t>(stream);
  sm90::Prepared p;
  const cudaError_t err = sm90::prepare(128, q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B,
                                        N, H, d, L, Lo, n_valid, scale, true, st, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.order.rank != 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90_ws::run_kernel<128, 4, false>(p, B, N, H, n_valid, st));
}

// C entry, bound with ctypes: how variant `variant` (0, kFull, K1-K3's own
// loop, to 6) is built and launched at head_dim 64 or 128 (traits).
// Returns the CUDA error code (cudaErrorInvalidValue for a variant not
// built at that width).
extern "C" int cbas_attention_variant_launch(int variant, int head_dim, int* threads,
                                             int* stages, int* min_blocks, int* smem_bytes,
                                             int* resident) {
  if (head_dim == 64)
    return static_cast<int>(
        traits_at<64>(variant, threads, stages, min_blocks, smem_bytes, resident));
  if (head_dim == 128)
    return static_cast<int>(
        traits_at<128>(variant, threads, stages, min_blocks, smem_bytes, resident));
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry, bound with ctypes: writes the 65536 bf16 results of
// ex2.approx.ftz.bf16x2 (the exponential of kVextBf16Exp), indexed by the
// input's bit pattern, to `out`. The yardstick's bound for that variant
// (chip_smoke.py) reads where the instruction leaves the correctly rounded
// 2^y. Returns the CUDA error code of the launch.
extern "C" int cbas_ex2_bf16x2_table(void* out, void* stream) {
  ex2_bf16x2_table<<<128, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// C entry, bound with ctypes: K3's signature (attention_headmajor.cu), then
// heads_per_group and variant. heads_per_group says how the heads group
// (Layout): H for flat (B, N, H*64) tensors (group strides unused), 2 for
// head-pair packed (B, H/2, N, 128) ones, 1 for head-major (B, H, N, d).
// variant is an attention_sm90.cuh Variant other than kFull (1-6); head_dim
// 64 or 128 (64 unless head-major); dtype 1 (bfloat16). q_scratch is unused;
// k_scratch is a buffer laid out like o for the roped keys, needed with
// tables by every variant but kDma (null otherwise). *body is set to 1 (the
// Hopper body) when the arguments name a built variant, else 0. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int cbas_attention_variants(const void* q, const void* k, const void* v, void* o,
                                       const void* cos_t, const void* sin_t,
                                       void* /*q_scratch*/, void* k_scratch, int B, int N, int H,
                                       int head_dim, long long batch_stride,
                                       long long group_stride, long long row_stride,
                                       long long o_batch_stride, long long o_group_stride,
                                       long long o_row_stride, int n_valid, float scale,
                                       int dtype, void* stream, int* body, int heads_per_group,
                                       int variant) {
  using namespace cbas_attention;
  const bool grouped = heads_per_group == 1 || heads_per_group == 2 ||
                       (heads_per_group == H && group_stride == 0);
  *body = dtype == 1 && (head_dim == 64 || (head_dim == 128 && heads_per_group == 1)) &&
          grouped && H % heads_per_group == 0 && variant >= sm90::kDma &&
          variant <= sm90::kVextBf16Exp;
  if (!*body) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{batch_stride, group_stride, heads_per_group, row_stride};
  const Layout Lo{o_batch_stride, o_group_stride, heads_per_group, o_row_stride};
  const cudaError_t err =
      head_dim == 64 ? run<64>(variant, q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, L, Lo,
                               n_valid, scale, stream)
                     : run<128>(variant, q, k, v, o, cos_t, sin_t, k_scratch, B, N, H, L, Lo,
                                n_valid, scale, stream);
  return static_cast<int>(err);
}
