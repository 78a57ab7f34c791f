// K3: fused attention forward over the head-major (B, H, N, d) layout, for
// Hopper (sm_90a), d any multiple of 8 up to 128.
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention): the JAX package's route for every head dim other
// than 64 and for odd head counts. Same function as K1 and K2; the body is
// attention_common.cuh's, instantiated once per head dim, read at row stride
// d with head h at h * N * d of its image.
//
// What bounds it on this card: at d = 128 (DINOv3 ViT-7B's 32 heads) each
// block does twice K1's q.k^T and p.V work per tile, with the same softmax,
// so the tensor-core share grows; the O accumulator doubles to 64 fp32
// registers a thread (beside 32 of Q fragments and 32 of scores), which
// bounds how many blocks share an SM: left alone, ptxas takes 172 registers
// and fits 2 blocks; the body caps it at 168 for 3 (a few bytes of spills,
// about 28% faster on an H100). The tiles outgrow static shared memory
// (52 KB in bf16, 99 KB in fp32), so they are dynamic. Head dims that are
// not a multiple of 16 are zero-filled to one in shared memory, and those
// whose half is not a multiple of 8 gather RoPE partners one element at a
// time: both cost only such rare widths.

#include "attention_common.cuh"

namespace {

template <int HD>
int run(const void* q, const void* k, const void* v, void* o, const void* cos_t,
        const void* sin_t, int B, int N, int H, int n_valid, float scale, int dtype,
        void* stream) {
  using namespace cbas_attention;
  return static_cast<int>(launch<HD>(q, k, v, o, cos_t, sin_t, B, N, H,
                                     headmajor_layout(N, H, HD), n_valid, scale, dtype, stream));
}

}  // namespace

// C entry, bound with ctypes. head_dim is d (a multiple of 8, at most 128).
// dtype: 0 = float32, 1 = bfloat16. cos_t/sin_t are (N, d) fp32 tables or
// both null. Returns the CUDA error code of the launch (0 on success).
extern "C" int cbas_attention_headmajor(const void* q, const void* k, const void* v, void* o,
                                        const void* cos_t, const void* sin_t, int B, int N,
                                        int H, int head_dim, int n_valid, float scale,
                                        int dtype, void* stream) {
#define CBAS_HEAD_DIM(D) \
  case D:                \
    return run<D>(q, k, v, o, cos_t, sin_t, B, N, H, n_valid, scale, dtype, stream);
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CBAS_HEAD_DIM
}
