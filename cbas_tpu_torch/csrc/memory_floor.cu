// The memory floor: o = q + 0*k + 0*v over three equal tensors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dma_kernel of benchmarks/attn_probes/
// probe14_dma_floor_256.py (:40, its pallas_call sites :51 in make_dma, 3-D
// blocks of (pairs, N, 128), and :63 in make_dma_flat2d, one flat (rows,
// 128) array) and of probe15_marginal_256.py (:45, the pallas_call :50,
// f_dma). The probes time it to learn what moving the bytes of an attention
// call (q, k and v read once, o written once) costs on their chip, apart
// from any arithmetic; chip_smoke.py times this kernel at the bytes of each
// attention row of PERF.md, so a kernel's bound can be stated against the
// card's measured rate beside its 3.35 TB/s peak.
//
// It computes the expression itself, not a copy of q: a NaN or an Inf in k
// or v makes o NaN, and q's -0 becomes +0 where k or v is non-negative
// (-0 + +0). Each element is widened to fp32, the two products and the two
// sums are rounded apart in the expression's order ((q + k*0) + v*0; every
// result is exact), and the sum is rounded back to the dtype, as PyTorch's
// kernels compute the same expression, so the two agree bit for bit.
//
// What bounds it on this card: bytes only, 4 * rows * width elements moved.
// What the design does about it: 16-byte vector loads and stores (8 bf16 or
// 4 fp32 values), a grid-stride loop over as many blocks as the card holds
// resident (8 of 256 threads an SM), so every SM keeps 2048 threads' loads
// in flight, and one thread of block 0 finishes the tail of a size that is
// no multiple of the vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// (q + k*0) + v*0 for one element, each operation rounded on its own (no
// FMA contraction) as the expression is evaluated eagerly.
template <typename T>
__device__ __forceinline__ void floor_one(const T* q, const T* k, const T* v, T* o) {
  store(o, __fadd_rn(__fadd_rn(to_float(*q), __fmul_rn(to_float(*k), 0.f)),
                     __fmul_rn(to_float(*v), 0.f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
memory_floor(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, long long n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const long long n_vec = n / kVec;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n_vec;
       i += step) {
    const uint4 a = reinterpret_cast<const uint4*>(q)[i];
    const uint4 b = reinterpret_cast<const uint4*>(k)[i];
    const uint4 c = reinterpret_cast<const uint4*>(v)[i];
    uint4 r;
    const T* qa = reinterpret_cast<const T*>(&a);
    const T* kb = reinterpret_cast<const T*>(&b);
    const T* vc = reinterpret_cast<const T*>(&c);
    T* ro = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int e = 0; e < kVec; ++e) floor_one(qa + e, kb + e, vc + e, ro + e);
    reinterpret_cast<uint4*>(o)[i] = r;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (long long i = n_vec * kVec; i < n; ++i) floor_one(q + i, k + i, v + i, o + i);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long n,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const long long wanted = (n / kVec + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(wanted < 1 ? 1 : wanted < sms * kBlocksPerSM ? wanted
                                                                                 : sms * kBlocksPerSM);
  memory_floor<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(q),
                                                   static_cast<const T*>(k),
                                                   static_cast<const T*>(v), static_cast<T*>(o), n);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes: o = q + 0*k + 0*v over rows * width elements
// of four contiguous tensors whose base addresses are 16-byte multiples (the
// wrapper checks both). dtype: 0 = float32, 1 = bfloat16. Returns the CUDA
// error of the launch (0 on success).
extern "C" int cbas_memory_floor(const void* q, const void* k, const void* v, void* o,
                                 long long rows, long long width, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n = rows * width;
  if (rows < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (dtype == 0) return static_cast<int>(launch<float>(q, k, v, o, n, st));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(q, k, v, o, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
