// The K-transposing relayout, for Hopper (sm_90a): flat (B, N, D) to
// (B, D, N), which is (B*H, d, N) for D = H*d heads: out[b*H + h, c, n] =
// x[b, n, h*d + c], bit for bit.
//
// Replaces the TPU kernel relayout_kt_kernel of benchmarks/attn_probes/
// probe26_layouts_256.py (:154, its pallas_call :163, (448, 272, 768) bf16),
// which prices producing a transposed K (the input of the probe's
// batched_kt_kernel and fatq_kt_kernel, and of csrc/attention_batched.cu's
// transposed forms) from the projection's flat output. No route calls it.
//
// What bounds it on this card: bytes only (x read once, the output written
// once). What the design does about it: a block transposes one 64-token x
// 64-column tile through shared memory, reading each token's 128 bytes with
// 16-byte loads and writing each output row's 128 bytes with 16-byte stores,
// 8 lanes a row, so both sides move whole lines. The tile's rows are 66
// columns apart (132 bytes), so the 16-bit gathers of a column hit at most
// two lanes a bank. x may be a strided view (its batch and row strides 16-byte
// multiples, its columns contiguous); N and D are multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // tokens and columns of a tile
constexpr int kPitch = 66;     // bf16 elements between a tile's rows in shared memory
constexpr int kThreads = 256;
constexpr int kChunks = kTile * kTile / 8;  // 16-byte chunks of a tile

__global__ void __launch_bounds__(kThreads)
relayout_kt(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, int N, int D,
            long long batch_stride, long long row_stride) {
  __shared__ __align__(16) uint16_t tile[kTile * kPitch];
  const int n0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  const long long b = blockIdx.z;
  const int cols = min(kTile, D - c0);
  const int rows = min(kTile, N - n0);
  // Load: chunk i is token i / 8, columns 8 (i % 8) .. +8; eight lanes a token.
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int r = i / 8, c = (i % 8) * 8;
    if (r >= rows || c >= cols) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(x + b * batch_stride + (n0 + r) * row_stride + c0 + c);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + r * kPitch + c);  // 4-byte aligned
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = w[e];
  }
  __syncthreads();
  // Store: chunk i is output row (column) i / 8, tokens 8 (i % 8) .. +8; eight
  // lanes write one row's 128 bytes.
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int c = i / 8, r = (i % 8) * 8;
    if (c >= cols || r >= rows) continue;
    uint4 v;
    uint16_t* h = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = tile[(r + e) * kPitch + c];
    *reinterpret_cast<uint4*>(out + (b * D + c0 + c) * N + n0 + r) = v;
  }
}

}  // namespace

// C entry, bound with ctypes: out (B, D, N), contiguous, from x (B, N, D)
// bf16 at element strides batch_stride and row_stride (columns contiguous).
// N and D multiples of 8, both strides and both base addresses 16-byte
// multiples (the wrapper checks). Returns the CUDA error of the launch.
extern "C" int cbas_relayout_kt(const void* x, void* out, int B, int N, int D,
                                long long batch_stride, long long row_stride, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || N % 8 || D % 8 || B > 65535 || batch_stride % 8 ||
      row_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, (D + kTile - 1) / kTile, B);
  relayout_kt<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), N, D, batch_stride,
      row_stride);
  return static_cast<int>(cudaGetLastError());
}
