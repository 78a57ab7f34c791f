// Row LayerNorm fused with the residual add and layer scale in front of it,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/attn_probes/probe25_ln_256.py::
// make_pallas_ln's `kernel` (a row LayerNorm over (B*N, D): fp32 statistics,
// the affine, the output in the input dtype). Same function, not the same
// blocking: the probe's 4352-row VMEM blocks carry nothing over to this card.
// Beyond the probe it takes the residual that the ViT forward adds before
// every LayerNorm but the first one:
//
//   x' = x + round(h * round(lambda))      (each rounded to x's dtype, as
//                                           two eager ops round them)
//   y  = LN(x') = (x' - mean) * rsqrt(var + eps) * w + b
//
// and writes both x' (the residual stream) and y. Without h it is the
// probe's LayerNorm alone and writes y only. var is the two-pass
// mean((x' - mean)^2), or the single-pass mean(x'^2) - mean^2 clamped at 0
// (the JAX package's default on bf16).
//
// What bounds it on this card: bytes. It reads x and h once and writes x' and
// y once (8 bytes an element in bf16); the arithmetic is a few operations an
// element. The design keeps every element of a row in registers between the
// read and the writes, so nothing is read twice: one warp a row up to 4
// 16-byte chunks a lane (D <= 1024 in bf16), else 2, 4 or 8 warps a row (a
// block each) with at most 8 chunks a thread, and the sums reduced by warp
// shuffles (and shared memory across a row's warps) in fp32, in a fixed order.
// 16-byte loads and stores where D, the row strides and the pointers allow
// it, one element a thread otherwise. A row too long for registers (over 2048
// elements on the scalar path, 16384 on the vector path in bf16, 8192 in
// fp32) streams through a block of 1024 threads, reading x' back from where
// it was written.
//
// The residual stream must be bit-identical to eager torch's: the product
// and the sum are rounded to x's dtype separately, with __fmul_rn/__fadd_rn
// so the compiler cannot contract them into one FMA (eager torch runs them as
// two kernels). The statistics are summed in another order than torch's, so
// y agrees with the plain version within a tolerance (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Args {
  const void* x;    // (rows, D), row stride x_stride elements, last dim contiguous
  const void* h;    // like x (row stride h_stride), or null: no residual
  const void* lam;  // (D,) layer scale, dtype lam_code; unused without h
  const void* w;    // (D,) LayerNorm weight, dtype w_code
  const void* b;    // (D,) LayerNorm bias, dtype b_code
  void* x_out;      // (rows, D) contiguous x'; unused without h
  void* y;          // (rows, D) contiguous
  long long rows, x_stride, h_stride;
  int D, lam_code, w_code, b_code, two_pass;
  float eps;
};

constexpr int kWarpRowsPerBlock = 4;  // rows of a block in the warp-a-row mode
constexpr int kMaxWarps = 8;          // warps a row at most in registers
constexpr int kStreamThreads = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element i of a (D,) parameter of dtype code (0 float32, 1 bfloat16), as float.
__device__ __forceinline__ float param(const void* p, int code, int i) {
  return code ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// x + round(h * round(lam)), each step rounded to T.
template <typename T>
__device__ __forceinline__ T residual(T x, T h, float lam) {
  const float scale = to_f(from_f<T>(lam));
  const float prod = to_f(from_f<T>(__fmul_rn(to_f(h), scale)));
  return from_f<T>(__fadd_rn(to_f(x), prod));
}

// ((v - mean) * rstd) * w + b, each step rounded in fp32 as the plain
// version's eager ops round them.
__device__ __forceinline__ float affine(float v, float mean, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), w), b);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each of v[0..K) over the threads of a row: its warp (W = 1) or its W
// warps, through shared memory in warp order. Every thread of the block calls
// it when W > 1 (it synchronises the block).
template <int K>
__device__ __forceinline__ void row_sum(float (&v)[K], int W, float (*red)[32]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (W == 1) return;
  const int warp = threadIdx.x >> 5, first = (warp / W) * W;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int i = 0; i < W; ++i) t += red[k][first + i];
    v[k] = t;
  }
  __syncthreads();
}

// The row in registers: C chunks of V elements a thread, W warps a row
// (W = 1: kWarpRowsPerBlock rows a block; W > 1: one row a block of 32 W
// threads). Chunk c of thread r covers columns [(c * 32 W + r) V, + V); V
// divides D, so a chunk lies wholly inside the row or wholly past it.
template <typename T, int V, int C>
__global__ void __launch_bounds__(32 * kMaxWarps) add_ln_rows(Args a, int W) {
  __shared__ float red[2][32];
  const int warp = threadIdx.x >> 5;
  const int per_block = (blockDim.x >> 5) / W;
  const long long row = static_cast<long long>(blockIdx.x) * per_block + warp / W;
  if (W == 1 && row >= a.rows) return;  // the last block's idle warps (no block sync at W = 1)
  const int r = (warp % W) * 32 + (threadIdx.x & 31);
  const int stride = 32 * W * V;
  const T* x = static_cast<const T*>(a.x) + row * a.x_stride;
  const T* h = a.h ? static_cast<const T*>(a.h) + row * a.h_stride : nullptr;
  T* x_out = static_cast<T*>(a.x_out) + row * a.D;
  T* y = static_cast<T*>(a.y) + row * a.D;

  float v[C][V];
  float sums[2] = {0.f, 0.f};  // sum of x', and (single pass) of x'^2
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = r * V + c * stride;
    if (col < a.D) {
      Pack<T, V> xv = *reinterpret_cast<const Pack<T, V>*>(x + col);
      if (h) {
        const Pack<T, V> hv = *reinterpret_cast<const Pack<T, V>*>(h + col);
#pragma unroll
        for (int j = 0; j < V; ++j)
          xv.e[j] = residual(xv.e[j], hv.e[j], param(a.lam, a.lam_code, col + j));
        *reinterpret_cast<Pack<T, V>*>(x_out + col) = xv;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[c][j] = to_f(xv.e[j]);
        sums[0] += v[c][j];
        sums[1] += v[c][j] * v[c][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[c][j] = 0.f;
    }
  }
  row_sum(sums, W, red);
  const float mean = sums[0] / a.D;
  float var;
  if (a.two_pass) {
    float dev[1] = {0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (r * V + c * stride < a.D) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[c][j] - mean;
          dev[0] += d * d;
        }
      }
    }
    row_sum(dev, W, red);
    var = dev[0] / a.D;
  } else {
    var = fmaxf(sums[1] / a.D - mean * mean, 0.f);
  }
  const float rstd = rsqrtf(var + a.eps);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = r * V + c * stride;
    if (col < a.D) {
      Pack<T, V> out;
#pragma unroll
      for (int j = 0; j < V; ++j)
        out.e[j] = from_f<T>(affine(v[c][j], mean, rstd, param(a.w, a.w_code, col + j),
                                    param(a.b, a.b_code, col + j)));
      *reinterpret_cast<Pack<T, V>*>(y + col) = out;
    }
  }
}

// A row too long for registers: one block of kStreamThreads a row, one
// element a thread at a time, x' (or x) read again for each later pass.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads) add_ln_stream(Args a) {
  __shared__ float red[2][32];
  const long long row = blockIdx.x;
  const int W = kStreamThreads / 32;
  const T* x = static_cast<const T*>(a.x) + row * a.x_stride;
  const T* h = a.h ? static_cast<const T*>(a.h) + row * a.h_stride : nullptr;
  T* x_out = static_cast<T*>(a.x_out) + row * a.D;
  T* y = static_cast<T*>(a.y) + row * a.D;

  float sums[2] = {0.f, 0.f};
  for (int col = threadIdx.x; col < a.D; col += kStreamThreads) {
    T xv = x[col];
    if (h) {
      xv = residual(xv, h[col], param(a.lam, a.lam_code, col));
      x_out[col] = xv;
    }
    const float f = to_f(xv);
    sums[0] += f;
    sums[1] += f * f;
  }
  row_sum(sums, W, red);
  // Each thread reads back only the columns it wrote itself.
  const T* src = h ? x_out : x;
  const float mean = sums[0] / a.D;
  float var;
  if (a.two_pass) {
    float dev[1] = {0.f};
    for (int col = threadIdx.x; col < a.D; col += kStreamThreads) {
      const float d = to_f(src[col]) - mean;
      dev[0] += d * d;
    }
    row_sum(dev, W, red);
    var = dev[0] / a.D;
  } else {
    var = fmaxf(sums[1] / a.D - mean * mean, 0.f);
  }
  const float rstd = rsqrtf(var + a.eps);
  for (int col = threadIdx.x; col < a.D; col += kStreamThreads)
    y[col] = from_f<T>(affine(to_f(src[col]), mean, rstd, param(a.w, a.w_code, col),
                              param(a.b, a.b_code, col)));
}

template <typename T, int V, int C>
cudaError_t launch_rows(const Args& a, int W, cudaStream_t stream) {
  if (W == 1) {
    const long long blocks = (a.rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
    add_ln_rows<T, V, C><<<static_cast<unsigned>(blocks), 32 * kWarpRowsPerBlock, 0, stream>>>(a, 1);
  } else {
    add_ln_rows<T, V, C><<<static_cast<unsigned>(a.rows), 32 * W, 0, stream>>>(a, W);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // Warps a row: one while a lane holds at most 4 chunks, else the fewest
  // (a power of two up to kMaxWarps) at which a thread holds at most 4; then
  // the chunks a thread holds, up to 8, or the streaming kernel.
  const long long chunks = (a.D + V - 1) / V;
  int W = 1;
  while (W < kMaxWarps && chunks > 32LL * W * 4) W *= 2;
  const long long C = (chunks + 32LL * W - 1) / (32LL * W);
  switch (C) {
    case 1: return launch_rows<T, V, 1>(a, W, stream);
    case 2: return launch_rows<T, V, 2>(a, W, stream);
    case 3: return launch_rows<T, V, 3>(a, W, stream);
    case 4: return launch_rows<T, V, 4>(a, W, stream);
    case 5: return launch_rows<T, V, 5>(a, W, stream);
    case 6: return launch_rows<T, V, 6>(a, W, stream);
    case 7: return launch_rows<T, V, 7>(a, W, stream);
    case 8: return launch_rows<T, V, 8>(a, W, stream);
    default:
      add_ln_stream<T><<<static_cast<unsigned>(a.rows), kStreamThreads, 0, stream>>>(a);
      return cudaGetLastError();
  }
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// The 16-byte path needs V to divide D and both row strides, and x, h and the
// outputs on 16-byte boundaries.
template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = a.D % V == 0 && a.x_stride % V == 0 && aligned16(a.x) && aligned16(a.y) &&
                   (!a.h || (a.h_stride % V == 0 && aligned16(a.h) && aligned16(a.x_out)));
  return vec ? launch<T, V>(a, stream) : launch<T, 1>(a, stream);
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (x, h and both
// outputs); lam_dtype, w_dtype, b_dtype the same codes for the (D,)
// parameters. h (with lam and x_out) is null for the LayerNorm alone. Strides
// are in elements. two_pass: 1 two-pass variance, 0 single-pass clamped at 0.
// Returns the CUDA error code of the launch (0 on success); the caller raises
// on anything else.
extern "C" int cbas_layernorm(const void* x, const void* h, const void* lam, const void* w,
                              const void* b, void* x_out, void* y, long long rows, int D,
                              long long x_stride, long long h_stride, int dtype, int lam_dtype,
                              int w_dtype, int b_dtype, float eps, int two_pass, void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7fffffffLL || !x || !w || !b || !y ||
      (h && (!lam || !x_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, h, lam, w, b, x_out, y, rows, x_stride, h_stride,
               D, lam_dtype, w_dtype, b_dtype, two_pass, eps};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, s));
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
