// What the port's fused-attention bodies share, for Hopper (sm_90a): the
// function, the Layout a head's rows are read and written through, the
// rounding of RoPE, and the passes that run before an attention kernel.
// attention_sm90.cuh (bf16: K1, K2, K3 up to 256), attention_wide.cuh (K3's
// bf16 heads above 256) and the fp32 bodies (attention_sm90_tf32*.cuh)
// include it; it holds no attention kernel of its own.
//
// The function, per head: optional rotate-half RoPE on q and k from fp32
// (N, head_dim) tables, the softmax scale folded into the q side,
// s = q.k^T in fp32, keys at or beyond n_valid masked by select and their V
// rows zeroed (NaN/Inf bits in dead rows cannot leak), an exact fp32
// softmax, o = p.V / rowsum written in the input dtype. In bf16, roped and
// scaled q and roped k are rounded to bf16 once (in fp32 before that), and
// p is rounded to bf16 before p.V.
//
// Two passes here run before a bf16 attention kernel, each one launch:
// - rope_rows, the RoPE prologue: q and/or k roped (q times the scale) into
//   scratch laid out as the output is, at an even d. The Hopper body ropes
//   K there (Q in its own blocks, at d equal to the width it is built at);
//   at a narrower d, and in the wide body, q as well.
// - stage_rows, the staging pass: q, k and v read through their strides at
//   the alignment they have (rows of d elements, any d), written into
//   scratch rows of a wider width w, the columns from d on zeros; q and k
//   roped with tables (rotate-half at any d, odd included), q times the
//   scale. The Hopper body reads heads whose rows are no 32-byte multiples
//   (d % 16 != 0) this way, at w = d rounded up to 16, since a tensor map
//   refuses rows that are no 16-byte multiple and it reads the others
//   slowly; the two-consumer body only those no 16-byte multiple (d % 8 !=
//   0); the wide body ropes an odd d with it (w = d).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cbas_attention {

constexpr int kTile = 64;          // query rows per block
constexpr float kMasked = -1e30f;  // the TPU kernels' masked-score value
constexpr int kMaxHeadDim = 256;

// Where one head's rows lie. Head h of image b starts at element
//   b * batch_stride + (h / heads_per_group) * group_stride
//     + (h % heads_per_group) * head_dim,
// and its consecutive rows (tokens) are row_stride elements apart. The
// strides come from the caller's tensors, so the same heads can be read in
// several layouts: flat (B, N, H*d) is one group of H heads at row stride
// H*d; head-major (B, H, N, d) H groups of one head; head-pair packed
// (B, H/2, N, 2d) H/2 groups of two, contiguous (row stride 2d) or as a
// strided view of a flat tensor (group stride 2d, row stride H*d). A stride
// of a dimension of size 1 is never stepped and may hold any value.
//
// An entry takes two: the inputs' (q, k and v share one) and the output's.
// The output is dense in the inputs' dim order (the wrapper allocates it so),
// so a view of a fused (B, N, 3D) projection, row stride 3D, is read in
// place and its context written at row stride D; the RoPE scratch lies as
// the output does.
struct Layout {
  long long batch_stride;
  long long group_stride;
  int heads_per_group;
  long long row_stride;
};

// Element offset of token n of head h of image b (n may be 0: the head's
// first row), head stride d within a group.
__device__ __forceinline__ size_t token_offset(const Layout& L, unsigned b, unsigned h,
                                               unsigned n, int d) {
  return static_cast<size_t>(b) * L.batch_stride +
         static_cast<size_t>(h / L.heads_per_group) * L.group_stride +
         static_cast<size_t>(h % L.heads_per_group) * d + static_cast<size_t>(n) * L.row_stride;
}

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// x * cos + rot(x) * sin for one element. Each product and the sum round
// separately (no FMA contraction), as the plain PyTorch version computes
// them, so both round the same roped values to bf16.
__device__ __forceinline__ float rope(float x, float partner, bool first_half, float c,
                                      float s) {
  const float rot = first_half ? -partner : partner;
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(rot, s));
}

constexpr int kChunk = 8;  // bf16 values per 16-byte load

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_at(const uint4& chunk, int e) {
  const auto* x2 = reinterpret_cast<const __nv_bfloat162*>(&chunk);
  return e % 2 ? __high2float(x2[e / 2]) : __low2float(x2[e / 2]);
}

// ---------------------------------------------------------------------------
// The passes that run before an attention kernel: RoPE, and staging
// ---------------------------------------------------------------------------

// The Hopper body ropes K here (Q in its own blocks); at a head width below
// the one it is built at (whose in-kernel rotation would pair the wrong
// columns) and in the wide body, Q and K both are roped here.
//
// Rounding: x * cos + rot(x) * sin in fp32 (rope(): each product and the sum
// rounded apart), times the job's scale, then one rounding to T. These are
// the plain version's rounding points (ops/flash_attention.py::_attend:
// roped q times the scale rounded once, roped k rounded once), and the
// same values the Hopper body computes as it ropes its own Q tile.

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive fp32 table values in 16- or 8-byte loads (V % 4 == 0 needs a
// 16-byte aligned p, V == 2 an 8-byte aligned one).
template <int V>
__device__ __forceinline__ void load_table(const float* __restrict__ p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[j];
      x[4 * j] = f.x, x[4 * j + 1] = f.y, x[4 * j + 2] = f.z, x[4 * j + 3] = f.w;
    }
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
    x[0] = *p;
  }
}

// One tensor the prologue ropes: `in` read through the inputs' Layout and
// `out` (scratch) written through the output's, tokens at or beyond n_live
// neither read nor written, each value times `scale` after the rotation.
template <typename T>
struct RopeJob {
  const T* in;
  T* out;
  int n_live;
  float scale;
};

// Job blockIdx.y (0: a, 1: b). Token n of head h of image b starts where L
// says in the input and where Lo says in the scratch, with head stride d
// within a group. One thread takes V consecutive
// columns [c, c + V) of the first half and their partners [c + d/2, +V),
// threads ordered (b, n, h, c) with c fastest, so a token's threads share its
// table row in L1. d is even (stage_rows ropes an odd one). Thread
// indices are 32-bit (the host checks that they fit): a 64-bit division a
// thread per index cost more issue slots than the memory-bound pass hides.
template <typename T, int V>
__global__ void __launch_bounds__(256)
rope_rows(const RopeJob<T> a, const RopeJob<T> b, const float* __restrict__ cos_t,
          const float* __restrict__ sin_t, int B, int H, int d, Layout L, Layout Lo) {
  const RopeJob<T> job = blockIdx.y ? b : a;
  const unsigned half = d / 2;
  const unsigned per_row = half / V;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned r = i / per_row;  // (b, n, h), h fastest
  if (r >= static_cast<unsigned>(B) * H * job.n_live) return;
  const unsigned c = (i - r * per_row) * V;
  const unsigned bn = r / H;
  const unsigned h = r - bn * H;
  const unsigned bi = bn / job.n_live;
  const unsigned n = bn - bi * job.n_live;
  const size_t off = token_offset(L, bi, h, n, d) + c;
  const size_t off_o = token_offset(Lo, bi, h, n, d) + c;
  const size_t t = static_cast<size_t>(n) * d + c;
  const Pack<T, V> xa = *reinterpret_cast<const Pack<T, V>*>(job.in + off);
  const Pack<T, V> xp = *reinterpret_cast<const Pack<T, V>*>(job.in + off + half);
  float ca[V], sa[V], cp[V], sp[V];
  load_table<V>(cos_t + t, ca);
  load_table<V>(sin_t + t, sa);
  load_table<V>(cos_t + t + half, cp);
  load_table<V>(sin_t + t + half, sp);
  Pack<T, V> ya, yp;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float x = to_float(xa.x[e]), p = to_float(xp.x[e]);
    ya.x[e] = from_float<T>(rope(x, p, true, ca[e], sa[e]) * job.scale);
    yp.x[e] = from_float<T>(rope(p, x, false, cp[e], sp[e]) * job.scale);
  }
  *reinterpret_cast<Pack<T, V>*>(job.out + off_o) = ya;
  *reinterpret_cast<Pack<T, V>*>(job.out + off_o + half) = yp;
}

// Launch rope_rows<T, V> at the widest V (16 bytes of T at most) that
// divides d / 2, every stride of both Layouts and the head offsets, and to
// whose bytes every base address is aligned.
template <typename T, int V>
cudaError_t launch_rope_at(int v, const RopeJob<T>& a, const RopeJob<T>& b, int jobs,
                           const float* cos_t, const float* sin_t, int B, int H, int d,
                           const Layout& L, const Layout& Lo, cudaStream_t st) {
  if constexpr (V > 1) {
    if (v < V) return launch_rope_at<T, V / 2>(v, a, b, jobs, cos_t, sin_t, B, H, d, L, Lo, st);
  }
  const int rows = jobs > 1 && b.n_live > a.n_live ? b.n_live : a.n_live;
  const long long threads = static_cast<long long>(B) * H * rows * (d / 2 / V);
  if (threads + 255 > 0xFFFFFFFFLL) return cudaErrorInvalidValue;  // 32-bit thread indices
  rope_rows<T, V><<<dim3(static_cast<unsigned>((threads + 255) / 256), jobs), 256, 0, st>>>(
      a, b, cos_t, sin_t, B, H, d, L, Lo);
  return cudaGetLastError();
}

// Rope job a, and job b if jobs == 2, on `stream`: one launch, the inputs
// read through L, the scratch written through Lo. Returns the CUDA error of
// the launch.
template <typename T>
cudaError_t launch_rope(const RopeJob<T>& a, const RopeJob<T>& b, int jobs, const float* cos_t,
                        const float* sin_t, int B, int H, int d, const Layout& L,
                        const Layout& Lo, cudaStream_t stream) {
  if (d % 2 || cos_t == nullptr || sin_t == nullptr) return cudaErrorInvalidValue;
  constexpr int kWidest = 16 / static_cast<int>(sizeof(T));
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  int v = kWidest;
  while (v > 1 && ((d / 2) % v || L.row_stride % v || L.group_stride % v || L.batch_stride % v ||
                   Lo.row_stride % v || Lo.group_stride % v || Lo.batch_stride % v ||
                   !aligned(a.in, v * sizeof(T)) || !aligned(a.out, v * sizeof(T)) ||
                   (jobs > 1 && (!aligned(b.in, v * sizeof(T)) || !aligned(b.out, v * sizeof(T)))) ||
                   !aligned(cos_t, v % 4 ? 8 : 16) || !aligned(sin_t, v % 4 ? 8 : 16)))
    v /= 2;
  return launch_rope_at<T, kWidest>(v, a, b, jobs, cos_t, sin_t, B, H, d, L, Lo, stream);
}

// One tensor the staging pass writes: `in` read through the inputs' Layout,
// `out` (scratch) written through the scratch's, tokens at or beyond n_live
// neither read nor written. With `rope` the tables' rotation first; then
// times `scale` and one rounding to T (rope's rounding points). Without
// either (scale 1, no tables) the bits pass through.
template <typename T>
struct StageJob {
  const T* in;
  T* out;
  int n_live;
  float scale;
  bool rope;
};

// Job blockIdx.y (0: a, 1: b, 2: c). One thread writes V consecutive
// columns [c0, c0 + V) of one token's scratch row of w columns (w >= d; the
// columns from d on are zeros), threads ordered (b, n, h, c) with c fastest
// as in rope_rows. It reads them U elements a load: rows of d elements lie
// at any 2-byte alignment, so U is what d, L's strides and the inputs'
// addresses allow (1 at an odd d). With tables it reads each column's
// rotate-half partner alone: with h = d / 2 and f = d - h, column i < f
// pairs with i + h (negated) and column i >= f with i - f. That is
// concat(-x[h:], x[:h]) at any d (the JAX package's rot_half), odd d
// included, and rope_rows' pairing at an even one. Token n of head h of
// image b starts where L says in the input and where Ls says in the scratch
// (head stride d and w within a group). Thread indices are 32-bit (the host
// checks that they fit).
template <typename T, int V, int U>
__global__ void __launch_bounds__(256)
stage_rows(const StageJob<T> a, const StageJob<T> b, const StageJob<T> c,
           const float* __restrict__ cos_t, const float* __restrict__ sin_t, int B, int H, int d,
           int w, Layout L, Layout Ls) {
  static_assert(V % U == 0, "a thread's columns are whole loads");
  const StageJob<T> job = blockIdx.y == 0 ? a : blockIdx.y == 1 ? b : c;
  const unsigned per_row = w / V;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned r = i / per_row;  // (b, n, h), h fastest
  if (r >= static_cast<unsigned>(B) * H * job.n_live) return;
  const int c0 = static_cast<int>(i - r * per_row) * V;
  const unsigned bn = r / H;
  const unsigned h = r - bn * H;
  const unsigned bi = bn / job.n_live;
  const unsigned n = bn - bi * job.n_live;
  const T* __restrict__ row = job.in + token_offset(L, bi, h, n, d);
  const int half = d / 2, first = d - half;
  const bool pass = !job.rope && job.scale == 1.f;
  T in[V];  // columns [c0, c0 + V); U divides d, so a load is wholly live or wholly past d
#pragma unroll
  for (int u = 0; u < V; u += U) {
    Pack<T, U> x;
    if (c0 + u < d) x = *reinterpret_cast<const Pack<T, U>*>(row + c0 + u);
#pragma unroll
    for (int e = 0; e < U; ++e) in[u + e] = x.x[e];
  }
  Pack<T, V> y;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int col = c0 + e;
    if (col >= d) {
      y.x[e] = from_float<T>(0.f);
    } else if (pass) {
      y.x[e] = in[e];
    } else {
      float x = to_float(in[e]);
      if (job.rope) {
        const bool lower = col < first;
        const size_t t = static_cast<size_t>(n) * d + col;
        x = rope(x, to_float(row[lower ? col + half : col - first]), lower, cos_t[t], sin_t[t]);
      }
      y.x[e] = from_float<T>(x * job.scale);
    }
  }
  *reinterpret_cast<Pack<T, V>*>(job.out + token_offset(Ls, bi, h, n, w) + c0) = y;
}

// stage_rows<T, V, U> at the widest load U (V elements at most) that
// divides d and every stride of L, and to whose bytes every input's base
// address is aligned.
template <typename T, int V, int U>
void launch_stage_at(int u, dim3 grid, const StageJob<T>& a, const StageJob<T>& b,
                     const StageJob<T>& c, const float* cos_t, const float* sin_t, int B, int H,
                     int d, int w, const Layout& L, const Layout& Ls, cudaStream_t stream) {
  if constexpr (U > 1) {
    if (u < U)
      return launch_stage_at<T, V, U / 2>(u, grid, a, b, c, cos_t, sin_t, B, H, d, w, L, Ls,
                                          stream);
  }
  stage_rows<T, V, U><<<grid, 256, 0, stream>>>(a, b, c, cos_t, sin_t, B, H, d, w, L, Ls);
}

// The first `jobs` of a, b and c on `stream`, one launch: the inputs read
// through L (rows d wide), the scratch written through Ls (rows w wide), a
// thread V columns: 16 bytes of T where w, every stride of Ls and every
// output's base address allow it, else one element. cos_t/sin_t are (N, d)
// fp32 tables, needed by a job with `rope`. Returns the CUDA error of the
// launch.
template <typename T>
cudaError_t launch_stage(const StageJob<T>& a, const StageJob<T>& b, const StageJob<T>& c,
                         int jobs, const float* cos_t, const float* sin_t, int B, int H, int d,
                         int w, const Layout& L, const Layout& Ls, cudaStream_t stream) {
  const StageJob<T>* all[3] = {&a, &b, &c};
  if (jobs < 1 || jobs > 3 || d <= 0 || w < d) return cudaErrorInvalidValue;
  constexpr int kWidest = 16 / static_cast<int>(sizeof(T));
  bool wide = w % kWidest == 0 && Ls.row_stride % kWidest == 0 &&
              Ls.group_stride % kWidest == 0 && Ls.batch_stride % kWidest == 0;
  int u = kWidest;  // the load: it divides d and L's strides, and every input is aligned to it
  while (u > 1 && (d % u || L.row_stride % u || L.group_stride % u || L.batch_stride % u))
    u /= 2;
  int rows = 0;
  for (int j = 0; j < jobs; ++j) {
    if (all[j]->rope && (cos_t == nullptr || sin_t == nullptr)) return cudaErrorInvalidValue;
    wide = wide && reinterpret_cast<uintptr_t>(all[j]->out) % 16 == 0;
    while (reinterpret_cast<uintptr_t>(all[j]->in) % (u * sizeof(T))) u /= 2;
    rows = all[j]->n_live > rows ? all[j]->n_live : rows;
  }
  const int v = wide ? kWidest : 1;
  const long long threads = static_cast<long long>(B) * H * rows * (w / v);
  if (threads + 255 > 0xFFFFFFFFLL) return cudaErrorInvalidValue;  // 32-bit thread indices
  const dim3 grid(static_cast<unsigned>((threads + 255) / 256), jobs);
  if (wide)
    launch_stage_at<T, kWidest, kWidest>(u, grid, a, b, c, cos_t, sin_t, B, H, d, w, L, Ls, stream);
  else
    stage_rows<T, 1, 1><<<grid, 256, 0, stream>>>(a, b, c, cos_t, sin_t, B, H, d, w, L, Ls);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The arguments every entry checks: the output's Layout groups the heads as
// the inputs' does. Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t check_args(int B, int N, int H, const Layout& L, const Layout& Lo,
                              int n_valid) {
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N || B > 65535 || H > 65535 ||
      L.heads_per_group <= 0 || H % L.heads_per_group || Lo.heads_per_group != L.heads_per_group)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace cbas_attention
