// The body shared by the port's three fused-attention kernels, for Hopper
// (sm_90a). Each of attention_fat.cu (K1), attention_packed.cu (K2) and
// attention_headmajor.cu (K3) includes it and binds one C entry to it; they
// differ only in where a head's rows lie (a Layout) and in the head dims they
// instantiate.
//
// The function, per head: optional rotate-half RoPE on q and k from fp32
// (N, head_dim) tables, the softmax scale folded into the q side,
// s = q.k^T in fp32, keys at or beyond n_valid masked by select and their V
// rows zeroed (NaN/Inf bits in dead rows cannot leak), an exact fp32
// softmax, o = p.V / rowsum written in the input dtype.
//
// One block per (64-query tile, head, image); a loop over 64-key tiles with
// an online softmax (running max and sum, fp32 accumulator in registers),
// in bfloat16: 4 warps, 16 query rows each, tensor-core mma.sync m16n8k16
// (bf16 in, fp32 accumulate) for q.k^T and p.V, fragments read from shared
// memory with ldmatrix. Roped and scaled q and k are rounded to bf16 once
// (in fp32 before that), and p is rounded to bf16 before p.V; the score and
// probability tiles stay in registers (the C fragment of q.k^T is the A
// fragment of p.V).
//
// Head dims: any multiple of 8 up to 128 (bf16 at 64, 128, 192 and 256 runs
// attention_sm90.cuh's body, so K3 sends the other widths here). float32
// runs attention_sm90_tf32.cuh and attention_sm90_tf32_wide.cuh up to 256
// in every entry. The mma k-steps are 16 deep, so
// the bf16 tiles are zero-filled in shared memory up to the next multiple of
// 16: zero columns change neither q.k^T nor the live output columns. The
// RoPE partner of column c is (c + hd/2) mod hd; when hd/2 is a multiple of
// 8 a 16-byte chunk's partners form one chunk with one first-half flag,
// otherwise (hd = 40, 56, ...) they are gathered one element at a time.
// Shared memory is dynamic: at hd = 128 the bf16 tiles take 52 KB, above
// the 48 KB a block may declare statically.
// Above hd = 256 K3 takes attention_wide.cuh's body, which takes hd at run
// time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cbas_attention {

constexpr int kTile = 64;          // query rows per block, keys per loop step
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

// The first row of this block's head (blockIdx.y) of image blockIdx.z.
template <int HD>
__device__ __forceinline__ size_t head_offset(const Layout& L) {
  return token_offset(L, blockIdx.z, blockIdx.y, 0, HD);
}

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// The column RoPE pairs with column c: rot(x)[c] = -x[c + hd/2] below half,
// x[c - hd/2] above.
template <int HD>
__device__ __forceinline__ int rope_partner(int c) {
  return c < HD / 2 ? c + HD / 2 : c - HD / 2;
}

// x * cos + rot(x) * sin for one element. Each product and the sum round
// separately (no FMA contraction), as the plain PyTorch version computes
// them, so both round the same roped values to bf16.
__device__ __forceinline__ float rope(float x, float partner, bool first_half, float c,
                                      float s) {
  const float rot = first_half ? -partner : partner;
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(rot, s));
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core mma.sync
// ---------------------------------------------------------------------------

constexpr int kBf16Threads = 128;  // 4 warps x 16 query rows
constexpr int kChunk = 8;          // bf16 values per 16-byte load

template <int HD>
struct Bf16Tiles {
  static constexpr int kPad = (HD + 15) / 16 * 16;  // columns held: whole 16-deep k steps
  // Row stride kPad + 8 is an odd number of 16-byte chunks, so the 8 rows an
  // ldmatrix reads at one column hit distinct banks.
  static constexpr int kLd = kPad + 8;
  static constexpr int kKSteps = kPad / 16;
  static constexpr size_t kSmemBytes = 3 * kTile * kLd * sizeof(__nv_bfloat16);
  // Blocks an SM must hold, passed to __launch_bounds__, which caps the
  // registers to fit them: without it ptxas takes 103 registers at d = 64
  // (4 blocks an SM) and 172 at d = 128 (2 blocks). Capped at 96 and 168,
  // with a few bytes of spills, both ran faster on an H100 (PERF.md).
  static constexpr int kMinBlocks = HD <= 64 ? 5 : 3;
};

// d = a * b + d for one m16n8k16 tile: bf16 A (4 regs) and B (2 regs), fp32 D.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane i gives the address of row
// i % 8 of matrix i / 8 and receives, of matrix j, row i / 4, columns
// 2 (i % 4) and 2 (i % 4) + 1 (with .trans: that column pair of the transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Two matrices: lanes 0-15 give the addresses (the others are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_at(const uint4& chunk, int e) {
  const auto* x2 = reinterpret_cast<const __nv_bfloat162*>(&chunk);
  return e % 2 ? __high2float(x2[e / 2]) : __low2float(x2[e / 2]);
}

// Columns [c, c + 8) of token n of one head (`row` points at the token's
// column 0) as 8 bf16 values in one 16-byte chunk. With tables, RoPE is
// applied in fp32, then `scale`, then one rounding to bf16; with neither,
// the bits pass through. Needs 16-byte aligned rows (checked by the wrapper;
// HD % 8 == 0 keeps every row aligned).
template <int HD>
__device__ __forceinline__ uint4 rope_chunk(const __nv_bfloat16* __restrict__ row, int c, int n,
                                            const float* __restrict__ cos_t,
                                            const float* __restrict__ sin_t, float scale) {
  uint4 out = *reinterpret_cast<const uint4*>(row + c);
  if (cos_t == nullptr && scale == 1.f) return out;
  float x[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) x[e] = bf16_at(out, e);
  if (cos_t != nullptr) {
    const float4* c4 = reinterpret_cast<const float4*>(cos_t + n * HD + c);
    const float4* s4 = reinterpret_cast<const float4*>(sin_t + n * HD + c);
    const float4 ca = c4[0], cb = c4[1], sa = s4[0], sb = s4[1];
    const float cs[kChunk] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    const float sn[kChunk] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    if constexpr ((HD / 2) % kChunk == 0) {
      // The chunk's partners are one chunk, all in the other half.
      const uint4 partner = *reinterpret_cast<const uint4*>(row + rope_partner<HD>(c));
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        x[e] = rope(x[e], bf16_at(partner, e), c < HD / 2, cs[e], sn[e]);
    } else {
      // The chunk straddles the half: gather each partner.
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        x[e] = rope(x[e], __bfloat162float(row[rope_partner<HD>(c + e)]), c + e < HD / 2, cs[e],
                    sn[e]);
    }
  }
  auto* o32 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int e = 0; e < kChunk / 2; ++e) o32[e] = pack_bf16(x[2 * e] * scale, x[2 * e + 1] * scale);
  return out;
}

// Copy rows [row0, row0 + 64) of one head into shared memory as bf16, in
// 16-byte chunks of 8 values (rope_chunk). Rows at or beyond `live_rows`, and
// the pad columns [HD, kPad), load as 0.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* __restrict__ dst,
                                               const __nv_bfloat16* __restrict__ head, int row0,
                                               int live_rows, long long row_stride,
                                               const float* __restrict__ cos_t,
                                               const float* __restrict__ sin_t, float scale) {
  using T = Bf16Tiles<HD>;
  constexpr int kChunksPerRow = T::kPad / kChunk;
  for (int i = threadIdx.x; i < kTile * kChunksPerRow; i += kBf16Threads) {
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * kChunk;
    const int n = row0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (n < live_rows && c < HD)
      out = rope_chunk<HD>(head + static_cast<size_t>(n) * row_stride, c, n, cos_t, sin_t, scale);
    *reinterpret_cast<uint4*>(dst + r * T::kLd + c) = out;
  }
}

// One block: query rows [blockIdx.x * 64, +64) of head blockIdx.y of image
// blockIdx.z. Warp w owns query rows 16 w .. 16 w + 15 of the tile. In the
// mma fragments, lane = 4 g + t holds rows g and g + 8 and columns 2 t, 2 t + 1
// of each 8-wide tile.
template <int HD>
__global__ void __launch_bounds__(kBf16Threads, Bf16Tiles<HD>::kMinBlocks)
attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t, int N,
               Layout L, Layout Lo, int n_valid, float scale) {
  using T = Bf16Tiles<HD>;
  constexpr int kKSteps = T::kKSteps;
  constexpr int kLd = T::kLd;
  auto* sq = reinterpret_cast<__nv_bfloat16*>(dynamic_smem());
  __nv_bfloat16* sk = sq + kTile * kLd;
  __nv_bfloat16* sv = sk + kTile * kLd;

  const int q0 = blockIdx.x * kTile;
  const size_t head_off = head_offset<HD>(L);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int mi = lane / 8;  // the 8x8 matrix this lane addresses in ldmatrix
  const int mr = lane % 8;  // and its row

  load_tile_bf16<HD>(sq, q + head_off, q0, N, L.row_stride, cos_t, sin_t, scale);
  __syncthreads();

  // This warp's 16 x kPad Q slice as A fragments, one per 16-wide k step:
  // matrices (rows 0-7, cols +0), (rows 8-15, +0), (rows 0-7, +8), (rows 8-15, +8).
  const __nv_bfloat16* q_frag = sq + (16 * warp + 8 * (mi % 2) + mr) * kLd + 8 * (mi / 2);
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qa[kk], q_frag + 16 * kk);

  float acc[2 * kKSteps][4] = {};       // O: tiles of 8 output dims
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum

  const int n_key_tiles = (n_valid + kTile - 1) / kTile;  // tiles past n_valid add zeros
  for (int kt = 0; kt < n_key_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp has finished with the previous K and V
    load_tile_bf16<HD>(sk, k + head_off, k0, n_valid, L.row_stride, cos_t, sin_t, 1.f);
    load_tile_bf16<HD>(sv, v + head_off, k0, n_valid, L.row_stride, nullptr, nullptr, 1.f);
    __syncthreads();

    // S = Q K^T over 8 tiles of 8 keys. B[kd][key] = K[key][kd]: one x4 load
    // gives the B fragments of two 16-wide k steps, an x2 load those of one.
    float s[8][4] = {};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int kp = 0; kp < kKSteps / 2; ++kp) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + (8 * j + mr) * kLd + 32 * kp + 8 * mi);
        mma_bf16(s[j], qa[2 * kp], b[0], b[1]);
        mma_bf16(s[j], qa[2 * kp + 1], b[2], b[3]);
      }
      if constexpr (kKSteps % 2) {
        uint32_t b[2];
        ldmatrix_x2(b, sk + (8 * j + mr) * kLd + 16 * (kKSteps - 1) + 8 * (mi % 2));
        mma_bf16(s[j], qa[kKSteps - 1], b[0], b[1]);
      }
    }

    // Only the last tile can hold dead keys: mask them by select. Their p is
    // then exactly 0 (every row has a live key, so its max is finite).
    if (k0 + kTile > n_valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= n_valid) s[j][e] = kMasked;
    }

    // Online softmax over rows g (s[j][0..1]) and g + 8 (s[j][2..3]); a row's
    // 64 scores are spread over the 4 lanes t = 0..3 of one quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - mx[e / 2]);
        rs[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * kKSteps; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the C fragments of score tiles 2 kk and 2 kk + 1 are the A
    // fragment of key step kk. B[key][dim] = V[key][dim]: one transposing x4
    // load gives the B fragments of two 8-wide dim tiles.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < kKSteps; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + (16 * kk + 8 * (mi % 2) + mr) * kLd + 16 * jp + 8 * (mi / 2));
        mma_bf16(acc[2 * jp], pa, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], pa, b[2], b[3]);
      }
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    __nv_bfloat16* out = o + head_offset<HD>(Lo) + static_cast<size_t>(row) * Lo.row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)  // the pad columns' tiles are not written
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// The RoPE prologue of the bodies that rope before their attention kernel
// ---------------------------------------------------------------------------

// The Hopper body ropes K here (Q in its own blocks); at a head width it
// runs padded (d below the built width, whose in-kernel rotation would pair
// the wrong columns) and in the wide body, Q and K both are roped here.
//
// Rounding: x * cos + rot(x) * sin in fp32 (rope(): each product and the sum
// rounded apart), times the job's scale, then one rounding to T. These are
// ops/flash_attention.py::_rope_heads's rounding points, and so the plain
// version's (roped q times the scale rounded once, roped k rounded once),
// and the same values rope_chunk computes in the bodies that rope as they
// load.

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
// table row in L1. d is even (an odd head is roped by the wrapper). Thread
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

// Launch one head dim's kernel on `stream`: q, k and v read through L, o
// written through Lo. dtype: 1 = bfloat16 (float32, 0, runs the fp32 Hopper
// bodies). cos_t/sin_t are (N, HD) fp32 tables or both null (no RoPE).
// Returns the CUDA error of the launch (cudaSuccess when it was queued).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                   const void* sin_t, int B, int N, int H, Layout L, Layout Lo, int n_valid,
                   float scale, int dtype, void* stream) {
  static_assert(HD % 8 == 0 && HD <= 128, "head dims are multiples of 8 up to 128");
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  if (dtype != 1) return cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  constexpr size_t bytes = Bf16Tiles<HD>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_bf16<HD><<<grid, kBf16Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), N, L, Lo, n_valid,
      scale);
  return cudaGetLastError();
}

}  // namespace cbas_attention
