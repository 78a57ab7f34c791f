// Pieces the whole-row attention kernels share (attention_batched.cu, the
// resident form; attention_pvt.cu, the streamed transposed form): rank-5
// tensor maps built from each operand's own strides, their TMA loads and
// stores, wgmma with both operands in shared memory, RoPE in bf16 arithmetic
// on a swizzled tile in place, and the transposed scores' column
// reductions. Each file that includes it gets its own copy (an anonymous
// namespace), so the kernels of one file do not change with the other's.

#pragma once

#include "attention_sm90.cuh"

namespace {

using namespace cbas_attention;
using namespace cbas_attention::sm90;

constexpr int kRows = 64;           // query rows of a block; keys of a tile
constexpr int kTile = kRows * 128;  // bytes of one 64 x 64 bf16 tile (one swizzle atom)

// One box of `map` at (c0, c1, c2, c3, c4) into shared memory at `dst`,
// counted on `bar` in bytes.
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store5(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// d (64 x 64, fp32) = a (64 x 16) . b (16 x 64), both bf16 in shared memory;
// a K-major (TransA 0) or MN-major (TransA 1), b K-major (TransB 0) or
// MN-major (TransB 1).
template <int TransB, int TransA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransB), "n"(TransA));
}

// The bf16 RoPE tables of one chunk pair: columns [c, c + 8) of row n and
// their partners [c + 32, c + 40), cos then sin. Loaded apart from their use,
// so a thread's loads for several pairs are in flight together (and before
// the wait for the tile they rope).
struct RopeTab {
  uint4 ca, cp, sa, sp;
};

__device__ __forceinline__ RopeTab rope_tab(const __nv_bfloat16* __restrict__ cos_t,
                                            const __nv_bfloat16* __restrict__ sin_t, int n,
                                            int c) {
  const size_t row = static_cast<size_t>(n) * kRows;
  return {*reinterpret_cast<const uint4*>(cos_t + row + c),
          *reinterpret_cast<const uint4*>(cos_t + row + c + kRows / 2),
          *reinterpret_cast<const uint4*>(sin_t + row + c),
          *reinterpret_cast<const uint4*>(sin_t + row + c + kRows / 2)};
}

// RoPE in bf16 arithmetic on a chunk pair held in registers, columns [c, c
// + 8) in xa and their partners [c + 32, c + 40) in xp: x' = bf16(bf16(x
// cos) + bf16(rot(x) sin)), rot(x) = (-x2, x1), two columns an instruction:
// each bf16x2 product and sum rounded once, as the probes' bf16 arithmetic
// is (the _rn forms: plain __hmul2 and __hadd2 may contract into one FMA).
__device__ __forceinline__ void rope_chunks(uint4& xa, uint4& xp, const RopeTab& t) {
  auto* a2 = reinterpret_cast<__nv_bfloat162*>(&xa);
  auto* p2 = reinterpret_cast<__nv_bfloat162*>(&xp);
  const auto* ca = reinterpret_cast<const __nv_bfloat162*>(&t.ca);
  const auto* cp = reinterpret_cast<const __nv_bfloat162*>(&t.cp);
  const auto* sa = reinterpret_cast<const __nv_bfloat162*>(&t.sa);
  const auto* sp = reinterpret_cast<const __nv_bfloat162*>(&t.sp);
#pragma unroll
  for (int e = 0; e < kChunk / 2; ++e) {
    const __nv_bfloat162 a = a2[e], b = p2[e];
    a2[e] = __hadd2_rn(__hmul2_rn(a, ca[e]), __hmul2_rn(__hneg2(b), sa[e]));
    p2[e] = __hadd2_rn(__hmul2_rn(b, cp[e]), __hmul2_rn(a, sp[e]));
  }
}

// rope_chunks on the chunk pair at column c of row r of a swizzled 64 x 64
// tile at `tile`, in place.
__device__ __forceinline__ void rope_pair(unsigned char* tile, int r, int c, const RopeTab& t) {
  uint4* pa = reinterpret_cast<uint4*>(tile + sw128_offset(r, c));
  uint4* pp = reinterpret_cast<uint4*>(tile + sw128_offset(r, c + kRows / 2));
  uint4 xa = *pa, xp = *pp;
  rope_chunks(xa, xp, t);
  *pa = xa;
  *pp = xp;
}

// The transposed orientation's column statistics. A thread of an m64n64
// s^T accumulator holds key rows g8 and g8 + 8 of its warp's 16 and the
// query columns 8 jj + 2 t4 + b (jj < 8, b < 2): its 16 columns, index 2 jj
// + b. col_accumulate folds a tile's two rows into them (max or sum);
// col_reduce takes the totals over the warpgroup's 64 keys: the lanes of
// one t4 by shuffles (xor 4, 8, 16), then the four warps through `red` (4 x
// 64 floats), (w0 + w1) + (w2 + w3). Every thread ends with its columns'
// totals. Named barrier `bar` orders the warpgroup's earlier reads of `red`
// before the writes, and the writes before the reads.
template <bool kMax>
__device__ __forceinline__ float col_op(float x, float y) {
  return kMax ? fmaxf(x, y) : x + y;
}

template <bool kMax>
__device__ __forceinline__ void col_accumulate(float (&c)[16], const float (&s)[32]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      c[2 * jj + b] = col_op<kMax>(c[2 * jj + b], col_op<kMax>(s[4 * jj + b], s[4 * jj + 2 + b]));
}

template <bool kMax>
__device__ __forceinline__ void col_reduce(float (&c)[16], float* red, int warp, int lane,
                                           int bar) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int x = 4; x <= 16; x *= 2) c[i] = col_op<kMax>(c[i], __shfl_xor_sync(0xffffffffu, c[i], x));
  const int t4 = lane % 4;
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kWGThreads) : "memory");
  if (lane < 4) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int b = 0; b < 2; ++b) red[warp * kRows + 8 * jj + 2 * t4 + b] = c[2 * jj + b];
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kWGThreads) : "memory");
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int col = 8 * jj + 2 * t4 + b;
      c[2 * jj + b] = col_op<kMax>(col_op<kMax>(red[col], red[kRows + col]),
                                   col_op<kMax>(red[2 * kRows + col], red[3 * kRows + col]));
    }
}

// One operand's element strides (image, group, head in group, row) and its
// dims: `inner` columns a row (the head's 64, or a transposed operand's keys)
// of which `inner_extent` are read, and `rows` rows.
struct Operand {
  const void* base;
  long long stride[4];
  int inner_extent, rows;
};

// The rank-5 bf16 map of an operand: (inner, rows, head in group, group,
// image), a box of 64 x 64, 128-byte swizzle, zeros out of bounds. A
// dimension of size 1 is never stepped; its stride is set to a valid
// 16-byte multiple. False if cuTensorMapEncodeTiled refuses it.
bool encode_operand(CUtensorMap* map, const Operand& op, int heads_per_group, int groups,
                    int images) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(op.inner_extent),
                              static_cast<cuuint64_t>(op.rows),
                              static_cast<cuuint64_t>(heads_per_group),
                              static_cast<cuuint64_t>(groups), static_cast<cuuint64_t>(images)};
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i) {
    // op.stride: image, group, head in group, row; map dims 1-4: row, head, group, image
    const long long s = op.stride[3 - i] * static_cast<long long>(sizeof(__nv_bfloat16));
    strides[i] = static_cast<cuuint64_t>(dims[i + 1] == 1 ? 16 : s);
    if (strides[i] % 16 || strides[i] == 0) return false;
  }
  const cuuint32_t box[5] = {kRows, kRows, 1, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(op.base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
