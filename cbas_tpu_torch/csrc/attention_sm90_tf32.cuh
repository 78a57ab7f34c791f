// The Hopper body of the port's fused attention in float32, built at head
// dims 64 and 128: K1 (flat, d = 64), K2 (head-pair packed, d = 64) and K3
// (head-major, every multiple of 4 up to 128) route here (attention_fat.cu,
// attention_packed.cu, attention_headmajor.cu). It serves the TPU kernels
// cbas_tpu/ops/flash_attention.py::_fat_kernel, _packed_attn_kernel and
// _attn_kernel in fp32 (preferred_element_type=jnp.float32). A K3 head
// narrower than the width it runs at (the next of 64 and 128) is read
// through tensor maps at d: Q's columns beyond d load as zeros, O's are not
// stored, the prologue writes zeros there. K3's fp32 widths from 132 to 256
// take attention_sm90_tf32_wide.cuh (this file's arithmetic and prologue,
// two warpgroups), above 256 the wide body; bfloat16 takes attention_sm90.cuh.
//
// The function is the other bodies' (optional rotate-half RoPE from fp32
// tables, the scale folded into q, s = q.k^T, keys at or beyond n_valid
// masked by select and their V rows zeroed, an exact fp32 softmax with the
// accurate expf, o = p.V / row sum), computed to fp32 accuracy on the tensor
// cores ("3xTF32", as CUTLASS's OpMultiplyAddFastF32):
//
// - Every fp32 operand x is split as hi = tf32(x) and lo = tf32(x - hi)
//   (tf32_split: round to nearest, ties away from zero, to 10 fraction bits,
//   which is cvt.rna.tf32.f32 with the 13 low bits zero by construction).
//   x - hi is exact in fp32 and |x - hi - lo| <= 2^-22 |x| (normal range).
//   A product a.b is lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, each on
//   wgmma.mma_async m64nNk8 .f32.tf32.tf32: a product of two TF32 values is
//   exact in fp32, so the tensor core's fp32 accumulation is the only
//   rounding, and the dropped lo.lo term is below 2^-22 of |a||b|. The two
//   small products are issued first, over every k-step, then the large. The
//   tensor core accumulates by truncation, so the chains are kept short: the
//   small products of q.k^T have their own accumulator, and each tile's p.V
//   its own, added to O by an fp32 FMA (with the softmax's rescale).
// - For .tf32 wgmma reads both operands K-major (its transpose bits exist
//   for 16-bit types only), so p.V needs V^T (keys contiguous). Its A
//   fragment of an 8-key step holds, per thread, columns t and t + 4 of rows
//   g and g + 8, where the accumulator of q.k^T holds columns 2t and 2t + 1:
//   so V^T keeps the keys of each group of 8 in the order
//   [0, 2, 4, 6, 1, 3, 5, 7] (kSlotOfKey), and P's accumulator registers are
//   p.V's A fragments as they stand, split in registers, with no shuffle.
// - A prologue (split_kv) prepares K and V once a call: one launch writes
//   K_hi, K_lo (roped when there are tables, pairing column c with c + d/2)
//   and V^T_hi, V^T_lo (transposed, permuted) into scratch the wrapper
//   allocates: 4 planes of B H n_keys HD fp32, n_keys = n_valid rounded up
//   to the key tile, keys at or beyond n_valid and columns from d to HD
//   written as zeros (NaN bits in dead rows never reach shared memory; the
//   score mask stays a select). ops/flash_attention.py::
//   tf32_prologue_reference is its plain version, bit for bit.
// - Q lands through the caller's strided tensor maps (map_shape, fp32,
//   32-column 128-byte swizzle atoms); the consumer ropes, scales and splits
//   it in place into Q_hi and Q_lo once a block, pairing column c with
//   c + d/2: at d = HD in 16-byte chunks, below HD with tables in 8-byte
//   pairs (d/2 is even), the columns from d to HD split as the zeros they
//   arrived as. q.k^T reads Q from shared
//   memory (Q fragments held in registers across the loop were wrong in the
//   bf16 body at d = 64, attention_sm90.cuh). P is split in registers each
//   tile and is the register A operand of p.V.
// - A TMA ring (one producer warp, "full" and "empty" mbarriers) of K and V
//   stages, each a key tile's hi and lo planes, as in the bf16 body. Shared
//   memory is the constraint: fp32 with hi and lo is 4x the bf16 body's bytes
//   a tile. 32-key stages (kKeys): q.k^T at n = 32, p.V in four k-steps of
//   8. At d = 64, Q_hi + Q_lo (32 KB) and two 16 KB stages: 3 blocks an SM;
//   at d = 128, Q (64 KB) and four 32 KB stages: one block an SM. 64-key
//   stages at d = 64 (2 blocks an SM) were timed beside them on the card:
//   6% slower at N = 261 and 4% faster at N = 1205 (PERF.md), so one width
//   serves.
//
// Grid: (ceil(N / 64) query blocks, H, B), one consumer warpgroup of 64
// query rows and one producer warp a block.
//
// What bounds it on this card: operations, at the 3xTF32 rate (495 TFLOP/s
// dense TF32 / 3 = 165 TFLOP/s of fp32-accurate products); at N = 1205 also
// L2: each of a head's 19 query blocks reads the head's K and V hi and lo
// planes (16 bytes an element), 8.9 GB a call at (32, 1205, 12, 64). The
// prologue is one pass over K and V (4 bytes read, 8 written an element of
// each).

#pragma once

#include "attention_sm90.cuh"

namespace cbas_attention {
namespace tf32 {

using sm90::fence_regs;
using sm90::HeadTiles;
using sm90::MapAddress;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int kRows = 64;        // query rows a block (one consumer warpgroup)
constexpr int kWGThreads = 128;
constexpr int kAtomCols = 32;    // fp32 columns in one 128-byte swizzle atom
constexpr int kVec = 4;          // fp32 values in one 16-byte chunk
constexpr int kKeys = 32;        // keys a ring stage holds (the key tile)
constexpr int kSplitKeys = 32;   // keys a prologue block prepares

// The order of the keys of a group of 8 in V^T: position p holds key
// [0, 2, 4, 6, 1, 3, 5, 7][p], so key r sits at kSlotOfKey(r).
__host__ __device__ constexpr int kSlotOfKey(int r) { return (r & ~7) + (r & 7) / 2 + 4 * (r & 1); }

template <int HD>
struct Config {
  static_assert(HD == 64 || HD == 128, "the fp32 Hopper body takes head dims 64 and 128");
  static constexpr int kAtoms = HD / kAtomCols;         // Q's and K's atoms (columns of d)
  static constexpr int kKeyAtoms = kKeys / kAtomCols;   // V^T's atoms (columns of keys)
  static constexpr int kQAtomBytes = kRows * 128;
  static constexpr int kQBytes = kAtoms * kQAtomBytes;  // Q_hi (Q_lo follows it)
  static constexpr int kKAtomBytes = kKeys * 128;       // kKeys rows of 32 columns of d
  static constexpr int kVAtomBytes = HD * 128;          // HD rows of 32 keys
  static constexpr int kPlaneBytes = kKeys * HD * 4;    // a tile's K_hi, K_lo, V^T_hi or V^T_lo
  static constexpr int kSlotBytes = 2 * kPlaneBytes;    // hi, then lo
  // d = 64: two stages, 3 blocks an SM (the ring's loads come from L2, and
  // other blocks' chains cover their latency). d = 128: Q alone is 64 KB, so
  // one block an SM, with four stages in flight.
  static constexpr int kSlots = HD == 128 ? 4 : 2;
  static constexpr int kMinBlocks = HD == 128 ? 1 : 3;
  static constexpr int kThreads = kWGThreads + 32;  // + the producer warp
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr size_t kSmemBytes = 1024 + 2 * kQBytes + kSlots * kSlotBytes + (2 * kSlots + 1) * 8;
  static_assert(kSmemBytes <= 232448, "a block uses at most 227 KB of shared memory");
};

// hi = x rounded to TF32 (10 fraction bits, to nearest, ties away from zero,
// the low 13 bits zero), as bits. On finite x this is cvt.rna.tf32.f32;
// written as integer operations so ops/flash_attention.py::tf32_split
// repeats it bit for bit.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (below 2^-22 |x|), both TF32 values as fp32 bits.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
}

// Byte offset of column c of row r in a 128-byte-swizzled fp32 tile of
// 32-column atoms, atom_bytes apart (the layout the TMA writes): row r of
// atom c / 32 at 128 r, its 16-byte chunk j at slot j ^ (r % 8).
__device__ __forceinline__ uint32_t sw128_f32(int r, int c, int atom_bytes) {
  return (c / kAtomCols) * atom_bytes + 128 * r + 16 * (((c % kAtomCols) / kVec) ^ (r % 8)) +
         4 * (c % kVec);
}

// --- wgmma, .tf32 (both operands K-major) -----------------------------------

// d (64 x N, fp32) = a (64 x 8, shared memory through desc_a) . b (8 x N,
// shared memory through desc_b) + (accumulate ? d : 0).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N, fp32) = a (64 x 8, TF32 bits in registers) . b (8 x N, shared
// memory through desc) + (accumulate ? d : 0). A fragment: a[0] row g,
// column t; a[1] row g + 8, column t; a[2] row g, column t + 4; a[3] row
// g + 8, column t + 4 (rows of this warp's 16).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// One box of a rank-3 map at (c0, c1, c2) into shared memory at `dst`;
// completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- the prologue --------------------------------------------------------------

// V fp32 values as TF32 bits, stored in one 8- or 16-byte write.
template <int V>
__device__ __forceinline__ void store_bits(float* dst, const uint32_t (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(x[0], x[1]);
}

// One block: keys [blockIdx.x * 32, +32) of head blockIdx.y of image
// blockIdx.z, of heads d wide (d % 4 == 0, d <= HD). K is read through L,
// roped with tables (rotate-half pairs column c with c + d/2), split and
// written to planes 0 (K_hi) and 1 (K_lo), each (B, H, n_keys, HD); V is
// transposed through shared memory into the V^T order (kSlotOfKey) and
// written, split, to planes 2 and 3, each (B, H, HD, n_keys). Columns d to
// HD (rows of V^T) and keys at or beyond n_valid are neither read nor left
// unwritten: they are zeros in every plane. V is 4 where d/2 is a multiple
// of 4, else 2: the columns a thread takes at a time.
template <int HD, int V>
__global__ void __launch_bounds__(256)
split_kv(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ out,
         const float* __restrict__ cos_t, const float* __restrict__ sin_t, int H, int n_keys,
         int n_valid, int d, Layout L, long long plane) {
  __shared__ float vt[HD][kSplitKeys + 1];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = blockIdx.x * kSplitKeys;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int half = d / 2;

  // K: slot c (V columns) of a key takes columns [c, c + V) of the first
  // half of d and their RoPE partners [c + d/2, +V); a slot past d/2 writes
  // zeros to 2 V of the columns from d to HD.
  constexpr int kSlots = HD / 2 / V;
  for (int i = threadIdx.x; i < kSplitKeys * kSlots; i += blockDim.x) {
    const int r = i / kSlots;
    const int c = (i % kSlots) * V;
    const int n = key0 + r;
    float xa[V] = {}, xp[V] = {};
    int ca = d + 2 * (c - half), cp = ca + V;  // a slot of zeros
    if (c < half) {
      ca = c, cp = c + half;
      if (n < n_valid) {
        const float* row = k + token_offset(L, b, h, n, d);
        load_table<V>(row + ca, xa);
        load_table<V>(row + cp, xp);
        if (cos_t != nullptr) {
          float cos_a[V], sin_a[V], cos_p[V], sin_p[V];
          const size_t t = static_cast<size_t>(n) * d;
          load_table<V>(cos_t + t + ca, cos_a);
          load_table<V>(sin_t + t + ca, sin_a);
          load_table<V>(cos_t + t + cp, cos_p);
          load_table<V>(sin_t + t + cp, sin_p);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float a = xa[e];
            xa[e] = rope(a, xp[e], true, cos_a[e], sin_a[e]);
            xp[e] = rope(xp[e], a, false, cos_p[e], sin_p[e]);
          }
        }
      }
    }
    uint32_t ha[V], la[V], hp[V], lp[V];
#pragma unroll
    for (int e = 0; e < V; ++e) tf32_split(xa[e], ha[e], la[e]), tf32_split(xp[e], hp[e], lp[e]);
    float* dst = out + (head * n_keys + n) * HD;
    store_bits<V>(dst + ca, ha);
    store_bits<V>(dst + cp, hp);
    store_bits<V>(dst + plane + ca, la);
    store_bits<V>(dst + plane + cp, lp);
  }

  // V: 32 keys x HD into shared memory, transposed, each key at its slot.
  constexpr int kQuads = HD / kVec;
  for (int i = threadIdx.x; i < kSplitKeys * kQuads; i += blockDim.x) {
    const int r = i / kQuads;
    const int c = (i % kQuads) * kVec;
    const int n = key0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_valid && c < d)
      x = *reinterpret_cast<const float4*>(v + token_offset(L, b, h, n, d) + c);
    const int s = kSlotOfKey(r);
    vt[c][s] = x.x, vt[c + 1][s] = x.y, vt[c + 2][s] = x.z, vt[c + 3][s] = x.w;
  }
  __syncthreads();
  constexpr int kRowQuads = kSplitKeys / kVec;
  for (int i = threadIdx.x; i < HD * kRowQuads; i += blockDim.x) {
    const int c = i / kRowQuads;
    const int j = (i % kRowQuads) * kVec;
    uint4 hi, lo;
    tf32_split(vt[c][j], hi.x, lo.x), tf32_split(vt[c][j + 1], hi.y, lo.y);
    tf32_split(vt[c][j + 2], hi.z, lo.z), tf32_split(vt[c][j + 3], hi.w, lo.w);
    float* dst = out + 2 * plane + (head * HD + c) * n_keys + key0 + j;
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + plane) = lo;
  }
}

// --- the attention kernel ------------------------------------------------------

// One block: query rows [blockIdx.x * 64, +64) of head blockIdx.y of image
// blockIdx.z. Warps 0-3 are the consumer warpgroup, warp 4 the producer. Q's
// and O's maps share one dim order (MapAddress) and have N rows; k_map is
// rank 3 over the scratch's K planes (HD, B H n_keys rows, planes 0-1),
// v_map over its V^T planes (n_keys, B H HD rows, planes 2-3).
template <int HD, int kRank>
__global__ void __launch_bounds__(Config<HD>::kThreads, Config<HD>::kMinBlocks)
attention_tf32(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t, int N, int d,
               int n_valid, int n_keys, int H, float scale, const MapAddress order) {
  using C = Config<HD>;
  constexpr int kKSteps = HD / 8;     // k-steps of q.k^T
  constexpr int kPSteps = kKeys / 8;  // k-steps of p.V
  constexpr int kS = kKeys / 2;       // score registers a thread
  constexpr int kO = HD / 2;          // output registers a thread

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t q_hi = (raw_addr + 1023u) & ~1023u;
  const uint32_t q_lo = q_hi + C::kQBytes;
  unsigned char* sq = raw + (q_hi - raw_addr);
  // Load i of the ring is K(i / 2) if i is even, else V(i / 2), into stage
  // i % kSlots: its hi plane, then its lo plane.
  const uint32_t ring = q_lo + C::kQBytes;
  const uint32_t bars = ring + C::kSlots * C::kSlotBytes;
  auto full = [&](int i) { return bars + 8u * (i % C::kSlots); };
  auto empty = [&](int i) { return bars + 8u * (C::kSlots + i % C::kSlots); };
  auto stage = [&](int i) { return ring + (i % C::kSlots) * C::kSlotBytes; };
  const uint32_t q_full = bars + 8u * 2 * C::kSlots;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (n_valid + kKeys - 1) / kKeys;  // tiles past n_valid add zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWGThreads / 32);  // one arrival a consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWGThreads) {
    // Producer: one thread loads the Q tile, then keeps the ring full.
    if (threadIdx.x == kWGThreads) {
      const HeadTiles tiles(order, h, b);
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        sm90::tma_load<kRank>(q_hi + a * C::kQAtomBytes, &q_map, q_full, tiles, a * kAtomCols, q0);
      const int k_row = (b * H + h) * n_keys;  // the head's first row in K's planes
      const int v_row = (b * H + h) * HD;      // and in V^T's
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int k0 = (i / 2) * kKeys;
        mbar_wait(empty(i), ((i / C::kSlots) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(i), C::kSlotBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t dst = stage(i) + p * C::kPlaneBytes;
          if (i % 2 == 0) {
#pragma unroll
            for (int a = 0; a < C::kAtoms; ++a)
              tma_load_3d(dst + a * C::kKAtomBytes, &k_map, full(i), a * kAtomCols, k_row + k0, p);
          } else {
#pragma unroll
            for (int a = 0; a < C::kKeyAtoms; ++a)
              tma_load_3d(dst + a * C::kVAtomBytes, &v_map, full(i), k0 + a * kAtomCols, v_row, p);
          }
        }
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  auto wait_full = [&](int i) { mbar_wait(full(i), (i / C::kSlots) & 1); };
  // Each consumer warp releases a stage once its share of the wgmma that read
  // it has completed.
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i));
  };

  // Rope, scale and split the Q tile in place: each thread takes pairs of
  // 16-byte chunks, columns [c, c + 4) and their RoPE partners [c + HD/2,
  // +4), writes hi where the chunk was and lo at the same place in Q_lo. The
  // tables of a batch of pairs load while the TMA brings the tile. Rows at or
  // beyond N arrived as zeros and split into zeros. Without tables the
  // pairing only visits every column once, so it serves any d.
  if (cos_t == nullptr || d == HD) {
    constexpr int kPairsPerRow = HD / 2 / kVec;
    constexpr int kPerThread = kRows * kPairsPerRow / kWGThreads;  // 4 or 8
    constexpr int kBatch = 2;
#pragma unroll
    for (int p0 = 0; p0 < kPerThread; p0 += kBatch) {
      float tab[kBatch][4][kVec];  // cos of the chunk, of its partner, then sin of both
#pragma unroll
      for (int pb = 0; pb < kBatch; ++pb) {
        const int i = tid + (p0 + pb) * kWGThreads;
        const int n = q0 + i / kPairsPerRow;
        const int c = (i % kPairsPerRow) * kVec;
        if (cos_t != nullptr && n < N) {
          const size_t row = static_cast<size_t>(n) * HD;
          load_table<kVec>(cos_t + row + c, tab[pb][0]);
          load_table<kVec>(cos_t + row + c + HD / 2, tab[pb][1]);
          load_table<kVec>(sin_t + row + c, tab[pb][2]);
          load_table<kVec>(sin_t + row + c + HD / 2, tab[pb][3]);
        }
      }
      if (p0 == 0) mbar_wait(q_full, 0);
#pragma unroll
      for (int pb = 0; pb < kBatch; ++pb) {
        const int i = tid + (p0 + pb) * kWGThreads;
        const int r = i / kPairsPerRow;
        const int c = (i % kPairsPerRow) * kVec;
        const uint32_t oa = sw128_f32(r, c, C::kQAtomBytes);
        const uint32_t op = sw128_f32(r, c + HD / 2, C::kQAtomBytes);
        const float4 a4 = *reinterpret_cast<const float4*>(sq + oa);
        const float4 p4 = *reinterpret_cast<const float4*>(sq + op);
        float xa[kVec] = {a4.x, a4.y, a4.z, a4.w}, xp[kVec] = {p4.x, p4.y, p4.z, p4.w};
        if (cos_t != nullptr && q0 + r < N) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float a = xa[e];
            xa[e] = rope(a, xp[e], true, tab[pb][0][e], tab[pb][2][e]);
            xp[e] = rope(xp[e], a, false, tab[pb][1][e], tab[pb][3][e]);
          }
        }
        uint4 ha, la, hp, lp;
        tf32_split(xa[0] * scale, ha.x, la.x), tf32_split(xa[1] * scale, ha.y, la.y);
        tf32_split(xa[2] * scale, ha.z, la.z), tf32_split(xa[3] * scale, ha.w, la.w);
        tf32_split(xp[0] * scale, hp.x, lp.x), tf32_split(xp[1] * scale, hp.y, lp.y);
        tf32_split(xp[2] * scale, hp.z, lp.z), tf32_split(xp[3] * scale, hp.w, lp.w);
        *reinterpret_cast<uint4*>(sq + oa) = ha;
        *reinterpret_cast<uint4*>(sq + op) = hp;
        *reinterpret_cast<uint4*>(sq + C::kQBytes + oa) = la;
        *reinterpret_cast<uint4*>(sq + C::kQBytes + op) = lp;
      }
    }
  } else {
    // With tables below HD: slot c (2 columns) of a row takes columns
    // [c, c + 2) of the first half of d and their partners [c + d/2, +2)
    // (d/2 need not be a multiple of 4); a slot past d/2 splits 4 of the
    // columns from d to HD, the zeros they arrived as.
    constexpr int kSlots = HD / 4;
    const int half = d / 2;
    mbar_wait(q_full, 0);
    for (int i = tid; i < kRows * kSlots; i += kWGThreads) {
      const int r = i / kSlots;
      const int c = 2 * (i % kSlots);
      const int n = q0 + r;
      int ca = d + 2 * (c - half), cp = ca + 2;  // a slot of zeros
      if (c < half) ca = c, cp = c + half;
      const uint32_t oa = sw128_f32(r, ca, C::kQAtomBytes);
      const uint32_t op = sw128_f32(r, cp, C::kQAtomBytes);
      const float2 a2 = *reinterpret_cast<const float2*>(sq + oa);
      const float2 p2 = *reinterpret_cast<const float2*>(sq + op);
      float xa[2] = {a2.x, a2.y}, xp[2] = {p2.x, p2.y};
      if (c < half && n < N) {
        float cos_a[2], sin_a[2], cos_p[2], sin_p[2];
        const size_t row = static_cast<size_t>(n) * d;
        load_table<2>(cos_t + row + ca, cos_a);
        load_table<2>(sin_t + row + ca, sin_a);
        load_table<2>(cos_t + row + cp, cos_p);
        load_table<2>(sin_t + row + cp, sin_p);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = xa[e];
          xa[e] = rope(a, xp[e], true, cos_a[e], sin_a[e]);
          xp[e] = rope(xp[e], a, false, cos_p[e], sin_p[e]);
        }
      }
      uint32_t ha[2], la[2], hp[2], lp[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tf32_split(xa[e] * scale, ha[e], la[e]), tf32_split(xp[e] * scale, hp[e], lp[e]);
      store_bits<2>(reinterpret_cast<float*>(sq + oa), ha);
      store_bits<2>(reinterpret_cast<float*>(sq + op), hp);
      store_bits<2>(reinterpret_cast<float*>(sq + C::kQBytes + oa), la);
      store_bits<2>(reinterpret_cast<float*>(sq + C::kQBytes + op), lp);
    }
  }
  // The wgmma reads shared memory through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWGThreads) : "memory");

  // Accumulator fragments (m64nNk8): element 4 j + e of a thread is row
  // 16 warp + g + 8 (e / 2), column 8 j + 2 t + (e & 1).
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum
  // The tensor core adds each product to its accumulator by truncation, so
  // an accumulator's error grows with the products chained into it. The two
  // small products of q.k^T go to s_small, the large to s, added in fp32 once
  // a tile; p.V of a tile goes to its own accumulator pv, added to O (scaled
  // by the softmax's alpha) by an fp32 FMA, so O is never chained through the
  // tensor core across tiles. Each accumulator's first product does not read
  // it (scale-d 0), so none is zeroed: a non-wgmma write to an accumulator
  // before its wgmma makes ptxas serialize the wgmmas.
  float s[kS], s_small[kS], pv[kO];

  // S = Q K(kt)^T, issued and committed: Q_lo K_hi and Q_hi K_lo over every
  // k-step into s_small, then Q_hi K_hi into s. Both operands K-major: an
  // 8-deep k-step is 32 bytes into the atoms' rows, 8-row groups 1024 bytes
  // apart.
  auto issue_qk = [&](int kt) {
    const uint32_t k_hi = stage(2 * kt);
    const uint32_t k_lo = k_hi + C::kPlaneBytes;
    wait_full(2 * kt);
    fence_regs(s);
    fence_regs(s_small);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint32_t sq_step = (kk / 4) * C::kQAtomBytes + (kk % 4) * 32;
      const uint32_t sk_step = (kk / 4) * C::kKAtomBytes + (kk % 4) * 32;
      wgmma_ss<kKeys>(s_small, sw128_desc(q_lo + sq_step, 16, 1024),
                      sw128_desc(k_hi + sk_step, 16, 1024), kk > 0);
      wgmma_ss<kKeys>(s_small, sw128_desc(q_hi + sq_step, 16, 1024),
                      sw128_desc(k_lo + sk_step, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint32_t sq_step = (kk / 4) * C::kQAtomBytes + (kk % 4) * 32;
      const uint32_t sk_step = (kk / 4) * C::kKAtomBytes + (kk % 4) * 32;
      wgmma_ss<kKeys>(s, sw128_desc(q_hi + sq_step, 16, 1024),
                      sw128_desc(k_hi + sk_step, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };

  // P V(kt) into pv, issued and committed: P_lo V_hi and P_hi V_lo over every
  // 8-key step, then P_hi V_hi. V^T's atoms are HD rows of 32 keys; a k-step
  // is 32 bytes into them.
  auto issue_pv = [&](const uint32_t (&phi)[kPSteps][4], const uint32_t (&plo)[kPSteps][4],
                      int kt) {
    const uint32_t v_hi = stage(2 * kt + 1);
    const uint32_t v_lo = v_hi + C::kPlaneBytes;
    wait_full(2 * kt + 1);
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      const uint32_t step = (j / 4) * C::kVAtomBytes + (j % 4) * 32;
      wgmma_rs<HD>(pv, plo[j], sw128_desc(v_hi + step, 16, 1024), j > 0);
      wgmma_rs<HD>(pv, phi[j], sw128_desc(v_lo + step, 16, 1024), 1);
    }
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      const uint32_t step = (j / 4) * C::kVAtomBytes + (j % 4) * 32;
      wgmma_rs<HD>(pv, phi[j], sw128_desc(v_hi + step, 16, 1024), 1);
    }
    wgmma_commit();
  };

  uint32_t phi[kPSteps][4], plo[kPSteps][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    issue_qk(kt);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(s_small);
    release(2 * kt);
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] += s_small[i];

    // The online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3); a row's
    // scores are spread over the 4 lanes t = 0..3 of one quad. Only the last
    // tile can hold dead keys: they are masked by select, and their p is then
    // exactly 0 (every row has a live key, so its max is finite).
    const int k0 = kt * kKeys;
    if (k0 + kKeys > n_valid) {
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= n_valid) s[4 * j + e] = kMasked;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = expf(m[r] - mx);  // 0 on the first tile (m = -inf)
      m[r] = mx;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      s[i] = expf(s[i] - m[(i % 4) / 2]);
      rs[(i % 4) / 2] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
    // P split in registers: element e of 8-key group j (row g + 8 (e / 2),
    // key 2 t + (e & 1)) is A element (e / 2) + 2 (e & 1) of k-step j, whose
    // V^T rows hold the keys in kSlotOfKey's order.
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(s[4 * j + e], phi[j][e / 2 + 2 * (e & 1)],
                                             plo[j][e / 2 + 2 * (e & 1)]);
    issue_pv(phi, plo, kt);
    wgmma_wait<0>();
    fence_regs(pv);
    release(2 * kt + 1);
    // O = O alpha + P V(kt), one fp32 rounding an element.
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = fmaf(o[i], alpha[(i % 4) / 2], pv[i]);
  }

  // O / row sum, staged in Q_hi's shared memory (q.k^T has read it for the
  // last time; each warp writes the rows its own share of the wgmma read) in
  // the same swizzled layout, then written by one TMA store a 32-column
  // atom; the map clips rows at or beyond N.
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(sq + sw128_f32(row, 8 * j + 2 * t, C::kQAtomBytes)) =
          make_float2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWGThreads) : "memory");
  if (tid == 0) {
    const HeadTiles tiles(order, h, b);
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a)
      sm90::tma_store<kRank>(&o_map, q_hi + a * C::kQAtomBytes, tiles, a * kAtomCols, q0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem read: may exit
  }
}

// --- host side ---------------------------------------------------------------

// The scratch's key rows: n_valid rounded up to the key tile.
inline int scratch_keys(int n_valid) { return (n_valid + kKeys - 1) / kKeys * kKeys; }

// The fp32 map of Q or O over the Layouts' shape m (map_shape), `rows` rows
// a head, at the inputs' strides or (`out`) the output's: boxes of one
// 32-column atom by 64 rows, 128-byte swizzle, zeros out of bounds.
inline bool encode_rows_map(CUtensorMap* map, const void* base, const sm90::MapShape& m, int rows,
                            bool out) {
  const long long* stride = out ? m.out_stride : m.stride;
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const int rank = m.order.rank, rows_dim = m.rows_dim;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  for (int d = 0; d < rank; ++d) {
    dims[d] = static_cast<cuuint64_t>(d == rows_dim ? rows : m.size[d]);
    box[d] = d == 0 ? kAtomCols : d == rows_dim ? kRows : 1;
    if (d > 0) strides[d - 1] = static_cast<cuuint64_t>(stride[d]) * sizeof(float);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A rank-3 map over two planes of the scratch from `base`: (inner, rows, 2),
// planes `plane` elements apart; boxes of 32 inner elements by box_rows rows
// of one plane, 128-byte swizzle.
inline bool encode_plane_map(CUtensorMap* map, const float* base, long long inner, long long rows,
                             int box_rows, long long plane) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * sizeof(float),
                                 static_cast<cuuint64_t>(plane) * sizeof(float)};
  const cuuint32_t box[3] = {kAtomCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The prologue alone on `stream`: k and v (heads d wide, d % 4 == 0 and
// d <= HD, read through L) into `scratch`, 4 planes of B H n_keys HD fp32
// (n_keys = scratch_keys(n_valid)), roped with tables (both null: not
// roped). Returns the CUDA error of the launch.
template <int HD>
cudaError_t launch_split(const void* k, const void* v, void* scratch, const void* cos_t,
                         const void* sin_t, int B, int H, int d, const Layout& L, int n_valid,
                         cudaStream_t stream) {
  static_assert(kKeys % kSplitKeys == 0, "a prologue block fills whole key tiles");
  if (B <= 0 || H <= 0 || n_valid <= 0 || B > 65535 || H > 65535 || L.heads_per_group <= 0 ||
      H % L.heads_per_group || scratch == nullptr || (cos_t == nullptr) != (sin_t == nullptr) ||
      d <= 0 || d > HD || d % 4)
    return cudaErrorInvalidValue;
  const int n_keys = scratch_keys(n_valid);
  const long long plane = static_cast<long long>(B) * H * n_keys * HD;
  const auto kernel = (d / 2) % 4 ? split_kv<HD, 2> : split_kv<HD, 4>;
  kernel<<<dim3(n_keys / kSplitKeys, H, B), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(scratch),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), H, n_keys, n_valid, d,
      L, plane);
  return cudaGetLastError();
}

// Launch the fp32 Hopper body on `stream` over heads of width d (d % 4 ==
// 0, d <= HD): the prologue (split_kv) into `scratch` (4 planes of B H
// scratch_keys(n_valid) HD fp32, laid out by the prologue), then the
// attention kernel. q, k and v lie as L says, o as Lo says, in the same dim
// order (map_shape); Q's and O's maps are d wide, so Q's columns beyond d
// load as zeros and O's are not stored, and the scratch's are zeros. Both
// rope at d/2. *prologues counts the prologue's launches that were queued
// (0 or 1). Returns the CUDA error of the launches (cudaSuccess when both
// were queued).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                   const void* sin_t, void* scratch, int B, int N, int H, int d, const Layout& L,
                   const Layout& Lo, int n_valid, float scale, void* stream, int* prologues) {
  using C = Config<HD>;
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_split<HD>(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st);
  if (err != cudaSuccess) return err;
  ++*prologues;
  const int n_keys = scratch_keys(n_valid);
  const long long plane = static_cast<long long>(B) * H * n_keys * HD;
  const auto* planes = static_cast<const float*>(scratch);
  sm90::MapShape m;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!sm90::map_shape(L, Lo, d, B, N, H, &m) || !encode_rows_map(&q_map, q, m, N, false) ||
      !encode_rows_map(&o_map, o, m, N, true) ||
      !encode_plane_map(&k_map, planes, HD, static_cast<long long>(B) * H * n_keys, kKeys, plane) ||
      !encode_plane_map(&v_map, planes + 2 * plane, n_keys, static_cast<long long>(B) * H * HD, HD,
                        plane))
    return cudaErrorInvalidValue;
  const auto kernel = m.order.rank == 5 ? attention_tf32<HD, 5> : attention_tf32<HD, 4>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(C::kSmemBytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  kernel<<<grid, C::kThreads, C::kSmemBytes, st>>>(
      q_map, k_map, v_map, o_map, static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      N, d, n_valid, n_keys, H, scale, m.order);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace cbas_attention
