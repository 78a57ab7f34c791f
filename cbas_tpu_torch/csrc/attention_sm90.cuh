// The Hopper body of the port's fused attention in bfloat16, built at head
// dims 64, 96, 128, 160 and 192: K1 (flat, d = 64), K2 (head-pair packed,
// d = 64) and K3 (head-major, every d up to 192, at the next of those
// widths) route here (attention_fat.cu, attention_packed.cu,
// attention_headmajor.cu);
// fp32 takes attention_sm90_tf32*.cuh, K3's bf16 heads from 193 to 256 the
// two-consumer body (attention_sm90_ws.cuh), above 256 attention_wide.cuh. The tensor maps are built from the
// caller's Layouts (strides), so one code path reads every layout, strided
// views included, and writes the output dense.
//
// The function and rounding points are attention_common.cuh's: RoPE in
// fp32, one rounding of roped, scaled q and of roped k to bf16, p rounded to
// bf16 before p.V, fp32 row sums, keys at or beyond n_valid masked by
// select. What the design does about what held back the port's first
// body (an mma.sync loop whose threads loaded each tile themselves, deleted
// since):
//
// - Copies in flight. One producer warp issues TMA loads
//   (cp.async.bulk.tensor) of the 64-key tiles K(0), V(0), K(1), V(1), ...
//   in turn into a ring of kSlots stages, each guarded by a "full" mbarrier
//   (transaction bytes) and an "empty" one (the consumer's release), so K(t+1)
//   loads while V(t) is read and the other way round. The tensor maps give K and
//   V a row extent of n_valid, so rows at or beyond it arrive as zeros from
//   the hardware: NaN or Inf bits in dead rows never reach shared memory.
//   The score mask stays a select.
// - wgmma. A consumer warpgroup of 64 query rows runs
//   wgmma.mma_async m64n64k16, bf16 in and fp32 accumulate, for both
//   products. q.k^T reads both operands from shared memory, K-major and
//   128-byte swizzled: K as the TMA lands it, Q as the block stages it
//   once. (Q as register fragments held across the loop was wrong at
//   d = 64: ptxas gave them the registers of p.V's fragments.) The
//   probabilities stay in registers as the A operand of p.V (the
//   accumulator layout of q.k^T is the A layout of p.V); V is read through
//   a transposed (MN-major) descriptor. The online softmax runs on the
//   accumulator fragments. A 128-wide head is two 64-column swizzle atoms,
//   each its own TMA box and its own n = 64 product. (FA3's in-warpgroup
//   overlap, the next tile's q.k^T and this tile's p.V in flight under the
//   next tile's softmax, is the variant kPipe below, with a register budget
//   and a ring of its own (Launch); at variant 0's blocks an SM its first
//   form spilled and had its wgmmas serialized.)
// - RoPE once per (token, head, image). The query block ropes and scales its
//   own Q rows as it stages them (each is read by one block only); K, which
//   every query block of a head reads, is roped by a prologue kernel
//   (rope_rows, attention_common.cuh, shared with the wide body) into
//   scratch the wrapper allocates, so the attention kernel reads roped K
//   through the same TMA path. Without tables nothing is roped and the
//   prologue does not run.
// - Tensor maps from strides (map_shape). A map's outer dimensions go in
//   ascending order of stride, dimensions of size 1 are left out, and a
//   group joins its heads' dimension when the heads are evenly spaced. So
//   K1's flat tensors, K3's head-major ones and K2's head-pair views of flat
//   projections get rank-4 maps (K2's views exactly K1's map), contiguous
//   packed tensors a rank-5 one; K3's head-major views of flat projections
//   get (d, H, rows, B), the flat map again. The rank is a template
//   argument and a block's coordinates are shifts and masks computed once:
//   a run-time division by the heads in a group, or a branch on the rank at
//   each load, was measured slower at N = 261.
//
// Grid: (ceil(N / 64) query blocks, H, B), one consumer warpgroup and one
// producer warp a block.
//
// What bounds it on this card: latency. A block does 5 (N = 261) to 19
// (N = 1205) key tiles, each a chain of wgmma, wait, softmax, wgmma, wait;
// the SM overlaps the chains of its 2-4 resident blocks, not the steps of
// one. At N = 261 the last query block and the last key tile of a head hold
// 5 rows of 64, so 25 tile steps do the work of 16.6. At N = 1205 the K and
// V re-reads of the 19 query blocks of a head also load L2 (2.25 GB at
// 640x480 for K1).
//
// At d = 192 (K3; the TPU kernel cbas_tpu/ops/flash_attention.py::
// _attn_kernel at that width) the same body runs with 3 swizzle atoms, each
// its own TMA box and its own n = 64 product. What bounds it there: the
// bytes of q, k, v and o at N = 261, and registers: O alone is 96 fp32
// registers a consumer thread before the scores (32) and P (16), so 2
// blocks an SM (Config::kMinBlocks). At 256 (128 registers of O, one block
// an SM) the two-consumer body (attention_sm90_ws.cuh) ran 20-34% faster at
// every timed row and took that width's place; at 192, where 2 blocks an SM
// already run two consumer warpgroups, it tied at N = 1205 and lost 5-9%
// of device time at N = 261, so 192 stays here (PERF.md).
//
// At 96 and 160 (and the two-consumer body's 224) the products run at the
// head's own width, not the next multiple of 64: q.k^T takes HD / 16
// k-steps and p.V one n = 32 product for O's last 32 columns, over V in
// 32-column boxes in the 64-byte swizzle (Tiles), as FlashAttention-3
// builds its Hopper kernel at 96; a 96-wide head ran 4/3 of its products
// on the 128 build before, a 160-wide one 6/5 on the 192 build (PERF.md).
//
// K3's other widths, in place (no pad copy, no RoPE outside a kernel): a
// head of width d runs at the next built width HD (HD - 32 < d < HD above
// 64, bf16_width); the two-consumer body reads the same forms through the same
// set-up (prepare, prepare_staged).
// - d % 16 == 0 (launch): the maps read the heads where they lie, their
//   innermost extent d, so the columns from d to HD load as zeros and the
//   store of O clips them. With tables, rope_rows ropes q (times the scale)
//   and k into scratch first, since the block's rotation pairs column c
//   with c + HD/2, not c + d/2.
// - otherwise (launch_staged): a row of d elements is no 32-byte multiple.
//   A tensor map refuses rows that are no 16-byte multiple, and reads those
//   of an odd number of 16-byte units (d % 16 == 8) slowly: the rows and
//   the box's last column end off the 32-byte sectors. One staging launch
//   (stage_rows, attention_common.cuh) copies q (roped, times the scale),
//   k (roped) and v through their strides into scratch rows of d rounded up
//   to 16 (kStageUnit), zeros from d; the maps read the scratch at that
//   width, and the epilogue writes O through the output's Layout with plain
//   stores of the widest unit the rows allow (kStagedOut).
//   Two launches a call, against the 5-7 of the copies that padded such a
//   head before (PERF.md). The two-consumer body reads rows of an odd
//   number of 16-byte units in place (attention_sm90_ws.cuh, kRowUnit): its
//   4-stage ring ran them within 5% of the staged body's time.
//
// Compile-time variants (kVariant, attention_variants.cu). Variant 0 (kFull)
// is the function above, the only one K1, K2 and K3 run. The others port the
// stage isolation of the TPU probes benchmarks/attn_probes/probe2.py
// (make_variant, its bodies dma_kernel, qk_kernel, nosm_kernel and
// pipe_kernel) and probe4.py (vext_kernel), as timing cases of this loop: the
// producer, the ring and the stores are the same in every variant, and each
// drops or changes one stage of the consumer (Variant). They are built at
// d = 64 and 128 only, and no encode route calls them. The pipe loop
// (kPipe) reorders the consumer as FA3 does and so has a ring and register
// budget of its own (Launch); bit for bit variant 0, it ran 1.18-1.68x its
// time at the main shapes, at every budget that built without spills
// (PERF.md), so K1-K3 keep variant 0's loop.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver entry is fetched at run time)

#include <type_traits>

#include "attention_common.cuh"

namespace cbas_attention {
namespace sm90 {

constexpr int kBlockN = 64;     // keys per ring stage
constexpr int kWGRows = 64;     // query rows per consumer warpgroup
constexpr int kWGThreads = 128;
constexpr int kAtom = 64;       // bf16 columns in one 128-byte swizzle atom
constexpr int kAtomBytes = kBlockN * 128;  // one 64-row atom of a K or V tile
constexpr int kHalfAtom = 32;   // bf16 columns in one 64-byte swizzle atom
constexpr int kHalfAtomBytes = kBlockN * 64;  // one 64-row atom of that width
// The columns a row of the staging scratch is rounded up to (32 bytes), and
// so the widths K3 reads in place: on maps whose rows, or whose last column,
// end off a 32-byte boundary the body ran 1.2-2.3x its time (PERF.md).
constexpr int kStageUnit = 16;

// The tiles of a body built at HD, a multiple of 32. Q, K and O's staging
// tile are 64-column boxes in the 128-byte swizzle, the last one half read
// where HD is an odd number of 32-column halves (96, 160, 224, kHalf):
// q.k^T runs HD / 16 k-steps, so it reads that box's first 64 bytes of each
// row and never the zeros beyond. V, the MN-major B of p.V, is cut along
// its columns into one product an atom, and a 128-byte-swizzled atom cannot
// be cut in half along N: V's whole atoms land as at the other widths, its
// last 32 columns in one 32-column box in the 64-byte swizzle, read by an
// n = 32 product. That box comes through a map of its own, which such a
// build takes in the O map's place: its epilogue writes O with 16-byte
// stores through the output's Layout (PlainOut), which ran as fast as the
// TMA store (PERF.md). (V in 32-column boxes throughout, with no second
// map, ran rows off 32 bytes 18% over the aligned width's time at 224.)
template <int HD>
struct Tiles {
  static_assert(HD % kHalfAtom == 0, "a body is built at a multiple of 32");
  static constexpr int kAtoms = HD / kAtom;              // whole 64-column atoms
  static constexpr bool kHalf = HD % kAtom != 0;         // and a 32-column half
  static constexpr int kBoxes = kAtoms + (kHalf ? 1 : 0);  // Q's, K's and O's 64-column boxes
  static constexpr int kTileBytes = kBoxes * kAtomBytes;  // one K tile, a ring stage
  // V's transaction bytes: its whole atoms and (kHalf) its last 32 columns.
  static constexpr int kVBytes = kAtoms * kAtomBytes + (kHalf ? kHalfAtomBytes : 0);
};

template <int HD>
struct Config : Tiles<HD> {
  static_assert(HD == 64 || HD == 96 || HD == 128 || HD == 160 || HD == 192,
                "the Hopper body takes head dims 64, 96, 128, 160 and 192");
  using Tiles<HD>::kBoxes;
  // One consumer warpgroup a block, a 2-stage ring and registers capped for
  // 4 blocks an SM at d = 64, 3 at d = 96 and 128, 2 at 160 and 192 (96 at
  // 4 and 160 at 3 spilled and had their wgmmas serialized: ptxas on the
  // card, PERF.md). The kernel is bound by latency,
  // so independent blocks an SM are what helps: on an H100 at the main
  // shapes this ran faster than two warpgroups sharing a 128-row block, and
  // than 3- and 4-stage rings, which cost blocks an SM (or registers) for
  // loads that a 2-stage ring already has in flight (PERF.md). At d = 192
  // the O accumulator alone is 96 registers a thread: one warpgroup a block
  // takes 158 registers, so 2 blocks an SM (an SM sub-partition holds 3
  // warps of up to 168 registers). Two consumer warpgroups on a 128-row
  // block with thread 0 refilling a shared ring ran slower; FA3's shape, a
  // producer warpgroup handing its registers to two consumer warpgroups by
  // setmaxnreg (attention_sm90_ws.cuh), ties at 192 and takes 256 (PERF.md).
  static constexpr int kSlots = 2;
  static constexpr int kMinBlocks = HD == 64 ? 4 : HD <= 128 ? 3 : 2;
  static constexpr int kThreads = kWGThreads + 32;        // + the producer warp
  using Tiles<HD>::kTileBytes;
  static constexpr int kQBytes = kBoxes * kAtomBytes;      // the Q tile, swizzled like K
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr size_t kSmemBytes = 1024 + kQBytes + kSlots * kTileBytes + (2 * kSlots + 1) * 8;
};

// The body's variants and the function each computes (the plain versions:
// cbas_tpu_torch/ops/attention_variants.py). Every variant loads Q and each
// K and V tile through the ring and stores one output tile, as kFull does;
// what it keeps of the consumer's work is all it claims to time, and no
// variant skips a key tile.
enum Variant : int {
  kFull = 0,         // the attention function (K1, K2, K3)
  kDma = 1,          // probe2 dma_kernel: no RoPE, no wgmma; o = q, bit for bit
  kQk = 2,           // probe2 qk_kernel: RoPE and q.k^T of every tile; o = bf16 of the
                     // scores of keys 0 .. HD-1 (key tile a into O's atom a)
  kNoSoftmax = 3,    // probe2 nosm_kernel: o = bf16(bf16(s) . V); no mask, max, exp or sum
  kPipe = 4,         // probe2 pipe_kernel: kFull with tile t+1's q.k^T and tile t's
                     // p.V in flight under tile t+1's softmax; bit for bit kFull
  kVext = 5,         // probe4 vext_kernel: row sums from p.[V | 1] on the tensor cores
  kVextBf16Exp = 6,  // the same with p = bf16(2^bf16(x)), two exponentials a MUFU op
};

// A tile of bf16 ones, B of the row-sum product p.1 (m64n8k16) of kVext and
// kVextBf16Exp: every element is 1, so its layout does not matter, and each
// 16-key step reads the same 16 x 8 block of it.
constexpr uint32_t kOnesBytes = 1024;

// How a variant's build is launched: its ring's stages, the blocks an SM
// its registers are capped for (__launch_bounds__) and its dynamic shared
// memory; every build runs a consumer warpgroup and a producer warp
// (Config::kThreads). Every variant but the pipe loop's takes Config's. An
// SM's registers lie in 4 sub-partitions of 16384, each holding a quarter
// of the resident warps, rounded up: at 5 warps a block, 4 blocks an SM
// cap a thread at 96 registers, 3 at 128, 2 at 168, 1 at 255. The pipe
// loop (kPipe) holds, while tile t + 1's softmax runs, O, the score set and
// two P sets, one read by p.V(t) (32 + 32 + 2 x 16 registers at d = 64,
// 64 + 32 + 2 x 16 at 128), and ptxas builds it without spills or
// serialized wgmmas only at 2 blocks an SM at 64 (141 registers) and 1 at
// 128 (178; at 3 and 2 it spilled and serialized them, C7512; blocks
// of 4 warps whose thread 0 loads built clean at 3 and 2 but ran slower,
// and a producer warpgroup giving its registers away by setmaxnreg left
// ptxas at 128 a thread, PERF.md). Its producer issues V(t) as soon as V(t - 2)'s
// stage is free: the loop waits on V(t) right after issuing q.k^T(t + 1),
// before tile t + 1's softmax could hide V(t)'s load, so a ring of 4 stages
// holds K and V twice over (load i at stage i % 4); on 2 stages it ran
// 9-35% slower (PERF.md).
template <int HD, int kVariant>
struct Launch {
  using C = Config<HD>;
  static constexpr bool kPipeLoop = kVariant == kPipe;
  static constexpr int kSlots = kPipeLoop ? 4 : C::kSlots;
  static constexpr int kMinBlocks = !kPipeLoop ? C::kMinBlocks : HD == 64 ? 2 : 1;
  static constexpr size_t kSmemBytes =
      1024 + C::kQBytes + kSlots * C::kTileBytes + (2 * kSlots + 1) * 8 +
      (kVariant == kVext || kVariant == kVextBf16Exp ? kOnesBytes : 0);
  static_assert(kSmemBytes * kMinBlocks <= 232448, "the blocks an SM fit its shared memory");
};

// Which key tiles the consumer's softmax masks (by select, keys at or beyond
// n_valid): the tile that reaches past n_valid, known at run time (the loop
// of variant 0), or, where the loop knows the last tile when it is
// compiled (the pipe loop's peeled last step), every tile it is given or
// none.
enum Mask : int { kMaskLast, kMaskAlways, kMaskNever };

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that outlasts
// about ten seconds of SM clock traps, so a fault in the ring ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// A position in a ring walked without a division (the wide bodies'): the
// stage and the phase of its barriers.
struct RingCursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// --- TMA -------------------------------------------------------------------

// How a tensor map of rank 4 or 5 is addressed: map dimension d + 1 of row
// `row` of head h of image b is
//   ((h >> head_shift[d]) & head_mask[d]) + b * image[d] + row * rows[d].
// The host builds it (map_shape): a head is one map dimension (mask all
// ones) unless a head-in-group dimension (mask heads_per_group - 1) and a
// group dimension (shift log2 heads_per_group) are both in the map.
struct MapAddress {
  int rank;  // the kernel's template argument
  int head_shift[4];
  int head_mask[4];
  int image[4];
  int rows[4];
};

// The map coordinates of one head's tiles: map dimension d + 1 of the tile
// at row `row` is base[d] + step[d] * row. Computed once into registers, so
// issuing a load costs a few multiply-adds.
struct HeadTiles {
  int base[4];
  int step[4];

  __device__ __forceinline__ HeadTiles(const MapAddress o, int h, int b) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      base[d] = ((h >> o.head_shift[d]) & o.head_mask[d]) + b * o.image[d];
      step[d] = o.rows[d];
    }
  }
  __device__ __forceinline__ int at(int d, int row) const { return base[d] + step[d] * row; }
};

// One box of `map` at column c0 of row `row` of the head `t` describes, into
// shared memory at `dst`; completion is counted on `bar` in bytes.
template <int kRank>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         const HeadTiles& t, int c0, int row) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (kRank == 5)
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(c0), "r"(t.at(0, row)), "r"(t.at(1, row)), "r"(t.at(2, row)),
        "r"(t.at(3, row))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(c0), "r"(t.at(0, row)), "r"(t.at(1, row)), "r"(t.at(2, row))
        : "memory");
}

// One box of shared memory at `src` to `map` at the same coordinates, as a
// bulk group of this thread.
template <int kRank>
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, const HeadTiles& t,
                                          int c0, int row) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (kRank == 5)
    asm volatile(
        "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
        ::"l"(m), "r"(src), "r"(c0), "r"(t.at(0, row)), "r"(t.at(1, row)), "r"(t.at(2, row)),
        "r"(t.at(3, row))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
        ::"l"(m), "r"(src), "r"(c0), "r"(t.at(0, row)), "r"(t.at(1, row)), "r"(t.at(2, row))
        : "memory");
}

// --- wgmma -----------------------------------------------------------------

// A shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (SW128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// The same for a 64-byte-swizzled operand (layout 2, SW64).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(2) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x (MUFU.EX2; 0 for -inf and for x far below -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x of both bf16 halves of x, as bf16x2 (one MUFU op for the pair; sm_90).
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The max (kMax) or sum of a thread's 16 scores of row r (0: row g, 1: row
// g + 8) in an m64n64 accumulator, as a tree: 4 dependent steps, not 16.
template <bool kMax>
__device__ __forceinline__ float row_reduce(const float (&s)[32], int r) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[2 * j] = s[4 * j + 2 * r], v[2 * j + 1] = s[4 * j + 2 * r + 1];
  auto op = [](float x, float y) { return kMax ? fmaxf(x, y) : x + y; };
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = op(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = op(v[i], v[i + 4]);
  return op(op(v[0], v[2]), op(v[1], v[3]));
}

// Keeps the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) = a (64 x 16, bf16, registers) . b (16 x 64, bf16, shared
// memory through `desc`) + (accumulate ? d : 0). TransB 0: b is K-major (its
// 16-deep columns contiguous); 1: MN-major (its 64-wide rows contiguous).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TransB));
}

// d (64 x 32, fp32) = a (64 x 16, bf16, registers) . b (16 x 32, bf16, shared
// memory through `desc`) + (accumulate ? d : 0); TransB as above.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TransB));
}

// O's columns from one V tile: acc[a] += p . V's columns [64 a, +64), each
// whole atom an n = 64 product over its 128-byte-swizzled box (a 16-key
// step 16 rows, 2048 bytes, down it; 8-row groups 1024 bytes apart), and at
// a build with a half atom (Tiles::kHalf) half += p . V's columns
// [64 kAtoms, +32), an n = 32 product over the 64-byte-swizzled box after
// them (a step 1024 bytes, groups 512 apart).
template <int kAtoms, bool kHalf, int R>
__device__ __forceinline__ void issue_pv_atoms(float (&acc)[kAtoms][32], float (&half)[R],
                                               const uint32_t (&p)[4][4], uint32_t v_tile) {
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<1>(acc[a], p[kk],
                         sw128_desc(v_tile + a * kAtomBytes + kk * 2048, kAtomBytes, 1024), 1);
  if constexpr (kHalf) {
    static_assert(R == 16, "the half atom's accumulator is m64n32");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n32k16<1>(half, p[kk],
                         sw64_desc(v_tile + kAtoms * kAtomBytes + kk * 1024, kHalfAtomBytes, 512),
                         1);
  }
}

// The same product with a from shared memory too, through `desc_a` (K-major).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 8, fp32) = a (64 x 16, bf16, registers) . b (16 x 8, bf16, shared
// memory through `desc`, K-major) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// A shared-memory matrix descriptor without swizzle (layout 0): start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// --- the kernels -----------------------------------------------------------

// Byte offset of column c of row r in a 128-byte-swizzled tile of 64-column
// atoms (the layout the TMA writes): row r of atom c / 64 at 128 r, its
// 16-byte chunk j at slot j ^ (r % 8).
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c / kAtom) * kAtomBytes + 128 * r + 16 * (((c % kAtom) / kChunk) ^ (r % 8));
}

// Where the staged form (kStagedOut) writes O: rows of d elements through
// Lo, `unit` elements (1, 2, 4 or, the two-consumer body's, 8: dividing d,
// Lo's strides and o's address) a store. The other forms write through
// their O map and ignore it.
struct PlainOut {
  __nv_bfloat16* o;
  Layout Lo;
  int d;
  int unit;
};

// Rows [q0, q0 + 64) of head h of image b, staged in the swizzled tile at
// `tile`, to `out` (rows at or beyond N are not written), by the 128 threads
// of a warpgroup (tid its thread): a store a thread in turn, `unit` elements
// each (up to kWidest), which lie in one 16-byte chunk of the tile.
template <int kWidest = 4>
__device__ __forceinline__ void store_rows(const unsigned char* tile, const PlainOut& out, int b,
                                           int h, int q0, int N, int tid) {
  auto rows = [&](auto width) {
    constexpr int V = decltype(width)::value;
    using P = Pack<__nv_bfloat16, V>;
    const int per_row = out.d / V;
    const int live = min(kWGRows, N - q0);
    for (int i = tid; i < live * per_row; i += kWGThreads) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * V;
      *reinterpret_cast<P*>(out.o + token_offset(out.Lo, b, h, q0 + r, out.d) + c) =
          *reinterpret_cast<const P*>(tile + sw128_offset(r, c) + 2 * (c % kChunk));
    }
  };
  if constexpr (kWidest == 8) {
    if (out.unit == 8) return rows(std::integral_constant<int, 8>{});
  }
  if (out.unit == 4)
    rows(std::integral_constant<int, 4>{});
  else if (out.unit == 2)
    rows(std::integral_constant<int, 2>{});
  else
    rows(std::integral_constant<int, 1>{});
}

// One block: query rows [blockIdx.x * 64, +64) of head blockIdx.y of image
// blockIdx.z. Warps 0-3 are the consumer warpgroup, warp 4 the producer.
// The four maps share one dim order and so one MapAddress; Q's and O's maps
// have N rows, K's and V's n_valid. kVariant selects the consumer's work
// (Variant); the producer is the same in all. kStagedOut (the staged form,
// variant kFull only): O goes through `out` with plain stores, not through
// the O map. At a build with a half atom (Tiles::kHalf) o_or_vhalf_map is
// V's last 32 columns' map and O always goes through `out`, 16 bytes a store
// where its rows allow; at the other builds it is O's map.
template <int HD, int kRank, int kVariant = kFull, bool kStagedOut = false>
__global__ void __launch_bounds__(Config<HD>::kThreads, Launch<HD, kVariant>::kMinBlocks)
attention_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap o_or_vhalf_map,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t, int N,
               int n_valid, float scale, const MapAddress order, const PlainOut out) {
  static_assert(!kStagedOut || kVariant == kFull, "the staged form is the attention function");
  using C = Config<HD>;
  static_assert(kVariant == kFull || !C::kHalf, "the variants are built at 64 and 128");
  constexpr int kKSteps = HD / 16;
  constexpr bool kRowSumProduct = kVariant == kVext || kVariant == kVextBf16Exp;
  constexpr int kSlots = Launch<HD, kVariant>::kSlots;

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t q_tile = (raw_addr + 1023u) & ~1023u;
  unsigned char* sq = raw + (q_tile - raw_addr);
  // Load i of the ring is K(i / 2) if i is even, else V(i / 2), into stage
  // i % kSlots at + (i % kSlots) * kTileBytes.
  const uint32_t ring = q_tile + C::kQBytes;
  // The row-sum variants' ones tile, then the full barriers of the stages,
  // their empty barriers, then Q's.
  const uint32_t ones = ring + kSlots * C::kTileBytes;
  const uint32_t bars = ones + (kRowSumProduct ? kOnesBytes : 0);
  auto full = [&](int i) { return bars + 8u * (i % kSlots); };
  auto empty = [&](int i) { return bars + 8u * (kSlots + i % kSlots); };
  auto stage = [&](int i) { return ring + (i % kSlots) * C::kTileBytes; };
  const uint32_t q_full = bars + 8u * 2 * kSlots;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kWGRows;
  const int n_tiles = (n_valid + kBlockN - 1) / kBlockN;  // tiles past n_valid add zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
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
      for (int a = 0; a < C::kBoxes; ++a)
        tma_load<kRank>(q_tile + a * kAtomBytes, &q_map, q_full, tiles, a * kAtom, q0);
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int row = (i / 2) * kBlockN;
        const CUtensorMap* map = i % 2 ? &v_map : &k_map;
        mbar_wait(empty(i), ((i / kSlots) & 1) ^ 1);  // round 0 passes at once
        if constexpr (C::kHalf) {
          if (i % 2) {  // V: its whole atoms, then its last 32 columns (Tiles)
            mbar_expect_tx(full(i), C::kVBytes);
#pragma unroll
            for (int a = 0; a < C::kAtoms; ++a)
              tma_load<kRank>(stage(i) + a * kAtomBytes, map, full(i), tiles, a * kAtom, row);
            tma_load<kRank>(stage(i) + C::kAtoms * kAtomBytes, &o_or_vhalf_map, full(i), tiles,
                            C::kAtoms * kAtom, row);
            continue;
          }
        }
        mbar_expect_tx(full(i), C::kTileBytes);
#pragma unroll
        for (int a = 0; a < C::kBoxes; ++a)
          tma_load<kRank>(stage(i) + a * kAtomBytes, map, full(i), tiles, a * kAtom, row);
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

  auto wait_full = [&](int i) { mbar_wait(full(i), (i / kSlots) & 1); };
  // Each consumer warp releases a stage once its share of the wgmma that read
  // it has completed.
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i));
  };

  if constexpr (kVariant == kDma) {
    // Loads and stores only: Q as it arrived, each stage waited on and
    // released; the epilogue stores the Q tile unchanged.
    mbar_wait(q_full, 0);
    for (int i = 0; i < 2 * n_tiles; ++i) {
      wait_full(i);
      release(i);
    }
  } else {
    // Rope and scale the Q tile in place, as the shared-memory A operand of
    // q.k^T: each thread takes pairs of 16-byte chunks, columns [c, c + 8) of
    // the first half and their RoPE partners [c + HD/2, +8), and rounds each
    // value to bf16 once, as rope_rows does. The tables of a batch of pairs
    // load while the TMA brings the tile. Rows at or beyond N arrived as zeros
    // and stay so.
    {
      constexpr int kPairsPerRow = HD / 2 / kChunk;
      constexpr int kPerThread = kWGRows * kPairsPerRow / kWGThreads;  // 2 to 6
      constexpr int kBatch = 2;
#pragma unroll
      for (int p0 = 0; p0 < kPerThread; p0 += kBatch) {
        float4 tab[kBatch][8];  // cos, then sin, of the chunk and of its partner
#pragma unroll
        for (int pb = 0; pb < kBatch; ++pb) {
          if (p0 + pb >= kPerThread) break;  // an odd count (96, 160): the last batch is one
          const int i = tid + (p0 + pb) * kWGThreads;
          const int n = q0 + i / kPairsPerRow;
          const int c = (i % kPairsPerRow) * kChunk;
          if (cos_t != nullptr && n < N) {
            const size_t row = static_cast<size_t>(n) * HD;
            const float4* cs = reinterpret_cast<const float4*>(cos_t + row);
            const float4* sn = reinterpret_cast<const float4*>(sin_t + row);
            const int c4 = c / 4, p4 = (c + HD / 2) / 4;
            tab[pb][0] = cs[c4], tab[pb][1] = cs[c4 + 1], tab[pb][2] = cs[p4], tab[pb][3] = cs[p4 + 1];
            tab[pb][4] = sn[c4], tab[pb][5] = sn[c4 + 1], tab[pb][6] = sn[p4], tab[pb][7] = sn[p4 + 1];
          }
        }
        if (p0 == 0) mbar_wait(q_full, 0);
#pragma unroll
        for (int pb = 0; pb < kBatch; ++pb) {
          if (p0 + pb >= kPerThread) break;
          const int i = tid + (p0 + pb) * kWGThreads;
          const int r = i / kPairsPerRow;
          const int c = (i % kPairsPerRow) * kChunk;
          if (q0 + r >= N) continue;
          uint4* pa = reinterpret_cast<uint4*>(sq + sw128_offset(r, c));
          uint4* pp = reinterpret_cast<uint4*>(sq + sw128_offset(r, c + HD / 2));
          const uint4 xa = *pa, xp = *pp;
          const float* tb = reinterpret_cast<const float*>(tab[pb]);  // [8 cos_a, 8 cos_p, ...]
          uint4 ya, yp;
          auto* a32 = reinterpret_cast<uint32_t*>(&ya);
          auto* p32 = reinterpret_cast<uint32_t*>(&yp);
#pragma unroll
          for (int e = 0; e < kChunk; e += 2) {
            float va[2], vp[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              va[u] = bf16_at(xa, e + u);
              vp[u] = bf16_at(xp, e + u);
              if (cos_t != nullptr) {
                const float a = va[u];
                va[u] = rope(a, vp[u], true, tb[e + u], tb[16 + e + u]);
                vp[u] = rope(vp[u], a, false, tb[8 + e + u], tb[24 + e + u]);
              }
            }
            a32[e / 2] = pack_bf16(va[0] * scale, va[1] * scale);
            p32[e / 2] = pack_bf16(vp[0] * scale, vp[1] * scale);
          }
          *pa = ya;
          *pp = yp;
        }
      }
    }
    if constexpr (kRowSumProduct) {  // the ones tile: 128 threads x 8 bytes of bf16 1.0
      static_assert(kOnesBytes == kWGThreads * 8, "one uint2 of ones a consumer thread");
      reinterpret_cast<uint2*>(raw + (ones - raw_addr))[tid] = make_uint2(0x3F803F80u, 0x3F803F80u);
    }
    // The wgmma reads shared memory through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWGThreads) : "memory");
  }

  // Accumulator fragments (m64nNk16): element 4 j + e of a thread is row
  // 16 warp + g + 8 (e / 2), column 8 j + 2 t + (e & 1).
  float acc[C::kAtoms][32];
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  // O's last 32 columns where HD is an odd number of halves (m64n32k16:
  // element 4 j + e as above, j < 4).
  float acc_h[C::kHalf ? 16 : 1];
#pragma unroll
  for (int i = 0; i < (C::kHalf ? 16 : 1); ++i) acc_h[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum
  // The row-sum variants' running sums, from p.1 (m64n8: elements 0 and 1
  // are row g, 2 and 3 row g + 8, every column the same sum).
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};

  // S = Q K(kt)^T into s, issued and committed. Both operands K-major: a
  // 16-deep step is 32 bytes into the atoms' rows; 8-row groups are 1024
  // bytes apart. The first step does not read s (scale-d 0), so it is not
  // zeroed: a non-wgmma write to an accumulator makes ptxas serialize the
  // wgmmas.
  float sc[32];
  auto issue_qk = [&](float (&s)[32], int kt) {
    const uint32_t k_tile = stage(2 * kt);
    wait_full(2 * kt);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint32_t step = (kk / 4) * kAtomBytes + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, sw128_desc(q_tile + step, 16, 1024),
                         sw128_desc(k_tile + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };

  // O += P V(kt), issued and committed. MN-major B: a 16-key step is 16 rows
  // (2048 bytes) down the atom; 8-row groups are 1024 bytes apart; each
  // 64-column atom of V is its own n = 64 product. The row-sum variants add
  // P 1 into lsum in the same group.
  auto issue_pv = [&](const uint32_t (&p)[4][4], int kt) {
    const uint32_t v_tile = stage(2 * kt + 1);
    wait_full(2 * kt + 1);
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
    if constexpr (C::kHalf) fence_regs(acc_h);
    if constexpr (kRowSumProduct) fence_regs(lsum);
    wgmma_fence();
    issue_pv_atoms<C::kAtoms, C::kHalf>(acc, acc_h, p, v_tile);
    if constexpr (kRowSumProduct) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n8k16(lsum, p[kk], plain_desc(ones, 128, 256), 1);
    }
    wgmma_commit();
  };

  // The online softmax of tile kt's scores s, over rows g (e = 0, 1) and
  // g + 8 (e = 2, 3); a row's 64 scores are spread over the 4 lanes t = 0..3
  // of one quad. exp(x - max) as 2^(x log2 e - max log2 e): one FFMA and one
  // MUFU an element. Updates m and l, writes P (rounded to bf16) as the A
  // fragments of p.V into p, and the factor O must be rescaled by into alpha.
  // The row-sum variants keep no l (p.1 sums P); kVextBf16Exp rounds each
  // x to bf16 and takes 2^x of a pair in one bf16x2 MUFU op, whose result is
  // P's A fragment as it stands. Only the last tile can hold dead keys:
  // `mask` (Mask) says whether they are masked (by select: their p is then
  // exactly 0, since every row has a live key and so a finite max) where the
  // tile reaches past n_valid (kMaskLast), always, or never.
  auto softmax = [&](float (&s)[32], int kt, uint32_t (&p)[4][4], float (&alpha)[2], auto mask) {
    constexpr int kMask = decltype(mask)::value;
    const int k0 = kt * kBlockN;
    if (kMask == kMaskAlways || (kMask == kMaskLast && k0 + kBlockN > n_valid)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= n_valid) s[4 * j + e] = kMasked;
    }
    float mxl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m[r], row_reduce<true>(s, r));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2((m[r] - mx) * kLog2e);  // 0 on the first tile (m = -inf)
      m[r] = mx;
      mxl[r] = mx * kLog2e;
    }
    // Key step kk of p.V is score columns 16 kk .. +15, the accumulator
    // elements of 8-column tiles 2 kk and 2 kk + 1; element 8 kk + 2 i (and
    // its neighbour, one bf16x2) is in row i % 2.
    if constexpr (kVariant == kVextBf16Exp) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[kk][i] = ex2_bf16x2(pack_bf16(fmaf(s[8 * kk + 2 * i], kLog2e, -mxl[i % 2]),
                                          fmaf(s[8 * kk + 2 * i + 1], kLog2e, -mxl[i % 2])));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], kLog2e, -mxl[(i % 4) / 2]));
      if constexpr (!kRowSumProduct) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float rs = row_reduce<false>(s, r);
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          l[r] = l[r] * alpha[r] + rs;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
  };
  const std::integral_constant<int, kMaskLast> mask_last{};

  // Once the running max settles, alpha is exactly 1 and the rescale is
  // skipped (a warp-uniform branch; a product by 1 changes nothing).
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i % 4) / 2];
      if constexpr (C::kHalf) {
#pragma unroll
        for (int i = 0; i < 16; ++i) acc_h[i] *= alpha[(i % 4) / 2];
      }
      if constexpr (kRowSumProduct) {
#pragma unroll
        for (int i = 0; i < 4; ++i) lsum[i] *= alpha[i / 2];
      }
    }
  };

  uint32_t p[4][4];
  float alpha[2];
  if constexpr (kVariant == kQk) {
    // q.k^T of every tile; tile a's scores (keys 64 a ..) become O's atom a.
    for (int kt = 0; kt < n_tiles; ++kt) {
      issue_qk(sc, kt);
      wgmma_wait<0>();
      fence_regs(sc);
      release(2 * kt);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        if (kt == a) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[a][i] = sc[i];
        }
      wait_full(2 * kt + 1);
      release(2 * kt + 1);
    }
  } else if constexpr (kVariant == kNoSoftmax) {
    // P = bf16(S) as it stands, then O += P V(kt).
    for (int kt = 0; kt < n_tiles; ++kt) {
      issue_qk(sc, kt);
      wgmma_wait<0>();
      fence_regs(sc);
      release(2 * kt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      issue_pv(p, kt);
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
      release(2 * kt + 1);
    }
  } else if constexpr (Launch<HD, kVariant>::kPipeLoop) {
    // FA3's in-warpgroup overlap. A step takes tile kt's P and does, in
    // this order: issue q.k^T(kt + 1) into the score set; issue p.V(kt);
    // wait until at most one wgmma group runs (q.k^T(kt + 1) has landed,
    // p.V(kt) may still run); tile kt + 1's mask and softmax into the other
    // P set, while p.V(kt) runs on the tensor cores; wait for p.V(kt); O *=
    // alpha(kt + 1). So O still sees O *= alpha(kt), O += P(kt) V(kt), O *=
    // alpha(kt + 1), ..., and m and l the same updates in the same order as
    // in variant 0: bit for bit its result. O is not touched between p.V's
    // issue and its wait, nor the P set it reads. One score set serves: tile
    // kt's softmax has read it before q.k^T(kt + 1) is issued. The loop is
    // unrolled by two, so the P sets swap by name; the last step, whose
    // softmax masks the last tile, is peeled. (One P set, P(kt + 1) kept in
    // the score set as fp32 and rounded after p.V(kt)'s wait, took 2 more
    // registers and ran 1-4% slower, PERF.md.) The ring loads K(0), V(0),
    // K(1), ...; a step waits on K(kt + 1) (load 2 kt + 2), then V(kt) (load
    // 2 kt + 1), and the producer has issued both: the stages they reuse,
    // K(kt - 1)'s and V(kt - 2)'s, were released in earlier steps (Launch).
    uint32_t p2[4][4];
    const std::integral_constant<int, kMaskNever> unmasked{};
    const std::integral_constant<int, kMaskAlways> masked{};
    auto step = [&](uint32_t (&p_cur)[4][4], uint32_t (&p_next)[4][4], int kt, auto mask) {
      issue_qk(sc, kt + 1);
      issue_pv(p_cur, kt);
      wgmma_wait<1>();
      fence_regs(sc);
      release(2 * kt + 2);
      softmax(sc, kt + 1, p_next, alpha, mask);
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
      release(2 * kt + 1);
      rescale(alpha);
    };
    auto last = [&](uint32_t (&p_cur)[4][4], int kt) {
      issue_pv(p_cur, kt);
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
      release(2 * kt + 1);
    };
    issue_qk(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(0);
    if (n_tiles == 1) {
      softmax(sc, 0, p, alpha, masked);
      rescale(alpha);
      last(p, 0);
    } else {
      softmax(sc, 0, p, alpha, unmasked);
      rescale(alpha);
      int kt = 0;
      for (; kt + 3 < n_tiles; kt += 2) {
        step(p, p2, kt, unmasked);
        step(p2, p, kt + 1, unmasked);
      }
      if (kt + 2 < n_tiles) {  // three tiles left: an odd count
        step(p, p2, kt, unmasked);
        step(p2, p, kt + 1, masked);
        last(p, kt + 2);
      } else {
        step(p, p2, kt, masked);
        last(p2, kt + 1);
      }
    }
  } else if constexpr (kVariant != kDma) {
    // Per tile: q.k^T, the softmax, p.V. Each stage is released as soon as its
    // wgmma has read it, so K(kt + 1) loads during this tile's softmax and p.V.
    for (int kt = 0; kt < n_tiles; ++kt) {
      issue_qk(sc, kt);
      wgmma_wait<0>();
      fence_regs(sc);
      release(2 * kt);
      softmax(sc, kt, p, alpha, mask_last);
      rescale(alpha);
      issue_pv(p, kt);
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
      if constexpr (C::kHalf) fence_regs(acc_h);
      if constexpr (kRowSumProduct) fence_regs(lsum);
      release(2 * kt + 1);
    }
  }

  // O / rowsum, rounded to bf16, staged in the Q tile's shared memory (q.k^T
  // has read it for the last time) in the same swizzled layout, then written
  // by one TMA store a 64-column atom; the map clips rows at or beyond N.
  // kQk and kNoSoftmax do not divide; kDma stores the Q tile as it arrived.
  // kStagedOut: the warpgroup writes the tile's d columns through `out`.
  if constexpr (kVariant != kDma) {
    float inv[2] = {1.f, 1.f};
    if constexpr (kRowSumProduct) {
      inv[0] = 1.f / lsum[0], inv[1] = 1.f / lsum[2];
    } else if constexpr (kVariant != kQk && kVariant != kNoSoftmax) {
      inv[0] = 1.f / l[0], inv[1] = 1.f / l[1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(sq + sw128_offset(row, kAtom * a + 8 * j) + 4 * t) =
              pack_bf16(acc[a][4 * j + 2 * r] * inv[r], acc[a][4 * j + 2 * r + 1] * inv[r]);
      if constexpr (C::kHalf) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(sq + sw128_offset(row, kAtom * C::kAtoms + 8 * j) + 4 * t) =
              pack_bf16(acc_h[4 * j + 2 * r] * inv[r], acc_h[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
  if constexpr (kStagedOut || C::kHalf) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWGThreads) : "memory");
    store_rows<C::kHalf ? 8 : 4>(sq, out, b, h, q0, N, tid);
    return;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWGThreads) : "memory");
  if (tid == 0) {
    const HeadTiles tiles(order, h, b);
#pragma unroll
    for (int a = 0; a < C::kBoxes; ++a)
      tma_store<kRank>(&o_or_vhalf_map, q_tile + a * kAtomBytes, tiles, a * kAtom, q0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem read: may exit
  }
}

// --- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so the
// library links no libcuda; null if the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The shape of the tensor maps over the inputs' Layout L and the output's
// Lo (with N rows): rank 4 or 5, sizes, and element strides of each,
// innermost (the HD columns) first, in one dim order, so one MapAddress
// addresses a tile in every map.
struct MapShape {
  long long size[5];
  long long stride[5];      // the inputs'
  long long out_stride[5];  // the output's (and the RoPE scratch's)
  int rows_dim;
  MapAddress order;
};

// The outer dimensions go in ascending order of the inputs' stride. A
// dimension of size 1 (other than the rows) is left out: it is never
// stepped, and its stride may hold any value. The group joins the
// head-in-group dimension when the heads are evenly spaced across groups in
// both Layouts. Trailing dimensions of size 1 pad the rank to 4. So a flat
// tensor's map is (64, H, rows, B), a head-major one's (d, rows, H, B), a
// head-major view of a flat one's the flat map (d, H, rows, B), the packed
// view of a flat tensor's the flat map (64, H, rows, B), and a contiguous
// packed one's (64, 2, rows, H/2, B); a view of a fused (B, N, 3D)
// projection has the map of its flat (or head-major, or packed) context,
// at row stride 3D. The output's strides follow the same order: the
// wrapper allocates it dense in the inputs' dim order. False if the heads
// of a group are split from their group in the map and number other than a
// power of two (no layout of the port's entries). d is the heads' width:
// the maps' innermost extent, which may be below the width a body runs at
// (the columns between load as zeros).
inline bool map_shape(const Layout& L, const Layout& Lo, int d, int B, int N, int H,
                      MapShape* m) {
  const int hpg = L.heads_per_group;
  const long long size[4] = {hpg, N, H / hpg, B};
  // (A single row's stride may hold any value too: it becomes d.)
  const long long stride[4] = {d, N > 1 ? L.row_stride : d, L.group_stride, L.batch_stride};
  const long long out_stride[4] = {d, N > 1 ? Lo.row_stride : d, Lo.group_stride,
                                   Lo.batch_stride};
  int idx[4] = {0, 1, 2, 3};
  for (int i = 1; i < 4; ++i)
    for (int j = i; j > 0 && stride[idx[j]] < stride[idx[j - 1]]; --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  *m = MapShape{{d}, {1}, {1}, 0, {}};
  int rank = 1, in_group_dim = 0, group_dim = 0;
  long long span = d, out_span = d;  // elements from the first to past the last
  for (int p = 0; p < 4; ++p) {
    const int i = idx[p];
    if (size[i] == 1 && i != 1) continue;
    span += (size[i] - 1) * stride[i];
    out_span += (size[i] - 1) * out_stride[i];
    const int last = rank - 1;
    if (i == 2 && last > 0 && in_group_dim == last && stride[i] == m->stride[last] * size[0] &&
        out_stride[i] == m->out_stride[last] * size[0]) {
      m->size[last] *= size[i];  // heads evenly spaced: one map dimension of all H
      continue;
    }
    if (i == 0) in_group_dim = rank;
    if (i == 1) m->rows_dim = rank;
    if (i == 2) group_dim = rank;
    if (i == 3) m->order.image[rank - 1] = 1;
    m->size[rank] = size[i];
    m->stride[rank] = stride[i];
    m->out_stride[rank] = out_stride[i];
    ++rank;
  }
  // The head's coordinate: whole in the one map dimension that holds heads,
  // or split as (h % hpg, h / hpg) when both are in the map.
  if (in_group_dim && group_dim) {
    if (hpg & (hpg - 1)) return false;
    m->order.head_mask[in_group_dim - 1] = hpg - 1;
    m->order.head_mask[group_dim - 1] = -1;
    for (int s = hpg; s > 1; s >>= 1) ++m->order.head_shift[group_dim - 1];
  } else if (in_group_dim || group_dim) {
    m->order.head_mask[(in_group_dim ? in_group_dim : group_dim) - 1] = -1;
  }
  m->order.rows[m->rows_dim - 1] = 1;
  for (; rank < 4; ++rank) {
    m->size[rank] = 1;
    m->stride[rank] = (span + kChunk - 1) / kChunk * kChunk;  // a 16-byte multiple
    m->out_stride[rank] = (out_span + kChunk - 1) / kChunk * kChunk;
  }
  m->order.rank = rank;
  return true;
}

// The bf16 map of one of Q, K, V or O, covering `rows` rows of each head,
// at the inputs' strides or (`out`) the output's; a box of one 64-column
// atom by 64 rows, 128-byte swizzle, or (`cols` kHalfAtom: V's last 32
// columns at a build with a half atom, Tiles) of 32 columns, 64-byte
// swizzle; zeros out of bounds. The driver refuses a base address or a
// stride that is not a 16-byte multiple (the wrapper checks both first).
inline bool encode_map(CUtensorMap* map, const void* base, const MapShape& m, int rows,
                       bool out = false, int cols = kAtom) {
  const long long* stride = out ? m.out_stride : m.stride;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int rank = m.order.rank, rows_dim = m.rows_dim;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  for (int d = 0; d < rank; ++d) {
    dims[d] = static_cast<cuuint64_t>(d == rows_dim ? rows : m.size[d]);
    box[d] = d == 0 ? cols : d == rows_dim ? kBlockN : 1;
    if (d > 0) strides[d - 1] = static_cast<cuuint64_t>(stride[d]) * sizeof(__nv_bfloat16);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == kAtom ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// What a launch of a bf16 Hopper body needs besides its kernel and grid:
// the four tensor maps, their MapAddress, the tables and scale the kernel
// applies to its own Q rows, and (the staged form) where O goes by plain
// stores. Filled by prepare or prepare_staged, which also queue the pass
// that runs before the attention kernel; the one-warpgroup body below and
// the two-consumer body (attention_sm90_ws.cuh) launch from it.
struct Prepared {
  CUtensorMap q_map, k_map, v_map;
  CUtensorMap o_or_vhalf_map;  // O's map, or V's last 32 columns' at a half atom (Tiles)
  MapAddress order;
  const float* cos_t;
  const float* sin_t;
  float scale;
  PlainOut out;
};

// Where plain stores write O's rows of d elements through Lo: the widest
// unit up to `widest` elements that divides d and Lo's strides, and to whose
// bytes o is aligned.
inline PlainOut plain_out(void* o, const Layout& Lo, int d, int widest) {
  int unit = widest;
  while (unit > 1 && (d % unit || Lo.row_stride % unit || Lo.group_stride % unit ||
                      Lo.batch_stride % unit || reinterpret_cast<uintptr_t>(o) % (2 * unit)))
    unit /= 2;
  return PlainOut{static_cast<__nv_bfloat16*>(o), Lo, d, unit};
}

// Over heads of width d for a body built at HD >= d: the maps'
// innermost extent is d, so columns d..HD-1 of every box load as zeros
// (they add nothing to q.k^T or p.V) and the store of O clips them; no copy
// pads a head. With tables (and `rope`), the RoPE prologue (rope_rows)
// first: at d == HD it ropes k into `k_scratch` and the attention kernel
// ropes its Q tiles itself; at d < HD, whose in-kernel rotation would pair
// column c with c + HD/2 instead of c + d/2, it ropes q (times the scale)
// into `q_scratch` and k into `k_scratch`, and the attention kernel runs
// without tables at scale 1. Without `rope` the tables are ignored. q, k and
// v lie as L says; o and the scratch as Lo says, in the same dim order
// (map_shape). At a build with a half atom o_or_vhalf_map is V's last 32
// columns' map and `out` says where O goes (Tiles). Returns the CUDA error of the
// queued prologue, or cudaErrorInvalidValue for arguments no map takes. (A template, so that a
// library builds the prologue's kernels only where it launches a body.)
template <typename T = __nv_bfloat16>
cudaError_t prepare(int HD, const void* q, const void* k, const void* v, void* o,
                    const void* cos_t, const void* sin_t, void* q_scratch, void* k_scratch,
                    int B, int N, int H, int d, const Layout& L, const Layout& Lo,
                    int n_valid, float scale, bool rope, cudaStream_t st, Prepared* p) {
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  if (d > HD || d <= HD - kAtom || d % kChunk) return cudaErrorInvalidValue;
  const auto* c = rope ? static_cast<const float*>(cos_t) : nullptr;
  const auto* s = rope ? static_cast<const float*>(sin_t) : nullptr;
  const void* q_in = q;
  const void* k_in = k;
  bool q_roped = false;  // q_in, and k_in with tables, are scratch laid out as Lo
  if (c != nullptr) {
    const bool padded = d < HD;
    if (k_scratch == nullptr || (padded && q_scratch == nullptr)) return cudaErrorInvalidValue;
    const RopeJob<T> kj{static_cast<const T*>(k), static_cast<T*>(k_scratch), n_valid, 1.f};
    const RopeJob<T> qj{static_cast<const T*>(q), static_cast<T*>(q_scratch), N, scale};
    const cudaError_t err = padded ? launch_rope<T>(qj, kj, 2, c, s, B, H, d, L, Lo, st)
                                   : launch_rope<T>(kj, kj, 1, c, s, B, H, d, L, Lo, st);
    if (err != cudaSuccess) return err;
    k_in = k_scratch;
    if (padded) q_in = q_scratch, q_roped = true, c = s = nullptr, scale = 1.f;
  }
  // A build with a half atom takes V's last 32 columns in O's map's place and
  // writes O with plain stores (Tiles).
  const bool half = HD % kAtom != 0;
  MapShape m;
  if (!map_shape(L, Lo, d, B, N, H, &m) || !encode_map(&p->q_map, q_in, m, N, q_roped) ||
      !(half ? encode_map(&p->o_or_vhalf_map, v, m, n_valid, false, kHalfAtom)
             : encode_map(&p->o_or_vhalf_map, o, m, N, true)) ||
      !encode_map(&p->k_map, k_in, m, n_valid, k_in != k) ||
      !encode_map(&p->v_map, v, m, n_valid))
    return cudaErrorInvalidValue;
  p->order = m.order;
  p->cos_t = c, p->sin_t = s, p->scale = scale;
  p->out = half ? plain_out(o, Lo, d, 8) : PlainOut{};
  return cudaSuccess;
}

// Lo's strides with rows of d elements made w wide: the Layout of scratch
// dense in Lo's dim order (Lo is dense, so each stride of a dimension
// longer than 1 is a multiple of d; false if not).
inline bool widen(const Layout& Lo, int d, int w, int B, int N, int H, Layout* Ls) {
  const auto scaled = [&](long long s, int n, long long* to) {
    *to = s / d * w;
    return n == 1 || s % d == 0;
  };
  Ls->heads_per_group = Lo.heads_per_group;
  return scaled(Lo.batch_stride, B, &Ls->batch_stride) &&
         scaled(Lo.group_stride, H / Lo.heads_per_group, &Ls->group_stride) &&
         scaled(Lo.row_stride, N, &Ls->row_stride);
}

// Over heads of width d whose rows are no 32-byte multiples (d % kStageUnit
// != 0, HD - 64 < d < HD, one head a group: K3), in place: one staging
// launch (stage_rows) writes q (roped with tables, times the scale) into
// `q_scratch` and k (roped) and v into the two planes of `k_scratch`, read
// through L at the alignment they have, into rows of w = d rounded up to
// kStageUnit laid out as the output is (Lo's dim order, widen), the columns
// from d zeros; each scratch plane holds B * H * N * w elements. The maps
// read the scratch at w (from w to HD the columns load as zeros), the
// kernel runs without tables at scale 1 and its epilogue writes O's d
// columns through Lo with plain stores (kStagedOut, `out`). Returns the
// CUDA error of the queued staging launch, or cudaErrorInvalidValue.
template <typename T = __nv_bfloat16>
cudaError_t prepare_staged(int HD, const void* q, const void* k, const void* v, void* o,
                           const void* cos_t, const void* sin_t, void* q_scratch,
                           void* k_scratch, int B, int N, int H, int d, const Layout& L,
                           const Layout& Lo, int n_valid, float scale, cudaStream_t st,
                           Prepared* p) {
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  const int w = (d + kStageUnit - 1) / kStageUnit * kStageUnit;
  Layout Ls;
  if (d > HD || d <= HD - kAtom || d % kStageUnit == 0 || L.heads_per_group != 1 ||
      q_scratch == nullptr || k_scratch == nullptr || (cos_t == nullptr) != (sin_t == nullptr) ||
      !widen(Lo, d, w, B, N, H, &Ls))
    return cudaErrorInvalidValue;
  const auto* c = static_cast<const float*>(cos_t);
  const auto* s = static_cast<const float*>(sin_t);
  T* qs = static_cast<T*>(q_scratch);
  T* ks = static_cast<T*>(k_scratch);
  T* vs = ks + static_cast<size_t>(B) * H * N * w;
  const bool rope = c != nullptr;
  const cudaError_t err =
      launch_stage<T>(StageJob<T>{static_cast<const T*>(q), qs, N, scale, rope},
                      StageJob<T>{static_cast<const T*>(k), ks, n_valid, 1.f, rope},
                      StageJob<T>{static_cast<const T*>(v), vs, n_valid, 1.f, false}, 3, c, s, B,
                      H, d, w, L, Ls, st);
  if (err != cudaSuccess) return err;
  // The maps at w: every stride a 32-byte multiple, and the staging pass
  // wrote zeros in the columns from d to w.
  MapShape m;
  if (!map_shape(Ls, Ls, w, B, N, H, &m) || m.order.rank != 4) return cudaErrorInvalidValue;
  p->o_or_vhalf_map = CUtensorMap{};  // (V's last 32 columns at a build with a half atom)
  if (!encode_map(&p->q_map, qs, m, N) || !encode_map(&p->k_map, ks, m, n_valid) ||
      !encode_map(&p->v_map, vs, m, n_valid) ||
      (HD % kAtom && !encode_map(&p->o_or_vhalf_map, vs, m, n_valid, false, kHalfAtom)))
    return cudaErrorInvalidValue;
  p->order = m.order;
  p->cos_t = p->sin_t = nullptr, p->scale = 1.f;
  p->out = plain_out(o, Lo, d, 4);
  return cudaSuccess;
}

// Launch the Hopper body (bf16) on `stream` over heads of width d, built at
// HD >= d, as prepare sets it up (its RoPE prologue first, with tables).
// kVariant other than kFull runs at d == HD only, and kDma without the
// prologue (it ropes nothing). Returns the CUDA error of the launches
// (cudaSuccess when all were queued).
template <int HD, int kVariant = kFull>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                   const void* sin_t, void* q_scratch, void* k_scratch, int B, int N, int H, int d,
                   const Layout& L, const Layout& Lo, int n_valid, float scale, void* stream) {
  using T = Launch<HD, kVariant>;
  if (kVariant != kFull && d != HD) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  Prepared p;
  cudaError_t err = prepare(HD, q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d, L,
                            Lo, n_valid, scale, kVariant != kDma, st, &p);
  if (err != cudaSuccess) return err;
  const auto kernel = p.order.rank == 5 ? attention_sm90<HD, 5, kVariant>
                                        : attention_sm90<HD, 4, kVariant>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kWGRows - 1) / kWGRows, H, B);
  kernel<<<grid, Config<HD>::kThreads, T::kSmemBytes, st>>>(
      p.q_map, p.k_map, p.v_map, p.o_or_vhalf_map, p.cos_t, p.sin_t, N, n_valid, p.scale, p.order,
      p.out);
  return cudaGetLastError();
}

// Launch the Hopper body (bf16) on heads of width d whose rows are no
// 32-byte multiples, as prepare_staged sets it up: the staging launch, then
// the attention kernel's staged form (kStagedOut). Returns the CUDA error
// of the launches (cudaSuccess when both were queued).
template <int HD>
cudaError_t launch_staged(const void* q, const void* k, const void* v, void* o,
                          const void* cos_t, const void* sin_t, void* q_scratch, void* k_scratch,
                          int B, int N, int H, int d, const Layout& L, const Layout& Lo,
                          int n_valid, float scale, void* stream) {
  using C = Config<HD>;
  const auto st = static_cast<cudaStream_t>(stream);
  Prepared p;
  cudaError_t err = prepare_staged(HD, q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H,
                                   d, L, Lo, n_valid, scale, st, &p);
  if (err != cudaSuccess) return err;
  const auto kernel = attention_sm90<HD, 4, kFull, true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kWGRows - 1) / kWGRows, H, B);
  kernel<<<grid, C::kThreads, C::kSmemBytes, st>>>(p.q_map, p.k_map, p.v_map, p.o_or_vhalf_map,
                                                   nullptr, nullptr, N, n_valid, 1.f, p.order, p.out);
  return cudaGetLastError();
}

}  // namespace sm90

// The widths the bf16 Hopper bodies are built at up to 256: this file's at
// 64 to 192, the two-consumer body's (attention_sm90_ws.cuh) at 224 and 256.
// Each product runs at the head's own width to the next 32 columns, as
// FlashAttention-3's Hopper kernel is built at 64, 96, 128, 192 and 256.
// ops/flash_attention.py's BF16_HEAD_DIMS lists them.
constexpr int kBf16Widths[] = {64, 96, 128, 160, 192, 224, 256};

// The width a bf16 Hopper body runs a d-wide head at (d up to 256), its maps
// at d: the first of kBf16Widths at or above d.
inline int bf16_width(int d) {
  for (const int w : kBf16Widths)
    if (d <= w) return w;
  return -1;
}

// The width an fp32 Hopper body runs a d-wide head at (maps at d): the next
// of 64 and 128 (attention_sm90_tf32.cuh) and 192 and 256
// (attention_sm90_tf32_wide.cuh); above 256 the width of the slices body's
// scratch (attention_sm90_tf32_slices.cuh), d rounded up to 64.
inline int tf32_width(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : d <= 256 ? 256 : (d + 63) / 64 * 64;
}

// Which body a (dtype, head dim) takes in every entry (K1 and K2 take only
// d = 64): 1 (this file's Hopper body) for bfloat16 up to 192, at
// bf16_width(d); 6 (the two-consumer body, attention_sm90_ws.cuh) for
// bfloat16 from 193 to 256, at 224 or 256 (from 129 to 192 the Hopper body:
// the measured rule above Config); 2 (K3's wide body,
// attention_wide.cuh) for bfloat16 above 256; 3 (attention_sm90_tf32.cuh's
// fp32 Hopper body) for float32 at a multiple of 4 up to 128, 4 (its wide
// form, attention_sm90_tf32_wide.cuh) at one from 132 to 256 and 5 (its
// slices body, attention_sm90_tf32_slices.cuh) at any d above 256; -1 (no
// body) for anything else. ops/flash_attention.py::attention_body mirrors
// it.
inline int sm90_route(int dtype, int head_dim) {
  if (dtype == 1 && head_dim > 0) return head_dim <= 192 ? 1 : head_dim <= kMaxHeadDim ? 6 : 2;
  if (dtype == 0 && head_dim > 256) return 5;
  if (dtype == 0 && head_dim > 0 && head_dim % 4 == 0)
    return head_dim > 128 ? 4 : 3;
  return -1;
}

}  // namespace cbas_attention
