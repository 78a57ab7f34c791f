// K3's wide body: fused attention over head-major (B, H, N, d) heads wider
// than 256, d a run-time argument, in bfloat16 (float32 at those widths runs
// attention_sm90_tf32_slices.cuh). Only attention_headmajor.cu includes it.
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention) at d > 256: the same function as the other bodies
// (optional rotate-half RoPE from (N, d) fp32 tables, the scale on the q
// side, keys at or beyond n_valid masked by select and their K and V rows
// read as zeros, an exact fp32 softmax, the output in bf16), with the same
// rounding points: roped and scaled q rounded to bf16 once, roped k once, p
// before p.V, fp32 row sums.
//
// What bounds it on this card: the bytes of q, k, v and o at N = 261 and the
// 4 N^2 d FLOP of q.k^T and p.V at N = 1205 on the tensor cores. What stands
// in the way: a 64-row tile this wide outgrows one warpgroup's registers (O
// alone is d / 2 fp32 registers a thread). What the design does:
//
// - O in slices of kSliceAtoms 64-column atoms (W = 384 columns). A block
//   owns 64 query rows and one slice, so the scores of a (query tile, key
//   tile) are formed ceil(d / 384) times: once for every d up to 384.
// - Two consumer warpgroups of 64 query rows, 256 threads. Q is
//   loaded once (all of d, resident). Warpgroup w forms the partial q.k^T
//   over atoms w, w + 2, ... (wgmma m64n64k16, both operands in shared
//   memory); the two partials meet in shared memory and each warpgroup adds
//   the other's, so both hold the same sum, bit for bit, and run the same
//   online softmax; then warpgroup w accumulates p.V into the slice's O atoms
//   w, w + 2, w + 4 (at most 3: 96 registers a thread), P staying in
//   registers. Each warpgroup reads its own K and V atoms only, so each
//   feeds its own ring of one-atom stages (as many as the shared memory left
//   by Q holds, at most 8: a key tile ahead at d = 384; 4 at d = 1024): its
//   thread 0 issues the TMA loads (128-byte swizzle, "full" mbarriers
//   counting bytes) and refills a stage once the warpgroup's four warps have
//   released it ("empty" mbarriers), the ring walked by cursors with no
//   division (a division on the consumers' path per load cost time). A
//   producer warp would make the block 288 threads, which ptxas caps at 168
//   registers a thread: too few for 144 of accumulators, scores and P.
//   FA3 lifts that cap with setmaxnreg (the producer gives its registers to
//   the consumers); the one probe of it here did not test it, since ptxas
//   ignored the instruction (C7508: no register count known at the kernel's
//   entry), so that shape is not measured (PERF.md).
// - RoPE once per (token, head): with tables the shared prologue
//   (rope_rows, attention_common.cuh; the Hopper body's too) writes q (the
//   scale folded in) and k roped, each value rounded once, in one launch to
//   two scratch buffers laid out like the output, and the attention kernel
//   reads those through the output's Layout. At an odd d the staging pass
//   (stage_rows, attention_common.cuh) writes the same two buffers, pairing
//   column i with i + d/2 rounded down (and the columns above the first
//   d - d/2 with i - (d - d/2)), rotate-half's pairing of an odd head.
//   Without tables the consumers scale Q in shared memory as it lands (one
//   rounding, as with tables).
// - Any layout of one head a group: the heads lie where the Layouts'
//   strides put them (contiguous head-major tensors, or head-major views of
//   flat (B, N, H*d) or fused (B, N, 3 H*d) projections); the TMA maps and
//   the staging both read through them, and the output is written through
//   its own Layout (dense in the inputs' dim order).
// - d % 8 != 0: rows are not 16-byte aligned, which the TMA needs, so each
//   warpgroup stages its atoms itself with zero-filled loads into the same
//   swizzled layout just before it reads them (slower; no model has such
//   heads).
// - Q stays in shared memory up to kMaxAtoms atoms (d = 1024), where Q, the
//   rings and the partials fill the 227 KB a block may use; a wider head's
//   Q atoms come through the rings with K's, each once per key tile.

#pragma once

#include "attention_sm90.cuh"

namespace cbas_attention {
namespace wide {

using sm90::kAtom;
using sm90::kAtomBytes;
using sm90::RingCursor;
using sm90::kBlockN;
using sm90::kWGRows;
using sm90::kWGThreads;

constexpr int kSliceAtoms = 6;              // O atoms a block owns: W = 384 columns
constexpr int kOutAtoms = kSliceAtoms / 2;  // of them, one consumer warpgroup's
constexpr int kConsumers = 2;
// No producer warp: a block of more than 256 threads is capped at 168
// registers a thread, and a consumer's accumulators, scores and P alone are
// 144 (setmaxnreg, which would move registers from a producer, is not
// measured; PERF.md). Each consumer warpgroup's thread 0 feeds its own ring
// instead.
constexpr int kThreads = kConsumers * kWGThreads;
// Stages of a warpgroup's ring, one atom each: 8 hold a key tile ahead at d = 384.
constexpr int kMaxSlots = 8;
constexpr int kMinSlots = 4;
constexpr int kMaxAtoms = 16;  // Q resident up to d = 1024, streamed above
constexpr int kPartialBytes = kWGRows * kBlockN * 4;  // one warpgroup's partial scores

// A warpgroup's full and empty barrier a stage and Q's, and the partials' three.
constexpr int kBarriers = kConsumers * (2 * kMaxSlots + 1) + 3;
constexpr size_t kSmemMax = 232448;  // the 227 KB a Hopper block may opt into

// Dynamic shared memory of a block whose Q is `atoms` atoms and whose
// rings have `slots` stages each: 1024 bytes of slack to align the tiles to
// the swizzle's period, Q, the rings, the two partial score tiles, the
// barriers.
__host__ __device__ constexpr size_t smem_bytes(int atoms, int slots) {
  return 1024 + static_cast<size_t>(atoms + kConsumers * slots) * kAtomBytes +
         2 * kPartialBytes + kBarriers * 8;
}

// The stages of each ring for Q of `atoms` atoms: as many as fit, at most
// kMaxSlots (kMinSlots at kMaxAtoms).
__host__ __device__ constexpr int ring_slots(int atoms) {
  const size_t room = (kSmemMax - smem_bytes(atoms, 0)) / (kConsumers * kAtomBytes);
  return room < kMaxSlots ? static_cast<int>(room) : kMaxSlots;
}
static_assert(ring_slots(kMaxAtoms) >= kMinSlots, "Q of kMaxAtoms atoms leaves room for the rings");

// A named barrier of `count` threads (id 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (the wgmma reads shared memory through it).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The atom at columns [col0, col0 + 64) of rows [row0, row0 + 64) of one
// head, staged by the 128 threads of a warpgroup into shared memory at `dst`
// in the TMA's 128-byte-swizzled layout, for rows that are not 16-byte
// aligned (d % 8 != 0). Columns at or beyond hd and rows at or beyond
// live_rows load as 0, whatever bits they hold.
__device__ __forceinline__ void stage_atom(unsigned char* dst,
                                           const __nv_bfloat16* __restrict__ head, int row0,
                                           int live_rows, long long row_stride, int col0, int hd,
                                           int wtid) {
  const auto* h16 = reinterpret_cast<const unsigned short*>(head);
  for (int i = wtid; i < kBlockN * (kAtom / 2); i += kWGThreads) {
    const int r = i / (kAtom / 2);
    const int c = 2 * (i % (kAtom / 2));
    const int n = row0 + r;
    uint32_t x = 0;
    if (n < live_rows) {
      const unsigned short* at = h16 + static_cast<size_t>(n) * row_stride + col0 + c;
      if (col0 + c < hd) x = at[0];
      if (col0 + c + 1 < hd) x |= static_cast<uint32_t>(at[1]) << 16;
    }
    *reinterpret_cast<uint32_t*>(dst + sm90::sw128_offset(r, c) + 2 * (c % kChunk)) = x;
  }
}

// One block: query rows [blockIdx.x * 64, +64) of head blockIdx.y, O atoms
// [6 s, 6 s + 6) of image b, where blockIdx.z = b * n_slices + s. Warps 0-3
// and 4-7 are the two consumer warpgroups. Warpgroup w reads Q's atoms and
// K's atoms a = w, w + 2, ... and the slice's V atoms w, w + 2, w + 4 of
// each key tile, through its own ring. With `tma` its thread 0 loads through
// the maps (Q's with N rows, K's and V's with n_valid), a ring ahead,
// refilling a stage once the warpgroup's four warps have released it; else
// the warpgroup stages each atom itself just before it is read.
template <bool kQResident>
__global__ void __launch_bounds__(kThreads, 1)
attention_wide_bf16(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int N, int hd, int n_slices, Layout Lqk,
                    Layout L, Layout Lo, int n_valid, float scale, const sm90::MapAddress order,
                    int tma) {
  using namespace sm90;
  const int atoms = (hd + kAtom - 1) / kAtom;
  // kQResident (up to kMaxAtoms atoms): Q stays in shared memory; else
  // Q's atoms come through the rings beside K's, once per key tile.
  constexpr bool q_resident = kQResident;
  const int q_atoms = q_resident ? atoms : 0;
  const int slots = ring_slots(q_atoms);
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int wtid = tid % kWGThreads;
  const int warp = wtid / 32;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // Shared memory: Q if resident (atom a at a * kAtomBytes), each
  // warpgroup's ring, the two partial score tiles, then each warpgroup's
  // barriers (a full and an empty one a stage, Q's) and the partials' three.
  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t q_tile = (raw_addr + 1023u) & ~1023u;
  unsigned char* sq = raw + (q_tile - raw_addr);
  const uint32_t ring = q_tile + q_atoms * kAtomBytes + wg * slots * kAtomBytes;
  unsigned char* sring = sq + (ring - q_tile);
  float* partial = reinterpret_cast<float*>(sq + (q_atoms + kConsumers * slots) * kAtomBytes);
  const uint32_t bars0 = q_tile + (q_atoms + kConsumers * slots) * kAtomBytes + 2 * kPartialBytes;
  const uint32_t bars = bars0 + wg * (2 * kMaxSlots + 1) * 8;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kMaxSlots + st); };
  const uint32_t q_full = bars + 8u * 2 * kMaxSlots;
  // Both partials of a tile written (one arrival a warp), and warpgroup w's
  // partial read by the other warpgroup (partial_free(w)).
  const uint32_t partials_full = bars0 + kConsumers * (2 * kMaxSlots + 1) * 8;
  auto partial_free = [&](int w) { return partials_full + 8u + 8u * w; };

  const int h = blockIdx.y;
  const int b = blockIdx.z / n_slices;
  const int atom0 = (blockIdx.z % n_slices) * kSliceAtoms;  // the slice's first O atom
  const int slice_atoms = min(kSliceAtoms, atoms - atom0);
  const int q0 = blockIdx.x * kWGRows;
  const int n_tiles = (n_valid + kBlockN - 1) / kBlockN;  // tiles past n_valid add zeros
  const int my_k = (atoms - wg + 1) / 2;        // K atoms wg, wg + 2, ...
  const int my_o = (slice_atoms - wg + 1) / 2;  // O atoms wg, wg + 2, wg + 4 of the slice
  const int k_items = q_resident ? my_k : 2 * my_k;  // loads a key tile: K's (Q a, K a streamed)
  const int per_tile = k_items + my_o;               // then V's
  // This head's first row in a Layout (one head a group).
  auto head_off = [&](const Layout& X) {
    return static_cast<size_t>(b) * X.batch_stride + static_cast<size_t>(h) * X.group_stride;
  };

  if (wtid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWGThreads / 32);  // one arrival a warp of the warpgroup
    }
    mbar_init(q_full, 1);
    if (wg == 0) {
      mbar_init(partials_full, kConsumers * kWGThreads / 32);
      for (int w = 0; w < kConsumers; ++w) mbar_init(partial_free(w), kWGThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring's loads, in order, are the warpgroup's K atoms of key tile 0
  // (each after its Q atom where Q streams), its V atoms of tile 0, its K
  // atoms of tile 1, ... Three cursors walk
  // them without a division: the next load to issue (thread 0, TMA only),
  // to acquire and to release, each as (stage, phase of that stage's
  // barriers).
  RingCursor acquired, released;
  int issue_tile = 0, issue_item = 0;
  const HeadTiles tiles(order, h, b);
  auto issue = [&](int st) {  // the next load into stage st
    const bool kq = issue_item < k_items;
    const bool is_q = kq && !q_resident && issue_item % 2 == 0;
    const int a = kq ? wg + 2 * (q_resident ? issue_item : issue_item / 2)
                     : atom0 + wg + 2 * (issue_item - k_items);
    mbar_expect_tx(full(st), kAtomBytes);
    tma_load<4>(ring + st * kAtomBytes, is_q ? &q_map : kq ? &k_map : &v_map, full(st), tiles,
                a * kAtom, is_q ? q0 : issue_tile * kBlockN);
    if (++issue_item == per_tile) issue_item = 0, ++issue_tile;
  };
  // The next load, the atom at column `col` of rows [row, row + 64) of `src`
  // (q or k through Lqk, v through L; rows at or beyond `live` are zeros):
  // its stage's address once it is there.
  auto acquire = [&](const __nv_bfloat16* src, const Layout& X, int live, int col, int row) {
    const int st = acquired.stage;
    if (tma) {
      mbar_wait(full(st), acquired.phase);
    } else {
      stage_atom(sring + st * kAtomBytes, src + head_off(X), row, live, X.row_stride, col, hd,
                 wtid);
      fence_async();
      named_sync(1 + wg, kWGThreads);
    }
    acquired.next(slots);
    return ring + st * kAtomBytes;
  };
  // Q's atom at shared memory `at` times `scale`, each value rounded to bf16
  // once, by the warpgroup's threads; rows at or beyond N and columns at or
  // beyond hd arrived as zeros and stay so.
  auto scale_atom = [&](unsigned char* at) {
    for (int i = wtid; i < kWGRows * (kAtom / kChunk); i += kWGThreads) {
      uint4* p = reinterpret_cast<uint4*>(at + sw128_offset(i / (kAtom / kChunk),
                                                            (i % (kAtom / kChunk)) * kChunk));
      const uint4 x = *p;
      uint4 y;
      auto* y32 = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
      for (int e = 0; e < kChunk; e += 2)
        y32[e / 2] = pack_bf16(bf16_at(x, e) * scale, bf16_at(x, e + 1) * scale);
      *p = y;
    }
    fence_async();  // the wgmma reads Q through the async proxy
    named_sync(1 + wg, kWGThreads);
  };
  // The oldest load not yet released, called by every thread once the
  // warpgroup's wgmma that read it has completed: with the TMA its stage
  // takes the next load to issue (staged atoms are written just before they
  // are read).
  auto release = [&]() {
    if (tma) {
      if (lane == 0) mbar_arrive(empty(released.stage));
      if (wtid == 0 && issue_tile < n_tiles) {
        mbar_wait(empty(released.stage), released.phase);
        issue(released.stage);
      }
    }
    released.next(slots);
  };

  // This warpgroup's resident Q atoms, and the first loads of its ring.
  if (tma) {
    if (wtid == 0) {
      if (q_resident) {
        mbar_expect_tx(q_full, my_k * kAtomBytes);
        for (int a = wg; a < atoms; a += 2)
          tma_load<4>(q_tile + a * kAtomBytes, &q_map, q_full, tiles, a * kAtom, q0);
      }
      for (int st = 0; st < min(slots, n_tiles * per_tile); ++st) issue(st);
    }
    if (q_resident) mbar_wait(q_full, 0);
  } else if (q_resident) {
    for (int a = wg; a < atoms; a += 2)
      stage_atom(sq + a * kAtomBytes, q + head_off(Lqk), q0, N, Lqk.row_stride, a * kAtom, hd,
                 wtid);
    fence_async();  // the wgmma reads Q through the async proxy
    named_sync(1 + wg, kWGThreads);
  }
  if (q_resident && scale != 1.f) {
    for (int a = wg; a < atoms; a += 2) scale_atom(sq + a * kAtomBytes);
  }

  // Accumulator fragments (m64nNk16): element 4 j + e of a thread is row
  // 16 warp + g + 8 (e / 2), column 8 j + 2 t + (e & 1).
  float acc[kOutAtoms][32];
#pragma unroll
  for (int a = 0; a < kOutAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum
  float* mine = partial + wg * (kPartialBytes / 4);
  const float* theirs = partial + (1 - wg) * (kPartialBytes / 4);

  float sc[32];
  uint32_t p[4][4];
  for (int kt = 0; kt < n_tiles; ++kt) {

    // This warpgroup's partial S = Q K^T over its atoms, one commit group an
    // atom. Both operands K-major: a 16-deep step is 32 bytes into the atoms'
    // rows; 8-row groups are 1024 bytes apart. The first step does not read
    // sc (scale-d 0). An atom's stage is released as soon as its group has
    // completed.
    fence_regs(sc);
    wgmma_fence();
    for (int j = 0; j < my_k; ++j) {
      const int a = wg + 2 * j;
      uint32_t qa = q_tile + a * kAtomBytes;
      if constexpr (!q_resident) {
        qa = acquire(q, Lqk, N, a * kAtom, q0);
        if (scale != 1.f) scale_atom(sq + (qa - q_tile));
      }
      const uint32_t ka = acquire(k, Lqk, n_valid, a * kAtom, kt * kBlockN);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(sc, sw128_desc(qa + kk * 32, 16, 1024),
                           sw128_desc(ka + kk * 32, 16, 1024), j > 0 || kk > 0);
      wgmma_commit();
      if (j > 0) {  // atom j - 1's stages (its Q's first, where Q streams)
        wgmma_wait<1>();
        if constexpr (!q_resident) release();
        release();
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    if constexpr (!q_resident) release();
    release();

    // The two partials meet: each warpgroup writes its own, then adds the
    // other's (a + b == b + a, so both hold the same S). A warpgroup
    // overwrites its partial once the other has read the last tile's.
    if (kt > 0) mbar_wait(partial_free(wg), (kt - 1) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * kWGThreads + wtid] = sc[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(partials_full);
    mbar_wait(partials_full, kt & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] += theirs[i * kWGThreads + wtid];
    __syncwarp();
    if (lane == 0) mbar_arrive(partial_free(1 - wg));

    // The online softmax, as attention_sm90.cuh's: only the last tile can
    // hold dead keys, masked by select (their p is then exactly 0).
    const int k0 = kt * kBlockN;
    if (k0 + kBlockN > n_valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= n_valid) sc[4 * j + e] = kMasked;
    }
    float alpha[2], mxl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m[r], row_reduce<true>(sc, r));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2((m[r] - mx) * kLog2e);  // 0 on the first tile (m = -inf)
      m[r] = mx;
      mxl[r] = mx * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = ex2(fmaf(sc[i], kLog2e, -mxl[(i % 4) / 2]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rs = row_reduce<false>(sc, r);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha[r] + rs;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int a = 0; a < kOutAtoms; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i % 4) / 2];
    }

    // O += P V over this warpgroup's O atoms. MN-major B: a 16-key step is
    // 16 rows (2048 bytes) down the atom; 8-row groups are 1024 bytes apart.
#pragma unroll
    for (int a = 0; a < kOutAtoms; ++a) fence_regs(acc[a]);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kOutAtoms; ++jj) {
      if (jj < my_o) {
        const uint32_t va =
            acquire(v, L, n_valid, (atom0 + wg + 2 * jj) * kAtom, kt * kBlockN);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16<1>(acc[jj], p[kk], sw128_desc(va + kk * 2048, kAtomBytes, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kOutAtoms; ++a) fence_regs(acc[a]);
    for (int jj = 0; jj < my_o; ++jj) release();
  }

  // O / rowsum, rounded to bf16, stored from registers: rows at or beyond N
  // and columns at or beyond hd are not written.
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    __nv_bfloat16* out = o + head_off(Lo) + static_cast<size_t>(row) * Lo.row_stride;
#pragma unroll
    for (int jj = 0; jj < kOutAtoms; ++jj) {
      if (jj >= my_o) continue;
      const int col0 = (atom0 + wg + 2 * jj) * kAtom + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + 8 * j;
        const float x0 = acc[jj][4 * j + 2 * r] * inv[r], x1 = acc[jj][4 * j + 2 * r + 1] * inv[r];
        if (hd % 2 == 0) {
          if (col < hd) *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(x0, x1);
        } else {
          if (col < hd) out[col] = __float2bfloat16(x0);
          if (col + 1 < hd) out[col + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// With tables, q (times the scale) and k roped into the scratch, laid out
// like the output (Lo), by one launch: the shared prologue (rope_rows) at an
// even hd, the staging pass (stage_rows, rows hd wide; counted in
// *prologues) at an odd one. q and k then point at the scratch, Lqk becomes
// Lo and the scale is 1. Returns the launch's CUDA error.
inline cudaError_t rope_first(const __nv_bfloat16*& q, const __nv_bfloat16*& k, void* q_scratch,
                              void* k_scratch, const float* cos_t, const float* sin_t, int B, int N,
                              int H, int hd, Layout& Lqk, const Layout& Lo, int n_valid,
                              float& scale, cudaStream_t st, int* prologues) {
  using T = __nv_bfloat16;
  if (cos_t == nullptr) return cudaSuccess;
  auto* qs = static_cast<T*>(q_scratch);
  auto* ks = static_cast<T*>(k_scratch);
  cudaError_t err;
  if (hd % 2) {
    const StageJob<T> qj{q, qs, N, scale, true};
    err = launch_stage<T>(qj, StageJob<T>{k, ks, n_valid, 1.f, true}, qj, 2, cos_t, sin_t, B, H,
                          hd, hd, Lqk, Lo, st);
    *prologues = 1;
  } else {
    err = launch_rope<T>(RopeJob<T>{q, qs, N, scale}, RopeJob<T>{k, ks, n_valid, 1.f}, 2, cos_t,
                         sin_t, B, H, hd, Lqk, Lo, st);
  }
  q = qs, k = ks, Lqk = Lo, scale = 1.f;
  return err;
}

// Launch the wide body on `stream`: bfloat16 heads of any hd above
// kMaxHeadDim, head-major wherever L puts them (one head a group; contiguous
// tensors and views of flat or fused projections alike), the output where Lo
// puts it (dense in L's dim order). cos_t/sin_t are (N, hd) fp32 tables,
// which need two scratch buffers laid out like the output (roped q, roped
// k), or both null. *prologues is set to the staging launches queued (1 at
// an odd hd with tables, else 0). Returns the CUDA error of the launches
// (cudaSuccess when all were queued).
inline cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                          const void* sin_t, void* q_scratch, void* k_scratch, int B, int N, int H,
                          int hd, const Layout& L, const Layout& Lo, int n_valid, float scale,
                          void* stream, int* prologues) {
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  const int atoms = (hd + kAtom - 1) / kAtom;
  const int n_slices = (atoms + kSliceAtoms - 1) / kSliceAtoms;
  if (hd <= kMaxHeadDim || (cos_t == nullptr) != (sin_t == nullptr) ||
      (cos_t != nullptr && (q_scratch == nullptr || k_scratch == nullptr)) ||
      L.heads_per_group != 1 || static_cast<long long>(B) * n_slices > 65535)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cos_t);
  const auto* s = static_cast<const float*>(sin_t);
  const dim3 grid((N + kTile - 1) / kTile, H, B * n_slices);
  Layout Lqk = L;  // where q and k lie: L, or Lo once roped into the scratch
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  cudaError_t err =
      rope_first(qb, kb, q_scratch, k_scratch, c, s, B, N, H, hd, Lqk, Lo, n_valid, scale, st,
                 prologues);
  if (err != cudaSuccess) return err;
  // The TMA takes rows at 16-byte multiples: d % 8 == 0 (the wrapper checks
  // the strides and base addresses); the warpgroups stage other widths
  // themselves. A view's map is (hd, H, rows, B), a contiguous tensor's
  // (hd, rows, H, B): rank 4 either way. q's and k's maps take the output's
  // strides once they are the roped scratch.
  const int tma = hd % kChunk == 0;
  const bool roped = c != nullptr;
  sm90::MapShape m{};
  CUtensorMap q_map{}, k_map{}, v_map{};
  if (tma && (!sm90::map_shape(L, Lo, hd, B, N, H, &m) || m.order.rank != 4 ||
              !sm90::encode_map(&q_map, qb, m, N, roped) ||
              !sm90::encode_map(&k_map, kb, m, n_valid, roped) ||
              !sm90::encode_map(&v_map, vb, m, n_valid)))
    return cudaErrorInvalidValue;
  const bool q_resident = atoms <= kMaxAtoms;
  const auto kernel = q_resident ? attention_wide_bf16<true> : attention_wide_bf16<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax));
  if (err != cudaSuccess) return err;
  const int q_atoms = q_resident ? atoms : 0;
  kernel<<<grid, kThreads, smem_bytes(q_atoms, ring_slots(q_atoms)), st>>>(
      q_map, k_map, v_map, qb, kb, vb, static_cast<__nv_bfloat16*>(o), N, hd, n_slices, Lqk, L,
      Lo, n_valid, scale, m.order, tma);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace cbas_attention
