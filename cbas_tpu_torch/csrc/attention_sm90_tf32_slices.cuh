// The fp32 Hopper body for K3's heads wider than 256: float32 at any d above
// 256, d a run-time argument, O in slices of 384 columns. Only
// attention_headmajor.cu includes it.
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention) in fp32 at d > 256, where the port ran scalar FMAs
// before (an fp32 kernel in attention_wide.cuh). The function and its
// rounding points are attention_sm90_tf32.cuh's (3xTF32: every fp32 operand split by tf32_split
// into TF32 hi and lo, every product lo.hi + hi.lo + hi.hi on wgmma .tf32,
// q.k^T's small products and each tile's p.V in accumulators of their own;
// the accurate expf; keys at or beyond n_valid masked by select, their V rows
// zero; the prologue splitting K (roped) and V^T into scratch). One sum
// differs, as in attention_sm90_tf32_wide.cuh: q.k^T is formed in two
// halves of d's 32-column atoms, one a warpgroup, each half's large and
// small products added in fp32, then the two halves added.
//
// What bounds it on this card: operations, at the 3xTF32 rate (165 TFLOP/s
// of fp32-accurate products), 4 N n_valid d FLOP a head with the scores
// formed once. What stands in the way: one warpgroup of 64 rows holds O and
// the tile's p.V in 2 x (columns / 2) registers a thread, so a block cannot
// own all of a wide head's O; Q in fp32 is 64 d 4 bytes (80 KB at d 320,
// 96 KB at 384) beside the ring. What the design does:
//
// - Slices: a block owns 64 query rows and one slice of O of kSliceChunks
//   64-column chunks (384 columns); ceil(d / 384) slices, so the scores of a
//   (query tile, key tile) are formed once up to d 384, once a slice above.
//   256-column slices (attention_sm90_tf32_wide.cuh's 64 + 64 accumulator
//   registers a thread, the scores formed twice at 257-512) ran 1.5-1.7x
//   slower on the card
//   (PERF.md, chip_slices.py).
// - Two consumer warpgroups, 256 threads (no producer warp: above 256
//   threads a thread gets at most 168 registers). Warpgroup w forms the
//   partial q.k^T over ceil(atoms / 2) of d's 32-column atoms (w's half;
//   warpgroup 1's last one lies past d where atoms is odd: zeros), meets
//   the other's in shared memory, runs the same online softmax on the same
//   scores, and owns the slice's O chunks w, w + 2 and w + 4: 96 accumulator
//   registers a thread, each chunk's p.V in one of two 32-register buffers,
//   folded into O while the next chunk's runs. Every count that steers a
//   wgmma is the same in both warpgroups (ptxas serialized the wgmma of
//   paths it could not prove uniform), so a chunk past d is computed on
//   whatever V^T rows lie there (the next head's, or the TMA's zeros) and
//   not stored.
// - q.k^T an atom (4 k-steps) a commit group, one in flight: Q's fragments
//   loaded from shared memory and split in registers at each k-step
//   (register-A wgmma, as p.V takes P). Only the first group of a tile
//   starts the accumulator chains, by a compile-time scale-d 0.
// - One ring a warpgroup, fed by its thread 0, of 16 KB stages: a chunk of
//   K (two 32-column atoms of 32 keys, hi and lo planes) or of V^T (64 rows
//   of O's columns by 32 keys, hi and lo), as many stages as shared memory
//   leaves, at most kMaxSlots (4 at d 320, 3 at 384).
// - Q without the TMA: each warpgroup stages its own atoms with zero-filled
//   loads (16-byte ones where d % 8 == 0), roped at d/2 from the tables and
//   scaled in the same pass, into the 128-byte-swizzled atoms q.k^T reads.
//   So any d, and any row stride, is read in place. Q stays resident up to
//   d = 576; above, each warpgroup restages a 64-column chunk of it beside
//   each K chunk, every key tile.
// - The output is written from registers, 8-byte stores where d is even.
// - The prologue, split_kv_wide: split_kv at a run-time width (d rounded up
//   to 64, so every chunk lies in its head), one block a 64-column slab of
//   32 keys, V transposed through shared memory, 4, 2 or 1 columns a thread
//   as d allows.
//
// Grid: (ceil(N / 64) query blocks, H, B x slices), 256 threads.

#pragma once

#include <type_traits>

#include "attention_sm90_tf32_wide.cuh"

namespace cbas_attention {
namespace tf32_slices {

using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::RingCursor;
using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;
using tf32::kAtomCols;
using tf32::kKeys;
using tf32::kRows;
using tf32::kSlotOfKey;
using tf32::kSplitKeys;
using tf32::kWGThreads;
using tf32::sw128_f32;
using tf32::tf32_split;
using tf32::wgmma_rs;

constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * kWGThreads;
constexpr int kChunkCols = 64;                          // a stage's columns of d, or of O
constexpr int kChunkAtoms = kChunkCols / kAtomCols;     // 32-column atoms a chunk
constexpr int kOutChunks = 3;                           // O chunks a warpgroup owns
constexpr int kSliceChunks = kConsumers * kOutChunks;   // and a block: 384 columns
constexpr int kSliceCols = kSliceChunks * kChunkCols;
constexpr int kAtomBytes = kKeys * 128;                 // an atom of K: 32 keys
constexpr int kQAtomBytes = kRows * 128;                // an atom of Q: 64 rows
// A K chunk's hi (or lo) plane, or a V^T chunk's (64 rows of 32 keys).
constexpr int kPlaneBytes = kChunkAtoms * kAtomBytes;
static_assert(kPlaneBytes == kChunkCols * kKeys * 4, "K and V^T chunks share the stage size");
constexpr int kStageBytes = 2 * kPlaneBytes;            // hi, then lo: 16 KB
constexpr int kQChunkBytes = kChunkAtoms * kQAtomBytes;  // a streamed chunk of Q
constexpr int kMaxSlots = 4;
constexpr int kMinSlots = 2;
constexpr int kPartialBytes = kRows * kKeys * 4;        // a warpgroup's partial scores
// Each warpgroup's full and empty barrier a stage, and the partials' three.
constexpr int kBarriers = kConsumers * 2 * kMaxSlots + 3;
constexpr size_t kSmemMax = 232448;  // the 227 KB a Hopper block may opt into

// Dynamic shared memory of a block with q_bytes of Q and `slots` stages a
// ring: 1024 bytes of slack to align the tiles to the swizzle's period, Q,
// the rings, the partials, the barriers.
__host__ __device__ constexpr size_t smem_bytes(size_t q_bytes, int slots) {
  return 1024 + q_bytes + static_cast<size_t>(kConsumers) * slots * kStageBytes +
         kConsumers * kPartialBytes + kBarriers * 8;
}

// Stages a ring for q_bytes of Q: as many as fit, at most kMaxSlots.
__host__ __device__ constexpr int ring_slots(size_t q_bytes) {
  const size_t used = smem_bytes(q_bytes, 0);
  const size_t room = used < kSmemMax ? (kSmemMax - used) / (kConsumers * kStageBytes) : 0;
  return room < kMaxSlots ? static_cast<int>(room) : kMaxSlots;
}

// Q's resident bytes at d: each warpgroup's ceil(atoms / 2) atoms, so d
// rounded up to a chunk.
__host__ __device__ constexpr size_t resident_q_bytes(int d) {
  return static_cast<size_t>((d + kChunkCols - 1) / kChunkCols) * kChunkAtoms * kQAtomBytes;
}
__host__ __device__ constexpr bool q_resident(int d) {
  return ring_slots(resident_q_bytes(d)) >= kMinSlots;
}
static_assert(q_resident(576) && !q_resident(577), "Q stays resident up to d = 576");
static_assert(ring_slots(kConsumers * kQChunkBytes) == kMaxSlots, "streamed Q leaves a full ring");

// Atoms [a0, a0 + n_atoms) of rows [q0, q0 + 64) of one head of q (`head`,
// rows row_stride apart, d wide) into `dst` (atom j of them at
// j * kQAtomBytes, 128-byte swizzled): roped with (N, d) tables, rotate-half
// pairing column c with c + d/2, each value rounded once by the rotation and
// once by the scale, as attention_sm90_tf32.cuh's block rounds it. Columns
// at or beyond d and rows at or beyond N are zeros. `vec` (d % 8 == 0): four
// columns at a time, whose partners are four aligned columns too. The
// `threads` threads of the caller from `tid` take one element (or four)
// each in turn.
__device__ __forceinline__ void stage_q(unsigned char* dst, const float* __restrict__ head,
                                        long long row_stride, const float* __restrict__ cos_t,
                                        const float* __restrict__ sin_t, int N, int d, int q0,
                                        int a0, int n_atoms, float scale, bool vec, int tid,
                                        int threads) {
  const int half = d / 2;
  const int c_first = a0 * kAtomCols;
  auto element = [&](auto width) {
    constexpr int V = decltype(width)::value;
    const int groups = n_atoms * kAtomCols / V;
    for (int i = tid; i < kRows * groups; i += threads) {
      const int r = i / groups;
      const int c = c_first + (i % groups) * V;
      const int n = q0 + r;
      float x[V] = {};
      if (n < N && c < d) {
        const float* row = head + static_cast<size_t>(n) * row_stride;
        load_table<V>(row + c, x);
        if (cos_t != nullptr) {
          float xp[V], cs[V], sn[V];
          const size_t t = static_cast<size_t>(n) * d + c;
          load_table<V>(row + (c < half ? c + half : c - half), xp);
          load_table<V>(cos_t + t, cs);
          load_table<V>(sin_t + t, sn);
#pragma unroll
          for (int e = 0; e < V; ++e) x[e] = rope(x[e], xp[e], c < half, cs[e], sn[e]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] *= scale;
      }
      float* at = reinterpret_cast<float*>(dst + sw128_f32(r, c - c_first, kQAtomBytes));
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(at) = make_float4(x[0], x[1], x[2], x[3]);
      else
        *at = x[0];
    }
  };
  if (vec)
    element(std::integral_constant<int, 4>{});
  else
    element(std::integral_constant<int, 1>{});
}

// One block: query rows [blockIdx.x * 64, +64) of head blockIdx.y, O chunks
// [4 s, 4 s + 4) of image b, where blockIdx.z = b * n_slices + s. Warps 0-3
// and 4-7 are the consumer warpgroups 0 and 1. q is read through L, `out`
// written through Lo (one head a group). k_map is rank 3 over the scratch's
// K planes (width, B H n_keys rows, planes 0-1), v_map over its V^T planes
// (n_keys, B H width rows, planes 2-3), boxes of 32 keys and of 64 rows.
// Tables are (N, d). kQResident: all of Q's atoms stay in shared memory (d
// <= 576); else each warpgroup restages a chunk of it beside each K chunk.
template <bool kQResident>
__global__ void __launch_bounds__(kThreads, 1)
attention_tf32_slices(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ q,
                      float* __restrict__ out, const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t, int N, int d, int n_valid, int n_keys,
                      int width, int H, int n_slices, Layout L, Layout Lo, float scale,
                      int slots) {
  constexpr int kPSteps = kKeys / 8;  // k-steps of p.V
  constexpr int kS = kKeys / 2;       // score registers a thread
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int wtid = tid % kWGThreads;
  const int warp = wtid / 32;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int h = blockIdx.y;
  const int b = blockIdx.z / n_slices;
  const int slice = blockIdx.z % n_slices;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (n_valid + kKeys - 1) / kKeys;  // tiles past n_valid add zeros
  // Every count that steers a wgmma is the same in both warpgroups (ptxas
  // serializes the wgmma of a path it cannot prove uniform): each takes
  // my_atoms = ceil(atoms / 2) atoms of d for q.k^T (warpgroup 1's last one
  // may lie past d: zeros in Q and in the K planes, which are d rounded up to
  // a chunk wide) in my_k chunks (K loads a tile), and kOutChunks O chunks,
  // chunk0 + 2 c, those past d computed on whatever V^T rows lie there and
  // not stored.
  const int my_atoms = ((d + kAtomCols - 1) / kAtomCols + 1) / 2;
  const int my_a0 = wg * my_atoms;
  const int my_k = (my_atoms + kChunkAtoms - 1) / kChunkAtoms;
  const int chunk0 = slice * kSliceChunks + wg;
  const int per_tile = my_k + kOutChunks;  // the ring's loads a key tile

  // Shared memory: Q (resident: atom a at a * kQAtomBytes; streamed: one
  // chunk a warpgroup), warpgroup 0's ring, 1's, the partials, the barriers.
  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* sq = raw + (base - raw_addr);
  const int q_bytes = kQResident ? kConsumers * my_atoms * kQAtomBytes : kConsumers * kQChunkBytes;
  const uint32_t ring = base + q_bytes + wg * slots * kStageBytes;
  float* partials = reinterpret_cast<float*>(sq + q_bytes + kConsumers * slots * kStageBytes);
  const uint32_t bars0 = smem_u32(partials) + kConsumers * kPartialBytes;
  const uint32_t bars = bars0 + wg * 2 * kMaxSlots * 8;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kMaxSlots + st); };
  const uint32_t partials_full = bars0 + 8u * kConsumers * 2 * kMaxSlots;
  auto partial_free = [&](int w) { return partials_full + 8u + 8u * w; };

  if (wtid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWGThreads / 32);  // one arrival a warp of the warpgroup
    }
    if (wg == 0) {
      mbar_init(partials_full, kThreads / 32);
      for (int w = 0; w < kConsumers; ++w) mbar_init(partial_free(w), kWGThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring's loads, in order: the warpgroup's K chunks of key tile 0, its
  // V^T chunks of tile 0, its K chunks of tile 1, ...
  const int k_row = (b * H + h) * n_keys;  // the head's first row in K's planes
  const int v_row = (b * H + h) * width;   // and in V^T's
  int issue_tile = 0, issue_item = 0;
  auto issue = [&](int st) {
    const uint32_t dst = ring + st * kStageBytes;
    if (issue_item < my_k) {
      const int a = my_a0 + kChunkAtoms * issue_item;
      const int n_at = min(kChunkAtoms, my_a0 + my_atoms - a);  // 1 or 2, the same in both
      mbar_expect_tx(full(st), 2 * n_at * kAtomBytes);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        for (int j = 0; j < n_at; ++j)
          tf32::tma_load_3d(dst + p * kPlaneBytes + j * kAtomBytes, &k_map, full(st),
                            (a + j) * kAtomCols, k_row + issue_tile * kKeys, p);
    } else {
      const int c = chunk0 + 2 * (issue_item - my_k);
      mbar_expect_tx(full(st), kStageBytes);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        tf32::tma_load_3d(dst + p * kPlaneBytes, &v_map, full(st), issue_tile * kKeys,
                          v_row + c * kChunkCols, p);
    }
    if (++issue_item == per_tile) issue_item = 0, ++issue_tile;
  };
  if (wtid == 0)
    for (int st = 0; st < min(slots, n_tiles * per_tile); ++st) issue(st);

  RingCursor acquired, released;
  auto acquire = [&]() {
    const int st = acquired.stage;
    mbar_wait(full(st), acquired.phase);
    acquired.next(slots);
    return ring + st * kStageBytes;
  };
  // The oldest load not yet released, once the warpgroup's wgmma that read
  // it has completed: each warp arrives, then thread 0 refills the stage
  // with the next load.
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty(released.stage));
    if (wtid == 0 && issue_tile < n_tiles) {
      mbar_wait(empty(released.stage), released.phase);
      issue(released.stage);
    }
    released.next(slots);
  };
  const float* q_head = q + token_offset(L, b, h, 0, d);
  const bool vec = d % 8 == 0;
  auto sync_wg = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWGThreads) : "memory"); };
  unsigned char* my_q = kQResident ? sq : sq + wg * kQChunkBytes;
  if constexpr (kQResident) {
    stage_q(sq + my_a0 * kQAtomBytes, q_head, L.row_stride, cos_t, sin_t, N, d, q0, my_a0,
            my_atoms, scale, vec, wtid, kWGThreads);
    sync_wg();  // q.k^T reads Q through the generic proxy (register A)
  }

  // Accumulator fragments (m64nNk8): element 4 j + e of a thread is row
  // 16 warp + g + 8 (e / 2), column 8 j + 2 t + (e & 1). The accumulators
  // are attention_sm90_tf32.cuh's: s_small for q.k^T's small products, s for
  // its large, pv for a tile's p.V (a 64-column chunk each); none is zeroed
  // (each one's first product does not read it).
  float o[kOutChunks][32];
#pragma unroll
  for (int c = 0; c < kOutChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum
  // pv: the p.V of the warpgroup's chunk c in pv[c % 2], folded into O
  // while the next chunk's runs.
  float s[kS], s_small[kS], pv[2][32];
  float* mine = partials + wg * (kPartialBytes / 4);
  const float* theirs = partials + (1 - wg) * (kPartialBytes / 4);
  // This thread's Q rows (16 warp + g and + 8): a k-step's A fragment is
  // columns t and t + 4 of its 8, the 16-byte chunks 2 kk and 2 kk + 1 of
  // the atom, swizzled by row % 8 = g.
  const unsigned char* q_rows = my_q + 128 * (16 * warp + g) + 4 * t;

  uint32_t a_hi[4][4], a_lo[4][4];
  uint32_t phi[kPSteps][4], plo[kPSteps][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    // The warpgroup's partial S = Q K(kt)^T over its atoms, an atom's 4
    // k-steps a commit group: each k-step's Q fragment loaded and split,
    // Q_lo K_hi and Q_hi K_lo into s_small and Q_hi K_hi into s, then
    // wait_group 0 (one group in flight: with a second, its A registers
    // split while the first ran, ptxas spilled in this run-time loop). A
    // chunk's stage is released once its atoms' groups have completed. Only
    // the tile's first group starts the chains (scale-d 0), a compile-time
    // choice: a run-time one would keep s and s_small live through p.V.
    fence_regs(s);
    fence_regs(s_small);
    uint32_t k_hi = 0;
    // The warpgroup's atom j, from chunk stage k_hi.
    auto qk_atom = [&](int j, auto first) {
      const unsigned char* atom =
          q_rows + (kQResident ? my_a0 + j : j % kChunkAtoms) * kQAtomBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = 2 * kk;
        const float x[4] = {*reinterpret_cast<const float*>(atom + 16 * (c ^ g)),
                            *reinterpret_cast<const float*>(atom + 1024 + 16 * (c ^ g)),
                            *reinterpret_cast<const float*>(atom + 16 * ((c + 1) ^ g)),
                            *reinterpret_cast<const float*>(atom + 1024 + 16 * ((c + 1) ^ g))};
#pragma unroll
        for (int r = 0; r < 4; ++r) tf32_split(x[r], a_hi[kk][r], a_lo[kk][r]);
      }
      const uint32_t k_atom = k_hi + (j % kChunkAtoms) * kAtomBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t sk = k_atom + 32 * kk;
        const int acc = !decltype(first)::value || kk > 0;
        wgmma_rs<kKeys>(s_small, a_lo[kk], sw128_desc(sk, 16, 1024), acc);
        wgmma_rs<kKeys>(s_small, a_hi[kk], sw128_desc(sk + kPlaneBytes, 16, 1024), 1);
        wgmma_rs<kKeys>(s, a_hi[kk], sw128_desc(sk, 16, 1024), acc);
      }
      wgmma_commit();
      wgmma_wait<0>();
    };
    // The chunk of atoms j and j + 1 (where j + 1 < my_atoms), then its stage released.
    auto qk_chunk = [&](int j, auto first) {
      if constexpr (!kQResident) {
        sync_wg();  // every warp has loaded its fragments of the last chunk
        stage_q(my_q, q_head, L.row_stride, cos_t, sin_t, N, d, q0, my_a0 + j,
                min(kChunkAtoms, my_atoms - j), scale, vec, wtid, kWGThreads);
        sync_wg();
      }
      k_hi = acquire();
      qk_atom(j, first);
      if (j + 1 < my_atoms) qk_atom(j + 1, std::false_type{});
      release();
    };
    qk_chunk(0, std::true_type{});
    for (int j = kChunkAtoms; j < my_atoms; j += kChunkAtoms) qk_chunk(j, std::false_type{});
    fence_regs(s);
    fence_regs(s_small);
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] += s_small[i];

    // The two partials meet: each warpgroup writes its own, then adds the
    // other's (a + b == b + a, so both hold the same S). A warpgroup
    // overwrites its partial once the other has read the last tile's.
    if (kt > 0) mbar_wait(partial_free(wg), (kt - 1) & 1);
#pragma unroll
    for (int i = 0; i < kS; ++i) mine[i * kWGThreads + wtid] = s[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(partials_full);
    mbar_wait(partials_full, kt & 1);
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] += theirs[i * kWGThreads + wtid];
    __syncwarp();
    if (lane == 0) mbar_arrive(partial_free(1 - wg));

    // The online softmax, attention_sm90_tf32.cuh's: only the last tile can
    // hold dead keys, masked by select (their p is then exactly 0).
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
    // P split in registers, as the A fragments of p.V (kSlotOfKey's order).
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(s[4 * j + e], phi[j][e / 2 + 2 * (e & 1)],
                                             plo[j][e / 2 + 2 * (e & 1)]);

    // pv = P V(kt) over each of the warpgroup's O chunks, a commit group a
    // chunk: P_lo V_hi and P_hi V_lo over every 8-key step, then P_hi V_hi.
    // A V^T chunk is 64 rows of 32 keys; a k-step is 32 bytes into them.
    // Chunk c - 1 is folded into O (O alpha + its p.V, one fp32 rounding an
    // element) once wait_group says its group completed, its stage released.
#pragma unroll
    for (int c = 0; c <= kOutChunks; ++c) {
      if (c < kOutChunks) {
        float (&acc)[32] = pv[c % 2];
        const uint32_t v_hi = acquire();
        const uint32_t v_lo = v_hi + kPlaneBytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kPSteps; ++j) {
          wgmma_rs<kChunkCols>(acc, plo[j], sw128_desc(v_hi + 32 * j, 16, 1024), j > 0);
          wgmma_rs<kChunkCols>(acc, phi[j], sw128_desc(v_lo + 32 * j, 16, 1024), 1);
        }
#pragma unroll
        for (int j = 0; j < kPSteps; ++j)
          wgmma_rs<kChunkCols>(acc, phi[j], sw128_desc(v_hi + 32 * j, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      if (c > 0) {
        float (&acc)[32] = pv[(c - 1) % 2];
        fence_regs(acc);
        release();
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c - 1][i] = fmaf(o[c - 1][i], alpha[(i % 4) / 2], acc[i]);
      }
    }
  }

  // O / row sum, stored from registers: rows at or beyond N and columns at
  // or beyond d are not written.
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    float* dst = out + token_offset(Lo, b, h, row, d);
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int col0 = (chunk0 + 2 * c) * kChunkCols + 2 * t;
#pragma unroll
      for (int j = 0; j < kChunkCols / 8; ++j) {
        const int col = col0 + 8 * j;
        const float x0 = o[c][4 * j + 2 * r] * inv[r], x1 = o[c][4 * j + 2 * r + 1] * inv[r];
        if (d % 2 == 0) {
          if (col < d) *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
        } else {
          if (col < d) dst[col] = x0;
          if (col + 1 < d) dst[col + 1] = x1;
        }
      }
    }
  }
}

// --- the prologue --------------------------------------------------------------

// tf32::split_kv at a run-time width (d rounded up to kChunkCols), one
// 64-column slab a block, so a head of any width is many small blocks:
// block x takes keys [(x / slabs) * 32, +32) and slab x % slabs of head
// blockIdx.y of image blockIdx.z. K: its share of the key's slots (V
// columns each, `slots` of them over the width), read through L, roped
// with tables (column c with c + d/2), split and written to planes 0 and
// 1, each (B, H, n_keys, width); V: the slab's 64 columns transposed through
// shared memory into the V^T order (kSlotOfKey) and written, split, to
// planes 2 and 3, each (B, H, width, n_keys). Columns d to width and keys
// at or beyond n_valid are zeros in every plane. V (4, 2 or 1) divides d,
// and d/2 with tables: the columns a thread takes at a time. With tables
// slot c takes columns [c, c + V) and their partners [c + d/2, +V), past d/2
// a slot of zeros from d on; without, columns [2c, 2c + V) and
// [2c + V, 2c + 2V).
template <int V>
__global__ void __launch_bounds__(256)
split_kv_wide(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ out,
              const float* __restrict__ cos_t, const float* __restrict__ sin_t, int H,
              int n_keys, int n_valid, int d, int width, Layout L, long long plane) {
  constexpr int kSlabSlots = kChunkCols / 2 / V;  // K slots a block
  __shared__ float vt[kChunkCols][kSplitKeys + 1];
  const int slabs = width / kChunkCols;
  const int slab = blockIdx.x % slabs;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = blockIdx.x / slabs * kSplitKeys;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int half = d / 2;

  for (int i = threadIdx.x; i < kSplitKeys * kSlabSlots; i += blockDim.x) {
    const int r = i / kSlabSlots;
    const int c = (slab * kSlabSlots + i % kSlabSlots) * V;
    const int n = key0 + r;
    int ca = 2 * c, cp = 2 * c + V;  // without tables
    if (cos_t != nullptr) {
      ca = c < half ? c : d + 2 * (c - half);  // past d/2: a slot of zeros
      cp = c < half ? c + half : ca + V;
    }
    float xa[V] = {}, xp[V] = {};
    if (n < n_valid) {
      const float* row = k + token_offset(L, b, h, n, d);
      if (ca < d) load_table<V>(row + ca, xa);
      if (cp < d) load_table<V>(row + cp, xp);
      if (cos_t != nullptr && c < half) {
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
    uint32_t ha[V], la[V], hp[V], lp[V];
#pragma unroll
    for (int e = 0; e < V; ++e) tf32_split(xa[e], ha[e], la[e]), tf32_split(xp[e], hp[e], lp[e]);
    float* dst = out + (head * n_keys + n) * width;
    if constexpr (V == 1) {
      reinterpret_cast<uint32_t*>(dst)[ca] = ha[0];
      reinterpret_cast<uint32_t*>(dst)[cp] = hp[0];
      reinterpret_cast<uint32_t*>(dst + plane)[ca] = la[0];
      reinterpret_cast<uint32_t*>(dst + plane)[cp] = lp[0];
    } else {
      tf32::store_bits<V>(dst + ca, ha);
      tf32::store_bits<V>(dst + cp, hp);
      tf32::store_bits<V>(dst + plane + ca, la);
      tf32::store_bits<V>(dst + plane + cp, lp);
    }
  }

  constexpr int kGroups = kChunkCols / V;
  constexpr int kRowQuads = kSplitKeys / 4;
  const int c0 = slab * kChunkCols;
  for (int i = threadIdx.x; i < kSplitKeys * kGroups; i += blockDim.x) {
    const int r = i / kGroups;
    const int c = (i % kGroups) * V;
    const int n = key0 + r;
    float x[V] = {};
    if (n < n_valid && c0 + c < d) load_table<V>(v + token_offset(L, b, h, n, d) + c0 + c, x);
    const int s = kSlotOfKey(r);
#pragma unroll
    for (int e = 0; e < V; ++e) vt[c + e][s] = x[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kChunkCols * kRowQuads; i += blockDim.x) {
    const int c = i / kRowQuads;
    const int j = (i % kRowQuads) * 4;
    uint4 hi, lo;
    tf32_split(vt[c][j], hi.x, lo.x), tf32_split(vt[c][j + 1], hi.y, lo.y);
    tf32_split(vt[c][j + 2], hi.z, lo.z), tf32_split(vt[c][j + 3], hi.w, lo.w);
    float* dst = out + 2 * plane + (head * width + c0 + c) * n_keys + key0 + j;
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + plane) = lo;
  }
}

// --- host side ---------------------------------------------------------------

// The scratch's width at d > 256: d rounded up to a chunk.
inline int scratch_width(int d) { return (d + kChunkCols - 1) / kChunkCols * kChunkCols; }

// The prologue alone on `stream`: k and v (heads d wide, d > 256, read
// through L) into `scratch`, 4 planes of B H n_keys scratch_width(d) fp32
// (n_keys = tf32::scratch_keys(n_valid)), roped with tables (both null: not
// roped; tables need an even d). Returns the CUDA error of the launch.
inline cudaError_t launch_split(const void* k, const void* v, void* scratch, const void* cos_t,
                                const void* sin_t, int B, int H, int d, const Layout& L,
                                int n_valid, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || n_valid <= 0 || B > 65535 || H > 65535 || L.heads_per_group != 1 ||
      scratch == nullptr || (cos_t == nullptr) != (sin_t == nullptr) || d <= kMaxHeadDim ||
      (cos_t != nullptr && d % 2))
    return cudaErrorInvalidValue;
  const int n_keys = tf32::scratch_keys(n_valid);
  const int width = scratch_width(d);
  const long long plane = static_cast<long long>(B) * H * n_keys * width;
  const auto kernel = d % 8 == 0 ? split_kv_wide<4> : d % 4 == 0 ? split_kv_wide<2> : split_kv_wide<1>;
  kernel<<<dim3(n_keys / kSplitKeys * (width / kChunkCols), H, B), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(scratch),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), H, n_keys, n_valid, d,
      width, L, plane);
  return cudaGetLastError();
}

// Launch the slices body on `stream` over heads of width d > 256: the
// prologue (split_kv_wide) into `scratch` (4 planes of B H
// tf32::scratch_keys(n_valid) scratch_width(d) fp32), then the attention
// kernel. q, k and v lie as L says, o as Lo says (one head a group; rows at
// any stride the wrapper's rule allows). *prologues counts the prologue's
// launches that were queued (0 or 1). Returns the CUDA error of the launches
// (cudaSuccess when both were queued).
inline cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                          const void* sin_t, void* scratch, int B, int N, int H, int d,
                          const Layout& L, const Layout& Lo, int n_valid, float scale,
                          void* stream, int* prologues) {
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  const int n_slices = (d + kSliceCols - 1) / kSliceCols;
  if (d <= kMaxHeadDim || static_cast<long long>(B) * n_slices > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_split(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st);
  if (err != cudaSuccess) return err;
  ++*prologues;
  const int n_keys = tf32::scratch_keys(n_valid);
  const int width = scratch_width(d);
  const long long plane = static_cast<long long>(B) * H * n_keys * width;
  const auto* planes = static_cast<const float*>(scratch);
  CUtensorMap k_map, v_map;
  if (!tf32::encode_plane_map(&k_map, planes, width, static_cast<long long>(B) * H * n_keys, kKeys,
                              plane) ||
      !tf32::encode_plane_map(&v_map, planes + 2 * plane, n_keys,
                              static_cast<long long>(B) * H * width, kChunkCols, plane))
    return cudaErrorInvalidValue;
  const bool resident = q_resident(d);
  const size_t q_bytes = resident ? resident_q_bytes(d) : kConsumers * kQChunkBytes;
  const int slots = ring_slots(q_bytes);
  const size_t smem = smem_bytes(q_bytes, slots);
  const auto kernel = resident ? attention_tf32_slices<true> : attention_tf32_slices<false>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(kSmemMax));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kRows - 1) / kRows, H, B * n_slices);
  kernel<<<grid, kThreads, smem, st>>>(k_map, v_map, static_cast<const float*>(q),
                                       static_cast<float*>(o), static_cast<const float*>(cos_t),
                                       static_cast<const float*>(sin_t), N, d, n_valid, n_keys,
                                       width, H, n_slices, L, Lo, scale, slots);
  return cudaGetLastError();
}

}  // namespace tf32_slices
}  // namespace cbas_attention
