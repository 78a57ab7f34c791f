// The batched whole-row attention, for Hopper (sm_90a): a timing kernel of
// its own beside the Hopper body K1-K3 run (attention_sm90.cuh), whose
// helpers (mbarriers, wgmma, swizzled descriptors) it includes and whose
// code it does not change, and the rank-5 maps, RoPE and column reductions
// of attention_rank5.cuh, which it shares with attention_pvt.cu. No encode
// route calls it.
//
// Replaces the TPU kernels of the head-major batched probes of
// benchmarks/attn_probes/, which run a (b, h) item's whole key row at once
// and batch several items into one program:
// - probe13_batched_dot_256.py:134 (make) with qk_kernel (:80, per head
//   pair, q.k^T into scratch, o = q) and qk_batched_kernel (:94, one batched
//   q.k^T, o = q) as the qk stage, and full_batched_kernel (:101, RoPE and
//   scale applied outside) as the full stage; its dma_kernel (:76) is the
//   memory floor (memory_floor.cu);
// - probe16_variants_marginal_256.py:83 with full_batched_kernel (:65);
// - probe21_batched_model_256.py:72, make_batched_kernel's kernel (:41):
//   the full stage with RoPE inside, in bf16 arithmetic;
// - probe26_layouts_256.py:90 batched_kernel (:72, the scale on the fp32
//   scores), :119 batched_kt_kernel (:100, K given transposed, (B*H, d, N))
//   and :208 fatq_kt_kernel (:182, flat q, K and V transposed);
// - probe26b_gbbatch_256.py:104 gbbatch_kernel (:59): flat q, k, v and o,
//   the items of gb images a program, RoPE inside or none;
// - the flat probes, K1's TPU body per (image, head) with RoPE inside (q's
//   tables times the scale, k's plain: at d 64 probe21's tables), pvt off
//   and on: probe18_fat768_256.py:107 fat_kernel (:47) and
//   probe18b_unroll_256.py:158 fat_kernel (:47) and fat_kernel_unroll (:104,
//   pvt) at gb 4 images (48 items) a block on flat views;
//   probe19_fat_gridpair_256.py:88 kernel (:39) at 16 items in (pair, image,
//   head) order on (G, B, 2, N, 64) views of the flat tensors;
//   probe20_fat_model_256.py:95 make_fat_kernel (:40) and
//   probe21_batched_model_256.py:160 make_fat_kernel (:118, pvt) in the
//   model; their dma_kernel (probe18 :102, probe18b :153) is the memory
//   floor at (384, 272, 768); probe24_pairrope_256.py:36's
//   _fat_kernel_pairrope is K1's Pallas body (cbas_tpu's _fat_kernel), whose
//   port is K1;
// - probe12_phase_split_256.py:139 phase_kernel (:49), pvt x noexp: the
//   split stage, 16 heads a program on packed views.
//
// The function, for each (b, h) item (d = 64, N <= 320, bfloat16):
// - full stage: s = q.k^T in fp32, times s_scale (1 where the scale sits in
//   q); keys at or beyond n_valid -> -1e30 by select; m = the row's max over
//   all keys; p = exp(s - m) in fp32; o = (bf16(p).V) / sum(p), V's rows at
//   or beyond n_valid read as zero. An exact softmax against the row's true
//   max: no running max and no rescale, as the probes compute it.
// - qk stage: the scores of every key are formed (and kept live), o = q.
// - split stage: the full stage's function, the scores formed once; under
//   noexp p = s - m, every key below N in the row sum (a dead one adds
//   -1e30 - m: the sum is about -1e30 (N - n_valid) and |o| of order
//   1e-28; V's dead rows add -0), probe12's function.
// - transposed scores (sT): s^T = K.Q^T, the max and the sums down its
//   columns, o^T = V^T.P^T: the same function in another orientation.
// - RoPE inside (full stage, K and V as rows): q = bf16(bf16(q cq) +
//   bf16(rot(q) sq)) and the same for k with (ck, sk), each product and the
//   sum rounded, from bf16 (N, 64) tables (probe21's carry the scale in q's
//   and sqrt(d) in k's; probe26b's are the plain tables, the scale on s).
//   Q is roped as its tile is staged; an item's K tiles are roped in shared
//   memory once, after the TMA lands them, by a warp of their own while the
//   consumers work on the item before: no prologue kernel, no scratch.
//
// Design. A block holds one item's whole K and V in shared memory (N <=
// 320: five 64-row tiles each, 2 x 40 KB) and a second item slot that the
// producer fills with the next item's K and V while this one computes; it
// takes `items` consecutive items in turn (a CTA of the probes' program).
// One producer warp issues the TMA loads; three consumer warpgroups take the
// item's 64-row query blocks in turn (block j of item t goes to warpgroup
// (t * blocks + j) % 3), each with a ring of two Q tiles. Shared memory: 2 x
// 80 KB of K and V, 6 x 8 KB of Q, about 209 KB: one block an SM.
//
// A warpgroup takes its block's exact softmax in two passes over the key
// tiles (the probes' whole-row form with q.k^T formed twice): the first
// keeps the row max, the second forms the same scores again (the same
// products give the same bits), p = exp(s - m) (as 2^(s log2(e) - m log2(e)),
// one FFMA and one MUFU op as K1-K3 take it), the row sums, P rounded to
// bf16 as p.V's A fragments (the accumulator layout of q.k^T is the A layout
// of p.V) and O += P V. Within a warpgroup the tiles run one after another
// (issuing tile kt + 1's q.k^T before tile kt is used made ptxas serialize
// the wgmma for want of registers); the warpgroups overlap each other.
// O is staged in the Q tile for one TMA store. The one-pass form, the block's
// 64 x 320 scores held in registers (160 a thread), was built first and not
// kept: ptxas allocates registers by whole warpgroups, so 288 threads cap a
// thread at 168, and the scores spilled with the wgmma serialized, several
// times K3's time; a producer warpgroup handing its registers to the
// consumers by setmaxnreg did not raise ptxas's allocation (PERF.md). The
// two-pass form needs one score tile and one P tile (48 registers) and costs
// a second q.k^T. The qk stage is the first pass alone: the scores formed
// and reduced.
//
// Transposed operands. K given as (d, N) rows is the MN-major B operand of
// q.k^T (the tile lands d rows of 64 keys, as V's tile lands keys rows of d
// for p.V); V given as (d, N) is the K-major B operand of p.V (as K's tile is
// for q.k^T). The tensor maps end each key extent at n_valid, so dead keys
// load as zeros (NaN bits in dead rows never reach shared memory) and the
// score mask stays a select. Every operand is read through a rank-5 map
// (inner, rows, heads in a group, groups, images) built from its own strides,
// so head-major, flat and head-pair packed views take one path.
//
// The transposed scores (sT). s^T = K.Q^T takes the key tile as wgmma's A
// operand, K-major as it lands, and the Q tile as B. A thread holds two key
// rows of its warp's 16 for 16 query columns: the column max and sum are
// taken within the thread across the key tiles, then over the warpgroup by
// col_reduce (shuffles across the eight row groups, the four warps through
// shared memory), in both passes. P^T is rounded to bf16 into a P^T tile of
// the warpgroup, the MN-major B operand of o^T = V^T.P^T, whose A operand is
// V's resident tile read MN-major (the transpose bit); two barriers a key
// tile order P^T's writes after the last p.V read it and before the next
// reads it. o^T over the column sums goes transposed into the Q tile for
// the store. Where the row form reduces within a quad and keeps P in
// registers, this orientation pays a cross-warp exchange and P^T's trip
// through shared memory, which is what its timing case prices. full+sT
// keeps three warpgroups and two item slots; the three P^T tiles (24 KB) fit
// by giving each warpgroup one Q slot instead of two (Cfg), and the column
// maxima sit in shared memory through pass 2, for at 448 threads a thread
// has at most 128 registers and pass 2 held the 16 sums beside them.
//
// The split stage (probe12's phases): one consumer warpgroup a block, one
// item slot. It forms its query block's scores over every key tile once into
// fp32 shared memory (64 x 320 x 4 = 80 KB: each thread its own accumulator
// elements), takes one pass of the max over them, one of p, its sums and
// bf16 P (with sT: P^T) into shared memory (40 KB), then every p.V with both
// operands from shared memory: P K-major as the Q tile is, or V^T.P^T as
// above. The block's 64 x 320 scores in registers (160 a thread, beside O)
// spilled in the one-pass form at 288 threads (above); here they never
// leave shared memory between the phases.
//
// Shared memory and registers a thread by option set (-Xptxas -v, sm_90a):
// full, full+rope, full+kT, full+kT+vT 209 KB, 113-114 registers; qk 209
// KB, 62; full+rope+sT 213 KB, 128 (the cap at 448 threads); split+rope 218
// KB, 122; split+rope+noexp 128; split+rope+sT 219 KB, 151;
// split+rope+sT+noexp 148 (192 threads: a thread may take 255). No spills
// but where PERF.md says so.
//
// What bounds it on this card: at the probes' shapes (384 or 448 images x 12
// heads, N 272) the bytes of q, k, v and o (0.64-0.75 GB, 0.19-0.22 ms at
// 3.35 TB/s) against 87-102 GFLOP of q.k^T and p.V (0.09-0.10 ms at 989
// TFLOP/s): bytes; and the latency of each block's chain of q.k^T, softmax
// and p.V, which the warpgroups and the item slots overlap with loads. The
// split stage's single warpgroup overlaps nothing of its own: its phases run
// one after another, each its own latency chain.

#include "attention_rank5.cuh"

namespace {

using namespace cbas_attention;
using namespace cbas_attention::sm90;

constexpr int kMaxTiles = 5;    // N <= 320
constexpr int kMaxN = kMaxTiles * kRows;
constexpr uint32_t kSlotBytes = 2 * kMaxTiles * kTile;  // an item's K tiles, then its V tiles

enum Stage : int { kStageFull = 0, kStageQk = 1, kStageSplit = 2 };

// The block's shape and shared memory for an option set. Shared memory, from
// a 1024-byte aligned base: the item slots, the Q rings, each consumer's P
// tiles (full+sT: one P^T tile; split: the item's P or P^T tiles), its fp32
// scores (split), its column-reduction rows (sT: 4 warps x 64 floats; full+sT
// also the 64 column maxima times log2(e), which pass 2 reads from there:
// held in registers beside the 16 column sums they spilled), then
// the mbarriers: kv_full[slots], kv_empty[slots], q_full[consumers][qslots],
// q_empty[consumers][qslots] (a consumer warpgroup's Q ring), k_roped[slots].
//
// full and qk: three consumer warpgroups, two Q slots each, two item slots
// (209 KB). full+sT: three warpgroups of one Q slot each, so that their three
// P^T tiles fit (212 KB): a warpgroup's next Q tile loads only after its O
// tile is stored. split: one warpgroup, whose 64 x 320 fp32 scores take 80
// KB and its P tiles 40 KB, and one item slot (218 KB): the next item's K and
// V load only after the block's last query block of this one.
template <int kStage, bool kST>
struct Cfg {
  static constexpr bool kSplit = kStage == kStageSplit;
  static constexpr int kConsumers = kSplit ? 1 : 3;  // warpgroups
  static constexpr int kConsumerThreads = kConsumers * kWGThreads;
  static constexpr int kThreads = kConsumerThreads + 64;  // + the producer warp and the RoPE warp
  static constexpr int kItemSlots = kSplit ? 1 : 2;
  static constexpr int kQSlots = kST && !kSplit ? 1 : 2;  // Q tiles a consumer warpgroup holds
  static constexpr int kPTiles = kSplit ? kMaxTiles : kST ? 1 : 0;
  static constexpr uint32_t kScoreBytes = kSplit ? kMaxTiles * kRows * kRows * 4 : 0;
  // sT: 4 x 64 floats of col_reduce, then (full+sT) the 64 column maxima
  static constexpr uint32_t kRedBytes = kST ? (kSplit ? 4 : 5) * kRows * 4 : 0;
  static constexpr uint32_t kQBase = kItemSlots * kSlotBytes;
  static constexpr uint32_t kPBase = kQBase + kConsumers * kQSlots * kTile;
  static constexpr uint32_t kScoreBase = kPBase + kConsumers * kPTiles * kTile;
  static constexpr uint32_t kRedBase = kScoreBase + kConsumers * kScoreBytes;
  static constexpr uint32_t kBarBase = kRedBase + kConsumers * kRedBytes;
  static constexpr int kBars = 3 * kItemSlots + 2 * kConsumers * kQSlots;
  static constexpr size_t kSmemBytes = 1024 + kBarBase + 8 * kBars;
  static_assert(kSmemBytes <= 232448, "one block an SM within the 227 KB a block may use");
};

// Named barriers: 0 is __syncthreads; warpgroup w uses 1 + w.

struct Params {
  const __nv_bfloat16* cq;  // RoPE tables, bf16 (N, 64): q's, then k's (null without RoPE)
  const __nv_bfloat16* sq;
  const __nv_bfloat16* ck;
  const __nv_bfloat16* sk;
  int N, n_valid;
  int heads_per_group, heads;  // an item's head h: group h / heads_per_group, h % heads_per_group in it
  int n_items, items;          // all items, and those a block takes in turn
  float s_scale;
};

// One block: items [blockIdx.x * items, +items). The consumer warpgroups
// come first (threads 0-383, or 0-127 for split), then the producer warp and
// the RoPE warp (idle without RoPE). Maps are rank 5: (inner,
// rows, head in group, group, image); Q's, O's and row-form K's and V's
// inner dimension is the head's 64 columns, a transposed operand's its keys.
// kST: the scores transposed (s^T = K.Q^T, column statistics); kNoExp (split
// only): p = s - m.
template <int kStage, bool kRope, bool kKT, bool kVT, bool kST, bool kNoExp>
__global__ void __launch_bounds__(Cfg<kStage, kST>::kThreads, 1)
attention_batched(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap o_map, const Params P) {
  static_assert(!kRope || (kStage != kStageQk && !kKT && !kVT),
                "RoPE inside is built for the full and split stages on row-form K and V");
  static_assert(!kST || (kStage != kStageQk && !kKT && !kVT),
                "the transposed scores are built for the full and split stages on row-form K and V");
  static_assert(!kNoExp || kStage == kStageSplit, "noexp is the split stage's option");
  using C = Cfg<kStage, kST>;
  constexpr int kConsumers = C::kConsumers, kConsumerThreads = C::kConsumerThreads;
  constexpr int kItemSlots = C::kItemSlots, kQSlots = C::kQSlots;
  constexpr uint32_t kQBase = C::kQBase, kBarBase = C::kBarBase;
  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* sbase = raw + (base - raw_addr);
  auto k_tile = [&](int slot, int kt) { return base + slot * kSlotBytes + kt * kTile; };
  auto v_tile = [&](int slot, int kt) {
    return base + slot * kSlotBytes + (kMaxTiles + kt) * kTile;
  };
  auto q_tile = [&](int w, int qs) { return base + kQBase + (w * kQSlots + qs) * kTile; };
  const uint32_t bars = base + kBarBase;
  auto kv_full = [&](int s) { return bars + 8u * s; };
  auto kv_empty = [&](int s) { return bars + 8u * (kItemSlots + s); };
  auto q_full = [&](int w, int qs) { return bars + 8u * (2 * kItemSlots + w * kQSlots + qs); };
  auto q_empty = [&](int w, int qs) {
    return bars + 8u * (2 * kItemSlots + kConsumers * kQSlots + w * kQSlots + qs);
  };
  auto k_roped = [&](int s) { return bars + 8u * (2 * kItemSlots + 2 * kConsumers * kQSlots + s); };

  const int first = blockIdx.x * P.items;
  const int n_mine = min(P.items, P.n_items - first);
  const int n_tiles = (P.n_valid + kRows - 1) / kRows;  // key tiles past n_valid add nothing
  const int n_blocks = (P.N + kRows - 1) / kRows;       // query blocks of an item
  auto coords = [&](int item, int& hp, int& g, int& b) {
    b = item / P.heads;
    const int h = item % P.heads;
    g = h / P.heads_per_group;
    hp = h % P.heads_per_group;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kItemSlots; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), kConsumerThreads / 32);  // one arrival a consumer warp
      mbar_init(k_roped(s), 1);
    }
    for (int w = 0; w < kConsumers; ++w)
      for (int qs = 0; qs < kQSlots; ++qs) {
        mbar_init(q_full(w, qs), 1);
        mbar_init(q_empty(w, qs), 1);  // the warpgroup's storing thread
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads + 32) {
    // RoPE warp: ropes each item's live K rows in shared memory once its
    // tiles land, and signals k_roped. The producer loads an item's K and V
    // as soon as its slot is free (the consumers are then on the item
    // before), so the RoPE runs beside their work. Chunk pairs kBatch a lane
    // at a time: their tables load together, the first batch's before the
    // wait for the tiles.
    if constexpr (kRope) {
      const int lane = threadIdx.x % 32;
      constexpr int kBatch = 2;
      const int pairs = P.n_valid * 4;
      for (int t = 0; t < n_mine; ++t) {
        const int slot = t % kItemSlots;
        for (int i0 = 0; i0 < pairs; i0 += 32 * kBatch) {
          RopeTab tab[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + lane + 32 * u;
            if (i < pairs) tab[u] = rope_tab(P.ck, P.sk, i / 4, (i % 4) * kChunk);
          }
          if (i0 == 0) mbar_wait(kv_full(slot), (t / kItemSlots) & 1);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + lane + 32 * u, key = i / 4;
            if (i < pairs)
              rope_pair(sbase + (k_tile(slot, key / kRows) - base), key % kRows, (i % 4) * kChunk,
                        tab[u]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(k_roped(slot));
      }
    }
    return;
  }
  if (threadIdx.x >= kConsumerThreads) {
    // Producer: one thread loads each item's K and V tiles into its slot,
    // then its Q tiles into the rings of the warpgroups that take them.
    if (threadIdx.x == kConsumerThreads) {
      int lq[kConsumers] = {};
      for (int t = 0; t < n_mine; ++t) {
        int hp, g, b;
        coords(first + t, hp, g, b);
        const int slot = t % kItemSlots;
        mbar_wait(kv_empty(slot), ((t / kItemSlots) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(kv_full(slot), 2 * n_tiles * kTile);
        for (int kt = 0; kt < n_tiles; ++kt) {
          const int key0 = kt * kRows;
          if (kKT)
            tma_load5(k_tile(slot, kt), &k_map, kv_full(slot), key0, 0, hp, g, b);
          else
            tma_load5(k_tile(slot, kt), &k_map, kv_full(slot), 0, key0, hp, g, b);
          if (kVT)
            tma_load5(v_tile(slot, kt), &v_map, kv_full(slot), key0, 0, hp, g, b);
          else
            tma_load5(v_tile(slot, kt), &v_map, kv_full(slot), 0, key0, hp, g, b);
        }
        for (int j = 0; j < n_blocks; ++j) {
          const int w = (t * n_blocks + j) % kConsumers;
          const int qs = lq[w] % kQSlots;
          mbar_wait(q_empty(w, qs), ((lq[w] / kQSlots) & 1) ^ 1);
          mbar_expect_tx(q_full(w, qs), kTile);
          tma_load5(q_tile(w, qs), &q_map, q_full(w, qs), 0, j * kRows, hp, g, b);
          ++lq[w];
        }
      }
    }
    return;
  }

  // The consumer warpgroups.
  const int tid = threadIdx.x;
  const int w = tid / kWGThreads;
  const int wtid = tid % kWGThreads;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int g8 = lane / 4;
  const int t4 = lane % 4;
  int lq = 0;

  for (int t = 0; t < n_mine; ++t) {
    int hp, g, b;
    coords(first + t, hp, g, b);
    const int slot = t % kItemSlots;
    mbar_wait(kv_full(slot), (t / kItemSlots) & 1);
    if constexpr (kRope) mbar_wait(k_roped(slot), (t / kItemSlots) & 1);  // K roped in place

    for (int j = 0; j < n_blocks; ++j) {
      if ((t * n_blocks + j) % kConsumers != w) continue;
      const int qs = lq % kQSlots;
      const uint32_t qa = q_tile(w, qs);
      unsigned char* sq = sbase + (qa - base);
      const int q0 = j * kRows;
      mbar_wait(q_full(w, qs), (lq / kQSlots) & 1);
      if constexpr (kRope) {
        for (int i = wtid; i < kRows * 4; i += kWGThreads)
          if (q0 + i / 4 < P.N)
            rope_pair(sq, i / 4, (i % 4) * kChunk, rope_tab(P.cq, P.sq, q0 + i / 4, (i % 4) * kChunk));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
      }

      // The row form (full, qk): two passes over the item's key tiles, one
      // 64-key tile of scores at a time: the first takes the row max over
      // every key, the second forms the scores again (the same products, so
      // the same bits) for p = exp(s - m), its row sums and p.V. Accumulator
      // element 4 j + e of a thread: row 16 warp + g8 + 8 (e / 2), key
      // column 8 j + 2 t4 + (e & 1) of its tile.
      float s[32];
      auto issue_qk = [&](float (&d)[32], int kt) {
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t a = sw128_desc(qa + kk * 32, 16, 1024);
          if constexpr (kKT)  // d rows of keys: MN-major, 16 rows of d a step
            wgmma_ss<1>(d, a, sw128_desc(k_tile(slot, kt) + kk * 2048, kTile, 1024), kk > 0);
          else  // key rows of d: K-major, 16 columns (32 bytes) a step
            wgmma_ss<0>(d, a, sw128_desc(k_tile(slot, kt) + kk * 32, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      // s times s_scale, then keys at or beyond n_valid -> -1e30 (only the
      // last live tile holds any).
      auto scale_mask = [&](float (&d)[32], int kt) {
        if (P.s_scale != 1.f) {
#pragma unroll
          for (int i = 0; i < 32; ++i) d[i] *= P.s_scale;
        }
        if ((kt + 1) * kRows > P.n_valid) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kt * kRows + 8 * jj + 2 * t4 + (e & 1) >= P.n_valid) d[4 * jj + e] = kMasked;
        }
      };

      // The transposed scores s^T = K.Q^T of key tile kt: the K tile as A
      // (K-major, as the TMA lands it), the Q tile as B (K-major).
      // Accumulator element 4 jj + e of a thread: key row 16 warp + g8 + 8 (e
      // / 2) of the tile, query column 8 jj + 2 t4 + (e & 1).
      auto issue_kq = [&](float (&d)[32], int kt) {
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(d, sw128_desc(k_tile(slot, kt) + kk * 32, 16, 1024),
                      sw128_desc(qa + kk * 32, 16, 1024), kk > 0);
        wgmma_commit();
      };
      // s^T times s_scale, then key rows at or beyond n_valid -> -1e30.
      auto scale_mask_t = [&](float (&d)[32], int kt) {
        if (P.s_scale != 1.f) {
#pragma unroll
          for (int i = 0; i < 32; ++i) d[i] *= P.s_scale;
        }
        if ((kt + 1) * kRows > P.n_valid) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kt * kRows + 16 * warp + g8 + 8 * (e / 2) >= P.n_valid) d[4 * jj + e] = kMasked;
        }
      };
      // O (rows: queries) over its row sums, rounded to bf16, into the Q tile
      // (every product that read it has completed).
      auto store_o_rows = [&](const float (&acc)[32], const float (&l)[2]) {
        const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g8 + 8 * r;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<uint32_t*>(sq + sw128_offset(row, 8 * jj) + 4 * t4) =
                pack_bf16(acc[4 * jj + 2 * r] * inv[r], acc[4 * jj + 2 * r + 1] * inv[r]);
        }
      };
      // O^T (rows: d, columns: queries) over its column sums, rounded to
      // bf16, transposed into the Q tile: element (d r, query c) to row c,
      // column r.
      auto store_o_cols = [&](const float (&acc)[32], const float (&l)[16]) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + g8 + 8 * (e / 2), c = 8 * jj + 2 * t4 + (e & 1);
            *reinterpret_cast<__nv_bfloat16*>(sq + sw128_offset(c, r) + 2 * (r % kChunk)) =
                __float2bfloat16_rn(acc[4 * jj + e] / l[2 * jj + (e & 1)]);
          }
      };
      // P^T of a thread's s^T fragment, rounded to bf16, into the P^T tile at
      // `tile` (rows: keys, 64 query columns): p.V's B operand, MN-major.
      auto store_pt = [&](unsigned char* tile, const float (&p)[32]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g8 + 8 * h;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<uint32_t*>(tile + sw128_offset(row, 8 * jj) + 4 * t4) =
                pack_bf16(p[4 * jj + 2 * h], p[4 * jj + 2 * h + 1]);
        }
      };
      // o^T += V^T(kt) . P^T: V's tile as A (MN-major: the transpose bit), the
      // P^T tile at `pta` as B (MN-major).
      auto issue_vtpt = [&](float (&acc)[32], int kt, uint32_t pta) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(acc, sw128_desc(v_tile(slot, kt) + kk * 2048, kTile, 1024),
                         sw128_desc(pta + kk * 2048, kTile, 1024), kt > 0 || kk > 0);
      };
      float* red = reinterpret_cast<float*>(sbase + C::kRedBase + w * C::kRedBytes);
      auto p_tile = [&](int kt) { return base + C::kPBase + (w * C::kPTiles + kt) * kTile; };

      if constexpr (kStage == kStageSplit) {
        // Split (probe12's phases): every score tile of the block formed
        // once, into fp32 shared memory (a thread's own accumulator
        // elements: tile kt's element i of thread wtid at (32 kt + i) 128 +
        // wtid); one pass takes the max over them, a second p (exp(s - m),
        // or s - m under noexp), its sums and bf16 P (P^T) into shared
        // memory; then every p.V, both operands from shared memory.
        float* sc = reinterpret_cast<float*>(sbase + C::kScoreBase + w * C::kScoreBytes);
        for (int kt = 0; kt < n_tiles; ++kt) {
          if constexpr (kST) issue_kq(s, kt); else issue_qk(s, kt);
          wgmma_wait<0>();
          fence_regs(s);
          if constexpr (kST) scale_mask_t(s, kt); else scale_mask(s, kt);
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[(kt * 32 + i) * kWGThreads + wtid] = s[i];
        }
        auto load = [&](int kt) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = sc[(kt * 32 + i) * kWGThreads + wtid];
        };
        // Under noexp the keys past N add nothing (p = 0) and each dead key
        // below N adds -1e30 - m to the sum, those past the tiles read too.
        const float dead_unread = static_cast<float>(max(0, P.N - n_tiles * kRows));
        auto weight = [&](float x, float mx, int key) {
          if constexpr (kNoExp) return key < P.N ? x - mx : 0.f;
          else return ex2(fmaf(x, kLog2e, -mx));  // mx: m log2(e)
        };
        float acc[32];
        if constexpr (kST) {
          float m[16], l[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) m[i] = -INFINITY, l[i] = 0.f;
          for (int kt = 0; kt < n_tiles; ++kt) {
            load(kt);
            col_accumulate<true>(m, s);
          }
          col_reduce<true>(m, red, warp, lane, 1 + w);
          float mx[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) mx[i] = kNoExp ? m[i] : m[i] * kLog2e;
          for (int kt = 0; kt < n_tiles; ++kt) {
            load(kt);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * jj + e] = weight(s[4 * jj + e], mx[2 * jj + (e & 1)],
                                       kt * kRows + 16 * warp + g8 + 8 * (e / 2));
            col_accumulate<false>(l, s);
            store_pt(sbase + (p_tile(kt) - base), s);
          }
          col_reduce<false>(l, red, warp, lane, 1 + w);
          if constexpr (kNoExp) {
#pragma unroll
            for (int i = 0; i < 16; ++i) l[i] += dead_unread * (kMasked - m[i]);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
          fence_regs(acc);
          wgmma_fence();
          for (int kt = 0; kt < n_tiles; ++kt) issue_vtpt(acc, kt, p_tile(kt));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          store_o_cols(acc, l);
        } else {
          float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
          for (int kt = 0; kt < n_tiles; ++kt) {
            load(kt);
#pragma unroll
            for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], row_reduce<true>(s, r));
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
          }
          const float mx[2] = {kNoExp ? m[0] : m[0] * kLog2e, kNoExp ? m[1] : m[1] * kLog2e};
          for (int kt = 0; kt < n_tiles; ++kt) {
            load(kt);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * jj + e] = weight(s[4 * jj + e], mx[e / 2], kt * kRows + 8 * jj + 2 * t4 + (e & 1));
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] += row_reduce<false>(s, r);
            unsigned char* pt = sbase + (p_tile(kt) - base);  // rows: queries, 64 key columns
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int jj = 0; jj < 8; ++jj)
                *reinterpret_cast<uint32_t*>(pt + sw128_offset(16 * warp + g8 + 8 * r, 8 * jj) +
                                             4 * t4) =
                    pack_bf16(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            if constexpr (kNoExp) l[r] += dead_unread * (kMasked - m[r]);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
          fence_regs(acc);
          wgmma_fence();
          for (int kt = 0; kt < n_tiles; ++kt)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // P (K-major, as Q) . V (key rows: MN-major)
              wgmma_ss<1>(acc, sw128_desc(p_tile(kt) + kk * 32, 16, 1024),
                          sw128_desc(v_tile(slot, kt) + kk * 2048, kTile, 1024), kt > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          store_o_rows(acc, l);
        }
      } else if constexpr (kST) {
        // The transposed orientation of the full stage, in the same two
        // passes: pass 1 the column max of each query over every key (within
        // a thread across the tiles, then col_reduce); pass 2 p^T = exp(s^T -
        // m), the column sums, P^T rounded to bf16 into this warpgroup's P^T
        // tile and o^T += V^T(kt) . P^T. Before P^T(kt) is written, every
        // warp has waited for p.V(kt - 1) (the wait after q.k^T(kt)).
        const uint32_t pta = p_tile(0);
        unsigned char* pt = sbase + (pta - base);
        float m[16], l[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = -INFINITY, l[i] = 0.f;
        for (int kt = 0; kt < n_tiles; ++kt) {
          issue_kq(s, kt);
          wgmma_wait<0>();
          fence_regs(s);
          scale_mask_t(s, kt);
          col_accumulate<true>(m, s);
        }
        col_reduce<true>(m, red, warp, lane, 1 + w);
        float* ml = red + 4 * kRows;  // m log2(e) of the 64 columns
        if (warp == 0 && g8 == 0) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int b = 0; b < 2; ++b) ml[8 * jj + 2 * t4 + b] = m[2 * jj + b] * kLog2e;
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
        float acc[32];
        for (int kt = 0; kt < n_tiles; ++kt) {
          issue_kq(s, kt);
          wgmma_wait<0>();
          fence_regs(s);
          scale_mask_t(s, kt);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[4 * jj + e] = ex2(fmaf(s[4 * jj + e], kLog2e, -ml[8 * jj + 2 * t4 + (e & 1)]));
          col_accumulate<false>(l, s);
          asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
          store_pt(pt, s);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
          fence_regs(acc);
          wgmma_fence();
          issue_vtpt(acc, kt, pta);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(acc);
        col_reduce<false>(l, red, warp, lane, 1 + w);
        store_o_cols(acc, l);
      } else {
        // Pass 1: the row max m of rows g8 and g8 + 8 over every key.
        float m[2] = {-INFINITY, -INFINITY};
        for (int kt = 0; kt < n_tiles; ++kt) {
          issue_qk(s, kt);
          wgmma_wait<0>();
          fence_regs(s);
          scale_mask(s, kt);
  #pragma unroll
          for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], row_reduce<true>(s, r));
        }
  #pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        }

        if constexpr (kStage == kStageQk) {
          // The scores are used (their row max), so the products stay; a
          // branch no argument takes keeps the max itself from being dropped.
          if (P.n_items < 0 && m[0] == m[1]) sq[wtid] = 0;
        } else {
          // Pass 2: p = exp(s - m) in fp32, its row sums, P rounded to bf16
          // as p.V's A fragments, O += P V(kt). p.V(kt) runs beside q.k^T(kt +
          // 1), whose wait covers it before P is written again. exp(s - m) as
          // 2^(s log2(e) - m log2(e)): one FFMA and one MUFU.
          const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
          float l[2] = {0.f, 0.f};
          uint32_t p[4][4];
          float acc[32];
          for (int kt = 0; kt < n_tiles; ++kt) {
            issue_qk(s, kt);
            wgmma_wait<0>();
            fence_regs(s);
            scale_mask(s, kt);
  #pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], kLog2e, -ml[(i % 4) / 2]));
  #pragma unroll
            for (int r = 0; r < 2; ++r) l[r] += row_reduce<false>(s, r);
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk)
  #pragma unroll
              for (int i = 0; i < 4; ++i)
                p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
            fence_regs(acc);
            wgmma_fence();
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if constexpr (kVT)  // d rows of keys: K-major, 16 keys (32 bytes) a step
                wgmma_m64n64k16<0>(acc, p[kk], sw128_desc(v_tile(slot, kt) + kk * 32, 16, 1024),
                                   kt > 0 || kk > 0);
              else  // key rows of d: MN-major, 16 key rows a step
                wgmma_m64n64k16<1>(acc, p[kk], sw128_desc(v_tile(slot, kt) + kk * 2048, kTile, 1024),
                                   kt > 0 || kk > 0);
            }
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(acc);
  #pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          }

          store_o_rows(acc, l);
        }
      }
      // (The qk stage stores the Q tile as it arrived: o = q.)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory");
      if (wtid == 0) {
        tma_store5(&o_map, qa, 0, q0, hp, g, b);  // the map clips rows at or beyond N
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty(w, qs));
      }
      ++lq;
    }
    // This warp's reads of the item's K and V are done (every wgmma waited).
    if (lane == 0) mbar_arrive(kv_empty(slot));
  }
}

template <int kStage, bool kRope, bool kKT, bool kVT, bool kST = false, bool kNoExp = false>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  using C = Cfg<kStage, kST>;
  const auto kernel = attention_batched<kStage, kRope, kKT, kVT, kST, kNoExp>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((p.n_items + p.items - 1) / p.items);
  kernel<<<blocks, C::kThreads, C::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. q, k, v and o are bf16 operands of B images of
// G groups of P heads (H = G P heads, B H items), each operand with its own
// element strides (image, group, head in group, row): q and o rows of 64
// columns (N rows), k and v rows of 64 (N rows) or, transposed, 64 rows of N
// keys (k_transposed, v_transposed). cq, sq, ck, sk: bf16 (N, 64) RoPE
// tables, all four or none (rope). stage: 0 full, 1 qk, 2 split.
// transposed_scores: s^T = K.Q^T; noexp: p = s - m (split). items: the items
// a block takes in turn. The option sets built: full with no RoPE (K and V
// rows; K transposed; K and V transposed), full with RoPE (rows; scores
// transposed), qk (rows), split with RoPE (each of transposed_scores and
// noexp on and off).
// Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for arguments outside what is built.
extern "C" int cbas_attention_batched(const void* q, const void* k, const void* v, void* o,
                                      const void* cq, const void* sq, const void* ck,
                                      const void* sk, int B, int G, int P, int N, int n_valid,
                                      int items, const long long* q_strides,
                                      const long long* k_strides, const long long* v_strides,
                                      const long long* o_strides, float s_scale, int stage,
                                      int rope, int k_transposed, int v_transposed,
                                      int transposed_scores, int noexp, void* stream) {
  const long long n_items = static_cast<long long>(B) * G * P;
  if (B <= 0 || G <= 0 || P <= 0 || N <= 0 || N > kMaxN || n_valid <= 0 || n_valid > N ||
      items <= 0 || n_items > (1LL << 31) - 1 || (n_items + items - 1) / items > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tables = cq != nullptr && sq != nullptr && ck != nullptr && sk != nullptr;
  if (rope != tables) return static_cast<int>(cudaErrorInvalidValue);
  Operand ops[4] = {
      {q, {q_strides[0], q_strides[1], q_strides[2], q_strides[3]}, kRows, N},
      {k, {k_strides[0], k_strides[1], k_strides[2], k_strides[3]},
       k_transposed ? n_valid : kRows, k_transposed ? kRows : n_valid},
      {v, {v_strides[0], v_strides[1], v_strides[2], v_strides[3]},
       v_transposed ? n_valid : kRows, v_transposed ? kRows : n_valid},
      {o, {o_strides[0], o_strides[1], o_strides[2], o_strides[3]}, kRows, N},
  };
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!encode_operand(&maps[i], ops[i], P, G, B))
      return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(cq), static_cast<const __nv_bfloat16*>(sq),
                 static_cast<const __nv_bfloat16*>(ck), static_cast<const __nv_bfloat16*>(sk),
                 N, n_valid, P, G * P, static_cast<int>(n_items), items, s_scale};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool rows = !k_transposed && !v_transposed;
  const bool plain = !transposed_scores && !noexp;
  cudaError_t err = cudaErrorInvalidValue;
  if (stage == kStageFull && !rope && rows && plain)
    err = launch<kStageFull, false, false, false>(maps, p, st);
  else if (stage == kStageFull && rope && rows && plain)
    err = launch<kStageFull, true, false, false>(maps, p, st);
  else if (stage == kStageFull && !rope && k_transposed && !v_transposed && plain)
    err = launch<kStageFull, false, true, false>(maps, p, st);
  else if (stage == kStageFull && !rope && k_transposed && v_transposed && plain)
    err = launch<kStageFull, false, true, true>(maps, p, st);
  else if (stage == kStageQk && !rope && rows && plain)
    err = launch<kStageQk, false, false, false>(maps, p, st);
  else if (stage == kStageFull && rope && rows && transposed_scores && !noexp)
    err = launch<kStageFull, true, false, false, true>(maps, p, st);
  else if (stage == kStageSplit && rope && rows && !transposed_scores && !noexp)
    err = launch<kStageSplit, true, false, false, false, false>(maps, p, st);
  else if (stage == kStageSplit && rope && rows && transposed_scores && !noexp)
    err = launch<kStageSplit, true, false, false, true, false>(maps, p, st);
  else if (stage == kStageSplit && rope && rows && !transposed_scores && noexp)
    err = launch<kStageSplit, true, false, false, false, true>(maps, p, st);
  else if (stage == kStageSplit && rope && rows && transposed_scores && noexp)
    err = launch<kStageSplit, true, false, false, true, true>(maps, p, st);
  return static_cast<int>(err);
}
