// The streamed transposed-score attention, for Hopper (sm_90a): a timing
// kernel of its own beside the Hopper body K1-K3 run (attention_sm90.cuh) and
// the batched whole-row kernel (attention_batched.cu), whose rank-5 maps,
// RoPE and column reductions it shares through attention_rank5.cuh, and a
// RoPE prologue of its own. No encode route calls it.
//
// Replaces the TPU kernels of the transposed-score ("pvt") probes of
// benchmarks/attn_probes/, which run one head's whole key row at once at
// the 640x480 geometry (N 1216, 1205 live keys) on packed head pairs:
// - probe3.py:42 (make_variant) with pvt_kernel (:60): p in fp32, the column
//   sum of the unrounded p (form std);
// - probe5.py:44 (make_variant) with pvt_kernel (:62) at bf16exp x vext: p
//   rounded to bf16 before its sum (form rounded), the sum taken as the ones
//   row of the p.V product (form vext), each with the exponential of
//   bf16(s - m) (bf16exp);
// - probe6_pvt_interleaved.py:60 (make_variant) with pvt_kernel (:20):
//   probe3's body (form std), timed in rounds against K2;
// - probe4.py:46 (make_variant) with pvt_vext_kernel (:118), bf16exp off and
//   on: form vext (its vext_kernel is attention_variants.cu's);
// - probe23_fat_480p.py:92, make_fat_kernel's kernel (:41): probe3's
//   function on the flat (B, N, 768) layout, swapped into the model
//   (form std on views of the fused projection).
//
// The function, for each (b, h) item (d = 64, bf16, any N): q and k roped in
// bf16 arithmetic from bf16 (N, 64) tables (the scale in q's, sqrt(d) times
// it in k's: at d 64 k's table is bf16(cos) itself); s^T = k.q^T in fp32,
// keys at or beyond n_valid -> -1e30 by select and their V rows zero; m =
// each query column's exact max over every key; then
// - std: p = exp(s - m) in fp32, l = the column sum of p, o^T = V^T.bf16(p) / l;
// - rounded: p = bf16(exp(s - m)), l = the column sum of p in fp32;
// - vext: the same p, l = (ones row of live keys).p, taken beside V^T.p on
//   the tensor cores;
// - bf16exp (rounded, vext): p = 2^x of bf16(x), x = s log2(e) - m log2(e)
//   in fp32, by ex2.approx.ftz.bf16x2 (two exponentials a MUFU op, as
//   attention_sm90.cuh's kVextBf16Exp); the probes' p = exp(bf16(s - m)) in
//   bf16 rounds its argument at another point (chip_smoke.pvt_tolerance);
// and o rounded to bf16 once. An exact softmax against the column's true
// max: no running max, no rescale, as the probes compute it.
//
// Design. One head's K and V at N 1216 take 311 KB, more than a block's
// 227 KB, so the keys stream through a ring of 64-key stages (the K tile,
// and in pass 2 the V tile), and the exact max takes two passes over them:
// pass 1 the column max of every query over every key, pass 2 the same
// scores again (the same products give the same bits), p, its sums and
// o^T += V^T.P^T. The work is in units of (item, round): round r of an item
// is its query blocks 3 r, 3 r + 1 and 3 r + 2, one a consumer warpgroup,
// all three reading the same ring in lockstep, so a key tile loads once for
// 192 queries. The last round of an item whose query blocks are no multiple
// of three leaves warpgroups idle (at N 1216, 19 blocks in 7 rounds: 19 of
// 21 slots busy); an idle warpgroup waits for each stage and releases it.
// Block b takes units b, b + blocks, b + 2 blocks, ... (blocks = items /
// `items`, so a block does the work of `items` items): the blocks resident at
// once work on neighbouring units, the rounds of a few items, whose K and V
// then stay in L2, where blocks taking their own items in turn (the TPU
// programs' order) would keep 132 items' K and V in flight. One producer
// warp loads Q tiles (two slots a warpgroup, so a unit's Q loads while the
// unit before computes) and keeps the ring full.
// K's live rows are roped in bf16 arithmetic by a prologue kernel
// (rope_k_rows) into a scratch the wrapper allocates, once per (item, key),
// as K1-K3's prologue does; the consumers rope their own Q tile. Warps
// roping each K tile as it lands would rope a key 14 times at N 1216 (7
// rounds x 2 passes), and the latency of their table loads bound such a
// kernel in development (PERF.md).
//
// s^T = K.Q^T takes the key tile as wgmma's A operand (K-major, as it lands)
// and the Q tile as B. A thread holds two key rows of its warp's 16 for 16
// query columns: the column max and the sums are taken within the thread
// across the key tiles, then over the warpgroup by col_reduce (shuffles
// across the eight row groups, the four warps through shared memory). The
// column maxima times log2(e) sit in shared memory through pass 2, as in
// attention_batched.cu's full+sT, beside s^T, o^T and the 16 sums in
// registers. P^T is rounded to bf16 into the warpgroup's P^T tile, the MN-major
// B operand of o^T += V^T.P^T, whose A operand is the stage's V tile read
// MN-major (the transpose bit); two barriers a key tile order P^T's writes
// after the last p.V read it and before the next reads it. vext adds the
// product P.1 (m64n8k16: P read MN-major out of the P^T tile as A, a ones
// tile of the live keys as B, 4 accumulator registers), whose column 0 is
// each query's sum; it goes through shared memory to the columns' owners.
// A stage is released once the p.V that read its V has completed (the wait
// after the next tile's s^T covers it). o^T over the column sums goes
// transposed into the Q tile for one TMA store, which clips rows past N.
//
// Shared memory (from a 1024-byte aligned base): eight ring stages of 16
// KB, 3 x 2 Q tiles, 3 P^T tiles, two ones tiles (1 KB each: all keys live,
// and the last tile's), 3 x 1.5 KB of reductions, the mbarriers: about 207
// KB, one block an SM; 416 threads, so a thread may take 152 registers.
// -Xptxas -v on sm_90a: 127-128 registers and no spill in every option set,
// the prologue 32 (chip_smoke.py's kernels line, PERF.md).
//
// What bounds it on this card: at the probes' (320 x 12, 1216, 64) its
// operations, 4 items N n_valid d = 1.44 TFLOP of q.k^T and p.V (1.46 ms at
// 989 TFLOP/s) against 2.38 GB of q, k, v, o and tables (0.71 ms at 3.35
// TB/s); the two-pass form issues q.k^T twice (2.2 ms of wgmma at peak), and
// every tile step is a chain of wgmma, wait, column work, barrier, P^T store,
// barrier and wgmma within a warpgroup, which the three warpgroups overlap
// only with each other; the ring streams 456 KB of K and V a unit from L2
// (12.3 GB at the probes' shape). The prologue moves K's live rows twice
// (0.59 GB each way).

#include "attention_rank5.cuh"

namespace {

enum Form : int { kFormStd = 0, kFormRounded = 1, kFormVext = 2 };

constexpr int kConsumers = 3;  // warpgroups: the query blocks of a round
constexpr int kConsumerThreads = kConsumers * kWGThreads;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kStages = 8;  // ring stages: a K tile, then a V tile
constexpr int kQSlots = 2;  // Q tiles a consumer warpgroup holds
constexpr uint32_t kStageBytes = 2 * kTile;
constexpr uint32_t kOnesTileBytes = 1024;  // 8 rows x 64 keys of bf16, one swizzle atom
constexpr uint32_t kQBase = kStages * kStageBytes;
constexpr uint32_t kPBase = kQBase + kConsumers * kQSlots * kTile;
constexpr uint32_t kOnesBase = kPBase + kConsumers * kTile;
// A warpgroup's reductions: col_reduce's 4 x 64 floats, the 64 column maxima
// times log2(e), the 64 vext sums.
constexpr uint32_t kRedBase = kOnesBase + 2 * kOnesTileBytes;
constexpr uint32_t kRedBytes = 6 * kRows * 4;
constexpr uint32_t kBarBase = kRedBase + kConsumers * kRedBytes;
constexpr int kBars = 2 * kStages + 2 * kConsumers * kQSlots;
constexpr size_t kSmemBytes = 1024 + kBarBase + 8 * kBars;
static_assert(kSmemBytes <= 232448, "one block an SM within the 227 KB a block may use");

// d (64 x 8, fp32) = a (64 x 16) . b (16 x 8), both bf16 in shared memory;
// a K-major (TransA 0) or MN-major (TransA 1), b K-major (TransB 0).
template <int TransB, int TransA>
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

struct Params {
  const __nv_bfloat16* cq;  // q's RoPE tables, bf16 (N, 64)
  const __nv_bfloat16* sq;
  int N, n_valid;
  int heads_per_group, heads;  // an item's head h: group h / heads_per_group, h % heads_per_group in it
  int n_items;
};

// K's live rows roped in bf16 arithmetic (rope_chunks) from K, under its
// element strides (image, group, head in group, row), into `out`, dense
// (items, N, 64): one chunk pair of a row a thread, `pairs` = items n_valid 4.
__global__ void __launch_bounds__(256)
rope_k_rows(const __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ out,
            const __nv_bfloat16* __restrict__ ck, const __nv_bfloat16* __restrict__ sk,
            long long s_image, long long s_group, long long s_head, long long s_row,
            int heads_per_group, int heads, int N, int n_valid, long long pairs) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= pairs) return;
  const int c = static_cast<int>(p % 4) * kChunk;
  const long long row = p / 4;
  const int n = static_cast<int>(row % n_valid);
  const long long item = row / n_valid;
  const int h = static_cast<int>(item % heads);
  const __nv_bfloat16* src = k + (item / heads) * s_image + (h / heads_per_group) * s_group +
                             (h % heads_per_group) * s_head + n * s_row;
  __nv_bfloat16* dst = out + (item * N + n) * kRows;
  const RopeTab t = rope_tab(ck, sk, n, c);
  uint4 xa = *reinterpret_cast<const uint4*>(src + c);
  uint4 xp = *reinterpret_cast<const uint4*>(src + c + kRows / 2);
  rope_chunks(xa, xp, t);
  *reinterpret_cast<uint4*>(dst + c) = xa;
  *reinterpret_cast<uint4*>(dst + c + kRows / 2) = xp;
}

// One block: units blockIdx.x, + gridDim.x, ..., of (item, round). Threads
// 0-383 are the consumer warpgroups, then the producer warp. Maps are rank 5:
// (64 columns, rows, head in group, group, image); K's (the roped scratch)
// and V's rows end at n_valid, Q's and O's at N.
template <int kForm, bool kBf16Exp>
__global__ void __launch_bounds__(kThreads, 1)
attention_pvt(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
              const Params P) {
  static_assert(!kBf16Exp || kForm != kFormStd, "bf16exp is built for the rounded and vext forms");
  constexpr bool kVext = kForm == kFormVext;
  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* sbase = raw + (base - raw_addr);
  // Load i of the block goes to stage i % kStages: K at its start, V after.
  auto stage_k = [&](int i) { return base + (i % kStages) * kStageBytes; };
  auto q_tile = [&](int w, int qs) { return base + kQBase + (w * kQSlots + qs) * kTile; };
  const uint32_t bars = base + kBarBase;
  auto full = [&](int i) { return bars + 8u * (i % kStages); };
  auto empty = [&](int i) { return bars + 8u * (kStages + i % kStages); };
  auto q_full = [&](int w, int qs) { return bars + 8u * (2 * kStages + w * kQSlots + qs); };
  auto q_empty = [&](int w, int qs) {
    return bars + 8u * (2 * kStages + kConsumers * kQSlots + w * kQSlots + qs);
  };

  const int n_tiles = (P.n_valid + kRows - 1) / kRows;  // key tiles past n_valid add nothing
  const int n_blocks = (P.N + kRows - 1) / kRows;       // query blocks of an item
  const int rounds = (n_blocks + kConsumers - 1) / kConsumers;
  const long long n_units = static_cast<long long>(P.n_items) * rounds;
  const int loads = 2 * n_tiles;  // ring loads a unit: K (pass 1), then K and V (pass 2)
  // The unit's item as (head in group, group, image), and its round.
  auto coords = [&](long long unit, int& hp, int& g, int& b, int& r) {
    const int item = static_cast<int>(unit / rounds);
    r = static_cast<int>(unit % rounds);
    b = item / P.heads;
    const int h = item % P.heads;
    g = h / P.heads_per_group;
    hp = h % P.heads_per_group;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads / 32);  // one arrival a consumer warp
    }
    for (int w = 0; w < kConsumers; ++w)
      for (int qs = 0; qs < kQSlots; ++qs) {
        mbar_init(q_full(w, qs), 1);
        mbar_init(q_empty(w, qs), 1);  // the warpgroup's storing thread
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kVext) {
    // The ones tiles, B of P.1 (8 rows, each the key tile's live mask):
    // every key live, then the last tile's (keys at or past n_valid 0).
    for (int e = threadIdx.x; e < 2 * 8 * kRows; e += kThreads) {
      const int t = e / (8 * kRows), n = (e / kRows) % 8, key = e % kRows;
      const bool live = t == 0 || (n_tiles - 1) * kRows + key < P.n_valid;
      *reinterpret_cast<__nv_bfloat16*>(sbase + kOnesBase + t * kOnesTileBytes +
                                        sw128_offset(n, key) + 2 * (key % kChunk)) =
          __float2bfloat16_rn(live ? 1.f : 0.f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer: one thread loads each unit's Q tiles into the slots of the
    // warpgroups that take them, then the unit's ring loads.
    if (threadIdx.x == kConsumerThreads) {
      int i = 0;
      int lq[kConsumers] = {};
      for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
        int hp, g, b, r;
        coords(unit, hp, g, b, r);
        for (int w = 0; w < kConsumers && r * kConsumers + w < n_blocks; ++w) {
          const int qs = lq[w] % kQSlots;
          mbar_wait(q_empty(w, qs), ((lq[w] / kQSlots) & 1) ^ 1);  // the first pass at once
          mbar_expect_tx(q_full(w, qs), kTile);
          tma_load5(q_tile(w, qs), &q_map, q_full(w, qs), 0, (r * kConsumers + w) * kRows, hp, g,
                    b);
          ++lq[w];
        }
        for (int u = 0; u < loads; ++u, ++i) {
          const int key0 = (u % n_tiles) * kRows;
          const bool with_v = u >= n_tiles;
          mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(full(i), with_v ? 2 * kTile : kTile);
          tma_load5(stage_k(i), &k_map, full(i), 0, key0, hp, g, b);
          if (with_v) tma_load5(stage_k(i) + kTile, &v_map, full(i), 0, key0, hp, g, b);
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
  const uint32_t pta = base + kPBase + w * kTile;  // this warpgroup's P^T tile
  unsigned char* pt = sbase + kPBase + w * kTile;
  float* red = reinterpret_cast<float*>(sbase + kRedBase + w * kRedBytes);
  float* ml = red + 4 * kRows;    // m log2(e) of the 64 columns
  float* vsum = red + 5 * kRows;  // vext: each query's sum
  auto wait_stage = [&](int i) { mbar_wait(full(i), (i / kStages) & 1); };
  // Each consumer warp releases a stage once its wgmma that read it completed.
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i));
  };
  auto wg_sync = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWGThreads) : "memory"); };
  int i = 0, lq = 0;

  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    int hp, g, b, r;
    coords(unit, hp, g, b, r);
    const int j = r * kConsumers + w;
    if (j >= n_blocks) {  // idle this round: keep the ring's count
      for (int u = 0; u < loads; ++u, ++i) {
        wait_stage(i);
        release(i);
      }
      continue;
    }
    const int qs = lq % kQSlots;
    const uint32_t qa = q_tile(w, qs);
    unsigned char* sq = sbase + (qa - base);
    const int q0 = j * kRows;
    mbar_wait(q_full(w, qs), (lq / kQSlots) & 1);
    for (int e = wtid; e < kRows * 4; e += kWGThreads)
      if (q0 + e / 4 < P.N)
        rope_pair(sq, e / 4, (e % 4) * kChunk, rope_tab(P.cq, P.sq, q0 + e / 4, (e % 4) * kChunk));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();

    // s^T = K.Q^T of the stage of load i: the K tile as A, the Q tile as
    // B, both K-major. Accumulator element 4 jj + e of a thread: key row 16
    // warp + g8 + 8 (e / 2) of the tile, query column 8 jj + 2 t4 + (e & 1).
    float s[32];
    auto issue_kq = [&](int ld) {
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(s, sw128_desc(stage_k(ld) + kk * 32, 16, 1024),
                    sw128_desc(qa + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // Key rows at or beyond n_valid -> -1e30 (only the last tile holds any).
    auto mask = [&](int kt) {
      if ((kt + 1) * kRows > P.n_valid) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kt * kRows + 16 * warp + g8 + 8 * (e / 2) >= P.n_valid) s[4 * jj + e] = kMasked;
      }
    };

    // Pass 1: each column's max over every key.
    float m[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) m[c] = -INFINITY;
    for (int kt = 0; kt < n_tiles; ++kt, ++i) {
      wait_stage(i);
      issue_kq(i);
      wgmma_wait<0>();
      fence_regs(s);
      release(i);
      mask(kt);
      col_accumulate<true>(m, s);
    }
    col_reduce<true>(m, red, warp, lane, 1 + w);
    if (warp == 0 && g8 == 0) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) ml[8 * jj + 2 * t4 + c] = m[2 * jj + c] * kLog2e;
    }
    wg_sync();

    // Pass 2: the same scores, p, the column sums (vext: P.1), P^T rounded
    // to bf16 into the P^T tile, o^T += V^T . P^T.
    float acc[32], l[16], vs[4];
#pragma unroll
    for (int c = 0; c < 16; ++c) l[c] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt, ++i) {
      wait_stage(i);
      issue_kq(i);
      wgmma_wait<0>();  // also p.V(kt - 1): its stage and P^T are free
      fence_regs(s);
      if (kt > 0) release(i - 1);
      mask(kt);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float x0 = fmaf(s[4 * jj + e], kLog2e, -ml[8 * jj + 2 * t4]);
          const float x1 = fmaf(s[4 * jj + e + 1], kLog2e, -ml[8 * jj + 2 * t4 + 1]);
          if constexpr (kBf16Exp) {
            const uint32_t y = ex2_bf16x2(pack_bf16(x0, x1));
            const __nv_bfloat162 p2 = *reinterpret_cast<const __nv_bfloat162*>(&y);
            s[4 * jj + e] = __low2float(p2), s[4 * jj + e + 1] = __high2float(p2);
          } else if constexpr (kForm == kFormStd) {
            s[4 * jj + e] = ex2(x0), s[4 * jj + e + 1] = ex2(x1);
          } else {  // rounded, vext: p rounded to bf16 before its sum
            const __nv_bfloat162 p2 = __floats2bfloat162_rn(ex2(x0), ex2(x1));
            s[4 * jj + e] = __low2float(p2), s[4 * jj + e + 1] = __high2float(p2);
          }
        }
      if constexpr (!kVext) col_accumulate<false>(l, s);
      wg_sync();  // every warp is past p.V(kt - 1), the last read of P^T
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g8 + 8 * h;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(pt + sw128_offset(row, 8 * jj) + 4 * t4) =
              pack_bf16(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync();
      fence_regs(acc);
      if constexpr (kVext) fence_regs(vs);
      wgmma_fence();
      const uint32_t va = stage_k(i) + kTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // V (keys x d) read MN-major as A; P^T MN-major as B
        wgmma_ss<1, 1>(acc, sw128_desc(va + kk * 2048, kTile, 1024),
                       sw128_desc(pta + kk * 2048, kTile, 1024), kt > 0 || kk > 0);
      if constexpr (kVext) {
        const uint32_t ones = base + kOnesBase + (kt == n_tiles - 1 ? kOnesTileBytes : 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // P (queries x keys) out of P^T, MN-major; ones K-major
          wgmma_ss_n8<0, 1>(vs, sw128_desc(pta + kk * 2048, kTile, 1024),
                            sw128_desc(ones + kk * 32, 16, 1024), kt > 0 || kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (kVext) fence_regs(vs);
    release(i - 1);
    if constexpr (kVext) {
      // P.1's column 0 holds row 16 warp + g8 (+ 8)'s sum; each thread
      // reads its 16 query columns' back.
      if (t4 == 0) vsum[16 * warp + g8] = vs[0], vsum[16 * warp + g8 + 8] = vs[2];
      wg_sync();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) l[2 * jj + c] = vsum[8 * jj + 2 * t4 + c];
    } else {
      col_reduce<false>(l, red, warp, lane, 1 + w);
    }
    // o^T (rows: d, columns: queries) over its column sums, rounded to bf16,
    // transposed into the Q tile: element (d r, query c) to row c, column r.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 16 * warp + g8 + 8 * (e / 2), c = 8 * jj + 2 * t4 + (e & 1);
        *reinterpret_cast<__nv_bfloat16*>(sq + sw128_offset(c, rr) + 2 * (rr % kChunk)) =
            __float2bfloat16_rn(acc[4 * jj + e] / l[2 * jj + (e & 1)]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();
    if (wtid == 0) {
      tma_store5(&o_map, qa, 0, q0, hp, g, b);  // the map clips rows at or beyond N
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(q_empty(w, qs));
    }
    ++lq;
  }
}

template <int kForm, bool kBf16Exp>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, int blocks, cudaStream_t stream) {
  const auto kernel = attention_pvt<kForm, kBf16Exp>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. q, k, v and o are bf16 operands of B images of
// G groups of P heads (H = G P heads, B H items), each with its own element
// strides (image, group, head in group, row), rows of 64 columns: q and o N
// rows, k and v N rows of which n_valid are read. cq, sq, ck, sk: bf16 (N,
// 64) RoPE tables, all four. k_roped: scratch for K's roped rows, bf16 (B H,
// N, 64) dense. form: 0 std, 1 rounded, 2 vext; bf16exp (the rounded and
// vext forms): the exponential in bf16. items: the items' work a block
// takes (the grid is B H / items blocks). Launches the RoPE prologue, then
// the attention; returns the CUDA error code of the launches (0 on
// success); cudaErrorInvalidValue for arguments outside what is built.
extern "C" int cbas_attention_pvt(const void* q, const void* k, const void* v, void* o,
                                  const void* cq, const void* sq, const void* ck, const void* sk,
                                  void* k_roped, int B, int G, int P, int N, int n_valid,
                                  int items, const long long* q_strides,
                                  const long long* k_strides, const long long* v_strides,
                                  const long long* o_strides, int form, int bf16exp,
                                  void* stream) {
  const long long n_items = static_cast<long long>(B) * G * P;
  if (B <= 0 || G <= 0 || P <= 0 || N <= 0 || n_valid <= 0 || n_valid > N || items <= 0 ||
      n_items > (1LL << 31) - 1 || (n_items + items - 1) / items > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cq == nullptr || sq == nullptr || ck == nullptr || sk == nullptr || k_roped == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(N) * kRows;  // the scratch's item stride
  Operand ops[4] = {
      {q, {q_strides[0], q_strides[1], q_strides[2], q_strides[3]}, kRows, N},
      {k_roped, {G * P * rows, P * rows, rows, kRows}, kRows, n_valid},
      {v, {v_strides[0], v_strides[1], v_strides[2], v_strides[3]}, kRows, n_valid},
      {o, {o_strides[0], o_strides[1], o_strides[2], o_strides[3]}, kRows, N},
  };
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!encode_operand(&maps[i], ops[i], P, G, B)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long pairs = n_items * n_valid * 4;
  rope_k_rows<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(k_roped),
      static_cast<const __nv_bfloat16*>(ck), static_cast<const __nv_bfloat16*>(sk), k_strides[0],
      k_strides[1], k_strides[2], k_strides[3], P, G * P, N, n_valid, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const __nv_bfloat16*>(cq), static_cast<const __nv_bfloat16*>(sq), N,
                 n_valid, P, G * P, static_cast<int>(n_items)};
  const int blocks = static_cast<int>((n_items + items - 1) / items);
  err = cudaErrorInvalidValue;
  if (form == kFormStd && !bf16exp)
    err = launch<kFormStd, false>(maps, p, blocks, st);
  else if (form == kFormRounded && !bf16exp)
    err = launch<kFormRounded, false>(maps, p, blocks, st);
  else if (form == kFormRounded && bf16exp)
    err = launch<kFormRounded, true>(maps, p, blocks, st);
  else if (form == kFormVext && !bf16exp)
    err = launch<kFormVext, false>(maps, p, blocks, st);
  else if (form == kFormVext && bf16exp)
    err = launch<kFormVext, true>(maps, p, blocks, st);
  return static_cast<int>(err);
}
