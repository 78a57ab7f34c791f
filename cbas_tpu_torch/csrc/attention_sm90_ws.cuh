// K3's bf16 Hopper body in FlashAttention-3's shape (arXiv:2407.08608,
// section 3.1): a producer warpgroup that gives its registers to two
// consumer warpgroups of 64 query rows each, which take turns on the tensor
// cores ("ping-pong"), so that one warpgroup's softmax runs while the
// other's q.k^T and p.V are in flight. K3's bf16 heads of width 193-256 run
// here (attention_headmajor.cu), at 256, their maps at d; K1, K2 and every
// d up to 192 keep attention_sm90.cuh's one-warpgroup body, which tied or
// won at 192 (PERF.md: at N = 261 this body's last block of each head has
// one live consumer), so this body is not built there. Built at 128 too, as
// a timing case no route calls (attention_variants.cu).
//
// Replaces, with attention_sm90.cuh, the TPU kernel
// cbas_tpu/ops/flash_attention.py::_attn_kernel (body :35-98, pallas_call
// :393) at those widths. The function and its rounding points are
// attention_common.cuh's: rotate-half RoPE from fp32 tables, one rounding of
// roped, scaled q and of roped k to bf16, fp32 scores, keys at or beyond
// n_valid masked by select (V's dead rows read as zeros: the maps end at
// n_valid), an exact online softmax, p rounded to bf16, fp32 row sums. Every
// input form of the one-warpgroup body at these widths is taken unchanged
// in meaning, through the same set-up (attention_sm90.cuh's prepare and
// prepare_staged): rank-4 and rank-5 maps from the caller's strides; maps
// at d when d % 16 == 0 (the columns from d load as zeros, the store clips
// them); the staged form when d % 16 != 0 (O by plain stores,
// kStagedOut); RoPE in the block at d == HD (Q) and by rope_rows before it
// (K; and Q at d < HD).
//
// What bounded the one-warpgroup body at these widths, and what this design
// does about it:
//
// - Registers. O alone is HD / 2 fp32 registers a consumer thread (96,
//   128). Under a common cap the one-warpgroup body took 158 and 194, so an
//   SM ran 2 blocks at 192 and 1 at 256: one consumer warpgroup, one warp
//   a sub-partition to issue from. Here the cap is known at entry
//   (__launch_bounds__(384, 1): 168 a thread), and the producer warpgroup
//   gives its registers away (setmaxnreg.dec to kProducerRegs) so each
//   consumer may take kConsumerRegs (setmaxnreg.inc): 128 x 24 + 256 x 240
//   = 64512 of the SM's 65536. ptxas honours the instruction only because
//   the branches of the two roles never rejoin.
// - A serial chain a key tile. One warpgroup's wgmma, wait, softmax, wgmma,
//   wait left the tensor cores idle through every softmax. Here two
//   consumers share a 128-row block and pass a turn through two named
//   barriers (kSchedBar + c): a consumer issues its tile's products in its
//   turn and hands the turn on, so its softmax runs during the other's
//   products. Within a warpgroup p.V of tile t is issued in the same turn
//   as q.k^T of tile t + 1, and the softmax of t + 1 runs while p.V of t is
//   in flight: S of t + 1 (32 fp32) and P of t (16 bf16x2) are live
//   together, which the 240-register cap affords (it ran 3-10% faster than
//   each tile's chain in order: PERF.md).
// - Copies in flight. As in the one-warpgroup body, one producer thread
//   issues the TMA loads of K(0), V(0), K(1), ... into a ring of
//   Config::kSlots stages, each with a full and an empty mbarrier; a stage is
//   released by every consumer warp of both warpgroups. Q is loaded in two
//   64-row halves with a full barrier each, so the first consumer starts
//   before the second half lands.
// - Re-reads. A block reads each K and V tile once for 128 query rows: at
//   N = 261 a head's tiles are read by 3 blocks (384 rows, 123 dead), not 5.
//   A consumer whose 64 rows all lie at or beyond N does no work (the ring
//   waits on the live one alone).
//
// Grid: (ceil(N / 128), H, B), 384 threads: warpgroup 0 the producer,
// warpgroups 1 and 2 the consumers of rows [0, 64) and [64, 128) of the
// block, each storing its own rows of O.

#pragma once

#include "attention_sm90.cuh"

namespace cbas_attention {
namespace sm90_ws {

using sm90::ex2;
using sm90::fence_regs;
using sm90::HeadTiles;
using sm90::kAtom;
using sm90::kAtomBytes;
using sm90::kBlockN;
using sm90::kLog2e;
using sm90::kWGRows;
using sm90::kWGThreads;
using sm90::MapAddress;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::PlainOut;
using sm90::Prepared;
using sm90::row_reduce;
using sm90::smem_u32;
using sm90::store_rows;
using sm90::sw128_desc;
using sm90::sw128_offset;
using sm90::tma_load;
using sm90::tma_store;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_m64n64k16;
using sm90::wgmma_m64n64k16_ss;
using sm90::wgmma_wait;

constexpr int kConsumers = 2;
constexpr int kBlockM = kConsumers * kWGRows;            // query rows a block
constexpr int kThreads = (1 + kConsumers) * kWGThreads;  // the producer warpgroup first
// setmaxnreg's counts: multiples of 8 whose sum over the block's threads
// fits the SM's registers.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * kWGThreads + kConsumerRegs * kConsumers * kWGThreads <= 65536,
              "the warpgroups' registers exceed the SM's");
// Named barriers (0 is __syncthreads): consumer c waits for its turn on
// kSchedBar + c and syncs its own warpgroup on kWGBar + c.
constexpr int kSchedBar = 1;
constexpr int kWGBar = 3;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on an H100

template <int HD>
struct Config {
  static_assert(HD == 128 || HD == 256, "the two-consumer body takes 128 and 256");
  static constexpr int kAtoms = HD / kAtom;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;   // one K or V tile, one Q half
  static constexpr int kQBytes = kConsumers * kTileBytes;  // the block's Q rows
  // The ring's stages, chosen on the card (PERF.md): at 256, 2 and 3 ran
  // 12-31% slower than 4, and 5 the same; at 128, 8 and 12 the same as 4.
  static constexpr int kSlots = 4;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's
  // period; the ring; then a full and an empty barrier a stage and Q's two.
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + kSlots * (kTileBytes + 16) + kConsumers * 8;
  static_assert(kSmemBytes <= kMaxSmem, "the ring does not fit");
};

// A consumer's position among the ring's loads of one kind (K: loads 0, 2,
// 4, ...; V: 1, 3, 5, ...) in a ring of kSlots stages: the stage and the
// phase of its barriers.
template <int kSlots>
struct EveryOther {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    stage += 2;
    if (stage >= kSlots) stage -= kSlots, phase ^= 1;
  }
};

__device__ __forceinline__ void fence_p(uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(p[kk][i])::"memory");
}

// One block: query rows [blockIdx.x * 128, +128) of head blockIdx.y of image
// blockIdx.z. The maps and their MapAddress as attention_sm90's.
// kStagedOut: O goes through `out` with plain stores, not through o_map.
template <int HD, int kRank, bool kStagedOut>
__global__ void __launch_bounds__(kThreads, 1)
attention_sm90_ws(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap o_map, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t, int N, int n_valid, float scale,
                  const MapAddress order, const PlainOut out) {
  using C = Config<HD>;
  constexpr int kKSteps = HD / 16;
  constexpr int slots = C::kSlots;

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t q_tile = (raw_addr + 1023u) & ~1023u;  // consumer c's rows at + c * kTileBytes
  const uint32_t ring = q_tile + C::kQBytes;            // stage s at + s * kTileBytes
  const uint32_t bars = ring + slots * C::kTileBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (slots + s); };
  auto q_full = [&](int c) { return bars + 8u * (2 * slots + c); };
  auto stage = [&](int s) { return ring + s * C::kTileBytes; };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockM;
  const int n_tiles = (n_valid + kBlockN - 1) / kBlockN;  // tiles past n_valid add zeros
  const int live = q0 + kWGRows < N ? 2 : 1;              // consumers with a query row below N

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), live * kWGThreads / 32);  // one arrival a live consumer warp
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(q_full(c), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWGThreads) {
    // The producer warpgroup: its registers go to the consumers, and one
    // thread loads Q's live halves, then keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const HeadTiles tiles(order, h, b);
      for (int c = 0; c < live; ++c) {
        mbar_expect_tx(q_full(c), C::kTileBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load<kRank>(q_tile + c * C::kTileBytes + a * kAtomBytes, &q_map, q_full(c), tiles,
                          a * kAtom, q0 + c * kWGRows);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int row = (i / 2) * kBlockN;
        const CUtensorMap* map = i % 2 ? &v_map : &k_map;
        mbar_wait(empty(s), phase ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), C::kTileBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load<kRank>(stage(s) + a * kAtomBytes, map, full(s), tiles, a * kAtom, row);
        if (++s == slots) s = 0, phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / kWGThreads - 1;  // this consumer: 0 or 1
    if (c < live) {
      const int tid = threadIdx.x % kWGThreads;
      const int warp = tid / 32;
      const int lane = tid % 32;
      const int g = lane / 4;
      const int t = lane % 4;
      const int r0 = q0 + c * kWGRows;  // the warpgroup's first query row
      const uint32_t q_half = q_tile + c * C::kTileBytes;
      unsigned char* sq = raw + (q_half - raw_addr);
      const bool pingpong = live == 2;

      // The turn: consumer 0 takes the first without waiting; consumer 1
      // hands on all but its last, so every wait on a barrier meets one
      // arrival of the other warpgroup.
      auto turn_begin = [&](int kt) {
        if (pingpong && (c == 1 || kt > 0))
          asm volatile("bar.sync %0, %1;\n" ::"r"(kSchedBar + c), "n"(2 * kWGThreads) : "memory");
      };
      auto turn_end = [&](int kt) {
        if (pingpong && (c == 0 || kt < n_tiles - 1))
          asm volatile("bar.arrive %0, %1;\n" ::"r"(kSchedBar + 1 - c), "n"(2 * kWGThreads)
                       : "memory");
      };
      auto sync_wg = [&]() {
        asm volatile("bar.sync %0, %1;\n" ::"r"(kWGBar + c), "n"(kWGThreads) : "memory");
      };

      // Rope and scale the warpgroup's Q rows in place, as the one-warpgroup
      // body does its tile (pairs of 16-byte chunks, columns [col, col + 8)
      // and their RoPE partners [col + HD/2, +8), each value rounded to bf16
      // once; the tables of a batch of pairs load while the TMA brings the
      // rows). Rows at or beyond N arrived as zeros and stay so.
      {
        constexpr int kPairsPerRow = HD / 2 / kChunk;
        constexpr int kPerThread = kWGRows * kPairsPerRow / kWGThreads;
        constexpr int kBatch = 2;
#pragma unroll
        for (int p0 = 0; p0 < kPerThread; p0 += kBatch) {
          float4 tab[kBatch][8];  // cos, then sin, of the chunk and of its partner
#pragma unroll
          for (int pb = 0; pb < kBatch; ++pb) {
            const int i = tid + (p0 + pb) * kWGThreads;
            const int n = r0 + i / kPairsPerRow;
            const int col = (i % kPairsPerRow) * kChunk;
            if (cos_t != nullptr && n < N) {
              const size_t row = static_cast<size_t>(n) * HD;
              const float4* cs = reinterpret_cast<const float4*>(cos_t + row);
              const float4* sn = reinterpret_cast<const float4*>(sin_t + row);
              const int c4 = col / 4, p4 = (col + HD / 2) / 4;
              tab[pb][0] = cs[c4], tab[pb][1] = cs[c4 + 1], tab[pb][2] = cs[p4],
              tab[pb][3] = cs[p4 + 1];
              tab[pb][4] = sn[c4], tab[pb][5] = sn[c4 + 1], tab[pb][6] = sn[p4],
              tab[pb][7] = sn[p4 + 1];
            }
          }
          if (p0 == 0) mbar_wait(q_full(c), 0);
#pragma unroll
          for (int pb = 0; pb < kBatch; ++pb) {
            const int i = tid + (p0 + pb) * kWGThreads;
            const int r = i / kPairsPerRow;
            const int col = (i % kPairsPerRow) * kChunk;
            if (r0 + r >= N) continue;
            uint4* pa = reinterpret_cast<uint4*>(sq + sw128_offset(r, col));
            uint4* pp = reinterpret_cast<uint4*>(sq + sw128_offset(r, col + HD / 2));
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
                  const float x = va[u];
                  va[u] = rope(x, vp[u], true, tb[e + u], tb[16 + e + u]);
                  vp[u] = rope(vp[u], x, false, tb[8 + e + u], tb[24 + e + u]);
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
      // The wgmma reads shared memory through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sync_wg();

      // Accumulator fragments (m64nNk16): element 4 j + e of a thread is row
      // 16 warp + g + 8 (e / 2), column 8 j + 2 t + (e & 1).
      float acc[C::kAtoms][32];
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
      float l[2] = {0.f, 0.f};              // running sum
      float sc[32];                         // one tile's scores, then their exponentials
      uint32_t p[4][4];                     // P rounded to bf16: the A fragments of p.V
      float alpha[2];                       // the factor O is rescaled by before p.V
      EveryOther<slots> kc{0, 0}, vc{1, 0};  // K(0) is load 0, V(0) load 1

      // Each consumer warp releases a stage once its share of the wgmma that
      // read it has completed.
      auto release = [&](const EveryOther<slots>& at) {
        if (lane == 0) mbar_arrive(empty(at.stage));
      };
      // S = Q K^T of the tile at kc into sc, issued and committed (both
      // operands K-major; the first step does not read sc, scale-d 0).
      auto issue_qk = [&]() {
        const uint32_t k_tile = stage(kc.stage);
        mbar_wait(full(kc.stage), kc.phase);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          const uint32_t step = (kk / 4) * kAtomBytes + (kk % 4) * 32;
          wgmma_m64n64k16_ss(sc, sw128_desc(q_half + step, 16, 1024),
                             sw128_desc(k_tile + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      // O += P V of the tile at vc, issued and committed (MN-major V, each
      // 64-column atom its own n = 64 product).
      auto issue_pv = [&]() {
        const uint32_t v_tile = stage(vc.stage);
        mbar_wait(full(vc.stage), vc.phase);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16<1>(acc[a], p[kk],
                               sw128_desc(v_tile + a * kAtomBytes + kk * 2048, kAtomBytes, 1024),
                               1);
        wgmma_commit();
      };
      // The online softmax of tile kt's scores in sc, in place: keys at or
      // beyond n_valid masked by select (only the last tile holds any), the
      // running max and sum updated, sc = 2^(s log2 e - max log2 e), and the
      // factor O must be rescaled by into alpha (0 on the first tile).
      auto softmax = [&](int kt) {
        const int k0 = kt * kBlockN;
        if (k0 + kBlockN > n_valid) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * j + 2 * t + (e & 1) >= n_valid) sc[4 * j + e] = kMasked;
        }
        float mxl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(m[r], row_reduce<true>(sc, r));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          alpha[r] = ex2((m[r] - mx) * kLog2e);
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
      };
      // Key step kk of p.V is score columns 16 kk .. +15, the accumulator
      // elements of 8-column tiles 2 kk and 2 kk + 1.
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      };
      // Once the running max settles, alpha is exactly 1 and the rescale is
      // skipped (a warp-uniform branch).
      auto rescale = [&]() {
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i % 4) / 2];
        }
      };
      auto pv_done = [&]() {
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) fence_regs(acc[a]);
        fence_p(p);
        release(vc);
        vc.next();
      };

      // Tile 0's q.k^T alone in the first turn; then in turn kt, q.k^T of
      // tile kt and p.V of tile kt - 1, and tile kt's softmax while that
      // p.V runs. K(kt) (load 2 kt) is waited on before V(kt - 1) (load
      // 2 kt - 1): the producer issued V(kt - 1) first, and K(kt)'s stage
      // was freed by K(kt - 1)'s release, so no wait is on a load not yet
      // issued.
      turn_begin(0);
      issue_qk();
      turn_end(0);
      wgmma_wait<0>();
      fence_regs(sc);
      release(kc);
      kc.next();
      softmax(0);
      pack();
      for (int kt = 1; kt < n_tiles; ++kt) {
        turn_begin(kt);
        issue_qk();
        rescale();
        issue_pv();
        turn_end(kt);
        wgmma_wait<1>();  // q.k^T, the older group, is done
        fence_regs(sc);
        release(kc);
        kc.next();
        softmax(kt);
        pv_done();
        pack();
      }
      rescale();
      issue_pv();
      pv_done();

      // O / rowsum, rounded to bf16, staged in the warpgroup's Q rows (its
      // q.k^T has read them for the last time) in the same swizzled layout,
      // then written by one TMA store a 64-column atom (the map clips rows
      // at or beyond N), or through `out` with plain stores (kStagedOut).
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(sq + sw128_offset(row, kAtom * a + 8 * j) + 4 * t) =
                pack_bf16(acc[a][4 * j + 2 * r] * inv[r], acc[a][4 * j + 2 * r + 1] * inv[r]);
      }
      if constexpr (kStagedOut) {
        sync_wg();
        store_rows(sq, out, b, h, r0, N, tid);
      } else {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        sync_wg();
        if (tid == 0) {
          const HeadTiles tiles(order, h, b);
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a)
            tma_store<kRank>(&o_map, q_half + a * kAtomBytes, tiles, a * kAtom, r0);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem read: may exit
        }
      }
    }
  }
}

// --- host side ---------------------------------------------------------------

template <int HD, int kRank, bool kStagedOut>
cudaError_t run_kernel(const Prepared& p, int B, int N, int H, int n_valid, cudaStream_t st) {
  const auto kernel = attention_sm90_ws<HD, kRank, kStagedOut>;
  constexpr size_t smem = Config<HD>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kThreads, smem, st>>>(p.q_map, p.k_map, p.v_map, p.o_map, p.cos_t, p.sin_t, N,
                                       n_valid, p.scale, p.order, p.out);
  return cudaGetLastError();
}

// Launch the body (bf16) on `stream` over heads of width d, HD - 64 < d <=
// HD, d % 8 == 0, on maps at d, as attention_sm90.cuh's prepare sets it up
// (its RoPE prologue first, with tables). Returns the CUDA error of the launches (cudaSuccess when all were
// queued).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                   const void* sin_t, void* q_scratch, void* k_scratch, int B, int N, int H, int d,
                   const Layout& L, const Layout& Lo, int n_valid, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  Prepared p;
  const cudaError_t err = sm90::prepare(HD, q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N,
                                        H, d, L, Lo, n_valid, scale, true, st, &p);
  if (err != cudaSuccess) return err;
  return p.order.rank == 5 ? run_kernel<HD, 5, false>(p, B, N, H, n_valid, st)
                           : run_kernel<HD, 4, false>(p, B, N, H, n_valid, st);
}

// Launch it on heads whose rows are no 32-byte multiples (d % 16 != 0), as
// prepare_staged sets it up: the staging launch, then the staged form
// (kStagedOut). Returns the CUDA error of the launches.
template <int HD>
cudaError_t launch_staged(const void* q, const void* k, const void* v, void* o,
                          const void* cos_t, const void* sin_t, void* q_scratch, void* k_scratch,
                          int B, int N, int H, int d, const Layout& L, const Layout& Lo,
                          int n_valid, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  Prepared p;
  const cudaError_t err = sm90::prepare_staged(HD, q, k, v, o, cos_t, sin_t, q_scratch,
                                               k_scratch, B, N, H, d, L, Lo, n_valid, scale, st,
                                               &p);
  if (err != cudaSuccess) return err;
  return run_kernel<HD, 4, true>(p, B, N, H, n_valid, st);
}

}  // namespace sm90_ws
}  // namespace cbas_attention
