// The persistent Hopper body of the port's fused attention in bfloat16, built
// at head dims 64 and 128, the widths of every DINO checkpoint: a timing case
// beside the one-warpgroup body (attention_sm90.cuh), which K1, K2 and K3 run
// there. No route calls it: it ran slower than that body at every main shape
// (PERF.md §6, PR 24); csrc/attention_persistent.cu is its entry.
//
// It computes what K1 (cbas_tpu/ops/flash_attention.py::_fat_kernel,
// pallas_call :728), K2 (::_packed_attn_kernel, :522) and K3 (::_attn_kernel,
// :393) compute at those widths, bit for bit the one-warpgroup body's: RoPE
// in fp32 with one rounding of roped, scaled q and of roped k (by the
// prologue rope_rows), keys at or beyond n_valid masked by select, dead K and
// V rows read as zeros (the maps end at n_valid), the exact fp32 online
// softmax, p rounded to bf16 before p.V. The tensor maps, their MapAddress
// and the RoPE prologue are that body's (sm90::prepare), so every layout it
// reads, strided views included, reads here.
//
// What bounds it on this card: at N = 261 the bytes of q, k, v and o; at
// N = 1205 the N^2 score work on the tensor cores. The one-warpgroup body
// reaches a third of either: a block is one 64-row query tile whose chain
// per key tile (q.k^T, wait, softmax, p.V, wait) overlaps only the other
// blocks of its SM, and each block pays its set-up, Q's load and its RoPE
// before its first product. What this design does about it:
//
// - Persistent blocks. The grid is the blocks the card holds at once; each
//   walks work items, one 64-row query tile of one (image, head) each,
//   taking the next from a counter in device memory (an atomic add), so the
//   items in flight stay a compact run in (image, head, tile) order, as the
//   hardware's own block order keeps them, and the K and V of the heads in
//   flight stay in L2.
// - A ring that spans work items: the producer warp keeps kStages K and V
//   tiles in flight across an item's end, and loads the next item's Q (Q
//   double-buffered) right after this item's first K and V.
// - Q roped and scaled off the consumers' chain, by a warp of its own (the
//   RoPE warp) while the consumers work on the item before: in the consumer
//   warpgroup the tables beside the walk's state spilled the accumulators at
//   every block count ptxas was given.
//
// Measured and taken out (PERF.md §6, PR 24): clusters of two blocks that
// multicast each K and V tile, the last key tile at its live width (ptxas
// serialized the wgmmas of every build that had it) and the K prologue
// under programmatic dependent launch, each slower or no faster; a fixed
// share of items a block, in place of the counter.
//
// Grid: the blocks the card holds at once, or fewer where there are fewer
// work items; a block is one consumer warpgroup, a producer warp and the
// RoPE warp.

#pragma once

#include "attention_sm90.cuh"

namespace cbas_attention {
namespace sm90p {

using sm90::HeadTiles;
using sm90::kAtom;
using sm90::kAtomBytes;
using sm90::kBlockN;
using sm90::kLog2e;
using sm90::kWGRows;
using sm90::kWGThreads;
using sm90::MapAddress;
using sm90::Prepared;
using sm90::RingCursor;
using sm90::sw128_offset;
using sm90::Tiles;

// A build: head dim, ring stages (K and V tiles, taken in turn), blocks an
// SM (__launch_bounds__).
template <int HD, int kStages, int kBlocks>
struct Config : Tiles<HD> {
  static_assert(HD == 64 || HD == 128, "the persistent body is built at 64 and 128");
  static_assert(!Tiles<HD>::kHalf, "whole 64-column atoms only");
  static_assert(kStages >= 2, "a K and a V tile in flight at least");
  using Tiles<HD>::kBoxes;
  using Tiles<HD>::kTileBytes;
  static constexpr int kStageCount = kStages, kBlocksPerSm = kBlocks;
  // The consumer warpgroup, the producer warp and the RoPE warp.
  static constexpr int kThreads = kWGThreads + 64;
  static constexpr int kQBytes = kBoxes * kAtomBytes;
  // Two Q tiles, the ring, then the barriers (full and empty a stage; full,
  // ready (roped) and empty a Q tile) and the two Q tiles' items; 1024 bytes
  // of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr size_t kSmemBytes =
      1024 + 2 * kQBytes + kStages * kTileBytes + (2 * kStages + 6) * 8 + 2 * 4;
};

// d 64: 3 blocks an SM and a ring of 4 stages (two K and V pairs): 2 x 8 KB
// of Q and 32 KB of ring. Six warps a block hold ptxas to 96 registers a
// thread at 3 blocks (5 warps of an SM sub-partition's 16384 registers), the
// one-warpgroup body's cap at 4 blocks of five warps. d 128: 2 blocks an SM
// (168 registers; at 3, 96) and 4 stages: 2 x 16 KB of Q and 64 KB of ring.
template <int HD>
using Build = Config<HD, 4, HD == 64 ? 3 : 2>;

// --- the products --------------------------------------------------------

// S = Q K^T of one key tile (m64n64, fp32) into s, its HD / 16 k-steps
// issued and committed by the caller: both operands K-major from shared
// memory, a 16-deep step 32 bytes into the atoms' rows.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t step = (kk / 4) * kAtomBytes + (kk % 4) * 32;
    sm90::wgmma_m64n64k16_ss(s, sm90::sw128_desc(q_tile + step, 16, 1024),
                             sm90::sw128_desc(k_tile + step, 16, 1024), kk > 0);
  }
}

// O += p . V of one V tile, each 64-column atom of V its own n = 64
// product over four 16-key steps (MN-major B).
template <int kAtoms>
__device__ __forceinline__ void issue_pv(float (&acc)[kAtoms][32], const uint32_t (&p)[4][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16<1>(acc[a], p[kk],
                               sm90::sw128_desc(v_tile + a * kAtomBytes + kk * 2048, kAtomBytes,
                                                1024),
                               1);
}

// --- the work items --------------------------------------------------------

// Item i is query tile t of head h of image b, i = (b H + h) T + t with
// T = ceil(N / 64) tiles a head: consecutive items share a head's K and V.
// ops/attention_persistent.py::work_item mirrors it.
__device__ __forceinline__ void work_item(int i, int H, int n_qt, int& b, int& h, int& t) {
  const int bh = i / n_qt;
  t = i - bh * n_qt;
  b = bh / H;
  h = bh - b * H;
}

// The kernel. Warps 0-3 are the consumer warpgroup, warp 4 the producer,
// warp 5 the RoPE warp. The producer takes each item from `counter` (zero at
// the launch) and publishes it with its Q tile (items[] beside the tiles'
// barriers; an index at or past the items' count ends the walk); the RoPE
// warp and the consumers read it there. The four maps share one MapAddress;
// Q's and O's maps have N rows, K's and V's n_valid.
template <int HD, int kRank, int kStages, int kBlocks>
__global__ void __launch_bounds__(kWGThreads + 64, kBlocks)
attention_sm90_persistent(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                          int B, int N, int H, int n_valid, float scale, const MapAddress order,
                          int* counter) {
  using C = Config<HD, kStages, kBlocks>;
  constexpr int kAtoms = C::kAtoms;

  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t q_base = (raw_addr + 1023u) & ~1023u;
  auto q_tile = [&](int s) { return q_base + s * C::kQBytes; };
  const uint32_t ring = q_base + 2 * C::kQBytes;
  auto stage = [&](int s) { return ring + s * C::kTileBytes; };
  const uint32_t bars = ring + kStages * C::kTileBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto q_full = [&](int s) { return bars + 8u * (2 * kStages + s); };
  auto q_empty = [&](int s) { return bars + 8u * (2 * kStages + 2 + s); };
  auto q_ready = [&](int s) { return bars + 8u * (2 * kStages + 4 + s); };
  volatile int* items =
      reinterpret_cast<volatile int*>(raw + (bars - raw_addr) + 8 * (2 * kStages + 6));

  const int n_qt = (N + kWGRows - 1) / kWGRows;
  const int n_items = B * H * n_qt;
  const int n_tiles = (n_valid + kBlockN - 1) / kBlockN;  // tiles past n_valid add zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kWGThreads / 32);  // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 1);
      sm90::mbar_init(q_ready(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWGThreads + 32) {
    // The RoPE warp ropes and scales each item's Q tile in place once it
    // lands (attention_sm90.cuh's staging of it, the same rounding), the
    // tables of a batch of pairs loading together, then marks it ready.
    const int lane = threadIdx.x % 32;
    for (int qn = 0;; ++qn) {
      const int qs = qn & 1;
      sm90::mbar_wait(q_full(qs), (qn >> 1) & 1);
      const int i = items[qs];
      if (i >= n_items) {  // the end of the walk
        if (lane == 0) sm90::mbar_arrive(q_ready(qs));
        break;
      }
      int b, h, t;
      work_item(i, H, n_qt, b, h, t);
      const int q0 = t * kWGRows;
      unsigned char* sq = raw + (q_tile(qs) - raw_addr);
      constexpr int kPairsPerRow = HD / 2 / kChunk;
      constexpr int kPerLane = kWGRows * kPairsPerRow / 32;  // 8 or 16
      constexpr int kBatch = 2;
#pragma unroll
      for (int p0 = 0; p0 < kPerLane; p0 += kBatch) {
        float4 tab[kBatch][8];  // cos, then sin, of the chunk and of its partner
#pragma unroll
        for (int pb = 0; pb < kBatch; ++pb) {
          const int e = lane + (p0 + pb) * 32;
          const int n = q0 + e / kPairsPerRow;
          const int c = (e % kPairsPerRow) * kChunk;
          if (cos_t != nullptr && n < N) {
            const size_t row = static_cast<size_t>(n) * HD;
            const float4* cs = reinterpret_cast<const float4*>(cos_t + row);
            const float4* sn = reinterpret_cast<const float4*>(sin_t + row);
            const int c4 = c / 4, p4 = (c + HD / 2) / 4;
            tab[pb][0] = cs[c4], tab[pb][1] = cs[c4 + 1], tab[pb][2] = cs[p4],
            tab[pb][3] = cs[p4 + 1];
            tab[pb][4] = sn[c4], tab[pb][5] = sn[c4 + 1], tab[pb][6] = sn[p4],
            tab[pb][7] = sn[p4 + 1];
          }
        }
#pragma unroll
        for (int pb = 0; pb < kBatch; ++pb) {
          const int e = lane + (p0 + pb) * 32;
          const int r = e / kPairsPerRow;
          const int c = (e % kPairsPerRow) * kChunk;
          if (q0 + r >= N) continue;  // rows past N arrived as zeros and stay so
          uint4* pa = reinterpret_cast<uint4*>(sq + sw128_offset(r, c));
          uint4* pp = reinterpret_cast<uint4*>(sq + sw128_offset(r, c + HD / 2));
          const uint4 xa = *pa, xp = *pp;
          const float* tb = reinterpret_cast<const float*>(tab[pb]);
          uint4 ya, yp;
          auto* a32 = reinterpret_cast<uint32_t*>(&ya);
          auto* p32 = reinterpret_cast<uint32_t*>(&yp);
#pragma unroll
          for (int e2 = 0; e2 < kChunk; e2 += 2) {
            float va[2], vp[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              va[u] = bf16_at(xa, e2 + u);
              vp[u] = bf16_at(xp, e2 + u);
              if (cos_t != nullptr) {
                const float a = va[u];
                va[u] = rope(a, vp[u], true, tb[e2 + u], tb[16 + e2 + u]);
                vp[u] = rope(vp[u], a, false, tb[8 + e2 + u], tb[24 + e2 + u]);
              }
            }
            a32[e2 / 2] = pack_bf16(va[0] * scale, va[1] * scale);
            p32[e2 / 2] = pack_bf16(vp[0] * scale, vp[1] * scale);
          }
          *pa = ya;
          *pp = yp;
        }
      }
      // The wgmma reads shared memory through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(q_ready(qs));
    }
  } else if (threadIdx.x >= kWGThreads) {
    // Producer: one thread takes the items, loading each one's K and V tiles
    // through the ring and the next item's Q into the next Q tile right
    // after this item's first K and V, so that it lands (and is roped) while
    // the consumers work on this one.
    if (threadIdx.x == kWGThreads) {
      RingCursor kv;
      int qn = 0;  // Q tiles published
      // Item i with its Q tile; an index past the walk (the end) with a bare
      // arrival.
      auto publish = [&](int i) {
        const int qs = qn & 1;
        sm90::mbar_wait(q_empty(qs), ((qn >> 1) & 1) ^ 1);  // each tile's first use passes
        items[qs] = i;
        ++qn;
        if (i >= n_items) {
          sm90::mbar_arrive(q_full(qs));
          return;
        }
        int b, h, t;
        work_item(i, H, n_qt, b, h, t);
        sm90::mbar_expect_tx(q_full(qs), C::kQBytes);
        const HeadTiles tiles(order, h, b);
#pragma unroll
        for (int a = 0; a < C::kBoxes; ++a)
          sm90::tma_load<kRank>(q_tile(qs) + a * kAtomBytes, &q_map, q_full(qs), tiles,
                                a * kAtom, t * kWGRows);
      };
      int i = atomicAdd(counter, 1);
      publish(i);
      while (i < n_items) {
        int b, h, t;
        work_item(i, H, n_qt, b, h, t);
        const HeadTiles tiles(order, h, b);
        int next = n_items;
        for (int u = 0; u < 2 * n_tiles; ++u) {
          const CUtensorMap* map = u % 2 ? &v_map : &k_map;
          sm90::mbar_wait(empty(kv.stage), kv.phase ^ 1);  // round 0 passes at once
          sm90::mbar_expect_tx(full(kv.stage), C::kTileBytes);
#pragma unroll
          for (int a = 0; a < C::kBoxes; ++a)
            sm90::tma_load<kRank>(stage(kv.stage) + a * kAtomBytes, map, full(kv.stage), tiles,
                                  a * kAtom, (u / 2) * kBlockN);
          kv.next(kStages);
          if (u == 1) {
            next = atomicAdd(counter, 1);
            publish(next);
          }
        }
        i = next;
      }
    }
  } else {
    // The consumer warpgroup.
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    RingCursor kv;
    auto wait_full = [&]() { sm90::mbar_wait(full(kv.stage), kv.phase); };
    // Each consumer warp releases a stage once its share of the wgmma that
    // read it has completed.
    auto release = [&]() {
      if (lane == 0) sm90::mbar_arrive(empty(kv.stage));
      kv.next(kStages);
    };

    for (int qn = 0;; ++qn) {
      const int qs = qn & 1;
      sm90::mbar_wait(q_ready(qs), (qn >> 1) & 1);  // landed, roped and scaled
      const int i = items[qs];
      if (i >= n_items) break;
      unsigned char* sq = raw + (q_tile(qs) - raw_addr);

      // Accumulator fragments (m64nNk16): element 4 j + e of a thread is row
      // 16 warp + g + 8 (e / 2), column 8 j + 2 t4 + (e & 1).
      float acc[kAtoms][32];
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[a][e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float sc[32];
      uint32_t pf[4][4];

      // Per key tile: q.k^T, the online softmax, p.V (attention_sm90.cuh's
      // chain and rounding). Each stage is released as soon as its wgmma
      // has read it.
      for (int kt = 0; kt < n_tiles; ++kt) {
        wait_full();
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
        issue_qk<HD>(sc, q_tile(qs), stage(kv.stage));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        release();

        // Dead keys (only in the last tile) masked by select: their p is
        // exactly 0.
        const int k0 = kt * kBlockN;
        if (k0 + kBlockN > n_valid) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * j + 2 * t4 + (e & 1) >= n_valid) sc[4 * j + e] = kMasked;
        }
        float alpha[2], mxl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(m[r], sm90::row_reduce<true>(sc, r));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          alpha[r] = sm90::ex2((m[r] - mx) * kLog2e);
          m[r] = mx;
          mxl[r] = mx * kLog2e;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = sm90::ex2(fmaf(sc[e], kLog2e, -mxl[(e % 4) / 2]));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float rs = sm90::row_reduce<false>(sc, r);
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          l[r] = l[r] * alpha[r] + rs;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pf[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[a][e] *= alpha[(e % 4) / 2];
        }

        wait_full();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) sm90::fence_regs(acc[a]);
        sm90::wgmma_fence();
        issue_pv<kAtoms>(acc, pf, stage(kv.stage));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) sm90::fence_regs(acc[a]);
        release();
      }

      // O / rowsum, rounded to bf16, staged in this item's Q tile (q.k^T has
      // read it for the last time) in its swizzled layout, then one TMA
      // store an atom; the map clips rows at or beyond N. The Q tile takes
      // the item after next once the store has read it.
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(sq + sw128_offset(row, kAtom * a + 8 * j) + 4 * t4) =
                pack_bf16(acc[a][4 * j + 2 * r] * inv[r], acc[a][4 * j + 2 * r + 1] * inv[r]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWGThreads) : "memory");
      if (tid == 0) {
        int b, h, t;
        work_item(i, H, n_qt, b, h, t);
        const HeadTiles tiles(order, h, b);
#pragma unroll
        for (int a = 0; a < C::kBoxes; ++a)
          sm90::tma_store<kRank>(&o_map, q_tile(qs) + a * kAtomBytes, tiles, a * kAtom,
                                 t * kWGRows);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        sm90::mbar_arrive(q_empty(qs));
      }
    }
  }
}

// --- host side ---------------------------------------------------------------

// Launch the persistent body (bf16) at head dim HD on `stream` over heads of
// width d (d % 16 == 0, HD - 64 < d <= HD), as sm90::prepare sets it up (its
// RoPE prologue first, with tables). `counter` is 4 bytes of device memory
// the launch zeroes and the blocks take items from; `blocks`, where given,
// is set to the grid's blocks. Returns the CUDA error of the launches
// (cudaSuccess when all were queued).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                   const void* sin_t, void* q_scratch, void* k_scratch, int* counter, int B,
                   int N, int H, int d, const Layout& L, const Layout& Lo, int n_valid,
                   float scale, void* stream, int* blocks = nullptr) {
  using C = Build<HD>;
  const auto st = static_cast<cudaStream_t>(stream);
  // Every block takes one index past the items at its end: the counter stays
  // under 2^31.
  const long long items = static_cast<long long>(B) * H * ((N + kWGRows - 1) / kWGRows);
  if (counter == nullptr || N <= 0 || items <= 0 || items + (1 << 20) > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  Prepared p;
  cudaError_t err = sm90::prepare(HD, q, k, v, o, cos_t, sin_t, q_scratch, k_scratch, B, N, H, d,
                                  L, Lo, n_valid, scale, true, st, &p);
  if (err != cudaSuccess) return err;
  const auto kernel = p.order.rank == 5
                          ? attention_sm90_persistent<HD, 5, C::kStageCount, C::kBlocksPerSm>
                          : attention_sm90_persistent<HD, 4, C::kStageCount, C::kBlocksPerSm>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmemBytes));
  // All of the SM's shared memory for its blocks: without it the driver's
  // carveout held a build to fewer blocks an SM than fit (PERF.md §6, PR 24).
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int per_sm = 0, sms = 0, device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads,
                                                        C::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(items < per_sm * sms ? items : per_sm * sms);
  if (blocks != nullptr) *blocks = grid;
  err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::kThreads, C::kSmemBytes, st>>>(p.q_map, p.k_map, p.v_map, p.o_or_vhalf_map,
                                                   p.cos_t, p.sin_t, B, N, H, n_valid, p.scale,
                                                   p.order, counter);
  return cudaGetLastError();
}

}  // namespace sm90p
}  // namespace cbas_attention
