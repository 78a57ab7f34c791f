// The fp32 Hopper body for K3's wide heads: float32 at head dims from 132 to
// 256 (d % 4 == 0), built at HD = 192 and 256; a head of another such width
// runs at the next of them with its tensor maps at d (Q's columns beyond d
// load as zeros, O's are not stored, the prologue writes zeros there). Only
// attention_headmajor.cu includes it.
//
// Replaces the TPU kernel cbas_tpu/ops/flash_attention.py::_attn_kernel
// (entry fused_attention) in fp32 at those widths, where the port ran its
// first body's scalar FMAs (since deleted) on a copy padded to 192 or 256. The
// function and its rounding points are attention_sm90_tf32.cuh's (3xTF32:
// every fp32 operand split by tf32_split into TF32 hi and lo, every product
// lo.hi + hi.lo + hi.hi on wgmma .tf32, q.k^T's small products and each
// tile's p.V in accumulators of their own; the accurate expf; keys at or
// beyond n_valid masked by select, their V rows zero; the same prologue,
// split_kv, at HD). One sum differs: q.k^T is formed in two halves of d, one
// a warpgroup, each half's large and small products added in fp32, then the
// two halves added (a + b == b + a: both warpgroups hold the same scores).
//
// What bounds it on this card: operations, at the 3xTF32 rate (165 TFLOP/s
// of fp32-accurate products). What stands in the way of the d 64 / 128
// body's shape: at d = 256 Q_hi and Q_lo alone are 128 KB, one 32-key stage
// of K (hi and lo) 64 KB and one of V^T another 64 KB, over the 227 KB a
// block may use; and one warpgroup of 64 rows would hold O and the tile's
// p.V in d / 2 + d / 2 = 256 fp32 registers a thread. What the design does:
//
// - Two consumer warpgroups share 64 query rows, 256 threads. Warpgroup w
//   takes columns [w d/2, (w + 1) d/2) of d (HD / 2 of them): it forms the
//   partial q.k^T over those, meets the other's partial in shared memory
//   (as attention_wide.cuh's bf16 body), runs the same online softmax on
//   the same scores, and owns that half of O and of p.V: HD / 4 + HD / 4
//   registers a thread (64 + 64 at 256).
// - Q is kept once, in fp32 (64 KB at d = 256): roped and scaled in place
//   once a block, then split in registers at every k-step of every tile (its
//   A fragments are loaded from shared memory afresh each tile, never held
//   across the loop), and q.k^T runs as register-A wgmma, as p.V takes P.
//   Each k-step reads Q once for its three products. The A registers of two
//   commit groups of kQGroup k-steps are in flight at a time (wait_group 1).
// - No producer warp: a block of more than 256 threads is capped at 168
//   registers a thread (attention_wide.cuh). Each warpgroup's thread 0
//   feeds the warpgroup's own ring of 32-key stages, each stage the
//   warpgroup's half of a K tile or of a V^T tile, hi and lo planes (24 KB
//   at 192, 32 KB at 256): 3 stages a warpgroup at 192, 2 at 256. Block
//   shared memory: 209 KB at both, so one block an SM.
// - RoPE at d, not HD: the block ropes its Q tile in shared memory pairing
//   column c with c + d/2 (8-byte pairs: d/2 is even); K is roped by the
//   prologue at d/2 too.
//
// Grid: (ceil(N / 64) query blocks, H, B), 256 threads.

#pragma once

#include "attention_sm90_tf32.cuh"

namespace cbas_attention {
namespace tf32 {

// The wgmma shapes this body adds to attention_sm90_tf32.cuh's: q.k^T at
// n = 32 keys with A in registers, p.V at n = 96 columns (half of 192).
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

}  // namespace tf32

namespace tf32_wide {

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
using tf32::kAtomCols;
using tf32::kKeys;
using tf32::kRows;
using tf32::kWGThreads;
using tf32::sw128_f32;
using tf32::tf32_split;
using tf32::wgmma_rs;

constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * kWGThreads;
constexpr int kQGroup = 4;  // q.k^T k-steps a commit group (1, 2 and 4 timed: PERF.md)

template <int HD>
struct Config {
  static_assert(HD == 192 || HD == 256, "the wide fp32 Hopper body takes head dims 192 and 256");
  static constexpr int kHalf = HD / 2;                   // a warpgroup's columns of d
  static constexpr int kAtoms = HD / kAtomCols;          // Q's atoms
  static constexpr int kHalfAtoms = kHalf / kAtomCols;   // a warpgroup's
  static constexpr int kQAtomBytes = kRows * 128;
  static constexpr int kQBytes = kAtoms * kQAtomBytes;   // Q, fp32
  static constexpr int kKAtomBytes = kKeys * 128;        // kKeys rows of 32 columns of d
  // A warpgroup's half of a tile's K_hi (kKeys rows of kHalf columns), or of
  // its V^T_hi (kHalf rows of kKeys keys): the same bytes.
  static constexpr int kPlaneBytes = kKeys * kHalf * 4;
  static constexpr int kStageBytes = 2 * kPlaneBytes;    // hi, then lo
  static constexpr int kSlots = HD == 192 ? 3 : 2;       // a warpgroup's ring
  static constexpr int kPartialBytes = kRows * kKeys * 4;  // a warpgroup's partial scores
  // Each warpgroup's full and empty barrier a stage, Q's, and the partials' three.
  static constexpr int kBarriers = kConsumers * 2 * kSlots + 4;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr size_t kSmemBytes = 1024 + kQBytes + kConsumers * kSlots * kStageBytes +
                                       kConsumers * kPartialBytes + kBarriers * 8;
  static_assert(kSmemBytes <= 232448, "a block uses at most 227 KB of shared memory");
};

// One block: query rows [blockIdx.x * 64, +64) of head blockIdx.y of image
// blockIdx.z, heads d wide. Warps 0-3 and 4-7 are the consumer warpgroups
// 0 and 1. Q's and O's maps share one dim order (MapAddress), have N rows and
// are d wide; k_map is rank 3 over the scratch's K planes (HD, B H n_keys
// rows, planes 0-1), v_map over its V^T planes (n_keys, B H HD rows, planes
// 2-3), boxes of HD / 2 rows. Tables are (N, d).
template <int HD, int kRank>
__global__ void __launch_bounds__(kThreads, 1)
attention_tf32_wide(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, int N, int d, int n_valid, int n_keys, int H,
                    float scale, const MapAddress order) {
  using C = Config<HD>;
  constexpr int kSteps = C::kHalf / 8;  // a warpgroup's k-steps of q.k^T
  constexpr int kPSteps = kKeys / 8;    // k-steps of p.V
  constexpr int kS = kKeys / 2;         // score registers a thread
  constexpr int kO = C::kHalf / 2;      // output registers a thread
  static_assert(kSteps % kQGroup == 0, "whole commit groups");

  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int wtid = tid % kWGThreads;
  const int warp = wtid / 32;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // Shared memory: Q (atom a at a * kQAtomBytes), warpgroup 0's ring, 1's,
  // the two partial score tiles, then the barriers: warpgroup w's full and
  // empty ones, Q's, both partials written, and partial w read.
  unsigned char* raw = dynamic_smem();
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t q_tile = (raw_addr + 1023u) & ~1023u;
  unsigned char* sq = raw + (q_tile - raw_addr);
  const uint32_t ring = q_tile + C::kQBytes + wg * C::kSlots * C::kStageBytes;
  float* partials = reinterpret_cast<float*>(sq + C::kQBytes + kConsumers * C::kSlots * C::kStageBytes);
  const uint32_t bars0 = smem_u32(partials) + kConsumers * C::kPartialBytes;
  const uint32_t bars = bars0 + wg * 2 * C::kSlots * 8;
  // Load i of a warpgroup's ring is its half of K(i / 2) if i is even, else
  // of V^T(i / 2), into stage i % kSlots: the hi plane, then the lo plane.
  auto full = [&](int i) { return bars + 8u * (i % C::kSlots); };
  auto empty = [&](int i) { return bars + 8u * (C::kSlots + i % C::kSlots); };
  auto stage = [&](int i) { return ring + (i % C::kSlots) * C::kStageBytes; };
  const uint32_t q_full = bars0 + 8u * kConsumers * 2 * C::kSlots;
  const uint32_t partials_full = q_full + 8u;
  auto partial_free = [&](int w) { return q_full + 16u + 8u * w; };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (n_valid + kKeys - 1) / kKeys;  // tiles past n_valid add zeros
  const int col0 = wg * C::kHalf;                     // the warpgroup's first column of d

  if (tid == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < C::kSlots; ++s) {
        mbar_init(bars0 + 8u * (w * 2 * C::kSlots + s), 1);
        mbar_init(bars0 + 8u * (w * 2 * C::kSlots + C::kSlots + s), kWGThreads / 32);
      }
    mbar_init(q_full, 1);
    mbar_init(partials_full, kThreads / 32);
    for (int w = 0; w < kConsumers; ++w) mbar_init(partial_free(w), kWGThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const HeadTiles tiles(order, h, b);
  const int k_row = (b * H + h) * n_keys;         // the head's first row in K's planes
  const int v_row = (b * H + h) * HD + col0;      // and the warpgroup's first in V^T's
  auto issue = [&](int i) {
    const int k0 = (i / 2) * kKeys;
    mbar_expect_tx(full(i), C::kStageBytes);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t dst = stage(i) + p * C::kPlaneBytes;
      if (i % 2 == 0) {
#pragma unroll
        for (int a = 0; a < C::kHalfAtoms; ++a)
          tf32::tma_load_3d(dst + a * C::kKAtomBytes, &k_map, full(i), col0 + a * kAtomCols,
                            k_row + k0, p);
      } else {
        tf32::tma_load_3d(dst, &v_map, full(i), k0, v_row, p);
      }
    }
  };
  if (wtid == 0) {
    if (wg == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        sm90::tma_load<kRank>(q_tile + a * C::kQAtomBytes, &q_map, q_full, tiles, a * kAtomCols, q0);
    }
    for (int i = 0; i < C::kSlots && i < 2 * n_tiles; ++i) issue(i);
  }

  // Rope and scale the Q tile in place, all 256 threads: with tables, pairs
  // of 2 columns [c, c + 2) of the first half of d and their partners
  // [c + d/2, +2) (each value rounded once by the rotation, once by the
  // scale, as the d 64 / 128 body rounds it); without, every 4 columns.
  // Rows at or beyond N and columns at or beyond d arrived as zeros and stay
  // so. q.k^T reads Q through the generic proxy (register A), so a barrier
  // suffices.
  mbar_wait(q_full, 0);
  if (cos_t != nullptr) {
    const int half = d / 2;
    const int pairs = half / 2;
    for (int i = tid; i < kRows * pairs; i += kThreads) {
      const int r = i / pairs;
      const int c = 2 * (i % pairs);
      const int n = q0 + r;
      float2* pa = reinterpret_cast<float2*>(sq + sw128_f32(r, c, C::kQAtomBytes));
      float2* pp = reinterpret_cast<float2*>(sq + sw128_f32(r, c + half, C::kQAtomBytes));
      float2 a = *pa, p = *pp;
      if (n < N) {
        float ca[2], sa[2], cp[2], sp[2];
        const size_t row = static_cast<size_t>(n) * d;
        load_table<2>(cos_t + row + c, ca);
        load_table<2>(sin_t + row + c, sa);
        load_table<2>(cos_t + row + c + half, cp);
        load_table<2>(sin_t + row + c + half, sp);
        const float2 x = a;
        a.x = rope(x.x, p.x, true, ca[0], sa[0]), a.y = rope(x.y, p.y, true, ca[1], sa[1]);
        p.x = rope(p.x, x.x, false, cp[0], sp[0]), p.y = rope(p.y, x.y, false, cp[1], sp[1]);
      }
      *pa = make_float2(a.x * scale, a.y * scale);
      *pp = make_float2(p.x * scale, p.y * scale);
    }
  } else {
    constexpr int kQuads = HD / tf32::kVec;
    for (int i = tid; i < kRows * kQuads; i += kThreads) {
      float4* px = reinterpret_cast<float4*>(
          sq + sw128_f32(i / kQuads, (i % kQuads) * tf32::kVec, C::kQAtomBytes));
      const float4 x = *px;
      *px = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }
  __syncthreads();

  auto wait_full = [&](int i) { mbar_wait(full(i), (i / C::kSlots) & 1); };
  // Each warp releases a stage once its share of the wgmma that read it has
  // completed; thread 0 then refills the stage with the load kSlots later.
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i));
    if (wtid == 0 && i + C::kSlots < 2 * n_tiles) {
      mbar_wait(empty(i), (i / C::kSlots) & 1);
      issue(i + C::kSlots);
    }
  };

  // Accumulator fragments (m64nNk8): element 4 j + e of a thread is row
  // 16 warp + g + 8 (e / 2), column 8 j + 2 t + (e & 1). The accumulators
  // are attention_sm90_tf32.cuh's: s_small for q.k^T's small products, s for
  // its large, pv for a tile's p.V; none is zeroed (each one's first product
  // does not read it).
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum
  float s[kS], s_small[kS], pv[kO];
  float* mine = partials + wg * (C::kPartialBytes / 4);
  const float* theirs = partials + (1 - wg) * (C::kPartialBytes / 4);
  // This thread's Q rows (r0 and r0 + 8) in the warpgroup's atoms: a
  // k-step's A fragment is columns t and t + 4 of its 8, the chunks
  // 2 (kk % 4) and 2 (kk % 4) + 1 of atom kk / 4, swizzled by row % 8 = g.
  const unsigned char* q_rows =
      sq + wg * C::kHalfAtoms * C::kQAtomBytes + 128 * (16 * warp + g) + 4 * t;

  uint32_t phi[kPSteps][4], plo[kPSteps][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    // The warpgroup's partial S = Q K(kt)^T over its kSteps k-steps: each
    // k-step's Q fragment loaded and split, then Q_lo K_hi and Q_hi K_lo
    // into s_small and Q_hi K_hi into s, kQGroup k-steps a commit group;
    // the A registers of the group before are free once wait_group 1 says
    // that group has completed.
    const uint32_t k_hi = stage(2 * kt);
    const uint32_t k_lo = k_hi + C::kPlaneBytes;
    wait_full(2 * kt);
    fence_regs(s);
    fence_regs(s_small);
    uint32_t a_hi[2][kQGroup][4], a_lo[2][kQGroup][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int buf = (kk / kQGroup) % 2, e = kk % kQGroup;
      const unsigned char* atom = q_rows + (kk / 4) * C::kQAtomBytes;
      const int j = 2 * (kk % 4);
      const float x[4] = {*reinterpret_cast<const float*>(atom + 16 * (j ^ g)),
                          *reinterpret_cast<const float*>(atom + 1024 + 16 * (j ^ g)),
                          *reinterpret_cast<const float*>(atom + 16 * ((j + 1) ^ g)),
                          *reinterpret_cast<const float*>(atom + 1024 + 16 * ((j + 1) ^ g))};
#pragma unroll
      for (int r = 0; r < 4; ++r) tf32_split(x[r], a_hi[buf][e][r], a_lo[buf][e][r]);
      if (e == kQGroup - 1) {
        wgmma_fence();
#pragma unroll
        for (int ee = 0; ee < kQGroup; ++ee) {
          const int step = kk - (kQGroup - 1) + ee;
          const uint32_t sk = (step / 4) * C::kKAtomBytes + (step % 4) * 32;
          wgmma_rs<kKeys>(s_small, a_lo[buf][ee], sw128_desc(k_hi + sk, 16, 1024), step > 0);
          wgmma_rs<kKeys>(s_small, a_hi[buf][ee], sw128_desc(k_lo + sk, 16, 1024), 1);
          wgmma_rs<kKeys>(s, a_hi[buf][ee], sw128_desc(k_hi + sk, 16, 1024), step > 0);
        }
        wgmma_commit();
        if (kk >= 2 * kQGroup - 1) wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(s_small);
    release(2 * kt);
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

    // pv = P V(kt) over the warpgroup's half of O: P_lo V_hi and P_hi V_lo
    // over every 8-key step, then P_hi V_hi. The V^T half is kHalf rows of
    // 32 keys; a k-step is 32 bytes into them.
    const uint32_t v_hi = stage(2 * kt + 1);
    const uint32_t v_lo = v_hi + C::kPlaneBytes;
    wait_full(2 * kt + 1);
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      wgmma_rs<C::kHalf>(pv, plo[j], sw128_desc(v_hi + 32 * j, 16, 1024), j > 0);
      wgmma_rs<C::kHalf>(pv, phi[j], sw128_desc(v_lo + 32 * j, 16, 1024), 1);
    }
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
      wgmma_rs<C::kHalf>(pv, phi[j], sw128_desc(v_hi + 32 * j, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    release(2 * kt + 1);
    // O = O alpha + P V(kt), one fp32 rounding an element.
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = fmaf(o[i], alpha[(i % 4) / 2], pv[i]);
  }

  // O / row sum, staged in the warpgroup's own Q atoms (each warp writes the
  // rows only it has read), then written by one TMA store an atom that holds
  // columns below d; the map clips rows at or beyond N and columns at or
  // beyond d.
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < C::kHalf / 8; ++j)
      *reinterpret_cast<float2*>(sq + sw128_f32(row, col0 + 8 * j + 2 * t, C::kQAtomBytes)) =
          make_float2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWGThreads) : "memory");
  if (wtid == 0) {
#pragma unroll
    for (int a = 0; a < C::kHalfAtoms; ++a) {
      const int col = col0 + a * kAtomCols;
      if (col < d) sm90::tma_store<kRank>(&o_map, q_tile + (col / kAtomCols) * C::kQAtomBytes, tiles, col, q0);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem read: may exit
  }
}

// Launch the wide fp32 Hopper body on `stream` over heads of width d (d % 4
// == 0, HD / 2 < d <= HD): the prologue (tf32::split_kv at HD) into
// `scratch` (4 planes of B H tf32::scratch_keys(n_valid) HD fp32), then the
// attention kernel. q, k and v lie as L says, o as Lo says, in the same dim
// order (map_shape). *prologues counts the prologue's launches that were
// queued (0 or 1). Returns the CUDA error of the launches (cudaSuccess when
// both were queued).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* cos_t,
                   const void* sin_t, void* scratch, int B, int N, int H, int d, const Layout& L,
                   const Layout& Lo, int n_valid, float scale, void* stream, int* prologues) {
  using C = Config<HD>;
  const cudaError_t bad = check_args(B, N, H, L, Lo, n_valid);
  if (bad != cudaSuccess) return bad;
  if (d % 4 || d <= HD / 2 || d > HD) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      tf32::launch_split<HD>(k, v, scratch, cos_t, sin_t, B, H, d, L, n_valid, st);
  if (err != cudaSuccess) return err;
  ++*prologues;
  const int n_keys = tf32::scratch_keys(n_valid);
  const long long plane = static_cast<long long>(B) * H * n_keys * HD;
  const auto* planes = static_cast<const float*>(scratch);
  sm90::MapShape m;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!sm90::map_shape(L, Lo, d, B, N, H, &m) || !tf32::encode_rows_map(&q_map, q, m, N, false) ||
      !tf32::encode_rows_map(&o_map, o, m, N, true) ||
      !tf32::encode_plane_map(&k_map, planes, HD, static_cast<long long>(B) * H * n_keys, kKeys,
                              plane) ||
      !tf32::encode_plane_map(&v_map, planes + 2 * plane, n_keys,
                              static_cast<long long>(B) * H * HD, C::kHalf, plane))
    return cudaErrorInvalidValue;
  const auto kernel = m.order.rank == 5 ? attention_tf32_wide<HD, 5> : attention_tf32_wide<HD, 4>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(C::kSmemBytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, C::kSmemBytes, st>>>(
      q_map, k_map, v_map, o_map, static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      N, d, n_valid, n_keys, H, scale, m.order);
  return cudaGetLastError();
}

}  // namespace tf32_wide
}  // namespace cbas_attention
