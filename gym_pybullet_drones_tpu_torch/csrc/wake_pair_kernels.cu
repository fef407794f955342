// K2, K5: the coupled swarm's all-pairs wake pass and the fused wake and
// contact pass, cut into work units of a few source tiles that the block
// scheduler spreads evenly over the SMs.
//
// Replaces two TPU kernels of gym_pybullet_drones_tpu/ops/:
//   K2  downwash_pallas.py:33  make_downwash_pallas (pallas_call :140), the
//       wake sum  -sum K/dz^2 exp(-dxy^2 / (2 beta^2))  over sources above,
//       square (sources = targets) or rectangular;
//   K5  interact_pallas.py:40  make_interact_pallas (pallas_call :160), the
//       wake and K4's Jacobi sphere contact in one square pass: seven sums.
// Launchers: downwash_pairs (K2), interact_pairs (K5). K4 stays in
// pair_kernels.cu, built with -fmad=false so that it equals its plain version
// bit for bit; this source contracts multiply-adds (ops/_build.py).
//
// Bound. A pass reads 3 (K2) or 6 (K5) float columns of Nt targets and Ns
// sources and writes 1 or 7 columns: tens of bytes a drone against 24
// operations a wake pair and 71 a fused pair (counted on the plain pair terms
// by chip_smoke.py) over Nt x Ns pairs. Two ceilings, both of operations: the
// float32 rate (67 TFLOP/s) and the special-function unit, 16 MUFU ops a
// clock an SM (132 x 16 x 1.98 GHz = 4.18e12 a second), of which a wake pair
// takes two (rcp and ex2). On the card the issue rate binds first: 4 warp
// instructions a clock an SM, so every instruction a pair counts.
//
// Design.
// * Work units. Target block b (256 targets) meets the source tiles (256
//   sources each) in units of `per_unit` consecutive tiles; the host lists the
//   units (ops/_pairs.pair_units) from the shapes alone, at most 32 a block,
//   each with its block, its first tile, its slot (its rank in the block) and
//   the block's unit count. Where the square wake cull holds (K2 on a fleet
//   sorted by z), block b's live tiles start at its diagonal, so the list
//   holds only units of live tiles. Elsewhere every unit is listed and one
//   whose tiles are all culled by the data exits at once. A unit is one small
//   block (128 threads), so thousands of them fill several waves and the
//   scheduler refills an SM as soon as a unit ends: culled work no longer
//   leaves SMs idle while others hold long chunks of live tiles.
// * The sum across units, in the same launch. A unit that evaluated a tile
//   writes its partial sums to scratch row `slot`; then, after a fence, one
//   64-bit atomic per unit adds 1 to the block's count (high word) and its
//   slot's bit to the block's mask of units that wrote (low word). The unit
//   that brings the count to the block's unit count adds the written rows in
//   slot order and writes the outputs. The launcher zeroes the words before
//   the kernel (one memset on the same stream), so no pass depends on how
//   the one before it ended. No float atomics: the order of every float32 sum is fixed by the
//   shapes (slots, then tiles, then sources in ascending order), so two passes
//   agree bit for bit, on any card.
// * Fewer instructions a pair. Each thread owns two targets (t and t + 128)
//   in registers, so one 16-byte shared load of a source (x, y, z packed in a
//   float4) serves two pairs, and the two pairs' reciprocal and exponent are
//   independent MUFU chains. The pair terms are pair_terms.cuh's wake_mag
//   (ex2.approx.ftz carrying the factor K, rcp.approx.ftz with no Newton
//   step and no clamp, the only guard the beta = 0 one that the plain version
//   has too) and contact_add, shared with K3, K4 and K6: dz <= 0 and the
//   cutoff predicate the accumulating add (a non-finite term there is never
//   added). Predicates are combined bitwise,
//   so the pair loop has no branch but K5's vote.
// * Contact skipped by warp vote (K5). The contact distance d2 is formed from
//   the wake's dx^2 + dy^2 and dz^2, rounded as the plain contact term rounds
//   it; the contact arithmetic of a source runs only when some lane of the
//   warp has a partner in it with eps^2 < d2 < min_dist^2 (__any_sync). A
//   skipped term is exactly zero (overlap 0, so push 0; appr 0), so the sums
//   are unchanged up to the sign of a zero. What only that branch touches
//   stays out of the registers, which the wake needs (64 a thread, 8 units an
//   SM): the branch forms d2 again, the six contact sums of a target live in
//   this thread's own slots of shared memory, and the targets' velocities are
//   read from the cache. (One vote for four sources, tried, was 0-6 % slower:
//   a taken branch then redoes four sources.)
//
// Rounding. beta = c2 dz + c3, dxy^2 and d2 are rounded step by step, as in
// the plain versions (pair_terms.cuh), so every pair lands on the same side
// of the jumps at float32 beta = 0, at the 10 m cutoff and at the contact
// radius. The rest is held to the plain versions at the pair tolerances.
//
// Culls (fleets sorted by z on both sides, `cull` = 1). A (block, tile) pair
// is skipped only where every pair in it is provably masked, the test uniform
// across the block and read from the real first and last element of a ragged
// tile or block:
//   wake, square:      skip when the tile's last source index <= the block's
//                      first target index (then dz <= 0 everywhere);
//   wake, rectangular: skip unless the tile's max z > the block's min z;
//   contact (K5):      skip when the z intervals are more than min_dist apart.
// An optional counter (`tiles`, null on the main path) receives the (block,
// tile) pairs each section evaluated: tiles[0] the wake, tiles[1] the contact.
//
// Layout. `tgt` is (rows, Nt) float32 and `src` is (rows, Ns): x, y, z and,
// for K5, vx, vy, vz. `out` is (outputs, Nt): the wake first, then dpx, dpy,
// dpz, dvx, dvy, dvz. `units` is (n_units, 4) int32, `scratch` (rows,
// outputs, Nt) float32, `sync` one 64-bit word per target block, zeroed by
// the launcher.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

using namespace pair_terms;

constexpr int kTile = 256;              // targets a block, sources a tile
constexpr int kThreads = 128;           // threads a unit
constexpr int kPer = kTile / kThreads;  // targets a thread
constexpr int kMaxSlots = 32;           // units a block: one bit each of a mask word
constexpr int kMinUnitsPerSm = 8;       // resident units an SM: at most 64 registers a thread
constexpr unsigned kAll = 0xFFFFFFFFu;

// The contact terms of source j of the staged tile on this thread's two
// targets; d2 is formed again with the same roundings as in the vote (target
// minus source is the negated source minus target, exactly).
__device__ __forceinline__ void contact_terms(const float4* __restrict__ pos,
                                              const float4* __restrict__ vel, int j,
                                              const float (&tv)[kPer][3],
                                              const bool (&live)[kPer],
                                              const float* __restrict__ tvel, int nt,
                                              const PairConsts& c, float* acc) {
  const float4 p = pos[j], v = vel[j];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float dx = tv[k][0] - p.x, dy = tv[k][1] - p.y, dz = tv[k][2] - p.z;
    const float d2 = __fadd_rn(sq2(dx, dy), __fmul_rn(dz, dz));
    // A dead lane (no target) reads no velocity; its sums are never written.
    const float* tv3 = tvel + k * kThreads;
    const float vx = live[k] ? __ldg(tv3) : 0.0f;
    const float vy = live[k] ? __ldg(tv3 + nt) : 0.0f;
    const float vz = live[k] ? __ldg(tv3 + 2LL * nt) : 0.0f;
    contact_add<kPer * kThreads>(d2, touching(d2, c), dx, dy, dz, vx - v.x, vy - v.y, vz - v.z,
                                 c, acc + k * kThreads);
  }
}

// The terms of one staged tile (len sources) on this thread's two targets,
// in ascending source order. kWake, kContact: the sections this tile needs.
// The contact of a source runs only where some lane of the warp has a
// partner in it: contact pairs are rare (a few in a thousand on a cloud).
template <bool kWake, bool kContact>
__device__ __forceinline__ void tile_terms(const float4* __restrict__ pos,
                                           const float4* __restrict__ vel, int len,
                                           const float (&tv)[kPer][3], const bool (&live)[kPer],
                                           const float* __restrict__ tvel, int nt,
                                           const WakeConsts& w, float (&wake)[kPer],
                                           float* acc) {
  const auto source = [&](int j) {
    const float4 p = pos[j];
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float dx = p.x - tv[k][0], dy = p.y - tv[k][1], dz = p.z - tv[k][2];
      const float dxy2 = sq2(dx, dy);
      const float dz2 = __fmul_rn(dz, dz);
      if (kWake) {
        const float mag = wake_mag(dxy2, dz, dz2, w);
        if (wake_live(dxy2, dz)) wake[k] -= mag;
      }
      if (kContact) hit |= touching(__fadd_rn(dxy2, dz2), w.c);
    }
    if (kContact && __any_sync(kAll, hit)) contact_terms(pos, vel, j, tv, live, tvel, nt, w.c, acc);
  };
  // Four sources a step for the wake alone, two where K5's vote may branch
  // (64 registers a thread).
  if (kContact) {
#pragma unroll 2
    for (int j = 0; j < len; ++j) source(j);
  } else {
#pragma unroll 4
    for (int j = 0; j < len; ++j) source(j);
  }
}

// One work unit: target block units[u].x against tiles units[u].y, ... (at
// most per_unit of them). kContact: K5 (else K2); kCull the z-sorted culls,
// kSquare the wake's index cull over the rectangular (z) one.
template <bool kContact, bool kCull, bool kSquare>
__global__ void __launch_bounds__(kThreads, kMinUnitsPerSm)
wake_pair_kernel(const float* __restrict__ tgt, int nt, const float* __restrict__ src, int ns,
                 const int4* __restrict__ units, int per_unit, WakeConsts w,
                 float* __restrict__ scratch, unsigned long long* __restrict__ sync,
                 float* __restrict__ out, unsigned int* __restrict__ tiles) {
  constexpr int kOut = kContact ? 7 : 1;
  __shared__ float4 pos[kTile];
  __shared__ float4 vel[kContact ? kTile : 1];
  __shared__ unsigned long long seen;

  const int4 unit = units[blockIdx.x];
  const int block = unit.x, slot = unit.z, count = unit.w;
  const int t_first = block * kTile;
  const int t_last = min(t_first + kTile, nt) - 1;
  const int n_tiles = (ns + kTile - 1) / kTile;
  const int tile_end = min(unit.y + per_unit, n_tiles);
  const PairConsts& c = w.c;

  float tv[kPer][3];
  bool live[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = t_first + k * kThreads + threadIdx.x;
    live[k] = t < nt;
#pragma unroll
    for (int r = 0; r < 3; ++r) tv[k][r] = live[k] ? tgt[(long long)r * nt + t] : 0.0f;
  }
  // K5: this thread's first target's vx (vy, vz a row of nt further on).
  const float* tvel = kContact ? tgt + 3LL * nt + t_first + threadIdx.x : tgt;
  // The block's z range: its real first and last target (sorted by z).
  const float zt_first = kCull ? tgt[2LL * nt + t_first] : 0.0f;
  const float zt_last = kCull ? tgt[2LL * nt + t_last] : 0.0f;

  float wake[kPer] = {0.0f, 0.0f};
  // K5's contact sums, which change only where a warp's vote passes: kept in
  // this thread's own slots of shared memory (output o of target k at
  // acc[(o * kPer + k) * kThreads]) rather than in twelve registers.
  __shared__ float contact[kContact ? 6 * kPer * kThreads : 1];
  float* acc = contact + threadIdx.x;
  if (kContact) {
#pragma unroll
    for (int i = 0; i < 6 * kPer; ++i) acc[i * kThreads] = 0.0f;
  }
  unsigned int n_wake = 0, n_contact = 0;
  for (int tile = unit.y; tile < tile_end; ++tile) {
    const int s0 = tile * kTile;
    const int len = min(kTile, ns - s0);
    bool do_wake = true, do_contact = kContact;
    if (kCull) {
      const float zs_first = src[2LL * ns + s0], zs_last = src[2LL * ns + s0 + len - 1];
      do_wake = kSquare ? (s0 + len - 1 > t_first) : (zs_last > zt_first);
      if (kContact) {
        do_contact = (zs_last >= zt_first - c.min_dist) && (zs_first <= zt_last + c.min_dist);
      }
    }
    n_wake += do_wake ? 1u : 0u;
    n_contact += do_contact ? 1u : 0u;
    if (!(do_wake || do_contact)) continue;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const long long at = s0 + i;
      pos[i] = make_float4(src[at], src[ns + at], src[2LL * ns + at], 0.0f);
      if (kContact && do_contact) {
        vel[i] = make_float4(src[3LL * ns + at], src[4LL * ns + at], src[5LL * ns + at], 0.0f);
      }
    }
    __syncthreads();
    if (kContact && do_wake && do_contact) {
      tile_terms<true, true>(pos, vel, len, tv, live, tvel, nt, w, wake, acc);
    } else if (do_wake) {
      tile_terms<true, false>(pos, vel, len, tv, live, tvel, nt, w, wake, acc);
    } else if (kContact) {
      tile_terms<false, true>(pos, vel, len, tv, live, tvel, nt, w, wake, acc);
    }
  }

  if (tiles != nullptr && threadIdx.x == 0) {
    atomicAdd(&tiles[0], n_wake);
    if (kContact) atomicAdd(&tiles[1], n_contact);
  }
  // This unit's partial sums, if it evaluated any tile, to row `slot`.
  const bool wrote = n_wake + n_contact > 0;
  if (wrote) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!live[k]) continue;
      float* row = scratch + (long long)slot * kOut * nt + t_first + k * kThreads + threadIdx.x;
      row[0] = wake[k];
      if (kContact) {
#pragma unroll
        for (int o = 0; o < 6; ++o) {
          row[(long long)(o + 1) * nt] = acc[(o * kPer + k) * kThreads];
        }
      }
    }
  }
  __threadfence();  // the partials are visible to every SM before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long add = (1ULL << 32) | (wrote ? (1ULL << slot) : 0ULL);
    seen = atomicAdd(&sync[block], add);
  }
  __syncthreads();
  const unsigned long long before = seen;
  if ((int)(before >> 32) != count - 1) return;

  // The block's last unit: add the rows that were written, in slot order.
  __threadfence();
  const unsigned int mask = (unsigned int)before | (wrote ? (1u << slot) : 0u);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!live[k]) continue;
    const long long t = t_first + k * kThreads + threadIdx.x;
    for (int o = 0; o < kOut; ++o) {
      float s = 0.0f;
      for (int q = 0; q < count; ++q) {
        if ((mask >> q) & 1u) s += __ldcg(scratch + ((long long)q * kOut + o) * nt + t);
      }
      out[(long long)o * nt + t] = s;
    }
  }
}

template <bool kContact, bool kCull, bool kSquare>
cudaError_t run(unsigned int n_units, cudaStream_t st, const float* tgt, int nt, const float* src,
                int ns, const int4* units, int per_unit, const WakeConsts& w, float* scratch,
                unsigned long long* sync, float* out, unsigned int* tiles) {
  wake_pair_kernel<kContact, kCull, kSquare><<<n_units, kThreads, 0, st>>>(
      tgt, nt, src, ns, units, per_unit, w, scratch, sync, out, tiles);
  return cudaGetLastError();
}

template <bool kContact>
int launch(const void* tgt, int nt, const void* src, int ns, int cull, int square,
           const void* consts, int n_consts, const void* units, int n_units, int per_unit,
           int rows, void* scratch, void* sync, void* out, void* tiles, void* stream) {
  const int blocks = (nt + kTile - 1) / kTile;
  if (n_consts != kNumConsts || nt < 0 || ns < 0 || per_unit < 1 || rows < 1 ||
      rows > kMaxSlots || n_units < blocks || units == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (nt == 0) return (int)cudaSuccess;
  WakeConsts w;
  if (!wake_consts(consts, &w)) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  // The units' counts start from zero in every pass.
  const cudaError_t zeroed = cudaMemsetAsync(sync, 0, sizeof(unsigned long long) * blocks, st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  const auto n = (unsigned int)n_units;
  const auto* t = (const float*)tgt;
  const auto* s = (const float*)src;
  const auto* u = (const int4*)units;
  auto* sc = (float*)scratch;
  auto* sy = (unsigned long long*)sync;
  auto* o = (float*)out;
  auto* ti = (unsigned int*)tiles;
  if (!cull) return (int)run<kContact, false, false>(n, st, t, nt, s, ns, u, per_unit, w, sc, sy, o, ti);
  if (square) return (int)run<kContact, true, true>(n, st, t, nt, s, ns, u, per_unit, w, sc, sy, o, ti);
  if constexpr (!kContact) {  // the rectangular cull: K2 only
    return (int)run<false, true, false>(n, st, t, nt, s, ns, u, per_unit, w, sc, sy, o, ti);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define UNIT_ARGS                                                                            \
  const void *tgt, int nt, const void *src, int ns, int cull, int square, const void *consts, \
      int n_consts, const void *units, int n_units, int per_unit, int rows, void *scratch,    \
      void *sync, void *out, void *tiles, void *stream
#define UNIT_PASS                                                                         \
  tgt, nt, src, ns, cull, square, consts, n_consts, units, n_units, per_unit, rows, scratch, \
      sync, out, tiles, stream

// K2: out (1, Nt) = the wake sum per target.
extern "C" int downwash_pairs(UNIT_ARGS) { return launch<false>(UNIT_PASS); }

// K5: out (7, Nt) = the wake, then pushout and velocity correction (square).
extern "C" int interact_pairs(UNIT_ARGS) {
  if (!square || nt != ns) return (int)cudaErrorInvalidValue;
  return launch<true>(UNIT_PASS);
}

// Units of K2 (contact 0) or K5 (contact 1), in the z-sorted square form,
// that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int wake_blocks_per_sm(int contact, int* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  const void* fn = contact ? (const void*)wake_pair_kernel<true, true, true>
                           : (const void*)wake_pair_kernel<false, true, true>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0);
}
