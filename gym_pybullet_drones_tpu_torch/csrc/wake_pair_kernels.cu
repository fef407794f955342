// K2, K4, K5: the coupled swarm's all-pairs wake pass, contact pass and fused
// wake and contact pass, cut into work units of a few source tiles that the
// block scheduler spreads evenly over the SMs. One unit kernel, instantiated
// for the sections each pass needs.
//
// Replaces three TPU kernels of gym_pybullet_drones_tpu/ops/:
//   K2  downwash_pallas.py:33  make_downwash_pallas (pallas_call :140), the
//       wake sum  -sum K/dz^2 exp(-dxy^2 / (2 beta^2))  over sources above,
//       square (sources = targets) or rectangular;
//   K4  collide_pallas.py:27  make_collide_pallas (pallas_call :145), the
//       Jacobi sphere contact: pushout and velocity correction per target,
//       square or rectangular;
//   K5  interact_pallas.py:40  make_interact_pallas (pallas_call :160), the
//       wake and K4's contact in one square pass: seven sums.
// Launchers: downwash_pairs (K2), collide_pairs (K4), interact_pairs (K5).
// This source contracts multiply-adds (ops/_build.py); the contact term
// rounds every step itself (pair_terms.cuh), so K4 equals its plain version
// bit for bit wherever no target has two partners.
//
// Bound. A pass reads 3 (K2) or 6 (K4, K5) float columns of Nt targets and
// Ns sources and writes 1, 6 or 7 columns: tens of bytes a drone against 24
// operations a wake pair, 47 a contact pair and 71 a fused pair (counted on
// the plain pair terms by chip_smoke.py) over Nt x Ns pairs, of which only the
// gates are needed where the gates fail. Two ceilings, both of operations:
// the float32 rate (67 TFLOP/s) and the special-function unit, 16 MUFU ops a
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
//   whose tiles are all culled by the data exits at once (K4 on a fleet
//   sorted by z: most units, since only a band of tiles around the diagonal
//   holds partners). A unit is one small block (128 threads), so thousands
//   of them fill several waves and the scheduler refills an SM as soon as a
//   unit ends: culled work no longer leaves SMs idle while others hold long
//   chunks of live tiles.
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
//   step, no clamp and no guard) and contact_add, shared with K3 and K6:
//   dz <= 0, the cutoff and beta = 0 predicate the accumulating add (a
//   non-finite term there is never added). Predicates are combined bitwise,
//   so the pair loop has no branch but the contact vote.
// * Contact skipped by warp vote (K4, K5). The contact distance d2 is formed
//   from dx^2 + dy^2 and dz^2, rounded as the plain contact term rounds
//   it; the contact arithmetic of a source runs only when some lane of the
//   warp has a partner in it with eps^2 < d2 < min_dist^2 (__any_sync). A
//   skipped term is exactly zero (overlap 0, so push 0; appr 0), so the sums
//   are unchanged up to the sign of a zero. On the swarm's fleets about one
//   pair in 250,000 touches, so K4's loop is the gate alone: the squares, d2
//   and two compares, with one vote for four sources (a vote that passes
//   runs the four sources' contact terms in order, adding zeros for those
//   out of touch). K5 votes once a source: one vote for four, tried there,
//   was 0-6 % slower, since its taken branch redoes four sources. What only
//   that branch touches stays out of the registers, which the wake needs (64
//   a thread, 8 units an SM): the branch forms d2 again, the six contact sums
//   of a target live in this thread's own slots of shared memory, and the
//   targets' velocities are read from the cache.
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
//   contact (K4, K5):  skip when the z intervals are more than min_dist apart
//                      (K4: square or rectangular).
// An optional counter (`tiles`, null on the main path) receives the (block,
// tile) pairs each section evaluated: tiles[0] the wake, tiles[1] the contact.
//
// Layout. `tgt` is (rows, Nt) float32 and `src` is (rows, Ns): x, y, z and,
// for K4 and K5, vx, vy, vz. `out` is (outputs, Nt): the wake first (K2, K5),
// then dpx, dpy, dpz, dvx, dvy, dvz (K4, K5). `units` is (n_units, 4) int32,
// `scratch` (rows, outputs, Nt) float32, `sync` one 64-bit word per target
// block, zeroed by the launcher.
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
constexpr int kVote = 4;                // K4: sources a contact vote covers
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
  // The wake of source j on this thread's targets (where kWake) and whether
  // one of them touches it (where kContact).
  const auto gate = [&](int j) {
    const float4 p = pos[j];
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float dx = p.x - tv[k][0], dy = p.y - tv[k][1], dz = p.z - tv[k][2];
      const float dxy2 = sq2(dx, dy);
      const float dz2 = __fmul_rn(dz, dz);
      if (kWake) {
        const float beta = wake_beta(dz, w);
        const float mag = wake_mag(dxy2, dz2, beta, w);
        if (wake_live(dxy2, dz, beta)) wake[k] -= mag;
      }
      if (kContact) hit |= touching(__fadd_rn(dxy2, dz2), w.c);
    }
    return hit;
  };
  const auto contact = [&](int j) { contact_terms(pos, vel, j, tv, live, tvel, nt, w.c, acc); };
  if constexpr (!kContact) {
#pragma unroll 4
    for (int j = 0; j < len; ++j) gate(j);
  } else if constexpr (kWake) {
    // K5: one vote a source, two sources a step (64 registers a thread).
#pragma unroll 2
    for (int j = 0; j < len; ++j) {
      if (__any_sync(kAll, gate(j))) contact(j);
    }
  } else {
    // K4: the gate alone, one vote for four sources. Where it passes, the
    // four run their contact terms in order; those out of touch add zeros.
    int j = 0;
    for (; j + kVote <= len; j += kVote) {
      bool hit = false;
#pragma unroll
      for (int u = 0; u < kVote; ++u) hit |= gate(j + u);
      if (__any_sync(kAll, hit)) {
        for (int u = 0; u < kVote; ++u) contact(j + u);
      }
    }
    for (; j < len; ++j) {
      if (__any_sync(kAll, gate(j))) contact(j);
    }
  }
}

// One work unit: target block units[u].x against tiles units[u].y, ... (at
// most per_unit of them). kWake, kContact: the sections of the pass (K2 the
// wake, K4 the contact, K5 both); kCull the z-sorted culls, kSquare the
// wake's index cull over the rectangular (z) one.
template <bool kWake, bool kContact, bool kCull, bool kSquare>
__global__ void __launch_bounds__(kThreads, kMinUnitsPerSm)
pair_unit_kernel(const float* __restrict__ tgt, int nt, const float* __restrict__ src, int ns,
                 const int4* __restrict__ units, int per_unit, WakeConsts w,
                 float* __restrict__ scratch, unsigned long long* __restrict__ sync,
                 float* __restrict__ out, unsigned int* __restrict__ tiles) {
  constexpr int kFirst = kWake ? 1 : 0;  // the first contact output
  constexpr int kOut = kFirst + (kContact ? 6 : 0);
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
  // K4, K5: this thread's first target's vx (vy, vz a row of nt further on).
  const float* tvel = kContact ? tgt + 3LL * nt + t_first + threadIdx.x : tgt;
  // The block's z range: its real first and last target (sorted by z).
  const float zt_first = kCull ? tgt[2LL * nt + t_first] : 0.0f;
  const float zt_last = kCull ? tgt[2LL * nt + t_last] : 0.0f;

  float wake[kPer] = {0.0f, 0.0f};
  // The contact sums, which change only where a warp's vote passes: kept in
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
    bool do_wake = kWake, do_contact = kContact;
    if (kCull) {
      const float zs_first = src[2LL * ns + s0], zs_last = src[2LL * ns + s0 + len - 1];
      if (kWake) do_wake = kSquare ? (s0 + len - 1 > t_first) : (zs_last > zt_first);
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
    if (kWake && kContact && do_wake && do_contact) {
      tile_terms<true, true>(pos, vel, len, tv, live, tvel, nt, w, wake, acc);
    } else if (kWake && do_wake) {
      tile_terms<true, false>(pos, vel, len, tv, live, tvel, nt, w, wake, acc);
    } else if (kContact) {
      tile_terms<false, true>(pos, vel, len, tv, live, tvel, nt, w, wake, acc);
    }
  }

  if (tiles != nullptr && threadIdx.x == 0) {
    if (kWake) atomicAdd(&tiles[0], n_wake);
    if (kContact) atomicAdd(&tiles[1], n_contact);
  }
  // This unit's partial sums, if it evaluated any tile, to row `slot`.
  const bool wrote = n_wake + n_contact > 0;
  if (wrote) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!live[k]) continue;
      float* row = scratch + (long long)slot * kOut * nt + t_first + k * kThreads + threadIdx.x;
      if (kWake) row[0] = wake[k];
      if (kContact) {
#pragma unroll
        for (int o = 0; o < 6; ++o) {
          row[(long long)(o + kFirst) * nt] = acc[(o * kPer + k) * kThreads];
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
  if constexpr (kOut == 1) {
    // K2: one sum a target, whose loads the compiler pipelines.
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!live[k]) continue;
      const long long t = t_first + k * kThreads + threadIdx.x;
      float s = 0.0f;
      for (int q = 0; q < count; ++q) {
        if ((mask >> q) & 1u) s += __ldcg(scratch + (long long)q * nt + t);
      }
      out[t] = s;
    }
  } else {
    // K4, K5: every output of both targets at once, a slot at a time, so
    // that 12 or 14 loads are in flight together (K5 at N = 4096: 0.045 ->
    // 0.035 ms a pass on the H100).
    float sum[kPer][kOut];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) sum[k][o] = 0.0f;
    }
    for (int q = 0; q < count; ++q) {
      if (!((mask >> q) & 1u)) continue;
      const float* row = scratch + (long long)q * kOut * nt + t_first + threadIdx.x;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (!live[k]) continue;
#pragma unroll
        for (int o = 0; o < kOut; ++o) sum[k][o] += __ldcg(row + (long long)o * nt + k * kThreads);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!live[k]) continue;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        out[(long long)o * nt + t_first + k * kThreads + threadIdx.x] = sum[k][o];
      }
    }
  }
}

template <bool kWake, bool kContact, bool kCull, bool kSquare>
cudaError_t run(unsigned int n_units, cudaStream_t st, const float* tgt, int nt, const float* src,
                int ns, const int4* units, int per_unit, const WakeConsts& w, float* scratch,
                unsigned long long* sync, float* out, unsigned int* tiles) {
  pair_unit_kernel<kWake, kContact, kCull, kSquare><<<n_units, kThreads, 0, st>>>(
      tgt, nt, src, ns, units, per_unit, w, scratch, sync, out, tiles);
  return cudaGetLastError();
}

template <bool kWake, bool kContact>
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
  if (!cull) {
    return (int)run<kWake, kContact, false, false>(n, st, t, nt, s, ns, u, per_unit, w, sc, sy, o,
                                                   ti);
  }
  if constexpr (kWake) {  // the wake's index cull where sources = targets
    if (square) {
      return (int)run<kWake, kContact, true, true>(n, st, t, nt, s, ns, u, per_unit, w, sc, sy, o,
                                                   ti);
    }
  }
  if constexpr (!(kWake && kContact)) {  // the z cull alone: K2 rectangular, K4 either form
    return (int)run<kWake, kContact, true, false>(n, st, t, nt, s, ns, u, per_unit, w, sc, sy, o,
                                                  ti);
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
extern "C" int downwash_pairs(UNIT_ARGS) { return launch<true, false>(UNIT_PASS); }

// K4: out (6, Nt) = pushout and velocity correction per target; `square` is
// not read (the contact cull reads z alone, in either form).
extern "C" int collide_pairs(UNIT_ARGS) { return launch<false, true>(UNIT_PASS); }

// K5: out (7, Nt) = the wake, then pushout and velocity correction (square).
extern "C" int interact_pairs(UNIT_ARGS) {
  if (!square || nt != ns) return (int)cudaErrorInvalidValue;
  return launch<true, true>(UNIT_PASS);
}

// Units of K2 (wake 1, contact 0), K4 (0, 1) or K5 (1, 1), in the z-sorted
// form, that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int unit_blocks_per_sm(int wake, int contact, int* blocks) {
  if (blocks == nullptr || !(wake || contact)) return (int)cudaErrorInvalidValue;
  const void* fn = !contact ? (const void*)pair_unit_kernel<true, false, true, true>
                   : !wake  ? (const void*)pair_unit_kernel<false, true, true, false>
                            : (const void*)pair_unit_kernel<true, true, true, true>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0);
}
