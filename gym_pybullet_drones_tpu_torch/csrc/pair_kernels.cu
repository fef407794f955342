// K2, K4, K5: the coupled swarm's all-pairs passes, one thread per target.
//
// Replaces three TPU kernels of gym_pybullet_drones_tpu/ops/:
//   K2  downwash_pallas.py:33  make_downwash_pallas (pallas_call :140), the
//       wake sum  -sum K/dz^2 exp(-dxy^2 / (2 beta^2))  over sources above;
//   K4  collide_pallas.py:27   make_collide_pallas  (pallas_call :145), the
//       Jacobi sphere contact: pushout and velocity correction per target;
//   K5  interact_pallas.py:40  make_interact_pallas (pallas_call :160), K2
//       and K4 in one square pass.
// Launchers: downwash_pairs (K2), collide_pairs (K4), interact_pairs (K5).
// K2 and K4 take a square form (sources = targets) and a rectangular one;
// K5 is square only. The pair arithmetic lives in two device functions,
// wake_term and contact_term (pair_terms.cuh, shared with the masked passes
// K3 and K6), so K5 is K2 plus K4 by construction.
//
// Bound. A pass reads 3 (wake) or 6 (contact) float columns of N targets and
// N sources and writes 1, 6 or 7 columns: about 24 N bytes in, against
// 24 operations per wake pair, 47 per contact pair and 71 per fused pair
// (counted on the plain versions' pair terms by chip_smoke.py), over N^2
// pairs. At the swarm's sizes (N >= 4096) that is thousands of operations
// per byte: the passes are bound by operations, never by bytes.
//
// Design. Each thread owns one target and keeps its coordinates and its
// accumulators in registers. A block of 256 targets walks the sources in
// tiles of 256, staged through shared memory with coalesced loads; every
// thread then reads the same shared value (a broadcast) and walks the tile
// in ascending index. Few targets (16 blocks at N = 4096) cannot fill 132
// SMs, so the grid's second dimension splits the source tiles into S
// chunks; each (block, chunk) writes its partial sums to a (S, outputs, Nt)
// scratch, and a second small launch adds the S partials in a fixed order.
// Results are the same from run to run, with no atomics. The pair math is
// branch-free (compute, then select), so the warps never diverge.
//
// Culls (fleets sorted by z on both sides, `cull` = 1). A (block, tile) pair
// is skipped only where every pair in it is provably masked, and the test is
// uniform across the block. It reads the real first and last element of a
// ragged tile or block, never padding:
//   wake, square:      skip when the tile's last source index <= the block's
//                      first target index (then dz <= 0 everywhere);
//   wake, rectangular: skip unless the tile's max z > the block's min z;
//   contact:           skip when the z intervals are more than min_dist
//                      apart.
// An optional counter (`tiles`, null on the main path) receives the number
// of (block, tile) pairs each section evaluated, so the culls can be seen to
// fire.
//
// Math. expf, rsqrtf (the TPU kernels use lax.rsqrt), true division,
// fmaxf/fminf, float literals only. Built without --use_fast_math and with
// -fmad=false (ops/_build.py). The host forms K, min_dist, min_dist^2 and
// eps^2 in double, as the JAX package's Python floats are, and rounds each
// once to float.
//
// Layout. `tgt` is (rows, Nt) float32 and `src` is (rows, Ns): x, y, z and,
// for contact, vx, vy, vz. `out` is (outputs, Nt): the wake first, then
// dpx, dpy, dpz, dvx, dvy, dvz. Thread t reads row r of its target at
// tgt[r * Nt + t].
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <string.h>

#include "pair_terms.cuh"

namespace {

using namespace pair_terms;

constexpr int kBlock = 256;  // targets per block, and sources per shared tile

// One (target block, source chunk) of a pass. kWake and kContact pick the
// sections (K2: wake; K4: contact; K5: both), kCull the z-sorted culls and
// kSquare the wake's square (index) cull over the rectangular (z) one.
template <bool kWake, bool kContact, bool kCull, bool kSquare>
__global__ void __launch_bounds__(kBlock)
pair_kernel(const float* __restrict__ tgt, int nt, const float* __restrict__ src, int ns,
            int tiles_per_chunk, PairConsts c, float* __restrict__ partial,
            unsigned int* __restrict__ tiles) {
  constexpr int kRows = kContact ? 6 : 3;
  constexpr int kOut = (kWake ? 1 : 0) + (kContact ? 6 : 0);
  __shared__ float sh[kRows][kBlock];

  const int t_first = blockIdx.x * kBlock;
  const int t = t_first + threadIdx.x;
  const bool live = t < nt;
  float tv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) tv[r] = live ? tgt[(long long)r * nt + t] : 0.0f;
  // The block's z range: its real first and last target (sorted by z).
  const int t_last = min(t_first + kBlock, nt) - 1;
  const float zt_first = tgt[2LL * nt + t_first];
  const float zt_last = tgt[2LL * nt + t_last];

  float wake = 0.0f;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  unsigned int n_wake = 0, n_contact = 0;
  const int n_tiles = (ns + kBlock - 1) / kBlock;
  const int tile_begin = blockIdx.y * tiles_per_chunk;
  const int tile_end = min(tile_begin + tiles_per_chunk, n_tiles);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int s0 = tile * kBlock;
    const int len = min(kBlock, ns - s0);
    __syncthreads();  // every thread is done with the previous tile
    if (threadIdx.x < len) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) sh[r][threadIdx.x] = src[(long long)r * ns + s0 + threadIdx.x];
    }
    __syncthreads();
    bool do_wake = kWake, do_contact = kContact;
    if (kCull) {
      const float zs_first = sh[2][0], zs_last = sh[2][len - 1];
      if (kWake) do_wake = kSquare ? (s0 + len - 1 > t_first) : (zs_last > zt_first);
      if (kContact) {
        do_contact = (zs_last >= zt_first - c.min_dist) && (zs_first <= zt_last + c.min_dist);
      }
    }
    n_wake += do_wake ? 1u : 0u;
    n_contact += do_contact ? 1u : 0u;
    if (!live || !(do_wake || do_contact)) continue;
    for (int j = 0; j < len; ++j) {
      if (kWake && do_wake) {
        wake -= wake_term(sh[0][j] - tv[0], sh[1][j] - tv[1], sh[2][j] - tv[2], c);
      }
      if (kContact && do_contact) {
        contact_term(tv[0] - sh[0][j], tv[1] - sh[1][j], tv[2] - sh[2][j], tv[3] - sh[3][j],
                     tv[4] - sh[4][j], tv[5] - sh[5][j], c, acc);
      }
    }
  }

  if (tiles != nullptr && threadIdx.x == 0) {
    if (kWake) atomicAdd(&tiles[0], n_wake);
    if (kContact) atomicAdd(&tiles[1], n_contact);
  }
  if (!live) return;
  float* out = partial + (long long)blockIdx.y * kOut * nt + t;
  int o = 0;
  if (kWake) out[(long long)(o++) * nt] = wake;
  if (kContact) {
#pragma unroll
    for (int k = 0; k < 6; ++k) out[(long long)(o++) * nt] = acc[k];
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... + partial[S-1][i], in order.
__global__ void __launch_bounds__(kBlock)
reduce_kernel(const float* __restrict__ partial, int split, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int k = 1; k < split; ++k) s += partial[k * n + i];
  out[i] = s;
}

template <bool kWake, bool kContact>
int launch(const void* tgt, int nt, const void* src, int ns, int cull, int square,
           const void* consts, int n_consts, int split, int tiles_per_chunk, void* partial,
           void* out, void* tiles, void* stream) {
  const int n_tiles = (ns + kBlock - 1) / kBlock;
  if (n_consts != kNumConsts || nt < 0 || ns < 0 || split < 1 || tiles_per_chunk < 1 ||
      split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (nt == 0) return (int)cudaSuccess;
  // Every chunk holds at least one tile and the chunks cover every tile.
  if (ns > 0 && ((long long)split * tiles_per_chunk < n_tiles ||
                 (long long)(split - 1) * tiles_per_chunk >= n_tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kOut = (kWake ? 1 : 0) + (kContact ? 6 : 0);
  PairConsts c;
  memcpy(&c, consts, sizeof(PairConsts));
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned int)((nt + kBlock - 1) / kBlock), (unsigned int)split);
  float* dst = split > 1 ? (float*)partial : (float*)out;
  const float* t = (const float*)tgt;
  const float* s = (const float*)src;
  unsigned int* counter = (unsigned int*)tiles;
  if (cull && square) {
    pair_kernel<kWake, kContact, true, true><<<grid, kBlock, 0, st>>>(
        t, nt, s, ns, tiles_per_chunk, c, dst, counter);
  } else if (cull) {
    pair_kernel<kWake, kContact, true, false><<<grid, kBlock, 0, st>>>(
        t, nt, s, ns, tiles_per_chunk, c, dst, counter);
  } else {
    pair_kernel<kWake, kContact, false, false><<<grid, kBlock, 0, st>>>(
        t, nt, s, ns, tiles_per_chunk, c, dst, counter);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long n = (long long)kOut * nt;
  reduce_kernel<<<(unsigned int)((n + kBlock - 1) / kBlock), kBlock, 0, st>>>(
      (const float*)partial, split, n, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIR_ARGS                                                                            \
  const void *tgt, int nt, const void *src, int ns, int cull, int square, const void *consts, \
      int n_consts, int split, int tiles_per_chunk, void *partial, void *out, void *tiles,     \
      void *stream
#define PAIR_PASS                                                                         \
  tgt, nt, src, ns, cull, square, consts, n_consts, split, tiles_per_chunk, partial, out, \
      tiles, stream

// K2: out (1, Nt) = the wake sum per target.
extern "C" int downwash_pairs(PAIR_ARGS) { return launch<true, false>(PAIR_PASS); }

// K4: out (6, Nt) = pushout and velocity correction per target.
extern "C" int collide_pairs(PAIR_ARGS) { return launch<false, true>(PAIR_PASS); }

// K5: out (7, Nt) = the wake, then pushout and velocity correction (square).
extern "C" int interact_pairs(PAIR_ARGS) {
  if (!square || nt != ns) return (int)cudaErrorInvalidValue;
  return launch<true, true>(PAIR_PASS);
}
