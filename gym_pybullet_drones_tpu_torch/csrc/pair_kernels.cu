// K4: the coupled swarm's all-pairs contact pass, one thread per target.
//
// Replaces the TPU kernel gym_pybullet_drones_tpu/ops/collide_pallas.py:27
// make_collide_pallas (pallas_call :145): the Jacobi sphere contact, pushout
// and velocity correction per target. Launcher: collide_pairs, square form
// (sources = targets) or rectangular. The pair arithmetic is contact_term
// (pair_terms.cuh, shared with K2, K3, K5 and K6). The wake passes K2 and K5
// live in wake_pair_kernels.cu.
//
// Bound. A pass reads 6 float columns of Nt targets and Ns sources and
// writes 6: about 24 N bytes in, against 47 operations per contact pair
// (counted on the plain version's pair term by chip_smoke.py) over Nt x Ns
// pairs. At the swarm's sizes (N >= 4096) that is thousands of operations
// per byte: the pass is bound by operations, never by bytes.
//
// Design. Each thread owns one target and keeps its coordinates and its
// accumulators in registers. A block of 256 targets walks the sources in
// tiles of 256, staged through shared memory with coalesced loads; every
// thread then reads the same shared value (a broadcast) and walks the tile
// in ascending index. Few targets (16 blocks at N = 4096) cannot fill 132
// SMs, so the grid's second dimension splits the source tiles into S
// chunks (ops/_pairs.source_split, a rule of the shapes alone); each (block,
// chunk) writes its partial sums to a (S, 6, Nt) scratch, and a second small
// launch adds the S partials in a fixed order. Results are the same from run
// to run, with no atomics. The pair math is branch-free (compute, then
// select), so the warps never diverge.
//
// Cull (fleets sorted by z on both sides, `cull` = 1). A (block, tile) pair
// is skipped when the z intervals of the block and the tile, read from their
// real first and last elements, are more than min_dist apart. An optional
// counter (`tiles`, null on the main path) receives in tiles[1] the (block,
// tile) pairs evaluated, so the cull can be seen to fire.
//
// Math. rsqrtf (the TPU kernel uses lax.rsqrt), fmaxf/fminf, float literals
// only. Built without --use_fast_math and with -fmad=false (ops/_build.py),
// so the pass equals its plain version bit for bit on fleets where no target
// has two partners. The host forms min_dist, min_dist^2 and eps^2 in double,
// as the JAX package's Python floats are, and rounds each once to float.
//
// Layout. `tgt` is (6, Nt) float32 and `src` is (6, Ns): x, y, z, vx, vy,
// vz. `out` is (6, Nt): dpx, dpy, dpz, dvx, dvy, dvz. Thread t reads row r
// of its target at tgt[r * Nt + t].
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <string.h>

#include "pair_terms.cuh"

namespace {

using namespace pair_terms;

constexpr int kBlock = 256;  // targets per block, and sources per shared tile

// One (target block, source chunk) of a pass; kCull the z-sorted cull.
template <bool kCull>
__global__ void __launch_bounds__(kBlock)
collide_kernel(const float* __restrict__ tgt, int nt, const float* __restrict__ src, int ns,
               int tiles_per_chunk, PairConsts c, float* __restrict__ partial,
               unsigned int* __restrict__ tiles) {
  constexpr int kRows = 6;
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

  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  unsigned int n_contact = 0;
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
    bool do_contact = true;
    if (kCull) {
      const float zs_first = sh[2][0], zs_last = sh[2][len - 1];
      do_contact = (zs_last >= zt_first - c.min_dist) && (zs_first <= zt_last + c.min_dist);
    }
    n_contact += do_contact ? 1u : 0u;
    if (!live || !do_contact) continue;
    for (int j = 0; j < len; ++j) {
      contact_term(tv[0] - sh[0][j], tv[1] - sh[1][j], tv[2] - sh[2][j], tv[3] - sh[3][j],
                   tv[4] - sh[4][j], tv[5] - sh[5][j], c, acc);
    }
  }

  if (tiles != nullptr && threadIdx.x == 0) atomicAdd(&tiles[1], n_contact);
  if (!live) return;
  float* out = partial + (long long)blockIdx.y * 6 * nt + t;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[(long long)k * nt] = acc[k];
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

}  // namespace

// K4: out (6, Nt) = pushout and velocity correction per target.
extern "C" int collide_pairs(const void* tgt, int nt, const void* src, int ns, int cull,
                             const void* consts, int n_consts, int split, int tiles_per_chunk,
                             void* partial, void* out, void* tiles, void* stream) {
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
  PairConsts c;
  memcpy(&c, consts, sizeof(PairConsts));
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned int)((nt + kBlock - 1) / kBlock), (unsigned int)split);
  float* dst = split > 1 ? (float*)partial : (float*)out;
  const float* t = (const float*)tgt;
  const float* s = (const float*)src;
  unsigned int* counter = (unsigned int*)tiles;
  if (cull) {
    collide_kernel<true><<<grid, kBlock, 0, st>>>(t, nt, s, ns, tiles_per_chunk, c, dst, counter);
  } else {
    collide_kernel<false><<<grid, kBlock, 0, st>>>(t, nt, s, ns, tiles_per_chunk, c, dst, counter);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long n = 6LL * nt;
  reduce_kernel<<<(unsigned int)((n + kBlock - 1) / kBlock), kBlock, 0, st>>>(
      (const float*)partial, split, n, (float*)out);
  return (int)cudaGetLastError();
}
