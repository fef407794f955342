// K3, K6: the coupled swarm's mask-gated pair passes, with the sources of a
// target split over S warps, padding targets skipped and the live sources
// staged asynchronously.
//
// Replaces two TPU kernels of gym_pybullet_drones_tpu/ops/:
//   K3  downwash_pallas.py:163  make_downwash_masked (pallas_call :304), the
//       wake sum of K2 on any permutation of the fleet, each (target tile,
//       source tile) gated by a packed live word and each sub-slice of the
//       source tile by one bit of it;
//   K6  interact_pallas.py:183  make_interact_masked (pallas_call :325), the
//       seven sums of K5 gated the same way, bits 0-7 of a word gating the
//       wake section and bits 8-15 the contact section of each sub-slice.
// Launchers: downwash_masked (K3), interact_masked (K6). Both take separate
// target and source columns and counts (the rectangular form); the square
// form passes the same pointer twice. The pair arithmetic is wake_term and
// contact_term of pair_terms.cuh, shared with K2, K4 and K5; this source is
// built with FMA contraction on (ops/_build.py).
//
// The words (ops/spatial.py). The fleet is cut into tiles of `bt` targets
// and `bs` sources, and a source tile into `sub_n` <= 8 sub-slices of
// sub_w = bs / sub_n sources. Two forms of the same gate:
//   dense:     words is (target tiles, source tiles); word (i, j) gates the
//              tile pair (i, j);
//   compacted: words is (target tiles, row_len); slot p of row i holds
//              `source tile << 16 | word` of the row's p-th live source tile
//              in ascending source order, and 0 marks the end of the list.
// The masks are exact (never drop a contributing pair), and padding slots of
// a binned layout are inert per pair (z = -1e9 fails dz > 0 and d2 < min_dist^2
// against any real drone), so the words only save work.
//
// Padding targets. `valid` (one byte per target, or null) marks the real
// slots of a binned layout. A padding target's outputs are exactly 0, and a
// block whose targets are all padding exits before it stages anything. The
// JAX package evaluates those rows (at most about 1e-17 N of wake and no
// contact against the z = -1e9 sentinels), so both agree on every row at the
// tests' tolerances.
//
// Bound. A pass reads 3 (K3) or 6 (K6) float columns of Nt targets and Ns
// sources and a few KB of words and writes 1 or 7 columns, against 24
// operations per wake pair and 71 per fused pair (counted on the plain pair
// terms by chip_smoke.py) over the pairs of real drones in the live
// sub-slices: thousands of operations per byte. The passes are bound by
// operations, and on the card by the issue rate of the schedulers: a wake
// pair is one reciprocal, one exponent, the selects of the pair term and a
// shared load.
//
// Design. A block holds 32 consecutive targets of one target tile (a tile of
// bt targets is cut into ceil(bt / 32) blocks) and S warps, the source ranks:
// every warp holds the same 32 targets in registers, and rank r adds the
// sources whose position inside their sub-slice is r modulo S (S, a power of
// two up to 8, divides the sub-slice width). The block walks its tile's row
// of words in ascending position (32 words a load, the live ones found by a
// warp ballot) and cuts the live sub-slices into
// stages of at most C = 64 S sources: as many whole sub-slices of one word
// as fit, or one piece of C sources of a wider sub-slice. A stage is copied
// into shared memory with cp.async, a source's x, y, z into one float4 (one
// shared load a pair), while the previous stage is evaluated: two buffers,
// two barriers a stage, up to 64 pair terms per thread between them. For K6
// the velocities are copied only for the sub-slices whose contact bit is set.
// At the end the ranks' partial sums are added in rank order in shared
// memory and rank 0 writes the outputs.
//
// Summation order is a contract: the compacted pass equals the dense one
// bit for bit. Each rank adds its sources in ascending source order in both
// forms (the two walk the same live sub-slices in the same order, and a
// source's rank depends on its position in its sub-slice only), and the
// partials are combined in a fixed order. S depends on the shapes alone
// (ops/_pairs.masked_split), never on the card, so neither do the bits.
//
// Layout. `tgt` is (rows, Nt) float32 and `src` is (rows, Ns): x, y, z and,
// for K6, vx, vy, vz. `out` is (outputs, Nt): the wake first, then dpx, dpy,
// dpz, dvx, dvy, dvz.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; each launcher returns cudaGetLastError().

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

using namespace pair_terms;

constexpr int kWarp = 32;
constexpr int kPerRank = 64;  // stage capacity per source rank: C = kPerRank * S sources
constexpr unsigned kAll = 0xFFFFFFFFu;

// The tiling as the kernel reads it; the same in every thread.
struct Geo {
  int bs, sub_w, sub_n;
  int pl;      // sources per slot of a stage: min(sub_w, C)
  int pieces;  // slots a sub-slice takes: ceil(sub_w / C)
  int per;     // whole sub-slices a stage holds when pieces == 1: C / sub_w
};

// The walk over a row of words (the same in every thread of a block).
struct Walk {
  int p;          // position of the current word in the row
  unsigned w;     // the current word
  unsigned rest;  // its live sub-slices not yet staged in full, one bit each
  int piece;      // the next piece of the lowest sub-slice in rest
};

// One stage: sub-slices `mask` of source tile j (its word w), or piece
// `piece` of the one sub-slice in mask.
struct Stage {
  int j;
  unsigned w;
  unsigned mask;
  int piece;
};

__device__ __forceinline__ unsigned live_slices(unsigned w, bool contact, unsigned subs) {
  return (contact ? (w | (w >> 8)) : w) & subs;
}

__device__ __forceinline__ int nth_bit(unsigned m, int i) {
  for (; i > 0; --i) m &= m - 1u;
  return __ffs(m) - 1;
}

// The first position q >= p of the row whose word has a bit of `bits` set,
// its word in *w; row_len if there is none (a compacted row also ends at its
// first zero word). Every lane of the warp calls it with the same arguments.
__device__ __forceinline__ int next_live(const int* __restrict__ row, int p, int row_len,
                                         int compact, unsigned bits, unsigned* w) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (; p < row_len; p += kWarp) {
    const int q = p + lane;
    const unsigned v = q < row_len ? (unsigned)__ldg(row + q) : 0u;
    const unsigned ends = __ballot_sync(kAll, compact && q < row_len && v == 0u);
    unsigned lives = __ballot_sync(kAll, (v & bits) != 0u);
    if (ends) lives &= (1u << (__ffs(ends) - 1)) - 1u;  // the words before the list's end
    if (lives) {
      const int k = __ffs(lives) - 1;
      *w = __shfl_sync(kAll, v, k);
      return p + k;
    }
    if (ends) return row_len;
  }
  return row_len;
}

// The next stage of the walk; false at the end of the row.
template <bool kContact>
__device__ __forceinline__ bool next_stage(const int* __restrict__ row, int row_len, int compact,
                                           const Geo& g, Walk& k, Stage& s) {
  const unsigned subs = (1u << g.sub_n) - 1u;
  if (k.rest == 0u) {
    const unsigned bits = kContact ? (subs | (subs << 8)) : subs;
    k.p = next_live(row, k.p + 1, row_len, compact, bits, &k.w);
    if (k.p >= row_len) return false;
    k.rest = live_slices(k.w, kContact, subs);
    k.piece = 0;
  }
  s.j = compact ? (int)(k.w >> 16) : k.p;
  s.w = k.w;
  if (g.pieces == 1) {
    unsigned m = 0u, r = k.rest;
    for (int i = 0; i < g.per && r != 0u; ++i) {
      const unsigned low = r & (0u - r);
      m |= low;
      r ^= low;
    }
    s.mask = m;
    s.piece = 0;
    k.rest = r;
  } else {
    const unsigned low = k.rest & (0u - k.rest);
    s.mask = low;
    s.piece = k.piece;
    if (++k.piece == g.pieces) {
      k.piece = 0;
      k.rest ^= low;
    }
  }
  return true;
}

__device__ __forceinline__ int stage_len(const Geo& g, const Stage& s) {
  return g.pieces == 1 ? g.sub_w : min(g.pl, g.sub_w - s.piece * g.pl);
}

// Start the copies of stage s into `stage`: every thread of the block takes a
// share. Source p of the stage (slot i holds positions i * pl on) lands as
// (x, y, z, -) at float4 p and, for K6, (vx, vy, vz, -) at float4 C + p, so
// that one 16-byte shared load gives a pair its source.
template <bool kContact, int S>
__device__ __forceinline__ void issue(const float* __restrict__ src, int ns, const Geo& g,
                                      const Stage& s, float4* stage) {
  constexpr int C = kPerRank * S;
  const int len = stage_len(g, s);
  const int first = s.piece * g.pl;
  const int slots = __popc(s.mask);
  for (int e = threadIdx.x; e < slots * len; e += kWarp * S) {
    const int i = e / len;
    const int x = e - i * len;
    const int k = nth_bit(s.mask, i);
    const long long at = (long long)s.j * g.bs + k * g.sub_w + first + x;
    const int rows = (kContact && ((s.w >> (k + 8)) & 1u)) ? 6 : 3;
    float* dst = reinterpret_cast<float*>(stage + i * g.pl + x);
    for (int r = 0; r < rows; ++r) {
      __pipeline_memcpy_async(dst + (r < 3 ? r : 4 * C + r - 3), src + (long long)r * ns + at, 4);
    }
  }
}

// The slots of stage s whose sub-slice has bit `section` + k of its word
// set (0: wake, 8: contact), one bit a slot.
__device__ __forceinline__ unsigned slot_bits(const Stage& s, int section) {
  unsigned m = s.mask, bits = 0u;
  for (int i = 0; m != 0u; ++i) {
    const int k = __ffs(m) - 1;
    m &= m - 1u;
    if ((s.w >> (k + section)) & 1u) bits |= 1u << i;
  }
  return bits;
}

// Cut `bits` (slots) into runs of consecutive slots: the next run's first
// slot and length, taken out of `bits`.
__device__ __forceinline__ void next_run(unsigned& bits, int& first, int& n) {
  first = __ffs(bits) - 1;
  n = __ffs(~(bits >> first)) - 1;
  bits &= ~(((1u << n) - 1u) << first);
}

// Rank `rank`'s terms of stage s, from buf, in ascending source order. S
// divides the sub-slice width and the stage capacity, so the rank's sources
// are the buffer positions rank, rank + S, ... of each run of slots.
template <bool kContact, int S>
__device__ __forceinline__ void evaluate(const float4* __restrict__ pos, const Geo& g,
                                         const Stage& s, int rank, const float* tv,
                                         const WakeConsts& w, float& wake, float* acc) {
  constexpr int C = kPerRank * S;
  const int len = stage_len(g, s);
  unsigned runs = kContact ? slot_bits(s, 0) : (1u << __popc(s.mask)) - 1u;
  while (runs != 0u) {
    int first, n;
    next_run(runs, first, n);
#pragma unroll 4
    for (int x = first * len + rank; x < (first + n) * len; x += S) {
      const float4 p = pos[x];
      wake -= wake_term(p.x - tv[0], p.y - tv[1], p.z - tv[2], w);
    }
  }
  if constexpr (kContact) {
    runs = slot_bits(s, 8);
    while (runs != 0u) {
      int first, n;
      next_run(runs, first, n);
#pragma unroll 2
      for (int x = first * len + rank; x < (first + n) * len; x += S) {
        const float4 p = pos[x], v = pos[C + x];
        contact_term(tv[0] - p.x, tv[1] - p.y, tv[2] - p.z, tv[3] - v.x, tv[4] - v.y,
                     tv[5] - v.z, w.c, acc);
      }
    }
  }
}

// One block: 32 targets of target tile blockIdx.x / groups, S source ranks.
template <bool kContact, int S>
__global__ void __launch_bounds__(kWarp * S)
masked_pair_kernel(const float* __restrict__ tgt, int nt, const float* __restrict__ src, int ns,
                   const int* __restrict__ words, int row_len, int compact, int bt, int groups,
                   Geo g, const unsigned char* __restrict__ valid, WakeConsts w,
                   float* __restrict__ out) {
  constexpr int kRows = kContact ? 6 : 3;
  constexpr int kOut = kContact ? 7 : 1;
  constexpr int C = kPerRank * S;
  __shared__ float4 stages[2][kContact ? 2 * C : C];  // positions, then velocities

  const int lane = threadIdx.x & (kWarp - 1);
  const int rank = threadIdx.x / kWarp;
  const int tile = blockIdx.x / groups;
  const int local = (blockIdx.x % groups) * kWarp + lane;
  const bool live = local < bt;
  const int t = tile * bt + local;
  const bool real = live && (valid == nullptr || valid[t] != 0);

  // Every warp holds the same targets, so the whole block leaves together.
  if (__ballot_sync(kAll, real) == 0u) {
    if (rank == 0 && live) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) out[(long long)o * nt + t] = 0.0f;
    }
    return;
  }

  float tv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) tv[r] = live ? tgt[(long long)r * nt + t] : 0.0f;
  float wake = 0.0f;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  const int* row = words + (long long)tile * row_len;
  Walk k{-1, 0u, 0u, 0};
  Stage cur{}, nxt{};
  bool have = next_stage<kContact>(row, row_len, compact, g, k, cur);
  if (have) issue<kContact, S>(src, ns, g, cur, stages[0]);
  __pipeline_commit();
  int b = 0;
  while (have) {
    const bool more = next_stage<kContact>(row, row_len, compact, g, k, nxt);
    if (more) issue<kContact, S>(src, ns, g, nxt, stages[b ^ 1]);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of the current stage landed
    __syncthreads();           // and every other thread's
    evaluate<kContact, S>(stages[b], g, cur, rank, tv, w, wake, acc);
    __syncthreads();  // every rank is done with the buffer the next copies fill
    cur = nxt;
    have = more;
    b ^= 1;
  }

  // The ranks' partials, added in rank order (the buffers are free now).
  float* smem = reinterpret_cast<float*>(stages);
  if (S > 1) {
    if (rank > 0) {
      float* part = smem + (rank - 1) * kOut * kWarp + lane;
      part[0] = wake;
      if (kContact) {
#pragma unroll
        for (int o = 0; o < 6; ++o) part[(o + 1) * kWarp] = acc[o];
      }
    }
    __syncthreads();
    if (rank == 0) {
      for (int q = 1; q < S; ++q) {
        const float* other = smem + (q - 1) * kOut * kWarp + lane;
        wake += other[0];
        if (kContact) {
#pragma unroll
          for (int o = 0; o < 6; ++o) acc[o] += other[(o + 1) * kWarp];
        }
      }
    }
  }
  if (rank != 0 || !live) return;
  out[t] = real ? wake : 0.0f;
  if (kContact) {
#pragma unroll
    for (int o = 0; o < 6; ++o) out[(long long)(o + 1) * nt + t] = real ? acc[o] : 0.0f;
  }
}

template <bool kContact, int S>
cudaError_t run(unsigned int blocks, cudaStream_t stream, const float* tgt, int nt,
                const float* src, int ns, const int* words, int row_len, int compact, int bt,
                int groups, const Geo& g, const unsigned char* valid, const WakeConsts& w,
                float* out) {
  masked_pair_kernel<kContact, S><<<blocks, kWarp * S, 0, stream>>>(
      tgt, nt, src, ns, words, row_len, compact, bt, groups, g, valid, w, out);
  return cudaGetLastError();
}

template <bool kContact>
const void* kernel_of(int split) {
  switch (split) {
    case 1: return (const void*)masked_pair_kernel<kContact, 1>;
    case 2: return (const void*)masked_pair_kernel<kContact, 2>;
    case 4: return (const void*)masked_pair_kernel<kContact, 4>;
    case 8: return (const void*)masked_pair_kernel<kContact, 8>;
    default: return nullptr;
  }
}

template <bool kContact>
int launch(const void* tgt, int nt, const void* src, int ns, const void* words, int row_len,
           int compact, int bt, int bs, int sub_n, const void* valid, int split,
           const void* consts, int n_consts, void* out, void* stream) {
  if (n_consts != kNumConsts || nt < 0 || ns < 0 || row_len < 0 || bt < 1 || bs < 1 ||
      sub_n < 1 || sub_n > 8 || bs % sub_n != 0 || nt % bt != 0 || ns % bs != 0 ||
      kernel_of<kContact>(split) == nullptr || (bs / sub_n) % split != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // A dense row has one word per source tile; a compacted row indexes source
  // tiles with 15 bits of a non-negative int32.
  if (!compact && row_len != ns / bs) return (int)cudaErrorInvalidValue;
  if (compact && ns / bs > 32768) return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  WakeConsts wc;
  if (!wake_consts(consts, &wc)) return (int)cudaErrorInvalidValue;
  Geo g;
  g.bs = bs;
  g.sub_n = sub_n;
  g.sub_w = bs / sub_n;
  const int cap = kPerRank * split;
  g.pl = g.sub_w < cap ? g.sub_w : cap;
  g.pieces = (g.sub_w + cap - 1) / cap;
  g.per = g.pieces == 1 ? cap / g.sub_w : 1;
  const int groups = (bt + kWarp - 1) / kWarp;
  const long long blocks = (long long)(nt / bt) * groups;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const auto* t = (const float*)tgt;
  const auto* s = (const float*)src;
  const auto* w = (const int*)words;
  const auto* v = (const unsigned char*)valid;
  auto* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  const auto n = (unsigned int)blocks;
  switch (split) {
    case 1: return (int)run<kContact, 1>(n, st, t, nt, s, ns, w, row_len, compact, bt, groups, g, v, wc, o);
    case 2: return (int)run<kContact, 2>(n, st, t, nt, s, ns, w, row_len, compact, bt, groups, g, v, wc, o);
    case 4: return (int)run<kContact, 4>(n, st, t, nt, s, ns, w, row_len, compact, bt, groups, g, v, wc, o);
    default: return (int)run<kContact, 8>(n, st, t, nt, s, ns, w, row_len, compact, bt, groups, g, v, wc, o);
  }
}

}  // namespace

#define MASKED_ARGS                                                                         \
  const void *tgt, int nt, const void *src, int ns, const void *words, int row_len,         \
      int compact, int bt, int bs, int sub_n, const void *valid, int split,                 \
      const void *consts, int n_consts, void *out, void *stream
#define MASKED_PASS                                                                          \
  tgt, nt, src, ns, words, row_len, compact, bt, bs, sub_n, valid, split, consts, n_consts, \
      out, stream

// K3: out (1, Nt) = the wake sum per target over the live sub-slices.
extern "C" int downwash_masked(MASKED_ARGS) { return launch<false>(MASKED_PASS); }

// K6: out (7, Nt) = the wake, then pushout and velocity correction.
extern "C" int interact_masked(MASKED_ARGS) { return launch<true>(MASKED_PASS); }

// Blocks of the K3 (contact 0) or K6 (contact 1) kernel with `split` source
// ranks that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int masked_blocks_per_sm(int contact, int split, int* blocks) {
  const void* fn = contact ? kernel_of<true>(split) : kernel_of<false>(split);
  if (fn == nullptr || blocks == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kWarp * split, 0);
}
