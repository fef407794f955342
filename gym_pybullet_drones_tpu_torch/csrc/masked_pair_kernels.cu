// K3, K6: the coupled swarm's mask-gated pair passes, one thread per target.
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
// contact_term of pair_terms.cuh, shared with K2, K4 and K5.
//
// The words (ops/spatial.py). The fleet is cut into tiles of `bt` targets
// and `bs` sources, and a source tile into `sub_n` <= 8 sub-slices of
// bs / sub_n sources. Two forms of the same gate:
//   dense:     words is (target tiles, source tiles); word (i, j) gates the
//              tile pair (i, j);
//   compacted: words is (target tiles, row_len); slot p of row i holds
//              `source tile << 16 | word` of the row's p-th live source tile
//              in ascending source order, and 0 marks the end of the list.
// The masks are exact (never drop a contributing pair), and padding slots of
// a binned layout are inert per pair (z = -1e9 fails dz > 0 and d2 < min_dist^2
// against any real drone), so the words only save work.
//
// Bound. A pass reads 3 (K3) or 6 (K6) float columns of Nt targets and Ns
// sources and a few KB of words and writes 1 or 7 columns, against 24
// operations per wake pair and 71 per fused pair (counted on the plain pair
// terms by chip_smoke.py) over the pairs of the live sub-slices: thousands
// of operations per byte. The passes are bound by operations.
//
// Design. On the TPU the source-tile grid axis runs in order and the word
// rides scalar prefetch. Here a block owns `blockDim.x` consecutive targets
// of one target tile (a tile of bt targets is cut into ceil(bt / blockDim.x)
// blocks, so that small fleets still make enough blocks for 132 SMs), each
// thread keeps its target and its accumulators in registers, and the block
// walks its tile's row of words in ascending position: it reads word p (every
// thread the same address), and for each set bit stages that sub-slice of
// the source tile through shared memory, at most kStage sources at a time,
// and adds the pair terms in ascending source index. Skips are uniform
// across the block. One block walks its whole row, with no split of the
// sources, so per target the sources are added in ascending order in both
// forms: the compacted pass equals the dense one bit for bit, whatever the
// block size.
//
// Layout. `tgt` is (rows, Nt) float32 and `src` is (rows, Ns): x, y, z and,
// for K6, vx, vy, vz. `out` is (outputs, Nt): the wake first, then dpx, dpy,
// dpz, dvx, dvy, dvz.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <string.h>

#include "pair_terms.cuh"

namespace {

using namespace pair_terms;

constexpr int kStage = 256;     // sources staged through shared memory at once
constexpr int kMaxThreads = 256;

// One block: `blockDim.x` targets of target tile blockIdx.x / chunks.
template <bool kContact>
__global__ void __launch_bounds__(kMaxThreads)
masked_pair_kernel(const float* __restrict__ tgt, int nt, const float* __restrict__ src, int ns,
                   const int* __restrict__ words, int row_len, int compact, int bt, int bs,
                   int sub_n, int chunks, PairConsts c, float* __restrict__ out) {
  constexpr int kRows = kContact ? 6 : 3;
  __shared__ float sh[kRows][kStage];

  const int tile = blockIdx.x / chunks;
  const int local = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  const bool live = local < bt;
  const int t = tile * bt + local;
  float tv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) tv[r] = live ? tgt[(long long)r * nt + t] : 0.0f;

  float wake = 0.0f;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int sub_w = bs / sub_n;
  const int* row = words + (long long)tile * row_len;
  for (int p = 0; p < row_len; ++p) {
    const unsigned int w = (unsigned int)row[p];
    if (compact && w == 0u) break;  // the end of this row's live list
    const int j = compact ? (int)(w >> 16) : p;
    const unsigned int m = w & 0xFFFFu;
    if (m == 0u) continue;
    for (int k = 0; k < sub_n; ++k) {
      const bool do_wake = ((m >> k) & 1u) != 0u;
      const bool do_contact = kContact && ((m >> (k + 8)) & 1u) != 0u;
      if (!(do_wake || do_contact)) continue;
      const int s_first = j * bs + k * sub_w;
      for (int s0 = s_first; s0 < s_first + sub_w; s0 += kStage) {
        const int len = min(kStage, s_first + sub_w - s0);
        __syncthreads();  // every thread is done with the previous stage
        for (int i = threadIdx.x; i < len; i += blockDim.x) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) sh[r][i] = src[(long long)r * ns + s0 + i];
        }
        __syncthreads();
        if (!live) continue;
        if (do_wake) {
          for (int i = 0; i < len; ++i) {
            wake -= wake_term(sh[0][i] - tv[0], sh[1][i] - tv[1], sh[2][i] - tv[2], c);
          }
        }
        if constexpr (kContact) {
          if (do_contact) {
            for (int i = 0; i < len; ++i) {
              contact_term(tv[0] - sh[0][i], tv[1] - sh[1][i], tv[2] - sh[2][i], tv[3] - sh[3][i],
                           tv[4] - sh[4][i], tv[5] - sh[5][i], c, acc);
            }
          }
        }
      }
    }
  }

  if (!live) return;
  out[t] = wake;
  if (kContact) {
#pragma unroll
    for (int k = 0; k < 6; ++k) out[(long long)(k + 1) * nt + t] = acc[k];
  }
}

template <bool kContact>
int launch(const void* tgt, int nt, const void* src, int ns, const void* words, int row_len,
           int compact, int bt, int bs, int sub_n, int threads, const void* consts,
           int n_consts, void* out, void* stream) {
  if (n_consts != kNumConsts || nt < 0 || ns < 0 || row_len < 0 || bt < 1 || bs < 1 ||
      sub_n < 1 || sub_n > 8 || bs % sub_n != 0 || nt % bt != 0 || ns % bs != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // A dense row has one word per source tile; a compacted row indexes source
  // tiles with 15 bits of a non-negative int32.
  if (!compact && row_len != ns / bs) return (int)cudaErrorInvalidValue;
  if (compact && ns / bs > 32768) return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  PairConsts c;
  memcpy(&c, consts, sizeof(PairConsts));
  const int chunks = (bt + threads - 1) / threads;
  const long long blocks = (long long)(nt / bt) * chunks;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  masked_pair_kernel<kContact><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)tgt, nt, (const float*)src, ns, (const int*)words, row_len, compact, bt, bs,
      sub_n, chunks, c, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define MASKED_ARGS                                                                        \
  const void *tgt, int nt, const void *src, int ns, const void *words, int row_len,        \
      int compact, int bt, int bs, int sub_n, int threads, const void *consts, int n_consts, \
      void *out, void *stream
#define MASKED_PASS \
  tgt, nt, src, ns, words, row_len, compact, bt, bs, sub_n, threads, consts, n_consts, out, stream

// K3: out (1, Nt) = the wake sum per target over the live sub-slices.
extern "C" int downwash_masked(MASKED_ARGS) { return launch<false>(MASKED_PASS); }

// K6: out (7, Nt) = the wake, then pushout and velocity correction.
extern "C" int interact_masked(MASKED_ARGS) { return launch<true>(MASKED_PASS); }
