// The pair terms of every pair kernel: the constants, the wake of one source
// on one target and the contact of one partner on one target. Included by
// pair_kernels.cu (K2, K4, K5) and masked_pair_kernels.cu (K3, K6), so that
// all five passes share one arithmetic by construction.
//
// Math. One reciprocal a wake pair (the hardware's, refined by a Newton
// step), exp2f, rsqrtf (the TPU kernels use lax.rsqrt), fmaxf/fminf, float
// literals only; no --use_fast_math. pair_kernels.cu is built with
// -fmad=false, masked_pair_kernels.cu with FMA contraction on
// (ops/_build.py). The plain versions divide twice and call exp; the passes
// are held to them at the pair tolerances. The wake term jumps where float32
// beta is exactly 0 (dz = 0.6875 m for the CF2X: beta^2 is then taken as 1)
// and at the 10 m cutoff, so its beta and dxy^2 are rounded step by step as
// in the plain version (__fmul_rn and __fadd_rn are never contracted): every
// pass puts the same pairs on the same side of both. The host forms K,
// min_dist, min_dist^2 and eps^2 in double, as the JAX package's Python
// floats are, and rounds each once to float.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pair_terms {

// Host packs these floats in this order (ops/_pairs.py, PairConsts).
struct PairConsts {
  float K;          // c1 * r_prop^2 / 16: alpha = K / dz^2
  float c2, c3;     // beta = c2 * dz + c3
  float min_dist;   // 2 * collision_r
  float min_dist2;  // min_dist^2, formed in double on the host
  float eps2;       // 1e-9^2, formed in double on the host
  float max_push;   // pushout cap per pass
};
constexpr int kNumConsts = sizeof(PairConsts) / sizeof(float);
static_assert(kNumConsts == 7, "PairConsts layout changed: update the host packing");

// 1 / x for x in [1e-37, 1e37]: the hardware's reciprocal and one Newton
// step, within an ulp and with no branch (the correctly rounded __frcp_rn
// branches to a slow path near the ends of the range, which keeps the
// compiler from overlapping the pairs of an unrolled loop).
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmaf_rn(r, __fmaf_rn(-x, r, 1.0f), r);
}

// The wake magnitude of a source at (dx, dy, dz) from the target (source
// minus target); the pass subtracts it. K / dz^2 * exp(-dxy^2 / (2 beta^2))
// from one reciprocal r = 1 / (dz^2 beta^2): K beta^2 r * 2^(-log2(e) / 2 *
// dxy^2 dz^2 r).
__device__ __forceinline__ float wake_term(float dx, float dy, float dz, const PairConsts& c) {
  constexpr float kNegHalfLog2e = -0.72134752044448170f;  // -log2(e) / 2
  const float dxy2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float safe_dz = dz > 0.0f ? dz : 1.0f;
  const float beta = __fadd_rn(__fmul_rn(c.c2, safe_dz), c.c3);
  const float safe_beta2 = fabsf(beta) > 1e-12f ? beta * beta : 1.0f;
  const float dz2 = safe_dz * safe_dz;
  const float r = recip(fminf(dz2 * safe_beta2, 1e37f));
  const float mag = (c.K * safe_beta2) * r * exp2f(kNegHalfLog2e * dxy2 * dz2 * r);
  return (dz > 0.0f && dxy2 < 100.0f) ? mag : 0.0f;
}

// Contact of a partner at (dx, dy, dz) = target minus partner, with relative
// velocity (rvx, rvy, rvz) = target minus partner: adds the pushout to
// acc[0..2] and the velocity correction to acc[3..5].
__device__ __forceinline__ void contact_term(float dx, float dy, float dz, float rvx, float rvy,
                                             float rvz, const PairConsts& c, float* acc) {
  const float d2 = dx * dx + dy * dy + dz * dz;
  const bool contact = d2 < c.min_dist2 && d2 > c.eps2;
  const float inv = rsqrtf(fmaxf(d2, c.eps2));
  const float dist = d2 * inv;
  const float overlap = contact ? c.min_dist - dist : 0.0f;
  const float nx = dx * inv, ny = dy * inv, nz = dz * inv;
  const float push = fminf(0.5f * overlap, c.max_push);
  acc[0] += push * nx;
  acc[1] += push * ny;
  acc[2] += push * nz;
  const float vn = rvx * nx + rvy * ny + rvz * nz;
  const float appr = (contact && vn < 0.0f) ? vn : 0.0f;
  acc[3] += -0.5f * appr * nx;
  acc[4] += -0.5f * appr * ny;
  acc[5] += -0.5f * appr * nz;
}

}  // namespace pair_terms
