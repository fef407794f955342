// The pair terms of every pair kernel: the constants, the wake of one source
// on one target and the contact of one partner on one target. Included by
// wake_pair_kernels.cu (K2, K4, K5: wake_beta, wake_mag, wake_live, touching,
// contact_add) and masked_pair_kernels.cu (K3, K6: wake_term, contact_term),
// so that the five passes share one arithmetic by construction; the sources
// differ only in their flags.
//
// Math. A wake pair takes one reciprocal and one exponent, rcp.approx.ftz
// (1 ulp, no Newton step) and ex2.approx.ftz (2 ulp; its argument carries
// log2 K, so the factor K costs nothing and terms under 2^-126 flush to 0);
// a contact pair takes rsqrtf (the TPU kernels use lax.rsqrt). fmaxf/fminf,
// float literals only; no --use_fast_math. Both sources are built with FMA
// contraction on (ops/_build.py); the contact term rounds every product and
// sum itself (__fmul_rn, __fadd_rn are never contracted), so that K4 equals
// its plain version bit for bit wherever a target has at most one partner.
// The plain versions divide twice and call exp; the wake passes are held to
// them at the pair tolerances. The wake term jumps at the 10 m cutoff and
// where float32 beta is exactly 0, and the contact term at the contact
// radius, so beta, dxy^2 and d^2 are rounded step by step as in the plain
// versions: every pass puts the same pairs on the same side of all three.
//
// beta = 0. The reference simulator's Gaussian exp(-dxy^2 / (2 beta^2))
// (BaseAviary.py:798-811) goes to 0 as beta goes to 0, and so does the
// port's term: where float32 beta = c2 dz + c3 is 0 (dz = 0.6875 m for the
// CF2X), wake_live is false and the term is exactly 0. The JAX package puts
// beta^2 = 1 there, a Gaussian 1 m wide (ops/downwash_pallas.py:74); this is
// the port's one deliberate deviation from it. It makes the live masks'
// cone cull (ops/spatial.py), which reads beta -> 0 as an ever narrower
// Gaussian, exact. The host forms K, log2 K, min_dist, min_dist^2 and eps^2
// in double, as the JAX package's Python floats are, and rounds each once to
// float.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

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

// The pair constants, and log2(K) formed in double on the host: the wake's
// exponent adds it, so that 2^(...) carries the factor K.
struct WakeConsts {
  PairConsts c;
  float log2K;
};

// The launchers' constants from the host's packed floats; false unless K > 0.
inline bool wake_consts(const void* packed, WakeConsts* w) {
  memcpy(&w->c, packed, sizeof(PairConsts));
  w->log2K = (float)log2((double)w->c.K);
  return w->c.K > 0.0f;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// dx^2 + dy^2, rounded as the plain version rounds it.
__device__ __forceinline__ float sq2(float dx, float dy) {
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// beta = c2 dz + c3, rounded as the plain version rounds it.
__device__ __forceinline__ float wake_beta(float dz, const WakeConsts& w) {
  return __fadd_rn(__fmul_rn(w.c.c2, dz), w.c.c3);
}

// The wake magnitude of a source dz above the target (the pass subtracts it
// where wake_live holds), dxy2 = dx^2 + dy^2 and dz2 = dz^2 rounded as in the
// plain version: K / dz^2 * exp(-dxy^2 / (2 beta^2)) from one reciprocal
// r = 1 / (dz^2 beta^2) as beta^2 r * 2^(-log2(e) / 2 * dxy^2 dz^2 r + log2 K).
// Finite for 0 < dz < 1e18 m and beta != 0; elsewhere it may be inf or NaN,
// and wake_live masks it.
__device__ __forceinline__ float wake_mag(float dxy2, float dz2, float beta, const WakeConsts& w) {
  constexpr float kNegHalfLog2e = -0.72134752044448170f;  // -log2(e) / 2
  const float beta2 = beta * beta;
  const float r = rcp_approx(dz2 * beta2);
  const float e = ex2_approx(fmaf(kNegHalfLog2e * dxy2, dz2 * r, w.log2K));
  return (beta2 * r) * e;
}

// The pairs whose wake term is not 0: the source above the target, within
// the 10 m cutoff, and float32 beta not 0. Bitwise, so that no branch is
// formed: the beta test folds into the predicate that the others form.
__device__ __forceinline__ bool wake_live(float dxy2, float dz, float beta) {
  return (dz > 0.0f) & (dxy2 < 100.0f) & (fabsf(beta) > 1e-12f);
}

// The wake term of a source at (dx, dy, dz) from the target (source minus
// target): wake_mag where wake_live holds, else 0.
__device__ __forceinline__ float wake_term(float dx, float dy, float dz, const WakeConsts& w) {
  const float dxy2 = sq2(dx, dy);
  const float beta = wake_beta(dz, w);
  const float mag = wake_mag(dxy2, __fmul_rn(dz, dz), beta, w);
  return wake_live(dxy2, dz, beta) ? mag : 0.0f;
}

// eps^2 < d2 < min_dist^2, bitwise.
__device__ __forceinline__ bool touching(float d2, const PairConsts& c) {
  return (d2 < c.min_dist2) & (d2 > c.eps2);
}

// Contact of a partner at (dx, dy, dz) = target minus partner with d2 its
// squared distance, relative velocity (rvx, rvy, rvz) = target minus partner
// and `touch` = touching(d2): adds the pushout to acc[0], acc[s], acc[2 s]
// and the velocity correction to acc[3 s .. 5 s], s = kStride. Where `touch`
// is false both are exactly zero (overlap 0, so push 0; appr 0). Every
// product and sum is rounded as the plain version rounds it, in its order.
template <int kStride>
__device__ __forceinline__ void contact_add(float d2, bool touch, float dx, float dy, float dz,
                                            float rvx, float rvy, float rvz, const PairConsts& c,
                                            float* acc) {
  const float inv = rsqrtf(fmaxf(d2, c.eps2));
  const float dist = __fmul_rn(d2, inv);
  const float overlap = touch ? __fsub_rn(c.min_dist, dist) : 0.0f;
  const float nx = __fmul_rn(dx, inv), ny = __fmul_rn(dy, inv), nz = __fmul_rn(dz, inv);
  const float push = fminf(__fmul_rn(0.5f, overlap), c.max_push);
  acc[0] = __fadd_rn(acc[0], __fmul_rn(push, nx));
  acc[1 * kStride] = __fadd_rn(acc[1 * kStride], __fmul_rn(push, ny));
  acc[2 * kStride] = __fadd_rn(acc[2 * kStride], __fmul_rn(push, nz));
  const float vn = __fadd_rn(__fadd_rn(__fmul_rn(rvx, nx), __fmul_rn(rvy, ny)), __fmul_rn(rvz, nz));
  const float half = __fmul_rn(-0.5f, (touch & (vn < 0.0f)) ? vn : 0.0f);
  acc[3 * kStride] = __fadd_rn(acc[3 * kStride], __fmul_rn(half, nx));
  acc[4 * kStride] = __fadd_rn(acc[4 * kStride], __fmul_rn(half, ny));
  acc[5 * kStride] = __fadd_rn(acc[5 * kStride], __fmul_rn(half, nz));
}

// The contact term of a partner at (dx, dy, dz) = target minus partner into
// acc[0..5], d2 rounded as the plain version rounds it.
__device__ __forceinline__ void contact_term(float dx, float dy, float dz, float rvx, float rvy,
                                             float rvz, const PairConsts& c, float* acc) {
  const float d2 = __fadd_rn(sq2(dx, dy), __fmul_rn(dz, dz));
  contact_add<1>(d2, touching(d2, c), dx, dy, dz, rvx, rvy, rvz, c, acc);
}

}  // namespace pair_terms
