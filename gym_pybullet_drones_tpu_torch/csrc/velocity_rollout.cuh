// K1's step and time loop, shared by its two libraries: the cells' library
// (csrc/velocity_rollout.cu: the kernel with the fast step's arithmetic
// FastMath) and the counting build (csrc/velocity_rollout_counts.cu: a
// FastMath that also counts its operands). The design, the arithmetic and the
// layout are described in csrc/velocity_rollout.cu; this file holds one copy
// of the constants, the state, the control step and the time loop with its
// guard and library recompute.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "rn_math.cuh"

namespace {

constexpr int kStateRows = 26;
constexpr int kBlock = 32;  // one warp a block: the warps spread over every SM
constexpr unsigned kAll = 0xFFFFFFFFu;

// Host packs these floats in this order (ops/velocity_rollout.py, _pack).
struct VelConsts {
  float i_for[3], d_for[3];
  float p_tor[3], i_tor[3], d_tor[3];
  float mixer[4][3];
  float scale, cnst, min_pwm, max_pwm;
  float four_kf_c;  // 4.0 * kf of the controller, formed in double on the host
  float grav;
  float kf, km, yaw_sign, m, g;
  float J[3];
  float dt_jinv[3];  // pyb_dt * J^-1 diagonal, formed in double on the host
  float offs[4][3];
  float z_min;
  float ctrl_dt, pyb_dt, speed_limit;
};
constexpr int kNumConsts = sizeof(VelConsts) / sizeof(float);
static_assert(kNumConsts == 60, "VelConsts layout changed: update the host packing");

// Whether a launcher's arguments are in range: the constants' count, sizes
// that are not negative, and a grid of E lanes that an int indexes.
inline bool launch_args_ok(long long E, int n_consts, int n_substeps, int num_steps) {
  return n_consts == kNumConsts && E >= 0 && n_substeps >= 0 && num_steps >= 0 &&
         E < (1LL << 31);
}

// One env's state, the 26 rows of SOA_KEYS.
struct State {
  float px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz;
  float rpm[4], ip[3], ir[3], lr[3];
};

// max and min that return NaN if either input is NaN (PTX, sm_80 and up).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

__device__ __forceinline__ float max0(float x) { return max_nan(x, 0.0f); }

// The arithmetic of a control step. FastMath: the library's inline division,
// root, sine and cosine and arc tangent sequences without their checks
// (csrc/rn_math.cuh): `sincos_small` without the reduction (the substep's
// angle), `sincos` without the Payne-Hanek branch (yaw); its guard notes any
// operand outside their fast classes. `divisor` registers a divisor that
// changes (the constant ones seed the guard). LibraryMath: the library's
// `a / b`, `sqrtf`, `atan2f` and `sincosf`.
struct FastMath {
  RnGuard guard;
  __device__ __forceinline__ float div(float a, float b) {
    guard.numerator(a);
    return div_rn(a, b);
  }
  __device__ __forceinline__ float root(float x) {
    guard.radicand(x);
    return sqrt_rn(x);
  }
  __device__ __forceinline__ float arctan(float y, float x) {
    guard.arctan(y, x);
    return atan2_rn(y, x);
  }
  __device__ __forceinline__ void sincos_small(float x, float* s, float* c) {
    guard.small_angle(x);
    sincos_small_rn(x, s, c);
  }
  __device__ __forceinline__ void sincos(float x, float* s, float* c) {
    guard.reduced_angle(x);
    sincos_rn(x, s, c);
  }
  __device__ __forceinline__ void divisor(float b) { guard.divisor(b); }
};

struct LibraryMath {
  __device__ __forceinline__ float div(float a, float b) const { return a / b; }
  __device__ __forceinline__ float root(float x) const { return sqrtf(x); }
  __device__ __forceinline__ float arctan(float y, float x) const { return atan2f(y, x); }
  __device__ __forceinline__ void sincos_small(float x, float* s, float* c) const {
    sincosf(x, s, c);
  }
  __device__ __forceinline__ void sincos(float x, float* s, float* c) const { sincosf(x, s, c); }
  __device__ __forceinline__ void divisor(float) const {}
};

// The guard a step starts with: the constant divisors bound its divisors.
__device__ __forceinline__ RnGuard step_guard(const VelConsts& c) {
  return RnGuard(fminf(fminf(c.four_kf_c, c.ctrl_dt), fminf(c.scale, c.m)),
                 max_nan(max_nan(c.four_kf_c, c.ctrl_dt), max_nan(c.scale, c.m)));
}

// One control step of env state s with the arithmetic of M: the DSLPID
// velocity pipeline, then n_substeps Physics.PYB substeps. (tvx, tvy, tvz):
// the velocity target.
template <class M>
__device__ __forceinline__ void control_step(State& s, const VelConsts& c, float tvx, float tvy,
                                             float tvz, int n_substeps, M& m) {
  // ---------------- DSLPID, velocity pipeline ----------------
  {
    const float xx = s.qx * s.qx, yy = s.qy * s.qy, zz = s.qz * s.qz;
    const float xy = s.qx * s.qy, xz = s.qx * s.qz, yz = s.qy * s.qz;
    const float wxq = s.qw * s.qx, wyq = s.qw * s.qy, wzq = s.qw * s.qz;
    const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wzq), r02 = 2.0f * (xz + wyq);
    const float r10 = 2.0f * (xy + wzq), r11 = 1.0f - 2.0f * (xx + zz), r12 = 2.0f * (yz - wxq);
    const float r20 = 2.0f * (xz - wyq), r21 = 2.0f * (yz + wxq), r22 = 1.0f - 2.0f * (xx + yy);

    const float roll = m.arctan(r21, r22);
    const float yaw = m.arctan(r10, r00);
    const float pitch = asinf(clip(-r20, -1.0f, 1.0f));

    // pos_e == 0 (target_pos = cur_pos): integrals clipped but unchanged,
    // z twice (the generic clip, then its own).
    s.ip[0] = clip(s.ip[0], -2.0f, 2.0f);
    s.ip[1] = clip(s.ip[1], -2.0f, 2.0f);
    s.ip[2] = clip(clip(s.ip[2], -2.0f, 2.0f), -0.15f, 0.15f);
    const float ex = tvx - s.vx, ey = tvy - s.vy, ez = tvz - s.vz;
    const float ttx = c.i_for[0] * s.ip[0] + c.d_for[0] * ex;
    const float tty = c.i_for[1] * s.ip[1] + c.d_for[1] * ey;
    const float ttz = c.i_for[2] * s.ip[2] + c.d_for[2] * ez + c.grav;
    const float scalar_thrust = max0(ttx * r02 + tty * r12 + ttz * r22);
    float syaw, cyaw;
    m.sincos(yaw, &syaw, &cyaw);
    // scalar_thrust / 4 kf and the rate errors -(rpy - last rpy) / ctrl_dt.
    const float cur[3] = {roll, pitch, yaw};
    const float thrust_kf = m.div(scalar_thrust, c.four_kf_c);
    const float rr_e[3] = {m.div(-(roll - s.lr[0]), c.ctrl_dt),
                           m.div(-(pitch - s.lr[1]), c.ctrl_dt),
                           m.div(-(yaw - s.lr[2]), c.ctrl_dt)};
    const float thrust_root = m.root(thrust_kf);
    const float tnorm = m.root(ttx * ttx + tty * tty + ttz * ttz);
    m.divisor(tnorm);
    // the thrust PWM and z_des = t / |t|
    const float thrust_pwm = m.div(thrust_root - c.cnst, c.scale);
    const float zdx = m.div(ttx, tnorm), zdy = m.div(tty, tnorm), zdz = m.div(ttz, tnorm);
    // y_des = normalize(z_des x x_c), x_c = (cos yaw, sin yaw, 0)
    const float yx0 = zdy * 0.0f - zdz * syaw;
    const float yy0 = zdz * cyaw - zdx * 0.0f;
    const float yz0 = zdx * syaw - zdy * cyaw;
    const float yn = m.root(yx0 * yx0 + yy0 * yy0 + yz0 * yz0);
    m.divisor(yn);
    const float yx = m.div(yx0, yn), yyd = m.div(yy0, yn), yzd = m.div(yz0, yn);
    // x_des = y_des x z_des
    const float xxd = yyd * zdz - yzd * zdy;
    const float xyd = yzd * zdx - yx * zdz;
    const float xzd = yx * zdy - yyd * zdx;
    // rot_matrix_e = Rd^T R - R^T Rd; Rd has columns (x_des, y_des, z_des).
    const float e21 = (zdx * r01 + zdy * r11 + zdz * r21) - (r02 * yx + r12 * yyd + r22 * yzd);
    const float e02 = (xxd * r02 + xyd * r12 + xzd * r22) - (r00 * zdx + r10 * zdy + r20 * zdz);
    const float e10 = (yx * r00 + yyd * r10 + yzd * r20) - (r01 * xxd + r11 * xyd + r21 * xzd);
    const float rot_e[3] = {e21, e02, e10};

    float tq[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s.ir[k] = clip(s.ir[k] - rot_e[k] * c.ctrl_dt, -1500.0f, 1500.0f);
      if (k < 2) s.ir[k] = clip(s.ir[k], -1.0f, 1.0f);
      tq[k] = clip(-c.p_tor[k] * rot_e[k] + c.d_tor[k] * rr_e[k] + c.i_tor[k] * s.ir[k],
                   -3200.0f, 3200.0f);
      s.lr[k] = cur[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float pwm = thrust_pwm + c.mixer[k][0] * tq[0] + c.mixer[k][1] * tq[1] +
                  c.mixer[k][2] * tq[2];
      pwm = clip(pwm, c.min_pwm, c.max_pwm);
      s.rpm[k] = c.scale * pwm + c.cnst;
    }
  }

  // The forces depend on the RPMs alone: constant across the substeps.
  float f[4], tm[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = s.rpm[k] * s.rpm[k] * c.kf;
    tm[k] = s.rpm[k] * s.rpm[k] * c.km * c.yaw_sign;
  }
  const float tau_z = -tm[0] + tm[1] - tm[2] + tm[3];
  const float tau_x = f[0] * c.offs[0][1] + f[1] * c.offs[1][1] + f[2] * c.offs[2][1] +
                      f[3] * c.offs[3][1];
  const float tau_y = -(f[0] * c.offs[0][0] + f[1] * c.offs[1][0] + f[2] * c.offs[2][0] +
                        f[3] * c.offs[3][0]);
  const float fsum = f[0] + f[1] + f[2] + f[3];

  // ---------------- physics substeps (Physics.PYB) ----------------
  for (int k = 0; k < n_substeps; ++k) {
    const float xx = s.qx * s.qx, yy = s.qy * s.qy, zz = s.qz * s.qz;
    const float xy = s.qx * s.qy, xz = s.qx * s.qz, yz = s.qy * s.qz;
    const float wxq = s.qw * s.qx, wyq = s.qw * s.qy, wzq = s.qw * s.qz;
    const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wzq), r02 = 2.0f * (xz + wyq);
    const float r10 = 2.0f * (xy + wzq), r11 = 1.0f - 2.0f * (xx + zz), r12 = 2.0f * (yz - wxq);
    const float r20 = 2.0f * (xz - wyq), r21 = 2.0f * (yz + wxq), r22 = 1.0f - 2.0f * (xx + yy);

    // omega world -> body: R^T w; coupling = w x (J w), J diagonal
    const float obx = r00 * s.wx + r10 * s.wy + r20 * s.wz;
    const float oby = r01 * s.wx + r11 * s.wy + r21 * s.wz;
    const float obz = r02 * s.wx + r12 * s.wy + r22 * s.wz;
    const float cx = oby * (c.J[2] * obz) - obz * (c.J[1] * oby);
    const float cy = obz * (c.J[0] * obx) - obx * (c.J[2] * obz);
    const float cz = obx * (c.J[1] * oby) - oby * (c.J[0] * obx);
    const float nbx = obx + c.dt_jinv[0] * (tau_x - cx);
    const float nby = oby + c.dt_jinv[1] * (tau_y - cy);
    const float nbz = obz + c.dt_jinv[2] * (tau_z - cz);
    const float nwx = r00 * nbx + r01 * nby + r02 * nbz;
    const float nwy = r10 * nbx + r11 * nby + r12 * nbz;
    const float nwz = r20 * nbx + r21 * nby + r22 * nbz;

    // integrate_quat (axis-angle, body rates nb), then renormalize
    const float onorm = m.root(nbx * nbx + nby * nby + nbz * nbz);
    const float sn = fmaxf(onorm, 1e-9f);
    m.divisor(sn);
    const float theta = sn * c.pyb_dt * 0.5f;
    float sin_t, ct;
    m.sincos_small(theta, &sin_t, &ct);
    const float axw = m.div(r02 * fsum, c.m), ayw = m.div(r12 * fsum, c.m);
    const float azw = m.div(r22 * fsum, c.m) - c.g, st = m.div(sin_t, sn);
    const float nvx = s.vx + c.pyb_dt * axw, nvy = s.vy + c.pyb_dt * ayw;
    const float nvz = s.vz + c.pyb_dt * azw;

    s.px = s.px + c.pyb_dt * nvx;
    s.py = s.py + c.pyb_dt * nvy;
    const float npz = s.pz + c.pyb_dt * nvz;

    const float mqx = nbz * s.qy - nby * s.qz + nbx * s.qw;
    const float mqy = -nbz * s.qx + nbx * s.qz + nby * s.qw;
    const float mqz = nby * s.qx - nbx * s.qy + nbz * s.qw;
    const float mqw = -nbx * s.qx - nby * s.qy - nbz * s.qz;
    const bool turn = onorm > 1e-9f;
    const float qx = turn ? ct * s.qx + st * mqx : s.qx;
    const float qy = turn ? ct * s.qy + st * mqy : s.qy;
    const float qz = turn ? ct * s.qz + st * mqz : s.qz;
    const float qw = turn ? ct * s.qw + st * mqw : s.qw;
    const float qn = m.root(qx * qx + qy * qy + qz * qz + qw * qw);
    m.divisor(qn);
    s.qx = m.div(qx, qn);
    s.qy = m.div(qy, qn);
    s.qz = m.div(qz, qn);
    s.qw = m.div(qw, qn);

    // plane contact clamp; `pressed` reads the pre-clamp acceleration
    const bool below = npz < c.z_min;
    const bool pressed = below & (azw <= 0.0f);
    s.pz = below ? c.z_min : npz;
    s.vx = nvx;
    s.vy = nvy;
    s.vz = below ? max0(nvz) : nvz;
    s.wx = pressed ? 0.0f : nwx;
    s.wy = pressed ? 0.0f : nwy;
    s.wz = pressed ? 0.0f : nwz;
  }
}

// The work of one lane of K1, one env, from in (30, E) to out (26, E).
// Each control step runs first with the fast arithmetic `fast` (its guard
// reset every step); a warp in which any operand fell outside the fast
// classes recomputes the step from its saved state with LibraryMath, to the
// same bits. Returns the number of steps this lane's warp recomputed.
template <class Fast>
__device__ __forceinline__ int rollout_lane(const float* __restrict__ in, float* __restrict__ out,
                                            long long E, const VelConsts& c, int n_substeps,
                                            int num_steps, Fast& fast) {
  const long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = env < E ? env : E - 1;

  State s;
  s.px = in[0 * E + e], s.py = in[1 * E + e], s.pz = in[2 * E + e];
  s.qx = in[3 * E + e], s.qy = in[4 * E + e], s.qz = in[5 * E + e], s.qw = in[6 * E + e];
  s.vx = in[7 * E + e], s.vy = in[8 * E + e], s.vz = in[9 * E + e];
  s.wx = in[10 * E + e], s.wy = in[11 * E + e], s.wz = in[12 * E + e];
#pragma unroll
  for (int k = 0; k < 4; ++k) s.rpm[k] = in[(13 + k) * E + e];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.ip[k] = in[(17 + k) * E + e];
    s.ir[k] = in[(20 + k) * E + e];
    s.lr[k] = in[(23 + k) * E + e];
  }
  const float ax = in[26 * E + e], ay = in[27 * E + e], az = in[28 * E + e];
  const float amag = in[29 * E + e];

  // The velocity target depends on the action alone.
  const float vnorm = sqrtf(ax * ax + ay * ay + az * az);
  const float safe = fmaxf(vnorm, 1e-12f);
  const float fac = vnorm > 0.0f ? c.speed_limit * fabsf(amag) / safe : 0.0f;
  const float tvx = ax * fac, tvy = ay * fac, tvz = az * fac;

  const RnGuard fresh = step_guard(c);
  int replayed = 0;
  for (int t = 0; t < num_steps; ++t) {
    State next = s;
    fast.guard = fresh;
    control_step(next, c, tvx, tvy, tvz, n_substeps, fast);
    if (__any_sync(kAll, fast.guard.rare())) {
      ++replayed;
      next = s;
      LibraryMath lib;
      control_step(next, c, tvx, tvy, tvz, n_substeps, lib);
    }
    s = next;
  }

  if (env >= E) return replayed;
  const float result[kStateRows] = {s.px, s.py, s.pz, s.qx, s.qy, s.qz, s.qw, s.vx, s.vy,
                                    s.vz, s.wx, s.wy, s.wz, s.rpm[0], s.rpm[1], s.rpm[2],
                                    s.rpm[3], s.ip[0], s.ip[1], s.ip[2], s.ir[0], s.ir[1],
                                    s.ir[2], s.lr[0], s.lr[1], s.lr[2]};
#pragma unroll
  for (int k = 0; k < kStateRows; ++k) out[k * E + env] = result[k];
  return replayed;
}

}  // namespace
