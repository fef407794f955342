// K1: whole VelocityAviary rollout chunks, one thread per env.
//
// Replaces the TPU kernel `make_velocity_rollout_pallas` in
// gym_pybullet_drones_tpu/ops/velocity_pallas.py (its inner `kernel`). It
// computes what that kernel computes: `num_steps` x `velocity_step_soa`
// (ops/velocity_soa.py): the DSLPID velocity pipeline, then `n_substeps`
// Physics.PYB substeps (thrust at the prop offsets, yaw reaction torque,
// Newton-Euler, axis-angle quaternion update, ground clamp).
//
// Design. Each thread owns one env: it loads its 26 state values and 4 action
// values into registers once, runs the whole time loop, and stores its 26
// values once. Nothing passes through device memory between steps.
//
// Bound. Per launch the kernel moves (30 + 26) * 4 bytes per env, against
// about 10^3 floating-point operations per env-step times `num_steps`; at
// the main path's chunk lengths it is bound by operations, never by bytes.
// Each thread's step is one long dependent chain, so the time is set by
// instruction latency: the design spreads the envs over as many SMs as
// possible (blocks of 32 threads: 4096 envs -> 128 blocks on 132 SMs) and
// leaves deeper per-SM occupancy and instruction-level parallelism to a
// later change.
//
// Math. IEEE atan2f, asinf, sinf, cosf, sqrtf and true division. Build
// without --use_fast_math (no __sinf, no approximate division) and with
// -fmad=false, so every add and multiply rounds separately, as in the plain
// PyTorch version: the closed loop amplifies every extra rounding
// difference. This halves the float32 ceiling against a build that fuses
// multiply-add pairs, a price paid for bit parity. (The plain version divides by host constants as true
// divisions too; see `_div` in ops/velocity_soa.py.) With the same libdevice
// transcendentals on both sides, K1 and the plain version agree bit for bit
// on the card. Clamps propagate NaN like torch.clamp, so a diverged env stays
// visibly non-finite. Every literal is a float (0.5f): a bare 0.5 would
// promote the expression to double.
//
// Layout. `in` is (30, E) float32: the 26 state rows in SOA_KEYS order, then
// the action rows ax, ay, az, amag. `out` is (26, E). Thread e reads
// in[k * E + e], so a warp's loads are coalesced. The ragged edge is masked.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kStateRows = 26;
constexpr int kBlock = 32;

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

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max0(float x) {
  return isnan(x) ? x : fmaxf(x, 0.0f);
}

__global__ void __launch_bounds__(kBlock)
velocity_rollout_kernel(const float* __restrict__ in, float* __restrict__ out,
                        long long E, VelConsts c, int n_substeps, int num_steps) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;

  float px = in[0 * E + e], py = in[1 * E + e], pz = in[2 * E + e];
  float qx = in[3 * E + e], qy = in[4 * E + e], qz = in[5 * E + e], qw = in[6 * E + e];
  float vx = in[7 * E + e], vy = in[8 * E + e], vz = in[9 * E + e];
  float wx = in[10 * E + e], wy = in[11 * E + e], wz = in[12 * E + e];
  float rpm[4] = {in[13 * E + e], in[14 * E + e], in[15 * E + e], in[16 * E + e]};
  float ip[3] = {in[17 * E + e], in[18 * E + e], in[19 * E + e]};
  float ir[3] = {in[20 * E + e], in[21 * E + e], in[22 * E + e]};
  float lr[3] = {in[23 * E + e], in[24 * E + e], in[25 * E + e]};
  const float ax = in[26 * E + e], ay = in[27 * E + e], az = in[28 * E + e];
  const float amag = in[29 * E + e];

  // The velocity target depends on the action alone.
  const float vnorm = sqrtf(ax * ax + ay * ay + az * az);
  const float safe = fmaxf(vnorm, 1e-12f);
  const float fac = vnorm > 0.0f ? c.speed_limit * fabsf(amag) / safe : 0.0f;
  const float tvx = ax * fac, tvy = ay * fac, tvz = az * fac;

  for (int t = 0; t < num_steps; ++t) {
    // ---------------- DSLPID, velocity pipeline ----------------
    {
      const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
      const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
      const float wxq = qw * qx, wyq = qw * qy, wzq = qw * qz;
      const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wzq), r02 = 2.0f * (xz + wyq);
      const float r10 = 2.0f * (xy + wzq), r11 = 1.0f - 2.0f * (xx + zz), r12 = 2.0f * (yz - wxq);
      const float r20 = 2.0f * (xz - wyq), r21 = 2.0f * (yz + wxq), r22 = 1.0f - 2.0f * (xx + yy);

      const float roll = atan2f(r21, r22);
      const float pitch = asinf(clip(-r20, -1.0f, 1.0f));
      const float yaw = atan2f(r10, r00);

      // pos_e == 0 (target_pos = cur_pos): integrals clipped but unchanged,
      // z twice (the generic clip, then its own).
      ip[0] = clip(ip[0], -2.0f, 2.0f);
      ip[1] = clip(ip[1], -2.0f, 2.0f);
      ip[2] = clip(clip(ip[2], -2.0f, 2.0f), -0.15f, 0.15f);
      const float ex = tvx - vx, ey = tvy - vy, ez = tvz - vz;
      const float ttx = c.i_for[0] * ip[0] + c.d_for[0] * ex;
      const float tty = c.i_for[1] * ip[1] + c.d_for[1] * ey;
      const float ttz = c.i_for[2] * ip[2] + c.d_for[2] * ez + c.grav;
      const float scalar_thrust = max0(ttx * r02 + tty * r12 + ttz * r22);
      const float thrust_pwm = (sqrtf(scalar_thrust / c.four_kf_c) - c.cnst) / c.scale;
      const float tnorm = sqrtf(ttx * ttx + tty * tty + ttz * ttz);
      const float zdx = ttx / tnorm, zdy = tty / tnorm, zdz = ttz / tnorm;
      const float cyaw = cosf(yaw), syaw = sinf(yaw);
      // y_des = normalize(z_des x x_c), x_c = (cos yaw, sin yaw, 0)
      float yx = zdy * 0.0f - zdz * syaw;
      float yyd = zdz * cyaw - zdx * 0.0f;
      float yzd = zdx * syaw - zdy * cyaw;
      const float yn = sqrtf(yx * yx + yyd * yyd + yzd * yzd);
      yx = yx / yn;
      yyd = yyd / yn;
      yzd = yzd / yn;
      // x_des = y_des x z_des
      const float xxd = yyd * zdz - yzd * zdy;
      const float xyd = yzd * zdx - yx * zdz;
      const float xzd = yx * zdy - yyd * zdx;
      // rot_matrix_e = Rd^T R - R^T Rd; Rd has columns (x_des, y_des, z_des).
      const float e21 = (zdx * r01 + zdy * r11 + zdz * r21) - (r02 * yx + r12 * yyd + r22 * yzd);
      const float e02 = (xxd * r02 + xyd * r12 + xzd * r22) - (r00 * zdx + r10 * zdy + r20 * zdz);
      const float e10 = (yx * r00 + yyd * r10 + yzd * r20) - (r01 * xxd + r11 * xyd + r21 * xzd);
      const float rot_e[3] = {e21, e02, e10};
      const float cur[3] = {roll, pitch, yaw};

      float tq[3];
      for (int k = 0; k < 3; ++k) {
        const float rr_e = -(cur[k] - lr[k]) / c.ctrl_dt;
        ir[k] = clip(ir[k] - rot_e[k] * c.ctrl_dt, -1500.0f, 1500.0f);
        if (k < 2) ir[k] = clip(ir[k], -1.0f, 1.0f);
        tq[k] = clip(-c.p_tor[k] * rot_e[k] + c.d_tor[k] * rr_e + c.i_tor[k] * ir[k],
                     -3200.0f, 3200.0f);
        lr[k] = cur[k];
      }
      for (int m = 0; m < 4; ++m) {
        float pwm = thrust_pwm + c.mixer[m][0] * tq[0] + c.mixer[m][1] * tq[1] +
                    c.mixer[m][2] * tq[2];
        pwm = clip(pwm, c.min_pwm, c.max_pwm);
        rpm[m] = c.scale * pwm + c.cnst;
      }
    }

    // The forces depend on the RPMs alone: constant across the substeps.
    float f[4], tm[4];
    for (int m = 0; m < 4; ++m) {
      f[m] = rpm[m] * rpm[m] * c.kf;
      tm[m] = rpm[m] * rpm[m] * c.km * c.yaw_sign;
    }
    const float tau_z = -tm[0] + tm[1] - tm[2] + tm[3];
    const float tau_x = f[0] * c.offs[0][1] + f[1] * c.offs[1][1] + f[2] * c.offs[2][1] +
                        f[3] * c.offs[3][1];
    const float tau_y = -(f[0] * c.offs[0][0] + f[1] * c.offs[1][0] + f[2] * c.offs[2][0] +
                          f[3] * c.offs[3][0]);
    const float fsum = f[0] + f[1] + f[2] + f[3];

    // ---------------- physics substeps (Physics.PYB) ----------------
    for (int s = 0; s < n_substeps; ++s) {
      const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
      const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
      const float wxq = qw * qx, wyq = qw * qy, wzq = qw * qz;
      const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wzq), r02 = 2.0f * (xz + wyq);
      const float r10 = 2.0f * (xy + wzq), r11 = 1.0f - 2.0f * (xx + zz), r12 = 2.0f * (yz - wxq);
      const float r20 = 2.0f * (xz - wyq), r21 = 2.0f * (yz + wxq), r22 = 1.0f - 2.0f * (xx + yy);

      const float axw = r02 * fsum / c.m, ayw = r12 * fsum / c.m, azw = r22 * fsum / c.m - c.g;
      float nvx = vx + c.pyb_dt * axw, nvy = vy + c.pyb_dt * ayw, nvz = vz + c.pyb_dt * azw;

      // omega world -> body: R^T w; coupling = w x (J w), J diagonal
      const float obx = r00 * wx + r10 * wy + r20 * wz;
      const float oby = r01 * wx + r11 * wy + r21 * wz;
      const float obz = r02 * wx + r12 * wy + r22 * wz;
      const float cx = oby * (c.J[2] * obz) - obz * (c.J[1] * oby);
      const float cy = obz * (c.J[0] * obx) - obx * (c.J[2] * obz);
      const float cz = obx * (c.J[1] * oby) - oby * (c.J[0] * obx);
      const float nbx = obx + c.dt_jinv[0] * (tau_x - cx);
      const float nby = oby + c.dt_jinv[1] * (tau_y - cy);
      const float nbz = obz + c.dt_jinv[2] * (tau_z - cz);
      float nwx = r00 * nbx + r01 * nby + r02 * nbz;
      float nwy = r10 * nbx + r11 * nby + r12 * nbz;
      float nwz = r20 * nbx + r21 * nby + r22 * nbz;

      px = px + c.pyb_dt * nvx;
      py = py + c.pyb_dt * nvy;
      float npz = pz + c.pyb_dt * nvz;

      // integrate_quat (axis-angle, body rates nb), then renormalize
      const float onorm = sqrtf(nbx * nbx + nby * nby + nbz * nbz);
      const float sn = fmaxf(onorm, 1e-9f);
      const float theta = sn * c.pyb_dt / 2.0f;
      const float ct = cosf(theta), st = sinf(theta) / sn;
      const float mqx = nbz * qy - nby * qz + nbx * qw;
      const float mqy = -nbz * qx + nbx * qz + nby * qw;
      const float mqz = nby * qx - nbx * qy + nbz * qw;
      const float mqw = -nbx * qx - nby * qy - nbz * qz;
      if (onorm > 1e-9f) {
        qx = ct * qx + st * mqx;
        qy = ct * qy + st * mqy;
        qz = ct * qz + st * mqz;
        qw = ct * qw + st * mqw;
      }
      const float qn = sqrtf(qx * qx + qy * qy + qz * qz + qw * qw);
      qx = qx / qn;
      qy = qy / qn;
      qz = qz / qn;
      qw = qw / qn;

      // plane contact clamp; `pressed` reads the pre-clamp acceleration
      const bool below = npz < c.z_min;
      if (below) {
        npz = c.z_min;
        nvz = max0(nvz);
        if (azw <= 0.0f) {
          nwx = 0.0f;
          nwy = 0.0f;
          nwz = 0.0f;
        }
      }
      pz = npz;
      vx = nvx;
      vy = nvy;
      vz = nvz;
      wx = nwx;
      wy = nwy;
      wz = nwz;
    }
  }

  const float result[kStateRows] = {px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz,
                                    rpm[0], rpm[1], rpm[2], rpm[3], ip[0], ip[1], ip[2],
                                    ir[0], ir[1], ir[2], lr[0], lr[1], lr[2]};
#pragma unroll
  for (int k = 0; k < kStateRows; ++k) out[k * E + e] = result[k];
}

}  // namespace

extern "C" int velocity_rollout(const void* in, void* out, long long E, const void* consts,
                                int n_consts, int n_substeps, int num_steps, void* stream) {
  if (n_consts != kNumConsts || E < 0 || n_substeps < 0 || num_steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (E == 0) return (int)cudaSuccess;
  VelConsts c;
  memcpy(&c, consts, sizeof(VelConsts));
  const unsigned int blocks = (unsigned int)((E + kBlock - 1) / kBlock);
  velocity_rollout_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, E, c, n_substeps, num_steps);
  return (int)cudaGetLastError();
}
