"""Firmware Mellinger controller on tensors (port of the JAX
``control/mellinger.py``).

Behavioral twin of the native bridge ``bridges/cffirmware/src/cffirm.cpp``
(:368-500 ``controllerMellinger``, :80-108 ``lpf2p``, and the
QUAD_FORMATION_X power stage mirrored from ``envs/cf.py:247-276``), which
itself re-implements the subset of the Bitcraze firmware the reference
drives (gym_pybullet_drones/envs/CFAviary.py:401-416, :615-652). Its memory
is an explicit ``MellingerState``, so whole fleets fly full-state setpoints
as batched tensor operations, with no host round trip.

Scope: the position / full-state setpoint mode (``mode.x == modeAbs``, the
only mode the high-level commander emits).

Units follow the firmware wire conventions:
  positions/velocities/accelerations : m, m/s, m/s^2 (world frame)
  quaternion                         : xyzw
  gyro / setpoint rates              : deg/s (legacy frame handled inside)
  outputs                            : PWM counts (thrust 0..65535,
                                       torques clipped to +-32000)
"""

import dataclasses
import math

import torch

from gym_pybullet_drones_tpu_torch._struct import (
    TensorStruct,
    resolve_device,
    resolve_dtype,
)
from gym_pybullet_drones_tpu_torch.core.rotations import cross, quat_to_matrix

ATTITUDE_RATE = 500.0  # Hz, firmware stabilizer rate (cffirm.cpp ATTITUDE_RATE)
_DEG2RAD = 0.017453292519943295


@dataclasses.dataclass(frozen=True)
class Lpf2pCoeffs(TensorStruct):
    """2nd-order Butterworth biquad coefficients (cffirm.cpp lpf2pInit)."""

    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor


def lpf2p_coeffs(sample_freq: float, cutoff_freq: float, dtype=torch.float32,
                 device=None) -> Lpf2pCoeffs:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
    if cutoff_freq <= 0.0 or sample_freq <= 0.0:
        return Lpf2pCoeffs(b0=arr(1.0), b1=arr(0.0), b2=arr(0.0), a1=arr(0.0), a2=arr(0.0))
    fr = sample_freq / cutoff_freq
    ohm = math.tan(math.pi / fr)
    c = 1.0 + 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm
    b0 = ohm * ohm / c
    return Lpf2pCoeffs(
        b0=arr(b0),
        b1=arr(2.0 * b0),
        b2=arr(b0),
        a1=arr(2.0 * (ohm * ohm - 1.0) / c),
        a2=arr((1.0 - 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm) / c),
    )


def lpf2p_apply(coeffs: Lpf2pCoeffs, delay1, delay2, sample):
    """One biquad step (cffirm.cpp lpf2pApply, incl. the NaN-inflow guard).

    Returns ``(out, delay1, delay2)``; broadcasts over any batch shape.
    """
    delay0 = sample - delay1 * coeffs.a1 - delay2 * coeffs.a2
    delay0 = torch.where(torch.isfinite(delay0), delay0, sample)
    out = delay0 * coeffs.b0 + delay1 * coeffs.b1 + delay2 * coeffs.b2
    return out, delay0, delay1


@dataclasses.dataclass(frozen=True)
class MellingerParams(TensorStruct):
    """Firmware default tuning (cffirm.cpp controllerMellingerInit, :368-388)."""

    mass: torch.Tensor          # kg (firmware g_vehicleMass, CF2 + deck)
    mass_thrust: torch.Tensor   # thrust (N) -> PWM counts
    kp_xy: torch.Tensor
    kd_xy: torch.Tensor
    ki_xy: torch.Tensor
    i_range_xy: torch.Tensor
    kp_z: torch.Tensor
    kd_z: torch.Tensor
    ki_z: torch.Tensor
    i_range_z: torch.Tensor
    kr_xy: torch.Tensor
    kw_xy: torch.Tensor
    ki_m_xy: torch.Tensor
    i_range_m_xy: torch.Tensor
    kr_z: torch.Tensor
    kw_z: torch.Tensor
    ki_m_z: torch.Tensor
    i_range_m_z: torch.Tensor
    kd_omega_rp: torch.Tensor
    dt: torch.Tensor            # 1 / ATTITUDE_RATE
    lpf: Lpf2pCoeffs            # 30 Hz D-term low-pass (roll & pitch share coeffs)


@dataclasses.dataclass(frozen=True)
class MellingerState(TensorStruct):
    """Carried controller memory (cffirm.cpp mel.* mutable fields)."""

    i_error: torch.Tensor         # (..., 3) position integral, m*s
    i_error_m: torch.Tensor       # (..., 3) attitude-error integral
    prev_omega_err: torch.Tensor  # (..., 3) rad/s, legacy frame
    lpf_delay1: torch.Tensor      # (..., 2) D-term biquad memory [roll, pitch]
    lpf_delay2: torch.Tensor      # (..., 2)


def mellinger_params(kd_omega_rp: float = 200.0, dtype=torch.float32,
                     device=None) -> MellingerParams:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return MellingerParams(
        mass=arr(0.032),
        mass_thrust=arr(132000.0),
        kp_xy=arr(0.4), kd_xy=arr(0.2), ki_xy=arr(0.05), i_range_xy=arr(2.0),
        kp_z=arr(1.25), kd_z=arr(0.4), ki_z=arr(0.05), i_range_z=arr(0.4),
        kr_xy=arr(70000.0), kw_xy=arr(20000.0), ki_m_xy=arr(0.0), i_range_m_xy=arr(1.0),
        kr_z=arr(60000.0), kw_z=arr(12000.0), ki_m_z=arr(500.0), i_range_m_z=arr(1500.0),
        kd_omega_rp=arr(kd_omega_rp),
        dt=arr(1.0 / ATTITUDE_RATE),
        lpf=lpf2p_coeffs(ATTITUDE_RATE, 30.0, dtype=dtype, device=device),
    )


def mellinger_reset(batch_shape=(), dtype=torch.float32, device=None) -> MellingerState:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    z = lambda k: torch.zeros(tuple(batch_shape) + (k,), dtype=dtype, device=device)
    return MellingerState(i_error=z(3), i_error_m=z(3), prev_omega_err=z(3),
                          lpf_delay1=z(2), lpf_delay2=z(2))


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _vnorm(a):
    """cffirm vnorm: unit vector, falling back to +z below 1e-9 magnitude."""
    n = torch.sqrt(_dot(a, a))[..., None]
    small = n < 1e-9
    safe = a / torch.where(small, torch.ones_like(n), n)
    up = torch.zeros_like(a)
    up[..., 2] = 1.0
    return torch.where(small, up, safe)


def mellinger_control(
    params: MellingerParams,
    state: MellingerState,
    cur_pos,
    cur_vel,
    cur_quat,
    gyro_deg,
    sp_pos,
    sp_vel=None,
    sp_acc=None,
    sp_yaw_deg=None,
    sp_quat=None,
    sp_rate_deg=None,
):
    """One firmware tick of the Mellinger controller (cffirm.cpp:394-500).

    All inputs broadcast over leading batch axes; trailing dims are 3 (vectors)
    or 4 (``cur_quat``/``sp_quat``, xyzw). ``gyro_deg`` is the firmware gyro
    feed in deg/s — the reference plumbs finite-differenced Euler rates there
    (CFAviary.py:215-217 / envs/cf.py:153). Yaw comes from ``sp_quat`` when
    given (full-state command, cffirm.cpp:424-428), else ``sp_yaw_deg``.

    Returns ``(control, new_state)`` where ``control`` is a dict with
    ``thrust`` (PWM counts) and ``roll/pitch/yaw`` torque commands clipped to
    +-32000, matching the C ``control_t``.
    """
    zeros = torch.zeros_like(cur_pos)
    sp_vel = zeros if sp_vel is None else sp_vel
    sp_acc = zeros if sp_acc is None else sp_acc
    sp_rate_deg = zeros if sp_rate_deg is None else sp_rate_deg
    dt = params.dt

    r_error = sp_pos - cur_pos
    v_error = sp_vel - cur_vel
    i_range = torch.stack([params.i_range_xy, params.i_range_xy, params.i_range_z])
    i_error = torch.minimum(torch.maximum(state.i_error + r_error * dt, -i_range), i_range)
    kp = torch.stack([params.kp_xy, params.kp_xy, params.kp_z])
    kd = torch.stack([params.kd_xy, params.kd_xy, params.kd_z])
    ki = torch.stack([params.ki_xy, params.ki_xy, params.ki_z])
    grav = torch.cat([sp_acc[..., :2], sp_acc[..., 2:] + 9.81], -1)
    target_thrust = params.mass * grav + kp * r_error + kd * v_error + ki * i_error

    if sp_quat is not None:
        qx, qy, qz, qw = sp_quat[..., 0], sp_quat[..., 1], sp_quat[..., 2], sp_quat[..., 3]
        desired_yaw = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    elif sp_yaw_deg is not None:
        desired_yaw = torch.as_tensor(sp_yaw_deg, dtype=cur_pos.dtype,
                                      device=cur_pos.device) * _DEG2RAD
    else:
        desired_yaw = torch.zeros_like(cur_pos[..., 0])

    # cffirm quat_to_R == core.rotations.quat_to_matrix (xyzw, row-major)
    rot = quat_to_matrix(cur_quat)
    z_axis = rot[..., :, 2]
    current_thrust = _dot(target_thrust, z_axis)

    z_des = _vnorm(target_thrust)
    x_c = torch.stack([torch.cos(desired_yaw), torch.sin(desired_yaw),
                       torch.zeros_like(desired_yaw)], -1)
    y_des = _vnorm(cross(z_des, x_c))
    x_des = cross(y_des, z_des)

    # eR = (Rdes^T R - R^T Rdes)^vee, firmware layout: no 1/2 factor, y negated
    # for the legacy inverted-pitch output frame (cffirm.cpp:448-455).
    xb, yb = rot[..., :, 0], rot[..., :, 1]
    er = torch.stack(
        [
            _dot(yb, z_des) - _dot(z_axis, y_des),
            -(_dot(z_axis, x_des) - _dot(xb, z_des)),
            _dot(xb, y_des) - _dot(yb, x_des),
        ],
        -1,
    )

    ew = (sp_rate_deg - gyro_deg) * _DEG2RAD
    ew = torch.stack([ew[..., 0], -ew[..., 1], ew[..., 2]], -1)
    err_d = (ew - state.prev_omega_err) / dt
    d_roll, delay1_r, delay2_r = lpf2p_apply(
        params.lpf, state.lpf_delay1[..., 0], state.lpf_delay2[..., 0], err_d[..., 0])
    d_pitch, delay1_p, delay2_p = lpf2p_apply(
        params.lpf, state.lpf_delay1[..., 1], state.lpf_delay2[..., 1], err_d[..., 1])

    i_range_m = torch.stack([params.i_range_m_xy, params.i_range_m_xy, params.i_range_m_z])
    i_error_m = torch.minimum(torch.maximum(state.i_error_m - er * dt, -i_range_m), i_range_m)

    mx = (-params.kr_xy * er[..., 0] + params.kw_xy * ew[..., 0]
          + params.ki_m_xy * i_error_m[..., 0] + params.kd_omega_rp * d_roll)
    my = (-params.kr_xy * er[..., 1] + params.kw_xy * ew[..., 1]
          + params.ki_m_xy * i_error_m[..., 1] + params.kd_omega_rp * d_pitch)
    mz = (-params.kr_z * er[..., 2] + params.kw_z * ew[..., 2]
          + params.ki_m_z * i_error_m[..., 2])

    thrust = params.mass_thrust * current_thrust
    armed = thrust > 0
    zero = torch.zeros_like(thrust)
    clip_t = lambda v: torch.clamp(v, -32000.0, 32000.0)
    control = {
        "thrust": thrust,
        "roll": torch.where(armed, clip_t(mx), zero),
        "pitch": torch.where(armed, clip_t(my), zero),
        "yaw": torch.where(armed, clip_t(-mz), zero),
    }
    # Thrust-cut integrator reset (cffirm.cpp:493-499)
    keep = armed[..., None]
    new_state = MellingerState(
        i_error=torch.where(keep, i_error, torch.zeros_like(i_error)),
        i_error_m=torch.where(keep, i_error_m, torch.zeros_like(i_error_m)),
        prev_omega_err=torch.where(keep, ew, torch.zeros_like(ew)),
        lpf_delay1=torch.stack([delay1_r, delay1_p], -1),
        lpf_delay2=torch.stack([delay2_r, delay2_p], -1),
    )
    return control, new_state


# ---------------------------------------------------------------------------
# Power stage: QUAD_FORMATION_X mixer + brushed-motor PWM curve
# (envs/cf.py:247-276, reference CFAviary.py:615-652)
# ---------------------------------------------------------------------------

SUPPLY_VOLTAGE = 3.0
MAX_PWM = 65535.0
MIN_PWM = 20000.0
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3


def power_distribution_x(control):
    """control dict -> per-motor PWM counts (..., 4), brushed curve applied."""
    r = control["roll"] / 2.0
    p = control["pitch"] / 2.0
    t, y = control["thrust"], control["yaw"]
    thrusts = torch.stack([t - r + p + y, t - r - p - y, t + r - p + y, t + r + p - y], -1)
    thrusts = torch.clamp(thrusts, 0.0, MAX_PWM)
    scaled = thrusts / 65536.0 * 60.0
    volts = -0.0006239 * (scaled * scaled) + 0.088 * scaled
    percentage = torch.clamp(volts / SUPPLY_VOLTAGE, max=1.0)
    return percentage * MAX_PWM


def pwm_to_rpm(pwms):
    """Motor PWM -> RPM action (envs/cf.py:167-168)."""
    return PWM2RPM_SCALE * torch.clamp(pwms, MIN_PWM, MAX_PWM) + PWM2RPM_CONST


def mellinger_rpm(params, state, cur_pos, cur_vel, cur_quat, gyro_deg, sp_pos,
                  **setpoint_kwargs):
    """Convenience: one controller tick straight to (..., 4) RPMs."""
    control, new_state = mellinger_control(
        params, state, cur_pos, cur_vel, cur_quat, gyro_deg, sp_pos,
        **setpoint_kwargs)
    return pwm_to_rpm(power_distribution_x(control)), new_state
