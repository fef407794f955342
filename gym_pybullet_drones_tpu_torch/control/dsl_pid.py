"""DSL cascaded PID controller for the Crazyflie 2.x on tensors (port of the JAX
``control/dsl_pid.py``).

Behavioral spec: gym_pybullet_drones/control/DSLPIDControl.py:37-259 —
position PID -> target thrust + target attitude, then attitude PID -> torques
-> motor mixer -> PWM -> RPM, with the reference's integral clips, torque
clips and PWM<->RPM affine map. The reference's mutable attributes become an
explicit ``DSLPIDState`` carried by the caller. All math broadcasts over
leading batch axes.
"""

import dataclasses

import torch

from gym_pybullet_drones_tpu_torch._struct import (
    TensorStruct,
    resolve_device,
    resolve_dtype,
)
from gym_pybullet_drones_tpu_torch.core.params import G, _MODEL_TABLE
from gym_pybullet_drones_tpu_torch.core.rotations import (
    cross,
    euler_intrinsic_xyz_to_matrix,
    matrix_to_euler_intrinsic_xyz,
    norm3,
    quat_to_euler_xyz,
    quat_to_matrix,
)
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel

# Mixer matrices (DSLPIDControl.py:47-60)
_MIXER_CF2X = [[-0.5, -0.5, -1.0], [-0.5, 0.5, 1.0], [0.5, 0.5, -1.0], [0.5, -0.5, 1.0]]
_MIXER_CF2P = [[0.0, -1.0, -1.0], [1.0, 0.0, 1.0], [0.0, 1.0, -1.0], [-1.0, 0.0, 1.0]]


@dataclasses.dataclass(frozen=True)
class DSLPIDParams(TensorStruct):
    p_for: torch.Tensor  # (3,)
    i_for: torch.Tensor
    d_for: torch.Tensor
    p_tor: torch.Tensor
    i_tor: torch.Tensor
    d_tor: torch.Tensor
    pwm2rpm_scale: torch.Tensor
    pwm2rpm_const: torch.Tensor
    min_pwm: torch.Tensor
    max_pwm: torch.Tensor
    mixer: torch.Tensor  # (4, 3)
    kf: torch.Tensor
    gravity: torch.Tensor  # m * g


@dataclasses.dataclass(frozen=True)
class DSLPIDState(TensorStruct):
    """Carried controller memory (DSLPIDControl.reset, :65-78)."""

    last_rpy: torch.Tensor  # (..., 3)
    integral_pos_e: torch.Tensor  # (..., 3)
    integral_rpy_e: torch.Tensor  # (..., 3)


def dsl_pid_params(model: DroneModel = DroneModel.CF2X, g: float = G,
                   dtype=torch.float32, device=None) -> DSLPIDParams:
    if model not in (DroneModel.CF2X, DroneModel.CF2P):
        raise ValueError("DSLPID supports CF2X and CF2P only (DSLPIDControl.py:34-36)")
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    table = _MODEL_TABLE[model]
    arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
    mixer = _MIXER_CF2X if model == DroneModel.CF2X else _MIXER_CF2P
    return DSLPIDParams(
        p_for=arr([0.4, 0.4, 1.25]),
        i_for=arr([0.05, 0.05, 0.05]),
        d_for=arr([0.2, 0.2, 0.5]),
        p_tor=arr([70000.0, 70000.0, 60000.0]),
        i_tor=arr([0.0, 0.0, 500.0]),
        d_tor=arr([20000.0, 20000.0, 12000.0]),
        pwm2rpm_scale=arr(0.2685),
        pwm2rpm_const=arr(4070.3),
        min_pwm=arr(20000.0),
        max_pwm=arr(65535.0),
        mixer=arr(mixer),
        kf=arr(table["kf"]),
        gravity=arr(g * table["m"]),
    )


def dsl_pid_reset(batch_shape=(), dtype=torch.float32, device=None) -> DSLPIDState:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    z = lambda: torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    return DSLPIDState(last_rpy=z(), integral_pos_e=z(), integral_rpy_e=z())


def _position_control(
    params: DSLPIDParams, integral_pos_e, dt, cur_pos, cur_quat, cur_vel,
    target_pos, target_rpy, target_vel,
):
    """Position loop (DSLPIDControl.py:149-209). Returns thrust (PWM units),
    target intrinsic-XYZ Euler angles, pos error, and the updated integral."""
    cur_rotation = quat_to_matrix(cur_quat)
    pos_e = target_pos - cur_pos
    vel_e = target_vel - cur_vel
    integral_pos_e = torch.clamp(integral_pos_e + pos_e * dt, -2.0, 2.0)
    integral_pos_e = torch.cat(
        [integral_pos_e[..., :2], torch.clamp(integral_pos_e[..., 2:], -0.15, 0.15)], -1)
    zero = torch.zeros_like(pos_e[..., 0])
    target_thrust = (
        params.p_for * pos_e
        + params.i_for * integral_pos_e
        + params.d_for * vel_e
        + torch.stack([zero, zero, zero + params.gravity], -1)
    )
    rz = cur_rotation[..., :, 2]
    scalar_thrust = torch.clamp(
        target_thrust[..., 0] * rz[..., 0] + target_thrust[..., 1] * rz[..., 1]
        + target_thrust[..., 2] * rz[..., 2], min=0.0)
    thrust = (
        torch.sqrt(scalar_thrust / (4.0 * params.kf)) - params.pwm2rpm_const
    ) / params.pwm2rpm_scale
    target_z_ax = target_thrust / norm3(target_thrust, keepdim=True)
    yaw = target_rpy[..., 2]
    target_x_c = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], -1)
    zx = cross(target_z_ax, target_x_c)
    target_y_ax = zx / norm3(zx, keepdim=True)
    target_x_ax = cross(target_y_ax, target_z_ax)
    # Rows stacked then transposed (axes as columns), DSLPIDControl.py:204-205
    target_rotation = torch.stack([target_x_ax, target_y_ax, target_z_ax], -1)
    target_euler = matrix_to_euler_intrinsic_xyz(target_rotation)
    return thrust, target_euler, pos_e, integral_pos_e


def _mat_t_mat(A, B):
    """A^T @ B for (..., 3, 3) matrices, term by term."""
    return torch.stack([torch.stack([
        A[..., 0, i] * B[..., 0, k] + A[..., 1, i] * B[..., 1, k] + A[..., 2, i] * B[..., 2, k]
        for k in range(3)], -1) for i in range(3)], -2)


def _attitude_control(
    params: DSLPIDParams, last_rpy, integral_rpy_e, dt, thrust, cur_quat,
    target_euler, target_rpy_rates,
):
    """Attitude loop (DSLPIDControl.py:212-259). Returns RPMs and new memory."""
    cur_rotation = quat_to_matrix(cur_quat)
    cur_rpy = quat_to_euler_xyz(cur_quat)
    # Reference roundtrips euler -> quat -> matrix with a label swap that is a
    # no-op (DSLPIDControl.py:247-249); net effect is from_euler('XYZ').
    target_rotation = euler_intrinsic_xyz_to_matrix(target_euler)
    rot_matrix_e = (_mat_t_mat(target_rotation, cur_rotation)
                    - _mat_t_mat(cur_rotation, target_rotation))
    rot_e = torch.stack(
        [rot_matrix_e[..., 2, 1], rot_matrix_e[..., 0, 2], rot_matrix_e[..., 1, 0]], -1
    )
    rpy_rates_e = target_rpy_rates - (cur_rpy - last_rpy) / dt
    integral_rpy_e = torch.clamp(integral_rpy_e - rot_e * dt, -1500.0, 1500.0)
    integral_rpy_e = torch.cat(
        [torch.clamp(integral_rpy_e[..., 0:2], -1.0, 1.0), integral_rpy_e[..., 2:]], -1)
    target_torques = (
        -params.p_tor * rot_e
        + params.d_tor * rpy_rates_e
        + params.i_tor * integral_rpy_e
    )
    target_torques = torch.clamp(target_torques, -3200.0, 3200.0)
    mix = params.mixer
    pwm = thrust[..., None] + torch.stack(
        [mix[m, 0] * target_torques[..., 0] + mix[m, 1] * target_torques[..., 1]
         + mix[m, 2] * target_torques[..., 2] for m in range(4)], -1)
    pwm = torch.minimum(torch.maximum(pwm, params.min_pwm), params.max_pwm)
    rpm = params.pwm2rpm_scale * pwm + params.pwm2rpm_const
    return rpm, cur_rpy, integral_rpy_e


def dsl_pid_control(
    params: DSLPIDParams,
    state: DSLPIDState,
    control_timestep,
    cur_pos,
    cur_quat,
    cur_vel,
    target_pos,
    target_rpy=None,
    target_vel=None,
    target_rpy_rates=None,
):
    """Full cascaded PID step (DSLPIDControl.computeControl, :82-145).

    Returns ``(rpm, new_state, pos_e, yaw_e)``.
    """
    zeros = torch.zeros_like(cur_pos)
    target_rpy = zeros if target_rpy is None else target_rpy
    target_vel = zeros if target_vel is None else target_vel
    target_rpy_rates = zeros if target_rpy_rates is None else target_rpy_rates
    thrust, target_euler, pos_e, integral_pos_e = _position_control(
        params, state.integral_pos_e, control_timestep,
        cur_pos, cur_quat, cur_vel, target_pos, target_rpy, target_vel,
    )
    rpm, cur_rpy, integral_rpy_e = _attitude_control(
        params, state.last_rpy, state.integral_rpy_e, control_timestep,
        thrust, cur_quat, target_euler, target_rpy_rates,
    )
    new_state = DSLPIDState(
        last_rpy=cur_rpy, integral_pos_e=integral_pos_e, integral_rpy_e=integral_rpy_e
    )
    yaw_e = target_euler[..., 2] - cur_rpy[..., 2]
    return rpm, new_state, pos_e, yaw_e


def one23d_interface(params: DSLPIDParams, thrust):
    """1/2/4-dim thrust -> per-motor PWM (DSLPIDControl._one23DInterface, :263-287).

    ``thrust`` has trailing dim 1, 2, or 4; returns (..., 4) PWM.
    """
    dim = thrust.shape[-1]
    if dim not in (1, 2, 4):
        raise ValueError("thrust trailing dim must be 1, 2, or 4")
    pwm = (torch.sqrt(thrust / (params.kf * (4 // dim))) - params.pwm2rpm_const) \
        / params.pwm2rpm_scale
    pwm = torch.minimum(torch.maximum(pwm, params.min_pwm), params.max_pwm)
    if dim == 1:
        return pwm.repeat_interleave(4, dim=-1)
    if dim == 2:
        return torch.cat([pwm, torch.flip(pwm, dims=(-1,))], -1)
    return pwm
