"""Collective-Thrust-Body-Rates controller on tensors (port of the JAX
``control/ctbr.py``).

Behavioral spec: control/CTBRControl.py:149-168 — PD position loop producing a
desired acceleration, mass-normalized collective thrust along the current body
z, target attitude from the desired acceleration direction, and body rates
proportional to the vector part of the attitude error quaternion. Used to
drive Betaflight-style rate-mode flight stacks (examples/beta.py:128-138).

Quaternions are xyzw (suite-wide); the reference uses wxyz via transforms3d
internally (CTBRControl.py:92) — the math is identical, only the storage
order differs. All math broadcasts over leading batch axes.
"""

import dataclasses

import torch

from gym_pybullet_drones_tpu_torch._struct import (
    TensorStruct,
    resolve_device,
    resolve_dtype,
)
from gym_pybullet_drones_tpu_torch.core.params import G
from gym_pybullet_drones_tpu_torch.core.rotations import cross, quat_multiply, quat_rotate
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel


@dataclasses.dataclass(frozen=True)
class CTBRParams(TensorStruct):
    k_p: torch.Tensor  # (3,) position P gains (CTBRControl.py:150)
    k_d: torch.Tensor  # (3,) velocity D gains (:151)
    k_rates: torch.Tensor  # (3,) attitude-error-to-rate gains (:152)
    g: torch.Tensor


def ctbr_params(model: DroneModel = DroneModel.CF2X, g: float = G,
                dtype=torch.float32, device=None) -> CTBRParams:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return CTBRParams(k_p=arr([3.0, 3.0, 8.0]), k_d=arr([2.5, 2.5, 5.0]),
                      k_rates=arr([5.0, 5.0, 1.0]), g=arr(g))


def _matrix_cols_to_quat_xyzw(x_body, y_body, z_body):
    """Quaternion from a rotation matrix given as column vectors (Shepperd's
    method, branch-free: every candidate is computed and the one of the
    largest pivot kept with ``torch.where``, the first on ties as
    ``jnp.argmax``; matches transforms3d mat2quat up to sign, which the rate
    law is invariant to)."""
    m00, m10, m20 = x_body[..., 0], x_body[..., 1], x_body[..., 2]
    m01, m11, m21 = y_body[..., 0], y_body[..., 1], y_body[..., 2]
    m02, m12, m22 = z_body[..., 0], z_body[..., 1], z_body[..., 2]
    tr = m00 + m11 + m22
    pivot = lambda v: torch.clamp(4.0 * v, min=1e-12)

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0
    q0 = torch.stack([(m21 - m12) / pivot(qw0), (m02 - m20) / pivot(qw0),
                      (m10 - m01) / pivot(qw0), qw0], -1)
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    q1 = torch.stack([qx1, (m01 + m10) / pivot(qx1), (m02 + m20) / pivot(qx1),
                      (m21 - m12) / pivot(qx1)], -1)
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    q2 = torch.stack([(m01 + m10) / pivot(qy2), qy2, (m12 + m21) / pivot(qy2),
                      (m02 - m20) / pivot(qy2)], -1)
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0
    q3 = torch.stack([(m02 + m20) / pivot(qz3), (m12 + m21) / pivot(qz3), qz3,
                      (m10 - m01) / pivot(qz3)], -1)

    idx = torch.argmax(torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                                    -m00 - m11 + m22], -1), dim=-1)[..., None]
    q = torch.where(idx == 0, q0, torch.where(idx == 1, q1, torch.where(idx == 2, q2, q3)))
    n = torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
                   + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])
    return q / n[..., None]


def _qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def _normed(v):
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
    return v / torch.clamp(n, min=1e-12)[..., None]


def ctbr_control(params: CTBRParams, cur_pos, cur_quat, cur_vel,
                 target_pos, target_vel=None):
    """Returns (..., 4): [mass-normalized thrust (m/s^2), p, q, r (rad/s)].

    CTBRControl.computeControl (:149-168): tar_acc = Kp e + Kd de + g*z;
    thrust = tar_acc . z_body(world); attitude from acc direction with x_body
    from cross([0,1,0], z); rates = 2 * K_RATES * vec(q_err), sign-corrected.
    """
    target_vel = torch.zeros_like(cur_pos) if target_vel is None else target_vel
    e_p = target_pos - cur_pos
    e_d = target_vel - cur_vel
    zero = torch.zeros_like(e_p[..., 0])
    gvec = torch.stack([zero, zero, params.g.expand(zero.shape)], -1)
    tar_acc = params.k_p * e_p + params.k_d * e_d + gvec
    z_world = quat_rotate(cur_quat, torch.stack([zero, zero, zero + 1.0], -1))
    norm_thrust = (tar_acc[..., 0] * z_world[..., 0] + tar_acc[..., 1] * z_world[..., 1]
                   + tar_acc[..., 2] * z_world[..., 2])

    z_body = _normed(tar_acc)
    y_axis = torch.stack([zero, zero + 1.0, zero], -1)
    x_body = _normed(cross(y_axis, z_body))
    y_body = _normed(cross(z_body, x_body))
    tar_att = _matrix_cols_to_quat_xyzw(x_body, y_body, z_body)
    q_err = quat_multiply(_qconj(cur_quat), tar_att)
    rates = 2.0 * params.k_rates * q_err[..., :3]
    rates = torch.where(q_err[..., 3:4] < 0, -rates, rates)
    return torch.cat([norm_thrust[..., None], rates], -1)
