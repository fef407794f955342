"""Model-Reference Adaptive Controller on tensors (port of the JAX
``control/mrac.py``; the gains are seeded by scipy on the host).

Behavioral spec: control/MRAC.py — linearized 12-state quadrotor model
(:69-85), pole placement at -1..-12 (:91-92, via `ct.place`; here
scipy.signal.place_poles), Lyapunov P from Q=600 I (:97), adaptation gains
Gamma = 5e-3 I (:99-100), online update K̇x = -Γx X eᵀ P Bm (:133-137), and
the DSLPID-style thrust/torque -> PWM -> RPM output stage (:144-147). The
reference's mutable attributes (Kx, Kr, Xm) become an explicit ``MRACState``
carried by the caller; the one-time linear algebra (pole placement, Lyapunov
solve) runs in float64 numpy and scipy when the params are built.
"""

import dataclasses

import numpy as np
import scipy.linalg
import scipy.signal
import torch

from gym_pybullet_drones_tpu_torch._struct import (
    TensorStruct,
    resolve_device,
    resolve_dtype,
)
from gym_pybullet_drones_tpu_torch.control.dsl_pid import _MIXER_CF2P, _MIXER_CF2X
from gym_pybullet_drones_tpu_torch.core.params import G, _MODEL_TABLE
from gym_pybullet_drones_tpu_torch.core.rotations import (
    euler_intrinsic_xyz_to_matrix,
    quat_to_euler_xyz,
)
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel


@dataclasses.dataclass(frozen=True)
class MRACParams(TensorStruct):
    Am: torch.Tensor  # (12, 12) reference model dynamics
    Bm: torch.Tensor  # (12, 4)
    P: torch.Tensor  # (12, 12) Lyapunov solution
    Kr_ref_gain: torch.Tensor  # (4, 12) pinv(B)(A - BK)
    gamma_x: torch.Tensor  # scalar 5e-3
    gamma_r: torch.Tensor
    Kx0: torch.Tensor  # (12, 4) initial feedback gain (-K.T)
    Kr0: torch.Tensor  # (4, 4) initial reference gain (I)
    mixer: torch.Tensor  # (4, 3)
    kf: torch.Tensor
    pwm2rpm_scale: torch.Tensor
    pwm2rpm_const: torch.Tensor
    min_pwm: torch.Tensor
    max_pwm: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MRACState(TensorStruct):
    Kx: torch.Tensor  # (..., 12, 4) adaptive feedback gain
    Kr: torch.Tensor  # (..., 4, 4) adaptive reference gain
    Xm: torch.Tensor  # (..., 12) reference model state
    initialized: torch.Tensor  # (...,) bool: Xm snapped to X on first step (MRAC.py:124-126)


def mrac_params(model: DroneModel = DroneModel.CF2X, g: float = G, psi: float = 0.0,
                dtype=torch.float32, device=None) -> MRACParams:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    t = _MODEL_TABLE[model]
    m, ixx, iyy, izz = t["m"], t["ixx"], t["iyy"], t["izz"]
    # Linearized model (MRAC.py:69-85): x = [pos, rpy, vel, body rates]
    a_sub = np.zeros((6, 6))
    a_sub[0, 3:6] = [g * np.sin(psi), g * np.cos(psi), 0.0]
    a_sub[1, 3:6] = [-g * np.cos(psi), g * np.sin(psi), 0.0]
    A = np.block([[np.zeros((6, 6)), np.eye(6)], [a_sub, np.zeros((6, 6))]])
    b_sub = np.diag([1.0 / m, 1.0 / ixx, 1.0 / iyy, 1.0 / izz])
    B = np.vstack([np.zeros((8, 4)), b_sub])
    poles = -np.linspace(1.0, 12.0, 12)
    K = scipy.signal.place_poles(A, B, poles).gain_matrix
    Am = A - B @ K
    Q = np.eye(12) * 600.0
    P = scipy.linalg.solve_lyapunov(Am.T, -Q)
    Kr_ref_gain = np.linalg.pinv(B) @ Am
    mixer = _MIXER_CF2P if model == DroneModel.CF2P else _MIXER_CF2X
    arr = lambda v: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)
    return MRACParams(
        Am=arr(Am), Bm=arr(B), P=arr(P), Kr_ref_gain=arr(Kr_ref_gain),
        gamma_x=arr(5e-3), gamma_r=arr(5e-3),
        Kx0=arr(-K.T), Kr0=arr(np.eye(4)),
        mixer=arr(mixer), kf=arr(t["kf"]),
        pwm2rpm_scale=arr(0.2685), pwm2rpm_const=arr(4070.3),
        min_pwm=arr(20000.0), max_pwm=arr(65535.0),
    )


def mrac_reset(params: MRACParams, batch_shape=()) -> MRACState:
    """Initial gains and an unseeded reference model, on the params' device."""
    batch_shape = tuple(batch_shape)
    bc = lambda x: x.expand(batch_shape + x.shape).clone()
    return MRACState(
        Kx=bc(params.Kx0), Kr=bc(params.Kr0),
        Xm=torch.zeros(batch_shape + (12,), dtype=params.Kx0.dtype, device=params.Kx0.device),
        initialized=torch.zeros(batch_shape, dtype=torch.bool, device=params.Kx0.device),
    )


def mrac_control(params: MRACParams, state: MRACState, dt,
                 cur_pos, cur_quat, cur_vel, cur_ang_vel,
                 target_pos, target_rpy=None, target_vel=None,
                 target_rpy_rates=None):
    """One adaptive control step (MRAC.computeControl, :113-155).

    ``cur_ang_vel`` is the world-frame angular velocity; like the reference it
    is rotated into the body frame with the intrinsic-XYZ matrix of the Euler
    angles (:122). Returns (rpm, new_state, pos_e, rpy_e).
    """
    z3 = torch.zeros_like(cur_pos)
    target_rpy = z3 if target_rpy is None else target_rpy
    target_vel = z3 if target_vel is None else target_vel
    target_rpy_rates = z3 if target_rpy_rates is None else target_rpy_rates

    cur_rpy = quat_to_euler_xyz(cur_quat)
    Rxyz = euler_intrinsic_xyz_to_matrix(cur_rpy)
    w_body = torch.einsum("...ji,...j->...i", Rxyz, cur_ang_vel)

    X = torch.cat([cur_pos, cur_rpy, cur_vel, w_body], -1)  # (..., 12)
    # The first step seeds the reference model with the measured state
    Xm = torch.where(state.initialized[..., None], state.Xm, X)

    r = torch.cat([target_pos, target_rpy, target_vel, target_rpy_rates], -1)
    rt = -torch.einsum("ij,...j->...i", params.Kr_ref_gain, r)  # (..., 4)

    u = (torch.einsum("...ji,...j->...i", state.Kx, X)
         + torch.einsum("...ji,...j->...i", state.Kr, rt))
    e = X - Xm
    ePBm = torch.einsum("...i,ij,jk->...k", e, params.P, params.Bm)  # (..., 4)
    Kx_dot = -params.gamma_x * X[..., :, None] * ePBm[..., None, :]
    Kr_dot = -params.gamma_r * rt[..., :, None] * ePBm[..., None, :]

    thrust = torch.clamp(u[..., 0], min=0.0)
    torques = torch.clamp(u[..., 1:4], -3200.0, 3200.0)
    thrust_pwm = (torch.sqrt(thrust / (4.0 * params.kf)) - params.pwm2rpm_const) \
        / params.pwm2rpm_scale
    pwm = thrust_pwm[..., None] + torch.einsum("mk,...k->...m", params.mixer, torques)
    pwm = torch.minimum(torch.maximum(pwm, params.min_pwm), params.max_pwm)
    rpm = params.pwm2rpm_scale * pwm + params.pwm2rpm_const

    Xm_dot = (torch.einsum("ij,...j->...i", params.Am, Xm)
              + torch.einsum("ij,...j->...i", params.Bm, rt))
    new_state = MRACState(
        Kx=state.Kx + Kx_dot * dt,
        Kr=state.Kr + Kr_dot * dt,
        Xm=Xm + Xm_dot * dt,
        initialized=torch.ones_like(state.initialized),
    )
    return rpm, new_state, target_pos - cur_pos, target_rpy - cur_rpy
