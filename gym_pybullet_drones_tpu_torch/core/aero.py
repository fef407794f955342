"""Aerodynamic force models: ground effect, drag, downwash (port of the JAX
``core/aero.py``).

Behavioral spec: BaseAviary._groundEffect (BaseAviary.py:715-752),
BaseAviary._drag (:754-783), BaseAviary._downwash (:785-811), as batched
tensor expressions over the drone axis. The dense ``downwash_forces_body_z``
is the plain version that the coupled-swarm pair kernels of a later slice are
held against.

Conventions: positions/velocities are world-frame, ``R`` is the body->world
rotation matrix, rpm is the (..., 4) motor speed array.
"""

import math

import torch

from gym_pybullet_drones_tpu_torch.core.params import DroneParams


def ground_effect_forces(rpm, pos, R, rpy, params: DroneParams):
    """Per-propeller ground-effect thrust increments, body-frame z: (..., 4).

    BaseAviary.py:732-752: per-prop world heights from forward kinematics,
    clipped at GND_EFF_H_CLIP, gated on |roll|, |pitch| < pi/2.
    """
    r2 = R[..., 2, :]
    offs = params.prop_offsets
    prop_world_z = pos[..., 2:3] + (r2[..., 0:1] * offs[:, 0] + r2[..., 1:2] * offs[:, 1]
                                    + r2[..., 2:3] * offs[:, 2])
    prop_heights = torch.clamp(prop_world_z, min=params.gnd_eff_h_clip)
    gnd_effects = (
        rpm**2 * params.kf * params.gnd_eff_coeff * (params.prop_radius / (4.0 * prop_heights)) ** 2
    )
    gate = (torch.abs(rpy[..., 0]) < math.pi / 2) & (torch.abs(rpy[..., 1]) < math.pi / 2)
    return torch.where(gate[..., None], gnd_effects, torch.zeros_like(gnd_effects))


def drag_force_world(rpm, vel, params: DroneParams):
    """World-frame drag force (..., 3): ``-drag_coeff * sum(2*pi*rpm/60) * vel``
    (the base-frame rotations of BaseAviary.py:771-783 cancel)."""
    omega_sum = torch.sum(2.0 * math.pi * rpm / 60.0, dim=-1, keepdim=True)
    return -params.drag_coeff * omega_sum * vel


def downwash_forces_body_z(pos, params: DroneParams, pos_above=None):
    """Downwash force magnitude along body -z for each drone: (..., N).

    ``pos`` is (..., N, 3). For every ordered pair (i above k) with
    delta_z > 0 and ||delta_xy|| < 10 m the reference adds
    ``-alpha * exp(-0.5 (dxy/beta)^2)`` along the body z axis
    (BaseAviary.py:798-811); contributions sum over i. ``pos_above``
    optionally supplies a different set of source positions (..., M, 3).
    """
    src = pos if pos_above is None else pos_above
    delta = src[..., None, :, :] - pos[..., :, None, :]  # (..., N_k, M_i, 3)
    delta_z = delta[..., 2]
    delta_xy = torch.sqrt(delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1])
    one = torch.ones_like(delta_z)
    safe_dz = torch.where(delta_z > 0, delta_z, one)
    alpha = params.dw_coeff_1 * (params.prop_radius / (4.0 * safe_dz)) ** 2
    beta = params.dw_coeff_2 * safe_dz + params.dw_coeff_3
    safe_beta = torch.where(torch.abs(beta) > 1e-12, beta, one)
    mag = alpha * torch.exp(-0.5 * (delta_xy / safe_beta) ** 2)
    mask = (delta_z > 0) & (delta_xy < 10.0)
    return -torch.sum(torch.where(mask, mag, torch.zeros_like(mag)), dim=-1)
