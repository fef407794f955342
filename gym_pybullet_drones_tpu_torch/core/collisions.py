"""Drone-drone and drone-obstacle contact as batched tensor ops (port of the
JAX ``core/collisions.py``).

The reference gets contact from Bullet's sequential-impulse solver (world at
BaseAviary.py:484-505; the four RL landmarks are physical bodies,
BaseRLAviary._addObstacles :99-128). Here it is a simultaneous (Jacobi)
projection once per substep:

* drones are spheres of radius ``collision_r`` (cf2x.urdf:31-36);
* obstacles are static boxes and spheres (``ObstacleSet``);
* contacts are inelastic and frictionless: each overlapping pair separates
  along its normal (drones split the overlap, an obstacle pushes the drone
  out fully) and loses its approaching normal velocity (an equal-mass split
  between drones). The pushout per pass is capped at ``max_push``.

``resolve_drone_collisions`` is the dense plain reference of the contact
pair pass K4 (``ops/collide_pairs.py``). Norms are ``sqrt(sum(x*x))`` in a
fixed order.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import TensorStruct, resolve_device
from gym_pybullet_drones_tpu_torch.core.rotations import norm3


@dataclasses.dataclass(frozen=True)
class ObstacleSet(TensorStruct):
    """Static collision bodies, all shaped (M, ...).

    ``half`` holds each obstacle's axis-aligned box half-extents; a zero row
    makes the box a point, so the closest-point formula becomes the sphere
    formula exactly and ``radius`` is a sphere's radius or a box's rounding
    radius. ``half=None`` means a set of spheres."""

    pos: torch.Tensor  # (M, 3)
    radius: torch.Tensor  # (M,)
    half: Optional[torch.Tensor] = None  # (M, 3)


# The four RL landmarks (BaseRLAviary.py:108-126): block.urdf and
# cube_small.urdf as boxes, duck and teddy as spheres.
_RL_OBSTACLE_POS = np.array([
    [1.0, 0.0, 0.1], [0.0, 1.0, 0.1], [-1.0, 0.0, 0.1], [0.0, -1.0, 0.1],
])
_RL_OBSTACLE_R = np.array([0.0, 0.0, 0.12, 0.15])
_RL_OBSTACLE_HALF = np.array([
    [0.025, 0.075, 0.025], [0.025, 0.025, 0.025],
    [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
])

# BaseAviary's own obstacle scene (BaseAviary._addObstacles, :958-981): the
# duck as a 0.12 m sphere, cube_no_rotation (a 1 m box on the ground),
# sphere2 (r = 0.5), and the samurai backdrop as a three-box gate.
_BASE_OBSTACLE_POS = np.array([
    [-0.5, -0.5, 0.08],    # duck
    [-0.5, -2.5, 0.5],     # cube_no_rotation
    [0.0, 2.0, 0.5],       # sphere2
    [-1.5, -4.0, 1.0],     # samurai gate: left pillar
    [1.5, -4.0, 1.0],      # samurai gate: right pillar
    [0.0, -4.0, 2.15],     # samurai gate: lintel
])
_BASE_OBSTACLE_R = np.array([0.12, 0.0, 0.5, 0.0, 0.0, 0.0])
_BASE_OBSTACLE_HALF = np.array([
    [0.0, 0.0, 0.0],
    [0.5, 0.5, 0.5],
    [0.0, 0.0, 0.0],
    [0.2, 0.2, 1.0],
    [0.2, 0.2, 1.0],
    [1.9, 0.25, 0.15],
])


def _obstacle_set(pos, radius, half, dtype, device) -> ObstacleSet:
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ObstacleSet(pos=t(pos), radius=t(radius), half=t(half))


def rl_obstacles(dtype=torch.float32, device=None) -> ObstacleSet:
    """The four RL landmarks as static bodies."""
    return _obstacle_set(_RL_OBSTACLE_POS, _RL_OBSTACLE_R, _RL_OBSTACLE_HALF, dtype, device)


def base_obstacles(dtype=torch.float32, device=None) -> ObstacleSet:
    """The BaseAviary obstacle world as static bodies."""
    return _obstacle_set(_BASE_OBSTACLE_POS, _BASE_OBSTACLE_R, _BASE_OBSTACLE_HALF, dtype,
                         device)


def obstacle_closest_point(pos, obstacles: ObstacleSet):
    """The closest point of each obstacle's core shape to each drone center:
    (..., N, 3) -> (..., N, M, 3). Inside or on a box it is the clamped
    point; for a sphere (half = 0) the center."""
    c = obstacles.pos
    if obstacles.half is None:
        return torch.broadcast_to(c, pos.shape[:-1] + c.shape)
    lo, hi = c - obstacles.half, c + obstacles.half
    return torch.minimum(torch.maximum(pos[..., :, None, :], lo), hi)


def obstacle_delta(pos, obstacles: ObstacleSet):
    """The contact delta from each obstacle toward each drone center and the
    center-inside-core mask: ((..., N, M, 3), (..., N, M)).

    Normally ``pos - closest_point``. A center inside a box core would give a
    zero delta and so no normal; there the delta runs from the box center
    instead, and the mask lets the caller treat the overlap as full."""
    delta = pos[..., :, None, :] - obstacle_closest_point(pos, obstacles)
    inside = torch.sum(delta * delta, dim=-1, keepdim=True) < 1e-18
    delta_fb = pos[..., :, None, :] - obstacles.pos
    return torch.where(inside, delta_fb, delta), inside[..., 0]


def resolve_drone_collisions(pos, vel, radius, *, max_push=0.01, other_pos=None,
                             other_vel=None):
    """One Jacobi contact pass over all drone pairs: corrected (pos, vel).

    ``pos``, ``vel`` are (..., N, 3) and ``radius`` the sphere radius.
    ``other_pos``/``other_vel`` (..., M, 3) give another partner set (a
    sharded fleet's gathered positions); the self pair is masked by its zero
    distance."""
    src_pos = pos if other_pos is None else other_pos
    src_vel = vel if other_vel is None else other_vel
    delta = pos[..., :, None, :] - src_pos[..., None, :, :]  # (..., N, M, 3)
    dist = norm3(delta)
    min_dist = 2.0 * radius
    eps = torch.tensor(1e-9, dtype=pos.dtype, device=pos.device)
    overlap = torch.where((dist < min_dist) & (dist > eps), min_dist - dist,
                          torch.zeros_like(dist))
    safe_dist = torch.maximum(dist, eps)
    normal = delta / safe_dist[..., None]  # from partner j toward i

    # (i) each drone of a pair takes half the overlap, capped per pass
    push = torch.clamp(0.5 * overlap, max=max_push)
    pos_corr = torch.sum(push[..., None] * normal, dim=-2)

    # (ii) remove the approaching half of the relative normal velocity
    v_rel = vel[..., :, None, :] - src_vel[..., None, :, :]
    vn = torch.sum(v_rel * normal, dim=-1)
    approaching = torch.where((overlap > 0.0) & (vn < 0.0), vn, torch.zeros_like(vn))
    vel_corr = torch.sum((-0.5 * approaching)[..., None] * normal, dim=-2)
    return pos + pos_corr, vel + vel_corr


def resolve_obstacle_collisions(pos, vel, radius, obstacles: ObstacleSet, *, max_push=0.01):
    """Drone spheres against static obstacles: full pushout and the normal
    approach velocity removed (infinite obstacle mass). Sphere against
    rounded box, with the center-inside-box fallback of ``obstacle_delta``;
    zero half-extents give the sphere-against-sphere formula."""
    delta, inside = obstacle_delta(pos, obstacles)
    raw_dist = norm3(delta)
    dist = torch.where(inside, torch.zeros_like(raw_dist), raw_dist)
    min_dist = radius + obstacles.radius  # (M,)
    eps = torch.tensor(1e-9, dtype=pos.dtype, device=pos.device)
    overlap = torch.where(inside | ((dist < min_dist) & (dist > eps)), min_dist - dist,
                          torch.zeros_like(dist))
    safe_dist = torch.maximum(raw_dist, eps)
    normal = delta / safe_dist[..., None]  # away from the obstacle

    push = torch.clamp(overlap, max=max_push)
    pos_corr = torch.sum(push[..., None] * normal, dim=-2)

    vn = torch.sum(vel[..., :, None, :] * normal, dim=-1)
    approaching = torch.where((overlap > 0.0) & (vn < 0.0), vn, torch.zeros_like(vn))
    vel_corr = torch.sum((-approaching)[..., None] * normal, dim=-2)
    return pos + pos_corr, vel + vel_corr


def resolve_collisions(pos, vel, radius, obstacles: Optional[ObstacleSet] = None, *,
                       drone_drone: bool = True, max_push=0.01, other_pos=None,
                       other_vel=None):
    """The full contact pass: drone pairs, then static obstacles."""
    if drone_drone:
        pos, vel = resolve_drone_collisions(pos, vel, radius, max_push=max_push,
                                            other_pos=other_pos, other_vel=other_vel)
    if obstacles is not None:
        pos, vel = resolve_obstacle_collisions(pos, vel, radius, obstacles, max_push=max_push)
    return pos, vel
