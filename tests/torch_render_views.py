"""Seeded camera views for K7's tests: chip_smoke.py phase 10b's (a1)-(a4)
placements and edge views (cameras inside the duck's and the teddy's
bounding spheres, rays grazing a box's top face and a drone's prop discs, a
drone 0.2 m ahead, 37 x 23 and 1 x 1 images). Imports no JAX: the card's
tests use it too."""

import math

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.core.rotations import euler_xyz_to_quat, quat_to_matrix

ARM = 0.0397  # CF2X


def _quat(rpy):
    return euler_xyz_to_quat(torch.as_tensor(np.asarray(rpy, np.float64))).float()


def views(spread, B, N, seed):
    """chip_smoke.py's render_case on the CPU: "landmarks" faces each
    world's first drone toward an RL landmark from 0.4-1.2 m with its other
    drones 0.2-0.8 m ahead; "line" is 12 drones on the x axis; "base" faces
    BaseAviary's obstacles."""
    import chip_smoke

    return tuple(chip_smoke.render_case("cpu", B, N, seed, spread))


def _look(eyes, headings, pitches=None, extra=()):
    """One world per eye: drone 0's eye at ``eyes[b]`` (its body L below),
    yawed to ``headings[b]`` and pitched down by ``pitches[b]``; ``extra``
    adds drones (position, rpy) to every world."""
    B = len(eyes)
    pitches = np.zeros(B) if pitches is None else np.asarray(pitches)
    pos = [[np.asarray(e, np.float64) - [0, 0, ARM]] + [np.asarray(p) for p, _ in extra]
           for e in eyes]
    rpy = [[[0.0, p, h]] + [list(r) for _, r in extra] for h, p in zip(headings, pitches)]
    return (torch.as_tensor(np.asarray(pos), dtype=torch.float32), _quat(rpy),
            torch.full((B,), ARM))


def _duck_and_teddy():
    """Cameras inside the duck's and the teddy's bounding spheres, looking
    across and out of them."""
    duck, teddy = np.array([-1.0, 0.0, 0.12]), np.array([0.0, -1.0, 0.11])
    eyes = [duck + [0.05, 0.0, 0.0], duck + [-0.08, 0.02, 0.03], teddy + [0.0, 0.06, 0.0],
            teddy + [0.03, -0.09, 0.05]]
    return _look(eyes, [math.pi, 0.3, -math.pi / 2, 2.0], [0.1, -0.2, 0.0, 0.4])


def _grazing_box():
    """Eyes at the height of the block's and the cube's top faces (z = 0.125),
    looking level at them: the middle rows run along the faces."""
    eyes = [[0.6, 0.0, 0.125], [0.7, 0.01, 0.125], [0.0, 0.6, 0.125], [0.02, 1.5, 0.125]]
    return _look(eyes, [0.0, 0.02, math.pi / 2, -math.pi / 2])


def _drone_ahead():
    """A drone 0.2 m ahead of drone 0's eye, its prop discs (0.16 arm above
    its centre) at eye height, seen level and tilted."""
    eye = np.array([0.3, 0.2, 0.5])
    ahead = (eye + [0.2, 0.0, -0.16 * ARM], (0.0, 0.0, 0.4))
    pos, quat, arm = _look([eye, eye], [0.0, 0.05], [0.0, 0.02], extra=[ahead])
    quat[1, 1] = _quat([0.3, -0.2, 1.1])
    return pos, quat, arm


VIEWS = {
    "a1_rl": (lambda: views("landmarks", 4, 1, 1), {}),
    "a2_mesh_2": (lambda: views("landmarks", 4, 2, 2), {}),
    "a3_xframe_12": (lambda: views("line", 1, 12, 3), {}),
    "a4_base": (lambda: views("base", 4, 1, 4), dict(scene="base")),
    "inside_duck_teddy": (_duck_and_teddy, {}),
    "grazing_box": (_grazing_box, {}),
    "drone_ahead_mesh": (_drone_ahead, dict(drone_proxy="mesh")),
    "drone_ahead_xframe": (_drone_ahead, dict(drone_proxy="xframe")),
    "odd_37x23": (lambda: views("landmarks", 3, 2, 5), dict(width=37, height=23)),
    "one_pixel": (lambda: views("landmarks", 4, 2, 6), dict(width=1, height=1)),
}


def with_drones(pos, quat, arm, N, seed):
    """The view with N drones: its first N, or its own and more, each 0.2-1.5
    m from drone 0's eye in a direction inside its camera's field of view,
    tilted up to 0.3 rad and yawed at random."""
    n = pos.shape[1]
    if N <= n:
        return pos[:, :N].contiguous(), quat[:, :N].contiguous(), arm
    rng = np.random.default_rng(seed)
    B, extra = pos.shape[0], N - n
    R = quat_to_matrix(quat[:, 0]).double().numpy()  # (B, 3, 3)
    eye = pos[:, 0].double().numpy()
    eye[:, 2] += arm.double().numpy()
    ray = np.concatenate([np.ones((B, extra, 1)), rng.uniform(-0.5, 0.5, (B, extra, 2))], -1)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    dist = rng.uniform(0.2, 1.5, (B, extra, 1))
    more = eye[:, None] + dist * np.einsum("bij,bkj->bki", R, ray)
    rpy = np.concatenate([rng.uniform(-0.3, 0.3, (B, extra, 2)),
                          rng.uniform(-math.pi, math.pi, (B, extra, 1))], -1)
    return (torch.cat([pos, torch.as_tensor(more, dtype=torch.float32)], 1),
            torch.cat([quat, _quat(rpy)], 1), arm)
