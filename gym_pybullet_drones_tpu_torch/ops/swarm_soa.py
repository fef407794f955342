"""The coupled swarm's step over structure-of-arrays columns: the substep
chain of ``ops/velocity_soa.physics_substep_soa`` between the pair passes K2,
K4 and K5 (port of the JAX ``ops/swarm_soa.py``).

Semantics match ``runtime/swarm.make_big_swarm_physics``:

* the wake magnitude, from the positions before each substep, enters the
  substep's force assembly as a body-z force at the COM (``fz_body``), as
  the dense downwash term does;
* with contact, substep k's contact pass and substep k+1's wake share one
  fused pass (K5): one K2 pass, then n-1 K5 passes, then one K4 pass per
  control step. Without contact, n K2 passes.

PYB_DW only (the coupled-swarm mode); the drag and ground-effect variants
take the AoS path.
"""

from typing import Dict

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import make_collide
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import (
    _rot_cols_from_quat,
    motor_wrench_soa,
    physics_consts,
    physics_substep_soa,
)

SWARM_KEYS = ("px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz", "wx", "wy", "wz")


def swarm_soa_from_kin(kin) -> Dict[str, torch.Tensor]:
    """KinState (leaves (N, d)) -> dict of (N,) columns."""
    s = {}
    for keys, x in ((("px", "py", "pz"), kin.pos), (("qx", "qy", "qz", "qw"), kin.quat),
                    (("vx", "vy", "vz"), kin.vel), (("wx", "wy", "wz"), kin.ang_v)):
        for i, k in enumerate(keys):
            s[k] = x[:, i]
    return s


def swarm_soa_to_kin(s: Dict[str, torch.Tensor], template):
    """dict of (N,) columns -> KinState; rpy_rates = R(quat)^T @ ang_v, as
    ``core/dynamics.substep_pyb`` forms it."""
    pack = lambda ks: torch.stack([s[k] for k in ks], -1)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_cols_from_quat(
        s["qx"], s["qy"], s["qz"], s["qw"])
    wx, wy, wz = s["wx"], s["wy"], s["wz"]
    rpy_rates = torch.stack([r00 * wx + r10 * wy + r20 * wz,
                             r01 * wx + r11 * wy + r21 * wz,
                             r02 * wx + r12 * wy + r22 * wz], -1)
    return template.replace(
        pos=pack(("px", "py", "pz")),
        quat=pack(("qx", "qy", "qz", "qw")),
        vel=pack(("vx", "vy", "vz")),
        ang_v=pack(("wx", "wy", "wz")),
        rpy_rates=rpy_rates,
    )


def make_sorted_swarm(*args, **kwargs):
    """The persistently sorted swarm runs the masked pair kernels K3 and K6
    over ``ops/spatial.py``'s live masks; they come with the next slice."""
    raise NotImplementedError(
        "the persistently sorted swarm (make_sorted_swarm, kernels K3 and K6) comes with "
        "slice 2b, with ops/spatial.py and the binned backend")


def make_swarm_step_soa(params: DroneParams, dt, n_substeps: int, collisions: bool = False,
                        z_sort=None, device=None):
    """Build ``step(s, rpm_cols) -> s`` over the SoA columns of
    ``swarm_soa_from_kin``: one control period of PYB_DW physics with the
    pair wake and, with ``collisions``, drone-drone contact. ``rpm_cols`` is
    a list of four (N,) motor-speed columns. ``z_sort`` (default: on from
    8192 drones) runs the pair passes on the fleet sorted by z, for exact
    tile culls. ``device=None`` means the CUDA card, whose kernels are built
    here; CPU columns run the plain versions."""
    device = resolve_device(device)
    c = physics_consts(params)
    opts = dict(z_sort=z_sort, device=device)
    dw_fn = make_downwash(params, **opts)
    interact_fn = make_interact(params, **opts) if collisions else None
    collide_fn = make_collide(params, **opts) if collisions else None

    def step(s: Dict[str, torch.Tensor], rpm_cols):
        got = s["px"].device
        if got.type != device.type:
            raise ValueError(f"this swarm step was built for {device}; state is on {got}")
        px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz = (s[k] for k in SWARM_KEYS)
        wrench = motor_wrench_soa(c, rpm_cols)
        mag = dw_fn.cols(px, py, pz)
        for k in range(n_substeps):
            (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz) = physics_substep_soa(
                c, dt, px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz, wrench,
                fz_body=mag)
            if collisions:
                if k < n_substeps - 1:
                    mag, dp, dv = interact_fn.cols(px, py, pz, vx, vy, vz)
                else:
                    dp, dv = collide_fn.cols(px, py, pz, vx, vy, vz)
                px, py, pz = px + dp[0], py + dp[1], pz + dp[2]
                vx, vy, vz = vx + dv[0], vy + dv[1], vz + dv[2]
            elif k < n_substeps - 1:
                mag = dw_fn.cols(px, py, pz)
        return dict(zip(SWARM_KEYS, (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz)))

    return step
