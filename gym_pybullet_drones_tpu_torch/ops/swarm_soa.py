"""The coupled swarm's step over structure-of-arrays columns: the substep
chain of ``ops/velocity_soa.physics_substep_soa`` between the pair passes K2,
K4 and K5, or, for the persistently sorted loop, the masked passes K3 and K6
(port of the JAX ``ops/swarm_soa.py``).

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
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash, make_downwash_masked
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact, make_interact_masked
from gym_pybullet_drones_tpu_torch.ops.spatial import sort_key
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


def check_step_device(built: torch.device, s: Dict[str, torch.Tensor]):
    """A swarm step built for ``built`` takes a state of that device type."""
    got = s["px"].device
    if got.type != built.type:
        raise ValueError(f"this swarm step was built for {built}; state is on {got}")


def make_sorted_swarm(params: DroneParams, dt, n_substeps: int, collisions: bool = False,
                      order: str = "z", resort_every: int = 4, cone: bool = True,
                      neighbor_cap=None, bt: int = 256, bs=None, device=None):
    """The persistently sorted coupled-swarm loop. Returns ``(init, step,
    export)``:

    * ``init(kin) -> s`` sorts the fleet by ``order`` ("z" or "morton"),
      keeps the original indices in ``s["ids"]`` (int64, what PyTorch indexes
      with) and seeds the carried wake;
    * ``step(s, rpm_cols) -> s`` advances one control period in permuted
      space; ``rpm_cols`` are in the drones' original order and gathered once
      per step; the fleet re-sorts every ``resort_every`` control steps
      (``s["t"]`` is a host integer, so this is a Python ``if``);
    * ``export(s, template) -> KinState`` scatters back to the original order.

    The state never leaves permuted space: the pair passes are the mask-gated
    K3 and K6 (``make_downwash_masked``, ``make_interact_masked``), whose live
    words come from the actual coordinates each pass, so a stale order only
    loosens the culling. The wake is carried across control steps (the pass
    after the last substep seeds the next step's first): ``n_substeps`` pair
    passes per control step in both modes. With contact the carried wake is
    computed from the positions before the pushout, the deviation stated in
    ``ops/interact_pairs.py``. ``device=None`` means the CUDA card, whose
    kernels are built here."""
    device = resolve_device(device)
    c = physics_consts(params)
    opts = dict(bt=bt, bs=bs, cone=cone, neighbor_cap=neighbor_cap, device=device)
    dw_m = make_downwash_masked(params, **opts)
    ia_m = make_interact_masked(params, **opts) if collisions else None
    cols = SWARM_KEYS + ("mag", "ids")

    def _resort(s):
        o = torch.argsort(sort_key(s["px"], s["py"], s["pz"], order), stable=True)
        return {k: (s[k][o] if k in cols else s[k]) for k in s}

    def init(kin):
        s = swarm_soa_from_kin(kin)
        check_step_device(device, s)
        s["ids"] = torch.arange(s["px"].shape[0], device=s["px"].device)
        s["mag"] = torch.zeros_like(s["px"])
        s["t"] = 0
        s = _resort(s)
        s["mag"] = dw_m.cols(s["px"], s["py"], s["pz"])
        return s

    def step(s, rpm_cols):
        check_step_device(device, s)
        if s["t"] % resort_every == 0:
            s = _resort(s)
        ids = s["ids"]
        wrench = motor_wrench_soa(c, [r[ids] for r in rpm_cols])
        px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz = (s[k] for k in SWARM_KEYS)
        mag = s["mag"]
        for _ in range(n_substeps):
            (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz) = physics_substep_soa(
                c, dt, px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz, wrench,
                fz_body=mag)
            if collisions:
                mag, dp, dv = ia_m.cols(px, py, pz, vx, vy, vz)
                px, py, pz = px + dp[0], py + dp[1], pz + dp[2]
                vx, vy, vz = vx + dv[0], vy + dv[1], vz + dv[2]
            else:
                mag = dw_m.cols(px, py, pz)
        out = dict(zip(SWARM_KEYS, (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz)))
        out.update(mag=mag, ids=ids, t=s["t"] + 1)
        return out

    def export(s, template):
        ids = s["ids"]
        unsorted = {}
        for k in SWARM_KEYS:
            unsorted[k] = torch.empty_like(s[k])
            unsorted[k][ids] = s[k]
        return swarm_soa_to_kin(unsorted, template)

    return init, step, export


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
        check_step_device(device, s)
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
