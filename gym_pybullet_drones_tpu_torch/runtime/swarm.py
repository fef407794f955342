"""The coupled swarm: one aviary whose drones interact through downwash and
contact on every substep (port of the JAX ``runtime/swarm.py``, its
single-device forms).

``make_swarm_physics`` is the entry point: it returns ``(init, step,
export)`` and picks a backend from the fleet's geometry. This slice carries
the ``"soa"`` backend (``ops/swarm_soa.py``, pair kernels K2, K4 and K5),
which ``"auto"`` picks for every fleet under 16384 drones and for every
dense one. ``make_big_swarm_physics`` is the same physics in AoS form over
``core/dynamics.substep_pyb``.
"""

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.dynamics import _PYB_FLAGS, KinState, substep_pyb
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.envs.spec import Physics
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import make_collide
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact
from gym_pybullet_drones_tpu_torch.ops.swarm_soa import (
    make_sorted_swarm,
    make_swarm_step_soa,
    swarm_soa_from_kin,
    swarm_soa_to_kin,
)

_LATER = "comes with slice 2b (ops/spatial.py, the binned backend, kernels K3 and K6)"


def _positions(pos):
    """(N, 3) numpy positions from an array, a tensor or a KinState, or None."""
    if pos is None:
        return None
    if hasattr(pos, "pos"):
        pos = pos.pos
    if isinstance(pos, torch.Tensor):
        return pos.detach().cpu().numpy()
    return np.asarray(pos)


def select_swarm_backend(pos, mesh=None, min_n: int = 16384, min_pitch: float = 2.0) -> str:
    """The ``backend="auto"`` rule of ``make_swarm_physics``: ``"binned"``
    for big spread fleets (N >= min_n and mean lattice pitch >= min_pitch,
    where the 10 m wake cutoff of BaseAviary.py:801 leaves each drone few
    partners) or whenever the drone axis is sharded over a mesh; ``"soa"``
    otherwise. Reads the positions to the host once."""
    if mesh is not None:
        return "binned"
    pos = _positions(pos)
    if pos is None or pos.shape[0] < min_n:
        return "soa"
    ext = np.maximum(pos.max(0) - pos.min(0), 1e-6)
    pitch = float(np.prod(ext) ** (1 / 3) / pos.shape[0] ** (1 / 3))
    return "binned" if pitch >= min_pitch else "soa"


def make_swarm_physics(params: DroneParams, dt, n_substeps: int, collisions: bool = False,
                       init_pos=None, backend: str = "auto", mesh=None, device=None,
                       **backend_opts):
    """The coupled swarm's factory: ``(init, step, export)``.

    * ``init(kin) -> s``: the backend's state from a KinState;
    * ``step(s, rpm_cols) -> s``: one control period (PYB_DW physics, with
      drone-drone contact when ``collisions``), ``rpm_cols`` four (N,)
      columns in the drones' order;
    * ``export(s, template) -> KinState``.

    ``backend="auto"`` applies ``select_swarm_backend`` to ``init_pos`` (an
    (N, 3) array or tensor, or the KinState about to be passed to ``init``);
    without it, auto picks ``"soa"``. ``"soa"`` is the dense SoA step
    (``ops/swarm_soa.make_swarm_step_soa``; ``z_sort`` passes through).
    ``device=None`` means the CUDA card, whose kernels are built here.
    The binned backend, ``sorted=True`` and ``mesh`` are not ported yet and
    raise."""
    if backend == "auto":
        backend = select_swarm_backend(init_pos, mesh=mesh)
    if mesh is not None:
        raise NotImplementedError(
            "a swarm sharded over a mesh comes with the torch.distributed runtime "
            "(ROADMAP Queue 1 item 21) and the binned backend, which " + _LATER)
    if backend == "binned":
        raise NotImplementedError("the binned swarm backend " + _LATER)
    if backend != "soa":
        raise ValueError(f"unknown swarm backend {backend!r}")
    if backend_opts.pop("sorted", False):
        return make_sorted_swarm(params, dt, n_substeps, collisions=collisions, **backend_opts)
    step = make_swarm_step_soa(params, dt, n_substeps, collisions=collisions, device=device,
                               **backend_opts)
    return swarm_soa_from_kin, step, swarm_soa_to_kin


def make_big_swarm_physics(params: DroneParams, dt, n_substeps: int,
                           physics: Physics = Physics.PYB_DW, collisions: bool = False,
                           z_sort=None, device=None):
    """Build ``step(kin, rpm, last_rpm) -> (kin, last_rpm)``: ``n_substeps``
    of ``substep_pyb`` with the wake from the pair pass K2 in place of the
    dense (N, N) downwash term (it enters through ``dw_force_body_z``, the
    same accel and resting-contact semantics) and, with ``collisions``,
    drone-drone contact from K4 after each substep.

    With both the wake and contact, one fused pass (K5) computes substep k's
    contact and substep k+1's wake from the post-integration positions: one
    K2, n-1 K5 and one K4 pass per control step. The dense pipeline feeds
    substep k+1's wake the post-pushout positions instead, the deviation
    stated in ``ops/interact_pairs.py``. ``z_sort`` (default: on from 8192
    drones) only reorders the float32 pair sums. ``device=None`` means the
    CUDA card, whose kernels are built here."""
    device = resolve_device(device)
    flags = dict(_PYB_FLAGS[physics])
    use_dw = flags.pop("dw")
    opts = dict(z_sort=z_sort, device=device)
    dw_fn = make_downwash(params, **opts) if use_dw else None
    collide_fn = make_collide(params, **opts) if collisions else None
    fused = use_dw and collisions
    interact_fn = make_interact(params, **opts) if fused else None
    collide_last = make_collide(params, return_delta=True, **opts) if fused else None

    def step(kin: KinState, rpm, last_rpm):
        if kin.pos.device.type != device.type:
            raise ValueError(f"this swarm step was built for {device}; state is on "
                             f"{kin.pos.device}")
        mag = dw_fn(kin.pos) if fused else None  # the first substep's wake
        for k in range(n_substeps):
            if not fused and use_dw:
                mag = dw_fn(kin.pos)
            kin = substep_pyb(kin, rpm, last_rpm, params, dt, dw=False, dw_force_body_z=mag,
                              **flags)
            if fused:
                if k < n_substeps - 1:
                    mag, dpos, dvel = interact_fn(kin.pos, kin.vel)
                else:
                    dpos, dvel = collide_last(kin.pos, kin.vel)
                kin = kin.replace(pos=kin.pos + dpos, vel=kin.vel + dvel)
            elif collide_fn is not None:
                new_pos, new_vel = collide_fn(kin.pos, kin.vel)
                kin = kin.replace(pos=new_pos, vel=new_vel)
            last_rpm = rpm
        return kin, last_rpm

    return step
