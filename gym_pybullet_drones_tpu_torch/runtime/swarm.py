"""The coupled swarm: one aviary whose drones interact through downwash and
contact on every substep (port of the JAX ``runtime/swarm.py``).

``make_swarm_physics`` is the entry point: it returns ``(init, step,
export)`` and picks a backend from the fleet's geometry: ``"soa"``
(``ops/swarm_soa.py``, pair kernels K2, K4 and K5; with ``sorted=True`` the
persistently sorted loop over the masked kernels K3 and K6) for every fleet
under 16384 drones and for every dense one, ``"binned"``
(``ops/swarm_binned.py``, K3 and K6 over padded xy cells) for big spread
fleets. ``make_big_swarm_physics`` is the same physics in AoS form over
``core/dynamics.substep_pyb``, and ``make_sharded_swarm_physics`` that form
with the drone axis split over the ranks of a ``runtime/mesh.Mesh``.
"""

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.collisions import resolve_drone_collisions
from gym_pybullet_drones_tpu_torch.core.dynamics import _PYB_FLAGS, KinState, substep_pyb
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.envs.spec import Physics
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import make_collide
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact
from gym_pybullet_drones_tpu_torch.ops.swarm_binned import binned_geometry, make_binned_swarm
from gym_pybullet_drones_tpu_torch.ops.swarm_soa import (
    make_sorted_swarm,
    make_swarm_step_soa,
    swarm_soa_from_kin,
    swarm_soa_to_kin,
)
from gym_pybullet_drones_tpu_torch.runtime.mesh import Mesh, all_gather, env_sharding

_GEOMETRY = ("cell_size", "nx", "ny", "cap")
_GEOMETRY_OPTS = ("occ_target", "headroom", "max_cap", "min_cell", "cell")


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
                       init_pos=None, backend: str = "auto", mesh=None, axis: str = "env",
                       device=None, **backend_opts):
    """The coupled swarm's factory: ``(init, step, export)``.

    * ``init(kin) -> s``: the backend's state from a KinState;
    * ``step(s, rpm_cols) -> s``: one control period (PYB_DW physics, with
      drone-drone contact when ``collisions``), ``rpm_cols`` four (N,)
      columns in the drones' order;
    * ``export(s, template) -> KinState``.

    ``backend="auto"`` applies ``select_swarm_backend`` to ``init_pos`` (an
    (N, 3) array or tensor, or the KinState about to be passed to ``init``);
    without it, auto picks ``"soa"``.

    * ``"soa"``: the dense SoA step (``ops/swarm_soa.make_swarm_step_soa``;
      ``z_sort`` passes through), for fleets up to about 16k drones and
      dense packs where most pairs interact. With ``sorted=True`` the
      persistently sorted loop (``make_sorted_swarm``; ``order``,
      ``resort_every``, ``neighbor_cap``, ``bt``, ``bs`` pass through).
    * ``"binned"``: the padded xy-cell layout, O(N k) pair work
      (``ops/swarm_binned.make_binned_swarm``), for spread fleets at scale.
      Its geometry comes from ``init_pos`` (``binned_geometry``; its options
      pass through) or from explicit ``cell_size``/``nx``/``ny``/``cap``,
      which win over the computed ones. With ``mesh`` (a
      ``runtime/mesh.Mesh``) the slot axis is split over the ranks in
      whole-cell slabs: ``ny`` grows until the cells divide over them.

    ``device=None`` means the CUDA card, whose kernels are built here."""
    pos = _positions(init_pos)
    if backend == "auto":
        backend = select_swarm_backend(pos, mesh=mesh)
    if backend == "binned":
        geo = {k: backend_opts.pop(k) for k in _GEOMETRY if k in backend_opts}
        if len(geo) < len(_GEOMETRY):
            if pos is None:
                raise ValueError("binned backend needs init_pos (or explicit "
                                 "cell_size/nx/ny/cap) to size the cell grid")
            auto = dict(zip(_GEOMETRY, binned_geometry(
                pos, **{k: backend_opts.pop(k) for k in _GEOMETRY_OPTS if k in backend_opts})))
            geo = {**auto, **geo}
            if mesh is not None:
                while (geo["nx"] * geo["ny"]) % mesh.shape[axis] != 0:
                    geo["ny"] += 1  # whole-cell slabs on every rank
        return make_binned_swarm(params, dt, n_substeps, collisions=collisions, device=device,
                                 mesh=mesh, axis=axis, **geo, **backend_opts)
    if backend != "soa":
        raise ValueError(f"unknown swarm backend {backend!r}")
    if mesh is not None:
        raise ValueError("the dense soa backend does not shard the drone axis; use "
                         "backend='binned' (or make_sharded_swarm_physics for the AoS "
                         "rectangular path)")
    if backend_opts.pop("sorted", False):
        return make_sorted_swarm(params, dt, n_substeps, collisions=collisions, device=device,
                                 **backend_opts)
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


def make_sharded_swarm_physics(mesh: Mesh, params: DroneParams, dt, n_substeps: int,
                               physics: Physics = Physics.PYB_DW, axis: str = "env",
                               collisions: bool = False, pallas: bool = False, z_sort=None,
                               device=None):
    """Build ``step(kin, rpm, last_rpm) -> (kin, last_rpm)`` over this rank's
    slab of the drones (``shard_swarm_kin``), coupled to the other ranks'
    through the downwash and, with ``collisions``, the drone-drone contact.

    It matches ``core.dynamics.step_physics`` for the PYB modes (with the
    previous action's drag); ``Physics.DYN`` has no cross-drone term, so it
    needs no mesh. Every substep all-gathers the positions for the wake and,
    after the integration (the dense pipeline's order), the positions and
    velocities for the contact: ``n_substeps * N * 3`` floats a control step
    without contact, three times that with it.

    ``pallas`` (the JAX keyword): the cross-rank pair terms go through the
    pair passes' rectangular entries, local targets against the gathered
    sources, O(N) memory: K2 (``ops/downwash_pairs.py``) whose wake enters
    ``substep_pyb`` through ``dw_force_body_z``, and K4
    (``ops/collide_pairs.py``) after the substep, on a card; their plain
    versions on the CPU. ``z_sort`` passes through to them. Otherwise the
    dense (N/D, N) terms of ``core/aero`` and ``core/collisions`` with
    ``other_pos``. ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    if axis != mesh.axis_name:
        raise ValueError(f"mesh has axis {mesh.axis_name!r}, not {axis!r}")
    flags = dict(_PYB_FLAGS[physics])
    use_dw = flags.pop("dw")
    gather = lambda x: all_gather(mesh, x)
    if pallas:
        opts = dict(z_sort=z_sort, device=device)
        dw_fn = make_downwash(params, **opts) if use_dw else None
        collide_fn = make_collide(params, return_delta=True, **opts) if collisions else None

    def step(kin: KinState, rpm, last_rpm):
        if kin.pos.device.type != device.type:
            raise ValueError(f"this swarm step was built for {device}; state is on "
                             f"{kin.pos.device}")
        for _ in range(n_substeps):
            if pallas:
                mag = dw_fn(kin.pos, src_pos=gather(kin.pos)) if use_dw else None
                kin = substep_pyb(kin, rpm, last_rpm, params, dt, dw=False,
                                  dw_force_body_z=mag, **flags)
            else:
                kin = substep_pyb(kin, rpm, last_rpm, params, dt, dw=use_dw,
                                  dw_src_pos=gather(kin.pos) if use_dw else None, **flags)
            if collisions:
                # contact on the post-integration kinematics, as in the dense
                # substep: the stepped fleet is gathered, then this slab is
                # projected against it
                gpos, gvel = gather(kin.pos), gather(kin.vel)
                if pallas:
                    dpos, dvel = collide_fn(kin.pos, kin.vel, src_pos=gpos, src_vel=gvel)
                    kin = kin.replace(pos=kin.pos + dpos, vel=kin.vel + dvel)
                else:
                    new_pos, new_vel = resolve_drone_collisions(
                        kin.pos, kin.vel, params.collision_r, other_pos=gpos, other_vel=gvel)
                    kin = kin.replace(pos=new_pos, vel=new_vel)
            last_rpm = rpm
        return kin, last_rpm

    return step


def shard_swarm_kin(mesh: Mesh, kin: KinState, axis: str = "env") -> KinState:
    """This rank's slab of a KinState (leading drone axis)."""
    sh = env_sharding(mesh, axis)
    return kin.map(lambda x: x[sh.rows(x.shape[0])])
