"""Placement over several processes: sharded env batches and the sharded
swarm's collectives (port of the JAX ``runtime/mesh.py`` over
``torch.distributed``).

The reference is one process (SURVEY §2.3). The port scales along the same
two data axes as the JAX package:

* the env axis: independent env instances, each rank stepping its own slice
  of the batch with no collective;
* the drone axis of one swarm: each rank holds a slab of the drones, and the
  cross-drone terms (downwash, BaseAviary.py:798-811; the adjacency matrix,
  :658-675; contact) read every drone through an all-gather.

JAX's mesh is a global array layout that XLA partitions; here a ``Mesh`` is
a small record of the process group, this process's rank, the group's size
and the axis name, and every rank holds only its own slice. Gloo serves
CPU tensors, NCCL CUDA tensors (``init_distributed`` picks by the card's
presence). The collectives are written out where JAX's ``shard_map``
inserts them: ``all_gather`` below.
"""

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from gym_pybullet_drones_tpu_torch._struct import TensorStruct
from gym_pybullet_drones_tpu_torch.core import aero
from gym_pybullet_drones_tpu_torch.envs.base import AviaryConfig, AviaryState
from gym_pybullet_drones_tpu_torch.runtime.rollout import make_batched_step


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join ``num_processes`` processes into one ``torch.distributed`` group
    at ``coordinator_address`` (``host:port``, e.g. ``localhost:29500``), as
    rank ``process_id``. ``backend`` defaults to NCCL where a CUDA card is
    present, else gloo. No-op without ``num_processes``; a one-process group
    is formed when asked for (the collectives then copy)."""
    if num_processes is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id or 0))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's mesh: one axis over the ranks of a process group, this
    process's rank and the group's size."""

    group: object  # a torch.distributed ProcessGroup; None is the default group
    rank: int
    size: int
    axis_name: str = "env"

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, as ``jax.sharding.Mesh.shape`` reads."""
        return {self.axis_name: self.size}


def make_mesh(axis_names: Sequence[str] = ("env",), group=None) -> Mesh:
    """A one-axis mesh over the initialized process group (or ``group``)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call init_distributed first")
    if len(axis_names) != 1:
        raise NotImplementedError("the port's meshes have one axis, over every rank")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), axis_names[0])


def _check_axis(mesh: Mesh, axis: str):
    if axis != mesh.axis_name:
        raise ValueError(f"mesh has axis {mesh.axis_name!r}, not {axis!r}")


def all_gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank (JAX's ``all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    if x.dtype == torch.bool:  # not every backend reduces bools: move them as bytes
        return all_gather(mesh, x.view(torch.uint8), dim).view(torch.bool)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim)


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)


@dataclasses.dataclass(frozen=True)
class EnvSharding:
    """A leading axis split in equal contiguous slices over ``axis``."""

    mesh: Mesh
    axis: str = "env"

    def rows(self, n: int) -> slice:
        """This rank's slice of a length-``n`` axis."""
        _check_axis(self.mesh, self.axis)
        if n % self.mesh.size:
            raise ValueError(f"an axis of {n} does not split over {self.mesh.size} ranks")
        per = n // self.mesh.size
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)


def env_sharding(mesh: Mesh, axis: str = "env") -> EnvSharding:
    """The sharding that splits a leading env or batch axis over ``mesh``."""
    return EnvSharding(mesh, axis)


def _map_tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, TensorStruct):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return tree


def shard_env_batch(mesh: Mesh, tree, axis: str = "env"):
    """This rank's slice of a batched tree (leading env axis on every tensor
    leaf)."""
    sh = env_sharding(mesh, axis)
    return _map_tree(lambda x: x[sh.rows(x.shape[0])], tree)


def make_sharded_batched_step(cfg: AviaryConfig, params, ctrl_params, target_pos, mesh: Mesh,
                              axis: str = "env", auto_reset: bool = True):
    """The env-batch step of one rank's slice: the batch axis is wholly
    data-parallel, so this is ``make_batched_step`` on the local envs, with no
    collective. Per-env ``params`` must be the rank's slice
    (``shard_env_batch``)."""
    _check_axis(mesh, axis)
    return make_batched_step(cfg, params, ctrl_params, target_pos, auto_reset)


################################################################################
# The drone axis of one swarm spans the ranks.
################################################################################


def make_swarm_downwash_fn(mesh: Mesh, params, axis: str = "env"):
    """``fn(pos_local) -> (N/D,)``: the downwash on this rank's (N/D, 3) slab
    from every drone (BaseAviary.py:798-811 is a global pair sum): an
    all-gather of the positions, then the dense (N/D, N) pair terms."""
    _check_axis(mesh, axis)

    def local_dw(pos_local):
        return aero.downwash_forces_body_z(pos_local, params, pos_above=all_gather(mesh, pos_local))

    return local_dw


def make_swarm_adjacency_fn(mesh: Mesh, neighbourhood_radius, axis: str = "env"):
    """``fn(pos_local) -> (N/D, N)``: this rank's strip of the adjacency
    matrix (BaseAviary.py:658-675)."""
    _check_axis(mesh, axis)

    def local_adj(pos_local):
        pos_all = all_gather(mesh, pos_local)
        diff = pos_local[:, None, :] - pos_all[None, :, :]
        d = torch.sqrt(torch.sum(diff * diff, -1))
        # the self-distance is 0 < radius, so the diagonal is 1 as in the
        # reference (which adds the identity)
        return (d < neighbourhood_radius).to(pos_local.dtype)

    return local_adj


def shard_swarm_state(mesh: Mesh, state: AviaryState, axis: str = "env") -> AviaryState:
    """This rank's slab of a single aviary's state, the DRONE axis split.

    The kinematics, ``last_rpm``, the controller memory and the held camera
    frames carry the drone axis first; ``action_buffer`` is (B, N, A), with
    the drone axis second; ``step_count`` is kept whole."""
    sh = env_sharding(mesh, axis)
    first = lambda x: x if x.ndim == 0 else x[sh.rows(x.shape[0])]
    buf = state.action_buffer
    return state.replace(
        kin=state.kin.map(first), last_rpm=first(state.last_rpm), ctrl=state.ctrl.map(first),
        action_buffer=buf[:, sh.rows(buf.shape[1])] if buf.ndim >= 2 else buf,
        rgb_frames=None if state.rgb_frames is None else first(state.rgb_frames))
