"""Carry parameters and state across from the JAX package as numpy arrays.

The JAX records' fields, read with ``np.asarray(getattr(record, field))``,
become the port's records here, so both packages compute from identical
inputs. The ``*_to_numpy`` functions read any record with the same field
names (the port's or the JAX package's), so one comparison serves both.
This module imports no JAX.
"""

import dataclasses

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device, resolve_dtype
from gym_pybullet_drones_tpu_torch.control.dsl_pid import DSLPIDParams, DSLPIDState
from gym_pybullet_drones_tpu_torch.core.dynamics import KinState
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.envs.base import AviaryState

_KIN = tuple(f.name for f in dataclasses.fields(KinState))
_CTRL = tuple(f.name for f in dataclasses.fields(DSLPIDState))
# The flat field names of an AviaryState: kinematics, last action, controller
# memory, RL action buffer and the substep counter.
AVIARY_STATE_FIELDS = _KIN + ("last_rpm",) + _CTRL + ("action_buffer", "step_count")


def _np(x) -> np.ndarray:
    """A writable numpy copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def _tensor(v, dtype, device):
    v = np.array(v)  # a writable copy: JAX hands out read-only buffers
    if np.issubdtype(v.dtype, np.integer):
        return torch.as_tensor(v, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _record(cls, d, dtype, device):
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    return cls(**{f.name: _tensor(d[f.name], dtype, device) for f in dataclasses.fields(cls)})


def drone_params_from_numpy(d: dict, device=None, dtype=torch.float32) -> DroneParams:
    """DroneParams from {field: numpy array}; integer fields keep their type."""
    return _record(DroneParams, d, dtype, device)


def dsl_pid_params_from_numpy(d: dict, device=None, dtype=torch.float32) -> DSLPIDParams:
    """DSLPIDParams from {field: numpy array}."""
    return _record(DSLPIDParams, d, dtype, device)


def aviary_state_from_numpy(d: dict, device=None, dtype=torch.float32) -> AviaryState:
    """AviaryState from the flat dict of ``AVIARY_STATE_FIELDS``."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    t = lambda k: _tensor(d[k], dtype, device)
    return AviaryState(
        kin=KinState(**{k: t(k) for k in _KIN}),
        last_rpm=t("last_rpm"),
        ctrl=DSLPIDState(**{k: t(k) for k in _CTRL}),
        action_buffer=t("action_buffer"),
        step_count=torch.as_tensor(np.array(d["step_count"], dtype=np.int32),
                                   device=device),
    )


def record_to_numpy(record) -> dict:
    """{field: numpy array} of a flat parameter record (either package's)."""
    return {f.name: _np(getattr(record, f.name)) for f in dataclasses.fields(record)}


def aviary_state_to_numpy(state) -> dict:
    """The flat dict of ``AVIARY_STATE_FIELDS`` of an AviaryState (either package's)."""
    out = {k: _np(getattr(state.kin, k)) for k in _KIN}
    out.update({k: _np(getattr(state.ctrl, k)) for k in _CTRL})
    for k in ("last_rpm", "action_buffer", "step_count"):
        out[k] = _np(getattr(state, k))
    return out
