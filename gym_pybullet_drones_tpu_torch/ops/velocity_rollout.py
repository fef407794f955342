"""Whole VelocityAviary rollout chunks: kernel K1 and its plain version.

``make_velocity_rollout`` builds ``rollout(soa, action) -> soa`` that advances
``num_steps`` control steps of ``velocity_step_soa``. The state keeps the JAX
package's layout at this boundary: a dict of (E,) float32 columns keyed by
``SOA_KEYS``, and the action a dict of (E,) columns ``ax, ay, az, amag``.

* On CUDA tensors it launches K1 (``csrc/velocity_rollout.cu``: one lane of
  a warp an env, the whole time loop in registers), which replaces the TPU kernel
  ``make_velocity_rollout_pallas`` (gym_pybullet_drones_tpu/ops/
  velocity_pallas.py). A failed build or launch raises.
* On CPU tensors it runs the plain version, a Python loop of
  ``velocity_step_soa``; the tests and ``chip_smoke.py`` hold K1 against it.

``velocity_rollout_counts`` launches K1's counting build
(``csrc/velocity_rollout_counts.cu``, a library of its own, built and loaded
at its first call; the main path never builds it) and returns how often K1's
step took a zero operand or a small angle inline and how often it fell back
to the library (``RN_COUNTS``).
"""

import ctypes
import functools
from typing import Dict

import torch

from gym_pybullet_drones_tpu_torch import _spans
from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.ops import _build
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import (
    ACTION_KEYS,
    SOA_KEYS,
    velocity_step_soa,
)

KERNEL = "velocity_rollout"
COUNTS_KERNEL = "velocity_rollout_counts"
# Whether this process has launched K1 (the set-up span ``k1.first_launch``):
# the span's own, as callers reset ``velocity_rollout_cuda.launches``.
_first_launch_done = False
# What K1's counting build counts (csrc/velocity_rollout_counts.cu, in this
# order), over all envs and control steps: divisions with a zero numerator,
# roots of a zero and atan2 of a zero y over a positive x, which its fast step
# takes inline (csrc/rn_math.cuh); the substeps' sines and cosines it takes
# without the reduction; divisions, roots, angles and atan2 operands outside
# the fast step's classes; and env-steps recomputed with the library.
RN_COUNTS = ("zero_numerator", "zero_radicand", "zero_atan2", "small_angle", "fallback",
             "replayed")


def velocity_rollout_plain(consts, ctrl_dt, pyb_dt, n_substeps, speed_limit, num_steps,
                           soa: Dict[str, torch.Tensor], action: Dict[str, torch.Tensor]):
    """The plain PyTorch version of K1: ``num_steps`` x ``velocity_step_soa``."""
    s = dict(soa)
    for _ in range(num_steps):
        s = velocity_step_soa(consts, ctrl_dt, pyb_dt, n_substeps, speed_limit, s,
                              action["ax"], action["ay"], action["az"], action["amag"])
    return s


def _pack_consts(consts, ctrl_dt, pyb_dt, speed_limit):
    """The kernel's constants, in the field order of ``VelConsts``. Products of
    two host constants are formed in double here, as the plain version's
    Python arithmetic forms them, then rounded once to float32."""
    c = consts
    vals = [*c["i_for"], *c["d_for"], *c["p_tor"], *c["i_tor"], *c["d_tor"],
            *(v for row in c["mixer"] for v in row),
            c["scale"], c["const"], c["min_pwm"], c["max_pwm"],
            4.0 * c["kf_c"], c["grav"],
            c["kf"], c["km"], c["yaw_sign"], c["m_"], c["g_"],
            *c["J"], *(pyb_dt * v for v in c["Jinv"]),
            *(v for row in c["offs"] for v in row),
            c["z_min"], ctrl_dt, pyb_dt, speed_limit]
    return (ctypes.c_float * len(vals))(*vals)


# The arguments both entry points begin with: in, out, E, the constants and
# their count, n_substeps, num_steps.
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int]


@functools.cache
def _library():
    """K1's library, whose one C entry point is ``velocity_rollout`` (the
    stream after ``_ARGS``), built at first use and typed
    once (the set-up span ``k1.load``: hashing the sources, nvcc where no
    library matches, loading it)."""
    with _spans.setup_span("k1.load"):
        lib = ctypes.CDLL(_build.build(KERNEL))
    lib.velocity_rollout.argtypes = _ARGS + [ctypes.c_void_p]
    lib.velocity_rollout.restype = ctypes.c_int
    return lib


@functools.cache
def _counts_library():
    """K1's counting build, whose one C entry point is
    ``velocity_rollout_counted`` (its counts buffer and the stream after
    ``_ARGS``), built and loaded at the first call of
    ``velocity_rollout_counts``."""
    lib = ctypes.CDLL(_build.build(COUNTS_KERNEL))
    lib.velocity_rollout_counted.argtypes = _ARGS + [ctypes.c_void_p, ctypes.c_void_p]
    lib.velocity_rollout_counted.restype = ctypes.c_int
    return lib


def _operands(soa, action, n_substeps, num_steps):
    """K1's checked operands: the packed (30, E) input, an empty (26, E)
    output and E."""
    cols = [soa[k] for k in SOA_KEYS] + [action[k] for k in ACTION_KEYS]
    E = cols[0].shape[0] if cols[0].ndim == 1 else -1
    device = cols[0].device
    for k, x in zip(SOA_KEYS + ACTION_KEYS, cols):
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"K1 takes CUDA tensors on one device; {k} is on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"K1 computes in float32 only; {k} is {x.dtype}")
        if x.ndim != 1 or x.shape[0] != E:
            raise ValueError(f"K1 takes (E,) columns of one length; {k} has shape "
                             f"{tuple(x.shape)}")
    if n_substeps < 0 or num_steps < 0:
        raise ValueError("n_substeps and num_steps must be non-negative")
    packed = torch.stack(cols)  # (30, E), contiguous
    out = torch.empty((len(SOA_KEYS), E), dtype=torch.float32, device=device)
    if not (packed.is_contiguous() and out.is_contiguous()):
        raise ValueError("K1 needs contiguous (30, E) input and (26, E) output")
    return packed, out, E


def velocity_rollout_cuda(consts, ctrl_dt, pyb_dt, n_substeps, speed_limit, num_steps,
                          soa: Dict[str, torch.Tensor], action: Dict[str, torch.Tensor]):
    """Launch K1 on CUDA float32 columns; ``velocity_rollout_cuda.launches``
    counts the launches. The call's host time is the span ``k1.call``; the process's first launch, where CUDA
    loads K1's module, the set-up span ``k1.first_launch``."""
    global _first_launch_done
    with _spans.span("k1.call"):
        packed, out, E = _operands(soa, action, n_substeps, num_steps)
        device = out.device
        fn = _library().velocity_rollout
        host = _pack_consts(consts, ctrl_dt, pyb_dt, speed_limit)
        first = not _first_launch_done
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            with _spans.setup_span("k1.first_launch") if first else _spans.OFF:
                rc = fn(packed.data_ptr(), out.data_ptr(), E, ctypes.addressof(host), len(host),
                        n_substeps, num_steps, stream)
        _first_launch_done = True
        if rc != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {rc}")
        velocity_rollout_cuda.launches += 1
        return {k: out[i] for i, k in enumerate(SOA_KEYS)}


velocity_rollout_cuda.launches = 0


def velocity_rollout_counts(consts, ctrl_dt, pyb_dt, n_substeps, speed_limit, num_steps,
                            soa: Dict[str, torch.Tensor],
                            action: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Run K1's counting build over the same operands as
    ``velocity_rollout_cuda`` and return its counts, ``RN_COUNTS``, over all
    envs and steps. Every operation of an env counts once; a recomputed
    step's operations count as its fast attempt met them, and ``replayed``
    counts env-steps recomputed with the library in warps of 32 envs (a warp
    recomputes a step for all of its envs). For tests and scripts: its
    library is built and loaded here, at the first call, and the main path
    never loads it."""
    packed, out, E = _operands(soa, action, n_substeps, num_steps)
    counts = torch.zeros(len(RN_COUNTS), dtype=torch.int64, device=out.device)
    host = _pack_consts(consts, ctrl_dt, pyb_dt, speed_limit)
    fn = _counts_library().velocity_rollout_counted
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(packed.data_ptr(), out.data_ptr(), E, ctypes.addressof(host), len(host),
                n_substeps, num_steps, counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K1 (counting build) launch failed: cudaError {rc}")
    return dict(zip(RN_COUNTS, counts.tolist()))


def make_velocity_rollout(consts, ctrl_dt, pyb_dt, n_substeps, speed_limit, num_steps: int,
                          device=None):
    """Build ``rollout(soa, action) -> soa`` advancing ``num_steps`` control
    steps. ``device=None`` means the CUDA card; on CUDA the kernel is built
    here, at first use. The rollout takes tensors on that device only:
    CUDA tensors launch K1, CPU tensors run the plain version."""
    device = resolve_device(device)
    if device.type == "cuda":
        _library()
    args = (consts, ctrl_dt, pyb_dt, n_substeps, speed_limit, num_steps)

    def rollout(soa: Dict[str, torch.Tensor], action: Dict[str, torch.Tensor]):
        got = soa[SOA_KEYS[0]].device
        if got.type != device.type:
            raise ValueError(f"this rollout was built for {device}; state is on {got}")
        if got.type == "cuda":
            return velocity_rollout_cuda(*args, soa, action)
        if got.type == "cpu":
            return velocity_rollout_plain(*args, soa, action)
        raise ValueError(f"no K1 path for device {got}")

    return rollout
