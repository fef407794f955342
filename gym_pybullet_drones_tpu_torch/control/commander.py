"""Mission planner on tensors: the high-level commander's twin (port of the JAX
``control/commander.py``).

Behavioral twin of the native bridge's crtp high-level commander
(``bridges/cffirmware/src/cffirm.cpp:502-619``, itself modeled on the
firmware ``crtp_commander_high_level.c``/``planner.c`` surface the reference
drives, gym_pybullet_drones/envs/CFAviary.py:422-433, :435-606): rest-to-rest
septic (7th-order) position blends with linear-in-s yaw, emitted as
full-state setpoints.

A whole mission (takeoff -> goto chain -> land, with holds) is compiled once
on the host into per-leg tensors (``plan_mission``), and
``mission_setpoint(legs, t)`` evaluates the piecewise polynomial directly: a
gather and a polynomial, with no host sync, so fleets fly whole missions
paired with ``control/mellinger.py``.

All leg leaves broadcast over leading batch axes: per-drone missions are
stacked leg tensors.
"""

import dataclasses

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import (
    TensorStruct,
    resolve_device,
    resolve_dtype,
)


@dataclasses.dataclass(frozen=True)
class MissionLegs(TensorStruct):
    """A chained piecewise septic plan. Leaves shaped (..., L) / (..., L, 3).

    Leg i is active on [t0[i], t0[i] + duration[i]); after the last leg ends
    the final position/yaw hold (tau clamps to 1, matching the C commander's
    clamp, cffirm.cpp:592)."""

    t0: torch.Tensor        # (..., L) leg start times [s]
    duration: torch.Tensor  # (..., L) leg durations [s], >= 1e-3
    p0: torch.Tensor        # (..., L, 3) start positions
    p1: torch.Tensor        # (..., L, 3) end positions
    yaw0: torch.Tensor      # (..., L) rad
    yaw1: torch.Tensor      # (..., L) rad


def plan_mission(init_pos, init_yaw, legs, dtype=torch.float32, device=None) -> MissionLegs:
    """Compile a waypoint list into chained rest-to-rest legs.

    ``legs`` is a sequence of dicts with keys:
      pos      : (..., 3) target position (None = hold current)
      yaw      : target yaw [rad] (None = keep)
      duration : leg flight time [s]
      hold     : optional extra hover time at the target after arrival [s]
    Each leg starts where (and when) the previous ended — the same chaining
    the C commander produces when TellState is fed the previous target
    (cffirm.cpp:512-533). Holds become explicit zero-length-displacement legs
    so velocity/acceleration are exactly zero during them.
    """
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    # Float64 numpy whatever the output dtype: leg start times are running
    # sums, and float32 sums would leak rounding into float64 missions (the
    # cast happens once, when the tensors are made).
    init_pos = np.asarray(init_pos, np.float64)
    batch = init_pos.shape[:-1]
    cur_p = init_pos
    cur_yaw = np.broadcast_to(np.asarray(init_yaw, np.float64), batch).copy()
    t = np.zeros(batch, np.float64)
    t0s, durs, p0s, p1s, y0s, y1s = [], [], [], [], [], []

    def emit(p1, yaw1, duration, advance=None):
        """Append a leg. ``advance``: per-drone time actually consumed
        (defaults to ``duration``); a mixed-batch hold leg floors its
        duration for the polynomial math but must NOT advance the clock of
        drones whose hold is 0 — their next leg starts at the same t0 and,
        sharing it, wins the is-started selection, so the phantom leg is
        never active for them."""
        nonlocal cur_p, cur_yaw, t
        duration = np.maximum(np.broadcast_to(np.asarray(duration, np.float64), batch), 1e-3)
        t0s.append(t.copy())
        durs.append(duration)
        p0s.append(cur_p.copy())
        p1s.append(np.broadcast_to(p1, batch + (3,)).astype(np.float64).copy())
        y0s.append(cur_yaw.copy())
        y1s.append(np.broadcast_to(yaw1, batch).astype(np.float64).copy())
        cur_p = p1s[-1]
        cur_yaw = y1s[-1]
        t = t + (duration if advance is None else advance)

    for leg in legs:
        p1 = cur_p if leg.get("pos") is None else np.asarray(leg["pos"], np.float64)
        yaw1 = cur_yaw if leg.get("yaw") is None else np.asarray(leg["yaw"], np.float64)
        emit(p1, yaw1, leg["duration"])
        hold = np.broadcast_to(np.asarray(leg.get("hold", 0.0), np.float64), batch)
        if np.any(hold > 0.0):
            emit(cur_p, cur_yaw, hold, advance=np.where(hold > 0.0, np.maximum(hold, 1e-3), 0.0))

    stack = lambda xs: torch.as_tensor(np.stack(xs, axis=len(batch)), dtype=dtype, device=device)
    return MissionLegs(t0=stack(t0s), duration=stack(durs), p0=stack(p0s),
                       p1=stack(p1s), yaw0=stack(y0s), yaw1=stack(y1s))


def septic_blend(tau):
    """Rest-to-rest septic s(tau) with s', s'', s''' = 0 at both ends and its
    first two derivatives (cffirm.cpp:577-584)."""
    t2 = tau * tau
    t3 = t2 * tau
    t4 = t3 * tau
    s = 35.0 * t4 - 84.0 * t4 * tau + 70.0 * t4 * t2 - 20.0 * t4 * t3
    ds = 140.0 * t3 - 420.0 * t4 + 420.0 * t4 * tau - 140.0 * t4 * t2
    dds = 420.0 * t2 - 1680.0 * t3 + 2100.0 * t4 - 840.0 * t4 * tau
    return s, ds, dds


def mission_setpoint(legs: MissionLegs, t):
    """Evaluate the mission at time ``t`` (a number or a tensor broadcastable
    to the batch), on the legs' device.

    Returns a dict of full-state setpoints shaped like the batch:
    ``pos``/``vel``/``acc`` (..., 3), ``yaw``/``yaw_rate`` (...,) [rad and
    rad/s], and ``quat`` (..., 4) xyzw (yaw-only, cffirm.cpp:608-612) — the
    fields ``mellinger_control`` consumes, MINDING ITS DEGREE INPUTS: pass
    yaw as ``sp_yaw_deg=torch.rad2deg(sp["yaw"])`` (or the quat as
    ``sp_quat``) and the rate as ``sp_rate_deg=[0, 0, deg(yaw_rate)]`` —
    feeding rad/s silently underweights the yaw damping term 57x.

    Before the first leg tau clamps to 0 (hold start); after the last, to 1
    (hold final target) — the C commander's clamp semantics.
    """
    t = torch.as_tensor(t, dtype=legs.t0.dtype, device=legs.t0.device)
    # Active leg: the last one whose start time has passed.
    started = (t[..., None] >= legs.t0).to(torch.int32)
    idx = torch.clamp(torch.sum(started, dim=-1, dtype=torch.int32) - 1, min=0)  # (...,)

    take = lambda a: torch.take_along_dim(a, idx[..., None].long(), dim=-1)[..., 0]
    take3 = lambda a: torch.take_along_dim(a, idx[..., None, None].long(), dim=-2)[..., 0, :]
    t0 = take(legs.t0)
    duration = take(legs.duration)
    p0, p1 = take3(legs.p0), take3(legs.p1)
    yaw0, yaw1 = take(legs.yaw0), take(legs.yaw1)

    tau = torch.clamp((t - t0) / duration, 0.0, 1.0)
    s, ds, dds = septic_blend(tau)
    inv_t = 1.0 / duration
    d = p1 - p0
    pos = p0 + d * s[..., None]
    vel = d * (ds * inv_t)[..., None]
    acc = d * (dds * inv_t * inv_t)[..., None]
    yaw = yaw0 + (yaw1 - yaw0) * s
    yaw_rate = (yaw1 - yaw0) * ds * inv_t
    half = 0.5 * yaw
    zero = torch.zeros_like(yaw)
    quat = torch.stack([zero, zero, torch.sin(half), torch.cos(half)], -1)
    return {"pos": pos, "vel": vel, "acc": acc, "yaw": yaw,
            "yaw_rate": yaw_rate, "quat": quat}


def mission_finished(legs: MissionLegs, t):
    """True once every leg has completed (crtpCommanderHighLevel
    IsTrajectoryFinished, cffirm.cpp:519-521)."""
    end = legs.t0[..., -1] + legs.duration[..., -1]
    return torch.as_tensor(t, dtype=legs.t0.dtype, device=legs.t0.device) >= end
