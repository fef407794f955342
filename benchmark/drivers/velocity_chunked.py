"""Back-to-back calls of the port's VelocityAviary rollout
(``ops/velocity_rollout.make_velocity_rollout``: kernel K1 on the card).

Each call flies every env ``control_steps_per_call`` control steps from the
reset state under one formation command of ``traffic.FormationHeadings``
(turned compass headings, the compass unturned, or hover, in an order drawn
from the seed), as a scripted formation sweep or a data-generation run
does; at most ``max_in_flight`` calls are queued on the device. The outputs
of one call in ``keep_every``, at a phase drawn from the seed, are kept for
the check.

Check: the state columns the timed calls returned, for ``calls`` kept calls
(drawn from the seed, each command in turn) and ``rows_per_call`` envs of
each, against the frozen float32 reference (``reference/velocity.py``) run
over the same rows and commands on the same device. The rows are drawn one
from each of ``calls x rows_per_call`` equal strata of the envs, so that the
checked calls together look into every part of the grid. The reference
repeats the kernel's arithmetic operation for operation, and the rollout
loop is closed through a PID whose derivative term amplifies rounding (a
float32 run parts from a float64 one by millimetres and hundreds of RPM
within one simulated second), so the comparison is exact:
``values_differing``, the state values that differ in any bit, has the
limit 0. A K1 that rounds otherwise (contracted multiply-adds, sums in
another order) fails it however accurate it is.
"""

import contextlib
import time
from collections import deque

import numpy as np
import torch

from benchmark import trace, traffic
from benchmark.reference import params as refparams
from benchmark.reference import velocity as ref


def _geometry(run):
    env = run.config["env"]
    nsub = env["pyb_freq"] // env["ctrl_freq"]
    return (refparams.velocity_consts(run.config), 1.0 / env["ctrl_freq"],
            1.0 / env["pyb_freq"], nsub, refparams.f32(refparams.speed_limit(run.config)))


def setup(run):
    from gym_pybullet_drones_tpu_torch.ops.velocity_rollout import make_velocity_rollout

    E, T = int(run.config["env"]["num_envs"]), int(run.traffic["control_steps_per_call"])
    rollout = make_velocity_rollout(*_geometry(run), T, device=run.device)
    start = ref.reset_columns(run.config, E, torch.float32, run.device)
    heads = traffic.FormationHeadings(run.traffic, E, run.seed, run.device)
    every = int(run.check_spec["keep_every"])
    phase = int(traffic.rng(run.seed, 5).integers(0, every))
    keep = (np.arange(traffic.MAX_CALLS) + phase) % every == 0
    run.state.update(rollout=rollout, start=start, heads=heads, keep=keep, kept={}, E=E, T=T)
    # warm-up: one call of the window's shape (K1 has one shape a cell)
    rollout(start, heads.action(0))


def _calls(run, first, until):
    """Calls from index ``first`` until ``until()`` says stop; returns the
    index after the last."""
    st = run.state
    rollout, start, heads = st["rollout"], st["start"], st["heads"]
    in_flight, k = deque(), first
    while True:
        out = rollout(start, heads.action(k))
        if st["keep"][k]:
            st["kept"][k] = out
        if run.cuda:
            ev = torch.cuda.Event()
            ev.record()
            in_flight.append(ev)
            if len(in_flight) > int(run.traffic["max_in_flight"]):
                in_flight.popleft().synchronize()
        k += 1
        if until(k):
            break
    run.fence()
    return k


def window(run, seconds):
    st = run.state
    run.fence()
    t0 = time.perf_counter()
    k = _calls(run, 0, lambda k: time.perf_counter() - t0 >= seconds)
    run.window_s = time.perf_counter() - t0
    run.attempted = run.completed = k
    run.work["drone_steps"] = k * st["E"] * st["T"]
    st["next_call"] = k


def traced(run):
    st = run.state
    n = int(run.workload["trace"]["calls"])
    first = st["next_call"]

    def calls():
        st["next_call"] = _calls(run, first, lambda k: k >= first + n)

    part = trace.profiled("k1_calls", calls)
    part["calls"] = n
    return [part]


def _rows(r, E, n_calls, per_call):
    """The rows checked in each of ``n_calls`` calls: ``E`` split into
    ``n_calls x per_call`` equal strata, call ``j`` drawing one row from each
    of strata ``j, j + n_calls, ...``; uniform draws where ``E`` is smaller."""
    n = n_calls * per_call
    if E < n:
        return [r.choice(E, size=min(per_call, E), replace=False) for _ in range(n_calls)]
    width = E // n
    return [(np.arange(per_call) * n_calls + j) * width + r.integers(0, width, size=per_call)
            for j in range(n_calls)]


def _sample(run):
    """The kept calls and rows drawn from the seed: ``(program's columns,
    their commands)``, each a dict of (n,) columns; frees the program's state."""
    st = run.state
    spec, heads = run.check_spec, st["heads"]
    r = traffic.rng(run.seed, 6)
    groups = {}
    for c in sorted(st["kept"]):
        groups.setdefault(heads.kind(c), []).append(c)
    groups = [list(r.permutation(groups[k])) for k in sorted(groups)]
    calls, want = [], int(spec["calls"])
    while len(calls) < want and any(groups):
        for g in groups:
            if g and len(calls) < want:
                calls.append(int(g.pop()))
    calls.sort()
    rows = [torch.as_tensor(rw, device=run.device)
            for rw in _rows(r, st["E"], len(calls), int(spec["rows_per_call"]))]
    got = {k: torch.cat([st["kept"][c][k][rw] for c, rw in zip(calls, rows)])
           for k in ref.SOA_KEYS}
    act = {k: torch.cat([heads.action(c)[k][rw] for c, rw in zip(calls, rows)])
           for k in ref.ACTION_KEYS}
    run.info.update(calls_checked=len(calls),
                    commands_checked=[heads.kind(c) for c in calls],
                    values_checked=sum(len(rw) for rw in rows) * len(ref.SOA_KEYS))
    st.clear()  # the program's state is freed before the reference runs
    if run.cuda:
        torch.cuda.empty_cache()
    return got, act


def _compare(run, got, act):
    n = len(act["ax"])
    start = ref.reset_columns(run.config, n, torch.float32, run.device)
    want = reference_rollout(run, start, act)
    differ = 0
    for k in ref.SOA_KEYS:
        a, b = got[k], want[k]
        differ += int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())
    run.checks["values_differing"] = (differ, 0)
    run.info["max_gap"] = max(float((got[k].double() - want[k].double()).abs().max())
                              for k in ref.SOA_KEYS)


def check(run):
    if not run.state["kept"]:
        run.checks["values_differing"] = (float("inf"), 0)
        return
    _compare(run, *_sample(run))


def control(run):
    """The reference computed in TF32 in the program's place."""
    from benchmark.reference.tf32 import TF32

    if not run.state["kept"]:
        run.checks["values_differing"] = (float("inf"), 0)
        return
    _, act = _sample(run)
    n = len(act["ax"])
    start = ref.reset_columns(run.config, n, torch.float32, run.device)
    _compare(run, reference_rollout(run, start, act, mode=TF32()), act)


def reference_rollout(run, start, act, mode=None):
    """The reference's rollout of ``start`` under ``act``, ``T`` steps;
    ``mode`` (a ``TorchDispatchMode``) wraps it, for the control."""
    T = int(run.traffic["control_steps_per_call"])
    with mode or contextlib.nullcontext():
        return ref.rollout(*_geometry(run), T, start, act, graph=run.cuda)
