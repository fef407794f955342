"""What the port's spans (``_spans.py``) cost on the card's host, and the
host time of K1's launcher with and without a profiler, to compare two
versions of the PyTorch port on one card.

    PYTHONPATH=<tree> python3 scripts/torch_span_cost.py LABEL

Times the package found on the path, so run it once per tree, in turns (A,
B, B, A), in one run on one card. Prints one JSON line: the label,
nvidia-smi's name and power limit; whether the profiler's flags
(``torch.autograd._profiler_enabled()``, the thread's, and
``torch.autograd.profiler._is_profiler_enabled``, the process's) read true
under a profiler with CUDA activity alone, as the benchmark's traced part
records; the ns a ``with span(...)`` block adds with no profiler and under
that one (median of 5 loops, an empty loop's time taken off), and how many
``k1.call`` annotations the exported Chrome trace holds; and K1's launcher
at E = 4096 and 65536, T = 4800, two calls in flight as in the benchmark's
K1 cells, in us a call on the host clock around it: with no profiler
(``host_us_off``), under one (``host_us_on``), and under one with the spans
turned into the no-op (``host_us_on_nospan``: what the profiler alone adds),
each measured twice in turns over ``CALLS`` calls, and the mean ``k1.call``
span under the profiler. A tree without spans reports the host clock alone.
Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import deque

import torch
from torch.profiler import ProfilerActivity, profile

from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_VELOCITY,
    AviaryConfig,
    build_ctrl_params,
    build_params,
)
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as vr
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import ACTION_KEYS, soa_consts, soa_from_state
from gym_pybullet_drones_tpu_torch.runtime import profiling

try:
    from gym_pybullet_drones_tpu_torch import _spans
except ImportError:  # a tree without spans
    _spans = None
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset

SIZES = (4096, 65536)
T = 4800
CALLS = 100  # launches timed a measurement, after two
ROUNDS = 2  # turns of the three measurements


def cuda_profile():
    return profile(activities=[ProfilerActivity.CUDA])


def span_ns(n):
    """ns a ``with span("probe")`` block adds to an empty loop's iteration."""
    span = profiling.span

    def with_span():
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("probe"):
                pass
        return time.perf_counter_ns() - t

    def empty():
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return time.perf_counter_ns() - t

    return statistics.median((with_span() - empty()) / n for _ in range(5))


def case(E):
    cfg = AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    p, cp = build_params(cfg, "cpu"), build_ctrl_params(cfg, "cpu")
    sl = 0.03 * float(p.max_speed_kmh) * (1000.0 / 3600.0)
    args = (soa_consts(cp, p), cfg.ctrl_timestep, cfg.pyb_timestep, cfg.steps_per_ctrl, sl, T)
    soa = soa_from_state(batch_reset(cfg, p, E, device="cuda"))
    act = {k: torch.full((E,), 0.25 if k == "amag" else 0.0, device="cuda") for k in ACTION_KEYS}
    act["ax"] += 1.0
    return args, soa, act


def launcher_us(args, soa, act):
    """Host us a launcher call (host clock around it), two calls in flight."""
    host, in_flight = [], deque()
    for _ in range(CALLS + 2):
        t = time.perf_counter_ns()
        vr.velocity_rollout_cuda(*args, soa, act)
        host.append(time.perf_counter_ns() - t)
        ev = torch.cuda.Event()
        ev.record()
        in_flight.append(ev)
        if len(in_flight) > 2:
            in_flight.popleft().synchronize()
    torch.cuda.synchronize()
    return 1e-3 * statistics.fmean(host[2:])


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    has_spans = _spans is not None
    out = dict(label=label, card=torch.cuda.get_device_name(0), smi=smi, spans=has_spans)
    with cuda_profile():
        out["flags_under_cuda_profiler"] = [torch.autograd._profiler_enabled(),
                                            torch.autograd.profiler._is_profiler_enabled]
    out["flags_without"] = [torch.autograd._profiler_enabled(),
                            torch.autograd.profiler._is_profiler_enabled]
    if has_spans:
        out["span_ns_off"] = span_ns(1_000_000)
        with cuda_profile():
            out["span_ns_on"] = span_ns(5_000)
    for E in SIZES:
        args, soa, act = case(E)
        launcher_us(args, soa, act)  # build, load, first launch
        row = dict(host_us_off=[], host_us_on=[], host_us_on_nospan=[], k1_call_spans=0,
                   k1_host_us_span=[])
        for r in range(ROUNDS):
            row["host_us_off"].append(launcher_us(args, soa, act))
            with cuda_profile() as prof:
                start = time.time_ns()
                row["host_us_on"].append(launcher_us(args, soa, act))
                end = time.time_ns()
            if has_spans:
                calls = [t1 - t0 for n, t0, t1 in profiling.spans(start, end) if n == "k1.call"]
                row["k1_call_spans"] += len(calls)
                row["k1_host_us_span"].append(1e-3 * statistics.fmean(calls[2:]))
                if r == 0:
                    with tempfile.TemporaryDirectory() as tmp:
                        path = os.path.join(tmp, "trace.json")
                        prof.export_chrome_trace(path)
                        with open(path) as fh:
                            events = json.load(fh)["traceEvents"]
                    row["k1_call_annotations"] = sum(e.get("name") == "k1.call" for e in events)
                span, _spans.span = _spans.span, lambda name: _spans.OFF
            try:
                with cuda_profile():
                    row["host_us_on_nospan"].append(launcher_us(args, soa, act))
            finally:
                if has_spans:
                    _spans.span = span
        out[f"E{E}"] = row
    if has_spans:
        out["setup_spans"] = {n: 1e-9 * (t1 - t0) for n, t0, t1 in profiling.setup_spans()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
