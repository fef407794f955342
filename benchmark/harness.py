"""Runs one cell: finds its files by name, drives set-up, the measured
window, the traced part and the check, and assembles the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its traffic file
``workloads/<traffic>.json`` names the driver (``drivers/<driver>.py``), the
traffic parameters, and what the check samples and its limits; its
configuration is ``configs/<config>.json``. The metrics a run reports are
the entries of ``BENCHMARK.json`` that apply to the cell (all cells, or
those listed under an entry's ``workloads``): its ``end_to_end`` metrics
with ``--trace 0``, its ``per_layer`` metrics with ``--trace 1``, each
read from the run's record by ``metrics/<name>.py``. A reader that finds
nothing returns None and the metric is left out of the line.
"""

import copy
import importlib
import importlib.util
import json
import os
import sys
import time

from benchmark import stats

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FOREIGN = ("jax", "jaxlib", "flax", "gym_pybullet_drones_tpu")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries put in, nested groups merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class Cell:
    """One cell: its entry (``name``, ``config``, ``traffic``, ``chips``) with
    its files, and the metric entries that apply to it."""

    def __init__(self, entry, end_to_end=(), per_layer=(), bench_dir=BENCH):
        self.name, self.chips, self.bench_dir = entry["name"], int(entry["chips"]), bench_dir
        self.workload = load_json(os.path.join(bench_dir, "workloads",
                                               f"{entry['traffic']}.json"))
        self.config = load_json(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
        self.end_to_end, self.per_layer = list(end_to_end), list(per_layer)


def load_cell(name, root=ROOT, bench_dir=BENCH) -> Cell:
    """The entry ``name`` of ``BENCHMARK.json``'s ``workloads``, with the
    metrics that apply to it (all cells, or those listed under an entry's
    ``workloads``)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    applies = lambda m: name in m.get("workloads", [name])
    return Cell(entries[name], [m for m in spec["end_to_end"] if applies(m)],
                [m for m in spec["per_layer"] if applies(m)], bench_dir)


def files_cell(traffic, config, bench_dir=BENCH) -> Cell:
    """A one-chip cell of ``workloads/<traffic>.json`` and
    ``configs/<config>.json`` that ``BENCHMARK.json`` need not name, with no
    metrics: for the readings of a check and the tests."""
    return Cell(dict(name=traffic, config=config, traffic=traffic, chips=1), bench_dir=bench_dir)


def driver(name):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name, bench_dir=BENCH):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """The context of one run and its record, which drivers fill and metric
    readers read. ``overrides`` (tests only) merges into the configuration
    (``config``) and the traffic file (``workload``)."""

    def __init__(self, cell: Cell, seed, device, started, overrides=None):
        import torch

        overrides = overrides or {}
        self.cell, self.seed, self.started = cell, int(seed), started
        self.device = torch.device(device)
        self.config = merge(cell.config, overrides.get("config"))
        self.workload = merge(cell.workload, overrides.get("workload"))
        self.traffic, self.check_spec = self.workload["traffic"], self.workload["check"]
        self.state = {}  # the driver's own
        self.setup_s = None
        self.window_s = None
        self.attempted = 0  # units of work the window started (calls, steps, train steps)
        self.completed = 0
        self.work = {}  # counts of completed work, by name
        self.samples = {}  # host-clock samples, by name
        self.parts = []  # traced parts (trace.profiled)
        self.checks = {}  # name -> (value, limit)
        self.info = {}  # numbers reported beside the checks, not compared
        self.memory_peak = 0

    @property
    def cuda(self):
        return self.device.type == "cuda"

    def fence(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)


def trace_summary(parts):
    """busy and window seconds, the device operations and the breakdown of
    traced parts."""
    busy = window = 0.0
    by_name, gaps, n_ops = {}, [], 0
    for p in parts:
        lo, hi = p["start"], p["end"]
        iv = [(max(a, lo), min(b, hi)) for _, a, b in p["ops"] if b > lo and a < hi]
        busy += stats.busy_union(iv)
        window += hi - lo
        n_ops += len(p["ops"])
        for name, a, b in p["ops"]:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        gaps += [(b - a, p["label"]) for a, b in stats.idle_gaps(iv, lo, hi)]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps, reverse=True)[:10]
    return dict(busy_s=busy, window_s=window, ops=n_ops,
                breakdown=dict(device_ops=[[n, s] for n, s in top],
                               idle_gaps=[[label, s] for s, label in gaps]))


def run_cell(cell: Cell, seed, seconds, trace, device, started, overrides=None):
    """Set-up, the window, (with ``trace``) the traced part, the check; returns
    ``(result, run)``."""
    import torch

    run = Run(cell, seed, device, started, overrides)
    drv = driver(run.workload["driver"])
    drv.setup(run)
    run.fence()
    run.setup_s = time.perf_counter() - started
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    drv.window(run, float(seconds))
    if trace:
        run.parts = drv.traced(run)
    run.fence()
    if run.cuda:
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    t_check = time.perf_counter()
    drv.check(run)
    run.info["check_s"] = time.perf_counter() - t_check
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for e in entries:
        value = metric_reader(e["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[e["name"]] = dict(value=float(value), unit=e["unit"])
    dev = dict(platform="gpu" if run.cuda else "cpu",
               kind=torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
               count=1, memory_peak_bytes=run.memory_peak)
    result = dict(correct=False, attempted=run.attempted,
                  failed=run.attempted - run.completed, metrics=metrics, device=dev)
    if trace:
        summary = trace_summary(run.parts)
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    result["correct"] = bool(run.checks) and run.completed > 0 \
        and result["failed"] == 0 and all(v <= lim for v, lim in run.checks.values())
    result["checks"] = {k: dict(value=v, limit=lim) for k, (v, lim) in run.checks.items()}
    return result, run


def foreign_modules():
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def readings(cell: Cell, seed, seconds, device, kind, overrides=None):
    """The numbers the check compares, for setting its limits: of the program
    (``kind="program"``), of the program with its TF32 path switched on
    (``"program_tf32"``), or of the reference computed in TF32 in the
    program's place (``"reference_tf32"``). A short window at the cell's
    load first, as the check's samples come from it. Returns ``{name: value}``
    and the run."""
    import torch

    run = Run(cell, seed, device, time.perf_counter(), overrides)
    drv = driver(run.workload["driver"])
    torch.backends.cuda.matmul.allow_tf32 = kind == "program_tf32"
    try:
        drv.setup(run)
        drv.window(run, float(seconds))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    (drv.control if kind == "reference_tf32" else drv.check)(run)
    return {k: v for k, (v, _) in run.checks.items()}, run
