"""Profiling helpers (port of the JAX ``runtime/profiling.py``).

The reference's only instrumentation is render()'s wall-clock and sim-time
printout (BaseAviary.py:404-406) and sleep-based pacing (utils.py:10-29).
Here: a ``torch.profiler`` trace written as a Chrome trace, items/s of a
state-threading step fenced on the device it ran on, and a realtime-factor
report with the reference's semantics.
"""

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a card
    is present) and write ``log_dir/trace.json``, a Chrome trace (Perfetto,
    ``chrome://tracing``). The profiler is yielded, so the caller can read
    ``key_averages()`` too."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def _fence(state):
    """Wait for the work behind ``state``: a CUDA synchronize when any of its
    tensors lies on a card; nothing on the CPU, where PyTorch runs eagerly."""
    if any(t.is_cuda for t in _leaves(state)):
        torch.cuda.synchronize()


def measure_throughput(step_fn: Callable, state, *args, iters: int = 10, warmup: int = 2,
                       items_per_call: int = 1):
    """items/s of a state-threading step ``state' = step(state, *args)`` (or
    ``(state', ...)``). Warms up first, then times ``iters`` chained calls
    with one fence at the end. Returns ``(rate, state)``."""
    for _ in range(warmup):
        out = step_fn(state, *args)
        state = out[0] if isinstance(out, tuple) else out
    _fence(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step_fn(state, *args)
        state = out[0] if isinstance(out, tuple) else out
    _fence(state)
    dt = time.perf_counter() - t0
    return items_per_call * iters / dt, state


class RealtimeMonitor:
    """Accumulates sim time against wall time (BaseAviary.render's realtime
    factor)."""

    def __init__(self, sim_freq_hz: float):
        self.sim_freq_hz = sim_freq_hz
        self.start = time.time()
        self.sim_steps = 0

    def add_steps(self, n: int):
        self.sim_steps += n

    @property
    def sim_time(self) -> float:
        return self.sim_steps / self.sim_freq_hz

    @property
    def wall_time(self) -> float:
        return time.time() - self.start

    @property
    def realtime_factor(self) -> float:
        w = self.wall_time
        return self.sim_time / w if w > 0 else 0.0

    def report(self) -> str:
        return (f"wall-clock time {self.wall_time:.1f}s, "
                f"simulation time {self.sim_time:.1f}s@{self.sim_freq_hz:.0f}Hz "
                f"({self.realtime_factor:.2f}x)")
