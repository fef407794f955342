"""A ``torch.profiler`` trace of a short part of a run, read into device
intervals.

``profiled(label, fn)`` runs ``fn`` under the profiler (CUDA activity only:
the device's kernels, memsets and copies; on a machine without a card, CPU
activity, which holds no device operation) and returns the part: its host
window and the device operations, each ``(name, start, end)`` in seconds on
the host's wall clock (``time.time_ns``, the clock kineto stamps its events
with): the Chrome trace is written to a temporary file and read back.
"""

import json
import os
import re
import tempfile
import time

import torch

DEVICE_KINDS = ("kernel", "gpu_memset", "gpu_memcpy")


def _device_ops(prof):
    """The device operations of the Chrome trace, ``(name, start, end)`` in
    seconds on the wall clock: event times count from the trace's
    ``baseTimeNanoseconds`` where it gives one."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    base = trace.get("baseTimeNanoseconds", 0) * 1e-9
    out = []
    for e in trace["traceEvents"]:
        if e.get("cat") in DEVICE_KINDS:
            start = base + e["ts"] * 1e-6
            out.append((short_name(e["name"]), start, start + e.get("dur", 0) * 1e-6))
    return out


_PART = re.compile(r"(\w*(?:Functor|functor|_kernel|_impl|Copy|gemm|Kernel)\w*)")


def short_name(name):
    """A kernel's name without its template arguments, with the innermost
    functor or kernel named inside them: ``vectorized_elementwise_kernel[MulFunctor]``."""
    name = name.replace("(anonymous namespace)::", "")
    head, _, rest = name.partition("<")
    head = head.split("(", 1)[0].replace("void ", "").strip().rsplit("::", 1)[-1]
    inner = [x for x in _PART.findall(rest.split(">(", 1)[0]) if x != head]
    return f"{head}[{inner[-1]}]" if inner else head


def profiled(label, fn):
    """Run ``fn()`` under the profiler, ending with a synchronize; returns
    ``dict(label, start, end, ops)``, the host window in wall-clock seconds
    and the device operations."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        start = time.time_ns() * 1e-9
        fn()
        sync()
        end = time.time_ns() * 1e-9
    ops = _device_ops(prof)
    if ops and (max(b for _, _, b in ops) < start or min(a for _, a, _ in ops) > end):
        # the trace's clock is not the wall clock: the window ends in a
        # synchronize, so its last device operation ends with it
        shift = end - max(b for _, _, b in ops)
        ops = [(n, a + shift, b + shift) for n, a, b in ops]
    return dict(label=label, start=start, end=end, ops=ops)
