"""device.idle.sim: the share of the traced part's wall time in which no
kernel, memset or copy ran on the card, in % (the union of their intervals
from the torch.profiler trace)."""

from benchmark.harness import trace_summary


def read(run):
    if not run.parts:
        return None
    s = trace_summary(run.parts)
    if not s["ops"] or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
