"""ppo.update_ms: the update half of a train step (``update``), mean over
the window's train steps, from CUDA events recorded around the call."""

import statistics


def read(run):
    xs = run.samples.get("update_ms")
    return statistics.fmean(xs) if xs else None
