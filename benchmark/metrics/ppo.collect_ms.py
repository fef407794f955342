"""ppo.collect_ms: the rollout half of a train step (``collect``), mean over
the window's train steps, from CUDA events recorded around the call."""

import statistics


def read(run):
    xs = run.samples.get("collect_ms")
    return statistics.fmean(xs) if xs else None
