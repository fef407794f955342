"""env_step.launches.sim: kernels, memsets and copies a vector-env step,
from the trace of ``step()`` calls (the env step with its auto-reset, the
action's copy in and the outputs' copy out)."""


def read(run):
    parts = [p for p in run.parts if p["label"] == "vec_step"]
    steps = sum(p["control_steps"] for p in parts)
    n = sum(1 for p in parts for _ in p["ops"])
    return n / steps if parts and n else None
