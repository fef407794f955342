"""env_step.launches.ppo: kernels and memsets a rollout control step, from
the trace of a whole ``collect`` (the env step's with the policy's sample
and GAE's share), over its control steps."""


def read(run):
    parts = [p for p in run.parts if p["label"] == "collect"]
    steps = sum(p["control_steps"] for p in parts)
    n = sum(1 for p in parts for _ in p["ops"])
    return n / steps if parts and n else None
