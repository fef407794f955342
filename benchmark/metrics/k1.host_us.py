"""k1.host_us: the host time of a call of K1's launcher
(``ops/velocity_rollout.velocity_rollout_cuda``: the column checks, the
stack, the constants, the launch, the returned views), in us: the mean of
the port's ``k1.call`` spans (``runtime/profiling.py``) that lie inside the
traced parts. Read under the traced part's ``torch.profiler``, so it holds
the profiler's own work on the launcher's torch ops; the span's
``record_function`` annotation lies outside its stamps."""


def read(run):
    from gym_pybullet_drones_tpu_torch.runtime import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    durs = [t1 - t0 for p in run.parts
            for name, t0, t1 in spans(int(p["start"] * 1e9), int(p["end"] * 1e9))
            if name == "k1.call"]
    return 1e-3 * sum(durs) / len(durs) if durs else None
