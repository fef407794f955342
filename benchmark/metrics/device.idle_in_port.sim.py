"""device.idle_in_port.sim: the share of the traced parts' wall time in
which no kernel, memset or copy ran on the card while the host was inside
one of the port's spans (``runtime/profiling.py``, the same wall clock as
the trace), in %. At most ``device.idle.sim``: the rest of that idle time
the host spent in the caller."""

from benchmark import stats


def read(run):
    from gym_pybullet_drones_tpu_torch.runtime import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None or not any(p["ops"] for p in run.parts):
        return None
    idle_in = window = 0.0
    found = False
    for p in run.parts:
        lo, hi = p["start"], p["end"]
        window += hi - lo
        inside = [(1e-9 * t0, 1e-9 * t1)
                  for _, t0, t1 in spans(int(lo * 1e9), int(hi * 1e9))]
        found = found or bool(inside)
        busy = [(max(a, lo), min(b, hi)) for _, a, b in p["ops"] if b > lo and a < hi]
        for a, b in stats.idle_gaps(busy, lo, hi):
            idle_in += stats.busy_union([(max(s, a), min(e, b)) for s, e in inside
                                         if e > a and s < b])
    if not found or not window:
        return None
    return 100.0 * idle_in / window
