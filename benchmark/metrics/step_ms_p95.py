"""step_ms_p95: the 95th percentile of the time a ``step()`` call takes, from
the call to its numpy return (host clock), in ms. The host's clock is good to
about half a millisecond, so each sample is the mean step time of a run of
consecutive steps that together span at least ``SPAN_S``; the window's steps
fall into such runs in order, and a last run shorter than that is left out."""

from benchmark import stats

SPAN_S = 0.25


def read(run):
    groups, acc, n = [], 0.0, 0
    for dt in run.samples.get("step_s", []):
        acc, n = acc + dt, n + 1
        if acc >= SPAN_S:
            groups.append(acc / n)
            acc, n = 0.0, 0
    return 1e3 * stats.percentile(groups, 95) if groups else None
