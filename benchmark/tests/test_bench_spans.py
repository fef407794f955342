"""The readers of the port's spans (``_spans.py``, exported by
``runtime/profiling.py``) on synthetic
runs: the set-up phases, K1's launcher, and the idle time the host spent
inside the port."""

import collections

import pytest

from benchmark import harness
from gym_pybullet_drones_tpu_torch import _spans
from gym_pybullet_drones_tpu_torch.runtime import profiling

S = 1_000_000_000  # ns a second
READERS = ("setup.port_import_s", "setup.k1_load_s", "k1.host_us", "device.idle_in_port.sim")


class Run:
    def __init__(self, parts):
        self.parts = parts


def _part(ops, start=100.0, end=110.0):
    return dict(label="k1_calls", start=start, end=end, ops=ops)


@pytest.fixture
def ring(monkeypatch):
    """An empty span ring and an empty list of set-up spans, for the test to fill."""
    spans, setup = collections.deque(maxlen=8), []
    monkeypatch.setattr(_spans, "_SPANS", spans)
    monkeypatch.setattr(_spans, "_SETUP_SPANS", setup)
    return spans, setup


def test_idle_in_port_reads_the_gap_a_span_covers(ring):
    """The device idles from 102 s to 106 s of a 10 s part; a span covers
    102-104 s, so half of that gap (20 % of the part) was spent in the port,
    and the other half in the caller."""
    spans, _ = ring
    run = Run([_part([("velocity_rollout_kernel", 100.0, 102.0),
                      ("velocity_rollout_kernel", 106.0, 111.0)])])
    spans.extend([("k1.call", 102 * S, 104 * S), ("k1.call", 200 * S, 201 * S),
                  ("k1.call", 99 * S, 101 * S)])
    idle = harness.metric_reader("device.idle.sim")(run)
    in_port = harness.metric_reader("device.idle_in_port.sim")(run)
    assert idle == pytest.approx(40.0)
    assert in_port == pytest.approx(20.0)
    spans.append(("k1.call", 103 * S, 105 * S))  # overlapping spans count once
    assert harness.metric_reader("device.idle_in_port.sim")(run) == pytest.approx(30.0)


def test_host_us_is_the_mean_k1_call_inside_the_parts(ring):
    spans, _ = ring
    run = Run([_part([]), _part([], start=120.0, end=121.0)])
    spans.extend([("k1.call", 101 * S, 101 * S + 100_000), ("k1.call", 120 * S, 120 * S + 300_000),
                  ("probe", 102 * S, 103 * S),  # another span
                  ("k1.call", 50 * S, 60 * S), ("k1.call", 109 * S, 111 * S)])  # outside
    assert harness.metric_reader("k1.host_us")(run) == pytest.approx(200.0)


def test_setup_readers_sum_their_spans(ring):
    _, setup = ring
    setup.extend([("port.import", 1 * S, 4 * S), ("nvcc.velocity_rollout", 5 * S, 9 * S),
                  ("k1.load", 5 * S - 10, 9 * S + 10), ("k1.first_launch", 10 * S, 10 * S + S // 2)])
    assert harness.metric_reader("setup.port_import_s")(Run([])) == pytest.approx(3.0)
    assert harness.metric_reader("setup.k1_load_s")(Run([])) == pytest.approx(4.5, abs=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_no_span_and_reads_none(ring, name):
    spans, _ = ring
    run = Run([_part([("velocity_rollout_kernel", 100.0, 102.0)])])
    spans.append(("k1.call", 200 * S, 201 * S))  # outside the part
    assert harness.metric_reader(name)(run) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_spans_reads_none(monkeypatch, name):
    """A port whose profiling module has no spans yet: the metric is left
    out of the line, and nothing raises."""
    for attr in ("spans", "setup_spans"):
        monkeypatch.delattr(profiling, attr)
    run = Run([_part([("velocity_rollout_kernel", 100.0, 102.0)])])
    assert harness.metric_reader(name)(run) is None
