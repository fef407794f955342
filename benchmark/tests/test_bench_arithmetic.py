"""The benchmark's arithmetic: percentiles, spreads, the busy union and the
idle gaps of a synthetic trace, the frozen operation counts, the formation
traffic's mix and the strata of the chunked check's rows."""

import statistics

import numpy as np
import torch

import pytest

from benchmark import harness, opcount, stats, traffic
from benchmark.drivers import velocity_chunked
from benchmark.tests import cells


def test_percentile_interpolates_like_numpy():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 10.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_busy_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.busy_union(iv) == pytest.approx(3.0)
    assert stats.idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert stats.busy_union([]) == 0.0


def test_trace_summary_of_a_synthetic_trace():
    parts = [dict(label="collect", start=0.0, end=10.0,
                  ops=[("k_a", 1.0, 2.0), ("k_b", 1.5, 3.0), ("k_a", 9.0, 11.0)]),
             dict(label="update", start=20.0, end=24.0, ops=[("k_c", 20.0, 24.0)])]
    s = harness.trace_summary(parts)
    assert s["busy_s"] == pytest.approx(2.0 + 1.0 + 4.0)
    assert s["window_s"] == pytest.approx(14.0)
    assert s["ops"] == 4
    assert s["breakdown"]["device_ops"][0] == ["k_c", 4.0]
    assert s["breakdown"]["idle_gaps"][0] == ["collect", 6.0]
    assert len(s["breakdown"]["idle_gaps"]) <= 10


def test_frozen_operation_counts():
    vel = cells.cell("velocity.chunked").config
    hover = cells.cell("hover_ppo.train").config
    assert opcount.velocity_ops(vel) == dict(target=15, control_step=1141)
    ppo = opcount.ppo_ops(hover)
    assert ppo["n_params"] == 2 * (27 * 64 + 64 + 64 * 64 + 64 + 64 + 1) + 1
    assert opcount.mlp_forward_ops([27, 64, 64, 1]) == 2 * (27 * 64 + 64 * 64 + 64) \
        + 64 + 64 + 1 + 64 + 64
    assert ppo["env_step"] == PPO_ENV_STEP_OPS
    assert ppo["per_env_step"] == pytest.approx(ppo["collect"] + ppo["update"])


PPO_ENV_STEP_OPS = 2595


@pytest.mark.parametrize("name,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, "
     "float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> >(int, "
     "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor"
     "<float> >, std::array<char*, 3ul>)", "vectorized_elementwise_kernel[MulFunctor]"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<4u>, unsigned int, 3, 64, 64>(int)", "CatArrayBatchedCopy"),
    ("velocity_rollout_kernel(VelConsts, float const*, float*, int, int)",
     "velocity_rollout_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
])
def test_kernel_names_are_shortened(name, short):
    from benchmark.trace import short_name

    assert short_name(name) == short


def test_a_profiled_part_has_its_window():
    """On a machine without a card the part holds no device operation."""
    from benchmark import trace

    part = trace.profiled("part", lambda: torch.ones(8).sum())
    assert part["label"] == "part" and part["end"] >= part["start"]
    assert isinstance(part["ops"], list)


def test_step_p95_reads_runs_of_a_quarter_second():
    class Run:
        samples = {"step_s": [0.026] * 100 + [0.05] * 20 + [0.01]}

    read = harness.metric_reader("step_ms_p95")
    # ten 26 ms steps make a 260 ms run; five 50 ms steps a 250 ms one; the
    # 10 ms step left over is no run
    assert read(Run()) == pytest.approx(50.0)
    Run.samples = {"step_s": [0.1]}
    assert read(Run()) is None


def test_formation_traffic_gives_every_seed_the_same_mix():
    spec = dict(speed_fraction=0.25, commands=["rotated", "compass", "hover"])
    a, b = (traffic.FormationHeadings(spec, 8, seed, "cpu") for seed in (5, 2 ** 33 + 1))
    for h in (a, b):
        kinds = [h.kind(c) for c in range(300)]
        for i in range(0, 300, 3):
            assert sorted(kinds[i:i + 3]) == ["compass", "hover", "rotated"]
    assert [a.kind(c) for c in range(30)] != [b.kind(c) for c in range(30)]
    again = traffic.FormationHeadings(spec, 8, 5, "cpu")
    assert [again.kind(c) for c in range(30)] == [a.kind(c) for c in range(30)]
    by_kind = {a.kind(c): a.action(c) for c in range(6)}
    assert all(float(v.abs().max()) == 0.0 for v in by_kind["hover"].values())
    compass = by_kind["compass"]
    assert float(compass["ax"][0]) == 1.0 and float(compass["ay"][0]) == 0.0
    assert 0.0 < abs(float(compass["ax"][2])) < 1e-15  # cos(pi / 2) in float64
    assert float(by_kind["rotated"]["amag"][0]) == pytest.approx(0.25)


@pytest.mark.parametrize("E", [4096, 65536, 100])
def test_checked_rows_take_one_from_each_stratum(E):
    rows = velocity_chunked._rows(np.random.default_rng(3), E, 8, 256)
    assert len(rows) == 8 and all(len(r) == min(256, E) for r in rows)
    flat = np.concatenate(rows)
    assert flat.min() >= 0 and flat.max() < E
    if E >= 8 * 256:
        width = E // (8 * 256)
        assert sorted(flat // width) == list(range(8 * 256))
