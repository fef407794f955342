"""The port's spans (runtime/profiling.py) on the CPU: off without a
profiler, recorded on the wall clock and annotated in the Chrome trace under
one, the set-up spans of the package's import and of a kernel build."""

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.ops import _build
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as tro
from gym_pybullet_drones_tpu_torch.ops import velocity_soa as tsoa
from gym_pybullet_drones_tpu_torch.runtime import profiling
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset

EVER = (0, 2 ** 63 - 1)


def _plain_rollout(E=3, T=2):
    cfg = tbase.AviaryConfig(task=tbase.TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    p, cp = tbase.build_params(cfg, "cpu"), tbase.build_ctrl_params(cfg, "cpu")
    sl = 0.03 * float(p.max_speed_kmh) * (1000.0 / 3600.0)
    rollout = tro.make_velocity_rollout(tsoa.soa_consts(cp, p), cfg.ctrl_timestep,
                                        cfg.pyb_timestep, cfg.steps_per_ctrl, sl, T,
                                        device="cpu")
    soa = tsoa.soa_from_state(batch_reset(cfg, p, E, device="cpu"))
    act = {k: torch.full((E,), 0.5, dtype=torch.float32) for k in tsoa.ACTION_KEYS}
    return lambda: rollout(soa, act)


def test_without_a_profiler_a_span_is_the_shared_no_op():
    before = profiling.spans(*EVER)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("k1.call") is profiling.span("other") is profiling.OFF
    with profiling.span("k1.call") as s:
        assert s is profiling.OFF
        _plain_rollout()()
    assert profiling.spans(*EVER) == before


def test_under_a_profiler_the_plain_rollout_records_its_span(tmp_path):
    """A span around a plain rollout of the port: its stamps on
    ``time.time_ns()`` inside the profiled window, and an annotation of its
    name in the exported Chrome trace around them."""
    rollout = _plain_rollout()

    def run():
        with profiling.span("probe"):
            rollout()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        start = time.time_ns()
        run()
        end = time.time_ns()
    got = [s for s in profiling.spans(start, end) if s[0] == "probe"]
    assert len(got) == 1
    _, t0, t1 = got[0]
    assert start <= t0 <= t1 <= end
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    marks = [(base + 1e3 * e["ts"], base + 1e3 * (e["ts"] + e["dur"]))
             for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"] == "probe"]
    assert len(marks) == 1
    # one clock: the annotation opens before the span's stamps and closes after
    a, b = marks[0]
    assert a - 1e3 <= t0 and t1 <= b + 1e3
    # the span is also kept after the profiler stops, and nothing more is recorded
    run()
    assert profiling.spans(start, time.time_ns()) == got


def test_a_span_is_recorded_when_its_block_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.time_ns()
        try:
            with profiling.span("raises"):
                raise KeyError("x")
        except KeyError:
            pass
        assert [s[0] for s in profiling.spans(start, time.time_ns())] == ["raises"]


def test_the_port_import_is_a_setup_span():
    got = [s for s in profiling.setup_spans() if s[0] == "port.import"]
    assert len(got) == 1
    _, t0, t1 = got[0]
    assert 0 < t0 < t1 <= time.time_ns()


def test_nvcc_is_a_setup_span_only_when_it_builds(tmp_path, monkeypatch):
    """A build of a kernel whose library is missing records ``nvcc.<name>``
    around the compiler alone; a second call finds the library and records
    nothing."""
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("built")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    count = lambda: sum(s[0] == "nvcc.velocity_rollout" for s in profiling.setup_spans())
    before = count()
    lib = _build.build("velocity_rollout")
    assert count() == before + 1 and len(calls) == 1
    assert _build.build("velocity_rollout") == lib
    assert count() == before + 1 and len(calls) == 1
