"""The port's runtime/checkpoint.py and runtime/profiling.py on the CPU, the
cases of tests/test_runtime_aux.py:27-97: a PPO runner saved and restored
into a fresh one takes the same next train step bit for bit, latest_step
skips an interrupted save, a NaN env is reset, and the throughput, trace and
realtime helpers."""

import json
import os
import time

import torch

from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_HOVER, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType
from gym_pybullet_drones_tpu_torch.rl.ppo import PPOConfig, make_ppo_train_step, ppo_init
from gym_pybullet_drones_tpu_torch.runtime import (
    RealtimeMonitor,
    batch_reset,
    latest_step,
    make_batched_step,
    measure_throughput,
    restore_checkpoint,
    save_checkpoint,
    trace,
)
from gym_pybullet_drones_tpu_torch.runtime.rollout import env_health

CPU = "cpu"


def _cfg():
    return AviaryConfig(task=TASK_HOVER, action_type=ActionType.ONE_D_RPM, pyb_freq=240,
                        ctrl_freq=30, action_buffer_size=2)


def _tensors(runner):
    """Every tensor a runner carries, by name, with the generator's state."""
    out = {f"param.{k}": v for k, v in runner.params.state_dict().items()}
    for i, st in runner.opt_state.state.items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out.update({f"env.{k}": v for k, v in vars(runner.env_state.kin).items()})
    out.update(obs=runner.obs, last_rpm=runner.env_state.last_rpm,
               buffer=runner.env_state.action_buffer, steps=runner.env_state.step_count,
               generator=runner.generator.get_state())
    return out


def test_checkpoint_roundtrip_ppo_runner_next_step_bit_equal(tmp_path):
    env_cfg = _cfg()
    ppo_cfg = PPOConfig(num_envs=4, n_steps=8, n_epochs=1, minibatch_size=32)
    runner, aux = ppo_init(env_cfg, ppo_cfg, 3, device=CPU)
    train = make_ppo_train_step(env_cfg, ppo_cfg, aux)
    runner, _ = train(runner)

    save_checkpoint(str(tmp_path), runner, step=1)
    assert latest_step(str(tmp_path)) == 1
    template, _ = ppo_init(env_cfg, ppo_cfg, 99, device=CPU)
    restored = restore_checkpoint(str(tmp_path), template)
    assert restored.params is template.params  # loaded in place
    assert restored.update_count == runner.update_count == 1
    # the restored Adam steps the restored network's parameters
    assert all(a is b for a, b in zip(restored.opt_state.param_groups[0]["params"],
                                      restored.params.parameters()))
    want = _tensors(runner)
    got = _tensors(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # training goes on bit for bit from the restored state
    r1, m1 = train(runner)
    r2, m2 = train(restored)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    want, got = _tensors(r1), _tensors(r2)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_latest_step_skips_an_interrupted_save(tmp_path):
    (tmp_path / "step_3").mkdir()
    (tmp_path / "step_5.tmp-1234-99").mkdir()  # what save_checkpoint leaves when cut
    (tmp_path / "step_6.orbax-checkpoint-tmp-1699999").mkdir()
    (tmp_path / "step_7").mkdir()
    assert latest_step(str(tmp_path)) == 7
    # a save replaces its step's directory and leaves no temporary one
    save_checkpoint(str(tmp_path), {"x": torch.arange(3.0)}, step=7)
    save_checkpoint(str(tmp_path), {"x": torch.arange(3.0) + 1}, step=7)
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_5.tmp-1234-99",
                                            "step_6.orbax-checkpoint-tmp-1699999", "step_7"]
    back = restore_checkpoint(str(tmp_path), {"x": torch.zeros(3, dtype=torch.float64)})
    assert back["x"].dtype == torch.float64 and back["x"].tolist() == [1.0, 2.0, 3.0]


def test_nan_health_mask_resets_poisoned_env():
    cfg = _cfg()
    params = tbase.build_params(cfg, CPU)
    cp = tbase.build_ctrl_params(cfg, CPU)
    tp = tbase.hover_target_pos(cfg, params)
    step = make_batched_step(cfg, params, cp, tp, auto_reset=True, reset_on_nan=True)
    state = batch_reset(cfg, params, 3, device=CPU)
    pos = state.kin.pos.clone()
    pos[1] = float("nan")
    state = state.replace(kin=state.kin.replace(pos=pos))
    assert env_health(state).tolist() == [True, False, True]
    new_state, out = step(state, torch.zeros((3, 1, 1)))
    assert bool(out.terminated[1]) and not bool(out.truncated[1])
    assert bool(torch.isfinite(new_state.kin.pos).all()) and bool(torch.isfinite(out.obs).all())


def test_measure_throughput_trace_and_monitor(tmp_path):
    cfg = _cfg()
    params = tbase.build_params(cfg, CPU)
    step = make_batched_step(cfg, params, tbase.build_ctrl_params(cfg, CPU),
                             tbase.hover_target_pos(cfg, params))
    state = batch_reset(cfg, params, 8, device=CPU)
    action = torch.zeros((8, 1, 1))
    rate, state = measure_throughput(step, state, action, iters=5, items_per_call=8)
    assert rate > 0 and int(state.step_count[0]) == 7 * cfg.steps_per_ctrl
    with trace(str(tmp_path / "trace")) as prof:
        step(state, action)
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert prof.key_averages()
    mon = RealtimeMonitor(240)
    mon.add_steps(240)
    assert mon.sim_time == 1.0
    assert "simulation time 1.0s@240Hz" in mon.report()
    assert mon.realtime_factor > 0


def test_realtime_report_equals_jax(monkeypatch):
    from gym_pybullet_drones_tpu.runtime.profiling import RealtimeMonitor as JRealtimeMonitor

    monkeypatch.setattr(time, "time", lambda: 102.5)
    reports = []
    for cls in (RealtimeMonitor, JRealtimeMonitor):
        mon = cls(48)
        mon.start = 100.0
        mon.add_steps(360)
        reports.append((mon.report(), mon.realtime_factor))
    assert reports[0] == reports[1]
    assert reports[0][0] == "wall-clock time 2.5s, simulation time 7.5s@48Hz (3.00x)"
