"""The plain reference against the port's CPU path at tiny sizes (here in
the tests only: the benchmark's runs never compare the two on the CPU)."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import cells
from benchmark.reference import params as refparams
from benchmark.reference import velocity as refvel
from benchmark.reference.hover import Hover
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType
from gym_pybullet_drones_tpu_torch.ops import velocity_soa
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step

VEL = cells.cell("velocity.chunked").config
HOVER = cells.cell("hover_ppo.train").config


def test_velocity_constants_equal_the_ports():
    cfg = envbase.AviaryConfig(task=envbase.TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    port = velocity_soa.soa_consts(envbase.build_ctrl_params(cfg, "cpu"),
                                   envbase.build_params(cfg, "cpu"))
    assert refparams.velocity_consts(VEL) == {k: port[k] for k in refparams.velocity_consts(VEL)}
    assert refparams.speed_limit(VEL) == pytest.approx(
        float(envbase.speed_limit(envbase.build_params(cfg, "cpu"))), rel=1e-7)


def test_velocity_step_equals_the_ports_bit_for_bit():
    consts = refparams.velocity_consts(VEL)
    g = torch.Generator().manual_seed(0)
    E = 32
    s = refvel.reset_columns(VEL, E, torch.float32, "cpu")
    a = [torch.randn(E, generator=g) for _ in range(3)] + [torch.rand(E, generator=g)]
    mine, port = dict(s), dict(s)
    for _ in range(60):
        mine = refvel.control_step(consts, 1 / 48, 1 / 240, 5, 0.25, mine, *a)
        port = velocity_soa.velocity_step_soa(consts, 1 / 48, 1 / 240, 5, 0.25, port, *a)
    for k in refvel.SOA_KEYS:
        assert torch.equal(mine[k], port[k]), k


def test_hover_step_equals_the_ports():
    """obs, reward, flags and final obs of the batched Hover step with
    auto-reset, 300 steps of random actions (episodes end by the bounds and
    by the 8 s timeout)."""
    cfg = envbase.AviaryConfig(num_drones=1, task=envbase.TASK_HOVER, pyb_freq=240,
                               ctrl_freq=30, action_type=ActionType.ONE_D_RPM,
                               action_buffer_size=15, episode_len_sec=8.0)
    params = envbase.build_params(cfg, "cpu")
    step = make_batched_step(cfg, params, envbase.build_ctrl_params(cfg, "cpu"),
                             envbase.hover_target_pos(cfg, params))
    E = 16
    port = batch_reset(cfg, params, E, device="cpu")
    hover = Hover(HOVER, "cpu")
    mine = hover.reset(E)
    assert torch.equal(hover.obs(mine), envbase.compute_obs(cfg, port))
    g = torch.Generator().manual_seed(1)
    done = 0
    for _ in range(300):
        act = torch.clamp(torch.randn((E, 1, 1), generator=g) + 0.3, -1.0, 1.0)
        port, out = step(port, act)
        mine, got = hover.batched_step(mine, act)
        for a, b in zip(got, (out.obs, out.reward, out.terminated, out.truncated,
                              out.final_obs)):
            assert torch.equal(a, b)
        done += int((out.terminated | out.truncated).sum())
    assert done > 0


@pytest.mark.parametrize("cell,over", [
    ("velocity.chunked", {"config": {"env": {"num_envs": 64}},
                          "workload": {"traffic": {"control_steps_per_call": 24},
                                       "check": {"keep_every": 1}}}),
    ("velocity.vector_env", {"config": {"env": {"num_envs": 32}},
                             "workload": {"check": {"stride": 2}}}),
    ("hover_ppo.train", {"config": {"ppo": {"num_envs": 8, "n_steps": 16,
                                            "minibatch_size": 32, "n_epochs": 2}}}),
    ("hover_ppo.domain_rand", {"config": {"ppo": {"num_envs": 8, "n_steps": 16,
                                                  "minibatch_size": 32, "n_epochs": 2}}}),
])
def test_a_cpu_run_is_correct(cell, over):
    """A whole run at a tiny size on the CPU, the port's plain path against
    the reference: correct, with every number under its limit."""
    res, run = harness.run_cell(cells.cell(cell), 2 ** 31 + 17, 0.5, 0, "cpu",
                                time.perf_counter(), over)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    assert list(res)[-1] == "checks"
    assert all(np.isfinite(m["value"]) and m["value"] > 0 for m in res["metrics"].values())
