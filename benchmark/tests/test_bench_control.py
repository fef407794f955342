"""The check refuses what it must: the control (the reference computed in
TF32 in the program's place) and, with the timed path broken underneath
on purpose, each fault a cell can have: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. At tiny sizes on the CPU; the control at each cell's own size on
the card is ``test_control_at_the_cells_size_on_the_card`` (marked cuda)."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import cells
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout
from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo

SMALL = {
    "velocity.chunked": {"config": {"env": {"num_envs": 64}},
                         "workload": {"traffic": {"control_steps_per_call": 24},
                                      "check": {"keep_every": 1}}},
    "velocity.vector_env": {"config": {"env": {"num_envs": 32}},
                            "workload": {"check": {"stride": 2}}},
    "hover_ppo.train": {"config": {"ppo": {"num_envs": 8, "n_steps": 16,
                                           "minibatch_size": 32, "n_epochs": 2}}},
}
SMALL["hover_ppo.domain_rand"] = SMALL["hover_ppo.train"]


def _run(cell):
    res, _ = harness.run_cell(cells.cell(cell), 2 ** 31 + 29, 0.5, 0, "cpu",
                              time.perf_counter(), SMALL[cell])
    return res


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_refused(cell):
    cell_ = cells.cell(cell)
    values, run = harness.readings(cell_, 7, 0.5, "cpu", "reference_tf32", SMALL[cell])
    assert any(v > run.checks[k][1] for k, v in values.items()), values


def _half(x):
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:h]])


def _velocity_faults(monkeypatch, fault):
    plain = velocity_rollout.velocity_rollout_plain

    def broken(*args):
        soa, action = args[-2], args[-1]
        out = plain(*args)
        if fault == "state_unchanged":
            return dict(soa)
        if fault == "half_batch":
            h = len(soa["px"]) // 2
            return {k: torch.cat([v[:h], soa[k][h:]]) for k, v in out.items()}
        return dict(out, pz=out["pz"] * 1.001)

    monkeypatch.setattr(velocity_rollout, "velocity_rollout_plain", broken)


def _env_faults(monkeypatch, fault):
    step = envbase.step

    def broken(cfg, params, ctrl_params, target_pos, state, action, **kw):
        new, obs, reward, term, trunc = step(cfg, params, ctrl_params, target_pos, state,
                                             action, **kw)
        if fault == "state_unchanged":
            return state, obs, reward, term, trunc
        if fault == "half_batch":
            return _half_state(state, new, obs.shape[0] // 2), obs, reward, term, trunc
        return new, obs * 1.001, reward, term, trunc

    monkeypatch.setattr(envbase, "step", broken)


def _half_state(old, new, h):
    """``new`` in the first ``h`` envs, ``old`` (not stepped) in the rest."""
    leaves_old = []
    old.map(lambda t: leaves_old.append(t) or t)
    olds = iter(leaves_old)
    return new.map(lambda b: torch.cat([b[:h], next(olds)[h:]]))


def _ppo_faults(monkeypatch, fault):
    if fault == "state_unchanged":
        def no_step(grads, max_norm):
            for g in grads:
                g.zero_()
            return torch.zeros(())
        monkeypatch.setattr(port_ppo, "clip_by_global_norm_", no_step)
    elif fault == "half_batch":
        rollout_step = port_ppo.rollout_step

        def half(*args, **kw):
            env_state, out, tr = rollout_step(*args, **kw)
            return env_state, out, type(tr)(*(_half(x) for x in tr))
        monkeypatch.setattr(port_ppo, "rollout_step", half)
    else:
        reward = envbase.compute_reward
        monkeypatch.setattr(envbase, "compute_reward", lambda *a: reward(*a) * 1.001)


FAULTS = {"velocity.chunked": _velocity_faults, "velocity.vector_env": _env_faults,
          "hover_ppo.train": _ppo_faults, "hover_ppo.domain_rand": _ppo_faults}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[cell](monkeypatch, fault)
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kind,seconds", [
    ("velocity.chunked", "reference_tf32", 2.0),
    ("velocity_e65536.chunked", "reference_tf32", 5.0),
    ("velocity.vector_env", "reference_tf32", 3.0),
    ("hover_ppo.train", "program_tf32", 0.0),
    ("hover_ppo.domain_rand", "program_tf32", 0.0),
])
def test_control_at_the_cells_size_on_the_card(cell, kind, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell_ = cells.cell(cell)
    over = {"workload": {"check": {"stride": 1}}} if cell == "velocity.vector_env" else None
    values, run = harness.readings(cell_, 11, seconds, "cuda", kind, over)
    assert any(v > run.checks[k][1] for k, v in values.items()), values
