"""The port's torch.distributed runtime in one two-process gloo run on the CPU
(tests/torch_distributed_worker.py), held against one-process runs of the
port and against the JAX package's sharded swarm on its CPU mesh:

* the sharded coupled swarm (runtime/swarm.make_sharded_swarm_physics) on
  tests/distributed_worker.py's 16-drone cloud, and its pair-pass path
  (pallas=True) against its dense path on the unique-z form of the cloud;
* the binned swarm with its slot axis sharded, across a rebin;
* one PPO train step with the env axis sharded: equal across the ranks bit
  for bit, and equal to the one-process step on the whole batch;
* a checkpoint saved from both ranks, restored in one process;
* runtime/mesh's helpers: the env-sharded batch step, the sharded downwash
  and adjacency strips, an aviary's state sharded over its drones.

The JAX package's four-process cross-topology case has no twin: a torch
checkpoint holds the whole batch, whatever the ranks that saved it."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from gym_pybullet_drones_tpu.core.dynamics import init_kin_state as jinit
from gym_pybullet_drones_tpu.core.params import drone_params as jdrone_params
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JDroneModel
from gym_pybullet_drones_tpu.envs.spec import Physics as JPhysics
from gym_pybullet_drones_tpu.runtime.swarm import make_sharded_swarm_physics as jsharded
from gym_pybullet_drones_tpu_torch.core import aero
from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state, step_physics
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_HOVER, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, DroneModel, ObservationType, Physics
from gym_pybullet_drones_tpu_torch.ops.swarm_binned import make_binned_swarm
from gym_pybullet_drones_tpu_torch.rl.ppo import PPOConfig, make_ppo_train_step, ppo_init
from gym_pybullet_drones_tpu_torch.runtime.checkpoint import restore_checkpoint
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CPU = "cpu"
WORLD = 2
# Sharding reorders the float32 pair sums of a control step (tests/test_soa.py:623-628's
# limits for backends that reorder them; the 16-drone cloud has near-coincident pairs).
REORDER = dict(pos=1e-4, vel=1e-3, quat=1e-5, ang_v=1e-3)
# The PPO step: the rollout's policy forwards run on each rank's slice, the rest
# on the gathered batch as in one process; float32 forwards of other row counts
# may round otherwise (equal on this backend).
PPO_RTOL, PPO_ATOL = 1e-5, 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_distributed_worker.py"),
                               str(r), str(WORLD), port, str(out)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    res = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return res, out


def _fleet(unique_z):
    n = 16
    pos = np.random.default_rng(0).uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[:, 2] += 1.0
    if unique_z:
        pos[:, 2] = 1.0 + 0.3 * np.arange(n, dtype=np.float32)
    return pos


def _close(got, want, limits, what):
    for k, lim in limits.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max())
        assert err <= lim, f"{what}: {k} differs by {err} > {lim}"


def test_ranks_agree_bit_for_bit(ranks):
    (r0, r1), _ = ranks
    for case in ("swarm", "swarm_unique_dense", "swarm_unique_pairs", "binned"):
        for k in r0[case]:
            assert torch.equal(r0[case][k], r1[case][k]), (case, k)
    for k in r0["ppo_params"]:
        assert torch.equal(r0["ppo_params"][k], r1["ppo_params"][k]), k
    for k in r0["ppo_metrics"]:
        assert torch.equal(r0["ppo_metrics"][k], r1["ppo_metrics"][k]), k
    assert torch.equal(r0["ppo_generator"], r1["ppo_generator"])


def test_sharded_swarm_against_one_process_and_jax(ranks):
    (r0, _), _ = ranks
    params = drone_params(DroneModel.CF2X, device=CPU)
    rpm = torch.full((16, 4), float(params.hover_rpm))
    for case, unique_z in (("swarm", False), ("swarm_unique_dense", True)):
        pos = _fleet(unique_z)
        kin = init_kin_state(pos, np.tile([0.0, 0.0, 0.0, 1.0], (16, 1)), device=CPU)
        one, _ = step_physics(kin, rpm, rpm, params, 1 / 240, 5, Physics.PYB_DW, collisions=True)
        _close(r0[case], vars(one), REORDER, f"{case} against one process")
    # the pair passes' rectangular entries against the dense pair terms, on the
    # well-conditioned cloud (tests/distributed_worker.py:90-106 allows 1e-4)
    _close(r0["swarm_unique_pairs"], r0["swarm_unique_dense"],
           dict(pos=1e-6, vel=1e-5, quat=1e-7, ang_v=1e-5), "pair passes against dense")

    with jax.enable_x64(False):
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("env",))
        jp = jdrone_params(JDroneModel.CF2X)
        sh = NamedSharding(mesh, P("env"))
        jkin = jinit(jnp.asarray(_fleet(False)),
                     jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32), (16, 1)))
        jkin = jax.tree.map(lambda x: jax.device_put(x, sh), jkin)
        jrpm = jax.device_put(jnp.full((16, 4), float(jp.hover_rpm), jnp.float32), sh)
        out, _ = jsharded(mesh, jp, 1 / 240, 5, JPhysics.PYB_DW, collisions=True)(jkin, jrpm,
                                                                                   jrpm)
        want = {k: np.asarray(getattr(out, k)) for k in REORDER}
    _close(r0["swarm"], want, REORDER, "swarm against JAX's sharded swarm")


def test_sharded_binned_equals_one_process(ranks):
    (r0, _), _ = ranks
    params = drone_params(DroneModel.CF2X, device=CPU)
    bn = 64
    bpos = np.zeros((bn, 3), np.float32)
    bpos[:, 0] = np.arange(bn) * 2.0
    bpos[:, 2] = 1.0 + 0.1 * (np.arange(bn) % 7)
    bkin = init_kin_state(bpos, np.tile([0.0, 0.0, 0.0, 1.0], (bn, 1)), device=CPU)
    init, step, export = make_binned_swarm(params, 1 / 240, 5, collisions=True, cell_size=10.0,
                                           nx=8, ny=2, cap=128, resort_every=2, device=CPU)
    s = init(bkin)
    for _ in range(3):
        s = step(s, [torch.full((bn,), float(params.hover_rpm))] * 4)
    one = export(s, bkin)
    for k in r0["binned"]:
        assert torch.equal(r0["binned"][k], getattr(one, k)), k


def _ppo_setup(seed):
    env_cfg = AviaryConfig(num_drones=1, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
                           obs_type=ObservationType.KIN, pyb_freq=240, ctrl_freq=30,
                           action_buffer_size=15)
    ppo_cfg = PPOConfig(num_envs=8, n_steps=16, minibatch_size=32, det_frac=0.25)
    runner, aux = ppo_init(env_cfg, ppo_cfg, seed, device=CPU)
    return env_cfg, ppo_cfg, runner, aux


def test_sharded_ppo_step_equals_one_process(ranks):
    (r0, r1), _ = ranks
    env_cfg, ppo_cfg, runner, aux = _ppo_setup(0)
    runner, metrics = make_ppo_train_step(env_cfg, ppo_cfg, aux)(runner)
    for k, v in runner.params.state_dict().items():
        torch.testing.assert_close(r0["ppo_params"][k], v, rtol=PPO_RTOL, atol=PPO_ATOL)
    for k, v in metrics.items():
        torch.testing.assert_close(r0["ppo_metrics"][k], v, rtol=PPO_RTOL, atol=PPO_ATOL)
    assert torch.equal(r0["ppo_generator"], runner.generator.get_state())
    torch.testing.assert_close(torch.cat([r0["ppo_env_pos"], r1["ppo_env_pos"]]),
                               runner.env_state.kin.pos, rtol=0, atol=PPO_ATOL)
    assert float(metrics["mean_reward"]) > 0


def test_checkpoint_from_two_ranks_restores_in_one_process(ranks):
    (r0, r1), out = ranks
    _, _, template, _ = _ppo_setup(99)
    restored = restore_checkpoint(str(out / "ckpt"), template)
    for k, v in restored.params.state_dict().items():
        assert torch.equal(v, r0["ppo_params"][k]), k
    assert torch.equal(restored.env_state.kin.pos,
                       torch.cat([r0["ppo_env_pos"], r1["ppo_env_pos"]]))
    assert torch.equal(restored.obs, torch.cat([r0["ppo_obs"], r1["ppo_obs"]]))
    assert torch.equal(restored.generator.get_state(), r0["ppo_generator"])
    assert restored.update_count == 1


def test_mesh_helpers_equal_one_process(ranks):
    (r0, r1), _ = ranks
    cfg = AviaryConfig(num_drones=1, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
                       pyb_freq=240, ctrl_freq=30)
    p = tbase.build_params(cfg, CPU)
    step = make_batched_step(cfg, p, tbase.build_ctrl_params(cfg, CPU),
                             tbase.hover_target_pos(cfg, p))
    state = batch_reset(cfg, p, 8, device=CPU)
    for _ in range(3):
        state, out = step(state, torch.linspace(-1, 1, 8).reshape(8, 1, 1))
    assert torch.equal(r0["env_pos"], state.kin.pos)
    assert torch.equal(r0["env_reward"], out.reward)

    params = drone_params(DroneModel.CF2X, device=CPU)
    pos = torch.as_tensor(_fleet(False))
    torch.testing.assert_close(r0["downwash"], aero.downwash_forces_body_z(pos, params),
                               rtol=1e-6, atol=0)
    assert torch.equal(r0["adjacency"], tbase.adjacency_matrix(pos, 0.5))

    mcfg = AviaryConfig(num_drones=16, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
                        pyb_freq=240, ctrl_freq=30, action_buffer_size=3)
    whole = tbase.reset(mcfg, tbase.build_params(mcfg, CPU))
    for r, res in enumerate((r0, r1)):
        rows = slice(8 * r, 8 * r + 8)
        got = res["swarm_state"]
        assert torch.equal(got["pos"], whole.kin.pos[rows])
        assert torch.equal(got["last_rpm"], whole.last_rpm[rows])
        assert torch.equal(got["buffer"], whole.action_buffer[:, rows])
        assert torch.equal(got["steps"], whole.step_count)
