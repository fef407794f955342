"""One rank of the port's two-process gloo run (tests/test_torch_distributed.py).

    python tests/torch_distributed_worker.py RANK WORLD PORT OUT_DIR

Joins a ``torch.distributed`` group at localhost:PORT over gloo on the CPU,
then, on ``runtime/mesh.make_mesh()``:

  1. the sharded coupled swarm (``runtime/swarm.make_sharded_swarm_physics``,
     PYB_DW with contact) on the dense plain path, and on the pair-pass path
     (``pallas=True``: the plain versions of K2 and K4 through their
     rectangular entries) with the dense path beside it;
  2. the binned swarm with its slot axis sharded (``ops/swarm_binned``,
     ``mesh=``), across a rebin;
  3. one PPO train step with the env axis sharded
     (``rl/ppo.make_ppo_train_step(..., mesh=)``);
  4. a checkpoint of that runner saved from both ranks
     (``runtime/checkpoint.save_checkpoint(..., mesh=)``);
  5. ``runtime/mesh``'s placement helpers: an env-sharded batch step, the
     sharded downwash and adjacency strips, an aviary's state sharded.

and writes what it got to OUT_DIR/rank<RANK>.pt for the parent to compare.
Imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(2)

from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state  # noqa: E402
from gym_pybullet_drones_tpu_torch.core.params import drone_params  # noqa: E402
from gym_pybullet_drones_tpu_torch.envs import base as tbase  # noqa: E402
from gym_pybullet_drones_tpu_torch.envs.base import TASK_HOVER, AviaryConfig  # noqa: E402
from gym_pybullet_drones_tpu_torch.envs.spec import (  # noqa: E402
    ActionType,
    DroneModel,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.ops.swarm_binned import (  # noqa: E402
    make_binned_swarm,
    shard_binned_state,
)
from gym_pybullet_drones_tpu_torch.rl.ppo import (  # noqa: E402
    PPOConfig,
    make_ppo_train_step,
    ppo_init,
)
from gym_pybullet_drones_tpu_torch.runtime.checkpoint import save_checkpoint  # noqa: E402
from gym_pybullet_drones_tpu_torch.runtime.mesh import (  # noqa: E402
    all_gather,
    init_distributed,
    make_mesh,
    make_sharded_batched_step,
    make_swarm_adjacency_fn,
    make_swarm_downwash_fn,
    shard_env_batch,
    shard_swarm_state,
)
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset  # noqa: E402
from gym_pybullet_drones_tpu_torch.runtime.swarm import (  # noqa: E402
    make_sharded_swarm_physics,
    shard_swarm_kin,
)

CPU = "cpu"
init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
mesh = make_mesh()
assert (mesh.rank, mesh.size) == (rank, world)
out = {}
params = drone_params(DroneModel.CF2X, device=CPU)
hover = float(params.hover_rpm)
quat = np.tile([0.0, 0.0, 0.0, 1.0], (1, 1))


def swarm_fleet(n, unique_z):
    """tests/distributed_worker.py's 16-drone cloud; with ``unique_z`` its
    well-conditioned form (0.3 m between heights)."""
    pos = np.random.default_rng(0).uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[:, 2] += 1.0
    if unique_z:
        pos[:, 2] = 1.0 + 0.3 * np.arange(n, dtype=np.float32)
    return init_kin_state(pos, np.tile(quat, (n, 1)), device=CPU)


# ---- 1. the sharded swarm, dense and pair-pass paths
n = 16
rpm_local = torch.full((n // world, 4), hover)
dense = make_sharded_swarm_physics(mesh, params, 1 / 240, 5, Physics.PYB_DW, collisions=True,
                                   device=CPU)
pairs = make_sharded_swarm_physics(mesh, params, 1 / 240, 5, Physics.PYB_DW, collisions=True,
                                   pallas=True, z_sort=False, device=CPU)
for name, fn, unique_z in (("swarm", dense, False), ("swarm_unique_dense", dense, True),
                           ("swarm_unique_pairs", pairs, True)):
    kin, _ = fn(shard_swarm_kin(mesh, swarm_fleet(n, unique_z)), rpm_local, rpm_local)
    out[name] = {k: all_gather(mesh, getattr(kin, k)) for k in ("pos", "vel", "quat", "ang_v")}

# ---- 2. the binned swarm, slot axis sharded (whole-cell slabs), across a rebin
bn = 64
bpos = np.zeros((bn, 3), np.float32)
bpos[:, 0] = np.arange(bn) * 2.0  # a 2 m line: spread, wake-coupled
bpos[:, 2] = 1.0 + 0.1 * (np.arange(bn) % 7)
bkin = init_kin_state(bpos, np.tile(quat, (bn, 1)), device=CPU)
b_init, b_step, b_export = make_binned_swarm(params, 1 / 240, 5, collisions=True,
                                             cell_size=10.0, nx=8, ny=2, cap=128,
                                             resort_every=2, mesh=mesh, device=CPU)
s = shard_binned_state(mesh, b_init(bkin))
assert s["px"].shape[0] == 8 * 2 * 128 // world
b_rpm = [torch.full((bn,), hover) for _ in range(4)]
for _ in range(3):
    s = b_step(s, b_rpm)
bk = b_export(s, bkin)
out["binned"] = {k: getattr(bk, k) for k in ("pos", "vel", "quat", "ang_v")}

# ---- 3. one PPO train step, the env axis sharded
env_cfg = AviaryConfig(num_drones=1, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
                       obs_type=ObservationType.KIN, pyb_freq=240, ctrl_freq=30,
                       action_buffer_size=15)
ppo_cfg = PPOConfig(num_envs=8, n_steps=16, minibatch_size=32, det_frac=0.25)
runner, aux = ppo_init(env_cfg, ppo_cfg, 0, device=CPU)
runner = runner.replace(env_state=shard_env_batch(mesh, runner.env_state),
                        obs=shard_env_batch(mesh, runner.obs))
train = make_ppo_train_step(env_cfg, ppo_cfg, aux, mesh=mesh)
runner, metrics = train(runner)
out["ppo_metrics"] = metrics
out["ppo_params"] = runner.params.state_dict()
out["ppo_generator"] = runner.generator.get_state()
out["ppo_env_pos"] = runner.env_state.kin.pos
out["ppo_obs"] = runner.obs

# ---- 4. the runner saved from both ranks
save_checkpoint(os.path.join(out_dir, "ckpt"), runner, step=1, mesh=mesh)

# ---- 5. runtime/mesh's placement helpers: the env-sharded batch step, the
# sharded downwash and adjacency strips, a single aviary's state sharded
cfg = AviaryConfig(num_drones=1, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
                   pyb_freq=240, ctrl_freq=30)
p_env = tbase.build_params(cfg, CPU)
step = make_sharded_batched_step(cfg, p_env, tbase.build_ctrl_params(cfg, CPU),
                                 tbase.hover_target_pos(cfg, p_env), mesh)
state = shard_env_batch(mesh, batch_reset(cfg, p_env, 8, device=CPU))
acts = shard_env_batch(mesh, torch.linspace(-1, 1, 8).reshape(8, 1, 1))
for _ in range(3):
    state, step_out = step(state, acts)
out["env_pos"] = all_gather(mesh, state.kin.pos)
out["env_reward"] = all_gather(mesh, step_out.reward)
swarm = swarm_fleet(n, False)
local = shard_swarm_kin(mesh, swarm).pos
out["downwash"] = all_gather(mesh, make_swarm_downwash_fn(mesh, params)(local))
out["adjacency"] = all_gather(mesh, make_swarm_adjacency_fn(mesh, 0.5)(local))
mcfg = AviaryConfig(num_drones=n, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
                    pyb_freq=240, ctrl_freq=30, action_buffer_size=3)
one = shard_swarm_state(mesh, tbase.reset(mcfg, tbase.build_params(mcfg, CPU)))
out["swarm_state"] = {"pos": one.kin.pos, "last_rpm": one.last_rpm,
                      "buffer": one.action_buffer, "steps": one.step_count}

torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
print("rank", rank, "done", flush=True)
