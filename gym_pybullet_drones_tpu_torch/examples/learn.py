"""PPO training on the hover tasks, on the device.

Port of the JAX package's ``examples/learn.py``, the retelling of reference
examples/learn.py: same tasks (HoverAviary / MultiHoverAviary :53-66), same
solved-reward thresholds (474 / 949.5 for ONE_D_RPM, 467 / 920 otherwise,
:79-82), periodic evaluation with stop-on-threshold (:83-92), final
deterministic evaluation and a logged rollout (:149-192). SB3's PPO is
replaced by the batched actor-learner of ``rl/ppo.py``, and the single env
(n_envs=1, :57) becomes a batch of envs on the device.

The best policy is written as ``best_model.msgpack`` in flax's format
(``convert.save_flax_msgpack``), which the JAX package's ``play.py`` and the
port's read alike. ``local=False`` shrinks training to a CI-sized budget
exactly like the reference (:93).

    python -m gym_pybullet_drones_tpu_torch.examples.learn [--device cpu]
"""

import argparse
import copy
import os

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.convert import actor_critic_to_flax, save_flax_msgpack
from gym_pybullet_drones_tpu_torch.envs.base import TASK_HOVER, TASK_MULTIHOVER, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, ObservationType
from gym_pybullet_drones_tpu_torch.rl.ppo import (
    PPOConfig,
    deterministic_rollout,
    evaluate_policy,
    make_ppo_train_step,
    ppo_init,
)
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_GUI = False
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_OBS = ObservationType.KIN
DEFAULT_ACT = ActionType.ONE_D_RPM
DEFAULT_AGENTS = 2
DEFAULT_MA = False


def run(
    multiagent=DEFAULT_MA,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    gui=DEFAULT_GUI,
    plot=True,
    colab=False,
    record_video=False,
    local=True,
    obs=DEFAULT_OBS,
    act=DEFAULT_ACT,
    num_envs: int = 128,
    seed: int = 0,
    device=None,
    **_ignored,
):
    device = resolve_device(device)
    os.makedirs(output_folder, exist_ok=True)
    num_drones = DEFAULT_AGENTS if multiagent else 1
    task = TASK_MULTIHOVER if multiagent else TASK_HOVER
    env_cfg = AviaryConfig(
        num_drones=num_drones, task=task, action_type=act, obs_type=obs,
        pyb_freq=240, ctrl_freq=30, action_buffer_size=15, episode_len_sec=8.0,
        # Pixel training needs velocity information: stack the last 4 held
        # 24 FPS captures (SB3 VecFrameStack analogue)
        frame_stack=4 if obs == ObservationType.RGB else 1,
    )

    # Solved thresholds (learn.py:79-82)
    if act == ActionType.ONE_D_RPM:
        target_reward = 949.5 if multiagent else 474.0
    else:
        target_reward = 920.0 if multiagent else 467.0

    # The JAX package's settings, which reach the reference's ONE_D_RPM
    # thresholds (474 single / 949.5 multiagent) within about 2M env steps.
    # Those bars are razor-thin: ONE_D_RPM commands equal RPMs (zero torque,
    # BaseRLAviary.py:224-225), a 2-state vertical system whose optimum is
    # 474.28 single / 950.61 multiagent (scripts/one_d_rpm_dp.py).
    # Exploration-noise annealing closes the last ~1 reward of the gap.
    # Training budget: 1e7 env-steps locally (the reference's learn.py:93
    # budget; stop-on-threshold usually exits after ~2M), 100 steps in CI.
    total_steps = int(1e7) if local else int(1e2)
    # 4-dim RPM is a knife-edge stabilization task: warm-start from the
    # DSLPID-in-band expert and anneal the exploration noise away so the
    # deterministic policy must stabilize on its own. Multiagent doubles the
    # obs/action dims: it gets a 256-wide net plus DAgger rounds.
    hard_rpm = act == ActionType.RPM
    anneal_to = ((-2.0 if multiagent else -3.0) if hard_rpm
                 else -2.5 if act == ActionType.ONE_D_RPM else None)
    ppo_cfg = PPOConfig(
        num_envs=num_envs, n_steps=128,
        # 1024 unless the batch is smaller: the minibatch must divide it (the
        # CI budget runs num_envs=4, a batch of 512).
        minibatch_size=min(1024, num_envs * 128),
        learning_rate=1e-4 if hard_rpm else 3e-4,
        hidden=(256, 256) if (hard_rpm and multiagent) else (64, 64),
        log_std_anneal_to=anneal_to,
        log_std_anneal_updates=max(
            1, int((0.9 if multiagent else 0.4 if hard_rpm else 0.6)
                   * (total_steps // (num_envs * 128)))),
    )
    generator = torch.Generator(device=device).manual_seed(seed)
    runner, aux = ppo_init(env_cfg, ppo_cfg, generator, device=device)
    if hard_rpm and local:
        from gym_pybullet_drones_tpu_torch.rl.warmstart import bc_pretrain

        runner, _ = bc_pretrain(
            env_cfg, runner, aux, torch.Generator(device=device).manual_seed(seed + 1),
            episodes=512 if multiagent else 768,
            noise=0.2 if multiagent else 0.25,
            dagger_rounds=2 if multiagent else 0)
    train = make_ppo_train_step(env_cfg, ppo_cfg, aux)

    updates = max(1, total_steps // ppo_cfg.batch_size)
    eval_every = max(1, updates // 40)
    eval_returns = []
    best = -np.inf
    # A copy: the train step updates the network in place
    best_params = copy.deepcopy(runner.params)
    for u in range(updates):
        runner, metrics = train(runner)
        if (u + 1) % eval_every == 0 or u == updates - 1:
            # SB3-equivalent protocol: 10 consecutive deterministic episodes
            # on ONE env (the action buffer persists across auto-resets —
            # BaseRLAviary.py:153-155 — so consecutive episodes differ; a
            # single-episode eval overstates robustness). CI keeps it short.
            ret, n_eps = evaluate_policy(
                env_cfg, aux, runner.params,
                num_steps=260 * 10 if local else 260, num_envs=1)
            eval_returns.append((int((u + 1) * ppo_cfg.batch_size), ret))
            print(f"[INFO] update {u+1}/{updates} mean episode return {ret:.1f} "
                  f"({n_eps} eps), train reward/step {float(metrics['mean_reward']):.3f}")
            if ret > best:
                best = ret
                best_params = copy.deepcopy(runner.params)
            if ret >= target_reward:
                print(f"[INFO] solved: {ret:.1f} >= {target_reward}")
                break

    # Persist the policy (flax msgpack; the analogue of model.save, learn.py:98)
    save_path = save_flax_msgpack(actor_critic_to_flax(best_params),
                                  os.path.join(output_folder, "best_model.msgpack"))
    print(f"[INFO] saved policy to {save_path}")

    # Final deterministic evaluation (learn.py:149-152)
    mean_ret, n_eps = evaluate_policy(env_cfg, aux, best_params,
                                      num_steps=260 * 10, num_envs=1)
    print(f"[INFO] final evaluation: mean return {mean_ret:.2f} over {n_eps} episodes")

    # Logged deterministic rollout (learn.py:155-192)
    states, rewards = deterministic_rollout(env_cfg, aux, best_params,
                                            int(8 * env_cfg.ctrl_freq))
    logger = Logger(logging_freq_hz=env_cfg.ctrl_freq, num_drones=num_drones,
                    output_folder=output_folder, colab=colab)
    logger.log_trajectory(states.cpu().numpy())
    logger.save()
    if plot:
        logger.plot()
    return eval_returns


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="PPO training (on-device)")
    parser.add_argument("--multiagent", default=DEFAULT_MA, type=str2bool)
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--local", default=True, type=str2bool)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
