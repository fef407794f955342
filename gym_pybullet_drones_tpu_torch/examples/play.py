"""Replay a trained policy (port of the JAX package's ``examples/play.py``,
the retelling of reference examples/play.py: loads the saved model, runs a
deterministic rollout with logging :20-76).

The model is a flax msgpack file: what the port's ``learn.py`` writes, or
what the JAX package wrote (``checkpoints/*.msgpack``), read by
``convert.load_flax_msgpack`` without flax.

    python -m gym_pybullet_drones_tpu_torch.examples.play \
        --model_path checkpoints/one_d_rpm_hover.msgpack [--device cpu]
"""

import argparse
import os


from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.convert import actor_critic_from_flax, load_flax_msgpack
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_HOVER, TASK_MULTIHOVER, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, ObservationType
from gym_pybullet_drones_tpu_torch.rl.ppo import deterministic_rollout
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_OUTPUT_FOLDER = "results"


def play(
    model_path=None,
    multiagent=False,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    gui=False,
    plot=True,
    act=ActionType.ONE_D_RPM,
    duration_sec=8,
    colab=False,
    animate=False,
    device=None,
    **_ignored,
):
    device = resolve_device(device)
    if model_path is None:
        model_path = os.path.join(output_folder, "best_model.msgpack")
    num_drones = 2 if multiagent else 1
    env_cfg = AviaryConfig(
        num_drones=num_drones,
        task=TASK_MULTIHOVER if multiagent else TASK_HOVER,
        action_type=act, obs_type=ObservationType.KIN,
        pyb_freq=240, ctrl_freq=30, action_buffer_size=15,
    )
    params_env = envbase.build_params(env_cfg, device)
    aux = dict(params_env=params_env, ctrl_params=envbase.build_ctrl_params(env_cfg, device),
               target_pos=envbase.hover_target_pos(env_cfg, params_env))
    params = actor_critic_from_flax(load_flax_msgpack(model_path), device=device)

    states, rewards = deterministic_rollout(env_cfg, aux, params,
                                            int(duration_sec * env_cfg.ctrl_freq))
    total = float(rewards.sum())
    print(f"[INFO] replay total reward {total:.1f}")
    logger = Logger(logging_freq_hz=env_cfg.ctrl_freq, num_drones=num_drones,
                    output_folder=output_folder, colab=colab)
    logger.log_trajectory(states.cpu().numpy())
    if plot:
        logger.plot()
    if animate:
        # 3-D third-person flight animation (the GUI/video stand-in; the
        # reference shows the replay in the PyBullet GUI, play.py:40-76)
        from gym_pybullet_drones_tpu_torch.utils.viz import animate_trajectory

        out = animate_trajectory(
            logger, os.path.join(output_folder, "replay.gif"),
            fps=env_cfg.ctrl_freq // 2)
        print(f"[INFO] replay animation saved to {out}")
    return total


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Replay a trained policy")
    parser.add_argument("--model_path", default=None, type=str)
    parser.add_argument("--multiagent", default=False, type=str2bool)
    parser.add_argument("--plot", default=True, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--animate", default=False, type=str2bool)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    play(**vars(parser.parse_args()))
