"""Velocity-reference flight: 4 drones under piecewise-constant velocity
commands (port of the JAX package's ``examples/pid_velocity.py``, the
retelling of reference examples/pid_velocity.py: same initial poses :61-72,
same velocity schedule :100-105, 240/48 Hz 5 s).

The velocity targets are a precomputed (T, 4, 4) table indexed by the
control step; each step is one ``envs/base.step`` of ``TASK_VELOCITY`` on the
device (VelocityAviary semantics: the embedded DSLPID chases the commanded
direction at |v4| x SPEED_LIMIT, VelocityAviary.py:129-168).

    python -m gym_pybullet_drones_tpu_torch.examples.pid_velocity [--device cpu]
"""

import argparse

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_VELOCITY, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_DRONE = DroneModel.CF2X
DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 5
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    drone=DEFAULT_DRONE,
    gui=DEFAULT_GUI,
    plot=DEFAULT_PLOT,
    simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
    control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
    duration_sec=DEFAULT_DURATION_SEC,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    colab=False,
    device=None,
    **_ignored,
):
    device = resolve_device(device)
    INIT_XYZS = np.array([[0, 0, 0.1], [0.3, 0, 0.1], [0.6, 0, 0.1], [0.9, 0, 0.1]])
    INIT_RPYS = np.array([[0, 0, 0], [0, 0, np.pi / 3], [0, 0, np.pi / 4],
                          [0, 0, np.pi / 2]])
    num_drones = 4

    # Piecewise-constant velocity table (pid_velocity.py:100-105)
    NUM_WP = control_freq_hz * duration_sec
    i = np.arange(NUM_WP)[:, None]
    TARGET_VEL = np.zeros((NUM_WP, 4, 4))
    TARGET_VEL[:, 0] = np.where(i < NUM_WP / 8, [-0.5, 1, 0, 0.99], [0.5, -1, 0, 0.99])
    TARGET_VEL[:, 1] = np.where(i < NUM_WP / 8 + NUM_WP / 6, [0, 1, 0, 0.99], [0, -1, 0, 0.99])
    TARGET_VEL[:, 2] = np.where(i < NUM_WP / 8 + 2 * NUM_WP / 6,
                                [0.2, 1, 0.2, 0.99], [-0.2, -1, -0.2, 0.99])
    TARGET_VEL[:, 3] = np.where(i < NUM_WP / 8 + 3 * NUM_WP / 6,
                                [0, 1, 0.5, 0.99], [0, -1, -0.5, 0.99])

    cfg = AviaryConfig(
        drone_model=drone, num_drones=num_drones, physics=Physics.PYB,
        pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz, task=TASK_VELOCITY,
        initial_xyzs=tuple(map(tuple, INIT_XYZS)),
        initial_rpys=tuple(map(tuple, INIT_RPYS)),
    )
    dtype = cfg.torch_dtype
    params = envbase.build_params(cfg, device)
    ctrl_params = envbase.build_ctrl_params(cfg, device)
    zeros = lambda k: torch.zeros((num_drones, k), dtype=dtype, device=device)
    dummy_target = zeros(3)
    num_steps = int(duration_sec * control_freq_hz)

    vel_table = torch.as_tensor(TARGET_VEL, dtype=dtype, device=device)

    state = envbase.reset(cfg, params)
    action = zeros(4)
    traj, controls = [], []
    for t in range(num_steps):
        # Reference loop order (pid_velocity.py:117-128): step on the carried
        # action, then pick this step's velocity command for the next step.
        state, obs, *_ = envbase.step(cfg, params, ctrl_params, dummy_target, state, action)
        action = vel_table[min(t, NUM_WP - 1)]
        traj.append(obs)
        controls.append(torch.cat([zeros(6), action[:, 0:3], zeros(3)], -1))

    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, duration_sec=duration_sec,
                    colab=colab)
    logger.log_trajectory(torch.stack(traj).cpu().numpy(),
                          controls=torch.stack(controls).cpu().numpy())
    logger.save()
    logger.save_as_csv("vel")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Velocity control: VelocityAviary (PyTorch)")
    parser.add_argument("--drone", default=DEFAULT_DRONE, type=DroneModel, choices=DroneModel)
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--simulation_freq_hz", default=DEFAULT_SIMULATION_FREQ_HZ, type=int)
    parser.add_argument("--control_freq_hz", default=DEFAULT_CONTROL_FREQ_HZ, type=int)
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC, type=int)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
