"""Downwash demo: two stacked drones oscillating through each other's wake
under ``Physics.PYB_DW`` (port of the JAX package's ``examples/downwash.py``,
the retelling of reference examples/downwash.py: same initial poses :45-47,
+-0.5 m cosine sweep :59-64, 240/48 Hz 12 s). Two drones take the dense wake
term of ``core/aero.py``.

    python -m gym_pybullet_drones_tpu_torch.examples.downwash [--device cpu]
"""

import argparse

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.control.dsl_pid import (
    dsl_pid_control,
    dsl_pid_params,
    dsl_pid_reset,
)
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_CTRL, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_DRONE = DroneModel.CF2X
DEFAULT_GUI = False
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    drone=DEFAULT_DRONE,
    gui=DEFAULT_GUI,
    simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
    control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
    duration_sec=DEFAULT_DURATION_SEC,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    plot=True,
    colab=False,
    device=None,
    **_ignored,
):
    device = resolve_device(device)
    INIT_XYZS = np.array([[0.5, 0, 1.0], [-0.5, 0, 0.5]])
    num_drones = 2

    # +-0.5 m cosine sweep; drone 1 phase-shifted half a period (downwash.py:59-64)
    PERIOD = 5
    NUM_WP = control_freq_hz * PERIOD
    idx = np.arange(NUM_WP)
    TARGET_X = 0.5 * np.cos(2 * np.pi * idx / NUM_WP)
    wp0 = np.array([0, NUM_WP // 2])

    cfg = AviaryConfig(
        drone_model=drone, num_drones=num_drones, physics=Physics.PYB_DW,
        pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz, task=TASK_CTRL,
        initial_xyzs=tuple(map(tuple, INIT_XYZS)),
    )
    dtype = cfg.torch_dtype
    params = envbase.build_params(cfg, device)
    ctrl_params = dsl_pid_params(drone, dtype=dtype, device=device)
    zeros = lambda k: torch.zeros((num_drones, k), dtype=dtype, device=device)
    dummy_target = zeros(3)
    num_steps = int(duration_sec * control_freq_hz)

    target_x = torch.as_tensor(TARGET_X, dtype=dtype, device=device)
    target_z = torch.as_tensor(INIT_XYZS[:, 2], dtype=dtype, device=device)

    state = envbase.reset(cfg, params)
    pid_state = dsl_pid_reset((num_drones,), dtype=dtype, device=device)
    wp = torch.as_tensor(wp0, device=device)
    action = zeros(4)
    traj, controls = [], []
    for _ in range(num_steps):
        state, obs, *_ = envbase.step(cfg, params, ctrl_params, dummy_target, state, action)
        tgt = torch.stack([target_x[wp], torch.zeros_like(target_z), target_z], -1)
        action, pid_state, _, _ = dsl_pid_control(
            ctrl_params, pid_state, cfg.ctrl_timestep,
            state.kin.pos, state.kin.quat, state.kin.vel, tgt,
        )
        wp = torch.where(wp < NUM_WP - 1, wp + 1, 0)
        traj.append(obs)
        controls.append(torch.cat([tgt, zeros(9)], -1))

    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, duration_sec=duration_sec,
                    colab=colab)
    logger.log_trajectory(torch.stack(traj).cpu().numpy(),
                          controls=torch.stack(controls).cpu().numpy())
    logger.save()
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Downwash demo (PyTorch)")
    parser.add_argument("--drone", default=DEFAULT_DRONE, type=DroneModel, choices=DroneModel)
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--simulation_freq_hz", default=DEFAULT_SIMULATION_FREQ_HZ, type=int)
    parser.add_argument("--control_freq_hz", default=DEFAULT_CONTROL_FREQ_HZ, type=int)
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC, type=int)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
