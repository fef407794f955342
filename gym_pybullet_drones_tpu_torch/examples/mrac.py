"""MRAC hover demo: adaptive control to [0, 0, 1] (port of the JAX package's
``examples/mrac.py``, the retelling of reference examples/mrac.py:
CtrlAviary + MRAC at 240/120 Hz for 15 s, :44-57, loop :82-103). The adaptive
gains (Kx, Kr, Xm) ride along the loop as an ``MRACState`` on the device.

    python -m gym_pybullet_drones_tpu_torch.examples.mrac [--device cpu]
"""

import argparse

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.control.mrac import mrac_control, mrac_params, mrac_reset
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_CTRL, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_DRONE = DroneModel.CF2X
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 120
DEFAULT_DURATION_SEC = 15
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    drone=DEFAULT_DRONE,
    gui=False,
    plot=True,
    simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
    control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
    duration_sec=DEFAULT_DURATION_SEC,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    colab=False,
    device=None,
    **_ignored,
):
    device = resolve_device(device)
    num_drones = 1
    INIT_XYZS = np.array([[0.0, 0.0, 0.1]])
    TARGET = np.array([[0.0, 0.0, 1.0]])

    cfg = AviaryConfig(
        drone_model=drone, num_drones=num_drones, physics=Physics.PYB,
        pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz, task=TASK_CTRL,
        initial_xyzs=tuple(map(tuple, INIT_XYZS)),
    )
    dtype = cfg.torch_dtype
    params = envbase.build_params(cfg, device)
    ctrl_params = mrac_params(drone, dtype=dtype, device=device)
    dummy_ctrl = envbase.build_ctrl_params(cfg, device)
    dummy_target = torch.zeros((num_drones, 3), dtype=dtype, device=device)
    target = torch.as_tensor(TARGET, dtype=dtype, device=device)
    num_steps = int(duration_sec * control_freq_hz)

    state = envbase.reset(cfg, params)
    mrac_state = mrac_reset(ctrl_params, (num_drones,))
    action = torch.zeros((num_drones, 4), dtype=dtype, device=device)
    traj = []
    for _ in range(num_steps):
        state, obs, *_ = envbase.step(cfg, params, dummy_ctrl, dummy_target, state, action)
        action, mrac_state, _, _ = mrac_control(
            ctrl_params, mrac_state, cfg.ctrl_timestep,
            state.kin.pos, state.kin.quat, state.kin.vel, state.kin.ang_v,
            target,
        )
        traj.append(obs)

    final_pos = state.kin.pos[0].cpu().numpy()
    print(f"[INFO] MRAC final position: {final_pos} (target {TARGET[0]})")

    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, duration_sec=duration_sec,
                    colab=colab)
    logger.log_trajectory(torch.stack(traj).cpu().numpy())
    logger.save()
    if plot:
        logger.plot()
    return final_pos


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="MRAC hover (PyTorch)")
    parser.add_argument("--drone", default=DEFAULT_DRONE, type=DroneModel, choices=DroneModel)
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC, type=int)
    parser.add_argument("--plot", default=True, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
