"""Helix-tracking demo: N drones on a circular trajectory under DSLPID.

Port of the JAX package's ``examples/pid.py``, the retelling of reference
examples/pid.py (same initial poses :64-66, same circular waypoint table
:72-77, same 240/48 Hz 12 s defaults :43-45). Each control step is one
``envs/base.step`` and one batched ``dsl_pid_control`` on the device, in a
Python loop where the JAX package scans; the stacked trajectory comes back
to the host once and is bulk-logged. With ``gui=True`` each step is logged
as it comes, paced by ``utils.sync`` like the reference's GUI loop
(:132-167).

    python -m gym_pybullet_drones_tpu_torch.examples.pid [--device cpu]
"""

import argparse
import time

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
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool, sync

DEFAULT_DRONES = DroneModel.CF2X
DEFAULT_NUM_DRONES = 3
DEFAULT_PHYSICS = Physics.PYB
DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    drone=DEFAULT_DRONES,
    num_drones=DEFAULT_NUM_DRONES,
    physics=DEFAULT_PHYSICS,
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
    # Initial poses on a circle with stacked heights (pid.py:64-66)
    H, H_STEP, R = 0.1, 0.05, 0.3
    INIT_XYZS = np.array([
        [R * np.cos((i / 6) * 2 * np.pi + np.pi / 2),
         R * np.sin((i / 6) * 2 * np.pi + np.pi / 2) - R,
         H + i * H_STEP] for i in range(num_drones)
    ])
    INIT_RPYS = np.array([[0.0, 0.0, i * (np.pi / 2) / num_drones]
                          for i in range(num_drones)])

    # Circular waypoint table (pid.py:71-77)
    PERIOD = 10
    NUM_WP = control_freq_hz * PERIOD
    idx = np.arange(NUM_WP)
    TARGET_XY = np.stack([
        R * np.cos((idx / NUM_WP) * 2 * np.pi + np.pi / 2) + INIT_XYZS[0, 0],
        R * np.sin((idx / NUM_WP) * 2 * np.pi + np.pi / 2) - R + INIT_XYZS[0, 1],
    ], axis=1)
    wp0 = np.array([int((i * NUM_WP / 6) % NUM_WP) for i in range(num_drones)])

    cfg = AviaryConfig(
        drone_model=drone, num_drones=num_drones, physics=physics,
        pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz, task=TASK_CTRL,
        initial_xyzs=tuple(map(tuple, INIT_XYZS)),
        initial_rpys=tuple(map(tuple, INIT_RPYS)),
    )
    dtype = cfg.torch_dtype
    params = envbase.build_params(cfg, device)
    ctrl_params = dsl_pid_params(drone, dtype=dtype, device=device)
    num_steps = int(duration_sec * control_freq_hz)

    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    target_xy, target_z, target_rpy = tensor(TARGET_XY), tensor(INIT_XYZS[:, 2]), tensor(INIT_RPYS)
    zeros = lambda k: torch.zeros((num_drones, k), dtype=dtype, device=device)
    dummy_target = zeros(3)

    state = envbase.reset(cfg, params)
    pid_state = dsl_pid_reset((num_drones,), dtype=dtype, device=device)
    wp = torch.as_tensor(wp0, device=device)
    action = zeros(4)

    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, duration_sec=duration_sec,
                    colab=colab)
    traj, controls = [], []
    start = time.time()
    for i in range(num_steps):
        state, obs, *_ = envbase.step(cfg, params, ctrl_params, dummy_target, state, action)
        tgt = torch.cat([target_xy[wp], target_z[:, None]], -1)
        action, pid_state, _, _ = dsl_pid_control(
            ctrl_params, pid_state, cfg.ctrl_timestep,
            state.kin.pos, state.kin.quat, state.kin.vel, tgt, target_rpy,
        )
        wp = torch.where(wp < NUM_WP - 1, wp + 1, 0)
        control12 = torch.cat([target_xy[wp], target_z[:, None], target_rpy, zeros(6)], -1)
        if gui:
            obs_np, control_np = obs.cpu().numpy(), control12.cpu().numpy()
            for j in range(num_drones):
                logger.log(drone=j, timestamp=i / control_freq_hz,
                           state=obs_np[j], control=control_np[j])
            sync(i, start, cfg.ctrl_timestep)
        else:
            traj.append(obs)
            controls.append(control12)
    if not gui:
        logger.log_trajectory(torch.stack(traj).cpu().numpy(),
                              controls=torch.stack(controls).cpu().numpy())

    logger.save()
    logger.save_as_csv("pid")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Helix flight: CtrlAviary + DSLPIDControl (PyTorch)")
    parser.add_argument("--drone", default=DEFAULT_DRONES, type=DroneModel,
                        choices=DroneModel)
    parser.add_argument("--num_drones", default=DEFAULT_NUM_DRONES, type=int)
    parser.add_argument("--physics", default=DEFAULT_PHYSICS, type=Physics,
                        choices=Physics)
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool)
    parser.add_argument("--simulation_freq_hz", default=DEFAULT_SIMULATION_FREQ_HZ, type=int)
    parser.add_argument("--control_freq_hz", default=DEFAULT_CONTROL_FREQ_HZ, type=int)
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC, type=int)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
