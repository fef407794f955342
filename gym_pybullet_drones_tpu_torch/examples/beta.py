"""Betaflight-in-the-loop flight (port of the JAX package's
``examples/beta.py``, the retelling of reference examples/beta.py: racer
model at 500/500 Hz :42-51, CSV trajectory streamed as pos/vel setpoints
:91-118, CTBR control after t > TRAJ_TIME :128-138).

The reference drives an externally-built ``betaflight_SITL.elf``
(assets/clone_bfs.sh); here the default is the wire-compatible ``MockSITL``
on ``udp_ip``. For the real thing, build with
``scripts/build_betaflight_sitl.sh N`` and pass ``--sitl_dir
betaflight_sitl`` (or explicit ``sitl_paths``). The flight follows the
port's ``assets/beta-traj.csv`` (written on first use by
``assets/make_beta_traj.py``); drone pairs fly it forward/reversed like the
reference's two interleaved trajectories (beta.py:91-118).

The env is ``envs.beta.BetaAviary`` where gymnasium imports, else
``runtime.firmware.BetaShellEnv``: the same packet exchange over the same
device step, without the Gymnasium shell.

    python -m gym_pybullet_drones_tpu_torch.examples.beta [--device cpu]
"""

import argparse
import csv
import importlib.util
import os

import numpy as np

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.bridges.betaflight import MockSITL
from gym_pybullet_drones_tpu_torch.control.compat import CTBRControl
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_DRONES = DroneModel.RACE
DEFAULT_SIMULATION_FREQ_HZ = 500
DEFAULT_CONTROL_FREQ_HZ = 500
DEFAULT_DURATION_SEC = 10
DEFAULT_OUTPUT_FOLDER = "results"


def make_env(output_folder, **kw):
    """``BetaAviary`` with gymnasium installed, else ``BetaShellEnv``; prints which."""
    if importlib.util.find_spec("gymnasium") is not None:
        from gym_pybullet_drones_tpu_torch.envs.beta import BetaAviary

        print("[INFO] beta: envs.beta.BetaAviary (gymnasium installed)")
        return BetaAviary(output_folder=output_folder, **kw)
    from gym_pybullet_drones_tpu_torch.runtime.firmware import BetaShellEnv

    print("[INFO] beta: runtime.firmware.BetaShellEnv (gymnasium absent), the loop BetaAviary "
          "wraps")
    return BetaShellEnv(**kw)


def run(
    drone=DEFAULT_DRONES,
    num_drones=1,
    gui=False,
    plot=True,
    simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
    control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
    duration_sec=DEFAULT_DURATION_SEC,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    use_mock_sitl=True,
    sitl_paths=None,
    sitl_dir=None,
    traj_csv=None,
    colab=False,
    udp_ip="127.0.0.1",
    device=None,
    **_ignored,
):
    device = resolve_device(device)
    if sitl_dir and not sitl_paths:
        # Layout produced by scripts/build_betaflight_sitl.sh
        sitl_paths = [
            os.path.join(sitl_dir, f"bf{i}", "obj", "main",
                         "betaflight_SITL.elf")
            for i in range(num_drones)
        ]
        missing = [p for p in sitl_paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"SITL binaries not found: {missing}; build them with "
                "scripts/build_betaflight_sitl.sh")

    # Trajectory table (beta-traj.csv schema): pos/vel setpoint per 2 ms row
    if traj_csv is None:
        from gym_pybullet_drones_tpu_torch.assets.make_beta_traj import ensure_csv

        traj_csv = ensure_csv()
    with open(traj_csv) as f:
        rows = list(csv.DictReader(f))
    traj = np.array([[float(r["p_x"]), float(r["p_y"]), float(r["p_z"]),
                      float(r["v_x"]), float(r["v_y"]), float(r["v_z"])]
                     for r in rows])
    mocks = []
    if use_mock_sitl and not sitl_paths:
        mocks = [MockSITL(i, udp_ip).start() for i in range(num_drones)]
    try:
        env = make_env(output_folder, drone_model=drone, num_drones=num_drones,
                       physics=Physics.PYB, pyb_freq=simulation_freq_hz,
                       ctrl_freq=control_freq_hz, sitl_paths=sitl_paths, udp_ip=udp_ip,
                       device=device)
    except BaseException:
        for m in mocks:
            m.stop()
        raise
    ctrl = [CTBRControl(drone, device=device) for _ in range(num_drones)]
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, colab=colab)

    num_steps = int(duration_sec * control_freq_hz)
    action = np.zeros((num_drones, 4))
    try:
        obs, info = env.reset(seed=0)
        for i in range(num_steps):
            obs, reward, terminated, truncated, info = env.step(action, i)
            t = i / control_freq_hz
            for j in range(num_drones):
                # Stream the CSV as pos/vel setpoints after TRAJ_TIME
                # (beta.py:119-138); odd drones fly the table reversed — the
                # reference's second interleaved trajectory.
                if t > env.TRAJ_TIME:
                    k = min(int((t - env.TRAJ_TIME) * control_freq_hz),
                            len(traj) - 1)
                    row = traj[len(traj) - 1 - k] if j % 2 else traj[k]
                    target_pos = row[0:3] + np.array([0.3 * j, 0.0, 0.0])
                    target_vel = row[3:6] * (-1.0 if j % 2 else 1.0)
                else:
                    target_pos = np.array([0.3 * j, 0.0, 0.1])
                    target_vel = np.zeros(3)
                out = ctrl[j].computeControlFromState(
                    1.0 / control_freq_hz, obs[j], target_pos=target_pos,
                    target_vel=target_vel)
                action[j] = out
                logger.log(drone=j, timestamp=t, state=obs[j])
    finally:
        env.close()
        for m in mocks:
            m.stop()

    logger.save()
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Betaflight SITL flight")
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC, type=int)
    parser.add_argument("--plot", default=True, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--num_drones", default=1, type=int)
    parser.add_argument("--sitl_dir", default=None, type=str,
                        help="betaflight_sitl dir from build_betaflight_sitl.sh"
                             " (real SITL instead of MockSITL)")
    parser.add_argument("--traj_csv", default=None, type=str,
                        help="beta-traj.csv-schema trajectory file")
    parser.add_argument("--udp_ip", default="127.0.0.1", type=str,
                        help="address of the SITL's UDP ports")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
