"""Crazyflie-firmware flight on a square trajectory (port of the JAX
package's ``examples/cf.py``, the retelling of reference examples/cf.py:
500/25 Hz :33-34, takeoff then ``sendFullStateCmd`` squares :74-97), driving
the native C++ firmware subset instead of pycffirmware.

The env is ``envs.cf.CFAviary`` where gymnasium imports, else
``runtime.firmware.CFShellEnv``: the same firmware loop over the same device
step, without the Gymnasium shell. The choice follows the installed
packages, not the device.

    python -m gym_pybullet_drones_tpu_torch.examples.cf [--device cpu]
"""

import argparse
import importlib.util

import numpy as np

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_DRONES = DroneModel.CF2X
DEFAULT_SIMULATION_FREQ_HZ = 500
DEFAULT_CONTROL_FREQ_HZ = 25
DEFAULT_DURATION_SEC = 20
DEFAULT_OUTPUT_FOLDER = "results"


def make_env(drone, simulation_freq_hz, control_freq_hz, output_folder, device):
    """``CFAviary`` with gymnasium installed, else ``CFShellEnv``; prints which."""
    kw = dict(drone_model=drone, pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz,
              device=device)
    if importlib.util.find_spec("gymnasium") is not None:
        from gym_pybullet_drones_tpu_torch.envs.cf import CFAviary

        print("[INFO] cf: envs.cf.CFAviary (gymnasium installed)")
        return CFAviary(output_folder=output_folder, **kw)
    from gym_pybullet_drones_tpu_torch.runtime.firmware import CFShellEnv

    print("[INFO] cf: runtime.firmware.CFShellEnv (gymnasium absent), the loop CFAviary wraps")
    return CFShellEnv(**kw)


def run(
    drone=DEFAULT_DRONES,
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
    env = make_env(drone, simulation_freq_hz, control_freq_hz, output_folder, device)
    obs, info = env.reset()
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=1,
                    output_folder=output_folder, colab=colab)

    # Square waypoints after a 2 s takeoff to 0.5 m (cf.py:74-97)
    corners = np.array([[0.0, 0.0], [0.5, 0.0], [0.5, 0.5], [0.0, 0.5]])
    takeoff_s, edge_s = 3.0, 4.0
    env.sendTakeoffCmd(0.5, 2.0)
    num_steps = int(duration_sec * control_freq_hz)
    try:
        for i in range(num_steps):
            t = i / control_freq_hz
            if t >= takeoff_s:
                # Piecewise-linear square tracking via full-state commands
                leg = (t - takeoff_s) / edge_s
                k = int(leg) % 4
                frac = leg - int(leg)
                p0, p1 = corners[k], corners[(k + 1) % 4]
                pos = p0 + (p1 - p0) * frac
                vel = (p1 - p0) / edge_s
                env.sendFullStateCmd([pos[0], pos[1], 0.5], [vel[0], vel[1], 0.0],
                                     [0.0, 0.0, 0.0], 0.0, [0.0, 0.0, 0.0], t)
            obs = env.step(i)[0]
            logger.log(drone=0, timestamp=t, state=obs[0])
    finally:
        env.close()

    logger.save()
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Crazyflie firmware square flight")
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC, type=int)
    parser.add_argument("--plot", default=True, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
