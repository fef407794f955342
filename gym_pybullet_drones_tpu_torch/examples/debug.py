"""Physics sandbox: raw substep probes without any aviary (port of the JAX
package's ``examples/debug.py``, the analogue of reference examples/debug.py,
which pokes PyBullet directly with external forces/torques on free bodies
:13-100). The probes run the plain ``substep_dyn`` / ``substep_pyb``
functions: a DYN hover at HOVER_RPM, a PYB asymmetric-thrust kick and a PYB
free fall, and print the resulting states.

    python -m gym_pybullet_drones_tpu_torch.examples.debug [--device cpu]
"""

import argparse

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state, substep_dyn, substep_pyb
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel


def main(device=None):
    """Run the three probes; returns their final states as numpy arrays
    (``hover_pos``, ``hover_vel``, ``kick_ang_v``, ``kick_rpy_rates``,
    ``fall_z``)."""
    device = resolve_device(device)
    params = drone_params(DroneModel.CF2X, device=device)
    dt = 1.0 / 240.0
    level = lambda z: init_kin_state(torch.tensor([[0.0, 0.0, z]], device=device),
                                     torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device))
    host = lambda t: t.detach().cpu().numpy()

    print("--- hover thrust probe (DYN): rpm = HOVER_RPM, expect z steady ---")
    kin = level(1.0)
    rpm = params.hover_rpm.expand(1, 4)
    for _ in range(240):
        kin = substep_dyn(kin, rpm, params, dt)
    hover_pos, hover_vel = host(kin.pos[0]), host(kin.vel[0])
    print("after 1 s:", hover_pos, "vel", hover_vel)

    print("--- asymmetric thrust probe (PYB): motor 0 +5% -> roll/pitch rates ---")
    kin = level(1.0)
    rpm = torch.tensor([[1.05, 1.0, 1.0, 1.0]], device=device) * params.hover_rpm
    last = rpm
    for _ in range(24):
        kin = substep_pyb(kin, rpm, last, params, dt, contact=False)
    kick_ang_v, kick_rates = host(kin.ang_v[0]), host(kin.rpy_rates[0])
    print("after 0.1 s: ang_v", kick_ang_v, "rpy_rates", kick_rates)

    print("--- free fall probe: rpm = 0 -> a = -g ---")
    kin = level(10.0)
    zero = torch.zeros((1, 4), device=device)
    for _ in range(240):
        kin = substep_pyb(kin, zero, zero, params, dt, contact=False)
    fall_z = float(kin.pos[0, 2])
    print("after 1 s: z", fall_z, "(expect ~%.3f)" % (10.0 - 0.5 * 9.8))
    return dict(hover_pos=hover_pos, hover_vel=hover_vel, kick_ang_v=kick_ang_v,
                kick_rpy_rates=kick_rates, fall_z=np.float64(fall_z))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Physics substep probes")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    main(**vars(parser.parse_args()))
