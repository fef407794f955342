"""Gradient-based trajectory optimization through the simulator (port of the
JAX package's ``examples/trajopt.py``, the 10th example, beyond the
reference's nine: PyBullet is not differentiable, this simulator is —
tests/test_torch_differentiability.py pins the property).

Optimizes an open-loop per-control-step collective-RPM schedule with Adam so
a CF2X reaches a target altitude at rest, back-propagating through the full
PYB physics (5 substeps per control period, 240/48 Hz) in float64. No
controller, no RL — ``torch.autograd`` through ``core.dynamics.step_physics``
and ``torch.optim.Adam`` with the JAX example's ``optax.adam(150.0)``
settings. (Collective thrust only: open-loop ATTITUDE trajectories are
unstable over horizons this long, so lateral waypoints need feedback in the
loop.)

    python -m gym_pybullet_drones_tpu_torch.examples.trajopt --duration_sec 1.0 [--device cpu]
"""

import argparse
import os
import time

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state, step_physics
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_DURATION_SEC = 1.0
DEFAULT_TARGET = (0.0, 0.0, 1.2)
DEFAULT_ITERS = 200
DEFAULT_OUTPUT_FOLDER = "results"


def run(
    duration_sec=DEFAULT_DURATION_SEC,
    target=DEFAULT_TARGET,
    iters=DEFAULT_ITERS,
    control_freq_hz=48,
    simulation_freq_hz=240,
    plot=True,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    device=None,
    **_ignored,
):
    """Returns (final position error in m, residual speed in m/s)."""
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    params = drone_params(DroneModel.CF2X, **f64)
    hover = float(params.hover_rpm)
    steps = int(duration_sec * control_freq_hz)
    sub = simulation_freq_hz // control_freq_hz
    dt = 1.0 / simulation_freq_hz
    tgt = torch.tensor(target, **f64)

    def rollout(sched):
        """sched: (steps,) collective RPM offsets -> (final kin, path)."""
        kin = init_kin_state(torch.tensor([[0.0, 0.0, 0.1]], **f64),
                             torch.tensor([[0.0, 0.0, 0.0, 1.0]], **f64))
        last = torch.full((1, 4), hover, **f64)
        path = []
        for r in sched.unbind(0):
            rpm = (hover + r).expand(1, 4)
            kin, last = step_physics(kin, rpm, last, params, dt, sub, Physics.PYB)
            path.append(kin.pos[0])
        return kin, torch.stack(path)

    def loss(sched):
        kin, _ = rollout(sched)
        return (torch.sum((kin.pos[0] - tgt) ** 2)
                + 0.1 * torch.sum(kin.vel[0] ** 2))

    sched = torch.zeros(steps, **f64, requires_grad=True)
    opt = torch.optim.Adam([sched], lr=150.0)
    t0 = time.time()
    for k in range(iters):
        opt.zero_grad()
        val = loss(sched)
        val.backward()
        opt.step()
        if (k + 1) % max(1, iters // 10) == 0:
            print(f"[{time.time()-t0:6.2f}s] iter {k+1}/{iters} "
                  f"loss {val.item():.6f}", flush=True)
    with torch.no_grad():
        kin, path = rollout(sched)
    err = float(torch.linalg.norm(kin.pos[0] - tgt))
    vel = float(torch.linalg.norm(kin.vel[0]))
    print(f"[DONE] final position error {err*1000:.1f} mm, "
          f"residual speed {vel*100:.1f} cm/s "
          f"({steps}-step schedule, {iters} Adam iterations)")
    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        p = path.cpu().numpy()
        fig, ax = plt.subplots(figsize=(6, 4))
        t_ax = np.arange(len(p)) / control_freq_hz
        ax.plot(t_ax, p[:, 2], "-o", ms=2, label="optimized altitude")
        ax.axhline(target[2], color="r", ls="--", label="target")
        ax.set_xlabel("t [s]")
        ax.set_ylabel("z [m]")
        ax.legend()
        os.makedirs(output_folder, exist_ok=True)
        out = os.path.join(output_folder, "trajopt.png")
        fig.savefig(out, dpi=120)
        print(f"[INFO] plot saved to {out}")
    return err, vel


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Gradient-based trajectory optimization through the sim")
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC,
                        type=float)
    parser.add_argument("--iters", default=DEFAULT_ITERS, type=int)
    parser.add_argument("--plot", default=True, type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    run(**vars(parser.parse_args()))
