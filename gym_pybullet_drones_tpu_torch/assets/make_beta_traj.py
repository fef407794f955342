"""Generate a Betaflight flight trajectory CSV (beta-traj.csv schema); the
port's copy of the JAX package's ``assets/make_beta_traj.py``.

The reference ships an 8288-row CSV sampled at 2 ms
(assets/beta-traj.csv, header
t,p_x,p_y,p_z,v_x,v_y,v_z,a_lin_x,a_lin_y,a_lin_z,j_lin_x,j_lin_y,j_lin_z,
heading,heading_rate,total_vel,total_acc,total_jerk,phi) that examples/beta.py
streams as position/velocity setpoints (beta.py:91-118). The data file is not
copied; this generator synthesizes an equivalent flight with the same schema,
duration and sample rate: a smooth minimum-snap-style climb to altitude
followed by a figure-eight (lemniscate of Gerono) with analytic
velocity/acceleration/jerk columns.

Run `python -m gym_pybullet_drones_tpu_torch.assets.make_beta_traj [out.csv]`, or
let examples/beta.py generate it on first use.
"""

import os
import sys

import numpy as np

HEADER = ("t,p_x,p_y,p_z,v_x,v_y,v_z,a_lin_x,a_lin_y,a_lin_z,"
          "j_lin_x,j_lin_y,j_lin_z,heading,heading_rate,total_vel,"
          "total_acc,total_jerk,phi")

DT = 0.002
ROWS = 8288  # ~16.58 s, matching the reference file's span


def _septic_blend(tau):
    """Rest-to-rest s(tau) with s', s'', s''' = 0 at both ends, plus
    derivatives (same polynomial family as the CF high-level planner)."""
    t = np.clip(tau, 0.0, 1.0)
    s = 35 * t**4 - 84 * t**5 + 70 * t**6 - 20 * t**7
    ds = 140 * t**3 - 420 * t**4 + 420 * t**5 - 140 * t**6
    dds = 420 * t**2 - 1680 * t**3 + 2100 * t**4 - 840 * t**5
    ddds = 840 * t - 5040 * t**2 + 8400 * t**3 - 4200 * t**4
    return s, ds, dds, ddds


def trajectory(rows: int = ROWS, dt: float = DT, climb_s: float = 4.0,
               height: float = 1.0, ax: float = 1.0, ay: float = 0.5,
               period_s: float = 8.0):
    """Return (rows, 18) float array in the beta-traj column order (phi left
    empty by the writer, as in the reference file)."""
    t = np.arange(rows) * dt
    T = np.maximum(t[-1], 1e-6)

    # Climb: septic blend 0 -> height over climb_s
    tau = t / climb_s
    s, ds, dds, ddds = _septic_blend(tau)
    pz = height * s
    vz = height * ds / climb_s
    az = height * dds / climb_s**2
    jz = height * ddds / climb_s**3

    # Lemniscate in xy, faded in after the climb with its own blend
    w = 2 * np.pi / period_s
    tau2 = (t - climb_s) / 2.0
    g, dg, ddg, dddg = _septic_blend(tau2)
    th = w * (t - climb_s) * (t > climb_s)
    sin, cos = np.sin(th), np.cos(th)
    # base lemniscate r(t) and derivatives (chain rule w/ constant w)
    x0, y0 = ax * sin, ay * np.sin(2 * th) / 2
    vx0, vy0 = ax * w * cos, ay * w * np.cos(2 * th)
    ax0, ay0_ = -ax * w**2 * sin, -2 * ay * w**2 * np.sin(2 * th)
    jx0, jy0 = -ax * w**3 * cos, -4 * ay * w**3 * np.cos(2 * th)
    # product with the fade g(t) (g' etc. in real time)
    dgdt, ddgdt, dddgdt = dg / 2.0, ddg / 4.0, dddg / 8.0
    px = g * x0
    py = g * y0
    vx = dgdt * x0 + g * vx0
    vy = dgdt * y0 + g * vy0
    axx = ddgdt * x0 + 2 * dgdt * vx0 + g * ax0
    ayy = ddgdt * y0 + 2 * dgdt * vy0 + g * ay0_
    jx = dddgdt * x0 + 3 * ddgdt * vx0 + 3 * dgdt * ax0 + g * jx0
    jy = dddgdt * y0 + 3 * ddgdt * vy0 + 3 * dgdt * ay0_ + g * jy0

    heading = np.full_like(t, 4.0)  # constant, like the reference file
    heading_rate = np.zeros_like(t)
    total_vel = np.sqrt(vx**2 + vy**2 + vz**2)
    total_acc = np.sqrt(axx**2 + ayy**2 + az**2)
    total_jerk = np.sqrt(jx**2 + jy**2 + jz**2)
    return np.column_stack([
        t, px, py, pz, vx, vy, vz, axx, ayy, az, jx, jy, jz,
        heading, heading_rate, total_vel, total_acc, total_jerk,
    ])


def write_csv(path: str, rows: int = ROWS) -> str:
    data = trajectory(rows)
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for r in data:
            f.write(",".join(repr(float(v)) for v in r) + ",\n")  # empty phi
    return path


def default_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "beta-traj.csv")


def ensure_csv() -> str:
    p = default_path()
    if not os.path.exists(p):
        write_csv(p)
    return p


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else default_path()
    print(write_csv(out))
