"""HoverAviary with ONE_D_RPM actions and KIN observations, batched over
envs, with auto-reset, in plain PyTorch.

A frozen copy of the arithmetic the port's Hover env step runs (the action
buffer, the ONE_D_RPM map ``hover_rpm * (1 + 0.05 a)``, Physics.PYB substeps
with the ground clamp, HoverAviary's obs, reward, termination and
truncation) and of the batched step's auto-reset (a non-finite env is
terminated and reset; finished envs restart from the reset state and keep
their action buffer). Leaves carry a leading env axis: pos, quat, vel,
ang_v, rpy_rates (E, N, 3 or 4), last_rpm (E, N, 4), buf (E, B, N, A),
count (E,) int32 (physics substeps so far).

Per-env plants (domain randomization) scale ``m`` and ``kf`` of each env by
its own factor; the plant's other constants, the action map's hover RPM
and the controller stay nominal.
"""

import numpy as np
import torch

from benchmark.reference.params import drone_constants

LEAVES = ("pos", "quat", "vel", "ang_v", "rpy_rates", "last_rpm", "buf", "count")


class Hover:
    """The env's configuration and plant on ``device``, in ``dtype``.
    ``plant_scale``: optional per-env factors ``{"m": (E,), "kf": (E,)}``."""

    def __init__(self, cfg: dict, device, dtype=torch.float32, plant_scale=None):
        env = cfg["env"]
        c = drone_constants(cfg)
        self.N, self.A, self.B = int(env["drones_per_env"]), 1, int(env["action_buffer_size"])
        self.pyb_freq, self.ctrl_freq = int(env["pyb_freq"]), int(env["ctrl_freq"])
        self.substeps = self.pyb_freq // self.ctrl_freq
        self.dt = 1.0 / self.pyb_freq
        self.episode_len_sec = float(env["episode_len_sec"])
        self.dtype, self.device = dtype, device
        t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=device)
        self.m, self.kf, self.km, self.g = t(c["m"]), t(c["kf"]), t(c["km"]), t(c["g"])
        self.yaw_sign = t(c["yaw_sign"])
        self.J = t(np.diag(c["J"]))
        self.J_inv = t(np.linalg.inv(np.diag(c["J"])))
        self.offs = t(c["prop_offsets"])
        self.hover_rpm = t(c["hover_rpm"])
        self.collision_h, self.collision_z_offset = t(c["collision_h"]), t(c["collision_z_offset"])
        self.arm = float(np.float32(c["arm"]))
        self.z0 = c["collision_h"] / 2 - c["collision_z_offset"] + 0.1
        self.target = torch.tensor([[0.0, 0.0, 1.0]], dtype=dtype, device=device)
        if plant_scale is not None:
            # (E, 1, 1): broadcast over drones and their components
            self.m = (self.m * plant_scale["m"])[:, None, None]
            self.kf = (self.kf * plant_scale["kf"])[:, None, None]

    # --- one env's reset state and observation ------------------------------
    def reset_one(self):
        N, dt, dev = self.N, self.dtype, self.device
        xyz = np.stack([4 * self.arm * np.arange(N), 4 * self.arm * np.arange(N),
                        np.full(N, self.z0)], 1)
        pos = torch.as_tensor(xyz, dtype=dt, device=dev)
        half = 0.5 * torch.zeros((N, 3), dtype=dt, device=dev)
        cr, cp, cy = torch.cos(half[:, 0]), torch.cos(half[:, 1]), torch.cos(half[:, 2])
        sr, sp, sy = torch.sin(half[:, 0]), torch.sin(half[:, 1]), torch.sin(half[:, 2])
        quat = torch.stack([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                            cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy], -1)
        z = torch.zeros_like(pos)
        return dict(pos=pos, quat=quat, vel=z, ang_v=z.clone(), rpy_rates=z.clone(),
                    last_rpm=torch.zeros((N, 4), dtype=dt, device=dev),
                    buf=torch.zeros((self.B, N, self.A), dtype=dt, device=dev),
                    count=torch.zeros((), dtype=torch.int32, device=dev))

    def reset(self, E):
        one = self.reset_one()
        return {k: v.expand((E,) + v.shape).clone() for k, v in one.items()}

    def obs(self, s):
        full = torch.cat([s["pos"], s["quat"], quat_to_euler_xyz(s["quat"]), s["vel"],
                          s["ang_v"], s["last_rpm"]], -1)
        obs12 = torch.cat([full[..., 0:3], full[..., 7:16]], -1)
        buf = torch.movedim(s["buf"], -3, -2)
        return torch.cat([obs12, buf.reshape(buf.shape[:-2] + (-1,))], -1)

    # --- the env step ---------------------------------------------------------
    def _substep(self, s, rpm):
        dt = self.dt
        R = quat_to_matrix(s["quat"])
        forces = rpm ** 2 * self.kf
        torques = rpm ** 2 * self.km * self.yaw_sign
        z_torque = -torques[..., 0] + torques[..., 1] - torques[..., 2] + torques[..., 3]
        tau_x = (forces * self.offs[:, 1]).sum(-1)
        tau_y = -(forces * self.offs[:, 0]).sum(-1)
        torques_body = torch.stack([tau_x, tau_y, z_torque], -1)
        thrust = torch.sum(forces, dim=-1)
        force_world = R[..., :, 2] * thrust[..., None]
        accel = force_world / self.m
        accel = torch.cat([accel[..., :2], accel[..., 2:] - self.g], -1)
        new_vel = s["vel"] + dt * accel
        omega_body = (R * s["ang_v"][..., :, None]).sum(-2)
        coupling = cross(omega_body, matvec(self.J, omega_body))
        omega_dot = matvec(self.J_inv, torques_body - coupling)
        new_omega_body = omega_body + dt * omega_dot
        new_ang_v = (R * new_omega_body[..., None, :]).sum(-1)
        new_pos = s["pos"] + dt * new_vel
        new_quat = quat_normalize(integrate_quat(s["quat"], new_omega_body, dt))
        z_min = self.collision_h / 2.0 - self.collision_z_offset
        pz, vz = new_pos[..., 2], new_vel[..., 2]
        below = pz < z_min
        new_pos = torch.cat([new_pos[..., :2], torch.where(below, z_min, pz)[..., None]], -1)
        new_vel = torch.cat([new_vel[..., :2],
                             torch.where(below, torch.clamp(vz, min=0.0), vz)[..., None]], -1)
        pressed = below & (accel[..., 2] <= 0.0)
        new_ang_v = torch.where(pressed[..., None], torch.zeros_like(new_ang_v), new_ang_v)
        rpy_rates = (quat_to_matrix(new_quat) * new_ang_v[..., :, None]).sum(-2)
        return dict(s, pos=new_pos, quat=new_quat, vel=new_vel, ang_v=new_ang_v,
                    rpy_rates=rpy_rates)

    def env_step(self, s, action):
        """One control step of every env (no reset): ``(state, obs, reward,
        terminated, truncated)``; ``action`` is (E, N, A)."""
        buf = torch.cat([s["buf"][:, 1:], action.unsqueeze(1)], dim=1)
        s = dict(s, buf=buf)
        rpm = self.hover_rpm * (1.0 + 0.05 * action.repeat_interleave(4, dim=-1))
        for _ in range(self.substeps):
            s = self._substep(s, rpm)
        s = dict(s, last_rpm=rpm, count=s["count"] + self.substeps)
        obs = self.obs(s)
        err = norm3(self.target - s["pos"])
        reward = torch.sum(torch.clamp(2.0 - err ** 4, min=0.0), dim=-1)
        terminated = err[..., 0] < 1e-4
        pos, rpy = s["pos"], quat_to_euler_xyz(s["quat"])
        out = ((torch.abs(pos[..., 0]) > 1.5) | (torch.abs(pos[..., 1]) > 1.5)
               | (pos[..., 2] > 2.0) | (torch.abs(rpy[..., 0]) > 0.4)
               | (torch.abs(rpy[..., 1]) > 0.4))
        pre_count = s["count"] - self.substeps
        timeout = pre_count / self.pyb_freq > self.episode_len_sec
        return s, obs, reward, terminated, torch.any(out, dim=-1) | timeout

    def batched_step(self, s, action):
        """``env_step`` with auto-reset: returns ``(state, (obs, reward,
        terminated, truncated, final_obs))``."""
        init = self.reset_one()
        init_obs = self.obs(init)
        new, obs, reward, term, trunc = self.env_step(s, action)
        E = obs.shape[0]
        fresh = {k: v.expand((E,) + v.shape).clone() for k, v in init.items()}
        finite = lambda x: torch.isfinite(x).flatten(1).all(dim=1)
        unhealthy = ~(finite(new["pos"]) & finite(new["quat"]) & finite(new["vel"])
                      & finite(new["ang_v"]) & finite(new["rpy_rates"]))
        term = term | unhealthy
        reward = torch.where(unhealthy, torch.zeros_like(reward), reward)
        obs = where_env(unhealthy, init_obs.expand(obs.shape), obs)
        done = term | trunc
        kept_buf = new["buf"]
        new = {k: where_env(done, fresh[k], new[k]) for k in LEAVES}
        new["buf"] = kept_buf
        final_obs = obs
        obs = where_env(done, self.obs(new), obs)
        return new, (obs, reward, term, trunc, final_obs)


def where_env(mask, a, b):
    """``a`` where the per-env ``mask`` holds, else ``b``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)


def norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def matvec(M, v):
    return torch.stack([M[i, 0] * v[..., 0] + M[i, 1] * v[..., 1] + M[i, 2] * v[..., 2]
                        for i in range(3)], -1)


def quat_to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], -1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], -1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_to_euler_xyz(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    r10 = 2.0 * (x * y + w * z)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    return torch.stack([torch.atan2(r21, r22), torch.asin(torch.clamp(-r20, -1.0, 1.0)),
                        torch.atan2(r10, r00)], -1)


def quat_normalize(q, eps=1e-12):
    n = torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
                   + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])
    return q / torch.clamp(n, min=eps)[..., None]


def integrate_quat(quat, omega, dt, eps=1e-9):
    """The axis-angle update of BaseAviary._integrateQ under body rates."""
    n2 = omega[..., 0:1] * omega[..., 0:1] + omega[..., 1:2] * omega[..., 1:2] \
        + omega[..., 2:3] * omega[..., 2:3]
    small = n2 <= eps * eps
    ex = torch.zeros_like(omega)
    ex[..., 0] = 1.0
    safe = torch.where(small, ex, omega)
    omega_norm = norm3(safe)[..., None]
    p, q_, r = omega[..., 0:1], omega[..., 1:2], omega[..., 2:3]
    x, y, z, w = quat[..., 0:1], quat[..., 1:2], quat[..., 2:3], quat[..., 3:4]
    mq = torch.cat([r * y - q_ * z + p * w, -r * x + p * z + q_ * w,
                    q_ * x - p * y + r * w, -p * x - q_ * y - r * z], -1)
    theta = omega_norm * dt / 2.0
    out = torch.cos(theta) * quat + torch.sin(theta) / omega_norm * mq
    return torch.where(small, quat, out)
