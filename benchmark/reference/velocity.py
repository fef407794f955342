"""The VelocityAviary control step over (E,) columns, in plain PyTorch.

A frozen copy of the port's plain VelocityAviary step in columns (the DSLPID
velocity pipeline of VelocityAviary.py:129-168 with target_pos = cur_pos,
then ``n_substeps`` Physics.PYB substeps: thrust at the prop offsets, yaw
reaction torque, Newton-Euler, the axis-angle quaternion update, the ground
clamp), operation for operation, so that in float32 on the card it rounds
as the port's rollout kernel does. In float64 it is the reference of one
control step. The dtype follows the state's columns.
"""

import torch

SOA_KEYS = (
    "px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz",
    "wx", "wy", "wz", "r0", "r1", "r2", "r3",
    "ipx", "ipy", "ipz", "irx", "iry", "irz", "lrx", "lry", "lrz",
)
ACTION_KEYS = ("ax", "ay", "az", "amag")


def reset_columns(cfg: dict, E: int, dtype, device):
    """The reset state of ``E`` single-drone envs: at rest at the default
    spawn (0, 0, h / 2 - z_offset + 0.1), level, controller memory zero."""
    d = cfg["drone"]
    z0 = float(d["collision_h"]) / 2 - float(d["collision_z_offset"]) + 0.1
    cols = {k: torch.zeros(E, dtype=dtype, device=device) for k in SOA_KEYS}
    cols["pz"] = torch.full((E,), z0, dtype=dtype, device=device)
    cols["qw"] = torch.ones(E, dtype=dtype, device=device)
    return cols


def _div(x, c: float):
    """``x / c`` as a true division (CUDA kernels multiply by the float32
    reciprocal of a host scalar, which rounds otherwise)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def rot_cols(qx, qy, qz, qw):
    """Rotation-matrix entries of an xyzw quaternion."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx_, wy_, wz_ = qw * qx, qw * qy, qw * qz
    r00 = 1 - 2 * (yy + zz); r01 = 2 * (xy - wz_); r02 = 2 * (xz + wy_)
    r10 = 2 * (xy + wz_); r11 = 1 - 2 * (xx + zz); r12 = 2 * (yz - wx_)
    r20 = 2 * (xz - wy_); r21 = 2 * (yz + wx_); r22 = 1 - 2 * (xx + yy)
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def rpy_cols(qx, qy, qz, qw):
    """PyBullet-convention roll, pitch, yaw of an xyzw quaternion."""
    r00, _, _, r10, _, _, r20, r21, r22 = rot_cols(qx, qy, qz, qw)
    return (torch.atan2(r21, r22), torch.asin(torch.clamp(-r20, -1.0, 1.0)),
            torch.atan2(r10, r00))


def motor_wrench(c, rpm):
    """Total thrust and body torques from the four motor speeds."""
    kf, km, yaw_sign, offs = c["kf"], c["km"], c["yaw_sign"], c["offs"]
    f = [rpm[m] * rpm[m] * kf for m in range(4)]
    t_m = [rpm[m] * rpm[m] * km * yaw_sign for m in range(4)]
    tau_z = -t_m[0] + t_m[1] - t_m[2] + t_m[3]
    tau_x = f[0] * offs[0][1] + f[1] * offs[1][1] + f[2] * offs[2][1] + f[3] * offs[3][1]
    tau_y = -(f[0] * offs[0][0] + f[1] * offs[1][0] + f[2] * offs[2][0] + f[3] * offs[3][0])
    fsum = f[0] + f[1] + f[2] + f[3]
    return fsum, tau_x, tau_y, tau_z


def substep(c, pyb_dt, px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz, wrench):
    """One Physics.PYB substep (no aero terms)."""
    m_, g_ = c["m_"], c["g_"]
    J, Jinv, z_min = c["J"], c["Jinv"], c["z_min"]
    fsum, tau_x, tau_y, tau_z = wrench
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot_cols(qx, qy, qz, qw)
    axw, ayw, azw = _div(r02 * fsum, m_), _div(r12 * fsum, m_), _div(r22 * fsum, m_) - g_
    nvx, nvy, nvz = vx + pyb_dt * axw, vy + pyb_dt * ayw, vz + pyb_dt * azw
    obx = r00 * wx + r10 * wy + r20 * wz
    oby = r01 * wx + r11 * wy + r21 * wz
    obz = r02 * wx + r12 * wy + r22 * wz
    cx = oby * (J[2] * obz) - obz * (J[1] * oby)
    cy = obz * (J[0] * obx) - obx * (J[2] * obz)
    cz = obx * (J[1] * oby) - oby * (J[0] * obx)
    nbx = obx + pyb_dt * Jinv[0] * (tau_x - cx)
    nby = oby + pyb_dt * Jinv[1] * (tau_y - cy)
    nbz = obz + pyb_dt * Jinv[2] * (tau_z - cz)
    nwx = r00 * nbx + r01 * nby + r02 * nbz
    nwy = r10 * nbx + r11 * nby + r12 * nbz
    nwz = r20 * nbx + r21 * nby + r22 * nbz
    npx, npy, npz = px + pyb_dt * nvx, py + pyb_dt * nvy, pz + pyb_dt * nvz
    onorm = torch.sqrt(nbx * nbx + nby * nby + nbz * nbz)
    sn = torch.clamp(onorm, min=1e-9)
    theta = sn * pyb_dt / 2.0
    ct, st = torch.cos(theta), torch.sin(theta) / sn
    mqx = nbz * qy - nby * qz + nbx * qw
    mqy = -nbz * qx + nbx * qz + nby * qw
    mqz = nby * qx - nbx * qy + nbz * qw
    mqw = -nbx * qx - nby * qy - nbz * qz
    big = onorm > 1e-9
    nqx = torch.where(big, ct * qx + st * mqx, qx)
    nqy = torch.where(big, ct * qy + st * mqy, qy)
    nqz = torch.where(big, ct * qz + st * mqz, qz)
    nqw = torch.where(big, ct * qw + st * mqw, qw)
    qn = torch.sqrt(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw)
    nqx, nqy, nqz, nqw = nqx / qn, nqy / qn, nqz / qn, nqw / qn
    below = npz < z_min
    npz = torch.where(below, z_min, npz)
    nvz = torch.where(below, torch.clamp(nvz, min=0.0), nvz)
    pressed = below & (azw <= 0.0)
    zero = torch.zeros_like(nwx)
    nwx = torch.where(pressed, zero, nwx)
    nwy = torch.where(pressed, zero, nwy)
    nwz = torch.where(pressed, zero, nwz)
    return (npx, npy, npz, nqx, nqy, nqz, nqw, nvx, nvy, nvz, nwx, nwy, nwz)


def velocity_target(speed_limit, ax, ay, az, amag):
    """The commanded velocity: the heading scaled to speed_limit * |amag|."""
    vnorm = torch.sqrt(ax * ax + ay * ay + az * az)
    safe = torch.clamp(vnorm, min=1e-12)
    fac = torch.where(vnorm > 0, speed_limit * torch.abs(amag) / safe,
                      torch.zeros_like(vnorm))
    return ax * fac, ay * fac, az * fac


def control_step(c, ctrl_dt, pyb_dt, n_substeps, speed_limit, s, ax, ay, az, amag):
    """One VelocityAviary control step: ``s`` maps ``SOA_KEYS`` to (E,)
    columns, (ax, ay, az, amag) is the command. Returns the new columns."""
    i_for, d_for = c["i_for"], c["d_for"]
    p_tor, i_tor, d_tor = c["p_tor"], c["i_tor"], c["d_tor"]
    mixer = c["mixer"]
    scale, const = c["scale"], c["const"]
    min_pwm, max_pwm = c["min_pwm"], c["max_pwm"]
    kf_c, grav = c["kf_c"], c["grav"]
    px, py, pz = s["px"], s["py"], s["pz"]
    qx, qy, qz, qw = s["qx"], s["qy"], s["qz"], s["qw"]
    vx, vy, vz = s["vx"], s["vy"], s["vz"]
    wx, wy, wz = s["wx"], s["wy"], s["wz"]
    ipz_ = [s["ipx"], s["ipy"], s["ipz"]]
    ir = [s["irx"], s["iry"], s["irz"]]
    lr = [s["lrx"], s["lry"], s["lrz"]]

    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot_cols(qx, qy, qz, qw)
    cur_roll = torch.atan2(r21, r22)
    cur_pitch = torch.asin(torch.clamp(-r20, -1.0, 1.0))
    cur_yaw = torch.atan2(r10, r00)
    tvx, tvy, tvz = velocity_target(speed_limit, ax, ay, az, amag)
    # pos_e == 0: the integrals are clipped but unchanged, z twice
    ip = [torch.clamp(ipz_[0], -2.0, 2.0), torch.clamp(ipz_[1], -2.0, 2.0),
          torch.clamp(torch.clamp(ipz_[2], -2.0, 2.0), -0.15, 0.15)]
    ex, ey, ez = tvx - vx, tvy - vy, tvz - vz
    ttx = i_for[0] * ip[0] + d_for[0] * ex
    tty = i_for[1] * ip[1] + d_for[1] * ey
    ttz = i_for[2] * ip[2] + d_for[2] * ez + grav
    scalar_thrust = torch.clamp(ttx * r02 + tty * r12 + ttz * r22, min=0.0)
    thrust_pwm = _div(torch.sqrt(_div(scalar_thrust, 4.0 * kf_c)) - const, scale)
    tnorm = torch.sqrt(ttx * ttx + tty * tty + ttz * ttz)
    zdx, zdy, zdz = ttx / tnorm, tty / tnorm, ttz / tnorm
    cyaw, syaw = torch.cos(cur_yaw), torch.sin(cur_yaw)
    yx = zdy * 0.0 - zdz * syaw
    yy = zdz * cyaw - zdx * 0.0
    yz = zdx * syaw - zdy * cyaw
    yn = torch.sqrt(yx * yx + yy * yy + yz * yz)
    yx, yy, yz = yx / yn, yy / yn, yz / yn
    xx_ = yy * zdz - yz * zdy
    xy_ = yz * zdx - yx * zdz
    xz_ = yx * zdy - yy * zdx
    dcols = ((xx_, xy_, xz_), (yx, yy, yz), (zdx, zdy, zdz))
    rcols = ((r00, r10, r20), (r01, r11, r21), (r02, r12, r22))

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    e21 = dot3(dcols[2], rcols[1]) - dot3(rcols[2], dcols[1])
    e02 = dot3(dcols[0], rcols[2]) - dot3(rcols[0], dcols[2])
    e10 = dot3(dcols[1], rcols[0]) - dot3(rcols[1], dcols[0])
    rot_e = [e21, e02, e10]
    cur_rpy = [cur_roll, cur_pitch, cur_yaw]
    rr_e = [_div(-(cur_rpy[k] - lr[k]), ctrl_dt) for k in range(3)]
    ir = [torch.clamp(ir[k] - rot_e[k] * ctrl_dt, -1500.0, 1500.0) for k in range(3)]
    ir[0] = torch.clamp(ir[0], -1.0, 1.0)
    ir[1] = torch.clamp(ir[1], -1.0, 1.0)
    tq = [torch.clamp(-p_tor[k] * rot_e[k] + d_tor[k] * rr_e[k] + i_tor[k] * ir[k],
                      -3200.0, 3200.0) for k in range(3)]
    rpm = []
    for m in range(4):
        pwm = thrust_pwm + mixer[m][0] * tq[0] + mixer[m][1] * tq[1] + mixer[m][2] * tq[2]
        pwm = torch.clamp(pwm, min_pwm, max_pwm)
        rpm.append(scale * pwm + const)

    wrench = motor_wrench(c, rpm)
    for _ in range(n_substeps):
        (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz) = substep(
            c, pyb_dt, px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz, wrench)
    return dict(
        px=px, py=py, pz=pz, qx=qx, qy=qy, qz=qz, qw=qw,
        vx=vx, vy=vy, vz=vz, wx=wx, wy=wy, wz=wz,
        r0=rpm[0], r1=rpm[1], r2=rpm[2], r3=rpm[3],
        ipx=ip[0], ipy=ip[1], ipz=ip[2],
        irx=ir[0], iry=ir[1], irz=ir[2],
        lrx=cur_rpy[0], lry=cur_rpy[1], lrz=cur_rpy[2],
    )


def rollout(c, ctrl_dt, pyb_dt, n_substeps, speed_limit, num_steps, s, action, graph=False):
    """``num_steps`` control steps from columns ``s`` under the fixed command
    ``action`` (a dict of ``ACTION_KEYS`` columns). ``graph=True`` (CUDA
    columns only) captures one step in a CUDA graph and replays it: the same
    kernels, launched without the host between them."""
    a = [action[k] for k in ACTION_KEYS]
    step = lambda cols: control_step(c, ctrl_dt, pyb_dt, n_substeps, speed_limit, cols, *a)
    if not graph:
        for _ in range(num_steps):
            s = step(s)
        return s
    static = {k: v.clone() for k, v in s.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator outside the capture
        step({k: v.clone() for k, v in static.items()})
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step(static)
        for k in SOA_KEYS:
            static[k].copy_(out[k])
    for _ in range(num_steps):
        g.replay()
    torch.cuda.synchronize()
    return {k: v.clone() for k, v in static.items()}


def obs_columns(s):
    """The 20-wide KIN observation of VelocityAviary (BaseAviary's state
    vector: pos, quat, rpy, vel, ang_v, last rpm) from the columns, (E, 20)."""
    roll, pitch, yaw = rpy_cols(s["qx"], s["qy"], s["qz"], s["qw"])
    cols = [s["px"], s["py"], s["pz"], s["qx"], s["qy"], s["qz"], s["qw"], roll, pitch, yaw,
            s["vx"], s["vy"], s["vz"], s["wx"], s["wy"], s["wz"],
            s["r0"], s["r1"], s["r2"], s["r3"]]
    return torch.stack(cols, -1)
