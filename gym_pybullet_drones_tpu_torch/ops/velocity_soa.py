"""The VelocityAviary step in structure-of-arrays form (port of the JAX
``ops/velocity_soa.py``).

Every state component is a flat (E,) tensor and every operation a scalar
expression over those tensors. The math mirrors, term for term:

  * ``control/dsl_pid.py``, velocity pipeline of VelocityAviary.py:129-168
    with target_pos = cur_pos, so pos_e == 0;
  * ``core/dynamics.substep_pyb`` with Physics.PYB flags (thrust at prop
    offsets, yaw reaction torque, Newton-Euler, axis-angle quat update,
    ground clamp).

``velocity_step_soa`` is the plain version of the rollout kernel K1
(``csrc/velocity_rollout.cu``), which repeats this arithmetic per thread.
``physics_substep_soa`` also carries the coupled swarm's substeps
(``ops/swarm_soa.py``).
"""

from typing import Dict

import torch

from gym_pybullet_drones_tpu_torch.control.dsl_pid import DSLPIDParams
from gym_pybullet_drones_tpu_torch.core.params import DroneParams

# State component names: position, quaternion (xyzw), velocity, world angular
# velocity, last RPM per motor, PID integrals and last-rpy memory.
SOA_KEYS = (
    "px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz",
    "wx", "wy", "wz", "r0", "r1", "r2", "r3",
    "ipx", "ipy", "ipz", "irx", "iry", "irz", "lrx", "lry", "lrz",
)
ACTION_KEYS = ("ax", "ay", "az", "amag")


def soa_from_state(state) -> Dict[str, torch.Tensor]:
    """AviaryState (leaves (E, 1, d)) -> dict of (E,) component tensors."""
    kin = state.kin
    if kin.pos.shape[-2] != 1:
        raise ValueError(
            f"the SoA path is single-drone-per-env (got N={kin.pos.shape[-2]}); "
            "use the general envs/base step for multi-drone aviaries")
    s = {}
    groups = (
        (("px", "py", "pz"), kin.pos),
        (("qx", "qy", "qz", "qw"), kin.quat),
        (("vx", "vy", "vz"), kin.vel),
        (("wx", "wy", "wz"), kin.ang_v),
        (("r0", "r1", "r2", "r3"), state.last_rpm),
        (("ipx", "ipy", "ipz"), state.ctrl.integral_pos_e),
        (("irx", "iry", "irz"), state.ctrl.integral_rpy_e),
        (("lrx", "lry", "lrz"), state.ctrl.last_rpy),
    )
    for keys, x in groups:
        for i, k in enumerate(keys):
            s[k] = x[..., 0, i]
    return s


def soa_to_state(s: Dict[str, torch.Tensor], template, pyb_steps: int = 0):
    """dict of (E,) tensors -> AviaryState with the template's structure.

    rpy_rates follows ``core/dynamics.substep_pyb``: R(quat)^T @ ang_v,
    recomputed from the advanced columns. ``step_count`` is not an SoA
    column: it advances by ``pyb_steps`` (steps_per_ctrl × control steps).
    """
    pack = lambda ks: torch.stack([s[k] for k in ks], -1)[:, None, :]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_cols_from_quat(
        s["qx"], s["qy"], s["qz"], s["qw"])
    wx, wy, wz = s["wx"], s["wy"], s["wz"]
    rpy_rates = torch.stack([r00 * wx + r10 * wy + r20 * wz,
                             r01 * wx + r11 * wy + r21 * wz,
                             r02 * wx + r12 * wy + r22 * wz], -1)[:, None, :]
    kin = template.kin.replace(
        pos=pack(("px", "py", "pz")),
        quat=pack(("qx", "qy", "qz", "qw")),
        vel=pack(("vx", "vy", "vz")),
        ang_v=pack(("wx", "wy", "wz")),
        rpy_rates=rpy_rates,
    )
    return template.replace(
        kin=kin,
        last_rpm=pack(("r0", "r1", "r2", "r3")),
        ctrl=template.ctrl.replace(
            integral_pos_e=pack(("ipx", "ipy", "ipz")),
            integral_rpy_e=pack(("irx", "iry", "irz")),
            last_rpy=pack(("lrx", "lry", "lrz")),
        ),
        step_count=template.step_count + pyb_steps,
    )


def _div(x, c: float):
    """``x / c`` for a host float ``c``, as a true division on every device.
    PyTorch's CUDA kernels multiply by the float32 reciprocal of a host
    scalar instead, which rounds differently from the CPU and from K1."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _rot_cols_from_quat(qx, qy, qz, qw):
    """Rotation-matrix entries from an xyzw quaternion (quat_to_matrix)."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx_, wy_, wz_ = qw * qx, qw * qy, qw * qz
    r00 = 1 - 2 * (yy + zz); r01 = 2 * (xy - wz_); r02 = 2 * (xz + wy_)
    r10 = 2 * (xy + wz_); r11 = 1 - 2 * (xx + zz); r12 = 2 * (yz - wx_)
    r20 = 2 * (xz - wy_); r21 = 2 * (yz + wx_); r22 = 1 - 2 * (xx + yy)
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def soa_consts(cp: DSLPIDParams, dp: DroneParams) -> Dict[str, object]:
    """All parameters as plain Python floats. Pass records that live on the
    CPU: ``float()`` of a CUDA tensor waits for the card."""
    return dict(
        p_for=[float(cp.p_for[i]) for i in range(3)],
        i_for=[float(cp.i_for[i]) for i in range(3)],
        d_for=[float(cp.d_for[i]) for i in range(3)],
        p_tor=[float(cp.p_tor[i]) for i in range(3)],
        i_tor=[float(cp.i_tor[i]) for i in range(3)],
        d_tor=[float(cp.d_tor[i]) for i in range(3)],
        mixer=[[float(cp.mixer[m, k]) for k in range(3)] for m in range(4)],
        scale=float(cp.pwm2rpm_scale), const=float(cp.pwm2rpm_const),
        min_pwm=float(cp.min_pwm), max_pwm=float(cp.max_pwm),
        kf_c=float(cp.kf), grav=float(cp.gravity),
        **physics_consts(dp),
    )


def physics_consts(dp: DroneParams) -> Dict[str, object]:
    """``physics_substep_soa``'s constants as plain floats."""
    return dict(
        kf=float(dp.kf), km=float(dp.km), yaw_sign=float(dp.yaw_sign),
        m_=float(dp.m), g_=float(dp.g),
        J=[float(dp.J[i, i]) for i in range(3)],
        Jinv=[float(dp.J_inv[i, i]) for i in range(3)],
        offs=[[float(dp.prop_offsets[p_, k]) for k in range(3)] for p_ in range(4)],
        z_min=float(dp.collision_h) / 2.0 - float(dp.collision_z_offset),
    )


def motor_wrench_soa(c: Dict[str, object], rpm):
    """Total thrust and body torques (fsum, tau_x, tau_y, tau_z) from a list
    of four (E,) motor-speed columns. They depend on the RPMs alone, so a
    control step forms them once for all its substeps."""
    kf, km, yaw_sign, offs = c["kf"], c["km"], c["yaw_sign"], c["offs"]
    f = [rpm[m] * rpm[m] * kf for m in range(4)]
    t_m = [rpm[m] * rpm[m] * km * yaw_sign for m in range(4)]
    tau_z = -t_m[0] + t_m[1] - t_m[2] + t_m[3]
    tau_x = f[0] * offs[0][1] + f[1] * offs[1][1] + f[2] * offs[2][1] + f[3] * offs[3][1]
    tau_y = -(f[0] * offs[0][0] + f[1] * offs[1][0] + f[2] * offs[2][0] + f[3] * offs[3][0])
    fsum = f[0] + f[1] + f[2] + f[3]
    return fsum, tau_x, tau_y, tau_z


def physics_substep_soa(c: Dict[str, object], pyb_dt,
                        px, py, pz, qx, qy, qz, qw,
                        vx, vy, vz, wx, wy, wz, wrench, fz_body=None):
    """One Physics.PYB substep over SoA columns (the op sequence of
    ``core/dynamics.substep_pyb`` without aero terms). ``wrench`` is
    ``motor_wrench_soa`` of the step's RPMs. ``fz_body``, an optional (E,)
    body-z force at the COM (the coupled swarm's wake sum), joins the thrust
    before the accelerations, as ``substep_pyb``'s dense downwash term does:
    torque-free, and seen by the resting-contact test."""
    m_, g_ = c["m_"], c["g_"]
    J, Jinv, z_min = c["J"], c["Jinv"], c["z_min"]
    fsum, tau_x, tau_y, tau_z = wrench
    if fz_body is not None:
        fsum = fsum + fz_body

    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_cols_from_quat(qx, qy, qz, qw)
    axw, ayw, azw = _div(r02 * fsum, m_), _div(r12 * fsum, m_), _div(r22 * fsum, m_) - g_
    nvx, nvy, nvz = vx + pyb_dt * axw, vy + pyb_dt * ayw, vz + pyb_dt * azw

    # omega world -> body: R^T w
    obx = r00 * wx + r10 * wy + r20 * wz
    oby = r01 * wx + r11 * wy + r21 * wz
    obz = r02 * wx + r12 * wy + r22 * wz
    # coupling = w x (J w) (J diagonal)
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

    # integrate_quat (axis-angle, body rates nb)
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

    # plane contact clamp; `pressed` reads the pre-clamp acceleration
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
    """The commanded velocity (tvx, tvy, tvz): the action's heading scaled to
    ``speed_limit * |amag|``, zero for a zero heading. It depends on the
    action alone."""
    vnorm = torch.sqrt(ax * ax + ay * ay + az * az)
    safe = torch.clamp(vnorm, min=1e-12)
    fac = torch.where(vnorm > 0, speed_limit * torch.abs(amag) / safe,
                      torch.zeros_like(vnorm))
    return ax * fac, ay * fac, az * fac


def velocity_step_soa(consts: Dict[str, object], ctrl_dt, pyb_dt,
                      n_substeps: int, speed_limit,
                      s: Dict[str, torch.Tensor],
                      ax, ay, az, amag) -> Dict[str, torch.Tensor]:
    """One VelocityAviary control step in SoA form.

    ``s`` maps SOA_KEYS to (E,) tensors; (ax, ay, az, amag) is the velocity
    command; ``consts`` comes from ``soa_consts``. Returns the updated dict.
    """
    c = consts
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

    # ---------------- DSLPID, velocity pipeline --------------------------
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_cols_from_quat(qx, qy, qz, qw)
    # PyBullet-convention rpy (quat_to_euler_xyz)
    cur_roll = torch.atan2(r21, r22)
    cur_pitch = torch.asin(torch.clamp(-r20, -1.0, 1.0))
    cur_yaw = torch.atan2(r10, r00)

    tvx, tvy, tvz = velocity_target(speed_limit, ax, ay, az, amag)

    # pos_e == 0 (target_pos = cur_pos, VelocityAviary.py:164); integrals are
    # clipped but unchanged, z twice (the generic clip, then its own).
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
    # target x_c from current yaw (target_rpy = [0, 0, yaw])
    cyaw, syaw = torch.cos(cur_yaw), torch.sin(cur_yaw)
    # y_des = normalize(z_des x x_c)
    yx = zdy * 0.0 - zdz * syaw
    yy = zdz * cyaw - zdx * 0.0
    yz = zdx * syaw - zdy * cyaw
    yn = torch.sqrt(yx * yx + yy * yy + yz * yz)
    yx, yy, yz = yx / yn, yy / yn, yz / yn
    # x_des = y_des x z_des
    xx_ = yy * zdz - yz * zdy
    xy_ = yz * zdx - yx * zdz
    xz_ = yx * zdy - yy * zdx
    # Target rotation has columns (x_des, y_des, z_des); the reference's
    # matrix -> euler -> matrix round trip is a float no-op, skipped here.
    dcols = ((xx_, xy_, xz_), (yx, yy, yz), (zdx, zdy, zdz))
    rcols = ((r00, r10, r20), (r01, r11, r21), (r02, r12, r22))

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    # rot_matrix_e = Rd^T R - R^T Rd, vee components [(2,1), (0,2), (1,0)]
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

    # ---------------- physics substeps (Physics.PYB) ----------------------
    wrench = motor_wrench_soa(c, rpm)
    for _ in range(n_substeps):
        (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz) = (
            physics_substep_soa(c, pyb_dt, px, py, pz, qx, qy, qz, qw,
                                vx, vy, vz, wx, wy, wz, wrench))

    return dict(
        px=px, py=py, pz=pz, qx=qx, qy=qy, qz=qz, qw=qw,
        vx=vx, vy=vy, vz=vz, wx=wx, wy=wy, wz=wz,
        r0=rpm[0], r1=rpm[1], r2=rpm[2], r3=rpm[3],
        ipx=ip[0], ipy=ip[1], ipz=ip[2],
        irx=ir[0], iry=ir[1], irz=ir[2],
        lrx=cur_rpy[0], lry=cur_rpy[1], lrz=cur_rpy[2],
    )
