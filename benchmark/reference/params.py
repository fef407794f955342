"""The drone's and the controller's constants, worked out from a
configuration file's ``drone`` and ``dsl_pid`` groups (the upstream
``cf2x.urdf`` properties and ``DSLPIDControl`` gains).

Derived constants follow BaseAviary.__init__: hover and maximum RPM from the
thrust-to-weight ratio. They are formed in float64, then rounded to the
records' precision, as a float32 deployment stores them.
"""

import numpy as np


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def drone_constants(cfg: dict) -> dict:
    """Physical constants (float64) of ``cfg["drone"]`` and derived values."""
    d, g = cfg["drone"], float(cfg["g"])
    m, kf = float(d["m"]), float(d["kf"])
    gravity = g * m
    return dict(
        m=m, g=g, kf=kf, km=float(d["km"]), arm=float(d["arm"]),
        J=[float(d["ixx"]), float(d["iyy"]), float(d["izz"])],
        collision_h=float(d["collision_h"]), collision_z_offset=float(d["collision_z_offset"]),
        prop_offsets=[[float(v) for v in row] for row in d["prop_offsets"]],
        max_speed_kmh=float(d["max_speed_kmh"]),
        gravity=gravity,
        hover_rpm=float(np.sqrt(gravity / (4.0 * kf))),
        max_rpm=float(np.sqrt(float(d["thrust2weight"]) * gravity / (4.0 * kf))),
        yaw_sign=1.0,
    )


def speed_limit(cfg: dict) -> float:
    """VelocityAviary's speed limit, 3 % of the maximum speed, in m/s."""
    return 0.03 * float(cfg["drone"]["max_speed_kmh"]) * 1000.0 / 3600.0


def velocity_consts(cfg: dict) -> dict:
    """The constants of the VelocityAviary step in columns: the DSLPID gains
    and the plant, each rounded to float32 (the precision of the records a
    float32 deployment holds), as plain floats."""
    c, p = drone_constants(cfg), cfg["dsl_pid"]
    vec = lambda xs: [f32(x) for x in xs]
    return dict(
        p_for=vec(p["p_for"]), i_for=vec(p["i_for"]), d_for=vec(p["d_for"]),
        p_tor=vec(p["p_tor"]), i_tor=vec(p["i_tor"]), d_tor=vec(p["d_tor"]),
        mixer=[vec(row) for row in p["mixer"]],
        scale=f32(p["pwm2rpm_scale"]), const=f32(p["pwm2rpm_const"]),
        min_pwm=f32(p["min_pwm"]), max_pwm=f32(p["max_pwm"]),
        kf_c=f32(c["kf"]), grav=f32(c["gravity"]),
        kf=f32(c["kf"]), km=f32(c["km"]), yaw_sign=c["yaw_sign"],
        m_=f32(c["m"]), g_=f32(c["g"]),
        J=vec(c["J"]), Jinv=vec([1.0 / j for j in c["J"]]),
        offs=[vec(row) for row in c["prop_offsets"]],
        z_min=f32(c["collision_h"]) / 2.0 - f32(c["collision_z_offset"]),
    )
