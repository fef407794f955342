"""Per-model physical parameters as a frozen dataclass of tensors.

Port of the JAX package's ``core/params.py``. The reference stores all physical
coefficients in custom ``<properties>`` tags of its URDF files
(BaseAviary._parseURDFParameters, BaseAviary.py:985-1017); here each drone
model is a ``DroneParams`` record with the same numeric values (the port's own
copies of the URDFs live in ``assets/``), plus the derived constants of
BaseAviary.__init__ (BaseAviary.py:117-128). Derived values are computed in
float64 numpy and then cast, so a float64 ``DroneParams`` equals the JAX one
field for field.

These are physical constants, not learnable weights, so the record is not an
``nn.Module``. ``randomize_params`` batches a record over envs with a
perturbed plant each (domain randomization).
"""

import dataclasses
import os
import xml.etree.ElementTree as etxml
from typing import Any

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import (
    TensorStruct,
    resolve_device,
    resolve_dtype,
)
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel

G = 9.8  # gravitational acceleration used throughout the reference (BaseAviary.py:74)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")


# Raw per-model property tables. Keys mirror the URDF <properties> attributes plus
# inertial/collision data. ``prop_offsets`` are the propeller link inertial-frame
# origins (cf2x.urdf:42-89, cf2p.urdf:42-80, racer.urdf:36-74); in PYB-mode physics
# the per-prop thrust is applied at these body-frame points.
_MODEL_TABLE: dict[DroneModel, dict[str, Any]] = {
    DroneModel.CF2X: dict(
        m=0.027,
        arm=0.0397,
        kf=3.16e-10,
        km=7.94e-12,
        thrust2weight=2.25,
        max_speed_kmh=30.0,
        gnd_eff_coeff=11.36859,
        prop_radius=2.31348e-2,
        drag_coeff_xy=9.1785e-7,
        drag_coeff_z=10.311e-7,
        dw_coeff_1=2267.18,
        dw_coeff_2=0.16,
        dw_coeff_3=-0.11,
        ixx=1.4e-5,
        iyy=1.4e-5,
        izz=2.17e-5,
        collision_h=0.025,
        collision_r=0.06,
        collision_z_offset=0.0,
        prop_offsets=[
            [0.028, -0.028, 0.0],
            [-0.028, -0.028, 0.0],
            [-0.028, 0.028, 0.0],
            [0.028, 0.028, 0.0],
        ],
    ),
    DroneModel.CF2P: dict(
        m=0.027,
        arm=0.0397,
        kf=3.16e-10,
        km=7.94e-12,
        thrust2weight=2.25,
        max_speed_kmh=30.0,
        gnd_eff_coeff=11.36859,
        prop_radius=2.31348e-2,
        drag_coeff_xy=9.1785e-7,
        drag_coeff_z=10.311e-7,
        dw_coeff_1=2267.18,
        dw_coeff_2=0.16,
        dw_coeff_3=-0.11,
        ixx=2.3951e-5,
        iyy=2.3951e-5,
        izz=3.2347e-5,
        collision_h=0.025,
        collision_r=0.06,
        collision_z_offset=0.0,
        prop_offsets=[
            [0.0397, 0.0, 0.0],
            [0.0, 0.0397, 0.0],
            [-0.0397, 0.0, 0.0],
            [0.0, -0.0397, 0.0],
        ],
    ),
    DroneModel.RACE: dict(
        m=0.830,
        arm=0.109,
        kf=8.47e-9,
        km=2.13e-11,
        thrust2weight=4.17,
        max_speed_kmh=200.0,
        gnd_eff_coeff=11.36859,
        prop_radius=12.7e-2,
        drag_coeff_xy=9.1785e-7,
        drag_coeff_z=10.311e-7,
        dw_coeff_1=2267.18,
        dw_coeff_2=0.16,
        dw_coeff_3=-0.11,
        ixx=0.003113,
        iyy=0.003113,
        izz=0.003113,
        collision_h=0.025,
        collision_r=0.06,
        collision_z_offset=0.0,
        prop_offsets=[
            [0.0850, 0.0675, 0.0],
            [-0.0850, 0.0675, 0.0],
            [-0.0850, -0.0675, 0.0],
            [0.0850, -0.0675, 0.0],
        ],
    ),
}

_MODEL_INDEX = {DroneModel.CF2X: 0, DroneModel.CF2P: 1, DroneModel.RACE: 2}


@dataclasses.dataclass(frozen=True)
class DroneParams(TensorStruct):
    """All per-vehicle physical constants, as 0-d tensors and small arrays.

    ``model_index`` encodes CF2X=0 / CF2P=1 / RACE=2; the x/y torque geometry
    is carried numerically in ``dyn_xy_mix`` and ``prop_offsets``.
    """

    m: torch.Tensor
    arm: torch.Tensor
    kf: torch.Tensor
    km: torch.Tensor
    thrust2weight: torch.Tensor
    max_speed_kmh: torch.Tensor
    gnd_eff_coeff: torch.Tensor
    prop_radius: torch.Tensor
    drag_coeff: torch.Tensor  # (3,) [xy, xy, z]
    dw_coeff_1: torch.Tensor
    dw_coeff_2: torch.Tensor
    dw_coeff_3: torch.Tensor
    J: torch.Tensor  # (3, 3)
    J_inv: torch.Tensor  # (3, 3)
    collision_h: torch.Tensor
    collision_r: torch.Tensor
    collision_z_offset: torch.Tensor
    prop_offsets: torch.Tensor  # (4, 3) body-frame prop positions
    dyn_xy_mix: torch.Tensor  # (2, 4) DYN torque mixing (BaseAviary.py:846-856)
    yaw_sign: torch.Tensor  # +1 or -1 (RACE flips reaction torque sign)
    gravity: torch.Tensor  # m * g
    hover_rpm: torch.Tensor
    max_rpm: torch.Tensor
    max_thrust: torch.Tensor
    max_xy_torque: torch.Tensor
    max_z_torque: torch.Tensor
    gnd_eff_h_clip: torch.Tensor
    g: torch.Tensor
    model_index: torch.Tensor


def _dyn_xy_mix(model: DroneModel, L: float) -> np.ndarray:
    """(2,4) matrix mapping per-motor forces to x/y torques in DYN mode."""
    if model == DroneModel.CF2X:
        a = L / np.sqrt(2.0)
        return np.array([[-a, -a, a, a], [-a, a, a, -a]])
    if model == DroneModel.CF2P:
        return np.array([[0.0, L, 0.0, -L], [-L, 0.0, L, 0.0]])
    # RACE (X config, but positive x_torque sign: BaseAviary.py:847-849)
    a = L / np.sqrt(2.0)
    return np.array([[a, a, -a, -a], [-a, a, a, -a]])


def _build(table: dict[str, Any], model: DroneModel, dtype, device) -> DroneParams:
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    t = {k: np.asarray(v, dtype=np.float64) for k, v in table.items()}
    m, kf, km = float(t["m"]), float(t["kf"]), float(t["km"])
    t2w = float(t["thrust2weight"])
    gravity = G * m
    hover_rpm = np.sqrt(gravity / (4.0 * kf))
    max_rpm = np.sqrt((t2w * gravity) / (4.0 * kf))
    max_thrust = 4.0 * kf * max_rpm**2
    L = float(t["arm"])
    if model == DroneModel.CF2P:
        max_xy_torque = L * kf * max_rpm**2
    else:
        max_xy_torque = (2.0 * L * kf * max_rpm**2) / np.sqrt(2.0)
    max_z_torque = 2.0 * km * max_rpm**2
    prop_radius = float(t["prop_radius"])
    gnd_eff_coeff = float(t["gnd_eff_coeff"])
    gnd_eff_h_clip = 0.25 * prop_radius * np.sqrt(
        (15.0 * max_rpm**2 * kf * gnd_eff_coeff) / max_thrust
    )
    J = np.diag([float(t["ixx"]), float(t["iyy"]), float(t["izz"])])
    arr = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                                    device=device)
    return DroneParams(
        m=arr(m),
        arm=arr(L),
        kf=arr(kf),
        km=arr(km),
        thrust2weight=arr(t2w),
        max_speed_kmh=arr(t["max_speed_kmh"]),
        gnd_eff_coeff=arr(gnd_eff_coeff),
        prop_radius=arr(prop_radius),
        drag_coeff=arr(
            [float(t["drag_coeff_xy"]), float(t["drag_coeff_xy"]), float(t["drag_coeff_z"])]
        ),
        dw_coeff_1=arr(t["dw_coeff_1"]),
        dw_coeff_2=arr(t["dw_coeff_2"]),
        dw_coeff_3=arr(t["dw_coeff_3"]),
        J=arr(J),
        J_inv=arr(np.linalg.inv(J)),
        collision_h=arr(t["collision_h"]),
        collision_r=arr(t["collision_r"]),
        collision_z_offset=arr(t["collision_z_offset"]),
        prop_offsets=arr(t["prop_offsets"]),
        dyn_xy_mix=arr(_dyn_xy_mix(model, L)),
        yaw_sign=arr(-1.0 if model == DroneModel.RACE else 1.0),
        gravity=arr(gravity),
        hover_rpm=arr(hover_rpm),
        max_rpm=arr(max_rpm),
        max_thrust=arr(max_thrust),
        max_xy_torque=arr(max_xy_torque),
        max_z_torque=arr(max_z_torque),
        gnd_eff_h_clip=arr(gnd_eff_h_clip),
        g=arr(G),
        model_index=torch.tensor(_MODEL_INDEX[model], dtype=torch.int32, device=device),
    )


def drone_params(model: DroneModel = DroneModel.CF2X, dtype=torch.float32,
                 device=None) -> DroneParams:
    """The parameter record of a built-in drone model."""
    return _build(_MODEL_TABLE[model], model, dtype, device)


def urdf_path(model: DroneModel) -> str:
    """Path of the port's own copy of a built-in model's URDF."""
    return os.path.join(ASSETS, f"{model.value}.urdf")


def from_urdf(path: str, model: DroneModel = DroneModel.CF2X, dtype=torch.float32,
              device=None) -> DroneParams:
    """Loader for reference-style URDFs.

    Reads the custom ``<properties>`` attributes, base inertial values,
    collision cylinder and propeller link offsets the way the reference does
    (BaseAviary._parseURDFParameters, BaseAviary.py:985-1017), by tag and
    attribute name. ``model`` selects the torque-sign conventions (X vs +
    mixing, racer yaw flip).
    """
    root = etxml.parse(path).getroot()
    props = root.find("properties").attrib
    links = root.findall("link")
    base = links[0]
    inertial = base.find("inertial")
    inertia = inertial.find("inertia").attrib
    cyl = base.find("collision/geometry/cylinder").attrib
    col_origin = base.find("collision/origin").attrib.get("xyz", "0 0 0").split()
    prop_offsets = []
    for link in links:
        if link.get("name", "").startswith("prop"):
            xyz = link.find("inertial/origin").attrib.get("xyz", "0 0 0").split()
            prop_offsets.append([float(v) for v in xyz])
    table = dict(
        m=float(inertial.find("mass").attrib["value"]),
        arm=float(props["arm"]),
        kf=float(props["kf"]),
        km=float(props["km"]),
        thrust2weight=float(props["thrust2weight"]),
        max_speed_kmh=float(props["max_speed_kmh"]),
        gnd_eff_coeff=float(props["gnd_eff_coeff"]),
        prop_radius=float(props["prop_radius"]),
        drag_coeff_xy=float(props["drag_coeff_xy"]),
        drag_coeff_z=float(props["drag_coeff_z"]),
        dw_coeff_1=float(props["dw_coeff_1"]),
        dw_coeff_2=float(props["dw_coeff_2"]),
        dw_coeff_3=float(props["dw_coeff_3"]),
        ixx=float(inertia["ixx"]),
        iyy=float(inertia["iyy"]),
        izz=float(inertia["izz"]),
        collision_h=float(cyl["length"]),
        collision_r=float(cyl["radius"]),
        collision_z_offset=float(col_origin[2]),
        prop_offsets=prop_offsets,
    )
    return _build(table, model, dtype, device)


# Fractional-jitter spec keys -> the base PLANT fields they scale.
RANDOMIZABLE = ("m", "kf", "km", "inertia", "drag", "gnd_eff_coeff",
                "dw_coeff_1")


def randomize_params(generator: torch.Generator, params: DroneParams, num_envs: int,
                     spec: dict) -> DroneParams:
    """Domain randomization: a DroneParams whose leaves carry a leading
    (num_envs,) axis.

    ``spec`` maps a key of ``RANDOMIZABLE`` to a fractional half-width f: the
    field is scaled by an independent per-env factor ~ U(1-f, 1+f), drawn
    from ``generator`` (one draw of ``num_envs`` values a key, keys in sorted
    order, on the generator's device). "inertia" scales the J diagonal (and
    divides J_inv by the same factor), "drag" the (3,) drag_coeff vector; the
    rest scale the matching scalar field. Geometry is never randomized: it
    sets the mixer and the spawn grid.

    Only the plant is perturbed. hover_rpm, max_rpm, the thrust and torque
    caps, gnd_eff_h_clip and gravity stay nominal: they are the flight
    stack's calibration (the action map ``hover_rpm * (1 + 0.05 a)`` of
    BaseRLAviary.py:192/224 and the RPM clip), which in a sim2real setting
    does not know the perturbed plant. Recomputing them from the perturbed
    m and kf would cancel the perturbation exactly for the RPM-normalized
    action types (accel = g((1 + 0.05 a)^2 - 1) whatever m and kf), so the
    randomization would do nothing. Controllers keep nominal parameters for
    the same reason.
    """
    unknown = set(spec) - set(RANDOMIZABLE)
    if unknown:
        raise ValueError(f"unknown randomization keys {sorted(unknown)}; "
                         f"supported: {RANDOMIZABLE}")
    E = num_envs
    batched = params.map(lambda x: x.expand((E,) + x.shape).clone())
    dtype, device = params.m.dtype, params.m.device
    mult = {}
    for name in sorted(spec):
        u = torch.empty(E, dtype=dtype, device=generator.device).uniform_(
            -1.0, 1.0, generator=generator)
        mult[name] = 1.0 + float(spec[name]) * u.to(device)
    rep = {field: getattr(params, field) * mult[field]
           for field in ("m", "kf", "km", "gnd_eff_coeff", "dw_coeff_1") if field in spec}
    if "inertia" in spec:
        j = mult["inertia"][:, None, None]
        rep.update(J=params.J * j, J_inv=params.J_inv / j)
    if "drag" in spec:
        rep.update(drag_coeff=params.drag_coeff * mult["drag"][:, None])
    return batched.replace(**rep)
