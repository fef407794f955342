"""Rigid-body quadrotor dynamics on tensors (port of the JAX ``core/dynamics.py``).

Two physics pipelines, both semi-implicit Euler at ``1/pyb_freq``:

* ``substep_dyn`` — the reference's explicit closed-form model
  (BaseAviary._dynamics, BaseAviary.py:815-877), operation for operation. No
  ground contact (the reference never calls stepSimulation in DYN mode).
* ``substep_pyb`` — the PyBullet force pipeline of BaseAviary._physics
  (BaseAviary.py:679-711): per-prop thrusts at the prop link offsets, yaw
  reaction torque, optional ground-effect / drag / downwash terms
  (BaseAviary.py:349-367), gravity, Newton-Euler with gyroscopic coupling,
  and a plane-contact clamp.

Drone-drone and obstacle contact (``collisions=True``) is the Jacobi
projection of ``core/collisions.py`` under ``contact_mode="clamp"``, and
the sequential-impulse solver of ``core/contact.py`` (plane, pair and
obstacle rows) under ``contact_mode="impulse"``.
Small matrix-vector products are written out term by term, in the order of
the JAX package's expressions.
"""

import dataclasses

import torch

from gym_pybullet_drones_tpu_torch._struct import TensorStruct
from gym_pybullet_drones_tpu_torch.core import aero
from gym_pybullet_drones_tpu_torch.core import contact as contact_solver
from gym_pybullet_drones_tpu_torch.core.collisions import resolve_collisions
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.core.rotations import (
    cross,
    integrate_quat,
    quat_normalize,
    quat_to_euler_xyz,
    quat_to_matrix,
)
from gym_pybullet_drones_tpu_torch.envs.spec import Physics


@dataclasses.dataclass(frozen=True)
class KinState(TensorStruct):
    """Kinematic state of a fleet: leaves shaped (..., N, dim).

    ``ang_v`` is the world-frame angular velocity (what the reference reports,
    BaseAviary.py:519); ``rpy_rates`` is the body-frame rate vector integrated
    by the DYN pipeline (BaseAviary.py:869).
    """

    pos: torch.Tensor  # (..., N, 3)
    quat: torch.Tensor  # (..., N, 4) xyzw
    vel: torch.Tensor  # (..., N, 3)
    ang_v: torch.Tensor  # (..., N, 3) world frame
    rpy_rates: torch.Tensor  # (..., N, 3) body frame


def init_kin_state(init_xyzs, init_quats, dtype=None, device=None) -> KinState:
    init_xyzs = torch.as_tensor(init_xyzs, dtype=dtype, device=device)
    init_quats = torch.as_tensor(init_quats, dtype=init_xyzs.dtype, device=init_xyzs.device)
    z = lambda: torch.zeros_like(init_xyzs)
    return KinState(pos=init_xyzs, quat=init_quats, vel=z(), ang_v=z(), rpy_rates=z())


def _matvec(M, v):
    """M @ v for a (3, 3) matrix and (..., 3) vectors, term by term."""
    return torch.stack([M[i, 0] * v[..., 0] + M[i, 1] * v[..., 1] + M[i, 2] * v[..., 2]
                        for i in range(3)], -1)


def _rot(R, v):
    """R @ v for (..., 3, 3) rotations and (..., 3) vectors."""
    return (R * v[..., None, :]).sum(-1)


def _rot_t(R, v):
    """R^T @ v for (..., 3, 3) rotations and (..., 3) vectors."""
    return (R * v[..., :, None]).sum(-2)


def motor_forces(rpm, params: DroneParams):
    """Per-motor thrusts (..., 4) and net yaw reaction torque (...,).

    BaseAviary.py:693-697: f_i = kf * rpm_i^2; tau_z = -t0 + t1 - t2 + t3 with
    t_i = km * rpm_i^2, sign-flipped for RACE.
    """
    forces = rpm**2 * params.kf
    torques = rpm**2 * params.km * params.yaw_sign
    z_torque = -torques[..., 0] + torques[..., 1] - torques[..., 2] + torques[..., 3]
    return forces, z_torque


def _euler_rotational(torques_body, omega_body, params: DroneParams, dt):
    """Body-frame Newton-Euler rate update (shared by both pipelines)."""
    coupling = cross(omega_body, _matvec(params.J, omega_body))
    omega_dot = _matvec(params.J_inv, torques_body - coupling)
    return omega_body + dt * omega_dot


def substep_dyn(state: KinState, rpm, params: DroneParams, dt) -> KinState:
    """One explicit-dynamics substep (reference BaseAviary.py:815-877).

    vel and body rates update first, then pos uses the new vel and the
    quaternion integrates the new rates; the reported world angular velocity
    uses the old rotation matrix (BaseAviary.py:871-875).
    """
    R = quat_to_matrix(state.quat)
    forces, z_torque = motor_forces(rpm, params)
    thrust_body_z = torch.sum(forces, dim=-1)
    thrust_world = R[..., :, 2] * thrust_body_z[..., None]
    zero = torch.zeros_like(thrust_body_z)
    accel = thrust_world / params.m - torch.stack(
        [zero, zero, zero + params.g], -1)
    mix = params.dyn_xy_mix
    xy_torque = torch.stack([(mix[k] * forces).sum(-1) for k in range(2)], -1)
    torques = torch.cat([xy_torque, z_torque[..., None]], -1)
    new_rates = _euler_rotational(torques, state.rpy_rates, params, dt)
    new_vel = state.vel + dt * accel
    new_pos = state.pos + dt * new_vel
    new_quat = integrate_quat(state.quat, new_rates, dt)
    ang_v_world = _rot(R, new_rates)
    return KinState(pos=new_pos, quat=new_quat, vel=new_vel, ang_v=ang_v_world,
                    rpy_rates=new_rates)


def substep_pyb(
    state: KinState,
    rpm,
    last_rpm,
    params: DroneParams,
    dt,
    *,
    gnd: bool = False,
    drag: bool = False,
    dw: bool = False,
    contact: bool = True,
    contact_mode: str = "clamp",
    renormalize_quat: bool = True,
    dw_src_pos=None,
    dw_force_body_z=None,
    collide: bool = False,
    obstacles=None,
    pair_candidates=None,
    env_batched: bool = False,
) -> KinState:
    """One PyBullet-compatible substep with optional aero terms.

    Thrust and ground effect act at the prop offsets (roll/pitch torques);
    drag (from the previous substep's action, BaseAviary.py:359) and downwash
    act at the COM. PyBullet's ground contact is a plane clamp at the
    collision-cylinder bottom.

    ``dw_src_pos`` gives the downwash other wake sources (default: the fleet
    itself). ``dw_force_body_z`` (..., N) is a wake magnitude computed
    elsewhere (the coupled swarm's pair kernels, ``runtime/swarm.py``); it
    joins the force assembly exactly as the dense downwash term does.
    ``collide`` and ``obstacles`` add the drone-drone and obstacle contact
    pass of ``core/collisions.py`` after the plane clamp.

    ``contact_mode="impulse"`` replaces the clamp and that pass with the
    sequential-impulse solver (``core/contact.solve_contacts``), in Bullet's
    phase order: contacts from the pre-integration pose, impulses on the
    force-integrated velocities, then position and quaternion integration.
    ``pair_candidates`` and ``env_batched`` go to the solver.
    """
    R = quat_to_matrix(state.quat)
    rpy = quat_to_euler_xyz(state.quat)
    forces, z_torque = motor_forces(rpm, params)

    prop_forces = forces
    if gnd:
        prop_forces = prop_forces + aero.ground_effect_forces(rpm, state.pos, R, rpy, params)

    # Body-frame torques from per-prop z-forces at offsets: r x [0,0,f]
    offs = params.prop_offsets
    tau_x = (prop_forces * offs[:, 1]).sum(-1)
    tau_y = -(prop_forces * offs[:, 0]).sum(-1)
    torques_body = torch.stack([tau_x, tau_y, z_torque], -1)

    thrust_body_z = torch.sum(prop_forces, dim=-1)
    force_world = R[..., :, 2] * thrust_body_z[..., None]
    if drag:
        force_world = force_world + aero.drag_force_world(last_rpm, state.vel, params)
    if dw:
        dw_mag = aero.downwash_forces_body_z(state.pos, params, pos_above=dw_src_pos)
        force_world = force_world + R[..., :, 2] * dw_mag[..., None]
    if dw_force_body_z is not None:
        # The same accel, and the same accel_z sign in the `pressed` test below.
        force_world = force_world + R[..., :, 2] * dw_force_body_z[..., None]

    accel = force_world / params.m
    accel = torch.cat([accel[..., :2], accel[..., 2:] - params.g], -1)
    new_vel = state.vel + dt * accel

    # Rotational update in the body frame, then back to world.
    omega_body = _rot_t(R, state.ang_v)
    new_omega_body = _euler_rotational(torques_body, omega_body, params, dt)
    new_ang_v = _rot(R, new_omega_body)

    if contact and contact_mode == "impulse":
        new_vel, new_ang_v = contact_solver.solve_contacts(
            state.pos, state.quat, new_vel, new_ang_v, params, dt, drone_drone=collide,
            obstacles=obstacles, pair_candidates=pair_candidates, env_batched=env_batched)
        new_omega_body = _rot_t(R, new_ang_v)
        new_pos = state.pos + dt * new_vel
        new_quat = integrate_quat(state.quat, new_omega_body, dt)
        if renormalize_quat:
            new_quat = quat_normalize(new_quat)
        new_rpy_rates = _rot_t(quat_to_matrix(new_quat), new_ang_v)
        return KinState(pos=new_pos, quat=new_quat, vel=new_vel, ang_v=new_ang_v,
                        rpy_rates=new_rpy_rates)

    new_pos = state.pos + dt * new_vel
    new_quat = integrate_quat(state.quat, new_omega_body, dt)
    if renormalize_quat:
        new_quat = quat_normalize(new_quat)

    if contact:
        z_min = params.collision_h / 2.0 - params.collision_z_offset
        pz, vz = new_pos[..., 2], new_vel[..., 2]
        below = pz < z_min
        new_pos = torch.cat([new_pos[..., :2], torch.where(below, z_min, pz)[..., None]], -1)
        new_vel = torch.cat([new_vel[..., :2],
                             torch.where(below, torch.clamp(vz, min=0.0), vz)[..., None]], -1)
        # Resting contact: friction kills residual spin when pressed into the plane.
        pressed = below & (accel[..., 2] <= 0.0)
        new_ang_v = torch.where(pressed[..., None], torch.zeros_like(new_ang_v), new_ang_v)

    if collide or obstacles is not None:
        new_pos, new_vel = resolve_collisions(new_pos, new_vel, params.collision_r, obstacles,
                                              drone_drone=collide)

    new_rpy_rates = _rot_t(quat_to_matrix(new_quat), new_ang_v)
    return KinState(pos=new_pos, quat=new_quat, vel=new_vel, ang_v=new_ang_v,
                    rpy_rates=new_rpy_rates)


_PYB_FLAGS = {
    Physics.PYB: dict(gnd=False, drag=False, dw=False),
    Physics.PYB_GND: dict(gnd=True, drag=False, dw=False),
    Physics.PYB_DRAG: dict(gnd=False, drag=True, dw=False),
    Physics.PYB_DW: dict(gnd=False, drag=False, dw=True),
    Physics.PYB_GND_DRAG_DW: dict(gnd=True, drag=True, dw=True),
}


def step_physics(
    state: KinState,
    rpm,
    last_rpm,
    params: DroneParams,
    dt,
    n_substeps: int,
    physics: Physics,
    *,
    renormalize_quat: bool = True,
    collisions: bool = False,
    obstacles=None,
    contact_mode: str = "clamp",
    env_batched: bool = False,
):
    """Advance ``n_substeps`` physics substeps under one control action.

    Mirrors the substep loop of BaseAviary.step (BaseAviary.py:343-372): the
    drag term of the first substep uses the previous control period's action
    (``last_rpm``); later substeps use the current one. Returns the new state
    and the action to carry as ``last_rpm`` next period. ``collisions`` adds
    drone-drone contact where the fleet has more than one drone;
    ``obstacles`` (an ``ObstacleSet``) adds contact with static bodies.
    ``contact_mode`` is ``"clamp"`` or ``"impulse"``; DYN has no contact
    (the reference never steps Bullet's world there).

    With impulse contact, fleets above ``PAIR_GS_MAX_N`` drones take the
    neighbor pair rows where the state is one world (``pos`` (N, 3)) or
    ``env_batched`` says its leading axes are independent envs (the env step
    sets it): their candidates are built once a control period, from the
    period's first pose, by the dense build up to ``NBR_MAX_N`` drones and
    by the hash grid above it. Any other leading axis takes the Jacobi pair
    pass, as a direct JAX call with such a state does.
    """
    if contact_mode not in ("clamp", "impulse"):
        raise ValueError(f"unknown contact_mode {contact_mode!r}")
    if physics == Physics.DYN:
        for _ in range(n_substeps):
            state = substep_dyn(state, rpm, params, dt)
            if renormalize_quat:
                state = state.replace(quat=quat_normalize(state.quat))
        return state, rpm
    flags = _PYB_FLAGS[physics]
    n = state.pos.shape[-2]
    collide = collisions and n > 1
    env_batched = env_batched and state.pos.ndim > 2
    pair_candidates = None
    if (contact_mode == "impulse" and collide and n > contact_solver.PAIR_GS_MAX_N
            and (state.pos.ndim == 2 or env_batched)):
        r = params.collision_r
        if n <= contact_solver.NBR_MAX_N:
            pair_candidates = contact_solver.build_pair_candidates(state.pos, r)
        elif not env_batched:
            pair_candidates = contact_solver.build_pair_candidates_binned(state.pos, r)
        else:
            raise NotImplementedError(
                f"impulse contact for env batches of more than {contact_solver.NBR_MAX_N} "
                "drones an env (the hash-grid candidates with an env axis, ROADMAP item 14b)")
    for _ in range(n_substeps):
        state = substep_pyb(state, rpm, last_rpm, params, dt,
                            renormalize_quat=renormalize_quat, collide=collide,
                            obstacles=obstacles, contact_mode=contact_mode,
                            pair_candidates=pair_candidates, env_batched=env_batched,
                            **flags)
        last_rpm = rpm
    return state, rpm


def state_rpy(state: KinState):
    """Euler angles (roll, pitch, yaw) as the reference reports them."""
    return quat_to_euler_xyz(state.quat)
