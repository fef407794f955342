"""Functional aviary environments on tensors (port of the JAX ``envs/base.py``, KIN path).

An env is a frozen ``AviaryConfig`` plus two plain functions

    reset(cfg, params) -> AviaryState
    step(cfg, params, ctrl_params, target_pos, state, action)
        -> (AviaryState, obs, reward, terminated, truncated)

Every tensor may carry leading env axes in front of the drone axis: ``step``
reads the batch shape from ``state.step_count``, so the same function serves
one env and a batch of them (``runtime/rollout.py``). Each env is a world of
its own, as under the JAX package's vmapped step: with impulse contact, an
env of more than 16 drones takes the neighbor pair rows, env by env.

Every behavioral detail (action pipelines, 20-dim state vector, reward /
termination rules, the 0.5 s action buffer of RL observations) follows the
reference (envs/BaseAviary.py, CtrlAviary.py, VelocityAviary.py,
BaseRLAviary.py, HoverAviary.py, MultiHoverAviary.py). RGB observations are
the onboard cameras' frames (``render/camera.py``; K7 on the card), captured
at the reference's 24 FPS cadence and held in between.
"""

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import TensorStruct, resolve_dtype
from gym_pybullet_drones_tpu_torch.control.dsl_pid import (
    DSLPIDParams,
    DSLPIDState,
    dsl_pid_control,
    dsl_pid_params,
    dsl_pid_reset,
)
from gym_pybullet_drones_tpu_torch.core.collisions import base_obstacles, rl_obstacles
from gym_pybullet_drones_tpu_torch.core.dynamics import (
    KinState,
    init_kin_state,
    state_rpy,
    step_physics,
)
from gym_pybullet_drones_tpu_torch.core.params import DroneParams, drone_params
from gym_pybullet_drones_tpu_torch.core.rotations import euler_xyz_to_quat, norm3
from gym_pybullet_drones_tpu_torch.envs.spec import (
    ActionType,
    DroneModel,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.render.camera import CameraConfig, render_drone_views

# Task identifiers (reward/termination/truncation rules)
TASK_CTRL = "ctrl"  # CtrlAviary: dummy reward -1, never done (CtrlAviary.py:144-200)
TASK_VELOCITY = "velocity"  # VelocityAviary: same dummy signals
TASK_HOVER = "hover"  # HoverAviary.py:68-132
TASK_MULTIHOVER = "multihover"  # MultiHoverAviary.py:75-145


@dataclasses.dataclass(frozen=True)
class AviaryConfig:
    """Static environment configuration (the JAX package's, field for field)."""

    drone_model: DroneModel = DroneModel.CF2X
    num_drones: int = 1
    physics: Physics = Physics.PYB
    pyb_freq: int = 240
    ctrl_freq: int = 240
    task: str = TASK_CTRL
    action_type: ActionType = ActionType.RPM
    obs_type: ObservationType = ObservationType.KIN
    # RL obs action buffer (BaseRLAviary.py:66-67); 0 disables (non-RL envs)
    action_buffer_size: int = 0
    episode_len_sec: float = 8.0
    neighbourhood_radius: float = float("inf")
    # None -> reference default grid (BaseAviary.py:194-197)
    initial_xyzs: Optional[tuple] = None
    initial_rpys: Optional[tuple] = None
    dtype: str = "float32"
    # Contact beyond the ground plane (core/collisions.py): drone-drone
    # spheres, plus the scene's obstacles as static bodies when `obstacles`.
    collisions: bool = False
    contact_mode: str = "clamp"
    # With `collisions`, contact with the scene's static bodies; the scene is
    # "rl" (the four BaseRLAviary landmarks, :99-128) or "base" (BaseAviary's
    # own scene, BaseAviary._addObstacles :958-981).
    obstacles: bool = True
    obstacle_scene: str = "rl"
    # RGB frame stacking, channel-wise: the held frames keep the last K
    # captures as (N, H, W, 4K). K = 1 is the reference's single frame
    # (BaseRLAviary.py:293-306); one 24 FPS frame carries no velocity, so
    # pixel-only training stacks K > 1.
    frame_stack: int = 1
    # Renormalize quaternions every substep (the reference's DYN pipeline
    # never does, so parity tests disable this).
    renormalize_quat: bool = True

    def __post_init__(self):
        if self.pyb_freq % self.ctrl_freq != 0:
            raise ValueError("pyb_freq must be a multiple of ctrl_freq (BaseAviary.py:79-80)")

    @property
    def steps_per_ctrl(self) -> int:
        return self.pyb_freq // self.ctrl_freq

    @property
    def ctrl_timestep(self) -> float:
        return 1.0 / self.ctrl_freq

    @property
    def pyb_timestep(self) -> float:
        return 1.0 / self.pyb_freq

    @property
    def torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    @property
    def action_dim(self) -> int:
        """Per-drone action width (BaseRLAviary._actionSpace, :140-149)."""
        if self.action_type in (ActionType.RPM, ActionType.VEL):
            return 4
        if self.action_type == ActionType.PID:
            return 3
        return 1  # ONE_D_RPM / ONE_D_PID

    @property
    def obs_dim(self) -> int:
        """Per-drone KIN observation width."""
        if self.task in (TASK_CTRL, TASK_VELOCITY):
            return 20
        return 12 + self.action_buffer_size * self.action_dim

    @property
    def img_capture_freq(self) -> int:
        """Physics substeps between onboard-camera captures: the reference
        grabs frames at 24 FPS of sim time and holds them in between
        (BaseAviary.py:135-136; the gate, BaseRLAviary.py:294), at least 1."""
        return max(1, int(self.pyb_freq / 24))


@dataclasses.dataclass(frozen=True)
class AviaryState(TensorStruct):
    """Complete dynamic state of one aviary (or a batch of them)."""

    kin: KinState
    last_rpm: torch.Tensor  # (..., N, 4) last clipped RPM action (BaseAviary.py:372)
    ctrl: DSLPIDState  # (..., N, 3) leaves; zeros when unused
    action_buffer: torch.Tensor  # (..., B, N, A) raw actions, oldest first; B may be 0
    step_count: torch.Tensor  # int32 (...), counts pyb substeps (BaseAviary.py:382)
    # The held onboard-camera frames (..., N, 48, 64, 4 * frame_stack) uint8,
    # refreshed every img_capture_freq substeps (BaseRLAviary.py:293-306);
    # None for KIN configs.
    rgb_frames: Optional[torch.Tensor] = None


def default_init_xyzs(cfg: AviaryConfig, params: DroneParams) -> np.ndarray:
    """Reference default spawn grid (BaseAviary.py:194-197)."""
    n = cfg.num_drones
    L = float(params.arm)
    z = float(params.collision_h) / 2 - float(params.collision_z_offset) + 0.1
    return np.stack(
        [4 * L * np.arange(n), 4 * L * np.arange(n), np.full(n, z)], axis=1
    )


def build_params(cfg: AviaryConfig, device=None) -> DroneParams:
    return drone_params(cfg.drone_model, dtype=cfg.torch_dtype, device=device)


def build_ctrl_params(cfg: AviaryConfig, device=None) -> DSLPIDParams:
    # Reference quirk: the RL aviaries (BaseRLAviary.py:76) and VelocityAviary
    # (VelocityAviary.py:61-62) always build the embedded controller with the
    # CF2X mixer, whatever the drone model.
    return dsl_pid_params(DroneModel.CF2X, dtype=cfg.torch_dtype, device=device)


def _initial_pose(cfg: AviaryConfig, params: DroneParams):
    if cfg.initial_xyzs is None:
        xyzs = default_init_xyzs(cfg, params)
    else:
        xyzs = np.asarray(cfg.initial_xyzs, dtype=np.float64).reshape(cfg.num_drones, 3)
    if cfg.initial_rpys is None:
        rpys = np.zeros((cfg.num_drones, 3))
    else:
        rpys = np.asarray(cfg.initial_rpys, dtype=np.float64).reshape(cfg.num_drones, 3)
    return xyzs, rpys


def _render_frames(cfg: AviaryConfig, kin: KinState, params: DroneParams):
    """Fresh onboard-camera frames (..., N, 48, 64, 4) uint8 from ``kin``."""
    rgba, _, _ = render_drone_views(
        kin.pos, kin.quat, params.arm,
        CameraConfig(with_landmarks=cfg.obstacles, scene=cfg.obstacle_scene,
                     frame_angle_deg=0.0 if cfg.drone_model == DroneModel.CF2P else 45.0))
    return rgba


def reset(cfg: AviaryConfig, params: DroneParams) -> AviaryState:
    """Fresh episode state on the params' device (the reference reset is
    deterministic, BaseAviary.py:220-255)."""
    dtype, device = cfg.torch_dtype, params.m.device
    xyzs, rpys = _initial_pose(cfg, params)
    quats = euler_xyz_to_quat(torch.as_tensor(rpys, dtype=dtype, device=device))
    kin = init_kin_state(torch.as_tensor(xyzs, dtype=dtype, device=device), quats)
    n = cfg.num_drones
    rgb_frames = None
    if cfg.obs_type == ObservationType.RGB:
        # reset's obs captures at once (step_counter 0 passes the gate); a
        # K-stack starts as the first capture K times.
        rgb_frames = _render_frames(cfg, kin, params).repeat(1, 1, 1, cfg.frame_stack)
    return AviaryState(
        kin=kin,
        last_rpm=torch.zeros((n, 4), dtype=dtype, device=device),
        ctrl=dsl_pid_reset((n,), dtype=dtype, device=device),
        action_buffer=torch.zeros((cfg.action_buffer_size, n, cfg.action_dim),
                                  dtype=dtype, device=device),
        step_count=torch.zeros((), dtype=torch.int32, device=device),
        rgb_frames=rgb_frames,
    )


################################################################################
# Action pipelines (reference: CtrlAviary.py:121-140, VelocityAviary.py:129-168,
# BaseRLAviary._preprocessAction :160-239)
################################################################################


def speed_limit(params: DroneParams):
    """0.03 * MAX_SPEED_KMH in m/s (VelocityAviary.py:78, BaseRLAviary.py:96)."""
    return 0.03 * params.max_speed_kmh * (1000.0 / 3600.0)


def _calculate_next_step(current_position, destination, step_size=1.0):
    """Waypoint capping for ActionType.PID (BaseAviary._calculateNextStep, :1108-1150)."""
    direction = destination - current_position
    distance = norm3(direction, keepdim=True)
    safe = torch.clamp(distance, min=1e-12)
    capped = current_position + direction / safe * step_size
    return torch.where(distance <= step_size, destination, capped)


def _vel_pipeline(cfg, ctrl_params, state: AviaryState, action, speed_limit):
    """Shared by VelocityAviary and ActionType.VEL: PID toward a velocity target."""
    rpy = state_rpy(state.kin)
    v = action[..., 0:3]
    vnorm = norm3(v, keepdim=True)
    v_unit = torch.where(vnorm > 0, v / torch.clamp(vnorm, min=1e-12), torch.zeros_like(v))
    target_vel = speed_limit * torch.abs(action[..., 3:4]) * v_unit
    target_rpy = torch.cat([torch.zeros_like(rpy[..., 0:2]), rpy[..., 2:3]], -1)
    rpm, new_ctrl, _, _ = dsl_pid_control(
        ctrl_params, state.ctrl, cfg.ctrl_timestep,
        state.kin.pos, state.kin.quat, state.kin.vel,
        state.kin.pos, target_rpy, target_vel,
    )
    return rpm, new_ctrl


def preprocess_action(cfg: AviaryConfig, params: DroneParams, ctrl_params: DSLPIDParams,
                      state: AviaryState, action):
    """action (..., N, A) -> (rpm (..., N, 4), new DSLPIDState)."""
    if cfg.task == TASK_CTRL:
        # Raw RPM clip (CtrlAviary.py:121-140)
        return torch.minimum(torch.clamp(action, min=0.0), params.max_rpm), state.ctrl
    if cfg.task == TASK_VELOCITY:
        return _vel_pipeline(cfg, ctrl_params, state, action, speed_limit(params))

    # RL pipelines (BaseRLAviary.py:160-239)
    at = cfg.action_type
    if at == ActionType.RPM:
        return params.hover_rpm * (1.0 + 0.05 * action), state.ctrl
    if at == ActionType.ONE_D_RPM:
        return params.hover_rpm * (1.0 + 0.05 * action.repeat_interleave(4, dim=-1)), state.ctrl
    if at == ActionType.PID:
        next_pos = _calculate_next_step(state.kin.pos, action, 1.0)
        rpm, new_ctrl, _, _ = dsl_pid_control(
            ctrl_params, state.ctrl, cfg.ctrl_timestep,
            state.kin.pos, state.kin.quat, state.kin.vel, next_pos,
        )
        return rpm, new_ctrl
    if at == ActionType.VEL:
        return _vel_pipeline(cfg, ctrl_params, state, action, speed_limit(params))
    if at == ActionType.ONE_D_PID:
        zero = torch.zeros_like(action)
        target = state.kin.pos + 0.1 * torch.cat([zero, zero, action], -1)
        rpm, new_ctrl, _, _ = dsl_pid_control(
            ctrl_params, state.ctrl, cfg.ctrl_timestep,
            state.kin.pos, state.kin.quat, state.kin.vel, target,
        )
        return rpm, new_ctrl
    raise ValueError(f"unsupported action type {at}")


################################################################################
# Observations
################################################################################


def drone_state_vector(cfg: AviaryConfig, state: AviaryState):
    """The reference 20-dim per-drone state (BaseAviary._getDroneStateVector, :541-561):
    [pos(3), quat(4), rpy(3), vel(3), ang_v(3), last_clipped_action(4)]."""
    kin = state.kin
    return torch.cat(
        [kin.pos, kin.quat, state_rpy(kin), kin.vel, kin.ang_v, state.last_rpm], -1
    )


def compute_obs(cfg: AviaryConfig, state: AviaryState):
    if cfg.task in (TASK_CTRL, TASK_VELOCITY):
        return drone_state_vector(cfg, state)  # (..., N, 20)
    if cfg.obs_type == ObservationType.RGB:
        # The held frames (BaseRLAviary._computeObs RGB path, :293-306),
        # refreshed by step() on img_capture_freq boundaries only.
        return state.rgb_frames  # (..., N, 48, 64, 4K) uint8
    # RL KIN obs: 12-dim kinematics + flattened action buffer, oldest first
    # (BaseRLAviary._computeObs, :307-319)
    full = drone_state_vector(cfg, state)
    obs12 = torch.cat([full[..., 0:3], full[..., 7:16]], -1)
    if cfg.action_buffer_size == 0:
        return obs12
    buf = torch.movedim(state.action_buffer, -3, -2)  # (..., N, B, A)
    flat = buf.reshape(buf.shape[:-2] + (-1,))
    return torch.cat([obs12, flat], -1)


################################################################################
# Task rules (reward / terminated / truncated)
################################################################################


def hover_target_pos(cfg: AviaryConfig, params: DroneParams) -> torch.Tensor:
    """HoverAviary.py:51 (single: [0,0,1]); MultiHoverAviary.py:71
    (INIT_XYZS + [0,0,1/(i+1)])."""
    device = params.m.device
    if cfg.task == TASK_HOVER:
        return torch.tensor([[0.0, 0.0, 1.0]], dtype=cfg.torch_dtype, device=device)
    xyzs, _ = _initial_pose(cfg, params)
    offs = np.stack(
        [np.zeros(cfg.num_drones), np.zeros(cfg.num_drones),
         1.0 / (np.arange(cfg.num_drones) + 1.0)], 1
    )
    return torch.as_tensor(xyzs + offs, dtype=cfg.torch_dtype, device=device)


def _batch_shape(state: AviaryState):
    return state.step_count.shape


def compute_reward(cfg: AviaryConfig, state: AviaryState, target_pos):
    if cfg.task in (TASK_CTRL, TASK_VELOCITY):
        return torch.full(_batch_shape(state), -1.0, dtype=cfg.torch_dtype,
                          device=state.step_count.device)
    # max(0, 2 - ||e||^4), summed over drones (HoverAviary.py:77-79,
    # MultiHoverAviary.py:84-88)
    err = norm3(target_pos - state.kin.pos)
    return torch.sum(torch.clamp(2.0 - err**4, min=0.0), dim=-1)


def compute_terminated(cfg: AviaryConfig, state: AviaryState, target_pos):
    if cfg.task in (TASK_CTRL, TASK_VELOCITY):
        return torch.zeros(_batch_shape(state), dtype=torch.bool,
                           device=state.step_count.device)
    err = norm3(target_pos - state.kin.pos)
    if cfg.task == TASK_HOVER:
        return err[..., 0] < 1e-4  # HoverAviary.py:92-96
    return torch.sum(err, dim=-1) < 1e-4  # MultiHoverAviary.py:101-108


def compute_truncated(cfg: AviaryConfig, state: AviaryState):
    if cfg.task in (TASK_CTRL, TASK_VELOCITY):
        return torch.zeros(_batch_shape(state), dtype=torch.bool,
                           device=state.step_count.device)
    pos = state.kin.pos
    rpy = state_rpy(state.kin)
    bound = 1.5 if cfg.task == TASK_HOVER else 2.0  # HoverAviary.py:109 / MultiHover.py:121
    out = (
        (torch.abs(pos[..., 0]) > bound)
        | (torch.abs(pos[..., 1]) > bound)
        | (pos[..., 2] > 2.0)
        | (torch.abs(rpy[..., 0]) > 0.4)
        | (torch.abs(rpy[..., 1]) > 0.4)
    )
    # The reference reads step_counter BEFORE the step advances it
    # (BaseAviary.step computes the signals at :376-380 and increments at
    # :382), so the timeout uses the pre-increment count: an 8 s episode at
    # 240/30 spans 242 reward-bearing control steps (HoverAviary.py:115).
    pre_count = state.step_count - cfg.steps_per_ctrl
    timeout = pre_count / cfg.pyb_freq > cfg.episode_len_sec
    return torch.any(out, dim=-1) | timeout


################################################################################
# The step
################################################################################


def step(
    cfg: AviaryConfig,
    params: DroneParams,
    ctrl_params: DSLPIDParams,
    target_pos,
    state: AviaryState,
    action,
    preprocessed_rpm=None,
):
    """One control-period step: action pipeline -> physics substeps -> signals.

    Mirrors BaseAviary.step (BaseAviary.py:259-383). Returns
    (state, obs, reward, terminated, truncated). ``state`` may carry leading
    env axes (read from ``state.step_count``); ``action`` then has them too.

    ``preprocessed_rpm`` (..., N, 4), when given, bypasses
    ``preprocess_action`` with externally computed motor RPMs (clipped to
    [0, MAX_RPM]) — the hook for subclasses that override the reference's
    ``_preprocessAction``; the action buffer is then not updated
    (BaseRLAviary.py:185-188 appends inside that method).
    """
    batch = tuple(_batch_shape(state))
    device = state.step_count.device
    action = torch.as_tensor(action, dtype=cfg.torch_dtype, device=device)
    layout = batch + (cfg.num_drones, cfg.action_dim)
    builtin_layout = action.numel() == int(np.prod(layout))
    if builtin_layout:
        action = action.reshape(layout)
    elif preprocessed_rpm is None:
        raise ValueError(
            f"action of size {action.numel()} does not fit the {layout} action "
            "layout; custom action shapes require preprocessed_rpm")
    if cfg.action_buffer_size > 0 and builtin_layout and preprocessed_rpm is None:
        k = len(batch)
        buf = torch.cat([state.action_buffer[(slice(None),) * k + (slice(1, None),)],
                         action.unsqueeze(k)], dim=k)
        state = state.replace(action_buffer=buf)
    if preprocessed_rpm is None:
        rpm, new_ctrl = preprocess_action(cfg, params, ctrl_params, state, action)
    else:
        rpm = torch.as_tensor(preprocessed_rpm, dtype=cfg.torch_dtype, device=device)
        rpm = torch.minimum(torch.clamp(rpm.reshape(batch + (cfg.num_drones, 4)), min=0.0),
                            params.max_rpm)
        new_ctrl = state.ctrl
    obstacles = None
    if cfg.collisions and cfg.obstacles:
        scene = base_obstacles if cfg.obstacle_scene == "base" else rl_obstacles
        obstacles = scene(cfg.torch_dtype, device)
    kin, last_rpm = step_physics(
        state.kin, rpm, state.last_rpm, params, cfg.pyb_timestep,
        cfg.steps_per_ctrl, cfg.physics, renormalize_quat=cfg.renormalize_quat,
        collisions=cfg.collisions, obstacles=obstacles, contact_mode=cfg.contact_mode,
        env_batched=len(batch) > 0,
    )
    state = state.replace(
        kin=kin,
        last_rpm=last_rpm,
        ctrl=new_ctrl,
        step_count=state.step_count + cfg.steps_per_ctrl,
    )
    if cfg.obs_type == ObservationType.RGB:
        # The capture gate reads the PRE-increment counter (obs computed at
        # BaseAviary.py:376, counter advanced at :382) and renders from the
        # post-physics kinematics; frames are held in between. Each env
        # renders and selects on its own flag (envs differ in phase after
        # auto-resets), JAX's semantics under vmap: no host sync. The frames
        # are new tensors, so an obs handed out earlier never changes.
        pre_count = state.step_count - cfg.steps_per_ctrl
        capture = torch.remainder(pre_count, cfg.img_capture_freq) == 0
        fresh = _render_frames(cfg, kin, params)
        if cfg.frame_stack > 1:
            # channel-wise ring: drop the oldest capture, append the newest
            fresh = torch.cat([state.rgb_frames[..., 4:], fresh], -1)
        mask = capture.reshape(capture.shape + (1,) * (fresh.ndim - capture.ndim))
        state = state.replace(rgb_frames=torch.where(mask, fresh, state.rgb_frames))
    obs = compute_obs(cfg, state)
    reward = compute_reward(cfg, state, target_pos)
    terminated = compute_terminated(cfg, state, target_pos)
    truncated = compute_truncated(cfg, state)
    return state, obs, reward, terminated, truncated


def adjacency_matrix(pos, neighbourhood_radius):
    """(..., N, N) 0/1 adjacency by Euclidean distance
    (BaseAviary._getAdjacencyMatrix, :658-675)."""
    d = norm3(pos[..., :, None, :] - pos[..., None, :, :])
    eye = torch.eye(pos.shape[-2], dtype=pos.dtype, device=pos.device)
    near = torch.where(d < neighbourhood_radius, 1.0, 0.0).to(pos.dtype)
    return near * (1 - eye) + eye


class Aviary:
    """Convenience bundle: config + parameter records + reset/step on one device.

    ``device=None`` means the CUDA card (raising when there is none).
    """

    def __init__(self, cfg: AviaryConfig, device=None):
        self.cfg = cfg
        self.params = build_params(cfg, device)
        self.ctrl_params = build_ctrl_params(cfg, self.params.m.device)
        self.target_pos = (
            hover_target_pos(cfg, self.params)
            if cfg.task in (TASK_HOVER, TASK_MULTIHOVER)
            else torch.zeros((cfg.num_drones, 3), dtype=cfg.torch_dtype,
                             device=self.params.m.device)
        )
        self.step_fn = partial(step, cfg, self.params, self.ctrl_params, self.target_pos)

    def reset(self):
        state = reset(self.cfg, self.params)
        return state, compute_obs(self.cfg, state)

    def step(self, state: AviaryState, action):
        return self.step_fn(state, action)
