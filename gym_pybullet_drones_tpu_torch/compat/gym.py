"""Gymnasium shell: drop-in stateful env classes over the functional env step
(port of the JAX ``compat/gym.py``).

Users of the reference (`gym_pybullet_drones/envs/*.py`) interact with stateful
`gym.Env` subclasses; here each class is a thin host-side wrapper over
``envs/base.step`` on one device (``device=None``: the CUDA card), converting
numpy <-> tensors at the boundary through ``runtime/shell.shell_step`` (one
copy back a step). Constructor signatures mirror the reference
(BaseAviary.__init__, BaseAviary.py:25-40); PyBullet-specific toggles (`gui`,
`record`, `obstacles`, `user_debug_gui`) keep their roles: `record=True`
writes drone-0 camera frames (K7 on the card), `gui=True` opens the
matplotlib fleet view (`utils/viz.LiveViewer`).

Space definitions are numeric copies of the reference's:
  * CtrlAviary/VelocityAviary obs: Box (N, 20) (CtrlAviary.py:90-102)
  * CtrlAviary act: Box [0, MAX_RPM] (N, 4) (CtrlAviary.py:74-86)
  * VelocityAviary act: Box [-1,1]^3 x [0,1] (VelocityAviary.py:82-94)
  * RL aviaries: act Box(-1,1) (N, {4,3,1}) (BaseRLAviary.py:132-156), obs
    Box (N, 12 + buffer*A) with z >= 0 and buffer bounds +-1
    (BaseRLAviary.py:242-277)
"""

import os
import subprocess
import time
from typing import Optional

import gymnasium as gym
import numpy as np
import torch
from gymnasium import spaces

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_CTRL,
    TASK_HOVER,
    TASK_MULTIHOVER,
    TASK_VELOCITY,
)
from gym_pybullet_drones_tpu_torch.envs.spec import (
    ActionType,
    DroneModel,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.runtime.shell import (
    host_copy,
    record_frame,
    shell_config,
    shell_step,
)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class BaseAviaryEnv(gym.Env):
    """Common shell; subclasses pick the task and spaces.

    Keywords beyond the reference's: ``frame_stack`` (RGB observations keep
    the last K camera captures, ``AviaryConfig.frame_stack``) and ``device``
    (``None``: the CUDA card).

    Exposes the reference's public attribute surface (NUM_DRONES, CTRL_FREQ,
    PYB_FREQ, CTRL_TIMESTEP, M, KF, KM, MAX_RPM, HOVER_RPM, INIT_XYZS, ... —
    BaseAviary.py:74-216) so downstream scripts port without edits.

    PERFORMANCE: this drop-in shell round-trips host<->device on EVERY step
    (numpy in and out, and each step is the env step's whole sequence of
    kernel launches for one env) — it exists for API parity. For throughput
    step many envs at once: `compat.vector.VecAviary`, `runtime.rollout`
    (`make_batched_step`) or `envs.base.Aviary`. A one-time RuntimeWarning
    flags this on construction; silence with
    ``warnings.filterwarnings('ignore', message='.*drop-in compatibility.*')``.
    """

    metadata = {"render_modes": ["human"]}
    _perf_warned = False

    def __init__(
        self,
        drone_model: DroneModel = DroneModel.CF2X,
        num_drones: int = 1,
        neighbourhood_radius: float = np.inf,
        initial_xyzs=None,
        initial_rpys=None,
        physics: Physics = Physics.PYB,
        pyb_freq: int = 240,
        ctrl_freq: int = 240,
        gui: bool = False,
        record: bool = False,
        obstacles: bool = False,
        user_debug_gui: bool = True,
        output_folder: str = "results",
        task: str = TASK_CTRL,
        act: ActionType = ActionType.RPM,
        obs: ObservationType = ObservationType.KIN,
        action_buffer_size: int = 0,
        episode_len_sec: float = 8.0,
        frame_stack: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = shell_config(
            drone_model=drone_model, num_drones=num_drones,
            neighbourhood_radius=neighbourhood_radius, initial_xyzs=initial_xyzs,
            initial_rpys=initial_rpys, physics=physics, pyb_freq=pyb_freq,
            ctrl_freq=ctrl_freq, obstacles=obstacles, task=task, act=act, obs=obs,
            action_buffer_size=action_buffer_size, episode_len_sec=episode_len_sec,
            frame_stack=frame_stack)
        self.params = envbase.build_params(self.cfg, self.device)
        self.ctrl_params = envbase.build_ctrl_params(self.cfg, self.device)
        self.target_pos = (
            envbase.hover_target_pos(self.cfg, self.params)
            if task in (TASK_HOVER, TASK_MULTIHOVER)
            else torch.zeros((num_drones, 3), dtype=self.cfg.torch_dtype, device=self.device)
        )
        # Reference subclassing protocol: a user env overriding
        # _preprocessAction (the BaseAviary extension hook, :896/:1108 and
        # every envs/*.py subclass) computes motor RPMs host-side; the device
        # step then skips its own action pipeline but keeps the task's
        # obs/reward/termination rules and the action buffer.
        self._custom_action = (
            type(self)._preprocessAction is not BaseAviaryEnv._preprocessAction
        )
        self._state = None
        if not BaseAviaryEnv._perf_warned:
            BaseAviaryEnv._perf_warned = True
            import warnings

            warnings.warn(
                "gym_pybullet_drones_tpu_torch drop-in compatibility shell: one "
                "host<->device round-trip per step. For throughput step many envs "
                "at once: compat.vector.VecAviary or runtime.rollout.",
                RuntimeWarning, stacklevel=3)
        self.GUI, self.RECORD, self.OBSTACLES = gui, record, obstacles
        self.USER_DEBUG = user_debug_gui
        self._viewer = None
        self.OUTPUT_FOLDER = output_folder
        # Recording (BaseAviary._startVideoRecording, :523-537): with
        # record=True, drone-0 POV frames are ray-cast every CAPTURE_FREQ
        # steps and saved as numbered PNGs under OUTPUT_FOLDER/recording_*.
        self.FRAME_PER_SEC = 24
        self.CAPTURE_FREQ = max(1, int(ctrl_freq / self.FRAME_PER_SEC))
        self._record_dir = None
        self._frame_num = 0
        self._step_index = 0

        # Reference public constants (BaseAviary.py:74-216)
        self.NUM_DRONES = num_drones
        self.DRONE_MODEL = drone_model
        self.PHYSICS = physics
        self.PYB_FREQ, self.CTRL_FREQ = pyb_freq, ctrl_freq
        self.PYB_TIMESTEP = 1.0 / pyb_freq
        self.CTRL_TIMESTEP = 1.0 / ctrl_freq
        self.PYB_STEPS_PER_CTRL = pyb_freq // ctrl_freq
        self.NEIGHBOURHOOD_RADIUS = neighbourhood_radius
        p = self.params.to("cpu")
        self.G = float(p.g)  # gravitational acceleration (BaseAviary.py:74)
        self.GRAVITY = float(p.gravity)  # m * g
        self.M = float(p.m)
        self.L = float(p.arm)
        self.KF = float(p.kf)
        self.KM = float(p.km)
        self.THRUST2WEIGHT_RATIO = float(p.thrust2weight)
        self.MAX_SPEED_KMH = float(p.max_speed_kmh)
        self.GND_EFF_COEFF = float(p.gnd_eff_coeff)
        self.PROP_RADIUS = float(p.prop_radius)
        self.DRAG_COEFF = _np(p.drag_coeff)
        self.DW_COEFF_1 = float(p.dw_coeff_1)
        self.DW_COEFF_2 = float(p.dw_coeff_2)
        self.DW_COEFF_3 = float(p.dw_coeff_3)
        self.J = _np(p.J)
        self.J_INV = _np(p.J_inv)
        self.COLLISION_H = float(p.collision_h)
        self.COLLISION_R = float(p.collision_r)
        self.COLLISION_Z_OFFSET = float(p.collision_z_offset)
        self.HOVER_RPM = float(p.hover_rpm)
        self.MAX_RPM = float(p.max_rpm)
        self.MAX_THRUST = float(p.max_thrust)
        self.MAX_XY_TORQUE = float(p.max_xy_torque)
        self.MAX_Z_TORQUE = float(p.max_z_torque)
        self.GND_EFF_H_CLIP = float(p.gnd_eff_h_clip)
        xyzs, rpys = envbase._initial_pose(self.cfg, p)
        self.INIT_XYZS = np.asarray(xyzs)
        self.INIT_RPYS = np.asarray(rpys)
        self.EPISODE_LEN_SEC = episode_len_sec
        self.ACT_TYPE, self.OBS_TYPE = act, obs
        self.ACTION_BUFFER_SIZE = action_buffer_size
        self.SPEED_LIMIT = 0.03 * self.MAX_SPEED_KMH * (1000.0 / 3600.0)
        # Vision attributes (BaseAviary.py:141-146): IMG_RES is (width, height)
        self.IMG_RES = np.array([64, 48])
        self.IMG_FRAME_PER_SEC = 24
        self.IMG_CAPTURE_FREQ = max(1, int(pyb_freq / self.IMG_FRAME_PER_SEC))

        self.URDF = drone_model.value + ".urdf"  # BaseAviary.py:94
        self.DRONE_IDS = np.arange(num_drones)  # body handles are ordinals here
        self.last_action = np.zeros((num_drones, 4))
        # Construction-time housekeeping (BaseAviary.py:205-211): the env is
        # fully inspectable (pos/quat/rpy mirrors, _getDroneStateVector)
        # before the first reset(), like the reference.
        self._housekeeping()
        self._last_obs = self._obs_now()
        self._last_reward, self._last_term, self._last_trunc = -1.0, False, False
        self.action_space = self._actionSpace()
        self.observation_space = self._observationSpace()
        self._start_wall = time.time()

    # -- spaces (overridden per subclass) -------------------------------------

    def _state_obs_bounds(self):
        """(N, 20) full-state bounds (CtrlAviary.py:90-102)."""
        n = self.NUM_DRONES
        inf, pi, mr = np.inf, np.pi, self.MAX_RPM
        lo = np.array([[-inf, -inf, 0.0, -1, -1, -1, -1, -pi, -pi, -pi,
                        -inf, -inf, -inf, -inf, -inf, -inf, 0, 0, 0, 0]] * n)
        hi = np.array([[inf, inf, inf, 1, 1, 1, 1, pi, pi, pi,
                        inf, inf, inf, inf, inf, inf, mr, mr, mr, mr]] * n)
        return spaces.Box(low=lo.astype(np.float32), high=hi.astype(np.float32),
                          dtype=np.float32)

    def _action_space(self):
        raise NotImplementedError

    def _observation_space(self):
        raise NotImplementedError

    # -- reference subclassing protocol ---------------------------------------
    # The reference's documented extension pattern is subclassing BaseAviary /
    # BaseRLAviary and overriding these camelCase hooks (abstract at
    # BaseAviary.py:1020-1106; implemented by every envs/*.py subclass).
    # step()/reset() below always route through them, so a user's custom
    # aviary ported from the reference drops in unchanged: un-overridden
    # hooks fall back to the device-computed signals of the built-in task.

    def _actionSpace(self):
        """Action space hook (BaseAviary.py:1020-1026)."""
        return self._action_space()

    def _observationSpace(self):
        """Observation space hook (BaseAviary.py:1030-1036)."""
        return self._observation_space()

    def _computeObs(self):
        """Observation hook (BaseAviary.py:1040-1046): default returns the
        device step's task observation."""
        return self._np_obs(self._last_obs)

    def _computeReward(self):
        """Reward hook (BaseAviary.py:1050-1056)."""
        return float(self._last_reward)

    def _computeTerminated(self):
        """Termination hook (BaseAviary.py:1060-1066)."""
        return bool(self._last_term)

    def _computeTruncated(self):
        """Truncation hook (BaseAviary.py:1070-1076)."""
        return bool(self._last_trunc)

    def _preprocessAction(self, action):
        """Action-to-RPM hook (BaseAviary.py:1080-1096). The built-in envs
        run the action pipeline inside the device step
        (envs/base.preprocess_action), so this base version is never called;
        OVERRIDING it in a subclass switches step() to the reference flow —
        your override maps `action` to (NUM_DRONES, 4) motor RPMs host-side
        and the device step applies them directly."""
        raise NotImplementedError(
            "built-in action pipelines run on device; override this hook "
            "in a subclass to inject custom RPMs")

    def _saveLastAction(self, action):
        """Store an action as ``last_action``, (NUM_DRONES, 4) from an array or
        a {drone index: action} mapping (the reference's helper, kept for
        subclasses that call it). The device step records the RPMs it
        applies itself (``last_clipped_action``)."""
        if isinstance(action, dict):
            for k, v in action.items():
                self.last_action[int(k), :] = np.resize(np.asarray(v), (1, 4))
        else:
            self.last_action = np.reshape(np.asarray(action), (self.NUM_DRONES, 4))

    def _housekeeping(self):
        """Reinitialize per-episode state (BaseAviary._housekeeping, :452-505):
        counters, kinematics, controllers — here one fresh env state record
        replaces the reference's attribute zeroing and reloads."""
        self._state = envbase.reset(self.cfg, self.params)

    def _updateAndStoreKinematicInformation(self):
        """Parity shim (BaseAviary.py:509-519): the pos/quat/rpy/vel/ang_v
        mirrors below read the device state, so there is nothing to copy;
        provided for subclasses that call it."""

    def _addObstacles(self):
        """Obstacle hook (BaseAviary.py:484-505, BaseRLAviary.py:99-128).

        Returns the active obstacle world's spec: the RL landmark set for
        RL tasks, and BaseAviary's OWN world (samurai gate stand-in / duck /
        cube_no_rotation / sphere2, BaseAviary._addObstacles :958-981) when
        obstacles=True on a non-RL env. Obstacles are static analytic bodies
        inside the env step here (core/collisions.rl_obstacles /
        base_obstacles, enabled by AviaryConfig.collisions), not URDF loads;
        returns the (K, 7) [x, y, z, radius, hx, hy, hz] spec for
        introspection (half-extents zero for spheres, radius zero for sharp
        boxes)."""
        from gym_pybullet_drones_tpu_torch.core.collisions import (
            base_obstacles,
            rl_obstacles,
        )

        scene = base_obstacles if self.cfg.obstacle_scene == "base" else rl_obstacles
        obs = scene(self.cfg.torch_dtype, "cpu")
        return np.column_stack([_np(obs.pos), _np(obs.radius), _np(obs.half)])

    def _showDroneLocalAxes(self, nth_drone: int):
        """Local-axes debug draw (BaseAviary._showDroneLocalAxes, :964-980):
        red/green/blue body-axis traces on the LiveViewer for the given
        drone. No-op without an active GUI viewer (matching the reference,
        which draws only when GUI is on)."""
        if self._viewer is None or self._state is None:
            return
        self._viewer.show_axes(self.pos, self.quat, length=2.0 * float(self.L),
                               drones=[int(nth_drone)])

    # -- physics-term probes ---------------------------------------------------
    # The reference's per-drone physics methods (BaseAviary.py:679-892) APPLY
    # forces to the PyBullet engine. Here every term is already applied inside
    # the env step (core/dynamics.step_physics), so these shims RETURN the
    # values the step computes for drone `nth_drone` from the live state.
    # Signatures match the reference so subclass code type-checks.

    def _rpm(self, rpm):
        return torch.as_tensor(np.asarray(rpm), dtype=self.cfg.torch_dtype,
                               device=self.device).reshape(4)

    def _physics(self, rpm, nth_drone: int):
        """Motor thrust/torque term (BaseAviary._physics, :679-711): returns
        ((4,) per-prop thrusts [N, body +z], z reaction torque [N m])."""
        from gym_pybullet_drones_tpu_torch.core.dynamics import motor_forces

        forces, z_torque = motor_forces(self._rpm(rpm), self.params)
        return _np(forces), float(z_torque)

    def _groundEffect(self, rpm, nth_drone: int):
        """Ground-effect term (BaseAviary._groundEffect, :715-752): returns
        the (4,) per-prop force increments [N, body +z] at the drone's
        current pose."""
        from gym_pybullet_drones_tpu_torch.core.aero import ground_effect_forces
        from gym_pybullet_drones_tpu_torch.core.rotations import (
            quat_to_euler_xyz,
            quat_to_matrix,
        )

        kin = self._state.kin
        quat = kin.quat[nth_drone]
        forces = ground_effect_forces(self._rpm(rpm), kin.pos[nth_drone], quat_to_matrix(quat),
                                      quat_to_euler_xyz(quat), self.params)
        return _np(forces)

    def _drag(self, rpm, nth_drone: int):
        """Drag term (BaseAviary._drag, :754-783): returns the (3,)
        world-frame drag force [N] at the drone's current velocity."""
        from gym_pybullet_drones_tpu_torch.core.aero import drag_force_world

        return _np(drag_force_world(self._rpm(rpm), self._state.kin.vel[nth_drone],
                                    self.params))

    def _downwash(self, nth_drone: int):
        """Downwash term (BaseAviary._downwash, :785-811): returns the (3,)
        force [N, world, always -z] induced on drone `nth_drone` by the rest
        of the fleet."""
        from gym_pybullet_drones_tpu_torch.core.aero import downwash_forces_body_z

        z_forces = downwash_forces_body_z(self._state.kin.pos, self.params)
        return np.array([0.0, 0.0, float(z_forces[nth_drone])])

    def _dynamics(self, rpm, nth_drone: int):
        """Explicit-dynamics substep (BaseAviary._dynamics, :815-877): returns
        the next (pos, quat, vel, rpy_rates) of drone `nth_drone` after one
        1/pyb_freq step, without mutating the env (the reference writes the
        result back into the engine instead)."""
        from gym_pybullet_drones_tpu_torch.core.dynamics import substep_dyn

        kin = self._state.kin.map(lambda leaf: leaf[nth_drone])
        nxt = substep_dyn(kin, self._rpm(rpm), self.params, self.cfg.pyb_timestep)
        return _np(nxt.pos), _np(nxt.quat), _np(nxt.vel), _np(nxt.rpy_rates)

    def _integrateQ(self, quat, omega, dt):
        """Closed-form axis-angle quaternion update (BaseAviary._integrateQ,
        :879-892)."""
        from gym_pybullet_drones_tpu_torch.core.rotations import integrate_quat

        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=self.cfg.torch_dtype,
                                         device=self.device)
        return _np(integrate_quat(as_t(quat), as_t(omega), float(dt)))

    def _calculateNextStep(self, current_position, destination, step_size=1):
        """Waypoint capping helper (BaseAviary._calculateNextStep,
        :1108-1150), in float32 on the host."""
        as_t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))
        return _np(envbase._calculate_next_step(as_t(current_position), as_t(destination),
                                                float(step_size)))

    def _parseURDFParameters(self):
        """Load the 17 reference URDF constants from the port's asset
        (BaseAviary._parseURDFParameters, :985-1017), in the reference's
        return order."""
        from gym_pybullet_drones_tpu_torch.core.params import ASSETS, from_urdf

        p = from_urdf(os.path.join(ASSETS, self.URDF), self.DRONE_MODEL, device="cpu")
        return (float(p.m), float(p.arm), float(p.thrust2weight),
                _np(p.J), _np(p.J_inv), float(p.kf),
                float(p.km), float(p.collision_h), float(p.collision_r),
                float(p.collision_z_offset), float(p.max_speed_kmh),
                float(p.gnd_eff_coeff), float(p.prop_radius),
                _np(p.drag_coeff), float(p.dw_coeff_1),
                float(p.dw_coeff_2), float(p.dw_coeff_3))

    # -- reference kinematic mirrors (BaseAviary.py:468-481, updated :509-519) --
    # Read-only numpy copies of the device state; the reference exposes these
    # as numpy attributes refreshed each step and user code reads them
    # (e.g. custom _computeReward via self.pos).

    @property
    def pos(self):
        return _np(self._state.kin.pos)

    @property
    def quat(self):
        return _np(self._state.kin.quat)

    @property
    def rpy(self):
        return _np(envbase.state_rpy(self._state.kin))

    @property
    def vel(self):
        return _np(self._state.kin.vel)

    @property
    def ang_v(self):
        return _np(self._state.kin.ang_v)

    @property
    def rpy_rates(self):
        return _np(self._state.kin.rpy_rates)

    @property
    def last_clipped_action(self):
        """The motor RPMs applied on the last physics step
        (BaseAviary.py:372; stored per substep by the device step)."""
        return _np(self._state.last_rpm)

    # -- gym API ---------------------------------------------------------------

    @property
    def step_counter(self) -> int:
        return int(self._state.step_count) if self._state is not None else 0

    @staticmethod
    def _np_obs(obs):
        obs = np.asarray(obs)
        return obs if obs.dtype == np.uint8 else obs.astype(np.float32)

    def _obs_now(self):
        (obs,) = host_copy(envbase.compute_obs(self.cfg, self._state))
        return obs

    def reset(self, seed: Optional[int] = None, options=None):
        """Reference reset sequence (BaseAviary.reset, :220-255):
        _housekeeping -> kinematic refresh -> _startVideoRecording ->
        (_computeObs, _computeInfo)."""
        super().reset(seed=seed)
        prev = self._state
        self._housekeeping()
        if prev is not None and self.ACTION_BUFFER_SIZE > 0:
            # The reference's RL action deque persists across reset()
            # (BaseRLAviary.py:153-155 fills it once at construction).
            self._state = self._state.replace(action_buffer=prev.action_buffer)
        self._updateAndStoreKinematicInformation()
        self._last_obs = self._obs_now()
        self._last_reward, self._last_term, self._last_trunc = -1.0, False, False
        self._start_wall = time.time()
        self._startVideoRecording()
        return self._computeObs(), self._computeInfo()

    def _startVideoRecording(self):
        """Open a fresh frame directory when record=True
        (BaseAviary._startVideoRecording, :523-537)."""
        if not self.RECORD:
            return
        import datetime
        self._record_dir = os.path.join(
            self.OUTPUT_FOLDER,
            "recording_" + datetime.datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
        os.makedirs(self._record_dir, exist_ok=True)
        self._frame_num = 0
        self._step_index = 0

    def _maybe_record(self):
        if not self.RECORD or self._record_dir is None:
            return
        if self._step_index % self.CAPTURE_FREQ == 0:
            record_frame(self._state, self.params, bool(self.OBSTACLES), self._record_dir,
                         self._frame_num)
            self._frame_num += 1
        self._step_index += 1

    def _maybe_view(self):
        """gui=True: live 3-D fleet view (the PyBullet GUI stand-in,
        utils/viz.LiveViewer), throttled to ~10 updates per sim-second."""
        if not self.GUI:
            return
        if self._viewer is None:
            from gym_pybullet_drones_tpu_torch.utils.viz import LiveViewer

            self._viewer = LiveViewer(
                self.NUM_DRONES,
                rpm_sliders=self.USER_DEBUG,
                max_rpm=float(self.MAX_RPM),
                hover_rpm=float(self.HOVER_RPM))
            self._view_every = max(1, self.CTRL_FREQ // 10)
            self._view_index = 0
        if self._view_index % self._view_every == 0:
            pos = self.pos
            if self.USER_DEBUG:
                # local body axes per drone (BaseAviary._showDroneLocalAxes
                # under GUI+user_debug, :931-939)
                self._viewer.show_axes(pos, self.quat, length=2.0 * float(self.L))
            self._viewer.update(pos)
        self._view_index += 1

    def step(self, action):
        action = np.asarray(action)
        rpm = None
        if (self._viewer is not None
                and getattr(self._viewer, "use_gui_rpm", False)):
            # "Use GUI RPM" input switch: slider RPMs replace the action for
            # every drone, bypassing the action pipeline (reference
            # BaseAviary.py:320-333 tiles gui_input over NUM_DRONES).
            rpm = np.tile(np.asarray(self._viewer.gui_rpm, dtype=np.float32),
                          (self.NUM_DRONES, 1))
        elif self._custom_action:
            # Reference flow (BaseAviary.step :340-383): the subclass hook
            # maps the action to motor RPMs; physics + task signals on device.
            rpm = np.asarray(self._preprocessAction(action), dtype=np.float32)
        self._state, obs, reward, term, trunc = shell_step(
            self.cfg, self.params, self.ctrl_params, self.target_pos, self._state, action,
            preprocessed_rpm=rpm)
        self._last_obs = obs
        self._last_reward, self._last_term, self._last_trunc = reward, term, trunc
        self._maybe_view()
        self._maybe_record()
        return (
            self._computeObs(),
            float(self._computeReward()),
            bool(self._computeTerminated()),
            bool(self._computeTruncated()),
            self._computeInfo(),
        )

    def _computeInfo(self):
        return {"answer": 42}  # reference in-joke (CtrlAviary.py:196-200)

    def render(self):
        """Text render with the realtime factor (BaseAviary.render, :387-414)."""
        if self._state is None:
            return
        sim_t = self.step_counter * self.PYB_TIMESTEP
        wall = time.time() - self._start_wall
        print(
            f"\n[INFO] BaseAviary.render() — it {self.step_counter:04d} — "
            f"wall-clock time {wall:.1f}s, simulation time {sim_t:.1f}s@{self.PYB_FREQ}Hz "
            f"({(sim_t / wall) if wall > 0 else 0.0:.2f}x)"
        )
        pos, vel, ang = self.pos, self.vel, self.ang_v
        rpy = np.degrees(self.rpy)
        for i in range(self.NUM_DRONES):
            print(
                f"[INFO] BaseAviary.render() — drone {i} — "
                f"x {pos[i,0]:+06.2f}, y {pos[i,1]:+06.2f}, z {pos[i,2]:+06.2f}, "
                f"velocity {np.linalg.norm(vel[i]):+06.2f}, "
                f"roll {rpy[i,0]:+06.2f}, pitch {rpy[i,1]:+06.2f}, yaw {rpy[i,2]:+06.2f}, "
                f"angular velocity {np.linalg.norm(ang[i]):+06.4f}"
            )

    def close(self):
        """Finalize a recording: mux the PNG frames into one playable video
        (the reference's MP4 capture, BaseAviary.py:523-537 — here H.264 MP4
        via ffmpeg when available, else the built-in MJPEG AVI muxer)."""
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        if self.RECORD and self._record_dir is not None and self._frame_num > 0:
            from gym_pybullet_drones_tpu_torch.utils.video import png_dir_to_video

            try:
                out = png_dir_to_video(self._record_dir, fps=24)
                print(f"[INFO] recording muxed to {out}")
            except (OSError, ValueError, subprocess.SubprocessError) as e:  # the PNG frames stay
                print(f"[WARNING] video muxing failed ({e}); PNG frames kept")
            self._record_dir = None

    def getDroneIds(self):
        return np.arange(self.NUM_DRONES)

    def getPyBulletClient(self):
        """API-parity stub (BaseAviary.getPyBulletClient): there is no
        PyBullet client in this stack; returns -1 so scripts that merely
        thread the handle through keep working."""
        return -1

    def _getDroneStateVector(self, nth_drone: int) -> np.ndarray:
        """Reference 20-dim state accessor (BaseAviary.py:541-561)."""
        return _np(envbase.drone_state_vector(self.cfg, self._state)[nth_drone])

    def _getAdjacencyMatrix(self) -> np.ndarray:
        return _np(envbase.adjacency_matrix(self._state.kin.pos, self.NEIGHBOURHOOD_RADIUS))

    def _getDroneImages(self, nth_drone: int, segmentation: bool = True):
        """Camera captures from the n-th drone POV (BaseAviary.py:565-617):
        (h, w, 4) uint8 RGBA, (h, w) depth, (h, w) segmentation — rendered by
        the ray-cast camera (K7 on the card) instead of PyBullet's
        TinyRenderer. ``segmentation`` is accepted for signature parity (the
        ray caster produces the mask at no extra cost)."""
        from gym_pybullet_drones_tpu_torch.render.camera import CameraConfig, render_drone_views

        kin = self._state.kin
        cfg = CameraConfig(width=int(self.IMG_RES[0]), height=int(self.IMG_RES[1]),
                           with_landmarks=bool(self.OBSTACLES))
        # cam_indices renders only the requested view while all N drones stay
        # in the scene with their global seg ids.
        rgb, dep, seg = render_drone_views(kin.pos, kin.quat, float(self.L), cfg,
                                           cam_indices=nth_drone)
        return tuple(host_copy(rgb[0], dep[0], seg[0]))

    def _exportImage(self, img_type, img_input, path: str, frame_num: int = 0):
        """Save a capture as ``frame_<num>.png`` (BaseAviary.py:621-654)."""
        from gym_pybullet_drones_tpu_torch.render.camera import export_image

        export_image(img_type, img_input, path, frame_num)

    def _normalizedActionToRPM(self, action):
        """Piecewise de-normalization of [-1, 1] to [0, MAX_RPM]:
        -1 -> 0, 0 -> HOVER_RPM, 1 -> MAX_RPM (BaseAviary.py:896-915)."""
        action = np.asarray(action)
        if np.any(np.abs(action) > 1):
            print(f"\n[ERROR] it {self.step_counter} in "
                  "BaseAviaryEnv._normalizedActionToRPM(), out-of-bound action")
        return np.where(action <= 0, (action + 1) * self.HOVER_RPM,
                        self.HOVER_RPM + (self.MAX_RPM - self.HOVER_RPM) * action)


class CtrlAviary(BaseAviaryEnv):
    """Direct-RPM control env (reference envs/CtrlAviary.py)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("pyb_freq", 240)
        kwargs.setdefault("ctrl_freq", 240)
        kwargs["task"] = TASK_CTRL
        super().__init__(**kwargs)

    def _action_space(self):
        n = self.NUM_DRONES
        return spaces.Box(
            low=np.zeros((n, 4), dtype=np.float32),
            high=np.full((n, 4), self.MAX_RPM, dtype=np.float32),
            dtype=np.float32,
        )

    def _observation_space(self):
        return self._state_obs_bounds()


class VelocityAviary(BaseAviaryEnv):
    """Velocity-command env with embedded DSLPID (reference envs/VelocityAviary.py)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("pyb_freq", 240)
        kwargs.setdefault("ctrl_freq", 240)
        kwargs["task"] = TASK_VELOCITY
        super().__init__(**kwargs)

    def _action_space(self):
        n = self.NUM_DRONES
        lo = np.tile(np.array([-1.0, -1.0, -1.0, 0.0], dtype=np.float32), (n, 1))
        hi = np.ones((n, 4), dtype=np.float32)
        return spaces.Box(low=lo, high=hi, dtype=np.float32)

    def _observation_space(self):
        return self._state_obs_bounds()


class _RLAviary(BaseAviaryEnv):
    """Shared RL shell (reference envs/BaseRLAviary.py): KIN obs + action buffer."""

    def __init__(self, task, **kwargs):
        kwargs.setdefault("pyb_freq", 240)
        kwargs.setdefault("ctrl_freq", 30)
        kwargs.setdefault("act", ActionType.RPM)
        kwargs.setdefault("obs", ObservationType.KIN)
        # The reference's RL base forces obstacles on (BaseRLAviary.py:89);
        # the landmark spheres then appear in recorded/queried camera views.
        kwargs.setdefault("obstacles", True)
        ctrl_freq = kwargs["ctrl_freq"]
        kwargs.setdefault("action_buffer_size", int(ctrl_freq // 2))
        kwargs["task"] = task
        super().__init__(**kwargs)
        self.TARGET_POS = _np(self.target_pos)

    def _action_space(self):
        n, a = self.NUM_DRONES, self.cfg.action_dim
        return spaces.Box(
            low=-np.ones((n, a), dtype=np.float32),
            high=np.ones((n, a), dtype=np.float32),
            dtype=np.float32,
        )

    def _observation_space(self):
        n, a = self.NUM_DRONES, self.cfg.action_dim
        if self.OBS_TYPE == ObservationType.RGB:
            # (N, H, W, 4) uint8 frames (BaseRLAviary.py:253-256); IMG_RES is
            # (width=64, height=48) like the reference default (:34). With
            # frame_stack K the last K captures stack channel-wise (4K).
            return spaces.Box(low=0, high=255, shape=(n, 48, 64, 4 * self.cfg.frame_stack),
                              dtype=np.uint8)
        lo = np.full((n, 12), -np.inf)
        lo[:, 2] = 0.0
        hi = np.full((n, 12), np.inf)
        buf_lo = -np.ones((n, self.ACTION_BUFFER_SIZE * a))
        buf_hi = np.ones((n, self.ACTION_BUFFER_SIZE * a))
        return spaces.Box(
            low=np.hstack([lo, buf_lo]).astype(np.float32),
            high=np.hstack([hi, buf_hi]).astype(np.float32),
            dtype=np.float32,
        )

    def step(self, action):
        action = np.asarray(action).reshape(self.NUM_DRONES, self.cfg.action_dim)
        return super().step(action)


class HoverAviary(_RLAviary):
    """Single-drone hover-at-[0,0,1] RL task (reference envs/HoverAviary.py)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("num_drones", 1)
        kwargs.setdefault("episode_len_sec", 8.0)
        super().__init__(TASK_HOVER, **kwargs)


class MultiHoverAviary(_RLAviary):
    """Multi-drone hover RL task (reference envs/MultiHoverAviary.py)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("num_drones", 2)
        kwargs.setdefault("episode_len_sec", 8.0)
        super().__init__(TASK_MULTIHOVER, **kwargs)
