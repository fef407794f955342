"""The device work of the Gymnasium shells, without gymnasium.

``compat/gym.py`` (one env a shell) and ``compat/vector.py`` (``VecAviary``)
are thin gymnasium wrappers over the functions here, which import nothing of
gymnasium: a machine without it still runs and measures the same device path.

* ``shell_config`` is the ``AviaryConfig`` a shell builds from the
  reference constructor's keywords.
* ``shell_step`` is one step of a single shell env: numpy action in, the env
  step on the params' device, the step's outputs back in one transfer.
* ``record_frame`` is one frame of ``record=True``: drone 0's camera (K7 on
  the card), written as a PNG.
* ``make_vec_core`` builds the reset and step of a batch of envs over
  ``runtime/rollout.make_batched_step(..., auto_reset=True)``: one
  host-to-device copy of the actions and one device-to-host copy of the
  outputs (obs, reward, terminated, truncated, the true final obs) a step.
* ``host_copy`` is that one copy: the tensors' bytes are concatenated on the
  device, moved with a single ``.cpu()``, and split back into numpy arrays.
"""

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_CTRL, TASK_VELOCITY, AviaryConfig
from gym_pybullet_drones_tpu_torch.envs.spec import (
    ActionType,
    DroneModel,
    ImageType,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.render.camera import (
    CameraConfig,
    export_image,
    render_drone_views,
)
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64, torch.uint8: np.uint8,
          torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64}


def host_copy(*tensors):
    """numpy copies of ``tensors`` through one device-to-host transfer."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].copy().view(_NUMPY[t.dtype]).reshape(tuple(t.shape)))
        at += n
    return out


def shell_config(drone_model: DroneModel = DroneModel.CF2X, num_drones: int = 1,
                 neighbourhood_radius: float = np.inf, initial_xyzs=None, initial_rpys=None,
                 physics: Physics = Physics.PYB, pyb_freq: int = 240, ctrl_freq: int = 240,
                 obstacles: bool = False, task: str = TASK_CTRL,
                 act: ActionType = ActionType.RPM, obs: ObservationType = ObservationType.KIN,
                 action_buffer_size: int = 0, episode_len_sec: float = 8.0,
                 frame_stack: int = 1) -> AviaryConfig:
    """The env configuration of a shell with these reference keywords
    (BaseAviary.__init__, BaseAviary.py:25-40)."""
    as_tuple = lambda x: None if x is None else tuple(map(tuple, np.asarray(x, dtype=float)))
    return AviaryConfig(
        drone_model=drone_model, num_drones=num_drones, physics=physics, pyb_freq=pyb_freq,
        ctrl_freq=ctrl_freq, task=task, action_type=act, obs_type=obs, obstacles=obstacles,
        # obstacles=True on a NON-RL env reaches BaseAviary's own
        # samurai/duck/cube/sphere world (BaseAviary._addObstacles,
        # :958-981), not the RL landmarks
        obstacle_scene="base" if obstacles and task in (TASK_CTRL, TASK_VELOCITY) else "rl",
        action_buffer_size=action_buffer_size, episode_len_sec=episode_len_sec,
        neighbourhood_radius=float(neighbourhood_radius),
        initial_xyzs=as_tuple(initial_xyzs), initial_rpys=as_tuple(initial_rpys),
        frame_stack=frame_stack,
    )


def record_frame(state, params, with_landmarks: bool, path: str, frame_num: int) -> str:
    """Drone 0's 128 x 96 camera frame of ``record=True``
    (BaseAviary._startVideoRecording, :523-537), written as
    ``path/frame_<frame_num>.png``; returns the file's path."""
    rgba, _, _ = render_drone_views(
        state.kin.pos, state.kin.quat, params.arm,
        CameraConfig(width=128, height=96, with_landmarks=with_landmarks), cam_indices=0)
    return export_image(ImageType.RGB, rgba[0], path, frame_num)


def shell_step(cfg, params, ctrl_params, target_pos, state, action, preprocessed_rpm=None):
    """``envs/base.step`` of one env from host inputs: returns ``(state, obs,
    reward, terminated, truncated)`` with the new state on the device and the
    signals as numpy, copied in one transfer. ``preprocessed_rpm`` (numpy
    (N, 4) motor RPMs) bypasses the action pipeline, as in ``envs/base.step``."""
    device = params.m.device
    rpm = None
    if preprocessed_rpm is not None:
        rpm = torch.as_tensor(np.asarray(preprocessed_rpm), dtype=cfg.torch_dtype,
                              device=device)
    state, obs, reward, term, trunc = envbase.step(
        cfg, params, ctrl_params, target_pos, state,
        torch.as_tensor(np.asarray(action), dtype=cfg.torch_dtype, device=device),
        preprocessed_rpm=rpm)
    obs, reward, term, trunc = host_copy(obs, reward, term, trunc)
    return state, obs, reward, term, trunc


def make_vec_core(cfg, params, ctrl_params, target_pos, num_envs, device=None):
    """``reset() -> (state, obs)`` and ``step(state, actions) -> (state,
    (obs, reward, terminated, truncated, final_obs))`` of ``num_envs`` envs
    on ``device`` (``None``: the card), the host side in numpy.

    ``params`` may be batched (``core.params.randomize_params``): each env
    then steps its own plant. Envs that finish restart at once (gymnasium's
    SAME_STEP autoreset); ``final_obs`` holds every env's true post-step
    observation, of which the caller keeps the finished envs'."""
    device = resolve_device(device)
    to = lambda x: None if x is None else x.to(device)
    params, ctrl_params, target_pos = params.to(device), ctrl_params.to(device), to(target_pos)
    step_fn = make_batched_step(cfg, params, ctrl_params, target_pos, auto_reset=True)
    act_dtype = cfg.torch_dtype

    def reset():
        state = batch_reset(cfg, params, num_envs, device=device)
        (obs,) = host_copy(envbase.compute_obs(cfg, state))
        return state, obs

    def step(state, actions):
        actions = torch.as_tensor(np.asarray(actions), dtype=act_dtype, device=device)
        state, out = step_fn(state, actions)
        return state, tuple(host_copy(out.obs, out.reward, out.terminated, out.truncated,
                                      out.final_obs))

    return reset, step
