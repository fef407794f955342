"""Gymnasium `VectorEnv` shell: one batched env step for the whole batch
(port of the JAX ``compat/vector.py``).

The reference trains through SB3's `make_vec_env` (reference
examples/learn.py:54-66, invoked with n_envs=1 because PyBullet envs step at
O(100)/s each); a switching user expects a vectorized API. This module gives
them the standard `gymnasium.vector.VectorEnv` surface over the port's
batched step (`runtime/shell.make_vec_core` over
`runtime.rollout.make_batched_step`), so `step(actions)` is one batched env
step on the device plus one copy each way, instead of `num_envs` Python env
steps.

Autoreset follows `gymnasium.vector.AutoresetMode.SAME_STEP` (the SB3 VecEnv
convention the reference relies on through learn.py:83-95): on a done step the
returned obs is already the fresh episode's first obs and the true terminal
observation is delivered in `infos["final_obs"]` — exactly what
`gymnasium.vector.SyncVectorEnv(autoreset_mode=SAME_STEP)` produces. The RL
action buffer persists across autoresets (BaseRLAviary.py:153-155 fills the
deque once at construction and never clears it), replicated by the batched
step itself (runtime/rollout.py).

`gym.make_vec("cuda/hover-aviary-v0", num_envs=4096)` resolves here via the
`vector_entry_point` registration in the package `__init__`.
"""

from typing import Optional, Type

import numpy as np
import torch
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from gym_pybullet_drones_tpu_torch.compat.gym import BaseAviaryEnv, HoverAviary
from gym_pybullet_drones_tpu_torch.runtime.shell import make_vec_core


class VecAviary(VectorEnv):
    """Batched aviary with the standard Gymnasium vector API.

    Parameters
    ----------
    num_envs : int
        Batch size. All envs advance in lockstep, one batched step a call.
    env_class : type, optional
        Any of the drop-in shell classes (`HoverAviary`, `MultiHoverAviary`,
        `CtrlAviary`, `VelocityAviary`) or a subclass that only customizes
        constructor arguments. Defaults to `HoverAviary`.
    domain_rand : dict, optional
        Per-env plant randomization spec forwarded to
        `core.params.randomize_params` (e.g. ``{"m": 0.1}`` for +-10% mass);
        each env then steps its own perturbed plant while the controller and
        task constants stay nominal. The draws come from a CPU
        ``torch.Generator`` seeded with ``domain_rand_seed``, so the card and
        the CPU step the same plants.
    **env_kwargs
        Forwarded to ``env_class`` (same signature as the reference
        constructors, BaseAviary.py:25-40, plus ``device``: None is the card).

    Notes
    -----
    A template single env is constructed once to derive spaces and the
    reference attribute surface (NUM_DRONES, CTRL_FREQ, HOVER_RPM, ...); it is
    kept as ``self.template`` for attribute passthrough but never stepped.
    Actions and observations cross the host boundary as one (num_envs, ...)
    numpy block each way a step.
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP}

    def __init__(
        self,
        num_envs: int,
        env_class: Type[BaseAviaryEnv] = HoverAviary,
        domain_rand: Optional[dict] = None,
        domain_rand_seed: int = 0,
        **env_kwargs,
    ):
        import warnings

        with warnings.catch_warnings():
            # The template never steps, so the shell's one-round-trip-per-step
            # performance warning does not apply to this path.
            warnings.filterwarnings("ignore", message=".*drop-in compatibility.*")
            self.template = env_class(**env_kwargs)
        t = self.template
        self.num_envs = int(num_envs)
        self.single_action_space = t.action_space
        self.single_observation_space = t.observation_space
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.render_mode = None
        self.spec = None

        params = t.params
        if domain_rand:
            from gym_pybullet_drones_tpu_torch.core.params import randomize_params

            params = randomize_params(torch.Generator().manual_seed(int(domain_rand_seed)),
                                      t.params, self.num_envs, domain_rand)
        self._params = params
        self._cfg = t.cfg
        self._reset, self._step = make_vec_core(t.cfg, params, t.ctrl_params, t.target_pos,
                                                self.num_envs, t.device)
        self._state, _ = self._reset()
        self._act_shape = (self.num_envs,) + self.single_action_space.shape

    # -- VectorEnv API ---------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        """Batch reset. Like the reference (BaseAviary.reset, :220-255), the
        initial state is deterministic — the seed only seeds the spaces."""
        if seed is not None:
            self.single_action_space.seed(seed)
            self.action_space.seed(seed)
        self._state, obs = self._reset()
        return self._np_obs(obs), {}

    def step(self, actions):
        actions = np.asarray(actions, dtype=np.float32).reshape(self._act_shape)
        self._state, (obs, reward, term, trunc, final_obs) = self._step(self._state, actions)
        done = term | trunc
        infos = {}
        if done.any():
            # gymnasium SAME_STEP convention (vector/sync_vector_env.py):
            # object arrays valid where the matching `_`-prefixed mask is set.
            # Episodes are deterministic-length, so often ALL envs finish on
            # the same step — build the object arrays without a Python loop.
            fo = np.full(self.num_envs, None, dtype=object)
            fi = np.full(self.num_envs, None, dtype=object)
            np_final = self._np_obs(final_obs)
            n_done = int(done.sum())
            per_env = np.empty(n_done, dtype=object)
            per_env[:] = list(np_final[done])
            fo[done] = per_env
            fi[done] = np.array([{} for _ in range(n_done)], dtype=object)
            infos = {"final_obs": fo, "_final_obs": done.copy(),
                     "final_info": fi, "_final_info": done.copy()}
        return self._np_obs(obs), np.asarray(reward, dtype=np.float32), term, trunc, infos

    def render(self):
        return None

    def close_extras(self, **kwargs):
        self.template.close()

    # -- helpers ---------------------------------------------------------------

    # uint8-passthrough / float32-cast, shared with the single-env shell
    _np_obs = staticmethod(BaseAviaryEnv._np_obs)


def make_vec_env(env_class: Type[BaseAviaryEnv] = HoverAviary,
                 n_envs: int = 1, seed: int = 0,
                 env_kwargs: Optional[dict] = None) -> VecAviary:
    """SB3 `make_vec_env` signature analogue (reference learn.py:54-66)."""
    env = VecAviary(n_envs, env_class, **(env_kwargs or {}))
    env.reset(seed=seed)
    return env


def _vector_entry_point(env_class):
    """Builds a `gym.make_vec` entry point for one shell class."""

    def make(num_envs: int = 1, **kwargs):
        kwargs.pop("max_episode_steps", None)
        kwargs.pop("autoreset_mode", None)
        return VecAviary(num_envs, env_class, **kwargs)

    return make


def _vec_ctrl(num_envs: int = 1, **kwargs):
    from gym_pybullet_drones_tpu_torch.compat.gym import CtrlAviary

    return _vector_entry_point(CtrlAviary)(num_envs, **kwargs)


def _vec_velocity(num_envs: int = 1, **kwargs):
    from gym_pybullet_drones_tpu_torch.compat.gym import VelocityAviary

    return _vector_entry_point(VelocityAviary)(num_envs, **kwargs)


def _vec_hover(num_envs: int = 1, **kwargs):
    return _vector_entry_point(HoverAviary)(num_envs, **kwargs)


def _vec_multihover(num_envs: int = 1, **kwargs):
    from gym_pybullet_drones_tpu_torch.compat.gym import MultiHoverAviary

    return _vector_entry_point(MultiHoverAviary)(num_envs, **kwargs)
