"""Batched rollouts with auto-reset (port of the JAX ``runtime/rollout.py``).

A batch of environments advances as one set of tensor operations: the env
axis leads every tensor, and ``envs/base.step`` broadcasts over it. Envs that
finish are replaced by the initial state (the VecEnv convention the reference
relies on through SB3, learn.py:83-95): the obs returned at a done step is the
new episode's first obs. Time is a Python loop; the hot single-drone velocity
path has its own kernel (``ops/velocity_rollout.py``).

Domain-randomized params (``core.params.randomize_params``, leaves with a
leading env axis) step each env with its own plant, through
``torch.func.vmap`` over the env step as the JAX package vmaps it; the RGB
configs' camera renders the whole batch in one call there too (its operator's
batching rule, ``ops/render_views.py``). The held RGB frames reset with the
state, from the nominal initial pose; the action buffer persists.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device, struct_where
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import AviaryConfig, AviaryState


class StepOutput(NamedTuple):
    """Per-step signals; ``rollout`` stacks them along a leading time axis.

    ``final_obs`` is the true post-step observation even on auto-reset steps
    (where ``obs`` is already the fresh episode's first obs)."""

    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    final_obs: torch.Tensor = None


def params_are_batched(params) -> bool:
    """True for per-env randomized params (``core.params.randomize_params``):
    the mass carries a leading env axis."""
    return params.m.ndim > 0


def nominal_params(params):
    """Env 0's slice of batched params (identity when unbatched).
    Randomization never touches geometry, so env 0's spawn grid stands in for
    the whole batch."""
    if not params_are_batched(params):
        return params
    return params.map(lambda x: x[0])


def _leaves(struct):
    out = []
    struct.map(lambda t: out.append(t) or t)
    return out


def _rebuild(template, leaves):
    it = iter(leaves)
    return template.map(lambda _: next(it))


def _broadcast(state: AviaryState, num_envs: int) -> AviaryState:
    """``num_envs`` distinct copies of one state (cloned, so no leaf aliases)."""
    return state.map(lambda x: x.expand((num_envs,) + x.shape).clone())


def batch_reset(cfg: AviaryConfig, params, num_envs: int, device=None) -> AviaryState:
    """A batch of ``num_envs`` freshly reset envs (leaves shaped (E, ...)).

    The reference reset is deterministic (BaseAviary.py:220-255), so the batch
    is one initial state repeated. Batched (domain-randomized) params reset
    from the nominal geometry. ``device=None`` means the CUDA card.
    """
    params = nominal_params(params).to(resolve_device(device))
    return _broadcast(envbase.reset(cfg, params), num_envs)


def env_health(state: AviaryState) -> torch.Tensor:
    """Per-env bool: all kinematic leaves finite (leaves (E, N, d))."""
    kin = state.kin

    def finite(x):
        return torch.isfinite(x).flatten(1).all(dim=1)

    return (finite(kin.pos) & finite(kin.quat) & finite(kin.vel)
            & finite(kin.ang_v) & finite(kin.rpy_rates))


def make_batched_step(cfg: AviaryConfig, params, ctrl_params, target_pos,
                      auto_reset: bool = True, reset_on_nan: bool = True):
    """Build ``step(state, action) -> (state, StepOutput)`` over an env batch.

    ``state`` leaves carry a leading env axis; ``action`` is (E, N, A). With
    ``auto_reset``, envs that finish (terminated | truncated) restart from the
    initial state and the returned obs is the fresh episode's first obs. With
    ``reset_on_nan``, a non-finite env is TERMINATED (not truncated) and reset
    instead of propagating NaNs, so a policy that blows up the sim loses its
    future reward rather than receiving a time-limit bootstrap.

    Batched params (``params_are_batched``) give each env its own plant; the
    controller and task constants stay nominal.
    """
    if params_are_batched(params):
        vstep = _per_env_step(cfg, params, ctrl_params, target_pos)
    else:
        vstep = partial(envbase.step, cfg, params, ctrl_params, target_pos)
    init_state = envbase.reset(cfg, nominal_params(params))
    init_obs = envbase.compute_obs(cfg, init_state)

    def step(state: AviaryState, action):
        new_state, obs, reward, term, trunc = vstep(state, action)
        num_envs = obs.shape[0]
        fresh = _broadcast(init_state, num_envs)
        if reset_on_nan:
            unhealthy = ~env_health(new_state)
            term = term | unhealthy
            reward = torch.where(unhealthy, torch.zeros_like(reward), reward)
            # The NaN state's observation must not leak anywhere, not even as
            # final_obs (the value bootstrap of PPO reads it).
            obs = struct_where(unhealthy, init_obs.expand(obs.shape), obs)
        if not auto_reset:
            if reset_on_nan:
                # Restore a diverged env even without episode auto-reset, or it
                # would freeze with masked obs and terminated=True forever.
                new_state = struct_where(unhealthy, fresh, new_state)
            return new_state, StepOutput(obs, reward, term, trunc, obs)
        done = term | trunc
        persisted_buffer = new_state.action_buffer
        new_state = struct_where(done, fresh, new_state)
        # Reference parity: BaseRLAviary's action deque is filled once at
        # construction and never cleared on reset (BaseRLAviary.py:153-155).
        new_state = new_state.replace(action_buffer=persisted_buffer)
        final_obs = obs
        if cfg.action_buffer_size > 0:
            # Post-reset KIN obs = fresh kinematics + the persisted buffer (an
            # RGB obs is the reset state's frames, the initial capture)
            reset_obs = envbase.compute_obs(cfg, new_state)
            obs = struct_where(done, reset_obs, obs)
        else:
            obs = struct_where(done, init_obs.expand(obs.shape), obs)
        return new_state, StepOutput(obs, reward, term, trunc, final_obs)

    return step


def _per_env_step(cfg, params, ctrl_params, target_pos):
    """``envbase.step`` vmapped over the env axis of params, state and
    action (JAX's ``jax.vmap(..., in_axes=(0, 0, 0))``): inside the map each
    env is a single env with its own plant."""
    p_leaves = _leaves(params)
    template = nominal_params(params)
    state_template = envbase.reset(cfg, template)

    def one(p, s, a):
        state, obs, reward, term, trunc = envbase.step(
            cfg, _rebuild(template, p), ctrl_params, target_pos,
            _rebuild(state_template, s), a)
        return _leaves(state), obs, reward, term, trunc

    mapped = torch.func.vmap(one)

    def step(state, action):
        leaves, obs, reward, term, trunc = mapped(p_leaves, _leaves(state), action)
        return _rebuild(state, leaves), obs, reward, term, trunc

    return step


def rollout(
    step_fn: Callable,
    policy_fn: Callable,
    state: AviaryState,
    policy_state,
    obs,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
):
    """Run ``num_steps`` of (policy -> env step).

    ``policy_fn(policy_state, obs, generator) -> (action, new_policy_state)``.
    Returns ``((state, policy_state, obs), StepOutput)`` where the StepOutput
    leaves have a leading time axis.
    """
    outs = []
    for _ in range(num_steps):
        action, policy_state = policy_fn(policy_state, obs, generator)
        state, out = step_fn(state, action)
        obs = out.obs
        outs.append(out)
    stacked = StepOutput(*(torch.stack(list(leaves)) if leaves[0] is not None else None
                           for leaves in zip(*outs)))
    return (state, policy_state, obs), stacked


def episode_stats(rewards, dones):
    """Per-env episode accumulation over (T, E) reward/done columns: returns
    (running, total, count) — the return still accruing in each env, the sum
    of completed episode returns, and how many completed."""
    running = torch.zeros_like(rewards[0])
    total = torch.zeros_like(rewards[0])
    count = torch.zeros(rewards.shape[1:], dtype=torch.int32, device=rewards.device)
    zero = torch.zeros_like(running)
    for r, d in zip(rewards, dones):
        running = running + r
        total = total + torch.where(d, running, zero)
        count = count + d.to(torch.int32)
        running = torch.where(d, zero, running)
    return running, total, count


def episode_returns(outputs: StepOutput):
    """Undiscounted returns of completed episodes and their number, from a
    rollout's stacked signals (time axis leading)."""
    _, total, count = episode_stats(outputs.reward,
                                    outputs.terminated | outputs.truncated)
    return total, count
