"""Behavior-cloning warm start for the hard action types.

Port of the JAX package's ``rl/warmstart.py``. The 4-dim ``ActionType.RPM``
Hover task is a knife-edge stabilization problem: plain PPO learns a policy
that leans on its action noise and falls over when the noise is removed at
evaluation. The DSLPID controller squeezed into the ±5 % RPM action band
(a = (rpm / hover - 1) / 0.05, clipped) reaches the threshold
deterministically, so training starts from a DAgger-style clone of it:
rollouts execute expert + noise for state coverage, the labels are the
expert's noiseless action at each visited state (the expert's own PID
integrators ride along the noisy path), then PPO fine-tunes with the log-std
annealing cap (``PPOConfig.log_std_anneal_to``).
"""

import torch

from gym_pybullet_drones_tpu_torch.control.dsl_pid import dsl_pid_control, dsl_pid_reset
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset


def dslpid_in_band_expert(env_cfg, aux):
    """Build ``expert(env_state, pid_state) -> (action, pid_state)``: DSLPID's
    output mapped into the RPM action band of BaseRLAviary.py:192. The state
    may carry leading env axes."""
    ctrl_params = aux["ctrl_params"]
    target = aux["target_pos"]
    hover = aux["params_env"].hover_rpm

    def expert(env_state, cs):
        rpm, cs, _, _ = dsl_pid_control(
            ctrl_params, cs, env_cfg.ctrl_timestep, env_state.kin.pos,
            env_state.kin.quat, env_state.kin.vel, target)
        return torch.clamp((rpm / hover - 1.0) / 0.05, -1.0, 1.0), cs

    return expert


def _collect(env_cfg, aux, expert, net, episodes, noise, use_policy, generator):
    """One batch of ``episodes`` envs stepped together for an episode:
    executing the expert (or, with ``use_policy``, the policy's mean) plus
    noise, labelled by the expert. Returns (obs, labels), one row a visited
    state, episode-major."""
    params_env = aux["params_env"]
    device = params_env.m.device
    steps = int(env_cfg.episode_len_sec * env_cfg.ctrl_freq)
    state = batch_reset(env_cfg, params_env, episodes, device=device)
    cs = dsl_pid_reset((episodes, env_cfg.num_drones), dtype=env_cfg.torch_dtype,
                       device=device)
    xs, ys = [], []
    with torch.no_grad():
        for _ in range(steps):
            obs = envbase.compute_obs(env_cfg, state).reshape(episodes, -1)
            a_exp, cs = expert(state, cs)
            a_drive = net(obs)[0].reshape(a_exp.shape) if use_policy else a_exp
            a_exec = torch.clamp(
                a_drive + noise * torch.randn(a_exp.shape, generator=generator,
                                              dtype=a_exp.dtype, device=device), -1.0, 1.0)
            state = envbase.step(env_cfg, params_env, aux["ctrl_params"], aux["target_pos"],
                                 state, a_exec)[0]
            xs.append(obs)
            ys.append(a_exp.reshape(episodes, -1))
    return torch.stack(xs, 1).flatten(0, 1), torch.stack(ys, 1).flatten(0, 1)


def _fit(net, X, Y, n_steps, bc_batch, generator, verbose):
    """Adam on the mean head's MSE, the LR linear from 1e-3 to 5e-5 over
    ``n_steps`` (optax.linear_schedule)."""
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    for step in range(n_steps):
        opt.param_groups[0]["lr"] = 1e-3 + (5e-5 - 1e-3) * step / n_steps
        idx = torch.randint(0, X.shape[0], (bc_batch,), generator=generator, device=X.device)
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((net(X[idx])[0] - Y[idx]) ** 2)
        loss.backward()
        opt.step()
        if verbose and ((step + 1) % 2000 == 0 or step + 1 == n_steps):
            print(f"[bc] step {step + 1}/{n_steps} mse {float(loss):.5f}", flush=True)


def bc_pretrain(env_cfg, runner, aux, generator, *, episodes=768, noise=0.25,
                bc_steps=20000, bc_batch=4096, log_std=-1.0, dagger_rounds=0, verbose=True):
    """Clone the DSLPID-in-band expert into ``runner.params`` (in place: the
    policy trunk and mean head fitted, ``log_std`` set); returns
    ``(runner, generator)``.

    With ``dagger_rounds`` > 0, after the fit on the expert's rollouts the
    DAgger loop runs: collect episodes executing the CURRENT policy (plus
    noise), label every visited state with the expert (whose PID state rides
    along the policy's trajectory), add them to the dataset, refit on half as
    many steps. This attacks the covariate shift of plain BC on knife-edge
    stabilization.
    """
    expert = dslpid_in_band_expert(env_cfg, aux)
    net = runner.params
    X, Y = _collect(env_cfg, aux, expert, net, episodes, noise, False, generator)
    if verbose:
        print(f"[bc] dataset {X.shape[0]} samples", flush=True)
    _fit(net, X, Y, bc_steps, bc_batch, generator, verbose)
    for r in range(dagger_rounds):
        x, y = _collect(env_cfg, aux, expert, net, max(1, episodes // 2), noise, True,
                        generator)
        X, Y = torch.cat([X, x]), torch.cat([Y, y])
        if verbose:
            print(f"[dagger {r + 1}/{dagger_rounds}] dataset {X.shape[0]}", flush=True)
        _fit(net, X, Y, bc_steps // 2, bc_batch, generator, verbose)
    with torch.no_grad():
        net.log_std.fill_(log_std)
    return runner, generator
