"""The port's PPO (rl/ppo.py) and BC warm start (rl/warmstart.py) against the
JAX package's on the CPU: the network, the log-prob, GAE, the config, one
whole train step from the same initial params, and the DSLPID expert."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu.rl import ppo as jppo
from gym_pybullet_drones_tpu.rl import warmstart as jws
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo
from gym_pybullet_drones_tpu_torch.rl import warmstart as tws
from torch_parity import jit_reference

jroll = importlib.import_module("gym_pybullet_drones_tpu.runtime.rollout")
troll = importlib.import_module("gym_pybullet_drones_tpu_torch.runtime.rollout")

# The train-step limits, float32 (the JAX reference runs with x64 enabled, so
# some of its constants and its noise are float64). Rewards: the 32-step
# deterministic closed loops of both packages differ by float32 rounding, at
# most a few ulps of a reward near 2. Params: each parameter moves by at most
# about lr = 3e-4 an Adam step (2 steps here); 1e-5 is 3 % of one step, far
# above the rounding of the two packages' gradients (measured gap in
# CHANGES.md) and far below what a wrong term in the loss or a wrong GAE moves.
REWARD_ATOL = 1e-5
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-4


def _configs(action="ONE_D_RPM", n=1, dtype="float32", **kw):
    common = dict(num_drones=n, task="hover" if n == 1 else "multihover", pyb_freq=240,
                  ctrl_freq=30, action_buffer_size=15, dtype=dtype, **kw)
    return (jbase.AviaryConfig(action_type=jspec.ActionType[action], **common),
            tbase.AviaryConfig(action_type=tspec.ActionType[action], **common))


def _to_jax(module):
    return jax.tree.map(jnp.asarray, convert.actor_critic_to_flax(module))


def _flax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("hidden", [(64, 64), (256, 256)])
@pytest.mark.parametrize("n", [1, 2])
def test_actor_critic_forward_equals_flax(hidden, n):
    """atol 1e-6 on mean, log_std and value, float32, both widths the
    checkpoints use, 1 and 2 drones (27 and 54 obs, 1 and 2 actions)."""
    _, tcfg = _configs(n=n)
    obs_dim, act_dim = n * tcfg.obs_dim, n * tcfg.action_dim
    net = tppo.ActorCritic(obs_dim, act_dim, hidden, -0.5,
                           torch.Generator().manual_seed(3), device="cpu")
    obs = np.random.default_rng(0).normal(size=(7, n, tcfg.obs_dim)).astype(np.float32)
    got = net(torch.as_tensor(obs))
    want = jppo.ActorCritic(action_dim=act_dim, hidden=hidden).apply(_to_jax(net),
                                                                     jnp.asarray(obs))
    assert got[0].shape == (7, act_dim) and got[2].shape == (7,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # round trip through the flax tree
    back = convert.actor_critic_from_flax(convert.actor_critic_to_flax(net), device="cpu")
    for a, b in zip(net.parameters(), back.parameters()):
        assert torch.equal(a, b)


def test_init_is_orthogonal_and_seeded():
    """Orthogonal rows or columns at gains sqrt(2), 0.01 and 1, zero biases,
    the same weights from the same seed, and the global RNG untouched."""
    state = torch.random.get_rng_state()
    a = tppo.ActorCritic(27, 1, (64, 64), 0.0, torch.Generator().manual_seed(5), "cpu")
    b = tppo.ActorCritic(27, 1, (64, 64), 0.0, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    for layer, gain in ((a.pi[0], 2 ** 0.5), (a.pi[1], 2 ** 0.5), (a.vf[1], 2 ** 0.5),
                        (a.mean, 0.01), (a.value, 1.0)):
        w = layer.weight.detach().double()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(len(gram)), atol=1e-5)
        assert not layer.bias.detach().any()


def test_gaussian_log_prob_and_gae_equal_jax():
    """1e-6 on seeded float32 data; the GAE data has dones mid-trajectory and at
    its end. The JAX recursion is rl/ppo.py's compute_gae body."""
    rng = np.random.default_rng(1)
    mean, action = (rng.normal(size=(9, 2)).astype(np.float32) for _ in range(2))
    log_std = np.array([-0.3, 0.7], np.float32)
    got = tppo._gaussian_log_prob(*map(torch.as_tensor, (mean, log_std, action)))
    want = jppo._gaussian_log_prob(*map(jnp.asarray, (mean, log_std, action)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    T, E, gamma, lam = 24, 5, 0.99, 0.95
    value, reward = (rng.normal(size=(T, E)).astype(np.float32) for _ in range(2))
    done = rng.random((T, E)) < 0.15
    done[-1, 0] = True
    last = rng.normal(size=E).astype(np.float32)

    def body(carry, inp):
        gae, next_value = carry
        v, r, d = inp
        nonterminal = 1.0 - d.astype(v.dtype)
        delta = r + gamma * next_value * nonterminal - v
        gae = delta + gamma * lam * nonterminal * gae
        return (gae, v), gae

    _, jadv = jax.lax.scan(body, (jnp.zeros_like(last), jnp.asarray(last)),
                           (jnp.asarray(value), jnp.asarray(reward), jnp.asarray(done)),
                           reverse=True)
    adv, ret = tppo.compute_gae(*map(torch.as_tensor, (value, reward, done, last)), gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jadv) + value, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(num_envs=128, n_steps=128),
                                dict(num_envs=4, n_steps=128, minibatch_size=512),
                                dict(num_envs=3, n_steps=5, minibatch_size=5)])
def test_ppo_config_properties_equal_jax(kw):
    t, j = tppo.PPOConfig(**kw), jppo.PPOConfig(**kw)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for name in ("batch_size", "resolved_minibatch_size", "num_minibatches"):
        assert getattr(t, name) == getattr(j, name), name


def test_ppo_config_rejects_a_non_divisor():
    with pytest.raises(ValueError, match="must divide"):
        tppo.PPOConfig(num_envs=4, n_steps=32, minibatch_size=100).num_minibatches


def _train_kw(anchor):
    """ONE_D_RPM Hover, E = 4, 32 steps of a 0.5 s episode (truncation and
    auto-reset occur), det_frac 1 (no noise), one minibatch (the epoch
    permutation only reorders the rows of a mean), 2 epochs."""
    kw = dict(num_envs=4, n_steps=32, minibatch_size=128, n_epochs=2, det_frac=1.0)
    if anchor:
        kw.update(anchor_coef=0.5, target_kl=1e-4, log_std_anneal_to=-1.0,
                  log_std_anneal_updates=4)
    return kw


def _init_pair(anchor):
    """Each package's runner from the same initial params."""
    jcfg, tcfg = _configs(episode_len_sec=0.5)
    tcfg_ppo, jcfg_ppo = tppo.PPOConfig(**_train_kw(anchor)), jppo.PPOConfig(**_train_kw(anchor))
    runner, aux = tppo.ppo_init(tcfg, tcfg_ppo, 0, device="cpu")
    jrunner, jaux = jppo.ppo_init(jcfg, jcfg_ppo, jax.random.key(0))
    jrunner = jrunner.replace(params=_to_jax(runner.params))
    return (tcfg, tcfg_ppo, runner, aux), (jcfg, jcfg_ppo, jrunner, jaux)


@pytest.fixture(scope="module")
def rollout_pair():
    """The rollout both train steps take, the same with and without anchor
    (the same initial params, envs and steps): mean actions through each
    package's batched step, 32 steps; (rewards, dones) of each."""
    (tcfg, _, runner, aux), (jcfg, _, jrunner, jaux) = _init_pair(False)
    roll = []
    for net, step, state, obs in (
            (runner.params, troll.make_batched_step(tcfg, aux["params_env"], aux["ctrl_params"],
                                                    aux["target_pos"]),
             runner.env_state, runner.obs),
            (None, jit_reference(jroll.make_batched_step(jcfg, jaux["params_env"],
                                                         jaux["ctrl_params"],
                                                         jaux["target_pos"])),
             jrunner.env_state, jrunner.obs)):
        rewards, dones = [], []
        for _ in range(32):
            if net is None:
                mean = jppo.ActorCritic(action_dim=1).apply(jrunner.params, obs)[0]
                state, out = step(state, jnp.clip(mean, -1, 1).reshape(4, 1, 1))
            else:
                with torch.no_grad():
                    mean = net(obs)[0]
                state, out = step(state, torch.clamp(mean, -1, 1).reshape(4, 1, 1))
            obs = out.obs
            rewards.append(np.asarray(out.reward))
            dones.append(np.asarray(out.terminated | out.truncated))
        roll.append((np.stack(rewards), np.stack(dones)))
    return roll


def _train_pair(anchor):
    """One train step of each package from the same initial params."""
    (tcfg, tcfg_ppo, runner, aux), (jcfg, jcfg_ppo, jrunner, jaux) = _init_pair(anchor)
    init = {k: v.copy() for k, v in _flax_leaves(jrunner.params).items()}
    args, jargs = (), ()
    if anchor:
        snap = tppo.ActorCritic(27, 1, (64, 64), 0.0, torch.Generator().manual_seed(9), "cpu")
        args, jargs = (snap,), (_to_jax(snap),)
    runner, metrics = tppo.make_ppo_train_step(tcfg, tcfg_ppo, aux, anchor=anchor)(
        runner, *args)
    jrunner, jmetrics = jit_reference(jppo.make_ppo_train_step(jcfg, jcfg_ppo, jaux,
                                                               anchor=anchor))(jrunner, *jargs)
    return runner, metrics, jrunner, jmetrics, init, tcfg_ppo


@pytest.mark.parametrize("anchor", [False, True], ids=["plain", "anchor_kl_anneal"])
def test_train_step_equals_jax(anchor, rollout_pair):
    runner, metrics, jrunner, jmetrics, init, cfg = _train_pair(anchor)
    (rt, dt), (rj, dj) = rollout_pair
    assert dt.any() and not dt.all()  # truncation and auto-reset happened
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=REWARD_ATOL)
    got = _flax_leaves(convert.actor_critic_to_flax(runner.params))
    want = _flax_leaves(jrunner.params)
    assert got.keys() == want.keys()
    moved = max(float(np.abs(want[k] - init[k]).max()) for k in want)
    assert moved > 1e-4  # the update did move the params
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    assert runner.update_count == int(jrunner.update_count) == 1
    if anchor:
        lr = float(jrunner.opt_state[1].hyperparams["learning_rate"])
        assert lr != cfg.learning_rate  # the KL rule acted
        np.testing.assert_allclose(runner.opt_state.param_groups[0]["lr"], lr, rtol=1e-6)
        cap = tppo._log_std_cap(cfg, 0)
        assert cap == -0.25 and float(runner.params.log_std.detach().max()) <= cap


def test_bc_pretrain_clones_the_jax_expert():
    """The DSLPID-in-band expert equals JAX's over 30 steps of two float64 envs
    driven by its own actions plus seeded noise (1e-9); then a tiny
    bc_pretrain halves the fit's MSE and sets log_std."""
    jcfg, tcfg = _configs("RPM", dtype="float64", episode_len_sec=1.0)
    _, aux = tppo.ppo_init(tcfg, tppo.PPOConfig(num_envs=2), 0, device="cpu")
    _, jaux = jppo.ppo_init(jcfg, jppo.PPOConfig(num_envs=2), jax.random.key(0))
    expert, jexpert = tws.dslpid_in_band_expert(tcfg, aux), jws.dslpid_in_band_expert(jcfg, jaux)
    from gym_pybullet_drones_tpu.control.dsl_pid import dsl_pid_reset as jreset
    from gym_pybullet_drones_tpu_torch.control.dsl_pid import dsl_pid_reset as treset

    state = troll.batch_reset(tcfg, aux["params_env"], 2, device="cpu")
    cs = treset((2, 1), dtype=torch.float64, device="cpu")
    jstate = jroll.batch_reset(jcfg, jaux["params_env"], 2)
    jcs = jax.vmap(lambda _: jreset((1,)))(jnp.arange(2))
    jstep = jit_reference(jax.vmap(lambda s, a: jbase.step(jcfg, jaux["params_env"],
                                                     jaux["ctrl_params"], jaux["target_pos"],
                                                     s, a)[0]))
    noise = 0.25 * np.random.default_rng(2).normal(size=(30, 2, 1, 4))
    for t in range(30):
        a, cs = expert(state, cs)
        ja, jcs = jax.vmap(jexpert)(jstate, jcs)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-9)
        act = np.clip(a.numpy() + noise[t], -1, 1)
        state = tbase.step(tcfg, aux["params_env"], aux["ctrl_params"], aux["target_pos"],
                           state, torch.as_tensor(act))[0]
        jstate = jstep(jstate, jnp.asarray(act))

    _, tcfg32 = _configs("RPM", episode_len_sec=1.0)
    runner, aux = tppo.ppo_init(tcfg32, tppo.PPOConfig(num_envs=2), 0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    X, Y = tws._collect(tcfg32, aux, tws.dslpid_in_band_expert(tcfg32, aux), runner.params,
                        4, 0.25, False, torch.Generator().manual_seed(5))
    mse = lambda: float(torch.mean((runner.params(X)[0].detach() - Y) ** 2))
    before = mse()
    runner, gen = tws.bc_pretrain(tcfg32, runner, aux, gen, episodes=4, bc_steps=300,
                                  bc_batch=64, log_std=-1.5, dagger_rounds=1, verbose=False)
    assert mse() < 0.5 * before, (before, mse())
    assert torch.equal(runner.params.log_std.detach(), torch.full((4,), -1.5))


def test_train_loop_and_stochastic_eval():
    """make_ppo_train_loop stacks each metric over its updates and equals as
    many train steps from the same seed; a stochastic evaluation draws from
    its generator and differs from the deterministic one."""
    _, tcfg = _configs(episode_len_sec=0.2)
    ppo_cfg = tppo.PPOConfig(num_envs=2, n_steps=8, minibatch_size=4, n_epochs=1)
    runner, aux = tppo.ppo_init(tcfg, ppo_cfg, 5, device="cpu")
    runner, stacked = tppo.make_ppo_train_loop(tcfg, ppo_cfg, aux, 2)(runner)
    again, aux2 = tppo.ppo_init(tcfg, ppo_cfg, 5, device="cpu")
    step = tppo.make_ppo_train_step(tcfg, ppo_cfg, aux2)
    history = []
    for _ in range(2):
        again, m = step(again)
        history.append(m)
    assert runner.update_count == 2 and stacked["loss"].shape == (2,)
    for k in stacked:
        assert torch.equal(stacked[k], torch.stack([m[k] for m in history])), k
    det = tppo.evaluate_policy(tcfg, aux, runner.params, num_steps=20, num_envs=2)
    noisy = [tppo.evaluate_policy(tcfg, aux, runner.params, num_steps=20, num_envs=2,
                                  deterministic=False,
                                  generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert noisy[0] == noisy[1] != noisy[2] and noisy[0] != det
    assert det[1] == 2 * (20 // 8)  # 0.2 s episodes end at the 8th control step
