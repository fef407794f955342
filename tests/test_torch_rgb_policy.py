"""The port's pixel policy against the JAX package's on the CPU:
CnnActorCritic on the converted RGB checkpoints against flax's apply on
JAX-rendered frames, the flax round trip, the init, one RGB PPO train step
against JAX's make_ppo_train_step, and the rgb_hover_fs4 checkpoint through
the port's evaluate_policy.

Float32 on both sides (the JAX reference with x64 off inside the test). The
policy outputs at atol 1e-5 plus rtol 1e-6: convolutions sum 1,024 terms in
another order on each side, and value heads reach about 400. The train step
at tests/test_torch_ppo.py's limits (params 1e-5, a thirtieth of one Adam
step)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu.render import camera as jcam
from gym_pybullet_drones_tpu.rl import ppo as jppo
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
POLICY_ATOL, POLICY_RTOL = 1e-5, 1e-6
PARAM_ATOL, METRIC_RTOL = 1e-5, 1e-4
ACTION_ATOL = 1e-4


def _ckpt(name):
    return convert.load_flax_msgpack(os.path.join(CKPT, f"{name}.msgpack"))


def _assert_frames_close(got, want):
    """tests/test_torch_rgb.py's frame limit: at most 0.1 % of the pixels
    past 1 in a channel."""
    gap = np.abs(got.astype(np.int32) - want.astype(np.int32)).reshape(-1, 4).max(-1)
    assert got.shape == want.shape and (gap > 1).mean() <= 0.001, int((gap > 1).sum())


def _configs(n=1, **kw):
    common = dict(num_drones=n, task="hover" if n == 1 else "multihover", pyb_freq=240,
                  ctrl_freq=30, **kw)
    return (jbase.AviaryConfig(action_type=jspec.ActionType.ONE_D_RPM,
                               obs_type=jspec.ObservationType.RGB, **common),
            tbase.AviaryConfig(action_type=tspec.ActionType.ONE_D_RPM,
                               obs_type=tspec.ObservationType.RGB, **common))


def _jax_frames(E, n, seed):
    """(E, n, 48, 64, 16) uint8: four JAX renders an env, at seeded poses
    around the hover point, stacked channel-wise."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-0.6, -0.6, 0.1], [0.6, 0.6, 1.2], (4, E, n, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (4, E, n))
    quat = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], -1).astype(np.float32)
    with jax.enable_x64(False):
        fn = jax.jit(jax.vmap(jax.vmap(lambda p, q: jcam.render_drone_views(
            p, q, jnp.float32(0.0397))[0])))
        frames = np.asarray(fn(jnp.asarray(pos), jnp.asarray(quat)))  # (4, E, n, H, W, 4)
    return np.concatenate(list(frames), axis=-1)


def _flax_apply(tree, obs, n, hidden):
    with jax.enable_x64(False):
        net = jppo.CnnActorCritic(action_dim=n, hidden=hidden)
        return [np.asarray(x) for x in jax.jit(net.apply)(jax.tree.map(jnp.asarray, tree),
                                                          jnp.asarray(obs))]


@pytest.mark.parametrize("name,n,hidden", [("rgb_hover_fs4", 1, (64, 64)),
                                           ("rgb_multihover_fs4", 2, (128, 128))])
def test_cnn_policy_equals_flax_on_jax_frames(name, n, hidden):
    tree = _ckpt(name)
    net = convert.actor_critic_from_flax(tree, device="cpu")
    assert isinstance(net, tppo.CnnActorCritic)
    assert tuple(l.out_features for l in net.heads.pi) == hidden
    obs = _jax_frames(4, n, seed=n)
    with torch.no_grad():
        got = [x.numpy() for x in net(torch.as_tensor(obs))]
    want = _flax_apply(tree, obs, n, hidden)
    assert got[0].shape == (4, n) and got[2].shape == (4,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=POLICY_RTOL, atol=POLICY_ATOL)


def test_cnn_flax_round_trip_and_forward():
    """A freshly initialised CnnActorCritic (2 drones, frame_stack 2) to the
    flax tree and back, leaf for leaf; flax's apply of that tree equals the
    port's forward."""
    net = tppo.CnnActorCritic(2, 8, 2, (32, 32), -0.5, torch.Generator().manual_seed(1), "cpu")
    tree = convert.actor_critic_to_flax(net)
    assert sorted(tree["params"]) == sorted(
        ["Conv_0", "Conv_1", "Conv_2", "log_std"] + [f"Dense_{i}" for i in range(7)])
    assert tree["params"]["Conv_0"]["kernel"].shape == (8, 8, 8, 32)  # HWIO
    back = convert.actor_critic_from_flax(tree, device="cpu")
    for (ka, a), (kb, b) in zip(net.state_dict().items(), back.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    again = convert.actor_critic_to_flax(back)
    for k, layer in tree["params"].items():
        if k == "log_std":
            np.testing.assert_array_equal(again["params"][k], layer)
            continue
        for kk in layer:
            np.testing.assert_array_equal(again["params"][k][kk], layer[kk])
    obs = np.random.default_rng(0).integers(0, 256, (3, 2, 48, 64, 8), dtype=np.uint8)
    with torch.no_grad():
        got = [x.numpy() for x in net(torch.as_tensor(obs))]
    for g, w in zip(got, _flax_apply(tree, obs, 2, (32, 32))):
        np.testing.assert_allclose(g, w, rtol=POLICY_RTOL, atol=POLICY_ATOL)


def test_cnn_init_is_flax_default_and_seeded():
    """Convolutions and the 512 layer: flax's lecun normal (truncated at two
    of its std, variance 1 / fan_in: sample std within 3 %), zero biases;
    heads orthogonal as ActorCritic's; the same from the same seed; the
    global RNG untouched."""
    state = torch.random.get_rng_state()
    a = tppo.CnnActorCritic(1, 16, 1, generator=torch.Generator().manual_seed(5), device="cpu")
    b = tppo.CnnActorCritic(1, 16, 1, generator=torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    for layer, fan_in in ((a.convs[0], 16 * 64), (a.convs[1], 32 * 16), (a.convs[2], 64 * 9),
                          (a.feat, 512)):
        w = layer.weight.detach().double()
        std = (1.0 / fan_in) ** 0.5
        assert float(w.abs().max()) <= 2 * std / tppo._TRUNC_STD
        assert abs(float(w.std()) / std - 1.0) < 0.03, (fan_in, float(w.std()))
        assert not layer.bias.detach().any()
    for layer, gain in ((a.heads.pi[0], 2 ** 0.5), (a.heads.mean, 0.01), (a.heads.value, 1.0)):
        w = layer.weight.detach().double()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(len(gram)), atol=1e-5)
    assert a.convs[2].weight.shape == (64, 64, 3, 3) and a.feat.in_features == 512


def test_rgb_train_step_equals_jax():
    """One RGB train step of each package from the same initial params:
    tests/test_rollout.py:165-180's config (Hover, ONE_D_RPM, no action
    buffer) with 0.5 s episodes, E = 2, n_steps 4, det_frac 1 (no noise),
    one minibatch, one epoch; the rollout keeps uint8 obs."""
    jcfg, tcfg = _configs(action_buffer_size=0, episode_len_sec=0.5)
    kw = dict(num_envs=2, n_steps=4, n_epochs=1, minibatch_size=8, det_frac=1.0)
    tcfg_ppo, jcfg_ppo = tppo.PPOConfig(**kw), jppo.PPOConfig(**kw)
    runner, aux = tppo.ppo_init(tcfg, tcfg_ppo, 0, device="cpu")
    assert isinstance(runner.params, tppo.CnnActorCritic)
    assert runner.obs.shape == (2, 1, 48, 64, 4) and runner.obs.dtype == torch.uint8
    tree = convert.actor_critic_to_flax(runner.params)
    train = tppo.make_ppo_train_step(tcfg, tcfg_ppo, aux)
    runner, rollout = train.collect(runner)
    assert rollout[0].obs.dtype == torch.uint8 and rollout[0].obs.shape == (8, 1, 48, 64, 4)
    runner, metrics = train.update(runner, rollout)
    with jax.enable_x64(False):
        jrunner, jaux = jppo.ppo_init(jcfg, jcfg_ppo, jax.random.key(0))
        jrunner = jrunner.replace(params=jax.tree.map(jnp.asarray, tree))
        jrunner, jmetrics = jax.jit(jppo.make_ppo_train_step(jcfg, jcfg_ppo, jaux))(jrunner)
        want = jax.tree.map(np.asarray, jrunner.params)
    got = convert.actor_critic_to_flax(runner.params)
    moved = 0.0
    for k, layer in want["params"].items():
        pairs = [(got["params"][k], layer)] if k == "log_std" else [
            (got["params"][k][kk], layer[kk]) for kk in layer]
        for g, w in pairs:
            np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL, err_msg=k)
    for k, layer in tree["params"].items():
        if k != "log_std":
            moved = max(moved, max(float(np.abs(want["params"][k][kk] - layer[kk]).max())
                                   for kk in layer))
    assert moved > 1e-4  # the update moved the params
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)


def test_rgb_hover_checkpoint_through_the_port():
    """rgb_hover_fs4 (tests/test_checkpoints.py:48) over its first 30
    deterministic control steps, each package in its own closed loop: the
    port's frames equal JAX's at the pixel limit of tests/test_torch_rgb.py;
    the port's policy on JAX's frames gives JAX's action within 1e-4; and on
    every step whose two frame stacks are equal bit for bit, the two closed
    loops' actions agree within 1e-4. (The float32 loops part by about 3e-7 m
    by step 26, XLA contracting multiply-adds; a capture there moves two of
    12,288 pixels, and the policy's action by about 2e-3.) Then
    evaluate_policy over 260 control steps (one full episode) reaches JAX's
    gate, >= 472.0."""
    jcfg, tcfg = _configs(action_buffer_size=15, episode_len_sec=8.0, frame_stack=4)
    tree = _ckpt("rgb_hover_fs4")
    net = convert.actor_critic_from_flax(tree, device="cpu")
    av = tbase.Aviary(tcfg, device="cpu")
    state, obs = av.reset()
    equal_steps = 0
    with jax.enable_x64(False):
        jav = jbase.Aviary(jcfg)
        jstate, jobs = jav.reset()
        policy = jax.jit(lambda o: jppo.CnnActorCritic(action_dim=1).apply(
            jax.tree.map(jnp.asarray, tree), o[None])[0])
        for t in range(30):
            jframes = np.array(jobs)
            _assert_frames_close(obs.numpy(), jframes)
            with torch.no_grad():
                act = torch.clamp(net(obs[None])[0], -1.0, 1.0).reshape(1, 1)
                on_jax = net(torch.as_tensor(jframes)[None])[0]
            jact = jnp.clip(policy(jobs), -1.0, 1.0).reshape(1, 1)
            np.testing.assert_allclose(np.clip(on_jax.numpy(), -1, 1).reshape(1, 1),
                                       np.asarray(jact), rtol=0, atol=ACTION_ATOL,
                                       err_msg=f"step {t}")
            if np.array_equal(obs.numpy(), jframes):
                equal_steps += 1
                np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=0,
                                           atol=ACTION_ATOL, err_msg=f"step {t}")
            state, obs, *_ = av.step(state, act)
            jstate, jobs, *_ = jav.step(jstate, jact)
    assert equal_steps >= 20, equal_steps
    _, aux = tppo.ppo_init(tcfg, tppo.PPOConfig(num_envs=1), 0, device="cpu")
    ret, episodes = tppo.evaluate_policy(tcfg, aux, net, num_steps=260, num_envs=1)
    assert episodes >= 1
    assert ret >= 472.0, ret
