"""The committed checkpoints (checkpoints/*.msgpack) through the port: its own
msgpack decoder against flax's, the policy forward against JAX's on every
KIN and RGB checkpoint, the reference's ONE_D_RPM threshold over the full
protocol, and the impulse-contact checkpoints' evaluation against JAX's over
1 s."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu.rl import ppo as jppo
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
ALL = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CKPT, "*.msgpack")))
# The KIN checkpoints: (name, action type, drones, contact), the configs of
# tests/test_checkpoints.py.
KIN = [
    ("one_d_rpm_hover", "ONE_D_RPM", 1, False),
    ("one_d_rpm_multihover", "ONE_D_RPM", 2, False),
    ("one_d_rpm_hover_contact", "ONE_D_RPM", 1, True),
    ("one_d_rpm_multihover_contact", "ONE_D_RPM", 2, True),
    ("rpm4_hover", "RPM", 1, False),
    ("rpm4_multihover", "RPM", 2, False),
    ("rpm4_hover_contact", "RPM", 1, True),
    ("pid_hover", "PID", 1, False),
    ("pid_multihover", "PID", 2, False),
    ("vel_hover", "VEL", 1, False),
    ("vel_multihover", "VEL", 2, False),
    ("one_d_pid_hover", "ONE_D_PID", 1, False),
    ("one_d_pid_multihover", "ONE_D_PID", 2, False),
]


def _configs(action, n, contact):
    common = dict(num_drones=n, task="hover" if n == 1 else "multihover", pyb_freq=240,
                  ctrl_freq=30, action_buffer_size=15, episode_len_sec=8.0)
    if contact:
        common.update(collisions=True, contact_mode="impulse")
    return (jbase.AviaryConfig(action_type=jspec.ActionType[action], **common),
            tbase.AviaryConfig(action_type=tspec.ActionType[action], **common))


def _read(name):
    with open(os.path.join(CKPT, name), "rb") as fh:
        return fh.read()


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_every_checkpoint_is_here():
    assert len(ALL) == 18 and {f"{k[0]}.msgpack" for k in KIN} <= set(ALL)


@pytest.mark.parametrize("name", ALL)
def test_load_flax_msgpack_equals_flax(name):
    """Leaf for leaf, dtype and shape, every checkpoint (the RGB ones too)."""
    got = convert.load_flax_msgpack(os.path.join(CKPT, name))
    _assert_same_tree(got, serialization.msgpack_restore(_read(name)))


@pytest.mark.parametrize("name,action,n,contact", KIN, ids=[k[0] for k in KIN])
def test_policy_forward_equals_jax(name, action, n, contact):
    """The converted policy on 16 seeded obs against flax's apply of the
    same tree (atol 1e-5 plus rtol 1e-6, a few float32 ulps: 256-wide layers
    on obs of unit scale, values up to about 200)."""
    _, tcfg = _configs(action, n, contact)
    tree = convert.load_flax_msgpack(os.path.join(CKPT, f"{name}.msgpack"))
    net = convert.actor_critic_from_flax(tree, device="cpu")
    hidden = tuple(l.out_features for l in net.pi)
    assert net.pi[0].in_features == n * tcfg.obs_dim
    assert net.mean.out_features == n * tcfg.action_dim
    obs = np.random.default_rng(0).normal(size=(16, n * tcfg.obs_dim)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.as_tensor(obs))
    want = jppo.ActorCritic(action_dim=n * tcfg.action_dim, hidden=hidden).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)


# The RGB checkpoints: (name, drones, hidden), tests/test_checkpoints.py's
# configs (frame_stack 4).
RGB = [("rgb_hover_fs4", 1, 64), ("rgb_multihover_fs4", 2, 128),
       ("rgb_hover_distilled", 1, 64), ("rgb_multihover_distilled", 2, 128),
       ("rgb_hover_scratch_ppo436", 1, 64)]


def test_rgb_checkpoint_names_its_item():
    """The five RGB checkpoints convert to CnnActorCritic (item 17): the
    drones, the frame stack and the head widths from the shapes, the flax
    tree back leaf for leaf, and the forward on 4 seeded uint8 frame stacks
    equal to flax's apply (float32; atol 1e-5 plus rtol 1e-6, the limits of
    test_policy_forward_equals_jax)."""
    assert {f"{r[0]}.msgpack" for r in RGB} == {n for n in ALL if n.startswith("rgb_")}
    rng = np.random.default_rng(0)
    for name, n, width in RGB:
        tree = convert.load_flax_msgpack(os.path.join(CKPT, f"{name}.msgpack"))
        net = convert.actor_critic_from_flax(tree, device="cpu")
        assert isinstance(net, tppo.CnnActorCritic), name
        assert net.convs[0].in_channels == 16 and net.heads.mean.out_features == n
        assert tuple(l.out_features for l in net.heads.pi) == (width, width)
        _assert_same_tree(convert.actor_critic_to_flax(net), tree)
        obs = rng.integers(0, 256, (4, n, 48, 64, 16), dtype=np.uint8)
        with torch.no_grad():
            got = net(torch.as_tensor(obs))
        with jax.enable_x64(False):
            want = jppo.CnnActorCritic(action_dim=n, hidden=(width, width)).apply(
                jax.tree.map(jnp.asarray, tree), jnp.asarray(obs))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-5,
                                       err_msg=name)


def test_one_d_rpm_checkpoint_solves_reference_threshold():
    """tests/test_checkpoints.py's gate through the port: >= 474 (the
    reference's learn.py:79 threshold) over 2,600 deterministic steps on one
    env, 10 consecutive episodes."""
    _, tcfg = _configs("ONE_D_RPM", 1, False)
    net = convert.actor_critic_from_flax(
        convert.load_flax_msgpack(os.path.join(CKPT, "one_d_rpm_hover.msgpack")), device="cpu")
    _, aux = tppo.ppo_init(tcfg, tppo.PPOConfig(num_envs=1), 0, device="cpu")
    ret, n = tppo.evaluate_policy(tcfg, aux, net, num_steps=2600, num_envs=1)
    assert n >= 10
    assert ret >= 474.0, ret


@pytest.mark.parametrize("name,action,n", [(k[0], k[1], k[2]) for k in KIN if k[3]],
                         ids=[k[0] for k in KIN if k[3]])
def test_contact_checkpoint_eval_equals_jax_over_a_second(name, action, n):
    """The impulse-contact checkpoints over 30 control steps (1 s, float32):
    the port's deterministic rollout against JAX's, state by state (1e-4 m,
    1e-3 m/s: the float32 closed loop over 1 s) and reward by reward."""
    jcfg, tcfg = _configs(action, n, True)
    tree = convert.load_flax_msgpack(os.path.join(CKPT, f"{name}.msgpack"))
    net = convert.actor_critic_from_flax(tree, device="cpu")
    _, aux = tppo.ppo_init(tcfg, tppo.PPOConfig(num_envs=1), 0, device="cpu")
    _, jaux = jppo.ppo_init(jcfg, jppo.PPOConfig(num_envs=1), jax.random.key(0))
    jparams = jax.tree.map(jnp.asarray, tree)
    states, rewards = tppo.deterministic_rollout(tcfg, aux, net, 30)
    jstates, jrewards = jppo.deterministic_rollout(jcfg, jaux, jparams, 30)
    assert states.shape == jstates.shape == (30, n, 20)
    np.testing.assert_allclose(states[..., 0:3].numpy(), np.asarray(jstates)[..., 0:3],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(states[..., 10:13].numpy(), np.asarray(jstates)[..., 10:13],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jrewards), rtol=0, atol=1e-4)


def test_episode_stats_equal_jax():
    """evaluate_policy's statistics on seeded (T, E) data, with completed
    episodes and with none (the running-mean fallback)."""
    rng = np.random.default_rng(3)
    rewards = rng.uniform(0, 2, (40, 3)).astype(np.float32)
    for dones in (rng.random((40, 3)) < 0.1, np.zeros((40, 3), bool)):
        got = tppo._episode_stats(torch.as_tensor(rewards), torch.as_tensor(dones))
        want = jppo._episode_stats(jnp.asarray(rewards), jnp.asarray(dones))
        assert int(got[1]) == int(want[1])
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
