"""The port's env step, batched step and rollout helpers against the JAX package
in float64, and the velocity_pyb / hover_learn_pyb / multihover_pyb goldens
through the port."""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from gym_pybullet_drones_tpu_torch.runtime import rollout as troll
from torch_parity import jit_reference

# The JAX runtime package re-exports a function named `rollout` over its module.
jroll = importlib.import_module("gym_pybullet_drones_tpu.runtime.rollout")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F64 = torch.float64

# (task, action type, drones, ctrl_freq, action buffer): every task, and every
# action type through the RL pipelines.
CASES = [
    ("ctrl", "RPM", 2, 48, 0),
    ("velocity", "VEL", 2, 48, 0),
    *[("hover", a, 1, 30, 15) for a in ("RPM", "PID", "ONE_D_RPM")],
    *[("multihover", a, 2, 30, 15) for a in ("VEL", "ONE_D_PID")],
]


def _configs(task, action, n, ctrl_freq, buf, **kw):
    common = dict(num_drones=n, pyb_freq=240, ctrl_freq=ctrl_freq, task=task,
                  action_buffer_size=buf, dtype="float64", **kw)
    jcfg = jbase.AviaryConfig(action_type=jspec.ActionType[action],
                              physics=jspec.Physics.PYB, **common)
    tcfg = tbase.AviaryConfig(action_type=tspec.ActionType[action],
                              physics=tspec.Physics.PYB, **common)
    return jcfg, tcfg


def _actions(rng, cfg, steps, batch=()):
    shape = (steps,) + batch + (cfg.num_drones, cfg.action_dim)
    if cfg.task == "ctrl":
        return rng.uniform(14000, 15000, shape)
    if cfg.action_type == jspec.ActionType.PID and cfg.task != "velocity":
        return rng.uniform(-0.5, 0.5, shape) + np.array([0.0, 0.0, 0.5])
    a = rng.uniform(-1, 1, shape)
    if cfg.action_dim == 4:
        a[..., 3] = np.abs(a[..., 3])
    return a


def _bundle(jcfg, tcfg):
    jp, jcp = jbase.build_params(jcfg), jbase.build_ctrl_params(jcfg)
    tp, tcp = tbase.build_params(tcfg, "cpu"), tbase.build_ctrl_params(tcfg, "cpu")
    if jcfg.task in (jbase.TASK_HOVER, jbase.TASK_MULTIHOVER):
        jtgt, ttgt = jbase.hover_target_pos(jcfg, jp), tbase.hover_target_pos(tcfg, tp)
    else:
        jtgt = jnp.zeros((jcfg.num_drones, 3))
        ttgt = torch.zeros((tcfg.num_drones, 3), dtype=F64)
    return (jp, jcp, jtgt), (tp, tcp, ttgt)


def _assert_state_close(tstate, jstate, atol, equal_nan=False):
    """Every leaf at ``atol``, plus 1e-12 relative: RPMs are ~1e4, where one
    float64 ulp is ~2e-12 and the attitude loop's gains amplify last-ulp
    differences in the rotation error."""
    got, want = convert.aviary_state_to_numpy(tstate), convert.aviary_state_to_numpy(jstate)
    for k in convert.AVIARY_STATE_FIELDS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=atol, err_msg=k,
                                   equal_nan=equal_nan)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_env_step_matches_jax(case):
    """Per-step parity over 12 control steps (<= 0.4 s of sim), every state
    leaf, obs, reward and flags, in float64 at 1e-10 (plus 1e-12 relative)."""
    jcfg, tcfg = _configs(*case)
    (jp, jcp, jtgt), (tp, tcp, ttgt) = _bundle(jcfg, tcfg)
    jstate, tstate = jbase.reset(jcfg, jp), tbase.reset(tcfg, tp)
    _assert_state_close(tstate, jstate, 0)
    jstep = jit_reference(lambda s, a: jbase.step(jcfg, jp, jcp, jtgt, s, a))
    acts = _actions(np.random.RandomState(6), jcfg, 12)
    for a in acts:
        jstate, jobs, jr, jte, jtr = jstep(jstate, jnp.asarray(a))
        tstate, tobs, tr, tte, ttr = tbase.step(tcfg, tp, tcp, ttgt, tstate, torch.as_tensor(a))
        _assert_state_close(tstate, jstate, 1e-10)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-10)
        assert tte.shape == jte.shape and bool(tte) == bool(jte)
        assert ttr.shape == jtr.shape and bool(ttr) == bool(jtr)


def test_preprocessed_rpm_hook_matches_jax():
    jcfg, tcfg = _configs("hover", "ONE_D_RPM", 1, 30, 15)
    (jp, jcp, jtgt), (tp, tcp, ttgt) = _bundle(jcfg, tcfg)
    rpm = np.full((1, 4), 15000.0)
    want = jit_reference(lambda s, r: jbase.step(jcfg, jp, jcp, jtgt, s, jnp.zeros((1, 2, 3)),
                                           preprocessed_rpm=r))(
        jbase.reset(jcfg, jp), jnp.asarray(rpm))
    got = tbase.step(tcfg, tp, tcp, ttgt, tbase.reset(tcfg, tp), torch.zeros((1, 2, 3)),
                     preprocessed_rpm=torch.as_tensor(rpm))
    _assert_state_close(got[0], want[0], 1e-12)
    with pytest.raises(ValueError):
        tbase.step(tcfg, tp, tcp, ttgt, tbase.reset(tcfg, tp), torch.zeros((1, 2, 3)))


@pytest.mark.parametrize("task", ["hover", "multihover"])
def test_truncation_uses_the_pre_increment_count(task):
    """The 242-step rule: compute_truncated reads step_count less one control
    period (BaseAviary.py:376-382), at every count around the 8 s limit."""
    n = 1 if task == "hover" else 2
    jcfg, tcfg = _configs(task, "ONE_D_RPM", n, 30, 15)
    (jp, _, _), (tp, _, _) = _bundle(jcfg, tcfg)
    flat = convert.aviary_state_to_numpy(jbase.reset(jcfg, jp))
    for count in range(8 * 238, 8 * 246, 8):
        flat["step_count"] = np.int32(count)
        jstate = jbase.reset(jcfg, jp).replace(step_count=jnp.int32(count))
        tstate = convert.aviary_state_from_numpy(flat, device="cpu", dtype=F64)
        want = bool(jbase.compute_truncated(jcfg, jstate))
        assert bool(tbase.compute_truncated(tcfg, tstate)) == want
        assert want == ((count - 8) / 240 > 8.0)


def test_adjacency_matrix_matches_jax():
    rng = np.random.RandomState(7)
    pos = rng.uniform(-1, 1, (2, 5, 3))
    for radius in (0.5, 1.0, float("inf")):
        want = np.asarray(jbase.adjacency_matrix(jnp.asarray(pos), radius))
        got = tbase.adjacency_matrix(torch.as_tensor(pos), radius).numpy()
        np.testing.assert_array_equal(got, want)


def test_rgb_and_contact_configs_name_their_slice():
    """RGB (ROADMAP item 17) builds and steps: MultiHover, two drones,
    frame_stack 2, five control steps through the Aviary bundle, held
    frames of the reference's shape on capture steps and the kinematics of
    the KIN config bit for bit (the camera reads the state, never writes
    it). The impulse contact mode steps tests/test_contact.py:226-241's
    config (two drones, MultiHover, ONE_D_RPM, collisions, the RL
    landmarks) through the Aviary bundle, 20 control steps of -0.9, against
    the JAX package at 1e-10: finite, and the grounded drones held on the
    plane."""
    rgb_cfg = tbase.AviaryConfig(num_drones=2, task="multihover", pyb_freq=240, ctrl_freq=30,
                                 action_type=tspec.ActionType.ONE_D_RPM, action_buffer_size=15,
                                 obs_type=tspec.ObservationType.RGB, frame_stack=2)
    kin_cfg = dataclasses.replace(rgb_cfg, obs_type=tspec.ObservationType.KIN)
    rgb, kin = tbase.Aviary(rgb_cfg, device="cpu"), tbase.Aviary(kin_cfg, device="cpu")
    (s_rgb, obs), (s_kin, _) = rgb.reset(), kin.reset()
    assert obs.shape == (2, 48, 64, 8) and obs.dtype == torch.uint8 and s_kin.rgb_frames is None
    for _ in range(5):
        a = torch.full((2, 1), 0.3)
        s_rgb, obs, r_rgb, *_ = rgb.step(s_rgb, a)
        s_kin, _, r_kin, *_ = kin.step(s_kin, a)
        assert torch.equal(obs, s_rgb.rgb_frames) and bool((obs[..., 3] == 255).all())
        assert torch.equal(s_rgb.kin.pos, s_kin.kin.pos) and torch.equal(r_rgb, r_kin)
    jcfg, tcfg = _configs("multihover", "ONE_D_RPM", 2, 30, 15, collisions=True,
                          contact_mode="impulse")
    jav, av = jbase.Aviary(jcfg), tbase.Aviary(tcfg, device="cpu")
    jstate, _ = jav.reset()
    state, obs = av.reset()
    jstep = jit_reference(jav.step_fn)
    action = -0.9 * np.ones((2, 1))
    for _ in range(20):
        jstate, jobs, *_ = jstep(jstate, jnp.asarray(action))
        state, obs, *_ = av.step(state, torch.as_tensor(action))
        _assert_state_close(state, jstate, 1e-10)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-12, atol=1e-10)
    assert bool(torch.isfinite(obs).all())
    z = state.kin.pos[:, 2].numpy()
    assert np.all(z > 0.005) and np.all(z < 0.2)


def test_aviary_bundle_steps_on_the_cpu():
    cfg = tbase.AviaryConfig(task="hover", action_type=tspec.ActionType.RPM,
                             ctrl_freq=30, action_buffer_size=15)
    av = tbase.Aviary(cfg, device="cpu")
    state, obs = av.reset()
    assert obs.shape == (1, 12 + 15 * 4) and obs.dtype == torch.float32
    state, obs, r, te, tr = av.step(state, torch.zeros((1, 4)))
    assert obs.shape == (1, 72) and r.shape == () and int(state.step_count) == 8


def _batched_case():
    jcfg, tcfg = _configs("hover", "ONE_D_RPM", 1, 30, 15)
    (jp, jcp, jtgt), (tp, tcp, ttgt) = _bundle(jcfg, tcfg)
    E = 8
    flat = convert.aviary_state_to_numpy(jroll.batch_reset(jcfg, jp, E))
    # env 2 one step from its time limit, env 5 already diverged
    flat["step_count"][2] = 8 * 242
    flat["pos"][5, 0, 0] = np.nan
    jstate = jroll.batch_reset(jcfg, jp, E).replace(step_count=jnp.asarray(flat["step_count"]))
    jstate = jstate.replace(kin=jstate.kin.replace(pos=jnp.asarray(flat["pos"])))
    tstate = convert.aviary_state_from_numpy(flat, device="cpu", dtype=F64)
    return (jcfg, jp, jcp, jtgt, jstate), (tcfg, tp, tcp, ttgt, tstate), E


@pytest.mark.parametrize("auto_reset", [True, False])
def test_make_batched_step_matches_jax(auto_reset):
    """E = 8 with one env at its time limit and one non-finite env: auto-reset,
    the NaN mask, final_obs and the persisted action buffer."""
    (jcfg, jp, jcp, jtgt, js), (tcfg, tp, tcp, ttgt, ts), E = _batched_case()
    jstep = jit_reference(jroll.make_batched_step(jcfg, jp, jcp, jtgt, auto_reset=auto_reset))
    tstep = troll.make_batched_step(tcfg, tp, tcp, ttgt, auto_reset=auto_reset)
    acts = np.random.RandomState(8).uniform(-1, 1, (4, E, 1, 1))
    for t, a in enumerate(acts):
        js, jo = jstep(js, jnp.asarray(a))
        ts, to = tstep(ts, torch.as_tensor(a))
        _assert_state_close(ts, js, 1e-10, equal_nan=True)
        for name in ("obs", "reward", "final_obs"):
            np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                       rtol=0, atol=1e-10, equal_nan=True, err_msg=name)
        for name in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)))
        if t == 0:
            assert bool(to.terminated[5]) and bool(to.truncated[2])
    assert bool(troll.env_health(ts).all())


def test_batch_reset_gives_distinct_buffers():
    cfg = tbase.AviaryConfig(task="velocity", ctrl_freq=48, action_type=tspec.ActionType.VEL)
    p = tbase.build_params(cfg, "cpu")
    s = troll.batch_reset(cfg, p, 4, device="cpu")
    assert s.kin.pos.shape == (4, 1, 3) and s.step_count.shape == (4,)
    s.kin.pos[0, 0, 0] = 5.0
    assert float(s.kin.pos[1, 0, 0]) == 0.0
    assert s.kin.pos.data_ptr() != s.kin.vel.data_ptr()


def test_rollout_and_episode_returns_match_jax():
    """``rollout`` runs policy -> batched step and stacks the signals along
    time; ``episode_stats`` / ``episode_returns`` match the JAX scans."""
    _, tcfg = _configs("hover", "ONE_D_RPM", 1, 30, 15)
    tp, tcp = tbase.build_params(tcfg, "cpu"), tbase.build_ctrl_params(tcfg, "cpu")
    ttgt = tbase.hover_target_pos(tcfg, tp)
    E, T = 4, 10
    act = torch.linspace(-1.0, 1.0, E, dtype=F64).reshape(E, 1, 1)
    step = troll.make_batched_step(tcfg, tp, tcp, ttgt)
    s0 = troll.batch_reset(tcfg, tp, E, device="cpu")
    (state, pstate, obs), out = troll.rollout(
        step, lambda ps, o, gen: (act, ps + 1), s0, 0, tbase.compute_obs(tcfg, s0), T)
    assert pstate == T and out.obs.shape == (T, E, 1, 27) and out.reward.shape == (T, E)
    s, rewards = s0, []
    for _ in range(T):
        s, o = step(s, act)
        rewards.append(o.reward)
    assert torch.equal(out.reward, torch.stack(rewards)) and torch.equal(obs, o.obs)
    _assert_state_close(state, s, 0)

    rng = np.random.RandomState(9)
    rewards, dones = rng.uniform(0, 1, (30, E)), rng.uniform(0, 1, (30, E)) < 0.2
    jo = jroll.StepOutput(obs=None, reward=jnp.asarray(rewards), terminated=jnp.asarray(dones),
                          truncated=jnp.zeros_like(jnp.asarray(dones)))
    to = troll.StepOutput(obs=None, reward=torch.as_tensor(rewards),
                          terminated=torch.as_tensor(dones),
                          truncated=torch.zeros((30, E), dtype=torch.bool))
    for g, w in zip(troll.episode_returns(to), jroll.episode_returns(jo)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)
    for g, w in zip(troll.episode_stats(to.reward, to.terminated),
                    jroll.episode_stats(jo.reward, jo.terminated)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)


def _replay_velocity_golden():
    g = np.load(os.path.join(GOLDEN, "velocity_pyb.npz"))
    n = 4
    cfg = tbase.AviaryConfig(num_drones=n, physics=tspec.Physics.PYB, pyb_freq=240,
                             ctrl_freq=48, task=tbase.TASK_VELOCITY,
                             action_type=tspec.ActionType.VEL, dtype="float64",
                             initial_xyzs=tuple(map(tuple, g["init_xyzs"])))
    p, cp = tbase.build_params(cfg, "cpu"), tbase.build_ctrl_params(cfg, "cpu")
    state = tbase.reset(cfg, p)
    tgt = torch.zeros((n, 3), dtype=F64)
    out = np.zeros((g["obs"].shape[0], n, 20))
    for t in range(out.shape[0]):
        state, obs, *_ = tbase.step(cfg, p, cp, tgt, state, torch.as_tensor(g["action"][t]))
        out[t] = obs.numpy()
    return out, g


def test_velocity_golden_through_port():
    """tests/test_golden_pyb.py:251-255: obs[:24] at 1e-10, obs[:48] at 1e-6,
    positions over the 4 s flight inside 5e-2."""
    obs, g = _replay_velocity_golden()
    np.testing.assert_allclose(obs[:24, :, 0:16], g["obs"][:24, :, 0:16], atol=1e-10)
    np.testing.assert_allclose(obs[:48, :, 0:16], g["obs"][:48, :, 0:16], atol=1e-6)
    assert np.abs(obs[..., 0:3] - g["obs"][..., 0:3]).max() < 5e-2


def _replay_rl_golden(golden, task, n, init):
    """tests/test_golden_pyb.py:97-121: the learn config (PYB, 240/30 Hz,
    ONE_D_RPM, buffer 15) through the env step, float64."""
    g = np.load(os.path.join(GOLDEN, golden))
    cfg = tbase.AviaryConfig(num_drones=n, physics=tspec.Physics.PYB, pyb_freq=240,
                             ctrl_freq=30, task=task, action_type=tspec.ActionType.ONE_D_RPM,
                             action_buffer_size=15, dtype="float64", initial_xyzs=init)
    p, cp = tbase.build_params(cfg, "cpu"), tbase.build_ctrl_params(cfg, "cpu")
    tgt = tbase.hover_target_pos(cfg, p)
    state = tbase.reset(cfg, p)
    steps = g["pos"].shape[0]
    pos, reward = np.zeros_like(g["pos"]), np.zeros(steps)
    term, trunc = np.zeros(steps, bool), np.zeros(steps, bool)
    for t in range(steps):
        state, _, r, te, tr = tbase.step(cfg, p, cp, tgt, state, torch.as_tensor(g["action"][t]))
        pos[t], reward[t], term[t], trunc[t] = state.kin.pos.numpy(), float(r), bool(te), bool(tr)
    np.testing.assert_allclose(pos, g["pos"], atol=1e-9)
    np.testing.assert_allclose(reward, g["reward"], atol=1e-9)
    np.testing.assert_array_equal(term, g["terminated"])
    np.testing.assert_array_equal(trunc, g["truncated"])


def test_hover_learn_golden_through_port():
    """tests/test_golden_pyb.py:180-191: the whole 8.2 s open-loop flight at
    1e-9, and the terminated/truncated streams exactly."""
    _replay_rl_golden("hover_learn_pyb.npz", tbase.TASK_HOVER, 1, ((0.0, 0.0, 0.025 / 2 + 0.1),))


def test_multihover_golden_through_port():
    """tests/test_golden_pyb.py:203-212: two drones of MultiHover, the
    whole flight at 1e-9, the signals exactly."""
    arm, z0 = 0.0397, 0.025 / 2 + 0.1
    _replay_rl_golden("multihover_pyb.npz", tbase.TASK_MULTIHOVER, 2,
                      ((0.0, 0.0, z0), (4 * arm, 4 * arm, z0)))