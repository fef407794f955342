"""The port's RGB observations (envs/base.py's RGB branch, runtime/rollout.py)
against the JAX package's on the CPU: the capture cadence and the frame ring,
the env step over 12 control steps at frame_stack 1 and 4, and the batched
step with auto-reset over per-env plants carried from JAX's draws.

Both packages step in float32 (the JAX reference with x64 off inside the
test). Frames are held at the render limits of tests/test_torch_render.py:
a frame pixel may differ by more than 1 in a channel on at most 0.1 % of
the pixels (XLA contracts multiply-adds on the CPU, which moves a grazing
plane pixel's checker or a silhouette edge by a last ulp). Kinematics at
1e-5, rewards at 1e-5 (float32 closed loops over 12 to 20 control steps);
dones equal."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core.params import randomize_params as jrandomize
from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu_torch import _struct, convert
from gym_pybullet_drones_tpu_torch.core.params import randomize_params
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec

jroll = importlib.import_module("gym_pybullet_drones_tpu.runtime.rollout")
troll = importlib.import_module("gym_pybullet_drones_tpu_torch.runtime.rollout")

PIXEL_SHARE = 0.001  # frame pixels allowed past 1 in a channel
KIN_ATOL, REWARD_ATOL = 1e-5, 1e-5


def _configs(n=1, frame_stack=4, **kw):
    common = dict(num_drones=n, task="hover" if n == 1 else "multihover", pyb_freq=240,
                  ctrl_freq=30, action_buffer_size=15, frame_stack=frame_stack, **kw)
    return (jbase.AviaryConfig(action_type=jspec.ActionType.ONE_D_RPM,
                               obs_type=jspec.ObservationType.RGB, **common),
            tbase.AviaryConfig(action_type=tspec.ActionType.ONE_D_RPM,
                               obs_type=tspec.ObservationType.RGB, **common))


def _assert_frames_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    gap = np.abs(got.astype(np.int32) - want.astype(np.int32)).reshape(-1, 4).max(-1)
    assert (gap > 1).mean() <= PIXEL_SHARE, f"{int((gap > 1).sum())} of {gap.size} pixels"


def _assert_kin_close(tkin, jkin):
    for k in ("pos", "quat", "vel", "ang_v"):
        np.testing.assert_allclose(getattr(tkin, k).numpy(), np.asarray(getattr(jkin, k)),
                                   rtol=0, atol=KIN_ATOL, err_msg=k)


def test_capture_cadence_and_the_frame_ring():
    """tests/test_render.py:90-125 through the port: at 240 Hz physics and
    30 Hz control the capture period is 10 substeps against 8 a control
    step, so fresh frames come on control steps 0, 5, 10 (pre-increment
    counters 0, 40, 80) and are held in between. With frame_stack 4 each
    capture shifts the ring by one frame: the old newest three are the new
    oldest three. An obs handed out earlier never changes."""
    _, cfg = _configs(frame_stack=4)
    assert cfg.img_capture_freq == 10
    av = tbase.Aviary(cfg, device="cpu")
    state, prev = av.reset()
    assert prev.shape == (1, 48, 64, 16) and prev.dtype == torch.uint8
    for k in range(1, 4):  # the reset capture repeated K times
        assert torch.equal(prev[..., 4 * k:4 * k + 4], prev[..., :4])
    first = prev.clone()
    changes = []
    action = torch.tensor([[0.4]])  # climb: the view changes between captures
    for t in range(12):
        state, obs, *_ = av.step(state, action)
        assert torch.equal(obs, state.rgb_frames)
        changes.append(not torch.equal(obs, prev))
        if t % 5 == 0:
            assert torch.equal(obs[..., :12], prev[..., 4:]), t
        prev = obs
    for t, changed in enumerate(changes):
        if t % 5 != 0:
            assert not changed, f"frame changed on hold step {t}"
    assert changes[5] and changes[10], "no fresh frame on capture steps"
    assert torch.equal(av.reset()[1], first) and not torch.equal(prev, first)


@pytest.mark.parametrize("frame_stack", [1, 4])
def test_env_step_equals_jax(frame_stack):
    """Two drones (MultiHover), 12 control steps of seeded actions through
    each package's env step: frames, kinematics, rewards and the flags."""
    jcfg, tcfg = _configs(n=2, frame_stack=frame_stack)
    rng = np.random.default_rng(1)
    acts = rng.uniform(-1, 1, (12, 2, 1)).astype(np.float32)
    av = tbase.Aviary(tcfg, device="cpu")
    state, obs = av.reset()
    with jax.enable_x64(False):
        jav = jbase.Aviary(jcfg)
        jstate, jobs = jav.reset()
        _assert_frames_close(obs.numpy(), jobs)
        for a in acts:
            jstate, jobs, jr, jterm, jtrunc = jav.step(jstate, jnp.asarray(a))
            state, obs, r, term, trunc = av.step(state, torch.as_tensor(a))
            _assert_frames_close(obs.numpy(), jobs)
            _assert_kin_close(state.kin, jstate.kin)
            np.testing.assert_allclose(float(r), float(jr), rtol=0, atol=REWARD_ATOL)
            assert bool(term) == bool(jterm) and bool(trunc) == bool(jtrunc)
    assert obs.shape == (2, 48, 64, 4 * frame_stack)
    assert int(state.step_count) == 96


def test_batched_step_auto_reset_with_per_env_plants_equals_jax():
    """JAX's randomize_params draws ({"m": 0.1, "kf": 0.05}), carried into the
    port, through both packages' per-env make_batched_step with auto-reset
    (0.5 s episodes: the 17th control step truncates), frame_stack 4, three
    envs, 20 control steps of seeded actions: obs frames, final obs,
    kinematics, rewards and the flags; the frames reset to the nominal
    initial capture while the action buffer persists."""
    jcfg, tcfg = _configs(episode_len_sec=0.5)
    E = 3
    with jax.enable_x64(False):
        jnom = jbase.build_params(jcfg)
        jp = jrandomize(jax.random.key(3), jnom, E, {"m": 0.1, "kf": 0.05})
        tp = convert.drone_params_from_numpy(convert.record_to_numpy(jp), device="cpu")
        jcp, tcp = jbase.build_ctrl_params(jcfg), tbase.build_ctrl_params(tcfg, "cpu")
        jtgt = jbase.hover_target_pos(jcfg, jnom)
        ttgt = tbase.hover_target_pos(tcfg, troll.nominal_params(tp))
        jstep = jax.jit(jroll.make_batched_step(jcfg, jp, jcp, jtgt))
        tstep = troll.make_batched_step(tcfg, tp, tcp, ttgt)
        jstate = jroll.batch_reset(jcfg, jp, E)
        tstate = troll.batch_reset(tcfg, tp, E, device="cpu")
        init = tstate.rgb_frames[0].clone()
        _assert_frames_close(tstate.rgb_frames.numpy(), jstate.rgb_frames)
        acts = np.random.default_rng(4).uniform(-1, 1, (20, E, 1, 1)).astype(np.float32)
        resets = 0
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no per-env loop fallback under vmap
            for a in acts:
                jstate, jout = jstep(jstate, jnp.asarray(a))
                tstate, tout = tstep(tstate, torch.as_tensor(a))
                _assert_frames_close(tout.obs.numpy(), jout.obs)
                _assert_frames_close(tout.final_obs.numpy(), jout.final_obs)
                _assert_kin_close(tstate.kin, jstate.kin)
                np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward),
                                           rtol=0, atol=REWARD_ATOL)
                np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(jout.truncated))
                np.testing.assert_array_equal(tout.terminated.numpy(),
                                              np.asarray(jout.terminated))
                np.testing.assert_allclose(tstate.action_buffer.numpy(),
                                           np.asarray(jstate.action_buffer), atol=1e-7)
                done = tout.truncated | tout.terminated
                if done.any():
                    resets += int(done.sum())
                    assert torch.equal(tout.obs[done], init.expand((int(done.sum()),) + init.shape))
                    assert tstate.action_buffer[done].abs().sum() > 0  # persisted
    assert resets == E
    vz = tstate.kin.vel[:, 0, 2].numpy()
    assert np.ptp(vz) > 1e-3  # the envs stepped different plants


def test_per_env_rgb_step_equals_each_env_alone():
    """The vmapped per-env step renders through the operator's batching rule
    (no per-env loop, no warning) and equals each env stepped alone with its
    own plant, bit for bit, frames included, over 6 control steps."""
    _, cfg = _configs()
    nominal = tbase.build_params(cfg, "cpu")
    p = randomize_params(torch.Generator().manual_seed(0), nominal, 3, {"m": 0.1, "kf": 0.05})
    ctrl, target = tbase.build_ctrl_params(cfg, "cpu"), tbase.hover_target_pos(cfg, nominal)
    a = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (3, 1, 1)),
                        dtype=torch.float32)
    state = troll.batch_reset(cfg, p, 3, device="cpu")
    step = troll.make_batched_step(cfg, p, ctrl, target, auto_reset=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(6):
            state, out = step(state, a)
    assert not caught, [str(w.message) for w in caught]
    for e in range(3):
        pe = p.map(lambda x: x[e])
        alone = troll.batch_reset(cfg, pe, 1, device="cpu")
        step_e = troll.make_batched_step(cfg, pe, ctrl, target, auto_reset=False)
        for _ in range(6):
            alone, out_e = step_e(alone, a[e:e + 1])
        assert torch.equal(alone.rgb_frames[0], state.rgb_frames[e])
        assert torch.equal(out_e.obs[0], out.obs[e])
        assert torch.equal(alone.kin.pos[0], state.kin.pos[e])


def test_struct_where_passes_none_fields_through():
    _, cfg = _configs()
    kin_cfg = tbase.AviaryConfig(num_drones=1, task="hover", action_buffer_size=15)
    params = tbase.build_params(kin_cfg, "cpu")
    a = troll.batch_reset(kin_cfg, params, 2, device="cpu")
    assert a.rgb_frames is None
    mask = torch.tensor([True, False])
    out = _struct.struct_where(mask, a, a.map(lambda t: t + 1))
    assert out.rgb_frames is None and torch.equal(out.kin.pos[0], a.kin.pos[0])
    rgb = troll.batch_reset(cfg, params, 2, device="cpu")
    dark = rgb.replace(rgb_frames=torch.zeros_like(rgb.rgb_frames))
    out = _struct.struct_where(mask, rgb, dark)
    assert torch.equal(out.rgb_frames[0], rgb.rgb_frames[0]) and not out.rgb_frames[1].any()


def test_rgb_frames_follow_the_config():
    """obstacles=False drops the landmarks from the frames, scene "base"
    draws BaseAviary's world, CF2P turns the frame to the plus layout; the
    KIN configs hold no frames."""
    def first_frame(**kw):
        _, cfg = _configs(**kw)
        return tbase.Aviary(cfg, device="cpu").reset()[1]

    rl = first_frame()
    assert not torch.equal(rl, first_frame(obstacles=False))
    assert not torch.equal(rl, first_frame(obstacle_scene="base"))
    assert first_frame(frame_stack=2).shape[-1] == 8
    _, kin = _configs()
    kin_state = tbase.reset(tbase.AviaryConfig(task="hover", action_buffer_size=15),
                            tbase.build_params(kin, "cpu"))
    assert kin_state.rgb_frames is None
