"""Domain randomization in the port (core.params.randomize_params and the
per-env make_batched_step): the properties tests/test_domain_rand.py pins on
the JAX package, checked on the port's own draws; JAX's draws fed into the
port's per-env step against JAX's; a PPO train step over randomized plants;
and the impulse solver's rewrite for torch.func.vmap, which leaves the
nominal path bit for bit what it was."""

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
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.core import contact as tcontact
from gym_pybullet_drones_tpu_torch.core.params import RANDOMIZABLE, drone_params, randomize_params
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo
from torch_parity import jit_reference

jroll = importlib.import_module("gym_pybullet_drones_tpu.runtime.rollout")
troll = importlib.import_module("gym_pybullet_drones_tpu_torch.runtime.rollout")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _hover(action="ONE_D_RPM", n=1, **kw):
    return tbase.AviaryConfig(num_drones=n, task="hover" if n == 1 else "multihover",
                              action_type=tspec.ActionType[action], pyb_freq=240, ctrl_freq=30,
                              action_buffer_size=15, **kw)


def _env(cfg, spec, E, seed):
    nominal = tbase.build_params(cfg, "cpu")
    p = randomize_params(_gen(seed), nominal, E, spec)
    return nominal, p, tbase.build_ctrl_params(cfg, "cpu")


def test_randomize_params_shapes_and_nominal_software_constants():
    """Every plant field spreads over (E,); the software constants stay the
    nominal tiles; J_inv tracks J per env; the draws stay inside the band."""
    nominal = drone_params(tspec.DroneModel.CF2X, device="cpu")
    E = 16
    p = randomize_params(_gen(0), nominal, E, {k: 0.15 for k in RANDOMIZABLE})
    assert troll.params_are_batched(p) and not troll.params_are_batched(nominal)
    assert p.m.shape == (E,) and p.J.shape == (E, 3, 3) and p.drag_coeff.shape == (E, 3)
    assert float(p.m.std()) > 0
    for field in ("arm", "hover_rpm", "max_rpm", "max_thrust", "max_xy_torque", "max_z_torque",
                  "gravity", "gnd_eff_h_clip"):
        assert torch.equal(getattr(p, field), getattr(nominal, field).expand(E)), field
    assert torch.equal(p.prop_offsets, nominal.prop_offsets.expand(E, 4, 3))
    np.testing.assert_allclose(torch.einsum("eij,ejk->eik", p.J, p.J_inv).numpy(),
                               np.tile(np.eye(3), (E, 1, 1)), atol=1e-5)
    for field in ("m", "kf", "km", "gnd_eff_coeff", "dw_coeff_1"):
        ratio = (getattr(p, field) / getattr(nominal, field)).numpy()
        assert ratio.min() >= 0.85 - 1e-6 and ratio.max() <= 1.15 + 1e-6, field
        assert np.ptp(ratio) > 0, field
    # the same generator state draws the same params; nominal_params is env 0
    assert torch.equal(randomize_params(_gen(0), nominal, E, {"m": 0.15}).m,
                       randomize_params(_gen(0), nominal, E, {"m": 0.15}).m)
    assert torch.equal(troll.nominal_params(p).m, p.m[0])


def test_one_d_rpm_randomization_is_not_cancelled():
    """ONE_D_RPM maps actions through the NOMINAL hover_rpm, so a mass spread
    moves the closed loop by a macroscopic amount in 1 s."""
    cfg = _hover()
    nominal, p, ctrl = _env(cfg, {"m": 0.2}, 8, 7)
    step = troll.make_batched_step(cfg, p, ctrl, tbase.hover_target_pos(cfg, nominal),
                                   auto_reset=False)
    state = troll.batch_reset(cfg, p, 8, device="cpu")
    for _ in range(30):
        state, _ = step(state, torch.full((8, 1, 1), 0.3))
    z = state.kin.pos[:, 0, 2]
    assert float(z.max() - z.min()) > 5e-2, z


def test_randomize_params_empty_spec_is_tile_and_unknown_keys_raise():
    nominal = drone_params(tspec.DroneModel.CF2X, device="cpu")
    p = randomize_params(_gen(1), nominal, 4, {})
    for got, nom in zip(troll._leaves(p), troll._leaves(nominal)):
        assert torch.equal(got, nom.expand(got.shape))
    with pytest.raises(ValueError, match="arm"):
        randomize_params(_gen(0), nominal, 2, {"arm": 0.1})


def test_randomized_mass_orders_climb_rates():
    """Nominal hover RPM on perturbed plants: the climb falls with mass, and
    its sign flips at the nominal mass; every env resets alike."""
    cfg = tbase.AviaryConfig(num_drones=1, task=tbase.TASK_CTRL, pyb_freq=240, ctrl_freq=48,
                             initial_xyzs=((0.0, 0.0, 1.0),))
    nominal, p, ctrl = _env(cfg, {"m": 0.2}, 8, 2)
    step = troll.make_batched_step(cfg, p, ctrl, None, auto_reset=False)
    state = troll.batch_reset(cfg, p, 8, device="cpu")
    assert torch.equal(state.kin.pos[0], state.kin.pos[-1])
    action = nominal.hover_rpm.expand(8, 1, 4)
    for _ in range(24):
        state, _ = step(state, action)
    dz = state.kin.pos[:, 0, 2].numpy() - 1.0
    m = p.m.numpy()
    assert (np.diff(dz[np.argsort(m)]) < 0).all(), (m, dz)
    assert dz[m < float(nominal.m)].min() > 0 and dz[m > float(nominal.m)].max() < 0


@pytest.mark.parametrize("action,n", [("ONE_D_RPM", 1), ("PID", 2), ("VEL", 1)])
def test_jax_draws_step_alike_in_both_packages(action, n):
    """JAX's randomize_params batch, carried into the port, through both
    packages' per-env make_batched_step (auto-reset on, 0.38 s episodes) for 20
    control steps, float64: every state leaf, obs and reward at 1e-10."""
    common = dict(num_drones=n, task="hover" if n == 1 else "multihover", pyb_freq=240,
                  ctrl_freq=30, action_buffer_size=15, episode_len_sec=0.38, dtype="float64")
    jcfg = jbase.AviaryConfig(action_type=jspec.ActionType[action], **common)
    tcfg = tbase.AviaryConfig(action_type=tspec.ActionType[action], **common)
    E = 5
    jnom = jbase.build_params(jcfg)
    jp = jrandomize(jax.random.key(3), jnom, E, {"m": 0.1, "kf": 0.05, "inertia": 0.1,
                                                 "drag": 0.2})
    tp = convert.drone_params_from_numpy(convert.record_to_numpy(jp), device="cpu",
                                         dtype=torch.float64)
    assert troll.params_are_batched(tp) and tp.J.shape == (E, 3, 3)
    jcp, tcp = jbase.build_ctrl_params(jcfg), tbase.build_ctrl_params(tcfg, "cpu")
    jtgt = jbase.hover_target_pos(jcfg, jnom)
    ttgt = tbase.hover_target_pos(tcfg, troll.nominal_params(tp))
    jstep = jit_reference(jroll.make_batched_step(jcfg, jp, jcp, jtgt))
    tstep = troll.make_batched_step(tcfg, tp, tcp, ttgt)
    jstate, tstate = jroll.batch_reset(jcfg, jp, E), troll.batch_reset(tcfg, tp, E, device="cpu")
    rng = np.random.default_rng(4)
    acts = rng.uniform(-1, 1, (20, E, n, tcfg.action_dim))
    if action == "PID":
        acts = 0.3 * acts + np.array([0.0, 0.0, 0.5])
    resets = 0
    for a in acts:
        jstate, jout = jstep(jstate, jnp.asarray(a))
        tstate, tout = tstep(tstate, torch.as_tensor(a))
        got, want = convert.aviary_state_to_numpy(tstate), convert.aviary_state_to_numpy(jstate)
        for k in convert.AVIARY_STATE_FIELDS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-10, err_msg=k)
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), atol=1e-10)
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), atol=1e-10)
        np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(jout.truncated))
        resets += int(tout.truncated.sum())
    assert resets > 0
    vz = tstate.kin.vel[:, 0, 2].numpy()
    assert np.ptp(vz) > 1e-3, vz  # the envs stepped different plants


def test_ppo_train_step_with_domain_rand():
    """One PPO train step over randomized plants: finite metrics, and the
    batch really steps different dynamics (z spread across envs > 1 mm)."""
    cfg = _hover(episode_len_sec=2.0)
    ppo_cfg = tppo.PPOConfig(num_envs=4, n_steps=16, n_epochs=1, minibatch_size=32)
    runner, aux = tppo.ppo_init(cfg, ppo_cfg, 3, device="cpu",
                                domain_rand={"m": 0.1, "kf": 0.05})
    assert aux["train_params_env"].m.shape == (4,) and aux["params_env"].m.ndim == 0
    runner, metrics = tppo.make_ppo_train_step(cfg, ppo_cfg, aux)(runner)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    z = runner.env_state.kin.pos[:, 0, 2]
    assert float(z.max() - z.min()) > 1e-3, z


@pytest.mark.parametrize("action,n,extra", [
    ("ONE_D_RPM", 1, {}), ("PID", 2, {}), ("VEL", 1, {}),
    ("ONE_D_RPM", 1, dict(collisions=True, contact_mode="impulse")),
    ("ONE_D_RPM", 2, dict(collisions=True, contact_mode="impulse")),
], ids=["one_d_rpm", "pid_2", "vel", "impulse", "impulse_2"])
def test_per_env_step_equals_each_env_alone(action, n, extra):
    """The vmapped per-env step equals each env stepped alone with its own
    plant, bit for bit, float32, 5 control steps."""
    cfg = _hover(action, n, **extra)
    nominal, p, ctrl = _env(cfg, {"m": 0.1, "kf": 0.05, "inertia": 0.1}, 3, 0)
    target = tbase.hover_target_pos(cfg, nominal)
    a = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (3, n, cfg.action_dim)),
                        dtype=torch.float32)
    state = troll.batch_reset(cfg, p, 3, device="cpu")
    step = troll.make_batched_step(cfg, p, ctrl, target, auto_reset=False)
    with warnings.catch_warnings(record=True) as caught:
        # vmap's "no batching rule" fallback warns: it loops over the envs
        warnings.simplefilter("always")
        for _ in range(5):
            state, _ = step(state, a)
    assert not caught, [str(w.message) for w in caught]
    for e in range(3):
        pe = p.map(lambda x: x[e])
        alone = troll.batch_reset(cfg, pe, 1, device="cpu")
        step_e = troll.make_batched_step(cfg, pe, ctrl, target, auto_reset=False)
        for _ in range(5):
            alone, _ = step_e(alone, a[e:e + 1])
        for k in ("pos", "quat", "vel", "ang_v"):
            assert torch.equal(getattr(alone.kin, k)[0], getattr(state.kin, k)[e]), (e, k)


def _in_place_rows(monkeypatch):
    """The body and exact pair rows' sweeps as they were before the vmap
    rewrite: in place."""

    def normal(self, S):
        lams = self.lam["n"]
        for c, p in enumerate(self.rows):
            H, G, kact = p["n"]
            new = torch.clamp_min(torch.addcmul(lams[c], p["tgt"] - tcontact._dot(S, H), kact),
                                  0.0)
            S.addcmul_(new - lams[c], G)
            lams[c] = new
        return S

    def friction(self, S):
        for c, p in enumerate(self.rows):
            limit = self.mu * self.lam["n"][c]
            neg = -limit
            for q in ("t1", "t2"):
                H, G, nkact = p[q]
                lams = self.lam[q]
                new = torch.clamp(torch.addcmul(lams[c], tcontact._dot(S, H), nkact),
                                  min=neg, max=limit)
                S.addcmul_(new - lams[c], G)
                lams[c] = new
        return S

    def pair_solve(self, S, p, q, lams, c, lo=None, hi=None):
        Hi, Gi, Hj, Gj, kact = p[q]
        Si, Sj = S[..., p["i"], :], S[..., p["j"], :]
        u = tcontact._dot(Si, Hi) - tcontact._dot(Sj, Hj)
        if lo is None:
            new = torch.clamp_min(torch.addcmul(lams[c], p["tgt"] - u, kact), 0.0)
        else:
            new = torch.clamp(torch.addcmul(lams[c], u, kact), min=lo, max=hi)
        a = new - lams[c]
        Si.addcmul_(a, Gi)
        Sj.addcmul_(a, Gj, value=-1.0)
        lams[c] = new

    def pair_normal(self, S):
        for c, p in enumerate(self.rows):
            self._solve(S, p, "n", self.lam["n"], c)
        return S

    def pair_friction(self, S):
        for c, p in enumerate(self.rows):
            limit = self.mu * self.lam["n"][c]
            for q in ("t1", "t2"):
                self._solve(S, p, q, self.lam[q], c, -limit, limit)
        return S

    monkeypatch.setattr(tcontact._BodyRows, "normal", normal)
    monkeypatch.setattr(tcontact._BodyRows, "friction", friction)
    monkeypatch.setattr(tcontact._ExactPairRows, "_solve", pair_solve)
    monkeypatch.setattr(tcontact._ExactPairRows, "normal", pair_normal)
    monkeypatch.setattr(tcontact._ExactPairRows, "friction", pair_friction)


@pytest.mark.parametrize("n", [1, 2])
def test_impulse_rewrite_keeps_the_nominal_path_bit_for_bit(n, monkeypatch):
    """make_batched_step on the contact checkpoints' envs (nominal params, 8
    envs lifting off the plane and landing, 20 control steps; the two drones
    start 10 cm apart, overlapping, so the pair rows act), with the body and
    pair rows' out-of-place sweeps against the in-place ones they replaced:
    every kinematic leaf equal bit for bit."""
    init = tuple((0.1 * i, 0.0, 0.0125) for i in range(n))
    cfg = _hover(n=n, collisions=True, contact_mode="impulse", initial_xyzs=init)
    p, cp = tbase.build_params(cfg, "cpu"), tbase.build_ctrl_params(cfg, "cpu")
    acts = np.clip(1.5 * np.sin(np.arange(20)[:, None, None, None] / 3.0
                                + np.arange(8)[None, :, None, None]), -1, 1)

    def run():
        step = troll.make_batched_step(cfg, p, cp, tbase.hover_target_pos(cfg, p))
        state, low = troll.batch_reset(cfg, p, 8, device="cpu"), []
        for a in acts:
            state, _ = step(state, torch.as_tensor(np.repeat(a, n, axis=1),
                                                   dtype=torch.float32))
            low.append(float(state.kin.pos[..., 2].min()))
        return state, min(low)

    new, low = run()
    with monkeypatch.context() as m:
        _in_place_rows(m)
        old, _ = run()
    for k in ("pos", "quat", "vel", "ang_v", "rpy_rates"):
        assert torch.equal(getattr(new.kin, k), getattr(old.kin, k)), k
    assert low < 0.013 and float(new.kin.pos[..., 2].max()) > 0.02  # rested and lifted
    if n == 2:  # the pair rows pushed the drones apart
        gap = (new.kin.pos[:, 1, 0] - new.kin.pos[:, 0, 0]).abs()
        assert float(gap.min()) > 0.11, gap
