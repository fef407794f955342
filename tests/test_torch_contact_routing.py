"""The impulse contact mode through the port's entry points against the JAX
package in float64: step_physics's candidate routing (NBR_MAX_N lowered on
both packages so the hash grid takes over at a few hundred drones), a direct
call with a leading batch axis (the Jacobi pass), and make_batched_step
against JAX's vmapped step at 1, 2 and 24 drones an env."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core import contact as jcon
from gym_pybullet_drones_tpu.core import dynamics as jdyn
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.core import contact as tcon
from gym_pybullet_drones_tpu_torch.core import dynamics as tdyn
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from torch_parity import jit_reference

jroll = importlib.import_module("gym_pybullet_drones_tpu.runtime.rollout")
troll = importlib.import_module("gym_pybullet_drones_tpu_torch.runtime.rollout")
F64 = torch.float64
DT = 1.0 / 240.0
LOWERED_NBR_MAX_N = 200


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _ladder(n, seed=0, batch=()):
    """scripts/impulse_ladder.py:38-47's contact-rich lattice: 10 cm pitch
    (every lateral neighbor pair in contact), +-5 mm jitter, at 1 m."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.arange(side) * 0.10, np.arange(side) * 0.10),
                 -1).reshape(-1, 2)[:n]
    pos = np.concatenate([g, np.full((n, 1), 1.0)], 1)
    pos = np.broadcast_to(pos, batch + pos.shape).copy()
    pos[..., :2] += rng.uniform(-0.005, 0.005, batch + (n, 2))
    return pos


def _kin_pair(pos, seed=1):
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 0.3, pos.shape)
    quat = np.zeros(pos.shape[:-1] + (4,))
    quat[..., 3] = 1.0
    z = np.zeros_like(pos)
    leaves = dict(pos=pos, quat=quat, vel=vel, ang_v=z, rpy_rates=z)
    return (jdyn.KinState(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            tdyn.KinState(**{k: _t(v) for k, v in leaves.items()}))


def _assert_kin_close(tkin, jkin, atol):
    for k in ("pos", "quat", "vel", "ang_v", "rpy_rates"):
        np.testing.assert_allclose(getattr(tkin, k).numpy(), np.asarray(getattr(jkin, k)),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("n,cands", [(64, "dense"), (256, "binned")])
def test_step_physics_routing_matches_jax(monkeypatch, n, cands):
    """One control period of 2 substeps with the neighbor rows, NBR_MAX_N
    lowered to 200 on both packages: equal to JAX at 1e-12, and equal bit for
    bit to a substep chain fed that build's candidates from the period's
    first pose (the routing and the persistence)."""
    monkeypatch.setattr(jcon, "NBR_MAX_N", LOWERED_NBR_MAX_N)
    monkeypatch.setattr(tcon, "NBR_MAX_N", LOWERED_NBR_MAX_N)
    jp, tp = jax_drone_params(dtype=jnp.float64), drone_params(dtype=F64, device="cpu")
    jkin, tkin = _kin_pair(_ladder(n))
    rpm = np.full((n, 4), float(jp.hover_rpm))
    jout, _ = jit_reference(lambda k, r: jdyn.step_physics(
        k, r, r, jp, DT, 2, jspec.Physics.PYB, collisions=True, contact_mode="impulse"))(
        jkin, jnp.asarray(rpm))
    tout, _ = tdyn.step_physics(tkin, _t(rpm), _t(rpm), tp, DT, 2, tspec.Physics.PYB,
                                collisions=True, contact_mode="impulse")
    _assert_kin_close(tout, jout, 1e-12)
    assert np.abs(tout.vel.numpy() - tkin.vel.numpy()).max() > 1e-2  # the pair rows acted

    build = getattr(tcon, "build_pair_candidates" + ("_binned" if cands == "binned" else ""))
    cands, kin = build(tkin.pos, tp.collision_r), tkin
    for _ in range(2):
        kin = tdyn.substep_pyb(kin, _t(rpm), _t(rpm), tp, DT, collide=True,
                               contact_mode="impulse", pair_candidates=cands)
    for k in ("pos", "quat", "vel", "ang_v"):
        assert torch.equal(getattr(kin, k), getattr(tout, k)), k


def test_env_batches_above_nbr_max_n_raise(monkeypatch):
    """An env batch with more than NBR_MAX_N drones an env names its ROADMAP
    item; one world of that size takes the hash grid."""
    monkeypatch.setattr(tcon, "NBR_MAX_N", 20)
    tp = drone_params(dtype=F64, device="cpu")
    _, tkin = _kin_pair(_ladder(24, batch=(2,)))
    rpm = torch.full((2, 24, 4), float(tp.hover_rpm), dtype=F64)
    with pytest.raises(NotImplementedError, match="item 14b"):
        tdyn.step_physics(tkin, rpm, rpm, tp, DT, 1, tspec.Physics.PYB, collisions=True,
                          contact_mode="impulse", env_batched=True)
    one = tkin.map(lambda x: x[0])
    out, _ = tdyn.step_physics(one, rpm[0], rpm[0], tp, DT, 1, tspec.Physics.PYB,
                               collisions=True, contact_mode="impulse")
    assert bool(torch.isfinite(out.vel).all())


def test_direct_batched_step_physics_takes_the_jacobi_pass():
    """A direct step_physics call with an (E, N, 3) state and N > 16 takes
    the Jacobi pair pass in both packages: one control period at 1e-12, and
    different from the env-batched neighbor rows."""
    jp, tp = jax_drone_params(dtype=jnp.float64), drone_params(dtype=F64, device="cpu")
    jkin, tkin = _kin_pair(_ladder(20, batch=(2,)))
    rpm = np.full((2, 20, 4), float(jp.hover_rpm))
    jout, _ = jit_reference(lambda k, r: jdyn.step_physics(
        k, r, r, jp, DT, 2, jspec.Physics.PYB, collisions=True, contact_mode="impulse"))(
        jkin, jnp.asarray(rpm))
    args = (tkin, _t(rpm), _t(rpm), tp, DT, 2, tspec.Physics.PYB)
    tout, _ = tdyn.step_physics(*args, collisions=True, contact_mode="impulse")
    _assert_kin_close(tout, jout, 1e-12)
    envs, _ = tdyn.step_physics(*args, collisions=True, contact_mode="impulse",
                                env_batched=True)
    assert np.abs(envs.ang_v.numpy() - tout.ang_v.numpy()).max() > 1e-3


def _grid24():
    """24 drones resting on the plane 11 cm apart (2r = 12 cm): the pair rows
    act from the first substep."""
    g = np.stack(np.meshgrid(np.arange(6) * 0.11, np.arange(4) * 0.11), -1).reshape(-1, 2)
    return tuple((float(x), float(y), 0.0125) for x, y in g)


@pytest.mark.parametrize("n", [1, 2, 24])
def test_make_batched_step_impulse_matches_jax(n):
    """The contact checkpoints' configs (tests/test_checkpoints.py:286-313:
    Hover with 1 drone, MultiHover with 2, ONE_D_RPM at 240/30 Hz, buffer 15,
    collisions, impulse, the RL landmarks), and 24 drones an env resting in
    touch (the neighbor rows, per env as under JAX's vmap; at 240/120 Hz, as
    the JAX reference's compile grows with the substeps it unrolls): E = 4
    envs, 20 control steps, every state leaf, obs and signal at 1e-10. The
    actions land the drones and take them off again."""
    task = "hover" if n == 1 else "multihover"
    common = dict(num_drones=n, pyb_freq=240, ctrl_freq=120 if n == 24 else 30, task=task,
                  action_buffer_size=15, dtype="float64", collisions=True,
                  contact_mode="impulse", initial_xyzs=_grid24() if n == 24 else None)
    jcfg = jbase.AviaryConfig(action_type=jspec.ActionType.ONE_D_RPM,
                              physics=jspec.Physics.PYB, **common)
    tcfg = tbase.AviaryConfig(action_type=tspec.ActionType.ONE_D_RPM,
                              physics=tspec.Physics.PYB, **common)
    jp, jcp = jbase.build_params(jcfg), jbase.build_ctrl_params(jcfg)
    tp, tcp = tbase.build_params(tcfg, "cpu"), tbase.build_ctrl_params(tcfg, "cpu")
    jtgt, ttgt = jbase.hover_target_pos(jcfg, jp), tbase.hover_target_pos(tcfg, tp)
    E = 4
    jstep = jit_reference(jroll.make_batched_step(jcfg, jp, jcp, jtgt))
    tstep = troll.make_batched_step(tcfg, tp, tcp, ttgt)
    js = jroll.batch_reset(jcfg, jp, E)
    ts = troll.batch_reset(tcfg, tp, E, device="cpu")
    u = np.random.RandomState(n).uniform(0.0, 0.2, (20, E, n, 1))
    acts = np.where(np.arange(20)[:, None, None, None] < 14, u - 1.0, 1.0 - u)
    zmin = np.inf
    for a in acts:
        js, jo = jstep(js, jnp.asarray(a))
        ts, to = tstep(ts, torch.as_tensor(a))
        got, want = convert.aviary_state_to_numpy(ts), convert.aviary_state_to_numpy(js)
        for k in convert.AVIARY_STATE_FIELDS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-10, err_msg=k)
        for name in ("obs", "reward", "final_obs"):
            np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                       rtol=1e-12, atol=1e-10, err_msg=name)
        for name in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(to, name).numpy(),
                                          np.asarray(getattr(jo, name)))
        zmin = min(zmin, float(ts.kin.pos[..., 2].min()))
    assert zmin < 0.0125  # the drones rested on the plane (the rows held them)
