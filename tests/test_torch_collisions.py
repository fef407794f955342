"""The port's contact physics (core/collisions.py, the contact branch of
core/dynamics.py and envs/base.step with collisions=True) against the JAX
package in float64: the resolves at 1e-12, the steps at 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core import collisions as jcol
from gym_pybullet_drones_tpu.core import dynamics as jdyn
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs import spec as jspec
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.core import collisions as tcol
from gym_pybullet_drones_tpu_torch.core import dynamics as tdyn
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs import spec as tspec
from torch_parity import jit_reference

F64 = torch.float64
R_COLL = 0.06  # cf2x.urdf:31-36


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def _obstacles(scene):
    if scene == "rl":
        return jcol.rl_obstacles(jnp.float64), tcol.rl_obstacles(F64, "cpu")
    return jcol.base_obstacles(jnp.float64), tcol.base_obstacles(F64, "cpu")


@pytest.mark.parametrize("other", [False, True])
def test_resolve_drone_collisions_matches_jax(other):
    """A dense 64-drone cloud with many overlaps, against itself or against
    another partner set (the sharded form)."""
    rng = np.random.RandomState(0)
    pos, vel = rng.uniform(-0.2, 0.2, (2, 64, 3))
    pos[:, 2] += 1.0
    kw_j, kw_t = {}, {}
    if other:
        opos, ovel = rng.uniform(-0.2, 0.2, (2, 40, 3))
        opos[:, 2] += 1.0
        kw_j = dict(other_pos=jnp.asarray(opos), other_vel=jnp.asarray(ovel))
        kw_t = dict(other_pos=_t(opos), other_vel=_t(ovel))
    jp, jv = jit_reference(lambda p, v, kw: jcol.resolve_drone_collisions(p, v, R_COLL, **kw))(
        jnp.asarray(pos), jnp.asarray(vel), kw_j)
    tp, tv = tcol.resolve_drone_collisions(_t(pos), _t(vel), R_COLL, **kw_t)
    assert np.abs(tp.numpy() - pos).max() > 1e-3  # contacts fired
    _close(tp, jp, 1e-12)
    _close(tv, jv, 1e-12)


@pytest.mark.parametrize("scene", ["rl", "base"])
def test_resolve_obstacle_collisions_matches_jax(scene):
    """Drones scattered around every obstacle, touching or not, plus one
    center inside a box core (tests/test_collisions.py:449)."""
    jobs, tobs = _obstacles(scene)
    rng = np.random.RandomState(1)
    centers = np.asarray(jobs.pos)
    reach = np.asarray(jobs.radius)[:, None] + np.asarray(jobs.half) + R_COLL + 0.05
    pos = (centers + rng.uniform(-1, 1, (8,) + centers.shape) * reach).reshape(-1, 3)
    box = int(np.argmax(np.asarray(jobs.half).sum(1)))
    inside = centers[box] + np.array([0.0, 0.4, 0.0]) * np.asarray(jobs.half)[box]
    pos = np.concatenate([pos, inside[None]])
    vel = rng.normal(size=pos.shape)
    jp, jv = jit_reference(lambda p, v: jcol.resolve_obstacle_collisions(p, v, R_COLL, jobs))(
        jnp.asarray(pos), jnp.asarray(vel))
    tp, tv = tcol.resolve_obstacle_collisions(_t(pos), _t(vel), R_COLL, tobs)
    push = tp.numpy() - pos
    assert (np.abs(push).max(1) > 0).sum() >= 4  # several drones in contact
    assert np.linalg.norm(push[-1]) > 1e-4  # the one inside the box is pushed out
    _close(tp, jp, 1e-12)
    _close(tv, jv, 1e-12)
    jd, jin = jit_reference(lambda p: jcol.obstacle_delta(p, jobs))(jnp.asarray(pos))
    td, tin = tcol.obstacle_delta(_t(pos), tobs)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    _close(td, jd, 1e-15)


def test_resolve_collisions_sphere_set_matches_jax():
    """An all-spheres set (half=None) through the full pass."""
    jobs = jcol.ObstacleSet(pos=jnp.asarray([[0.0, 0.0, 1.0]]), radius=jnp.asarray([0.1]))
    tobs = tcol.ObstacleSet(pos=_t([[0.0, 0.0, 1.0]]), radius=_t([0.1]))
    pos = np.array([[0.15, 0.0, 1.0], [0.0, 0.14, 1.02], [0.05, 0.2, 1.0]])
    vel = np.array([[-0.5, 0.3, 0.0], [0.1, -0.4, 0.2], [0.0, -1.0, 0.0]])
    jp, jv = jit_reference(lambda p, v: jcol.resolve_collisions(p, v, R_COLL, jobs))(
        jnp.asarray(pos), jnp.asarray(vel))
    tp, tv = tcol.resolve_collisions(_t(pos), _t(vel), R_COLL, tobs)
    _close(tp, jp, 1e-12)
    _close(tv, jv, 1e-12)


# tests/test_collisions.py:33 (head-on pair) and :82 (overlapping spawn), each
# with a third drone 0.6 m above so that the PYB_DW wake acts too.
_FLEETS = {
    "head_on": ([[-0.2, 0.0, 1.0], [0.2, 0.0, 1.0], [0.0, 0.3, 1.6]],
                [[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0], [0.0, 0.0, 0.0]]),
    "overlap": ([[0.0, 0.0, 1.0], [0.02, 0.0, 1.0], [0.01, 0.1, 1.6]],
                [[0.0, 0.0, 0.0]] * 3),
}


@pytest.mark.parametrize("physics", ["PYB", "PYB_DW"])
@pytest.mark.parametrize("fleet", sorted(_FLEETS))
def test_step_physics_with_contact_matches_jax(fleet, physics):
    """16 control steps (1/3 s, the head-on pair meets after 14) of
    step_physics(collisions=True) with the RL obstacles, in float64, every
    state leaf at 1e-10."""
    pos, vel = (np.array(a, dtype=np.float64) for a in _FLEETS[fleet])
    n = pos.shape[0]
    jp, tp = jax_drone_params(dtype=jnp.float64), drone_params(dtype=F64, device="cpu")
    jobs, tobs = _obstacles("rl")
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    jkin = jdyn.init_kin_state(jnp.asarray(pos), jnp.asarray(quat)).replace(vel=jnp.asarray(vel))
    tkin = tdyn.init_kin_state(_t(pos), _t(quat)).replace(vel=_t(vel))
    rpm = np.full((n, 4), float(jp.hover_rpm))
    jstep = jit_reference(lambda k, r: jdyn.step_physics(
        k, r, r, jp, 1 / 240, 5, jspec.Physics[physics], collisions=True, obstacles=jobs))
    gaps = []
    for _ in range(16):
        jkin, _ = jstep(jkin, jnp.asarray(rpm))
        tkin, _ = tdyn.step_physics(tkin, _t(rpm), _t(rpm), tp, 1 / 240, 5,
                                    tspec.Physics[physics], collisions=True, obstacles=tobs)
        for k in ("pos", "quat", "vel", "ang_v", "rpy_rates"):
            _close(getattr(tkin, k), getattr(jkin, k), 1e-10)
        gaps.append(float(torch.linalg.norm(tkin.pos[0] - tkin.pos[1])))
    assert min(gaps) >= 2 * R_COLL - 5e-3  # contact held the pair apart


def test_step_physics_single_drone_skips_pair_contact():
    """collisions=True with one drone runs no pair pass (JAX's N > 1 rule)
    and leaves a free drone's trajectory unchanged."""
    tp = drone_params(dtype=F64, device="cpu")
    kin = tdyn.init_kin_state(_t([[0.0, 0.0, 1.0]]), _t([[0.0, 0.0, 0.0, 1.0]]))
    rpm = torch.full((1, 4), float(tp.hover_rpm) * 1.01, dtype=F64)
    a, _ = tdyn.step_physics(kin, rpm, rpm, tp, 1 / 240, 5, tspec.Physics.PYB, collisions=True)
    b, _ = tdyn.step_physics(kin, rpm, rpm, tp, 1 / 240, 5, tspec.Physics.PYB)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)


@pytest.mark.parametrize("scene", ["rl", "base"])
def test_env_step_with_collisions_matches_jax(scene):
    """tests/test_collisions.py:141's converging pair, plus a third drone
    touching the scene's first obstacle, through envs/base.step in float64."""
    near = {"rl": (0.93, 0.0, 0.1), "base": (-0.5, -0.35, 0.1)}[scene]
    common = dict(num_drones=3, pyb_freq=240, ctrl_freq=48, task="ctrl", collisions=True,
                  obstacle_scene=scene, dtype="float64",
                  initial_xyzs=((-0.15, 0.0, 0.5), (0.15, 0.0, 0.5), near))
    jcfg = jbase.AviaryConfig(physics=jspec.Physics.PYB, **common)
    tcfg = tbase.AviaryConfig(physics=tspec.Physics.PYB, **common)
    jp, jcp = jbase.build_params(jcfg), jbase.build_ctrl_params(jcfg)
    tp, tcp = tbase.build_params(tcfg, "cpu"), tbase.build_ctrl_params(tcfg, "cpu")
    jtarget = jnp.zeros((3, 3))
    ttarget = torch.zeros((3, 3), dtype=F64)
    vel = np.array([[0.4, 0.0, 0.0], [-0.4, 0.0, 0.0], [0.0, 0.0, 0.0]])
    jstate = jbase.reset(jcfg, jp)
    jstate = jstate.replace(kin=jstate.kin.replace(vel=jnp.asarray(vel)))
    tstate = convert.aviary_state_from_numpy(convert.aviary_state_to_numpy(jstate),
                                             device="cpu", dtype=F64)
    action = np.full((3, 4), float(jp.hover_rpm))
    jstep = jit_reference(lambda s, a: jbase.step(jcfg, jp, jcp, jtarget, s, a))
    start = tstate.kin.pos.clone()
    for _ in range(24):
        jstate, jobs, *_ = jstep(jstate, jnp.asarray(action))
        tstate, tobs, *_ = tbase.step(tcfg, tp, tcp, ttarget, tstate, _t(action))
        _close(tobs, jobs, 1e-10)
        gap = float(torch.linalg.norm(tstate.kin.pos[0] - tstate.kin.pos[1]))
        assert gap >= 2 * R_COLL - 5e-3
    assert float(torch.linalg.norm(tstate.kin.pos[2] - start[2])) > 1e-3  # obstacle pushed
