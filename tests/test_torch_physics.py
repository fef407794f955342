"""Port rotations, aero, dynamics and DSLPID against the JAX package in float64,
and the hover_dyn / helix_pyb goldens replayed through the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.control import dsl_pid as jpid
from gym_pybullet_drones_tpu.core import aero as jaero
from gym_pybullet_drones_tpu.core import dynamics as jdyn
from gym_pybullet_drones_tpu.core import rotations as jrot
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JModel
from gym_pybullet_drones_tpu.envs.spec import Physics as JPhysics
from gym_pybullet_drones_tpu_torch.control import dsl_pid as tpid
from gym_pybullet_drones_tpu_torch.core import aero as taero
from gym_pybullet_drones_tpu_torch.core import dynamics as tdyn
from gym_pybullet_drones_tpu_torch.core import rotations as trot
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from torch_parity import jit_reference

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotation_inputs(rng):
    q = _rand_quats(rng, 16)
    omega = rng.normal(size=(16, 3)) * 3.0
    omega[:3] = 0.0  # the zero-rate branch of integrate_quat
    omega[3] = 1e-12
    return dict(
        quat_to_matrix=(q,),
        quat_multiply=(q, _rand_quats(rng, 16)),
        quat_normalize=(q * rng.uniform(0.5, 2.0, (16, 1)),),
        quat_rotate=(q, rng.normal(size=(16, 3))),
        quat_to_euler_xyz=(q,),
        euler_xyz_to_quat=(rng.uniform(-3.0, 3.0, (16, 3)),),
        matrix_to_euler_intrinsic_xyz=(np.asarray(jrot.quat_to_matrix(jnp.asarray(q))),),
        euler_intrinsic_xyz_to_matrix=(rng.uniform(-3.0, 3.0, (16, 3)),),
        integrate_quat=(q, omega, 1 / 240),
    )


@pytest.mark.parametrize("name", [
    "quat_to_matrix", "quat_multiply", "quat_normalize", "quat_rotate",
    "quat_to_euler_xyz", "euler_xyz_to_quat", "matrix_to_euler_intrinsic_xyz",
    "euler_intrinsic_xyz_to_matrix", "integrate_quat"])
def test_rotation_matches_jax(name):
    args = _rotation_inputs(np.random.RandomState(0))[name]
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    want = np.asarray(getattr(jrot, name)(*jargs))
    got = _n(getattr(trot, name)(*targs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("model", ["CF2X", "CF2P", "RACE"])
def test_motor_forces_match_jax(model):
    rng = np.random.RandomState(1)
    rpm = rng.uniform(0, 25000, (5, 3, 4))
    jp = jax_drone_params(JModel[model], dtype=jnp.float64)
    tp = drone_params(DroneModel[model], dtype=F64, device="cpu")
    wf, wz = jdyn.motor_forces(jnp.asarray(rpm), jp)
    gf, gz = tdyn.motor_forces(_t(rpm), tp)
    np.testing.assert_allclose(_n(gf), np.asarray(wf), rtol=1e-15, atol=0)
    np.testing.assert_allclose(_n(gz), np.asarray(wz), rtol=1e-15, atol=1e-30)


def test_aero_terms_match_jax():
    rng = np.random.RandomState(2)
    jp = jax_drone_params(dtype=jnp.float64)
    tp = drone_params(dtype=F64, device="cpu")
    n = 6
    q = _rand_quats(rng, n) * np.array([0.2, 0.2, 0.2, 1.0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    rpy = np.asarray(jrot.quat_to_euler_xyz(jnp.asarray(q)))
    # Drones 0.5 m apart in height: the wake is well conditioned there.
    pos = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                    0.02 + 0.5 * np.arange(n)], -1)
    rpm = rng.uniform(10000, 20000, (n, 4))
    vel = rng.normal(size=(n, 3))
    np.testing.assert_allclose(
        _n(taero.ground_effect_forces(_t(rpm), _t(pos), _t(R), _t(rpy), tp)),
        np.asarray(jaero.ground_effect_forces(jnp.asarray(rpm), jnp.asarray(pos),
                                              jnp.asarray(R), jnp.asarray(rpy), jp)),
        rtol=1e-13, atol=0)
    np.testing.assert_allclose(
        _n(taero.drag_force_world(_t(rpm), _t(vel), tp)),
        np.asarray(jaero.drag_force_world(jnp.asarray(rpm), jnp.asarray(vel), jp)),
        rtol=1e-13, atol=0)
    want = np.asarray(jaero.downwash_forces_body_z(jnp.asarray(pos), jp))
    assert np.abs(want).max() > 0  # the wake is live
    np.testing.assert_allclose(_n(taero.downwash_forces_body_z(_t(pos), tp)), want,
                               rtol=1e-12, atol=0)


def _fleet(rng, n=3):
    pos = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n),
                    0.3 + 0.6 * np.arange(n)], -1)
    rpy = rng.uniform(-0.2, 0.2, (n, 3))
    quat = np.asarray(jrot.euler_xyz_to_quat(jnp.asarray(rpy)))
    return dict(pos=pos, quat=quat, vel=rng.normal(size=(n, 3)) * 0.3,
                ang_v=rng.normal(size=(n, 3)) * 0.5, rpy_rates=rng.normal(size=(n, 3)) * 0.5)


@pytest.mark.parametrize("physics", [p.name for p in Physics])
def test_step_physics_matches_jax(physics):
    """3 drones, 10 control steps of 5 substeps under an open-loop RPM
    sequence, in float64: every state leaf and the carried action."""
    rng = np.random.RandomState(3)
    jp = jax_drone_params(dtype=jnp.float64)
    tp = drone_params(dtype=F64, device="cpu")
    s0 = _fleet(rng)
    jkin = jdyn.KinState(**{k: jnp.asarray(v) for k, v in s0.items()})
    tkin = tdyn.KinState(**{k: _t(v) for k, v in s0.items()})
    hover = float(jp.hover_rpm)
    jlast = jnp.zeros((3, 4))
    tlast = torch.zeros((3, 4), dtype=F64)
    jstep = jit_reference(lambda k, r, l: jdyn.step_physics(k, r, l, jp, 1 / 240, 5,
                                                      JPhysics[physics]))
    for _ in range(10):
        rpm = hover * (1.0 + 0.05 * rng.uniform(-1, 1, (3, 4)))
        jkin, jlast = jstep(jkin, jnp.asarray(rpm), jlast)
        tkin, tlast = tdyn.step_physics(tkin, _t(rpm), tlast, tp, 1 / 240, 5,
                                        Physics[physics])
        for k in s0:
            np.testing.assert_allclose(_n(getattr(tkin, k)), np.asarray(getattr(jkin, k)),
                                       rtol=0, atol=1e-11, err_msg=k)
        np.testing.assert_array_equal(_n(tlast), np.asarray(jlast))


def test_step_physics_leaves_contact_slices_unported():
    """Clamp contact with collisions is ported (tests/test_torch_collisions.py);
    the sequential-impulse mode, with or without collisions, names slice 3."""
    tp = drone_params(dtype=F64, device="cpu")
    kin = tdyn.init_kin_state(_t([[0.0, 0.0, 1.0]]), _t([[0.0, 0.0, 0.0, 1.0]]))
    rpm = torch.zeros((1, 4), dtype=F64)
    tdyn.step_physics(kin, rpm, rpm, tp, 1 / 240, 5, Physics.PYB, collisions=True)
    for collisions in (False, True):
        with pytest.raises(NotImplementedError, match="slice 3"):
            tdyn.step_physics(kin, rpm, rpm, tp, 1 / 240, 5, Physics.PYB,
                              collisions=collisions, contact_mode="impulse")


@pytest.mark.parametrize("model", ["CF2X", "CF2P"])
def test_dsl_pid_control_matches_jax(model):
    rng = np.random.RandomState(4)
    n = 8
    jcp = jpid.dsl_pid_params(JModel[model], dtype=jnp.float64)
    tcp = tpid.dsl_pid_params(DroneModel[model], dtype=F64, device="cpu")
    st = {k: rng.normal(size=(n, 3)) * 0.1
          for k in ("last_rpy", "integral_pos_e", "integral_rpy_e")}
    args = dict(cur_pos=rng.normal(size=(n, 3)), cur_quat=_rand_quats(rng, n),
                cur_vel=rng.normal(size=(n, 3)), target_pos=rng.normal(size=(n, 3)),
                target_rpy=rng.uniform(-0.5, 0.5, (n, 3)),
                target_vel=rng.normal(size=(n, 3)), target_rpy_rates=rng.normal(size=(n, 3)))
    jcontrol = jit_reference(
        lambda s, a: jpid.dsl_pid_control(jcp, jpid.DSLPIDState(**s), 1 / 48, **a))
    want = jcontrol({k: jnp.asarray(v) for k, v in st.items()},
                    {k: jnp.asarray(v) for k, v in args.items()})
    got = tpid.dsl_pid_control(tcp, tpid.DSLPIDState(**{k: _t(v) for k, v in st.items()}),
                               1 / 48, **{k: _t(v) for k, v in args.items()})
    np.testing.assert_allclose(_n(got[0]), np.asarray(want[0]), rtol=1e-12, atol=1e-8)
    for k in st:
        np.testing.assert_allclose(_n(getattr(got[1], k)), np.asarray(getattr(want[1], k)),
                                   rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(_n(got[2]), np.asarray(want[2]), atol=1e-15)
    np.testing.assert_allclose(_n(got[3]), np.asarray(want[3]), atol=1e-12)


@pytest.mark.parametrize("dim", [1, 2, 4])
def test_one23d_interface_matches_jax(dim):
    rng = np.random.RandomState(5)
    thrust = rng.uniform(0.01, 0.2, (6, dim))
    want = jpid.one23d_interface(jpid.dsl_pid_params(dtype=jnp.float64), jnp.asarray(thrust))
    got = tpid.one23d_interface(tpid.dsl_pid_params(dtype=F64, device="cpu"), _t(thrust))
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-15, atol=0)


def test_hover_dyn_golden_through_port():
    """tests/test_golden.py's float64 bit-parity replay: pos at 1e-12."""
    g = np.load(os.path.join(GOLDEN, "hover_dyn.npz"))
    p = drone_params(dtype=F64, device="cpu")
    cp = tpid.dsl_pid_params(dtype=F64, device="cpu")
    kin = tdyn.init_kin_state(_t([[0.0, 0.0, 0.1]]), _t([[0.0, 0.0, 0.0, 1.0]]))
    cs = tpid.dsl_pid_reset((1,), dtype=F64, device="cpu")
    target = _t([[0.0, 0.0, 1.0]])
    rpm = torch.zeros((1, 4), dtype=F64)
    pos, rpms = [], []
    for _ in range(48 * 4):
        kin, _ = tdyn.step_physics(kin, rpm, rpm, p, 1 / 240, 5, Physics.DYN,
                                   renormalize_quat=False)
        rpm, cs, _, _ = tpid.dsl_pid_control(cp, cs, 1 / 48, kin.pos, kin.quat, kin.vel, target)
        pos.append(_n(kin.pos))
        rpms.append(_n(rpm))
    np.testing.assert_allclose(np.stack(pos), g["pos"], atol=1e-12)
    np.testing.assert_allclose(np.stack(rpms), g["rpm"], atol=1e-8)


def test_helix_pyb_golden_through_port():
    """tests/test_golden_pyb.py's float64 replay: pos[:48] at 1e-9 and the
    4 s flight inside 5e-2."""
    g = np.load(os.path.join(GOLDEN, "helix_pyb.npz"))
    n = 3
    p = drone_params(dtype=F64, device="cpu")
    cp = tpid.dsl_pid_params(dtype=F64, device="cpu")
    init_xyzs, init_rpys = _t(g["init_xyzs"]), _t(g["init_rpys"])
    kin = tdyn.init_kin_state(init_xyzs, trot.euler_xyz_to_quat(init_rpys))
    cs = tpid.dsl_pid_reset((n,), dtype=F64, device="cpu")
    track, tz = _t(g["txy"]), init_xyzs[:, 2]
    wp = np.asarray(g["wp0"]).copy()
    rpm = torch.zeros((n, 4), dtype=F64)
    last = torch.zeros((n, 4), dtype=F64)
    out = []
    for _ in range(g["pos"].shape[0]):
        kin, last_next = tdyn.step_physics(kin, rpm, last, p, 1 / 240, 5, Physics.PYB)
        target = torch.cat([track[torch.as_tensor(wp)], tz[:, None]], -1)
        rpm, cs, _, _ = tpid.dsl_pid_control(cp, cs, 1 / 48, kin.pos, kin.quat, kin.vel,
                                             target, init_rpys)
        last = last_next
        wp = np.where(wp < track.shape[0] - 1, wp + 1, 0)
        out.append(_n(kin.pos))
    pos = np.stack(out)
    np.testing.assert_allclose(pos[:48], g["pos"][:48], atol=1e-9)
    assert np.abs(pos - g["pos"]).max() < 5e-2
