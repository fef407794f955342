"""The port's controllers (control/ctbr.py, mrac.py, mellinger.py, commander.py
and the shells of control/compat.py) against the JAX package's on the same
inputs: the pure functions in float64 at 1e-10 to 1e-12, the fleet mission
and the Mellinger fleet hover through the env step in float32 against JAX
over 1 s, with the JAX tests' end-state gates over their full length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gym_pybullet_drones_tpu.control import commander as jcom
from gym_pybullet_drones_tpu.control import compat as jcompat
from gym_pybullet_drones_tpu.control import ctbr as jctbr
from gym_pybullet_drones_tpu.control import mellinger as jmel
from gym_pybullet_drones_tpu.control import mrac as jmrac
from gym_pybullet_drones_tpu.core.rotations import quat_to_euler_xyz as jrpy
from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JDroneModel
from gym_pybullet_drones_tpu_torch import control as tcontrol
from gym_pybullet_drones_tpu_torch.control import commander as tcom
from gym_pybullet_drones_tpu_torch.control import compat as tcompat
from gym_pybullet_drones_tpu_torch.control import ctbr as tctbr
from gym_pybullet_drones_tpu_torch.control import mellinger as tmel
from gym_pybullet_drones_tpu_torch.control import mrac as tmrac
from gym_pybullet_drones_tpu_torch.core.rotations import quat_to_euler_xyz as trpy
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel
from test_controllers_extra import _ctbr_oracle
from torch_parity import jit_reference

F64 = torch.float64
RAD2DEG = 57.29577951308232
CPU = "cpu"


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _leaves_close(got, want, rtol, atol, what=""):
    """Every leaf of a port record (or dict) against the JAX one's."""
    import dataclasses

    if isinstance(got, dict):
        for k in got:
            _leaves_close(got[k], want[k], rtol, atol, f"{what}.{k}")
        return
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _leaves_close(getattr(got, f.name), getattr(want, f.name), rtol, atol,
                          f"{what}.{f.name}")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _poses(rng, n):
    pos = rng.uniform(-1, 1, (n, 3))
    vel = rng.uniform(-1, 1, (n, 3))
    quat = Rotation.from_euler("xyz", rng.uniform(-0.5, 0.5, (n, 3))).as_quat()
    return pos, vel, quat


def test_control_package_exports_what_jax_exports():
    import gym_pybullet_drones_tpu.control as jcontrol

    names = {n for n in dir(jcontrol) if not n.startswith("_")
             and n not in ("commander", "compat", "ctbr", "dsl_pid", "mellinger", "mrac")}
    assert names <= set(dir(tcontrol)), names - set(dir(tcontrol))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ctbr_matches_jax_and_the_float64_oracle(seed):
    """64 seeded poses at once: the port against JAX's ctbr_control and, pose
    by pose, against tests/test_controllers_extra.py's oracle, at 1e-12."""
    rng = np.random.RandomState(seed)
    pos, vel, quat = _poses(rng, 64)
    tp, tv = pos + rng.uniform(-1, 1, (64, 3)), rng.uniform(-0.5, 0.5, (64, 3))
    got = tctbr.ctbr_control(tctbr.ctbr_params(dtype=F64, device=CPU), _t(pos), _t(quat),
                             _t(vel), _t(tp), _t(tv)).numpy()
    want = jctbr.ctbr_control(jctbr.ctbr_params(dtype=jnp.float64), jnp.asarray(pos),
                              jnp.asarray(quat), jnp.asarray(vel), jnp.asarray(tp),
                              jnp.asarray(tv))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)
    for i in range(64):
        np.testing.assert_allclose(got[i], _ctbr_oracle(pos[i], quat[i], vel[i], tp[i], tv[i]),
                                   rtol=1e-12, atol=1e-12)
    # the default target velocity is zero, and every pivot branch is taken
    np.testing.assert_allclose(
        tctbr.ctbr_control(tctbr.ctbr_params(dtype=F64, device=CPU), _t(pos), _t(quat),
                           _t(vel), _t(tp)).numpy(),
        np.asarray(jctbr.ctbr_control(jctbr.ctbr_params(dtype=jnp.float64), jnp.asarray(pos),
                                      jnp.asarray(quat), jnp.asarray(vel), jnp.asarray(tp))),
        rtol=1e-12, atol=1e-12)


def test_ctbr_quaternion_from_matrix_takes_every_pivot():
    """Shepperd's four branches: rotations of pi about x, y, z and the
    identity each take another pivot; the port equals JAX at 1e-15."""
    R = Rotation.from_rotvec(np.array([[0, 0, 0], [np.pi * 0.9, 0, 0], [0, np.pi * 0.9, 0],
                                       [0, 0, np.pi * 0.9], [1.0, 2.0, -0.5]])).as_matrix()
    cols = [R[..., :, k] for k in range(3)]
    got = tctbr._matrix_cols_to_quat_xyzw(*map(_t, cols)).numpy()
    want = np.asarray(jctbr._matrix_cols_to_quat_xyzw(*map(jnp.asarray, cols)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_mrac_params_match_jax_array_for_array():
    for model in (DroneModel.CF2X, DroneModel.CF2P):
        for psi in (0.0, 0.3):
            got = tmrac.mrac_params(model, psi=psi, dtype=F64, device=CPU)
            want = jmrac.mrac_params(JDroneModel(model.value), psi=psi, dtype=jnp.float64)
            _leaves_close(got, want, rtol=1e-12, atol=1e-12, what=f"{model} psi={psi}")


def test_mrac_control_matches_jax_over_50_steps():
    """A batch of 16 drones fed seeded states for 50 steps, the adaptive gains
    carried, float64: rpm, errors and every state leaf at 1e-10 (relative
    to the gains' scale); the first step seeds Xm (initialized False)."""
    rng = np.random.RandomState(5)
    tp = tmrac.mrac_params(dtype=F64, device=CPU)
    jp = jmrac.mrac_params(dtype=jnp.float64)
    ts, js = tmrac.mrac_reset(tp, (16,)), jmrac.mrac_reset(jp, (16,))
    assert not bool(ts.initialized.any())
    jstep = jit_reference(lambda s, *a: jmrac.mrac_control(jp, s, 1.0 / 120.0, *a))
    for k in range(50):
        pos, vel, quat = _poses(rng, 16)
        pos[:, 2] += 1.0
        ang = rng.uniform(-1, 1, (16, 3))
        target = np.array([0.0, 0.0, 1.0]) + rng.uniform(-0.3, 0.3, (16, 3))
        extra = [rng.uniform(-0.2, 0.2, (16, 3)) for _ in range(3)]
        got = tmrac.mrac_control(tp, ts, 1.0 / 120.0, _t(pos), _t(quat), _t(vel), _t(ang),
                                 _t(target), *map(_t, extra))
        want = jstep(js, *map(jnp.asarray, (pos, quat, vel, ang, target, *extra)))
        ts, js = got[1], want[1]
        for a, b, what in ((got[0], want[0], "rpm"), (got[2], want[2], "pos_e"),
                           (got[3], want[3], "rpy_e")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10,
                                       err_msg=f"{what} step {k}")
        _leaves_close(ts, js, rtol=1e-10, atol=1e-10, what=f"state step {k}")
    assert bool(ts.initialized.all())


def test_lpf2p_matches_jax_with_a_non_finite_input():
    tc, jc = tmel.lpf2p_coeffs(500.0, 30.0, dtype=F64, device=CPU), \
        jmel.lpf2p_coeffs(500.0, 30.0, dtype=jnp.float64)
    _leaves_close(tc, jc, rtol=1e-14, atol=0)
    _leaves_close(tmel.lpf2p_coeffs(500.0, 0.0, dtype=F64, device=CPU),
                  jmel.lpf2p_coeffs(500.0, 0.0, dtype=jnp.float64), rtol=0, atol=0)
    rng = np.random.default_rng(0)
    samples = rng.normal(size=(200, 8)) * 50.0
    samples[50, 3] = np.inf  # the guard replaces a non-finite delay0 by the sample
    d = [(_t(np.zeros(8)), _t(np.zeros(8))), (jnp.zeros(8), jnp.zeros(8))]
    for k, s in enumerate(samples):
        got, *tdel = tmel.lpf2p_apply(tc, *d[0], _t(s))
        want, *jdel = jmel.lpf2p_apply(jc, *d[1], jnp.asarray(s))
        d = [tuple(tdel), tuple(jdel)]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10,
                                   err_msg=f"sample {k}")
    # a delay line driven non-finite restarts from the sample
    out, d0, _ = tmel.lpf2p_apply(tc, _t([np.inf]), _t([0.0]), _t([2.0]))
    assert float(d0) == 2.0 and not np.isfinite(float(out))


def _mel_inputs(rng, n, unarmed=False):
    pos, vel, quat = _poses(rng, n)
    pos[:, 2] += 1.0
    gyro = rng.uniform(-200, 200, (n, 3))
    sp = dict(sp_pos=pos + rng.uniform(-0.3, 0.3, (n, 3)), sp_vel=rng.uniform(-0.5, 0.5, (n, 3)),
              sp_acc=rng.uniform(-1, 1, (n, 3)), sp_rate_deg=rng.uniform(-30, 30, (n, 3)))
    if unarmed:  # a setpoint far below: target thrust points down, thrust <= 0
        sp["sp_pos"][:, 2] -= 50.0
        sp["sp_acc"][:, 2] = -20.0
    return pos, vel, quat, gyro, sp


@pytest.mark.parametrize("yaw", ["quat", "deg", "none"])
def test_mellinger_control_and_rpm_match_jax(yaw):
    """32 drones for 20 ticks of seeded states, the memory carried, float64:
    control, power stage, rpm and state at 1e-10; tick 10 is unarmed."""
    rng = np.random.default_rng(3)
    tp, jp = tmel.mellinger_params(dtype=F64, device=CPU), \
        jmel.mellinger_params(dtype=jnp.float64)
    ts = tmel.mellinger_reset((32,), dtype=F64, device=CPU)
    js = jmel.mellinger_reset((32,), dtype=jnp.float64)
    jctl = jit_reference(lambda s, *a, **kw: jmel.mellinger_control(jp, s, *a, **kw))
    for k in range(20):
        pos, vel, quat, gyro, sp = _mel_inputs(rng, 32, unarmed=k == 10)
        if yaw == "quat":
            sp["sp_quat"] = Rotation.from_euler("z", rng.uniform(-3, 3, (32, 1))).as_quat()
        elif yaw == "deg":
            sp["sp_yaw_deg"] = rng.uniform(-180, 180, 32)
        sp_pos = sp.pop("sp_pos")
        got, ts_new = tmel.mellinger_control(tp, ts, _t(pos), _t(vel), _t(quat), _t(gyro),
                                             _t(sp_pos), **{k_: _t(v) for k_, v in sp.items()})
        want, js_new = jctl(js, *map(jnp.asarray, (pos, vel, quat, gyro, sp_pos)),
                            **{k_: jnp.asarray(v) for k_, v in sp.items()})
        _leaves_close(got, want, rtol=1e-12, atol=1e-10, what=f"control tick {k}")
        if k == 10:
            assert not bool((got["thrust"] > 0).any())
            assert float(ts_new.i_error.abs().max()) == 0.0
        np.testing.assert_allclose(tmel.power_distribution_x(got).numpy(),
                                   np.asarray(jmel.power_distribution_x(want)),
                                   rtol=1e-12, atol=1e-9)
        rpm_t, _ = tmel.mellinger_rpm(tp, ts, _t(pos), _t(vel), _t(quat), _t(gyro),
                                      _t(sp_pos), **{k_: _t(v) for k_, v in sp.items()})
        rpm_j, _ = jmel.mellinger_rpm(jp, js, *map(jnp.asarray, (pos, vel, quat, gyro, sp_pos)),
                                      **{k_: jnp.asarray(v) for k_, v in sp.items()})
        np.testing.assert_allclose(rpm_t.numpy(), np.asarray(rpm_j), rtol=1e-12, atol=1e-9)
        ts, js = ts_new, js_new
        _leaves_close(ts, js, rtol=1e-12, atol=1e-10, what=f"state tick {k}")


def test_vnorm_falls_back_to_up():
    a = _t([[0.0, 0.0, 0.0], [1e-12, 0.0, 0.0], [3.0, 0.0, 4.0]])
    np.testing.assert_allclose(tmel._vnorm(a).numpy(),
                               np.asarray(jmel._vnorm(jnp.asarray(a.numpy()))), atol=0)


def _mission_legs(pkg):
    init = np.array([[0.3, -0.2, 0.0], [0.0, 0.5, 0.1], [1.0, 1.0, 0.05]])
    legs = [
        {"pos": init + np.array([0.0, 0.0, 0.5]), "duration": 2.0, "hold": [0.5, 0.0, 1.5]},
        {"pos": np.array([1.0, 0.5, 0.8]), "yaw": 0.9, "duration": 3.0},
        {"pos": None, "yaw": -0.4, "duration": [1.0, 2.0, 0.0005], "hold": 0.25},
        {"pos": init * np.array([1, 1, 0]) + 0.05, "duration": 2.5},
    ]
    if pkg == "torch":
        return tcom.plan_mission(init, [0.1, 0.0, -0.2], legs, dtype=F64, device=CPU)
    return jcom.plan_mission(init, np.array([0.1, 0.0, -0.2]), legs, dtype=jnp.float64)


def test_plan_mission_leg_for_leg_and_setpoints():
    """Mixed-batch holds, kept yaw and position, a floored duration: every
    leg leaf equal, then the setpoints on a time grid through every leg at
    1e-12, and mission_finished."""
    got, want = _mission_legs("torch"), _mission_legs("jax")
    _leaves_close(got, want, rtol=0, atol=0, what="legs")
    assert got.t0.shape == (3, 6)
    for t in np.arange(-0.5, 13.0, 0.0625):
        _leaves_close(tcom.mission_setpoint(got, t), jcom.mission_setpoint(want, t),
                      rtol=1e-12, atol=1e-12, what=f"t={t}")
    ts = np.array([0.7, 4.1, 9.0])
    _leaves_close(tcom.mission_setpoint(got, _t(ts)), jcom.mission_setpoint(want, ts),
                  rtol=1e-12, atol=1e-12, what="per-drone t")
    for t in (7.0, 11.0, 12.5, 20.0):
        np.testing.assert_array_equal(tcom.mission_finished(got, t).numpy(),
                                      np.asarray(jcom.mission_finished(want, t)))


def test_mixed_batch_hold_does_not_shift_zero_hold_drones():
    """tests/test_commander_jax.py:177's case on the port."""
    legs = tcom.plan_mission(np.zeros((2, 3)), np.zeros(2), [
        {"pos": np.array([[0, 0, 1.0], [0, 0, 1.0]]), "duration": 2.0,
         "hold": np.array([5.0, 0.0])},
        {"pos": np.array([[1.0, 0, 1.0], [1.0, 0, 1.0]]), "duration": 2.0},
    ], device=CPU)
    sp = tcom.mission_setpoint(legs, 3.0)
    np.testing.assert_allclose(sp["pos"][0].numpy(), [0, 0, 1.0], atol=1e-6)
    np.testing.assert_allclose(sp["vel"][0].numpy(), 0.0, atol=1e-6)
    assert 0.2 < float(sp["pos"][1, 0]) < 0.8
    sp4 = tcom.mission_setpoint(legs, 4.0)
    np.testing.assert_allclose(sp4["pos"][1].numpy(), [1.0, 0, 1.0], atol=1e-5)
    np.testing.assert_allclose(sp4["pos"][0].numpy(), [0, 0, 1.0], atol=1e-6)


def test_septic_blend_matches_jax():
    tau = np.linspace(-0.1, 1.1, 97)
    for a, b in zip(tcom.septic_blend(_t(tau)), jcom.septic_blend(jnp.asarray(tau))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Fleets through the env step (float32): port against JAX over 1 s (500
# ticks), then the JAX tests' gates over their full length on the port.
# Limits over the first second (XLA's CPU backend contracts multiply-adds
# into FMAs, so float32 trajectories part by rounding): positions 1e-4 m,
# velocities 1e-3 m/s, quaternions 1e-4 (tests/test_soa.py:52-59's are
# 1e-3, 2e-3, 1e-3).
# ---------------------------------------------------------------------------

FLEET_LIMITS = dict(pos=1e-4, vel=1e-3, quat=1e-4)


def _fleet_cfg(pkg, n):
    mod = tbase if pkg == "torch" else jbase
    return mod.AviaryConfig(num_drones=n, task=mod.TASK_CTRL, pyb_freq=500, ctrl_freq=500,
                            action_buffer_size=0, dtype="float32")


def _mission_case(n=4):
    starts = np.array([[0.3 * i, 0.0, 0.06] for i in range(n)], np.float32)
    corners = starts + np.array([[0.4, 0.4, 0.44], [-0.4, 0.4, 0.44],
                                 [0.4, -0.4, 0.44], [-0.4, -0.4, 0.44]], np.float32)
    lands = corners * np.array([1.0, 1.0, 0.0], np.float32) + np.array([0.0, 0.0, 0.08],
                                                                       np.float32)
    legs = [{"pos": starts + np.array([0, 0, 0.44], np.float32), "duration": 2.0, "hold": 0.5},
            {"pos": corners, "duration": 2.0, "hold": 0.5},
            {"pos": lands, "duration": 2.0, "hold": 1.0}]
    return starts, corners, lands, legs


def _torch_fleet(n, starts, ticks, setpoint):
    """The port's tick loop: the JAX test's ``tick`` on tensors."""
    cfg = _fleet_cfg("torch", n)
    params, cp = tbase.build_params(cfg, CPU), tbase.build_ctrl_params(cfg, CPU)
    state = tbase.reset(cfg, params)
    if starts is not None:
        state = state.replace(kin=state.kin.replace(pos=torch.as_tensor(starts)))
    target = torch.zeros((n, 3))
    mp, ms = tmel.mellinger_params(device=CPU), tmel.mellinger_reset((n,), device=CPU)
    dt, prev = torch.tensor(1.0 / 500.0), trpy(state.kin.quat)
    track = []
    for k in range(ticks):
        rpy = trpy(state.kin.quat)
        gyro = (rpy - prev) / dt * torch.tensor(RAD2DEG, dtype=torch.float32)
        rpm, ms = tmel.mellinger_rpm(mp, ms, state.kin.pos, state.kin.vel, state.kin.quat,
                                     gyro, **setpoint(k, dt))
        state, *_ = tbase.step(cfg, params, cp, target, state, torch.zeros((n, 4)),
                               preprocessed_rpm=rpm)
        prev = rpy
        track.append({key: getattr(state.kin, key).clone() for key in FLEET_LIMITS})
    return state, track


def _jax_fleet(n, starts, ticks, setpoint):
    cfg = _fleet_cfg("jax", n)
    params, cp = jbase.build_params(cfg), jbase.build_ctrl_params(cfg)
    state0 = jbase.reset(cfg, params)
    if starts is not None:
        state0 = state0.replace(kin=state0.kin.replace(pos=jnp.asarray(starts)))
    target = jnp.zeros((n, 3), jnp.float32)
    mp, ms0 = jmel.mellinger_params(), jmel.mellinger_reset(batch_shape=(n,))
    dt = jnp.float32(1.0 / 500.0)

    def tick(carry, k):
        state, ms, prev = carry
        rpy = jrpy(state.kin.quat)
        gyro = (rpy - prev) / dt * jnp.float32(RAD2DEG)
        rpm, ms = jmel.mellinger_rpm(mp, ms, state.kin.pos, state.kin.vel, state.kin.quat,
                                     gyro, **setpoint(k, dt))
        state, *_ = jbase.step(cfg, params, cp, target, state, jnp.zeros((n, 4), jnp.float32),
                               preprocessed_rpm=rpm)
        return (state, ms, rpy), {key: getattr(state.kin, key) for key in FLEET_LIMITS}

    _, track = jit_reference(lambda c: jax.lax.scan(tick, c, jnp.arange(ticks)))(
        (state0, ms0, jrpy(state0.kin.quat)))
    return track


def _hold_fleets(track_t, track_j):
    for k, row in enumerate(track_t):
        for key, lim in FLEET_LIMITS.items():
            np.testing.assert_allclose(row[key].numpy(), np.asarray(track_j[key][k]),
                                       rtol=0, atol=lim, err_msg=f"{key} tick {k}")


def test_fleet_mission_matches_jax_and_reaches_the_gates():
    """tests/test_commander_jax.py:102's four-drone mission on the port: the
    first second against JAX, then the corners at 4.5 s and the pads at the
    end of 4,100 ticks at the JAX test's gates."""
    n = 4
    starts, corners, lands, legs = _mission_case(n)
    tlegs = tcom.plan_mission(starts, np.zeros(n, np.float32), legs, device=CPU)
    jlegs = jcom.plan_mission(starts, np.zeros(n, np.float32), legs)

    def setpoint(legs_, pkg):
        lib, xp = (tcom, torch) if pkg == "torch" else (jcom, jnp)

        def sp_of(k, dt):
            t = (k.astype(jnp.float32) if pkg == "jax" else torch.tensor(k, dtype=torch.float32)) \
                * dt
            sp = lib.mission_setpoint(legs_, xp.broadcast_to(t, (n,)))
            z = xp.zeros_like(sp["yaw_rate"])
            return dict(sp_pos=sp["pos"], sp_vel=sp["vel"], sp_acc=sp["acc"], sp_quat=sp["quat"],
                        sp_rate_deg=xp.stack([z, z, sp["yaw_rate"] * RAD2DEG], -1))
        return sp_of

    track_j = _jax_fleet(n, starts, 500, setpoint(jlegs, "jax"))
    state, track = _torch_fleet(n, starts, 4100, setpoint(tlegs, "torch"))
    _hold_fleets(track[:500], track_j)
    mid = track[int(4.5 * 500) - 1]["pos"].numpy()
    assert np.all(np.abs(mid[:, :2] - corners[:, :2]) < 0.06), mid
    assert np.all(np.abs(mid[:, 2] - corners[:, 2]) < 0.12), mid
    final = state.kin.pos.numpy()
    assert np.all(np.abs(final[:, :2] - lands[:, :2]) < 0.06), final
    assert np.all(np.abs(final[:, 2] - lands[:, 2]) < 0.15), final


def test_mellinger_fleet_hover_matches_jax_and_holds():
    """tests/test_mellinger_jax.py:154's staggered fleet hover on the port:
    the first second against JAX, then its gates after 2,500 ticks."""
    n = 4
    xy = tbase.reset(_fleet_cfg("torch", n), tbase.build_params(_fleet_cfg("torch", n), CPU)) \
        .kin.pos[:, :2].numpy()
    sp_pos = np.concatenate([xy, (0.4 + 0.15 * np.arange(n, dtype=np.float32))[:, None]], 1)
    track_j = _jax_fleet(n, None, 500, lambda k, dt: dict(sp_pos=jnp.asarray(sp_pos)))
    state, track = _torch_fleet(n, None, 2500, lambda k, dt: dict(sp_pos=torch.as_tensor(sp_pos)))
    _hold_fleets(track[:500], track_j)
    pos, vel = state.kin.pos.numpy(), state.kin.vel.numpy()
    err = pos - sp_pos
    assert np.all(np.abs(err[:, :2]) < 0.05), err
    assert np.all(np.abs(err[:, 2]) < 0.15), err
    assert np.all(np.abs(vel) < 0.05), vel
    assert np.all(np.diff(pos[:, 2]) > 0.10), pos[:, 2]


# ---------------------------------------------------------------------------
# The stateful shells (float32 in both packages)
# ---------------------------------------------------------------------------

SHELL_RTOL, SHELL_ATOL = 1e-5, 1e-3  # float32 shells; RPMs are ~1e4


def _state20(rng):
    s = np.zeros(20)
    s[0:3] = rng.uniform(-0.5, 0.5, 3) + [0, 0, 1.0]
    s[3:7] = Rotation.from_euler("xyz", rng.uniform(-0.3, 0.3, 3)).as_quat()
    s[10:13] = rng.uniform(-0.5, 0.5, 3)
    s[13:16] = rng.uniform(-1, 1, 3)
    return s


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=SHELL_RTOL, atol=SHELL_ATOL)


def test_compat_shells_match_jax():
    """DSLPIDControl, CTBRControl and MRAC over 20 calls of seeded states,
    reset included, their outputs against the JAX shells'."""
    rng = np.random.default_rng(11)
    jm = JDroneModel.CF2X
    pairs = [(tcompat.DSLPIDControl(DroneModel.CF2X, device=CPU), jcompat.DSLPIDControl(jm)),
             (tcompat.CTBRControl(DroneModel.CF2X, device=CPU), jcompat.CTBRControl(jm)),
             (tcompat.MRAC(DroneModel.CF2X, device=CPU), jcompat.MRAC(jm))]
    for k in range(20):
        s = _state20(rng)
        target = s[0:3] + rng.uniform(-0.2, 0.2, 3)
        kw = dict(target_rpy=rng.uniform(-0.1, 0.1, 3), target_vel=rng.uniform(-0.1, 0.1, 3))
        for t_ctl, j_ctl in pairs:
            got = t_ctl.computeControlFromState(1 / 48, s, target, **kw)
            want = j_ctl.computeControlFromState(1 / 48, s, target, **kw)
            for a, b in zip(got, want):
                _close(a, b)
            assert t_ctl.control_counter == j_ctl.control_counter == (k % 10) + 1
        if k == 9:
            for t_ctl, j_ctl in pairs:
                t_ctl.reset()
                j_ctl.reset()
    assert isinstance(pairs[0][0].computeControlFromState(1 / 48, s, target)[2], float)


def test_dslpid_shell_gains_loops_and_urdf_match_jax():
    """setPIDCoefficients, the split position and attitude loops,
    _one23DInterface and every _getURDFParameter name, against JAX."""
    t_ctl = tcompat.DSLPIDControl(DroneModel.CF2X, device=CPU)
    j_ctl = jcompat.DSLPIDControl(JDroneModel.CF2X)
    for c in (t_ctl, j_ctl):
        c.setPIDCoefficients(p_coeff_pos=np.array([4.0, 4.0, 12.5]),
                             d_coeff_att=np.array([2e4, 2e4, 1e4]))
    _close(t_ctl.P_COEFF_FOR, [4.0, 4.0, 12.5])
    _close(t_ctl.I_COEFF_FOR, j_ctl.I_COEFF_FOR)
    _close(t_ctl.D_COEFF_TOR, j_ctl.D_COEFF_TOR)
    rng = np.random.default_rng(2)
    for _ in range(5):
        s = _state20(rng)
        target = s[0:3] + rng.uniform(-0.3, 0.3, 3)
        outs = []
        for c in (t_ctl, j_ctl):
            thrust, euler, pos_e = c._dslPIDPositionControl(
                1 / 48, s[0:3], s[3:7], s[10:13], target, np.zeros(3), np.zeros(3))
            rpm = c._dslPIDAttitudeControl(1 / 48, thrust, s[3:7], euler, np.zeros(3))
            outs.append((thrust, euler, pos_e, rpm))
        for a, b in zip(*outs):
            _close(a, b)
    for thrust in ([0.27], [0.1, 0.2], [0.05, 0.06, 0.07, 0.08], 0.2):
        _close(t_ctl._one23DInterface(thrust), j_ctl._one23DInterface(thrust))
    names = ("m", "ixx", "iyy", "izz", "arm", "thrust2weight", "kf", "km", "max_speed_kmh",
             "gnd_eff_coeff", "prop_radius", "drag_coeff_xy", "drag_coeff_z", "dw_coeff_1",
             "dw_coeff_2", "dw_coeff_3", "length", "radius", "collision_z_offset")
    for model in DroneModel:
        t_c = tcompat.CTBRControl(model, device=CPU)
        j_c = jcompat.CTBRControl(JDroneModel(model.value))
        for name in names:
            assert t_c._getURDFParameter(name) == j_c._getURDFParameter(name), (model, name)
        assert t_c.GRAVITY == j_c.GRAVITY and t_c.KF == j_c.KF and t_c.KM == j_c.KM
        with pytest.raises(SystemExit):
            t_c.setPIDCoefficients(p_coeff_pos=[1, 1, 1])
    with pytest.raises(KeyError):
        t_ctl._getURDFParameter("nonsense")


def test_mrac_shell_compute_k_and_reset_match_jax():
    t_m, j_m = tcompat.MRAC(DroneModel.CF2X, device=CPU), jcompat.MRAC(JDroneModel.CF2X)
    for psi in (0.0, 0.4):
        for a, b in zip(t_m._compute_K(psi), j_m._compute_K(psi)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        for name in ("Am", "Bm", "P", "Kr_ref_gain", "Gamma_x", "Gamma_r"):
            np.testing.assert_allclose(getattr(t_m, name), getattr(j_m, name), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    s = _state20(np.random.default_rng(4))
    for _ in range(3):
        t_m.computeControlFromState(1 / 120, s, [0, 0, 1.0])
    kx = t_m.state.Kx.clone()
    t_m.reset()
    # the adapted gains persist, Xm re-snaps on the next call
    assert torch.equal(t_m.state.Kx, kx) and not bool(t_m.state.initialized)
    assert t_m.control_counter == 0
