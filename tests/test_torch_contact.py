"""The port's sequential-impulse solver (core/contact.py) against the JAX
package in float64: every pair regime of solve_contacts at 1e-12, the two
candidate sets index for index (exact distance ties included), the binned
solve equal to the dense one, and the four impulse goldens through the
port's step_physics at < 1e-11 (tests/test_contact.py's budgets)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gym_pybullet_drones_tpu.core import collisions as jcol
from gym_pybullet_drones_tpu.core import contact as jcon
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu_torch.core import collisions as tcol
from gym_pybullet_drones_tpu_torch.core import contact as tcon
from gym_pybullet_drones_tpu_torch.core import dynamics as tdyn
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.core.rotations import euler_xyz_to_quat
from gym_pybullet_drones_tpu_torch.envs.spec import Physics
from torch_parity import jit_reference

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F64 = torch.float64
DT = 1.0 / 240.0
R_COLL = 0.06  # cf2x.urdf:31-36


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _params():
    return jax_drone_params(dtype=jnp.float64), drone_params(dtype=F64, device="cpu")


def _bodies(rng, pos):
    n = pos.shape[:-1]
    quat = Rotation.from_euler("xyz", rng.uniform(-0.6, 0.6, (int(np.prod(n)), 3))).as_quat()
    return (pos, quat.reshape(n + (4,)), rng.normal(0, 0.6, n + (3,)),
            rng.normal(0, 2.0, n + (3,)))


def _ground_cloud(rng, n, batch=(), pitch=0.08):
    """Drones about ``pitch`` apart and within 2 cm of the plane (tilted and
    moving, so their rims touch it): plane, pair and friction rows all live."""
    side = pitch * max(n, 2) ** (1 / 3)
    pos = rng.uniform(0.0, side, batch + (n, 3))
    pos[..., 2] = rng.uniform(0.0, 0.02, batch + (n,))
    return pos


def _regime(name, rng):
    """(state arrays, solver keywords for JAX, for the port)."""
    if name == "plane":
        return _bodies(rng, _ground_cloud(rng, 6)), {}, {}
    if name == "obstacles":
        # Beside and on top of every RL landmark: box faces and edges, spheres.
        pos = np.array([[1.0, 0.0, 0.17], [0.93, 0.06, 0.1], [0.0, 1.08, 0.14],
                        [-1.17, 0.02, 0.1], [0.1, -1.2, 0.1], [0.0, 0.0, 0.01]])
        jkw = dict(obstacles=jcol.rl_obstacles(jnp.float64))
        return _bodies(rng, pos), jkw, dict(obstacles=tcol.rl_obstacles(F64, "cpu"))
    if name == "exact_pairs":
        return _bodies(rng, _ground_cloud(rng, 9)), dict(drone_drone=True), dict(drone_drone=True)
    if name == "exact_pairs_batched":
        pos = _ground_cloud(rng, 4, (3,))
        return _bodies(rng, pos), dict(drone_drone=True), dict(drone_drone=True)
    if name in ("neighbor", "neighbor_candidates"):
        arrays = _bodies(rng, _ground_cloud(rng, 40))
        kw = dict(drone_drone=True)
        if name == "neighbor":
            return arrays, kw, kw
        j = jcon.build_pair_candidates(jnp.asarray(arrays[0]), R_COLL)
        t = tcon.build_pair_candidates(_t(arrays[0]), R_COLL)
        return arrays, dict(kw, pair_candidates=j), dict(kw, pair_candidates=t)
    if name == "jacobi_batched":  # a leading axis that is not an env axis
        # Sparser: the Jacobi pass sums every overlap of a pile at once.
        pos = _ground_cloud(rng, 20, (2,), pitch=0.16)
        return _bodies(rng, pos), dict(drone_drone=True), dict(drone_drone=True)
    assert name == "other_pos"
    other = _ground_cloud(rng, 7) + [0.05, 0.0, 0.0]
    ovel = rng.normal(0, 0.5, other.shape)
    return (_bodies(rng, _ground_cloud(rng, 5)),
            dict(drone_drone=True, other_pos=jnp.asarray(other), other_vel=jnp.asarray(ovel)),
            dict(drone_drone=True, other_pos=_t(other), other_vel=_t(ovel)))


REGIMES = ["plane", "obstacles", "exact_pairs", "exact_pairs_batched", "neighbor",
           "neighbor_candidates", "jacobi_batched", "other_pos"]


@pytest.mark.parametrize("regime", REGIMES)
def test_solve_contacts_matches_jax(regime):
    """One solve (10 Gauss-Seidel iterations) in each row regime, at 1e-12."""
    arrays, jkw, tkw = _regime(regime, np.random.RandomState(REGIMES.index(regime)))
    jp, tp = _params()
    solve = jit_reference(lambda a: jcon.solve_contacts(*a, jp, DT, **jkw))
    jv, jw = solve(tuple(jnp.asarray(a) for a in arrays))
    tv, tw = tcon.solve_contacts(*(_t(a) for a in arrays), tp, DT, **tkw)
    assert np.abs(tv.numpy() - arrays[2]).max() > 1e-2  # the rows acted
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-12)


def test_solver_batched_matches_unbatched():
    """tests/test_contact.py:139 on the port: a leading batch axis gives each
    item's own result."""
    _, tp = _params()
    rng = np.random.default_rng(0)
    pos = rng.uniform(-0.1, 0.1, (3, 2, 3))
    pos[..., 2] = rng.uniform(0.0, 0.05, (3, 2))
    quat = euler_xyz_to_quat(_t(rng.uniform(-0.3, 0.3, (3, 2, 3))))
    vel, ang_v = _t(rng.normal(0.0, 0.5, (3, 2, 3))), _t(rng.normal(0.0, 1.0, (3, 2, 3)))
    vb, wb = tcon.solve_contacts(_t(pos), quat, vel, ang_v, tp, DT, drone_drone=True)
    for b in range(3):
        v1, w1 = tcon.solve_contacts(_t(pos[b]), quat[b], vel[b], ang_v[b], tp, DT,
                                     drone_drone=True)
        np.testing.assert_allclose(vb[b].numpy(), v1.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(wb[b].numpy(), w1.numpy(), rtol=0, atol=1e-12)


def _lattice(kind):
    if kind == "jittered":
        # tests/test_contact.py:511-553's clustered fleet: half of it 7 cm
        # rms off the other half, hundreds of pairs in band.
        rng = np.random.RandomState(3)
        centers = rng.uniform(0, 40, (1024, 3)) + [0, 0, 2]
        return np.concatenate([centers, centers + rng.normal(0, 0.07, centers.shape)])
    # A 3-D lattice of pitch 1/8 m: every distance is exact, so each drone's
    # six face neighbors tie at 0.125 m and its twelve edge neighbors at
    # 0.177 m, and K = 8 cuts through the second tie.
    g = np.stack(np.meshgrid(*(np.arange(k) for k in (9, 8, 5)), indexing="ij"), -1)
    return g.reshape(-1, 3) * 0.125 + [3.0, -2.0, 1.0]


@pytest.mark.parametrize("cands", ["dense", "binned"])
@pytest.mark.parametrize("kind", ["jittered", "lattice"])
def test_candidate_sets_match_jax(cands, kind):
    """idx and in_band equal to the JAX package's element for element."""
    pos = _lattice(kind)
    name = "build_pair_candidates" + ("_binned" if cands == "binned" else "")
    ji, jb = jit_reference(lambda p: getattr(jcon, name)(p, R_COLL))(jnp.asarray(pos))
    ti, tb = getattr(tcon, name)(_t(pos), R_COLL)
    assert int(np.asarray(jb).sum()) > pos.shape[0] // 2  # the band holds partners
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_binned_solve_equals_dense_solve():
    """tests/test_contact.py:511-553 on the port: the in-band rows of the two
    two candidate sets agree slot for slot and the solves agree bit for bit."""
    _, tp = _params()
    pos = _lattice("jittered")
    rng = np.random.RandomState(3)
    quat = _t(Rotation.from_euler("xyz", rng.uniform(-1, 1, (2048, 3))).as_quat())
    vel, ang = _t(rng.normal(0, 1.0, (2048, 3))), _t(rng.normal(0, 2.0, (2048, 3)))
    di, db = tcon.build_pair_candidates(_t(pos), R_COLL)
    bi, bb = tcon.build_pair_candidates_binned(_t(pos), R_COLL)
    np.testing.assert_array_equal(db.numpy(), bb.numpy())
    np.testing.assert_array_equal(np.where(db, di, -1), np.where(bb, bi, -1))
    v_d, w_d = tcon.solve_contacts(_t(pos), quat, vel, ang, tp, DT, drone_drone=True,
                                   pair_candidates=(di, db))
    v_b, w_b = tcon.solve_contacts(_t(pos), quat, vel, ang, tp, DT, drone_drone=True,
                                   pair_candidates=(bi, bb))
    assert np.abs(v_d.numpy() - vel.numpy()).max() > 1e-2
    assert torch.equal(v_d, v_b) and torch.equal(w_d, w_b)


def test_partner_impulses_add_in_owner_order():
    """The neighbor rows' scatter adds a partner's impulses in owner order on
    the CPU, as XLA's scatter does, also past the size (32,768 updates) at
    which the CPU's accumulating index_put_ goes parallel and loses it."""
    rng = np.random.RandomState(4)
    x = rng.normal(size=(50_000, 6)).astype(np.float32)
    index = rng.randint(0, 2_000, 200_000)
    src = rng.normal(scale=1e3, size=(200_000, 6)).astype(np.float32)
    want = x.copy()
    np.add.at(want, index, src)  # unbuffered, in the order of the updates
    got = torch.as_tensor(x.copy())
    tcon._scatter_add(got, torch.as_tensor(index), torch.as_tensor(src))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,physics,drone_drone", [
    ("tumble_pyb", "PYB", False), ("slide_pyb", "PYB", False),
    ("collide2_pyb", "PYB", True), ("land_gnd_pyb", "PYB_GND", False)])
def test_impulse_golden_through_port(name, physics, drone_drone):
    """tests/test_contact.py:209-223,294-315: the float64 oracle's impulse
    trajectories, pos (and vel where recorded) at < 1e-11 every step."""
    g = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    _, tp = _params()
    n = g["init_xyzs"].shape[0]
    kin = tdyn.init_kin_state(_t(g["init_xyzs"]), euler_xyz_to_quat(_t(g["init_rpys"])))
    kin = kin.replace(vel=_t(g["init_vel"]))
    last = torch.zeros((n, 4), dtype=F64)
    err = 0.0
    for t in range(g["pos"].shape[0]):
        kin, last = tdyn.step_physics(kin, _t(g["rpm"][t]), last, tp, DT, 5, Physics[physics],
                                      contact_mode="impulse", collisions=drone_drone)
        err = max(err, float((kin.pos - _t(g["pos"][t])).abs().max()))
        if "vel" in g.files:
            err = max(err, float((kin.vel - _t(g["vel"][t])).abs().max()))
    assert err < 1e-11, err
    if name == "land_gnd_pyb":  # landed and held on the plane by the solver
        assert abs(float(kin.pos[0, 2]) - 0.0115) < 1e-3
