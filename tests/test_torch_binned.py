"""The port's binned swarm backend (ops/swarm_binned.py) on the CPU against
the JAX package's (Pallas in interpret mode) and against the port's own SoA
step, on tests/test_soa.py:568-601's reorder-robust fleets: the 2 m lattice
with +-0.4 m jitter without contact, the co-planar contact layer with it.

Tolerances are tests/test_soa.py:623-628's over 3 control steps (the binned
passes reorder the float32 pair sums): pos 1e-4, vel 1e-3, quat 1e-5. The
landed-drone case holds pos and vel at 1e-6 and the lateral position
exactly (:680-684). Geometry and layout checks are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core import dynamics as jdyn
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.ops import swarm_binned as jbin
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.ops import swarm_binned as tbin
from gym_pybullet_drones_tpu_torch.ops import swarm_soa as tswarm
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash_masked
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact_masked
from gym_pybullet_drones_tpu_torch.runtime.mesh import Mesh
from torch_parity import jit_reference

LIMITS = dict(pos=1e-4, vel=1e-3, quat=1e-5)
STEPS = 3
N = 512


def _fleet(collisions):
    rng = np.random.RandomState(11)
    g = np.stack(np.meshgrid(*[np.arange(8) * 2.0] * 3), -1).reshape(-1, 3)
    pos = (g + rng.uniform(-0.4, 0.4, g.shape) + [0, 0, 1.0]).astype(np.float32)
    vel = rng.uniform(-0.2, 0.2, (N, 3)).astype(np.float32)
    if collisions:
        base = np.stack(np.meshgrid(np.arange(16) * 0.5, np.arange(16) * 0.5), -1).reshape(-1, 2)
        xy = np.concatenate([base, base + [0.1, 0.0]], axis=0)
        pos = np.concatenate([xy, np.full((N, 1), 1.0)], 1).astype(np.float32)
        vel = rng.uniform(-0.2, 0.2, (N, 3)).astype(np.float32)
        vel[:, 2] = 0.0
    return _kin_dict(pos, vel)


def _kin_dict(pos, vel=None):
    n = pos.shape[0]
    zeros = np.zeros((n, 3), np.float32)
    quat = np.tile(np.array([[0.0, 0.0, 0.0, 1.0]], np.float32), (n, 1))
    return dict(pos=pos, quat=quat, vel=zeros if vel is None else vel, ang_v=zeros,
                rpy_rates=zeros)


def _jkin(d):
    return jdyn.KinState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tkin(d):
    return convert.kin_state_from_numpy(d, device="cpu")


def _run_jax(d, collisions, rpm, steps, **kw):
    jp = jax_drone_params()
    init, step, export = jbin.make_binned_swarm(jp, 1 / 240, 5, collisions=collisions,
                                                interpret=True, resort_every=2, **kw)
    cols = [jnp.full((d["pos"].shape[0],), rpm, jnp.float32)] * 4
    s = jit_reference(init)(_jkin(d))
    jstep = jit_reference(step)
    for _ in range(steps):
        s = jstep(s, cols)
    return export(s, _jkin(d))


def _run_port(d, collisions, rpm, steps, **kw):
    tp = drone_params(device="cpu")
    init, step, export = tbin.make_binned_swarm(tp, 1 / 240, 5, collisions=collisions,
                                                resort_every=2, device="cpu", **kw)
    cols = [torch.full((d["pos"].shape[0],), rpm)] * 4
    s = init(_tkin(d))
    for _ in range(steps):
        s = step(s, cols)
    return export(s, _tkin(d)), s


def _run_soa(d, collisions, rpm, steps):
    tp = drone_params(device="cpu")
    step = tswarm.make_swarm_step_soa(tp, 1 / 240, 5, collisions=collisions, device="cpu")
    cols = [torch.full((d["pos"].shape[0],), rpm)] * 4
    s = tswarm.swarm_soa_from_kin(_tkin(d))
    for _ in range(steps):
        s = step(s, cols)
    return tswarm.swarm_soa_to_kin(s, _tkin(d))


def _close(got, want, limits=LIMITS):
    for k, tol in limits.items():
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=tol, err_msg=k)


def _auto_geometry():
    cell, nx, ny, cap = tbin.binned_geometry(_fleet(False)["pos"], occ_target=64)
    return dict(cell_size=cell, nx=nx, ny=ny, cap=cap)


# tests/test_soa.py:595-601: comfortable capacity from the fleet's own
# geometry; source tiles smaller than the cell; contact; and a forced layout
# overflow (1 m cells clipped to 3 x 3: an edge cell holds more than 128).
ARMS = {
    "auto_geometry": (False, _auto_geometry),
    "bs_below_cap": (False, lambda: {**_auto_geometry(), "cap": 256, "bs": 128}),
    "contact": (True, lambda: dict(cell_size=3.0, nx=4, ny=4, cap=256)),
    "layout_overflow": (True, lambda: dict(cell_size=1.0, nx=3, ny=3, cap=128)),
    # The port's own fifth arm: one live tile a row is too few, so every pass
    # takes the overflow branch (the z-sorted K2). Held against the SoA step.
    "pass_overflow": (False, lambda: {**_auto_geometry(), "neighbor_cap": 1}),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_binned_swarm_matches_jax_and_soa_step(arm):
    collisions, geometry = ARMS[arm]
    kw, d = geometry(), _fleet(collisions)
    hover = float(drone_params(device="cpu").hover_rpm)
    overflows = (make_downwash_masked.overflows, make_interact_masked.overflows)
    got, s = _run_port(d, collisions, hover, STEPS, **kw)
    overflows = (make_downwash_masked.overflows - overflows[0],
                 make_interact_masked.overflows - overflows[1])
    if collisions:  # contacts fired
        assert np.abs(got.pos.numpy()[:, :2] - d["pos"][:, :2]).max() > 1e-4
    if arm != "pass_overflow":
        _close(got, _run_jax(d, collisions, hover, STEPS, **kw))
    _close(got, _run_soa(d, collisions, hover, STEPS))
    # The dense layout of an overflowing rebin fills the first N slots.
    packed = bool(s["valid"][:N].all()) and not bool(s["valid"][N:].any())
    assert packed == (arm == "layout_overflow")
    # One wake pass at init, then five a control step.
    assert overflows == ((1 + 5 * STEPS, 0) if arm == "pass_overflow" else (0, 0))
    assert s["t"] == STEPS and int(s["valid"].sum()) == N


def test_binned_padding_never_phantoms_landed_drones():
    """tests/test_soa.py:631-684: the substep's ground clamp snaps padding
    rows to (0, 0, z_min); were the pair pass to run before the padding
    freeze, a real drone landed within min_dist of the origin would be pushed
    by phantoms. It must rest exactly in place and match the dense SoA path."""
    tp = drone_params(device="cpu")
    z_min = float(tp.collision_h) / 2.0 - float(tp.collision_z_offset)
    pos = np.array([[0.04, 0.02, z_min]] + [[20.0 + i * 2.0, 20.0, 1.0] for i in range(7)],
                   np.float32)
    d = _kin_dict(pos)
    kw = dict(cell_size=10.0, nx=3, ny=3, cap=128)
    got, s = _run_port(d, True, 0.0, 4, **kw)  # motors off: resting
    assert int((~s["valid"]).sum()) == 9 * 128 - 8
    np.testing.assert_array_equal(got.pos.numpy()[0, :2], pos[0, :2])
    exact = dict(pos=1e-6, vel=1e-6)
    _close(got, _run_soa(d, True, 0.0, 4), exact)


def _lattice(n, pitch, seed=0):
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1 / 3))) + 1
    g = np.stack(np.meshgrid(*[np.arange(side) * pitch] * 3), -1).reshape(-1, 3)[:n]
    return (g + rng.uniform(-0.2 * pitch, 0.2 * pitch, g.shape) + [0, 0, 1.0]).astype(np.float32)


@pytest.mark.parametrize("fleet,kw", [
    ("lattice_2m", dict(occ_target=64)), ("lattice_4096", {}), ("coplanar", dict(cell=3.0)),
    ("lattice_4096", dict(cell=25.0, headroom=1.5, max_cap=512))])
def test_binned_geometry_matches_jax(fleet, kw):
    pos = {"lattice_2m": lambda: _fleet(False)["pos"], "coplanar": lambda: _fleet(True)["pos"],
           "lattice_4096": lambda: _lattice(4096, 3.0)}[fleet]()
    want = jbin.binned_geometry(pos, **kw)
    got = tbin.binned_geometry(pos, **kw)
    assert got == want and [type(g) for g in got] == [float, int, int, int]
    assert got == tbin.binned_geometry(torch.as_tensor(pos), **kw)
    assert got[3] % 128 == 0 and got[1] * got[2] * got[3] >= pos.shape[0]


@pytest.mark.parametrize("arm", ["auto_geometry", "layout_overflow"])
def test_binned_layout_and_export(arm):
    """init lays each cell's drones into its block sorted by z, padding
    behind them (or, on overflow, the whole fleet into the first N slots);
    export returns every drone once, in the original order, bit for bit."""
    collisions, geometry = ARMS[arm]
    kw, d = geometry(), _fleet(collisions)
    tp = drone_params(device="cpu")
    init, _, export = tbin.make_binned_swarm(tp, 1 / 240, 5, device="cpu", **kw)
    kin = _tkin(d)
    s = init(kin)
    ids, valid = s["ids"].numpy(), s["valid"].numpy()
    assert ids.dtype == np.int64 and ids.shape == (kw["nx"] * kw["ny"] * kw["cap"],)
    np.testing.assert_array_equal(np.sort(ids[valid]), np.arange(N))
    assert (ids[~valid] == N).all() and s["t"] == 0
    assert (s["pz"].numpy()[~valid] == np.float32(-1e9)).all()
    assert (s["qw"].numpy()[~valid] == 1).all() and (s["mag"].numpy()[~valid] == 0).all()
    back = export(s, kin)
    for k in ("pos", "quat", "vel", "ang_v"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), d[k])
    if arm == "layout_overflow":
        assert valid[:N].all() and not valid[N:].any()
        return
    blocks = valid.reshape(-1, kw["cap"])
    counts = blocks.sum(1)
    assert counts.max() <= kw["cap"] and (counts > 0).sum() > 1
    for b, (row, cnt) in enumerate(zip(blocks, counts)):
        assert row[:cnt].all() and not row[cnt:].any()  # real slots first
        z = s["pz"].numpy()[b * kw["cap"]:b * kw["cap"] + cnt]
        assert (np.diff(z) >= 0).all()  # sorted by z within the cell
    cx = np.floor((d["pos"][:, 0] - d["pos"][:, 0].min()) / np.float32(kw["cell_size"]))
    cy = np.floor((d["pos"][:, 1] - d["pos"][:, 1].min()) / np.float32(kw["cell_size"]))
    cell = (np.clip(cx, 0, kw["nx"] - 1) * kw["ny"] + np.clip(cy, 0, kw["ny"] - 1)).astype(int)
    np.testing.assert_array_equal(np.nonzero(valid)[0] // kw["cap"], cell[ids[valid]])


def test_binned_swarm_rejects_what_it_does_not_take():
    tp = drone_params(device="cpu")
    three = Mesh(group=None, rank=0, size=3)
    with pytest.raises(ValueError, match="8x8 must divide over the 3 ranks"):
        tbin.make_binned_swarm(tp, 1 / 240, 5, mesh=three, device="cpu")
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        tbin.shard_binned_state(three, {"px": torch.zeros(256), "t": 0})
    init, step, _ = tbin.make_binned_swarm(tp, 1 / 240, 5, nx=1, ny=1, cap=128, device="cpu")
    with pytest.raises(ValueError, match="too small"):
        init(_tkin(_fleet(False)))
    with pytest.raises(ValueError, match="built for cpu"):
        step({"px": torch.zeros(128, device="meta")}, [torch.zeros(4, device="meta")] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbin.make_binned_swarm(tp, 1 / 240, 5)
