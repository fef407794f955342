"""The port's coupled swarm (ops/swarm_soa.py, runtime/swarm.py) on the CPU:
the SoA step against the JAX package's (Pallas in interpret mode) for one
control step, make_big_swarm_physics against the SoA step, the persistently
sorted loop against the JAX package's and against the SoA step, the backend
rule and the factory. Tolerances are tests/test_soa.py:187-196's: pos 1e-5,
vel 1e-4, quat 1e-6, ang_v 1e-4, rpy_rates 1e-4 (float32); for the sorted
loop over 3 control steps, which reorders the pair sums, :347-352's: pos
1e-4, vel 1e-3, quat 1e-5, on the reorder-robust fleets (the 2 m lattice with
+-0.4 m jitter; the co-planar contact layer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core import dynamics as jdyn
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.ops import swarm_soa as jswarm
from gym_pybullet_drones_tpu.runtime import swarm as jrt
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.core import dynamics as tdyn
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs.spec import Physics
from gym_pybullet_drones_tpu_torch.ops import swarm_binned as tbin
from gym_pybullet_drones_tpu_torch.ops import swarm_soa as tswarm
from gym_pybullet_drones_tpu_torch.runtime import swarm as trt
from torch_parity import jit_reference

LIMITS = dict(pos=1e-5, vel=1e-4, quat=1e-6, ang_v=1e-4, rpy_rates=1e-4)
KIN = tuple(LIMITS)


def _fleet(collisions):
    """tests/test_soa.py:153-177: an 8 x 8 x 8 lattice at 0.5 m with 0.1 m
    jitter (contact-free), or a co-planar layer of overlapping pairs (dz = 0
    keeps the wake off between partners) for the contact case."""
    rng = np.random.RandomState(11)
    n = 512
    g = np.stack(np.meshgrid(*[np.arange(8) * 0.5] * 3), -1).reshape(-1, 3)
    pos = (g + rng.uniform(-0.1, 0.1, g.shape) + [0, 0, 1.0]).astype(np.float32)
    vel = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    if collisions:
        base = np.stack(np.meshgrid(np.arange(16) * 0.5, np.arange(16) * 0.5), -1).reshape(-1, 2)
        xy = np.concatenate([base, base + [0.1, 0.0]], axis=0)
        pos = np.concatenate([xy, np.full((n, 1), 1.0)], 1).astype(np.float32)
        vel = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
        vel[:, 2] = 0.0
    quat = np.tile(np.array([[0.0, 0.0, 0.0, 1.0]], np.float32), (n, 1))
    zeros = np.zeros((n, 3), np.float32)
    return dict(pos=pos, quat=quat, vel=vel, ang_v=zeros, rpy_rates=zeros)


def _jkin(d):
    return jdyn.KinState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tkin(d):
    return convert.kin_state_from_numpy(d, device="cpu")


def _close(got, want):
    for k in KIN:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=LIMITS[k], err_msg=k)


def _hover_cols(params, n):
    return [torch.full((n,), float(params.hover_rpm)) for _ in range(4)]


@pytest.mark.parametrize("collisions", [False, True])
def test_swarm_step_soa_matches_jax(collisions):
    d = _fleet(collisions)
    n = d["pos"].shape[0]
    jp, tp = jax_drone_params(), drone_params(device="cpu")
    jstep = jswarm.make_swarm_step_soa(jp, 1 / 240, 5, collisions=collisions, interpret=True)
    jrpm = [jnp.full((n,), float(jp.hover_rpm), jnp.float32)] * 4
    want = jswarm.swarm_soa_to_kin(jstep(jswarm.swarm_soa_from_kin(_jkin(d)), jrpm), _jkin(d))
    tstep = tswarm.make_swarm_step_soa(tp, 1 / 240, 5, collisions=collisions, device="cpu")
    got = tswarm.swarm_soa_to_kin(tstep(tswarm.swarm_soa_from_kin(_tkin(d)), _hover_cols(tp, n)),
                                  _tkin(d))
    if collisions:  # contacts fired
        assert np.abs(got.pos.numpy()[:, :2] - d["pos"][:, :2]).max() > 1e-4
    _close(got, want)


@pytest.mark.parametrize("collisions", [False, True])
def test_big_swarm_matches_soa_step(collisions):
    """The AoS form against the SoA step, as tests/test_soa.py:179-196
    does, both in the port."""
    d = _fleet(collisions)
    n = d["pos"].shape[0]
    tp = drone_params(device="cpu")
    kin = _tkin(d)
    rpm = torch.full((n, 4), float(tp.hover_rpm))
    aos, _ = trt.make_big_swarm_physics(tp, 1 / 240, 5, Physics.PYB_DW, collisions=collisions,
                                        device="cpu")(kin, rpm, rpm)
    init, step, export = trt.make_swarm_physics(tp, 1 / 240, 5, collisions=collisions,
                                                init_pos=kin, device="cpu")
    soa = export(step(init(kin), _hover_cols(tp, n)), kin)
    for k in KIN:
        np.testing.assert_allclose(getattr(soa, k).numpy(), getattr(aos, k).numpy(), rtol=0,
                                   atol=LIMITS[k], err_msg=k)


def test_grounded_drone_under_wake_is_pressed():
    """tests/test_collisions.py:388: the pair wake must reach the resting-
    contact test in the SoA and AoS swarm steps as the dense downwash term
    does: a grounded, spinning drone with a neighbour 0.5 m above stops
    spinning. Both against the port's dense step_physics."""
    tp = drone_params(device="cpu")
    z_min = float(tp.collision_h) / 2.0 - float(tp.collision_z_offset)
    cells = 256
    gx, gy = (np.arange(cells) % 16) * 2.0, (np.arange(cells) // 16) * 2.0
    pos = np.zeros((2 * cells, 3), np.float32)
    pos[0::2] = np.stack([gx, gy, np.full(cells, z_min)], -1)
    pos[1::2] = np.stack([gx, gy, np.full(cells, z_min + 0.5)], -1)
    ang_v = np.zeros_like(pos)
    ang_v[0::2, 2] = 1.0
    kin = tdyn.init_kin_state(torch.as_tensor(pos), torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(
        2 * cells, 1)).replace(ang_v=torch.as_tensor(ang_v))
    rpm = torch.full((2 * cells, 4), float(tp.hover_rpm))
    rpm[0::2] *= 1.02
    dense, _ = tdyn.step_physics(kin, rpm, rpm, tp, 1 / 240, 5, Physics.PYB_DW)
    assert bool((dense.ang_v[0::2] == 0).all())
    big, _ = trt.make_big_swarm_physics(tp, 1 / 240, 5, device="cpu")(kin, rpm, rpm)
    step = tswarm.make_swarm_step_soa(tp, 1 / 240, 5, device="cpu")
    soa = tswarm.swarm_soa_to_kin(step(tswarm.swarm_soa_from_kin(kin),
                                       [rpm[:, m] for m in range(4)]), kin)
    for out in (big, soa):
        np.testing.assert_allclose(out.ang_v.numpy(), dense.ang_v.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out.pos.numpy(), dense.pos.numpy(), rtol=0, atol=1e-5)


def _geometry(n, pitch, seed=0):
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1 / 3))) + 1
    g = np.stack(np.meshgrid(*[np.arange(side) * pitch] * 3), -1).reshape(-1, 3)[:n]
    return (g + rng.uniform(-0.2 * pitch, 0.2 * pitch, g.shape) + [0, 0, 1.0]).astype(np.float32)


@pytest.mark.parametrize("n,pitch", [(512, 0.5), (4096, 3.0), (16384, 0.5), (16384, 3.0)])
def test_select_swarm_backend_matches_jax(n, pitch):
    pos = _geometry(n, pitch)
    want = jrt.select_swarm_backend(pos)
    assert trt.select_swarm_backend(pos) == want
    assert trt.select_swarm_backend(torch.as_tensor(pos)) == want
    kin = _tkin(dict(pos=pos, quat=np.zeros((n, 4), np.float32), vel=pos, ang_v=pos,
                     rpy_rates=pos))
    assert trt.select_swarm_backend(kin) == want
    assert trt.select_swarm_backend(None) == jrt.select_swarm_backend(None) == "soa"


def test_swarm_backends_of_later_slices_raise():
    """What is left for later: a mesh (the torch.distributed runtime, ROADMAP
    item 21). The binned and the sorted backends run."""
    tp = drone_params(device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed.*item 21"):
        trt.make_swarm_physics(tp, 1 / 240, 5, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed.*item 21"):
        trt.make_swarm_physics(tp, 1 / 240, 5, backend="binned", cell_size=10.0, nx=2, ny=2,
                               cap=128, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 21"):
        tbin.shard_binned_state(object(), {})
    with pytest.raises(ValueError, match="unknown swarm backend"):
        trt.make_swarm_physics(tp, 1 / 240, 5, backend="dense", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.make_swarm_physics(tp, 1 / 240, 5)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.make_swarm_physics(tp, 1 / 240, 5, sorted=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.make_swarm_physics(tp, 1 / 240, 5, backend="binned", init_pos=_geometry(64, 3.0))


# ---------------- the persistently sorted loop and the factory ----------------

SORTED_LIMITS = dict(pos=1e-4, vel=1e-3, quat=1e-5)


def _spread_fleet(collisions):
    """tests/test_soa.py:568-587: the 2 m lattice with +-0.4 m jitter, or the
    co-planar contact layer of ``_fleet``."""
    if collisions:
        return _fleet(True)
    rng = np.random.RandomState(11)
    g = np.stack(np.meshgrid(*[np.arange(8) * 2.0] * 3), -1).reshape(-1, 3)
    pos = (g + rng.uniform(-0.4, 0.4, g.shape) + [0, 0, 1.0]).astype(np.float32)
    return dict(_fleet(False), pos=pos)


def _run(triple, kin, rpm_cols, steps=3):
    init, step, export = triple
    s = init(kin)
    for _ in range(steps):
        s = step(s, rpm_cols)
    return export(s, kin), s


@pytest.mark.parametrize("order", ["z", "morton"])
@pytest.mark.parametrize("collisions", [False, True])
def test_sorted_swarm_matches_jax_and_soa_step(collisions, order):
    d = _spread_fleet(collisions)
    n = d["pos"].shape[0]
    jp, tp = jax_drone_params(), drone_params(device="cpu")
    jinit, jstep, jexport = jswarm.make_sorted_swarm(jp, 1 / 240, 5, collisions=collisions,
                                                     interpret=True, order=order, resort_every=2)
    jrpm = [jnp.full((n,), float(jp.hover_rpm), jnp.float32)] * 4
    want, _ = _run((jit_reference(jinit), jit_reference(jstep), jexport), _jkin(d), jrpm)
    got, s = _run(tswarm.make_sorted_swarm(tp, 1 / 240, 5, collisions=collisions, order=order,
                                           resort_every=2, device="cpu"),
                  _tkin(d), _hover_cols(tp, n))
    soa, _ = _run(trt.make_swarm_physics(tp, 1 / 240, 5, collisions=collisions, device="cpu"),
                  _tkin(d), _hover_cols(tp, n))
    if collisions:  # contacts fired
        assert np.abs(got.pos.numpy()[:, :2] - d["pos"][:, :2]).max() > 1e-4
    for ref in (want, soa):
        for k, tol in SORTED_LIMITS.items():
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                       rtol=0, atol=tol, err_msg=k)
    assert s["t"] == 3 and s["ids"].dtype == torch.int64
    np.testing.assert_array_equal(np.sort(s["ids"].numpy()), np.arange(n))


def test_sorted_swarm_init_sorts_and_export_restores():
    d = _spread_fleet(False)
    tp = drone_params(device="cpu")
    for order in ("z", "morton"):
        init, _, export = tswarm.make_sorted_swarm(tp, 1 / 240, 5, order=order, device="cpu")
        s = init(_tkin(d))
        if order == "z":
            assert bool((s["pz"][1:] >= s["pz"][:-1]).all())
        np.testing.assert_array_equal(s["px"].numpy(), d["pos"][s["ids"].numpy(), 0])
        assert float(s["mag"].abs().max()) > 0  # the carried wake is seeded
        back = export(s, _tkin(d))
        for k in ("pos", "quat", "vel", "ang_v"):
            np.testing.assert_array_equal(getattr(back, k).numpy(), d[k])


def test_sorted_swarm_neighbor_backend_matches_masked():
    """tests/test_soa.py:449-480: neighbor_cap=True equals the loop without
    compaction bit for bit over 3 control steps (same tiles, same order, same
    resort schedule), through the factory's ``sorted=True``."""
    d = _spread_fleet(False)
    n = d["pos"].shape[0]
    tp = drone_params(device="cpu")
    outs = []
    for cap in (None, True):
        triple = trt.make_swarm_physics(tp, 1 / 240, 5, collisions=True, sorted=True,
                                        order="morton", resort_every=2, neighbor_cap=cap, bt=128,
                                        bs=128, device="cpu")
        outs.append(_run(triple, _tkin(d), _hover_cols(tp, n))[0])
    for k in KIN:
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k


def test_factory_picks_binned_for_a_big_spread_fleet():
    """A 16384-drone fleet at 3 m pitch: "auto" returns the binned triple
    (build and one init only at this size), with the geometry of
    ``binned_geometry``; explicit geometry wins over it."""
    tp = drone_params(device="cpu")
    pos = _geometry(16384, 3.0)
    cell, nx, ny, cap = tbin.binned_geometry(pos)
    assert cell >= 10.0 and nx * ny * cap >= 16384
    init, step, export = trt.make_swarm_physics(tp, 1 / 240, 5, init_pos=pos, device="cpu")
    kin = tdyn.init_kin_state(torch.as_tensor(pos), torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(
        16384, 1))
    s = init(kin)
    assert s["valid"].shape == (nx * ny * cap,) and int(s["valid"].sum()) == 16384
    assert float(s["mag"].abs().max()) > 0 and s["t"] == 0
    np.testing.assert_array_equal(export(s, kin).pos.numpy(), pos)
    small = trt.make_swarm_physics(tp, 1 / 240, 5, init_pos=pos, nx=1, device="cpu")[0]
    with pytest.raises(ValueError, match=f"{ny * cap} slots < 16384 drones"):
        small(kin)


def test_factory_binned_needs_a_geometry():
    tp = drone_params(device="cpu")
    with pytest.raises(ValueError, match="binned backend needs init_pos"):
        trt.make_swarm_physics(tp, 1 / 240, 5, backend="binned", device="cpu")
    with pytest.raises(ValueError, match="binned backend needs init_pos"):
        trt.make_swarm_physics(tp, 1 / 240, 5, backend="binned", cell_size=10.0, nx=2,
                               device="cpu")
    d = _spread_fleet(False)
    n = d["pos"].shape[0]
    cell, nx, ny, cap = tbin.binned_geometry(d["pos"], occ_target=64)
    explicit = trt.make_swarm_physics(tp, 1 / 240, 5, backend="binned", cell_size=cell, nx=nx,
                                      ny=ny, cap=cap, device="cpu")
    auto = trt.make_swarm_physics(tp, 1 / 240, 5, backend="binned", init_pos=_tkin(d),
                                  occ_target=64, device="cpu")
    a, sa = _run(explicit, _tkin(d), _hover_cols(tp, n), steps=1)
    b, sb = _run(auto, _tkin(d), _hover_cols(tp, n), steps=1)
    assert sa["valid"].shape == sb["valid"].shape == (nx * ny * cap,)
    for k in KIN:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_swarm_step_names_its_device():
    tp = drone_params(device="cpu")
    step = tswarm.make_swarm_step_soa(tp, 1 / 240, 5, device="cpu")
    s = {k: torch.zeros(4, device="meta") for k in tswarm.SWARM_KEYS}
    with pytest.raises(ValueError, match="built for cpu"):
        step(s, [torch.zeros(4, device="meta")] * 4)
