"""The plain versions of the pair passes K2, K4 and K5 (ops/downwash_pairs.py,
ops/collide_pairs.py, ops/interact_pairs.py) against the JAX package's Pallas
kernels in interpret mode, square and rectangular, z-sorted and not.

Tolerances are tests/test_soa.py's: the wake at rtol 1e-4 plus atol
1e-4 * max(1, max|w|) (float32 sums in another order), positions and
velocities after the contact deltas at atol 1e-6. Also the kernels'
schedules, which are host code: the work units of K2, K4 and K5; the wake
term at float32 beta = 0, where the port deviates from the JAX package; and
the pair gates by which chip_smoke.py prices its bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core.aero import downwash_forces_body_z as jax_downwash
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.ops.collide_pallas import make_collide_pallas
from gym_pybullet_drones_tpu.ops.downwash_pallas import make_downwash_pallas
from gym_pybullet_drones_tpu.ops.interact_pallas import make_interact_pallas
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.ops import _pairs
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import make_collide
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash, wake_terms
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact

TILE = dict(bt=256, bs=256, interpret=True)


def _cloud(n=1024, seed=11):
    """tests/test_soa.py:213-220: a well-separated random cloud with
    overlapping pairs sprinkled in, so that the contact band fires."""
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(-1, 1, (n, 3)) * np.array([4, 4, 1.5]) + [0, 0, 2.0]).astype(np.float32)
    pos[1::64] = pos[0::64] + np.array([0.08, 0.0, 0.05], np.float32)
    vel = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return pos, vel


def _params():
    return jax_drone_params(), drone_params(device="cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def _wake_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("z_sort", [False, True])
@pytest.mark.parametrize("n_tgt", [1024, 256])
def test_downwash_plain_matches_pallas(z_sort, n_tgt):
    """Square (1024 x 1024) and rectangular (256 targets x 1024 sources)."""
    jp, tp = _params()
    pos, _ = _cloud()
    tgt = pos[:n_tgt] + np.float32(0.01)  # not the sources' own positions
    jdw = make_downwash_pallas(jp, z_sort=z_sort, **TILE)
    tdw = make_downwash(tp, z_sort=z_sort, device="cpu")
    if n_tgt == pos.shape[0]:
        want, got = jdw(jnp.asarray(pos)), tdw(_t(pos))
    else:
        want = jdw(jnp.asarray(tgt), src_pos=jnp.asarray(pos))
        got = tdw(_t(tgt), src_pos=_t(pos))
    assert np.abs(np.asarray(want)).max() > 0  # the wake is live
    assert got.dtype == torch.float32 and got.shape == (n_tgt,)
    _wake_close(got.numpy(), want)


@pytest.mark.parametrize("z_sort", [False, True])
@pytest.mark.parametrize("n_tgt", [1024, 256])
def test_collide_plain_matches_pallas(z_sort, n_tgt):
    jp, tp = _params()
    pos, vel = _cloud()
    jco = make_collide_pallas(jp, z_sort=z_sort, **TILE)
    tco = make_collide(tp, z_sort=z_sort, device="cpu")
    if n_tgt == pos.shape[0]:
        jpos, jvel = jco(jnp.asarray(pos), jnp.asarray(vel))
        tpos, tvel = tco(_t(pos), _t(vel))
    else:
        # Targets are the first 256 drones, partners the whole fleet: each
        # target meets itself at distance 0, which the eps mask drops.
        args = (jnp.asarray(pos[:n_tgt]), jnp.asarray(vel[:n_tgt]))
        jpos, jvel = jco(*args, src_pos=jnp.asarray(pos), src_vel=jnp.asarray(vel))
        tpos, tvel = tco(_t(pos[:n_tgt]), _t(vel[:n_tgt]), src_pos=_t(pos), src_vel=_t(vel))
    assert np.abs(tpos.numpy() - pos[:n_tgt]).max() > 0  # contacts fired
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), rtol=0, atol=1e-6)


@pytest.mark.parametrize("z_sort", [False, True])
def test_interact_plain_matches_pallas(z_sort):
    jp, tp = _params()
    pos, vel = _cloud()
    jmag, jdp, jdv = make_interact_pallas(jp, z_sort=z_sort, **TILE)(jnp.asarray(pos),
                                                                     jnp.asarray(vel))
    tmag, tdp, tdv = make_interact(tp, z_sort=z_sort, device="cpu")(_t(pos), _t(vel))
    assert np.abs(tdp.numpy()).max() > 0  # contacts fired
    _wake_close(tmag.numpy(), jmag)
    np.testing.assert_allclose(pos + tdp.numpy(), np.asarray(pos + jdp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel + tdv.numpy(), np.asarray(vel + jdv), rtol=0, atol=1e-6)


def test_interact_plain_matches_pallas_contact_active():
    """tests/test_collisions.py:295's co-planar layer of overlapping pairs
    (dz = 0 keeps the wake off between partners), with a wake-active second
    layer 0.5 m above: every drone in contact, and wakes acting."""
    jp, tp = _params()
    rng = np.random.RandomState(7)
    base = np.stack(np.meshgrid(np.arange(16) * 0.5, np.arange(16) * 0.5), -1).reshape(-1, 2)
    xy = np.concatenate([base, base + [0.1, 0.0]], axis=0)
    low = np.concatenate([xy, np.full((512, 1), 1.0)], 1)
    high = np.concatenate([base + [0.25, 0.25], np.full((256, 1), 1.5)], 1)
    pos = np.concatenate([low, high]).astype(np.float32)
    vel = rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32)
    vel[:, 2] = 0.0
    jmag, jdp, jdv = make_interact_pallas(jp, z_sort=False, **TILE)(jnp.asarray(pos),
                                                                    jnp.asarray(vel))
    tmag, tdp, tdv = make_interact(tp, z_sort=False, device="cpu")(_t(pos), _t(vel))
    assert (np.abs(tdp.numpy()[:512]).max(1) > 0).all()  # every pair in contact
    assert (tmag.numpy()[:512] < 0).all()  # and under a wake
    _wake_close(tmag.numpy(), jmag)
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), rtol=0, atol=1e-6)


def test_pair_passes_keep_dtype_and_order():
    """float64 columns come back float64; sorted runs scatter back to the
    drones' own order (the sorted and unsorted sums agree to round-off)."""
    _, tp = _params()
    pos, vel = _cloud(n=300, seed=3)
    p64, v64 = _t(pos).double(), _t(vel).double()
    mags = [make_downwash(tp, z_sort=s, device="cpu")(p64) for s in (False, True)]
    assert all(m.dtype == torch.float64 for m in mags)
    _wake_close(mags[1].numpy(), mags[0].numpy())
    deltas = [make_interact(tp, z_sort=s, device="cpu")(p64, v64) for s in (False, True)]
    for a, b in zip(deltas[0], deltas[1]):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)


def _live_tiles(nt, ns, triangle):
    """(block, tile) pairs that K2 / K5 must evaluate, by brute force: all of
    them, or under the square wake cull those whose last source index lies
    above the block's first target."""
    blocks, n_tiles = -(-nt // _pairs.BLOCK), -(-ns // _pairs.BLOCK)
    return {(b, j) for b in range(blocks) for j in range(n_tiles)
            if not triangle or min(_pairs.BLOCK * (j + 1), ns) - 1 > _pairs.BLOCK * b}


# (nt, ns, triangle): the square wake cull takes sources = targets.
UNIT_SHAPES = [(n, n, tri) for n in (1000, 4096, 4097, 16384, 65536, 257, 1) for tri in (False, True)]
UNIT_SHAPES += [(4096, 16384, False), (33, 70000, False)]


@pytest.mark.parametrize("nt,ns,triangle", UNIT_SHAPES)
def test_pair_units_cover_every_live_tile_once(nt, ns, triangle):
    """K2's, K4's and K5's work units: every live tile in exactly one unit and no
    other tile; a block's units in tile order, slots 0, 1, ... with the
    block's unit count; at most ``UNIT_SLOTS`` a block; every block has a
    unit (an empty one writes its zeros); the list is a function of the
    shapes alone."""
    units, per = _pairs.pair_units(nt, ns, triangle)
    n_tiles = -(-ns // _pairs.BLOCK)
    assert per == max(1, -(-n_tiles // _pairs.UNIT_SLOTS))
    seen = []
    for b in range(-(-nt // _pairs.BLOCK)):
        mine = units[units[:, 0] == b]
        assert len(mine) >= 1 and (mine[:, 3] == len(mine)).all() and len(mine) <= _pairs.UNIT_SLOTS
        assert mine[:, 2].tolist() == list(range(len(mine)))
        ends = [min(f + per, n_tiles) for f in mine[:, 1]]
        assert all(e == f for e, f in zip(ends[:-1], mine[1:, 1]))  # consecutive, in tile order
        seen += [(b, j) for f, e in zip(mine[:, 1], ends) for j in range(f, e)]
    assert len(seen) == len(set(seen)) and set(seen) == _live_tiles(nt, ns, triangle)
    again, _ = _pairs.pair_units(nt, ns, triangle)
    assert units.dtype == np.int32 and np.array_equal(units, again)


def test_pair_units_pin_the_shape_rule():
    """The main path's shapes: N = 4096 unsorted (one tile a unit, 16 a
    block) and N = 16384 z-sorted (two tiles a unit; K2 lists the 1056 units
    of the upper triangle, K5 all 2048)."""
    units, per = _pairs.pair_units(4096, 4096)
    assert (len(units), per, int(units[:, 3].max())) == (256, 1, 16)
    assert (len(_pairs.pair_units(16384, 16384, True)[0]), _pairs.pair_units(16384, 16384)[1]) == (1056, 2)
    assert len(_pairs.pair_units(16384, 16384)[0]) == 2048


def test_k4_runs_on_the_units_of_k5():
    """K4's work units at the main path's shapes: every unit of the block's
    tiles, sorted or not (only K2's square wake cull lists a triangle), so N
    = 4096 unsorted has 256 units of one tile and N = 16384 z-sorted 2048
    units of two."""
    for n, sort, want in ((4096, False, (256, 1)), (16384, True, (2048, 2))):
        triangle = _pairs.units_triangle(6, sort, True)
        units, per = _pairs.pair_units(n, n, triangle)
        assert not triangle and (len(units), per) == want
        k5 = _pairs.pair_units(n, n, _pairs.units_triangle(7, sort, True))
        assert np.array_equal(units, k5[0])
    assert _pairs.units_triangle(1, True, True) and not _pairs.units_triangle(1, True, False)


def test_wake_term_is_zero_at_zero_beta_where_jax_keeps_a_gaussian():
    """The port's one deviation from the JAX package: where float32 beta =
    c2 dz + c3 is 0 (dz = 0.6875 m) the plain wake term is exactly 0, the
    limit of the reference simulator's Gaussian; the JAX package's term, as
    its source writes it and evaluated op by op (no jit, so no contraction
    of c2 dz + c3 into an FMA), puts beta^2 = 1 there: about 0.16 N."""
    jp, tp = _params()
    pos = np.array([[0.0, 0.0, 1.0], [0.1, 0.0, 1.6875]], np.float32)
    c = _pairs.pair_consts(tp)
    t = _t(pos).T
    assert float(c.c2 * (t[2, 1] - t[2, 0]) + c.c3) == 0.0
    term = wake_terms(t[:, :, None], t[:, None, :], c)
    assert float(term.abs().max()) == 0.0
    assert float(make_downwash(tp, device="cpu")(_t(pos)).abs().max()) == 0.0
    with jax.disable_jit():
        want = np.asarray(jax_downwash(jnp.asarray(pos), jp))
    assert want[0] < -0.1 and want[1] == 0.0


def test_pair_factories_name_their_device():
    _, tp = _params()
    pos, vel = _cloud(n=64)
    dw = make_downwash(tp, device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        dw(_t(pos).to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_collide(tp)


@pytest.mark.parametrize("seed", [11, 12])
def test_smoke_bound_gates_hold_every_nonzero_pair_term(seed):
    """chip_smoke.py's bound prices the rest of a pair term only on the pairs
    its gate lets through: every pair whose plain wake term is not 0 passes
    the wake gate, the pairs with a contact term are the contact gate's, and
    needed_pairs counts the gates' pairs."""
    import chip_smoke
    from gym_pybullet_drones_tpu_torch.ops.collide_pairs import contact_terms
    from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import wake_terms

    pos, vel = _cloud(512, seed)
    c = _pairs.pair_consts(drone_params(device="cpu"))
    cols = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy())
    t, s = cols[:, :, None], cols[:, None, :]
    wake_gate, contact_gate = chip_smoke.pair_gates(t, s, c)
    w = wake_terms(t, s, c)
    assert bool((w[~wake_gate] == 0).all()) and int((w != 0).sum()) > 0
    moved = torch.stack(contact_terms(t, s, c)[:3]).abs().amax(0) > 0
    assert torch.equal(moved, contact_gate) and int(contact_gate.sum()) > 0
    assert chip_smoke.needed_pairs(cols, c) == (int(wake_gate.sum()), int(contact_gate.sum()))
