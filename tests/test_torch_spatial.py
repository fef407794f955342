"""The port's ops/spatial.py against the JAX package's on the CPU: the tile
bounds, the live masks and the compacted live lists equal it word for word at
the same tile, slice and cap sizes, on tests/test_soa.py's clouds; the Morton
key equals it as an integer. One test needs no JAX: no contributing pair lies
outside a live sub-slice. Everything here is exact (``==``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.ops import spatial as jsp
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.ops import _pairs, spatial as tsp
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import contact_terms
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import wake_terms


def _cols(n, seed, lo=0.0, hi=12.0, z_sorted=False):
    """tests/test_soa.py:496-499's cloud; ``z_sorted`` orders it by z, so
    that the masks have dead tiles."""
    rng = np.random.RandomState(seed)
    cols = [rng.uniform(lo, hi, n).astype(np.float32) for _ in range(3)]
    order = np.argsort(cols[2], kind="stable") if z_sorted else slice(None)
    return [c[order] for c in cols]


def _j(cols):
    return [jnp.asarray(c) for c in cols]


def _t(cols):
    return [torch.as_tensor(c) for c in cols]


def _valid(n, seed, block):
    """tests/test_soa.py:527-534: 70 % real slots and one all-padding tile,
    sentinels planted on the padding slots as the binned layout does."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(n) < 0.7
    valid[block:2 * block] = False
    return valid


def _planted(cols, valid):
    x, y, z = cols
    return [np.where(valid, x, np.float32(0.0)), np.where(valid, y, np.float32(0.0)),
            np.where(valid, z, np.float32(-1e9))]


@pytest.mark.parametrize("with_valid", [False, True])
def test_tile_bounds6_matches_jax(with_valid):
    cols = _cols(512, 3, -5, 5)
    valid = _valid(512, 9, 64) if with_valid else None
    if with_valid:
        cols = _planted(cols, valid)
    want = jsp.tile_bounds6(*_j(cols), 64, valid=None if valid is None else jnp.asarray(valid))
    got = tsp.tile_bounds6(*_t(cols), 64, valid=None if valid is None else torch.as_tensor(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if with_valid:
        assert float(got[0][1]) > float(got[3][1])  # the all-padding tile: an empty box
    else:
        lo, hi = tsp.tile_bounds(_t(cols)[2], 64)
        np.testing.assert_array_equal(lo.numpy(), got[2].numpy())
        np.testing.assert_array_equal(hi.numpy(), got[5].numpy())


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("bt,bs", [(128, 128), (128, 256), (256, 64)])
def test_wake_and_contact_live_masks_match_jax(bt, bs, cone):
    jp, tp = jax_drone_params(), drone_params(device="cpu")
    cols = _cols(1024, 3, z_sorted=True)
    want = jsp.wake_live_mask(*_j(cols), bt, bs, params=jp, cone=cone)
    got = tsp.wake_live_mask(*_t(cols), bt, bs, params=tp, cone=cone)
    assert got.dtype == torch.int32 and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsp.contact_live_mask(*_j(cols), bt, bs, 0.12)
    got = tsp.contact_live_mask(*_t(cols), bt, bs, 0.12)
    assert 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsp.packed_live_mask(*_j(cols), bt, bs, 0.12, params=jp, cone=cone)
    got = tsp.packed_live_mask(*_t(cols), bt, bs, 0.12, params=tp, cone=cone)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["square", "sorted", "valid", "rectangular"])
@pytest.mark.parametrize("min_dist", [None, 0.12])
@pytest.mark.parametrize("bt,bs", [(128, 256), (128, 1024), (256, 128)])
def test_subtile_packed_mask_matches_jax(bt, bs, min_dist, form):
    """Wake bits only and both sections; in any order and sorted by z (where
    tiles and slices die); with the padding column; with
    another source set and its own padding column. The slice count is the
    JAX package's for that tile (2, 8 and 1 here), handed to both."""
    jp, tp = jax_drone_params(), drone_params(device="cpu")
    cols = _cols(1024, 3, z_sorted=form == "sorted")
    sub = jsp.subtile_count(bs)
    jkw, tkw = {}, {}
    if form in ("valid", "rectangular"):
        valid = _valid(1024, 9, 128)
        cols = _planted(cols, valid)
        jkw["valid"], tkw["valid"] = jnp.asarray(valid), torch.as_tensor(valid)
    if form == "rectangular":
        src_valid = _valid(2048, 13, 128)
        src = _planted(_cols(2048, 4), src_valid)
        jkw.update(src_cols=tuple(_j(src)), src_valid=jnp.asarray(src_valid))
        tkw.update(src_cols=tuple(_t(src)), src_valid=torch.as_tensor(src_valid))
    want = np.asarray(jsp.subtile_packed_mask(*_j(cols), bt, bs, min_dist=min_dist, params=jp,
                                              **jkw))
    got = tsp.subtile_packed_mask(*_t(cols), bt, bs, min_dist=min_dist, params=tp, sub=sub, **tkw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    full = ((1 << sub) - 1) * (1 if min_dist is None else 0x101)
    assert bool((got != 0).any()) and (form == "square" or bool((got != full).any()))
    np.testing.assert_array_equal(got.numpy(), want)
    if min_dist is None:
        assert int(got.max()) < 256  # no contact bits


def test_subtile_defaults_are_the_cards_own():
    """A slice per warp's worth of sources, at most 8; a divisor of the axis."""
    assert [tsp.subtile_count(b) for b in (2048, 256, 128, 96, 64, 48, 31)] == [8, 8, 4, 3, 2, 1, 1]
    assert tsp.fit_block(256, 4096) == 256 and tsp.fit_block(1024, 512) == 512
    assert tsp.fit_block(512, 768) == 384 and tsp.fit_block(256, 1000) == 250
    assert tsp.auto_bs(None) == 256 and tsp.auto_bs(128) == 128
    assert tsp.auto_nbr_cap(8) == 8 and tsp.auto_nbr_cap(4096) == 1024


def test_compact_live_tiles_unit():
    """tests/test_soa.py:430-446: ascending order per row, packed
    idx << 16 | bits, zero padding, the exact count_max."""
    mask = np.array([[0, 1, 0, 0x103], [2, 0, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], np.int32)
    idx, count_max = tsp.compact_live_tiles(torch.as_tensor(mask).reshape(-1), 4, 4, cap=2)
    np.testing.assert_array_equal(
        idx.numpy().reshape(4, 2),
        [[(1 << 16) | 1, (3 << 16) | 0x103], [2, 0], [0, 0], [1, (1 << 16) | 1]])
    assert idx.dtype == torch.int32 and int(count_max) == 4


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_compact_live_tiles_matches_jax(cap):
    jp, tp = jax_drone_params(), drone_params(device="cpu")
    cols = _cols(1024, 5, 0, 16)
    jmask = jsp.subtile_packed_mask(*_j(cols), 128, 128, min_dist=0.12, params=jp)
    tmask = tsp.subtile_packed_mask(*_t(cols), 128, 128, min_dist=0.12, params=tp, sub=1)
    want, want_max = jsp.compact_live_tiles(jmask, 8, 8, cap)
    got, got_max = tsp.compact_live_tiles(tmask, 8, 8, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_max) == int(want_max)


@pytest.mark.parametrize("seed", [3, 4])
def test_morton_and_sort_keys_match_jax(seed):
    cols = _cols(512, seed, -5, 5)
    want = np.asarray(jsp.morton_key(*_j(cols))).astype(np.int64)
    got = tsp.morton_key(*_t(cols))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 400
    np.testing.assert_array_equal(tsp.sort_key(*_t(cols), "morton").numpy(), want)
    np.testing.assert_array_equal(tsp.sort_key(*_t(cols), "z").numpy(), cols[2])
    with pytest.raises(ValueError, match="unknown order"):
        tsp.sort_key(*_t(cols), "x")


def test_cone_cull_at_zero_beta_is_the_jax_packages():
    """The cone cull where float32 beta = c2 dz + c3 is exactly 0, at
    dz = 0.6875 m: the masks stay the JAX package's word for word, cone on
    and off; the port's pair term is exactly 0 there (its one deviation from
    the JAX package, whose term puts beta^2 = 1: ROADMAP Queue 3); so no pair
    with a non-zero term lies in the tile pair that the cone culls."""
    jp, tp = jax_drone_params(), drone_params(device="cpu")
    cols = [np.array(c, np.float32) for c in
            ([0.0, 0.1, 3.0, 3.1], [0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.6875, 1.6875])]
    x, y, z = _t(cols)
    c = _pairs.pair_consts(tp)
    assert float(c.c2 * (z[2] - z[0]) + c.c3) == 0.0
    pos = torch.stack([x, y, z])
    term = wake_terms(pos[:, :, None], pos[:, None, :], c)  # (targets, sources)
    assert float(term[:2, 2:].abs().max()) == 0.0
    for cone, live in ((True, 0), (False, 1)):
        got = tsp.wake_live_mask(x, y, z, 2, 2, params=tp, cone=cone)
        want = jsp.wake_live_mask(*_j(cols), 2, 2, params=jp, cone=cone)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got[0, 1]) == live
        gate = got.bool().repeat_interleave(2, 0).repeat_interleave(2, 1)
        assert not bool(((term != 0) & ~gate).any())


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("order", ["random", "z"])
def test_no_contributing_pair_outside_a_live_subslice(order, cone):
    """Independent of JAX: on a random cloud with overlapping pairs, under a
    random permutation or sorted by z, every pair whose plain wake term or
    contact term is non-zero lies in a sub-slice whose bit is set."""
    tp = drone_params(device="cpu")
    c = _pairs.pair_consts(tp)
    rng = np.random.RandomState(17)
    n, bt, bs, sub = 1024, 64, 128, 4
    pos = rng.uniform(0, 1, (n, 3)) * np.array([30, 30, 6]) + [0, 0, 0.5]
    pos[1::32] = pos[0::32] + [0.05, 0.0, 0.05]
    vel = rng.uniform(-0.5, 0.5, (n, 3))
    perm = rng.permutation(n) if order == "random" else np.argsort(pos[:, 2], kind="stable")
    cols = torch.as_tensor(np.concatenate([pos, vel], 1)[perm].T.copy(), dtype=torch.float32)
    words = tsp.subtile_packed_mask(cols[0], cols[1], cols[2], bt, bs, min_dist=c.min_dist,
                                    params=tp, cone=cone, sub=sub)
    grid = _pairs.TileGrid(bt, bs, sub, n // bs, False)
    wake_live, contact_live = _pairs.slice_gates(words, grid, n, n)
    wake_gate = _pairs.pair_gate(wake_live, grid, 0, n)
    contact_gate = _pairs.pair_gate(contact_live, grid, 0, n)
    t, s = cols[:, :, None], cols[:, None, :]
    wake = wake_terms(t, s, c) != 0
    contact = torch.stack(contact_terms(t, s, c)).abs().sum(0) != 0
    assert int(wake.sum()) > n and int(contact.sum()) >= n // 32
    assert not bool((wake & ~wake_gate).any())
    assert not bool((contact & ~contact_gate).any())
    if order == "z":  # and the masks do cull
        assert float(wake_gate.float().mean()) < 0.7 and float(contact_gate.float().mean()) < 0.5
