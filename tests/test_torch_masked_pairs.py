"""The plain versions of the masked pair passes K3 and K6
(ops/downwash_pairs.make_downwash_masked, ops/interact_pairs.make_interact_masked)
on the CPU against the JAX package's masked Pallas kernels in interpret mode.

Tolerances. Against JAX, tests/test_soa.py:276-289's own: the wake at rtol
1e-4 plus atol 1e-4 * max(1, max|w|) (float32 sums in another order),
positions and velocities after the contact deltas at atol 1e-6. Against the
port's dense plain K2, the wake per drone at rtol 1e-4 plus atol 1e-6 (every
wake term has one sign, so a reordered sum errs relative to the sum itself).
The compacted grid against the dense masked one: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.ops.downwash_pallas import make_downwash_masked as jax_dw_masked
from gym_pybullet_drones_tpu.ops.interact_pallas import make_interact_masked as jax_ia_masked
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.ops import _pairs
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import collide_plain
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import downwash_plain, make_downwash_masked
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact_masked

JP, TP = jax_drone_params(), drone_params(device="cpu")
C = _pairs.pair_consts(TP)


def _permuted_cloud(n=1024, seed=11):
    """tests/test_soa.py:262-271: the cloud with overlapping pairs, under a
    deliberately unsorted order."""
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(-1, 1, (n, 3)) * np.array([4, 4, 1.5]) + [0, 0, 2.0]).astype(np.float32)
    pos[1::64] = pos[0::64] + np.array([0.08, 0.0, 0.05], np.float32)
    vel = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    perm = rng.permutation(n)
    return pos[perm], vel[perm]


def _spread_cloud(n=1024, seed=5):
    """tests/test_soa.py:405-409's cloud with contacts at 0.05 m, stretched to
    64 x 16 x 4 m and sorted by x, so that the 10 m wake cutoff leaves each
    row of 128 x 128 tiles at most 5 live source tiles of 8 and a cap can
    hold."""
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(0, 1, (n, 3)) * np.array([64, 16, 4])).astype(np.float32)
    pos[1::64] = pos[0::64] + np.array([0.05, 0.0, 0.05], np.float32)
    vel = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    order = np.argsort(pos[:, 0], kind="stable")
    return pos[order], vel[order]


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _cols(x):
    return [_t(x[:, i]) for i in range(x.shape[1])]


def _stacked(pos, vel):
    return _t(np.concatenate([pos, vel], 1).T)


def _wake_close_jax(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))


def _wake_close_dense(got, pos, src=None):
    tgt = _t(pos.T)
    want = downwash_plain(tgt, tgt if src is None else _t(src.T), C)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("cone", [False, True])
def test_downwash_masked_plain_matches_pallas(cone):
    pos, _ = _permuted_cloud()
    want = jax_dw_masked(JP, bt=256, bs=256, interpret=True, cone=cone)(jnp.asarray(pos))
    got = make_downwash_masked(TP, bt=256, bs=256, cone=cone, device="cpu")(_t(pos))
    assert got.dtype == torch.float32 and float(got.abs().max()) > 0
    _wake_close_jax(got.numpy(), want)
    _wake_close_dense(got, pos)


@pytest.mark.parametrize("sub", [None, 2])
def test_interact_masked_plain_matches_pallas(sub):
    """With the port's own slice count (8 slices of 32) and the JAX
    package's (2 of 128): the slices only change what is skipped."""
    pos, vel = _permuted_cloud()
    jmag, jdp, jdv = jax_ia_masked(JP, bt=256, bs=256, interpret=True)(jnp.asarray(pos),
                                                                       jnp.asarray(vel))
    tmag, tdp, tdv = make_interact_masked(TP, bt=256, bs=256, sub=sub, device="cpu")(_t(pos),
                                                                                     _t(vel))
    assert np.abs(tdp.numpy()).max() > 0  # contacts fired
    _wake_close_jax(tmag.numpy(), jmag)
    _wake_close_dense(tmag, pos)
    np.testing.assert_allclose(pos + tdp.numpy(), np.asarray(pos + jdp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel + tdv.numpy(), np.asarray(vel + jdv), rtol=0, atol=1e-6)
    dense = collide_plain(_stacked(pos, vel), _stacked(pos, vel), C)
    np.testing.assert_allclose(pos + tdp.numpy(), pos + dense[:3].T.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel + tdv.numpy(), vel + dense[3:].T.numpy(), rtol=0, atol=1e-6)


# (cap, passes that overflow): a row of the spread cloud holds at most 5 live
# source tiles of 8; the auto cap is 8.
CAPS = [(True, 0), (5, 0), (3, 1), (1, 1)]


@pytest.mark.parametrize("dense_fallback", [True, False])
@pytest.mark.parametrize("cap,overflows", CAPS)
def test_downwash_compacted_equals_dense_masked(cap, overflows, dense_fallback):
    """tests/test_soa.py:392-427. Where the cap holds, or with the dense
    fallback, the compacted pass equals the dense masked one exactly; the
    z-sorted fallback reorders the sums. The counter says which passes took
    the overflow branch."""
    pos, _ = _spread_cloud()
    ref = make_downwash_masked(TP, bt=128, bs=128, device="cpu").cols(*_cols(pos))
    want = jax_dw_masked(JP, bt=128, bs=128, interpret=True, neighbor_cap=cap,
                         dense_fallback=dense_fallback).cols(*(jnp.asarray(c) for c in pos.T))
    before = make_downwash_masked.overflows
    got = make_downwash_masked(TP, bt=128, bs=128, neighbor_cap=cap,
                               dense_fallback=dense_fallback, device="cpu").cols(*_cols(pos))
    assert make_downwash_masked.overflows - before == overflows
    if dense_fallback or not overflows:
        assert torch.equal(got, ref)
    _wake_close_jax(got.numpy(), want)
    _wake_close_dense(got, pos)


@pytest.mark.parametrize("dense_fallback", [True, False])
@pytest.mark.parametrize("cap,overflows", CAPS)
def test_interact_compacted_equals_dense_masked(cap, overflows, dense_fallback):
    pos, vel = _spread_cloud()
    args = _cols(pos) + _cols(vel)
    ref = make_interact_masked(TP, bt=128, bs=128, device="cpu").cols(*args)
    assert float(torch.stack(ref[1]).abs().max()) > 0  # contacts fired
    before = make_interact_masked.overflows
    got = make_interact_masked(TP, bt=128, bs=128, neighbor_cap=cap,
                               dense_fallback=dense_fallback, device="cpu").cols(*args)
    assert make_interact_masked.overflows - before == overflows
    flat = lambda r: torch.stack((r[0],) + tuple(r[1]) + tuple(r[2]))
    if dense_fallback or not overflows:
        assert torch.equal(flat(got), flat(ref))
    else:
        torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(flat(got)[1:], flat(ref)[1:], rtol=0, atol=1e-6)


def _padded(pos, vel, seed):
    """A fifth of the slots as padding sentinels, as the binned layout plants
    them (ops/swarm_binned.py)."""
    valid = np.random.RandomState(seed).rand(pos.shape[0]) < 0.8
    pos = np.where(valid[:, None], pos, np.array([0.0, 0.0, -1e9], np.float32))
    vel = np.where(valid[:, None], vel, np.float32(0.0))
    return pos.astype(np.float32), vel.astype(np.float32), valid


@pytest.mark.parametrize("cap", [None, True])
def test_masked_passes_with_valid_column_match_pallas(cap):
    pos, vel = _spread_cloud()
    pos, vel, valid = _padded(pos, vel, 3)
    jkw = dict(bt=128, bs=128, interpret=True, neighbor_cap=cap)
    tkw = dict(bt=128, bs=128, neighbor_cap=cap, device="cpu")
    jcols = [jnp.asarray(c) for c in np.concatenate([pos, vel], 1).T]
    want = jax_dw_masked(JP, **jkw).cols(*jcols[:3], valid=jnp.asarray(valid))
    got = make_downwash_masked(TP, **tkw).cols(*_cols(pos), valid=_t(valid))
    _wake_close_jax(got.numpy()[valid], np.asarray(want)[valid])
    _wake_close_dense(got[_t(valid)], pos[valid])  # padding is inert for real drones
    jmag, jdp, jdv = jax_ia_masked(JP, **jkw).cols(*jcols, valid=jnp.asarray(valid))
    tmag, tdp, tdv = make_interact_masked(TP, **tkw).cols(*_cols(pos), *_cols(vel),
                                                          valid=_t(valid))
    assert float(torch.stack(tdp).abs().max()) > 0
    _wake_close_jax(tmag.numpy()[valid], np.asarray(jmag)[valid])
    for t, j in zip(tdp + tdv, jdp + jdv):
        np.testing.assert_allclose(t.numpy()[valid], np.asarray(j)[valid], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cap", [None, True])
def test_masked_passes_zero_padding_rows_and_match_pallas_on_every_row(cap):
    """The padding rule, dense and compacted: a target whose ``valid`` is
    false gets exactly 0 in every output (the kernels skip such targets),
    and every row, padding too, matches the Pallas reference at the limits
    above (it evaluates padding rows against the z = -1e9 sentinels: at
    most about 1e-17 N of wake, no contact). The last tile is all padding."""
    pos, vel = _spread_cloud()
    valid = np.random.RandomState(6).rand(pos.shape[0]) < 0.8
    valid[-128:] = False
    pos = np.where(valid[:, None], pos, np.array([0.0, 0.0, -1e9], np.float32))
    vel = np.where(valid[:, None], vel, np.float32(0.0))
    jkw = dict(bt=128, bs=128, interpret=True, neighbor_cap=cap)
    tkw = dict(bt=128, bs=128, neighbor_cap=cap, device="cpu")
    jcols = [jnp.asarray(c) for c in np.concatenate([pos, vel], 1).T]
    pad = ~_t(valid)
    want = jax_dw_masked(JP, **jkw).cols(*jcols[:3], valid=jnp.asarray(valid))
    got = make_downwash_masked(TP, **tkw).cols(*_cols(pos), valid=_t(valid))
    assert bool((got[pad] == 0).all()) and float(got.abs().max()) > 0
    _wake_close_jax(got.numpy(), want)
    jmag, jdp, jdv = jax_ia_masked(JP, **jkw).cols(*jcols, valid=jnp.asarray(valid))
    tmag, tdp, tdv = make_interact_masked(TP, **tkw).cols(*_cols(pos), *_cols(vel),
                                                          valid=_t(valid))
    assert all(bool((t[pad] == 0).all()) for t in (tmag,) + tdp + tdv)
    assert float(torch.stack(tdp).abs().max()) > 0
    _wake_close_jax(tmag.numpy(), jmag)
    for t, j in zip(tdp + tdv, jdp + jdv):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_masked_split_depends_on_the_shapes_only():
    """S, the source ranks of K3 and K6: the least power of two up to 8 that
    brings the target warps to 16384 and divides the sub-slice width; read
    from (Nt, bt, bs, sub) alone, so the kernels' bits do not depend on the
    card."""
    split = _pairs.masked_split
    assert split(156672, 512, 512, 8) == 4  # the binned 65536-drone layout
    assert split(40960, 640, 640, 8) == 8  # the binned 16384-drone layout
    assert split(16384, 256, 256, 8) == 8  # the sorted loop, capped at 8
    assert split(524288, 32, 256, 8) == 1  # warps enough without a split
    assert split(3000, 100, 300, 3) == 4  # sub-slices of 100 sources
    assert split(4096, 64, 12, 4) == 1 and split(4096, 64, 8, 8) == 1  # 3 and 1 a sub-slice
    for n, bt, bs, sub in ((2048, 512, 2048, 2), (0, 1, 1, 1), (8192, 1, 256, 8)):
        s = split(n, bt, bs, sub)
        assert s in _pairs.MASKED_SPLITS and (bs // sub) % s == 0


@pytest.mark.parametrize("cap,dense_fallback", [(None, True), (True, True), (1, False)])
def test_masked_passes_rectangular_match_pallas(cap, dense_fallback):
    """256 targets (the sources' first 256, moved 1 cm, some padding) against
    1024 sources with their own padding column; the last case overflows into
    the z-sorted rectangular K2 plus K4."""
    spos, svel = _spread_cloud()
    tpos, tvel, valid = _padded(spos[:256] + np.float32(0.01), svel[:256], 4)
    spos, svel, src_valid = _padded(spos, svel, 3)
    jkw = dict(bt=128, bs=128, interpret=True, neighbor_cap=cap, dense_fallback=dense_fallback)
    tkw = dict(bt=128, bs=128, neighbor_cap=cap, dense_fallback=dense_fallback, device="cpu")
    jt = [jnp.asarray(c) for c in np.concatenate([tpos, tvel], 1).T]
    js = tuple(jnp.asarray(c) for c in np.concatenate([spos, svel], 1).T)
    want = jax_dw_masked(JP, **jkw).cols(*jt[:3], valid=jnp.asarray(valid), src=js[:3],
                                         src_valid=jnp.asarray(src_valid))
    got = make_downwash_masked(TP, **tkw).cols(*_cols(tpos), valid=_t(valid),
                                               src=tuple(_cols(spos)), src_valid=_t(src_valid))
    assert got.shape == (256,)
    _wake_close_jax(got.numpy()[valid], np.asarray(want)[valid])
    _wake_close_dense(got[_t(valid)], tpos[valid], src=spos)
    jmag, jdp, jdv = jax_ia_masked(JP, **jkw).cols(*jt, valid=jnp.asarray(valid), src=js,
                                                   src_valid=jnp.asarray(src_valid))
    before = make_interact_masked.overflows
    tmag, tdp, tdv = make_interact_masked(TP, **tkw).cols(
        *_cols(tpos), *_cols(tvel), valid=_t(valid), src=tuple(_cols(spos) + _cols(svel)),
        src_valid=_t(src_valid))
    assert make_interact_masked.overflows - before == (0 if dense_fallback else 1)
    assert float(torch.stack(tdp).abs().max()) > 0
    _wake_close_jax(tmag.numpy()[valid], np.asarray(jmag)[valid])
    for t, j in zip(tdp + tdv, jdp + jdv):
        np.testing.assert_allclose(t.numpy()[valid], np.asarray(j)[valid], rtol=0, atol=1e-6)


def test_masked_passes_keep_dtype_and_name_their_device():
    pos, vel = _permuted_cloud(n=512)
    got = make_downwash_masked(TP, device="cpu")(_t(pos).double())
    assert got.dtype == torch.float64
    with pytest.raises(ValueError, match="built for cpu"):
        make_interact_masked(TP, device="cpu")(_t(pos).to("meta"), _t(vel).to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_downwash_masked(TP)


def test_slice_gates_read_both_forms_alike():
    """The dense words and their compacted lists give the plain versions the
    same gates; a list is read up to its first zero word."""
    words = torch.tensor([[0, 0x0101, 0, 0x0302], [0x0003, 0, 0, 0]], dtype=torch.int32)
    dense = _pairs.TileGrid(4, 4, 2, 4, False)
    lists = torch.tensor([[(1 << 16) | 0x0101, (3 << 16) | 0x0302, 0],
                          [0x0003, 0, (2 << 16) | 0x0001]], dtype=torch.int32)
    compact = _pairs.TileGrid(4, 4, 2, 3, True)
    for a, b in zip(_pairs.slice_gates(words.reshape(-1), dense, 8, 16),
                    _pairs.slice_gates(lists.reshape(-1), compact, 8, 16)):
        assert torch.equal(a, b)
    wake, contact = _pairs.slice_gates(words.reshape(-1), dense, 8, 16)
    assert wake.tolist() == [[False, False, True, False, False, False, False, True],
                             [True, True, False, False, False, False, False, False]]
    assert contact[0].tolist() == [False, False, True, False, False, False, True, True]
    gate = _pairs.pair_gate(wake, dense, 2, 6)
    assert gate.shape == (4, 16) and gate[0].tolist() == gate[1].tolist()
    assert gate[0].tolist() == [False] * 4 + [True] * 2 + [False] * 8 + [True] * 2
    assert gate[2].tolist() == [True] * 4 + [False] * 12


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A built library is named by a hash of its source, of every csrc/ file
    it includes and of its own flags: a change to pair_terms.cuh renames (so
    rebuilds) the two pair kernel libraries and leaves K1's two (the cells'
    and the counting build) and K7's alone; a change to K1's shared header
    velocity_rollout.cuh renames both K1 libraries and neither the pair
    libraries nor K7's; and a change to one source's flags renames that
    library alone. K2/K4/K5's and K3/K6's sources contract multiply-adds,
    K1's, its counting build's (with K1's very flags) and K7's
    (render_views) do not. Needs no compiler."""
    import os
    import shutil

    from gym_pybullet_drones_tpu_torch.ops import _build
    from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as tro

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    names = (tro.KERNEL, tro.COUNTS_KERNEL, _pairs.UNIT_KERNEL, _pairs.MASKED_KERNEL,
             "render_views")
    k1, pairs = names[:2], names[2:4]
    for name in pairs:
        assert [os.path.basename(p) for p in _build._sources(str(csrc / f"{name}.cu"))] == [
            f"{name}.cu", "pair_terms.cuh"]
    for name in k1:
        assert [os.path.basename(p) for p in _build._sources(str(csrc / f"{name}.cu"))] == [
            f"{name}.cu", "velocity_rollout.cuh", "rn_math.cuh"]
    before = [_build._paths(n)[1] for n in names]
    with open(csrc / "velocity_rollout.cuh", "a") as fh:
        fh.write("// changed\n")
    shared = [_build._paths(n)[1] for n in names]
    assert [a != b for a, b in zip(shared, before)] == [n in k1 for n in names]
    with open(csrc / "pair_terms.cuh", "a") as fh:
        fh.write("// changed\n")
    after = [_build._paths(n)[1] for n in names]
    assert [a != b for a, b in zip(after, shared)] == [n in pairs for n in names]
    flags = _build.NVCC_FLAGS
    assert all("-fmad=true" in flags[n] for n in pairs)
    assert all("-fmad=false" in flags[n] for n in names if n not in pairs)
    assert flags[tro.COUNTS_KERNEL] == flags[tro.KERNEL]
    assert set(flags) == set(names)
    for i, name in enumerate(names):
        with monkeypatch.context() as m:
            m.setitem(flags, name, flags[name] + ("-lineinfo",))
            changed = [_build._paths(n)[1] for n in names]
        assert [a != b for a, b in zip(changed, after)] == [k == i for k in range(len(names))]
