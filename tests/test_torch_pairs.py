"""The plain versions of the pair passes K2, K4 and K5 (ops/downwash_pairs.py,
ops/collide_pairs.py, ops/interact_pairs.py) against the JAX package's Pallas
kernels in interpret mode, square and rectangular, z-sorted and not.

Tolerances are tests/test_soa.py's: the wake at rtol 1e-4 plus atol
1e-4 * max(1, max|w|) (float32 sums in another order), positions and
velocities after the contact deltas at atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.ops.collide_pallas import make_collide_pallas
from gym_pybullet_drones_tpu.ops.downwash_pallas import make_downwash_pallas
from gym_pybullet_drones_tpu.ops.interact_pallas import make_interact_pallas
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.ops import _pairs
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import make_collide
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash
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


def test_source_split_covers_every_tile():
    """The kernels' source split: no empty chunk, every tile covered, and
    enough blocks to fill the card where the tiles allow."""
    for nt, ns in ((1000, 1000), (4096, 4096), (16384, 16384), (4096, 16384), (256, 1024),
                   (1, 1), (33, 70000)):
        split, per = _pairs.source_split(nt, ns)
        tiles = -(-ns // _pairs.BLOCK)
        assert split * per >= tiles > (split - 1) * per
        assert split == tiles or -(-nt // _pairs.BLOCK) * split >= 4 * 132


def test_pair_factories_name_their_device():
    _, tp = _params()
    pos, vel = _cloud(n=64)
    dw = make_downwash(tp, device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        dw(_t(pos).to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_collide(tp)
