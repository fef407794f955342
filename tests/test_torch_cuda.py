"""Kernels K1 (csrc/velocity_rollout.cu), K2, K4, K5 (csrc/wake_pair_kernels.cu),
K3, K6 (csrc/masked_pair_kernels.cu) and K7 (csrc/render_views.cu) against
their plain PyTorch versions on the card, and the impulse contact solver
(core/contact.py) on the card against the CPU. Needs a CUDA card and nvcc:
run on the GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (the card is looked for inside a fixture, so all
pytest workers collect the same tests)."""

import importlib

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.ops import _pairs as tpairs
from gym_pybullet_drones_tpu_torch.ops import collide_pairs as tco
from gym_pybullet_drones_tpu_torch.ops import downwash_pairs as tdw
from gym_pybullet_drones_tpu_torch.ops import interact_pairs as tia
from gym_pybullet_drones_tpu_torch.ops import spatial as tsp
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as tro
from gym_pybullet_drones_tpu_torch.ops import velocity_soa as tsoa

troll = importlib.import_module("gym_pybullet_drones_tpu_torch.runtime.rollout")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the GPU machine")
    return torch.device("cuda")


def _case(device, E, seed=0):
    cfg = tbase.AviaryConfig(task=tbase.TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    p, cp = tbase.build_params(cfg, "cpu"), tbase.build_ctrl_params(cfg, "cpu")
    sl = 0.03 * float(p.max_speed_kmh) * (1000.0 / 3600.0)
    args = (tsoa.soa_consts(cp, p), cfg.ctrl_timestep, cfg.pyb_timestep, cfg.steps_per_ctrl, sl)
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.uniform(-1, 1, (3, E)), rng.uniform(0, 1, (1, E))])
    act = {k: torch.as_tensor(a[i], dtype=torch.float32, device=device)
           for i, k in enumerate(tsoa.ACTION_KEYS)}
    soa = tsoa.soa_from_state(troll.batch_reset(cfg, p, E, device=device))
    return args, soa, act


@pytest.mark.parametrize("E,T", [(1000, 8), (4096, 48), (33, 240)])
def test_k1_matches_plain_version(cuda, E, T):
    """atol 1e-5 on every column; the ragged edge (E not a multiple of the
    block) included."""
    args, soa, act = _case(cuda, E)
    got = tro.velocity_rollout_cuda(*args, T, soa, act)
    want = tro.velocity_rollout_plain(*args, T, soa, act)
    torch.cuda.synchronize()
    for k in tsoa.SOA_KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5, msg=k)


@pytest.mark.parametrize("lanes", tro.LANES)
@pytest.mark.parametrize("E", [33, 1000, 4097])
def test_k1_equals_plain_version_bit_for_bit_at_every_lane_count(cuda, E, lanes):
    """Each lane of an env's group runs the plain version's operations in its
    order, so K1 equals its plain version bit for bit whatever the lanes;
    ragged E (not a multiple of 32 / lanes) included."""
    args, soa, act = _case(cuda, E)
    got = tro.velocity_rollout_cuda(*args, 8, soa, act, lanes=lanes)
    want = tro.velocity_rollout_plain(*args, 8, soa, act)
    torch.cuda.synchronize()
    for k in tsoa.SOA_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_k1_zero_steps_is_identity(cuda):
    args, soa, act = _case(cuda, 64)
    got = tro.velocity_rollout_cuda(*args, 0, soa, act)
    assert all(torch.equal(got[k], soa[k]) for k in tsoa.SOA_KEYS)


def test_k1_counts_its_launches(cuda):
    args, soa, act = _case(cuda, 128)
    before = tro.velocity_rollout_cuda.launches
    rollout = tro.make_velocity_rollout(*args, 4, device=cuda)
    rollout(soa, act)
    rollout(soa, act)
    assert tro.velocity_rollout_cuda.launches == before + 2


def test_k1_rejects_what_it_does_not_take(cuda):
    args, soa, act = _case(cuda, 64)
    with pytest.raises(TypeError, match="float32"):
        tro.velocity_rollout_cuda(*args, 2, {k: v.double() for k, v in soa.items()}, act)
    with pytest.raises(ValueError, match="one length"):
        tro.velocity_rollout_cuda(*args, 2, soa, {k: v[:10] for k, v in act.items()})
    with pytest.raises(ValueError, match="CUDA"):
        tro.velocity_rollout_cuda(*args, 2, soa, {k: v.cpu() for k, v in act.items()})
    with pytest.raises(ValueError, match="lanes"):
        tro.velocity_rollout_cuda(*args, 2, soa, act, lanes=3)


# ---------------- K2, K4, K5 (csrc/wake_pair_kernels.cu) ----------------


def _pair_cloud(device, n, n_src=None, seed=11):
    """tests/test_soa.py's cloud (4 x 4 x 1.5 m per 1024 drones, scaled with
    N), with overlapping pairs sprinkled in, stacked as (6, N) float32."""
    rng = np.random.RandomState(seed)
    m = n if n_src is None else n_src
    scale = (m / 1024) ** (1 / 3)
    pos = rng.uniform(-1, 1, (m, 3)) * np.array([4, 4, 1.5]) * scale + [0, 0, 2.0]
    pos[1::64] = pos[0::64][:len(pos[1::64])] + [0.08, 0.0, 0.05]
    vel = rng.uniform(-0.5, 0.5, (m, 3))
    src = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), dtype=torch.float32,
                          device=device)
    tgt = src if n_src is None else (src[:, :n] + 0.01).contiguous()
    return tgt, src


def _spread_fleet(n, seed=3):
    """A jittered 1.5 m lattice: no two drones in touch, every drone under
    some wake; (n, 3) positions and velocities as float32 numpy."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side) * 1.5] * 3), -1).reshape(-1, 3)[:n]
    pos = g + rng.uniform(-0.3, 0.3, g.shape) + [0.0, 0.0, 1.0]
    return pos.astype(np.float32), rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)


def _pair_consts():
    return tpairs.pair_consts(tbase.build_params(tbase.AviaryConfig(), "cpu"))


def _wake_close(got, want):
    """Per drone at rtol 1e-4 plus atol 1e-6: every wake term has one sign,
    so a reordered float32 sum errs relative to the sum itself."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def _sorted(tgt, src, square):
    tgt, _ = tpairs.sort_by_z(tgt)
    return tgt, tgt if square else tpairs.sort_by_z(src)[0]


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n,n_src", [(1000, None), (4096, None), (4097, None), (16384, None),
                                     (4096, 16384)])
def test_k2_k4_match_plain_versions(cuda, n, n_src, sort):
    """Square and rectangular, z-sorted (culled) and not; ragged at 1000 and
    4097 (a last block and a last tile of one drone)."""
    c = _pair_consts()
    tgt, src = _pair_cloud(cuda, n, n_src)
    square = n_src is None
    if sort:
        tgt, src = _sorted(tgt, src, square)
    w = tdw.downwash_cuda(tgt[:3].contiguous(), src[:3].contiguous(), c, cull=sort, square=square)
    _wake_close(w, tdw.downwash_plain(tgt[:3].contiguous(), src[:3].contiguous(), c))
    d = tco.collide_cuda(tgt, src, c, cull=sort)
    want = tco.collide_plain(tgt, src, c)
    assert float(d[:3].abs().max()) > 0  # contacts fired
    torch.testing.assert_close(tgt[:3] + d[:3], tgt[:3] + want[:3], rtol=0, atol=1e-6)
    torch.testing.assert_close(tgt[3:] + d[3:], tgt[3:] + want[3:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n", [1000, 4096, 4097, 16384])
def test_k5_matches_plain_version(cuda, n, sort):
    c = _pair_consts()
    cols, _ = _pair_cloud(cuda, n)
    if sort:
        cols, _ = tpairs.sort_by_z(cols)
    got = tia.interact_cuda(cols, c, cull=sort)
    want = tia.interact_plain(cols, c)
    _wake_close(got[0], want[0])
    assert float(got[1:4].abs().max()) > 0
    torch.testing.assert_close(cols[:3] + got[1:4], cols[:3] + want[1:4], rtol=0, atol=1e-6)
    torch.testing.assert_close(cols[3:] + got[4:], cols[3:] + want[4:], rtol=0, atol=1e-6)


def test_pair_culls_fire_and_count_their_tiles(cuda):
    c = _pair_consts()
    cols, _ = _pair_cloud(cuda, 16384)
    cols, _ = tpairs.sort_by_z(cols)
    tiles = 64 * 64
    counts = {}
    for cull in (False, True):
        t = torch.zeros(2, dtype=torch.int32, device=cuda)
        tia.interact_cuda(cols, c, cull=cull, tiles=t)
        counts[cull] = t.tolist()
    assert counts[False] == [tiles, tiles]
    assert 0 < counts[True][0] < tiles and 0 < counts[True][1] < tiles


def test_k2_lists_only_the_live_tiles_of_the_triangle(cuda):
    """Square and z-sorted, K2 evaluates exactly the tiles on and above each
    block's diagonal (the units the host lists), K5's wake the same tiles."""
    c = _pair_consts()
    cols, _ = tpairs.sort_by_z(_pair_cloud(cuda, 16384)[0])
    t2, t5 = (torch.zeros(2, dtype=torch.int32, device=cuda) for _ in range(2))
    tdw.downwash_cuda(cols[:3].contiguous(), cols[:3].contiguous(), c, cull=True, tiles=t2)
    tia.interact_cuda(cols, c, cull=True, tiles=t5)
    assert int(t2[0]) == int(t5[0]) == 64 * 65 // 2


@pytest.mark.parametrize("sort", [False, True])
def test_k5_contact_of_one_lane_in_a_warp(cuda, sort):
    """A fleet with no two drones in touch but one pair: drone 37 (lane 5 of
    its warp) and drone 3000 move into contact, so in each of their warps one
    lane alone passes the vote. The deltas match the plain version within
    1e-6 and only those two drones move."""
    c = _pair_consts()
    pos, vel = _spread_fleet(4096)
    pos[3000] = pos[37] + np.array([0.06, 0.0, 0.03], np.float32)
    cols = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), device=cuda)
    if sort:
        cols, _ = tpairs.sort_by_z(cols)
    got = tia.interact_cuda(cols, c, cull=sort)
    want = tia.interact_plain(cols, c)
    moved = (got[1:4].abs().amax(0) > 0).nonzero()[:, 0]
    assert moved.numel() == 2 and torch.equal(moved, (want[1:4].abs().amax(0) > 0).nonzero()[:, 0])
    _wake_close(got[0], want[0])
    torch.testing.assert_close(cols[:3] + got[1:4], cols[:3] + want[1:4], rtol=0, atol=1e-6)
    torch.testing.assert_close(cols[3:] + got[4:], cols[3:] + want[4:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
def test_k4_contact_of_one_lane_in_a_warp(cuda, sort):
    """K5's one-lane fleet through K4: drones 37 and 3000 alone in touch, each
    the one lane of its warp that passes the vote; K4 equals its plain
    version bit for bit (one partner each) and moves only those two."""
    c = _pair_consts()
    pos, vel = _spread_fleet(4096)
    pos[3000] = pos[37] + np.array([0.06, 0.0, 0.03], np.float32)
    cols = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), device=cuda)
    if sort:
        cols, _ = tpairs.sort_by_z(cols)
    got = tco.collide_cuda(cols, cols, c, cull=sort)
    assert int((got[:3].abs().amax(0) > 0).sum()) == 2
    assert torch.equal(got, tco.collide_plain(cols, cols, c))


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n,n_src", [(4097, None), (16384, None), (4096, 16384)])
def test_k2_k5_passes_repeat_bit_for_bit(cuda, n, n_src, sort):
    """The units' partial sums are added in a fixed order: a second pass
    equals the first, for K2, K4 and K5."""
    c = _pair_consts()
    tgt, src = _pair_cloud(cuda, n, n_src)
    square = n_src is None
    if sort:
        tgt, src = _sorted(tgt, src, square)
    t3, s3 = tgt[:3].contiguous(), src[:3].contiguous()
    runs = [tdw.downwash_cuda(t3, s3, c, cull=sort, square=square) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    runs = [tco.collide_cuda(tgt, src, c, cull=sort) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    if square:
        runs = [tia.interact_cuda(tgt, c, cull=sort) for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n", [4096, 16384])
def test_k4_equals_its_plain_version_bit_for_bit(cuda, n, sort):
    """K4's contact term rounds each step as the plain version does and
    nearly every drone of the square cloud has at most one partner: it
    equals its plain version, sorted (most units culled) or not. (The rectangular form's targets, 1 cm from
    their own sources, meet two or three partners, whose order of addition
    differs; it is held at atol 1e-6 above.)"""
    c = _pair_consts()
    cols, _ = _pair_cloud(cuda, n)
    if sort:
        cols, _ = tpairs.sort_by_z(cols)
    got = tco.collide_cuda(cols, cols, c, cull=sort)
    assert float(got[:3].abs().max()) > 0
    assert torch.equal(got, tco.collide_plain(cols, cols, c))


def test_wake_is_zero_at_zero_beta_in_every_pass(cuda):
    """A drone 0.6875 m right under another (float32 beta = c2 dz + c3
    exactly 0), far from the rest of a lattice: its wake is exactly 0 in K2,
    K3, K5 and K6, as in the plain version; 0.75 m under, it is K / dz^2."""
    c = _pair_consts()
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    pos, vel = _spread_fleet(512)
    for dz, zero in ((0.6875, True), (0.75, False)):
        pos[0], pos[1] = (100.0, 0.0, 1.0), (100.0, 0.0, 1.0 + dz)
        cols = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), device=cuda)
        t3 = cols[:3].contiguous()
        assert (float(c.c2 * (t3[2, 1] - t3[2, 0]) + c.c3) == 0.0) == zero
        grid = tpairs.TileGrid(256, 256, 8, 2, False)
        words = tsp.subtile_packed_mask(cols[0], cols[1], cols[2], 256, 256, min_dist=c.min_dist,
                                        params=p, cone=True, sub=8)
        wakes = {"plain": tdw.downwash_plain(t3, t3, c), "K2": tdw.downwash_cuda(t3, t3, c),
                 "K3": tdw.downwash_masked_cuda(t3, t3, words, grid, c),
                 "K5": tia.interact_cuda(cols, c)[0],
                 "K6": tia.interact_masked_cuda(cols, cols, words, grid, c)[0]}
        for name, w in wakes.items():
            assert float(w[0]) == 0.0 if zero else float(w[0]) < -0.1, (name, dz, float(w[0]))


def test_pair_factories_sorted_match_unsorted(cuda):
    """The whole wrappers (sort, cull, scatter back) against the unsorted
    pass on the same cloud."""
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    cols, _ = _pair_cloud(cuda, 4096)
    x = [cols[i] for i in range(6)]
    runs = [tia.make_interact(p, z_sort=s, device=cuda).cols(*x) for s in (False, True)]
    _wake_close(runs[1][0], runs[0][0])
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_pair_kernels_count_their_launches(cuda):
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    cols, _ = _pair_cloud(cuda, 512)
    x = [cols[i] for i in range(6)]
    before = (tdw.downwash_cuda.launches, tco.collide_cuda.launches, tia.interact_cuda.launches)
    tdw.make_downwash(p, device=cuda).cols(*x[:3])
    tco.make_collide(p, device=cuda).cols(*x)
    tia.make_interact(p, device=cuda).cols(*x)
    tia.interact_plain(cols, tpairs.pair_consts(p))  # the plain version: no launch
    after = (tdw.downwash_cuda.launches, tco.collide_cuda.launches, tia.interact_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def test_pair_kernels_reject_what_they_do_not_take(cuda):
    c = _pair_consts()
    cols, _ = _pair_cloud(cuda, 512)
    with pytest.raises(TypeError, match="float32"):
        tdw.downwash_cuda(cols[:3].double().contiguous(), cols[:3].double().contiguous(), c)
    with pytest.raises(ValueError, match="CUDA"):
        tco.collide_cuda(cols.cpu(), cols.cpu(), c)
    with pytest.raises(ValueError, match="contiguous"):
        tco.collide_cuda(cols[:, ::2], cols[:, ::2], c)
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    with pytest.raises(ValueError, match="built for"):
        tdw.make_downwash(p, device=cuda)(cols[:3].T.cpu())


# ---------------- K3, K6 (csrc/masked_pair_kernels.cu) ----------------


def _masked_case(device, n, n_src, bt, bs, sub, with_valid, contact, cone=True, seed=5):
    """The cloud under a random permutation (the masks must hold in any
    order), its words in dense and compacted form, and the two grids. With
    ``with_valid`` a fifth of the slots become padding sentinels."""
    c = _pair_consts()
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    tgt, src = _pair_cloud(device, n, n_src)
    gen = torch.Generator().manual_seed(seed)
    src = src[:, torch.randperm(src.shape[1], generator=gen).to(device)].contiguous()
    tgt = src if n_src is None else tgt[:, torch.randperm(n, generator=gen).to(device)].contiguous()
    valid = src_valid = None
    if with_valid:
        src_valid = (torch.rand(src.shape[1], generator=gen) < 0.8).to(device)
        sent = torch.tensor([0.0, 0.0, -1e9, 0.0, 0.0, 0.0], device=device)[:, None]
        src = torch.where(src_valid, src, sent).contiguous()
        if n_src is None:
            tgt, valid = src, src_valid
        else:
            valid = (torch.rand(n, generator=gen) < 0.8).to(device)
            tgt = torch.where(valid, tgt, sent).contiguous()
    mask = tsp.subtile_packed_mask(
        tgt[0], tgt[1], tgt[2], bt, bs, min_dist=c.min_dist if contact else None, params=p,
        cone=cone, valid=valid, src_cols=None if n_src is None else tuple(src[:3]),
        src_valid=None if n_src is None else src_valid, sub=sub)
    nt, ns = tgt.shape[1] // bt, src.shape[1] // bs
    idx, count_max = tsp.compact_live_tiles(mask, nt, ns, ns)
    assert int(count_max) <= ns
    dense = tpairs.TileGrid(bt, bs, sub, ns, False)
    compact = tpairs.TileGrid(bt, bs, sub, ns, True)
    real = torch.ones(tgt.shape[1], dtype=torch.bool, device=device) if valid is None else valid
    return c, tgt, src, mask, idx, dense, compact, real


# (n, n_src, bt, bs, sub). The source ranks S (ops/_pairs.masked_split) are 4
# for the fourth (sub-slices of 100 sources), 2 for the seventh (8192 target
# tiles of one), 1 for the eighth (sub-slices of one source) and 8 for the
# rest; the tests also force S = 1 on each. A sub-slice of 1024 sources is
# staged in pieces of 64 S.
MASKED_SHAPES = [(1024, None, 128, 128, 1), (4096, None, 256, 256, 8), (4096, None, 512, 512, 4),
                 (3000, None, 100, 300, 3), (4096, 16384, 256, 256, 8), (2048, 6144, 512, 2048, 2),
                 (8192, None, 1, 256, 8), (1000, None, 40, 8, 8)]


def _padding_rows_zero(got, real):
    assert bool((got.reshape(-1, got.shape[-1])[:, ~real] == 0).all())


@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n,n_src,bt,bs,sub", MASKED_SHAPES)
def test_k3_matches_plain_version(cuda, n, n_src, bt, bs, sub, with_valid, split):
    """Dense and compacted grids, square and rectangular, with padding (whose
    rows come out 0) and without (valid=None); tiles that are no power of two
    and wider than one stage included; the rule's S and S = 1. The compacted
    pass equals the dense one bit for bit, and a second pass the first."""
    c, tgt, src, mask, idx, dense, compact, real = _masked_case(
        cuda, n, n_src, bt, bs, sub, with_valid, contact=False)
    t3, s3 = tgt[:3].contiguous(), src[:3].contiguous()
    valid = real if with_valid else None
    got = tdw.downwash_masked_cuda(t3, s3, mask, dense, c, valid, split)
    assert torch.equal(tdw.downwash_masked_cuda(t3, s3, idx, compact, c, valid, split), got)
    assert torch.equal(tdw.downwash_masked_cuda(t3, s3, mask, dense, c, valid, split), got)
    _padding_rows_zero(got, real)
    want = tdw.downwash_masked_plain(t3, s3, mask, dense, c, valid)
    _padding_rows_zero(want, real)
    _wake_close(got[real], want[real])
    _wake_close(got[real], tdw.downwash_plain(t3, s3, c)[real])  # the masks drop nothing


@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n,n_src,bt,bs,sub", MASKED_SHAPES)
def test_k6_matches_plain_version(cuda, n, n_src, bt, bs, sub, with_valid, split):
    c, tgt, src, mask, idx, dense, compact, real = _masked_case(
        cuda, n, n_src, bt, bs, sub, with_valid, contact=True)
    valid = real if with_valid else None
    got = tia.interact_masked_cuda(tgt, src, mask, dense, c, valid, split)
    assert torch.equal(tia.interact_masked_cuda(tgt, src, idx, compact, c, valid, split), got)
    assert torch.equal(tia.interact_masked_cuda(tgt, src, mask, dense, c, valid, split), got)
    _padding_rows_zero(got, real)
    want = tia.interact_masked_plain(tgt, src, mask, dense, c, valid)
    _padding_rows_zero(want, real)
    _wake_close(got[0][real], want[0][real])
    _wake_close(got[0][real], tdw.downwash_plain(tgt[:3].contiguous(), src[:3].contiguous(),
                                                 c)[real])
    assert float(got[1:4].abs().max()) > 0  # contacts fired
    unmasked = tco.collide_plain(tgt, src, c)
    for ref in (want[1:], unmasked):
        torch.testing.assert_close((tgt + got[1:])[:, real], (tgt + ref)[:, real], rtol=0,
                                   atol=1e-6)


# Real drones per 256-slot tile of a binned-like layout, each tile's first
# slots: an all-padding tile, a partial warp, one full warp, partial and full
# tiles; the rest of a tile is padding, so whole warps and blocks hold none.
_TILE_FILL = (0, 5, 32, 100, 256, 64, 0, 200)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_k3_k6_skip_padding_targets(cuda, split):
    """On a binned-like layout: padding rows exactly 0, real rows at the
    plain versions' limits and against the unmasked plain passes of the real
    drones alone, compacted = dense bit for bit, a second pass bit for bit
    the first; with valid=None the real rows agree too."""
    c = _pair_consts()
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    bt = 256
    cloud, _ = _pair_cloud(cuda, sum(_TILE_FILL))
    slots = torch.arange(len(_TILE_FILL) * bt, device=cuda)
    fill = torch.tensor(_TILE_FILL, device=cuda)
    real = (slots % bt) < fill[slots // bt]
    cols = torch.tensor([0.0, 0.0, -1e9, 0.0, 0.0, 0.0], device=cuda)[:, None].repeat(
        1, slots.numel())
    cols[:, real] = cloud
    mask = tsp.subtile_packed_mask(cols[0], cols[1], cols[2], bt, bt, min_dist=c.min_dist,
                                   params=p, valid=real, sub=8)
    n_tiles = len(_TILE_FILL)
    idx, _ = tsp.compact_live_tiles(mask, n_tiles, n_tiles, n_tiles)
    dense = tpairs.TileGrid(bt, bt, 8, n_tiles, False)
    compact = dense._replace(compact=True)
    alone = cloud[:3].contiguous()
    for kernel, plain, rows in ((tdw.downwash_masked_cuda, tdw.downwash_masked_plain, 3),
                                (tia.interact_masked_cuda, tia.interact_masked_plain, 6)):
        t = cols[:rows].contiguous()
        got = kernel(t, t, mask, dense, c, real, split).reshape(-1, t.shape[1])
        assert torch.equal(kernel(t, t, idx, compact, c, real, split).reshape(got.shape), got)
        assert torch.equal(kernel(t, t, mask, dense, c, real, split).reshape(got.shape), got)
        _padding_rows_zero(got, real)
        want = plain(t, t, mask, dense, c, real).reshape(got.shape)
        _wake_close(got[0][real], want[0][real])
        _wake_close(got[0][real], tdw.downwash_plain(alone, alone, c))
        if rows == 6:
            assert float(got[1:4].abs().max()) > 0  # contacts fired
            torch.testing.assert_close((cloud + got[1:][:, real]), (cloud + want[1:][:, real]),
                                       rtol=0, atol=1e-6)
        unpadded = kernel(t, t, mask, dense, c, None, split).reshape(got.shape)
        _wake_close(unpadded[0][real], want[0][real])


def test_masked_passes_count_launches_and_overflows(cuda):
    """A cap of one live tile a row overflows on this cloud: the pass takes
    the overflow branch (the dense masked grid, or z-sorted K2 / K5) and
    says so; the launch counters follow the kernels that ran."""
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    cols, _ = _pair_cloud(cuda, 4096)
    x = [cols[i] for i in range(6)]
    ref = tdw.make_downwash_masked(p, device=cuda).cols(*x[:3])
    for fallback, k3, k2 in ((True, 1, 0), (False, 0, 1)):
        before = (tdw.downwash_masked_cuda.launches, tdw.downwash_cuda.launches,
                  tdw.make_downwash_masked.overflows)
        got = tdw.make_downwash_masked(p, neighbor_cap=1, dense_fallback=fallback,
                                       device=cuda).cols(*x[:3])
        after = (tdw.downwash_masked_cuda.launches, tdw.downwash_cuda.launches,
                 tdw.make_downwash_masked.overflows)
        assert [a - b for a, b in zip(after, before)] == [k3, k2, 1]
        _wake_close(got, ref)
    before = (tia.interact_masked_cuda.launches, tia.interact_cuda.launches,
              tia.make_interact_masked.overflows)
    tia.make_interact_masked(p, neighbor_cap=16, device=cuda).cols(*x)  # 16 source tiles: holds
    tia.make_interact_masked(p, neighbor_cap=1, dense_fallback=False, device=cuda).cols(*x)
    after = (tia.interact_masked_cuda.launches, tia.interact_cuda.launches,
             tia.make_interact_masked.overflows)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def test_masked_kernels_reject_what_they_do_not_take(cuda):
    c, tgt, src, mask, idx, dense, compact, _ = _masked_case(cuda, 1024, None, 128, 128, 1,
                                                             False, contact=True)
    with pytest.raises(ValueError, match="int32 words"):
        tia.interact_masked_cuda(tgt, src, mask.long(), dense, c)
    with pytest.raises(ValueError, match="do not divide"):
        tia.interact_masked_cuda(tgt, src, mask, dense._replace(bt=100), c)
    with pytest.raises(ValueError, match="CUDA"):
        tdw.downwash_masked_cuda(tgt[:3].cpu(), src[:3].cpu(), mask, dense, c)
    with pytest.raises(ValueError, match="bool valid column"):
        tia.interact_masked_cuda(tgt, src, mask, dense, c, torch.ones(1024, device=cuda))
    with pytest.raises(ValueError, match="source ranks"):
        tia.interact_masked_cuda(tgt, src, mask, dense, c, None, 3)


# ---------------------------------------------------------------------------
# The sequential-impulse contact solver (core/contact.py) on the card
# ---------------------------------------------------------------------------


def _contact_case(regime, dtype=torch.float64, seed=0):
    """(pos, quat, vel, ang_v) numpy arrays and solver keywords (by device)."""
    from gym_pybullet_drones_tpu_torch.core import collisions as tcol
    from gym_pybullet_drones_tpu_torch.core.rotations import euler_xyz_to_quat

    rng = np.random.RandomState(seed)
    shape = dict(plane_obstacles=(64, 1), pairs=(64, 2), neighbor=(1, 200))[regime]
    side = 0.08 * shape[1] ** (1 / 3)
    pos = rng.uniform(0.0, side, shape + (3,))
    pos[..., 2] = rng.uniform(0.0, 0.02, shape)
    if regime == "plane_obstacles":  # beside the RL block, on the plane
        pos += [0.9, 0.0, 0.0]
    quat = euler_xyz_to_quat(torch.as_tensor(rng.uniform(-0.6, 0.6, shape + (3,)))).numpy()
    arrays = (pos, quat, rng.normal(0, 0.6, shape + (3,)), rng.normal(0, 2.0, shape + (3,)))
    if regime == "neighbor":
        arrays = tuple(a[0] for a in arrays)

    def kw(device):
        if regime == "plane_obstacles":
            return dict(obstacles=tcol.rl_obstacles(dtype, device))
        return dict(drone_drone=True, env_batched=regime == "pairs")

    return arrays, kw


@pytest.mark.parametrize("regime", ["plane_obstacles", "pairs", "neighbor"])
def test_solve_contacts_on_the_card_matches_the_cpu(cuda, regime):
    """One solve in float64 on the card against the CPU at 1e-10: the plane
    and obstacle rows (64 envs of one drone), the exact pair rows (64 envs of
    two) and the neighbor rows (200 drones)."""
    from gym_pybullet_drones_tpu_torch.core import contact as tcon
    from gym_pybullet_drones_tpu_torch.core.params import drone_params

    arrays, kw = _contact_case(regime)
    out = {}
    for dev in ("cpu", cuda):
        p = drone_params(dtype=torch.float64, device=dev)
        t = [torch.as_tensor(a, dtype=torch.float64, device=dev) for a in arrays]
        out[str(dev)] = [x.cpu() for x in tcon.solve_contacts(*t, p, 1 / 240, **kw(dev))]
    assert (out["cpu"][0] - torch.as_tensor(arrays[2])).abs().max() > 1e-2  # the rows acted
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_neighbor_solve_repeats_bit_for_bit_on_the_card(cuda):
    """Partners pushed by several owners in one sub-pass are summed in owner
    order (index_put_ with accumulate sorts its indices stably), so a float32
    solve of a touching lattice repeats itself bit for bit."""
    from gym_pybullet_drones_tpu_torch.core import contact as tcon
    from gym_pybullet_drones_tpu_torch.core.params import drone_params

    rng = np.random.RandomState(2)
    g = np.stack(np.meshgrid(np.arange(64) * 0.1, np.arange(64) * 0.1), -1).reshape(-1, 2)
    pos = np.concatenate([g + rng.uniform(-0.005, 0.005, g.shape), np.ones((len(g), 1))], 1)
    n = len(pos)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    quat = t(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)))
    p = drone_params(device=cuda)
    args = (t(pos), quat, t(rng.normal(0, 0.3, (n, 3))), t(np.zeros((n, 3))), p, 1 / 240)
    first = tcon.solve_contacts(*args, drone_drone=True)
    second = tcon.solve_contacts(*args, drone_drone=True)
    assert (first[0] - args[2]).abs().max() > 1e-2
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("build", ["build_pair_candidates", "build_pair_candidates_binned"])
@pytest.mark.parametrize("kind", ["jittered", "lattice"])
def test_candidate_sets_on_the_card_match_the_cpu(cuda, build, kind):
    """idx and in_band on the card equal to the CPU's element for element in
    float32, exact distance ties included (a 1/8 m lattice)."""
    from gym_pybullet_drones_tpu_torch.core import contact as tcon

    if kind == "jittered":
        rng = np.random.RandomState(3)
        centers = rng.uniform(0, 40, (1024, 3)) + [0, 0, 2]
        pos = np.concatenate([centers, centers + rng.normal(0, 0.07, centers.shape)])
    else:
        g = np.stack(np.meshgrid(*(np.arange(k) for k in (9, 8, 5)), indexing="ij"), -1)
        pos = g.reshape(-1, 3) * 0.125 + [3.0, -2.0, 1.0]
    build = getattr(tcon, build)
    want = build(torch.as_tensor(pos, dtype=torch.float32), 0.06)
    got = build(torch.as_tensor(pos, dtype=torch.float32, device=cuda), 0.06)
    assert bool(want[1].any())
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.cpu(), w_)


def test_impulse_step_physics_defaults_to_the_card(cuda):
    """The entry points without a device run on the card: step_physics in the
    impulse mode and the Aviary bundle of the contact checkpoints' config."""
    from gym_pybullet_drones_tpu_torch.core import dynamics as tdyn
    from gym_pybullet_drones_tpu_torch.core.params import drone_params
    from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, Physics

    p = drone_params()
    kin = tdyn.init_kin_state(torch.tensor([[0.0, 0.0, 0.02], [0.11, 0.0, 0.02]]),
                              torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 2), device=p.m.device)
    rpm = torch.zeros((2, 4), device=p.m.device)
    out, _ = tdyn.step_physics(kin, rpm, rpm, p, 1 / 240, 8, Physics.PYB, collisions=True,
                               contact_mode="impulse")
    assert out.pos.is_cuda and bool(torch.isfinite(out.vel).all())
    cfg = tbase.AviaryConfig(num_drones=2, task=tbase.TASK_MULTIHOVER, ctrl_freq=30,
                             action_type=ActionType.ONE_D_RPM, action_buffer_size=15,
                             collisions=True, contact_mode="impulse")
    av = tbase.Aviary(cfg)
    state, obs = av.reset()
    state, obs, *_ = av.step(state, -torch.ones((2, 1), device=obs.device))
    assert obs.is_cuda and bool(torch.isfinite(obs).all())


def _ppo_hover():
    from gym_pybullet_drones_tpu_torch.envs.spec import ActionType

    return tbase.AviaryConfig(num_drones=1, task=tbase.TASK_HOVER, ctrl_freq=30,
                              action_type=ActionType.ONE_D_RPM, action_buffer_size=15,
                              episode_len_sec=0.5)


def test_ppo_train_step_stays_on_the_card_and_repeats(cuda):
    """ppo_init and the train step without a device run on the card, leave
    every tensor there, and repeat bit for bit from the same seed (noise,
    permutations and init from the runner's CUDA generator)."""
    from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

    cfg = _ppo_hover()
    ppo_cfg = tppo.PPOConfig(num_envs=32, n_steps=16, minibatch_size=128, n_epochs=2,
                             log_std_anneal_to=-1.0, log_std_anneal_updates=2)
    runs = []
    for _ in range(2):
        runner, aux = tppo.ppo_init(cfg, ppo_cfg, 11, domain_rand={"m": 0.1})
        train = tppo.make_ppo_train_step(cfg, ppo_cfg, aux)
        for _ in range(2):
            runner, metrics = train(runner)
        runs.append((runner, metrics))
    (a, ma), (b, mb) = runs
    assert a.generator.device.type == "cuda" and aux["train_params_env"].m.is_cuda
    leaves = []
    a.env_state.map(lambda t: leaves.append(t) or t)
    assert all(t.is_cuda for t in leaves + [a.obs, *a.params.parameters(), *ma.values()])
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(p, q)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert torch.equal(a.env_state.kin.pos, b.env_state.kin.pos)


def test_randomize_params_and_checkpoints_load_alike_on_the_card(cuda):
    """randomize_params from one CPU generator state, and a checkpoint's
    policy, give the CPU's tensors on the card."""
    import os

    from gym_pybullet_drones_tpu_torch import convert
    from gym_pybullet_drones_tpu_torch.core.params import drone_params, randomize_params

    spec = {"m": 0.1, "kf": 0.05, "inertia": 0.2, "drag": 0.1}
    on = randomize_params(torch.Generator().manual_seed(2), drone_params(), 64, spec)
    off = randomize_params(torch.Generator().manual_seed(2), drone_params(device="cpu"), 64,
                           spec)
    got, want = [], []
    on.map(lambda t: got.append(t) or t)
    off.map(lambda t: want.append(t) or t)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints", "rpm4_multihover.msgpack")
    tree = convert.load_flax_msgpack(path)
    net, ref = convert.actor_critic_from_flax(tree), convert.actor_critic_from_flax(tree, "cpu")
    for p, q in zip(net.parameters(), ref.parameters()):
        assert p.is_cuda and torch.equal(p.cpu(), q)


# K7 (csrc/render_views.cu): the camera at chip_smoke.py phase 10b's limits.
RENDER_SEG_SHARE, RENDER_RGBA, RENDER_DEP = 0.999, 1, 1e-6


def _render_case(device, B, N, seed, spread=1.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-spread, -spread, 0.05], [spread, spread, 1.5], (B, N, 3))
    q = rng.normal(size=(B, N, 4))
    q = 0.3 * q / np.linalg.norm(q, axis=-1, keepdims=True) + np.array([0.0, 0.0, 0.0, 1.0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    arm = np.full(B, 0.0397)
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in (pos, q, arm)]


def _hold_render(got, want):
    same = got[2] == want[2]
    assert float(same.float().mean()) >= RENDER_SEG_SHARE, int((~same).sum())
    rgba_gap = (got[0].int() - want[0].int()).abs().amax(-1)
    assert int(rgba_gap[same].max()) <= RENDER_RGBA
    assert float((got[1] - want[1]).abs()[same].max()) <= RENDER_DEP


@pytest.mark.parametrize("B,N,cfg", [
    (64, 1, {}), (32, 2, {}), (1, 12, {}), (8, 3, dict(scene="base")),
    (4, 2, dict(drone_proxy="xframe")), (3, 40, dict(drone_proxy="mesh")),
    (2, 2, dict(with_landmarks=False, width=128, height=96, frame_angle_deg=0.0)),
], ids=["rl_1", "mesh_2", "xframe_12", "base_3", "xframe_forced", "mesh_40_global",
        "bare_large_cf2p"])
def test_k7_matches_plain_version(cuda, B, N, cfg):
    from gym_pybullet_drones_tpu_torch.ops import render_views as trv
    from gym_pybullet_drones_tpu_torch.render import camera as tcam

    pos, quat, arm = _render_case(cuda, B, N, seed=N)
    c = tcam.CameraConfig(**cfg)
    cam = list(range(N))
    before = trv.render_views_cuda.launches
    got = trv.render_views_cuda(pos, quat, arm, cam, c)
    want = tcam.render_drone_views_plain(pos, quat, arm, cam, c)
    torch.cuda.synchronize()
    assert trv.render_views_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.device == w.device
    _hold_render(got, want)


def test_k7_is_the_render_entry_on_the_card_and_under_vmap(cuda):
    """render_drone_views on CUDA tensors launches K7 (and equals the CPU's
    plain render at the limits); under torch.func.vmap it launches K7 once
    for the whole batch; the RGB env's entry points default to the card."""
    from gym_pybullet_drones_tpu_torch.envs import spec as tspec
    from gym_pybullet_drones_tpu_torch.ops import render_views as trv
    from gym_pybullet_drones_tpu_torch.render import camera as tcam
    from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

    pos, quat, arm = _render_case(cuda, 6, 2, seed=7)
    before = trv.render_views_cuda.launches
    got = tcam.render_drone_views(pos, quat, arm)
    assert trv.render_views_cuda.launches == before + 1
    cpu = tcam.render_drone_views(pos.cpu(), quat.cpu(), arm.cpu())
    _hold_render([g.cpu() for g in got], cpu)
    mapped = torch.func.vmap(tcam.render_drone_views)(pos, quat, arm)
    assert trv.render_views_cuda.launches == before + 2
    for m, g in zip(mapped, got):
        assert torch.equal(m, g)
    cfg = tbase.AviaryConfig(num_drones=1, task="hover", pyb_freq=240, ctrl_freq=30,
                             action_type=tspec.ActionType.ONE_D_RPM, action_buffer_size=15,
                             obs_type=tspec.ObservationType.RGB, frame_stack=4)
    runner, aux = tppo.ppo_init(cfg, tppo.PPOConfig(num_envs=4, n_steps=4, minibatch_size=16,
                                                    n_epochs=1), 0,
                                domain_rand={"m": 0.1, "kf": 0.05})
    assert runner.obs.is_cuda and runner.obs.dtype == torch.uint8
    assert isinstance(runner.params, tppo.CnnActorCritic)
    train = tppo.make_ppo_train_step(cfg, tppo.PPOConfig(
        num_envs=4, n_steps=4, minibatch_size=16, n_epochs=1), aux)
    before = trv.render_views_cuda.launches
    runner, metrics = train(runner)
    assert trv.render_views_cuda.launches - before == 4  # one a control step, under vmap
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_k7_rejects_what_it_does_not_take(cuda):
    from gym_pybullet_drones_tpu_torch.ops import render_views as trv
    from gym_pybullet_drones_tpu_torch.render import camera as tcam

    pos, quat, arm = _render_case(cuda, 2, 2, seed=1)
    c = tcam.CameraConfig()
    with pytest.raises(TypeError):
        trv.render_views_cuda(pos.double(), quat.double(), arm.double(), [0, 1], c)
    with pytest.raises(ValueError):
        trv.render_views_cuda(pos, quat, arm.cpu(), [0, 1], c)
    with pytest.raises(ValueError):
        trv.render_views_cuda(pos, quat, arm, [2], c)
    with pytest.raises(ValueError):
        trv.render_views_cuda(pos[:, :, :2].contiguous(), quat, arm, [0], c)


# The controllers (control/) and the shells' device functions (runtime/shell.py)
# on the card against the CPU, float32, at tests/test_soa.py:52-59's limits.
CARD_LIMITS = dict(pos=1e-3, vel=2e-3, quat=1e-3)


def test_controllers_on_the_card_match_the_cpu(cuda):
    """CTBR, MRAC (20 steps, gains carried), Mellinger (20 ticks, memory
    carried) and the mission setpoint on 64 seeded drones; every entry point
    defaults to the card."""
    from gym_pybullet_drones_tpu_torch.control import commander as tcom
    from gym_pybullet_drones_tpu_torch.control import ctbr as tctbr
    from gym_pybullet_drones_tpu_torch.control import mellinger as tmel
    from gym_pybullet_drones_tpu_torch.control import mrac as tmrac

    assert tctbr.ctbr_params().k_p.is_cuda and tmrac.mrac_params().Am.is_cuda
    assert tmel.mellinger_params().lpf.b0.is_cuda and tmel.mellinger_reset((2,)).i_error.is_cuda
    rng = np.random.default_rng(0)
    n = 64
    q = rng.normal(size=(n, 4)) * 0.2 + np.array([0, 0, 0, 1.0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    raw = dict(pos=rng.uniform(-1, 1, (n, 3)) + [0, 0, 1], quat=q, vel=rng.uniform(-1, 1, (n, 3)),
               ang=rng.uniform(-1, 1, (n, 3)), tgt=rng.uniform(-1, 1, (n, 3)) + [0, 0, 1])
    out = []
    for d in (cuda, torch.device("cpu")):
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=d) for k, v in raw.items()}
        res = [tctbr.ctbr_control(tctbr.ctbr_params(device=d), t["pos"], t["quat"], t["vel"],
                                  t["tgt"])]
        mp = tmrac.mrac_params(device=d)
        ms = tmrac.mrac_reset(mp, (n,))
        mel_p, mel_s = tmel.mellinger_params(device=d), tmel.mellinger_reset((n,), device=d)
        for _ in range(20):
            rpm, ms, _, _ = tmrac.mrac_control(mp, ms, 1.0 / 120.0, t["pos"], t["quat"],
                                               t["vel"], t["ang"], t["tgt"])
            mrpm, mel_s = tmel.mellinger_rpm(mel_p, mel_s, t["pos"], t["vel"], t["quat"],
                                             t["ang"] * 50.0, t["tgt"])
        legs = tcom.plan_mission(raw["pos"], np.zeros(n), [{"pos": raw["tgt"], "duration": 2.0,
                                                           "hold": 0.5}], device=d)
        sp = tcom.mission_setpoint(legs, torch.full((n,), 1.3, device=d))
        res += [rpm, ms.Kx, mrpm, mel_s.i_error_m, sp["pos"], sp["acc"]]
        out.append([r.cpu() for r in res])
    for card, cpu in zip(*out):
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-3)


def test_shell_device_functions_on_the_card_match_the_cpu(cuda):
    """shell_step (the single shell's step) and make_vec_core (VecAviary's),
    Hover at 240/30 Hz, 30 steps (1 s) of seeded actions: obs on the card
    against the CPU; the vector core's K7 launches once a control step on
    an RGB config, its frames equal to the CPU's."""
    from gym_pybullet_drones_tpu_torch.envs import spec as tspec
    from gym_pybullet_drones_tpu_torch.ops import render_views as trv
    from gym_pybullet_drones_tpu_torch.runtime import shell as tshell

    cfg = tshell.shell_config(task="hover", pyb_freq=240, ctrl_freq=30, obstacles=True,
                              action_buffer_size=15)
    acts = np.random.default_rng(1).uniform(-0.3, 0.3, (30, 16, 1, 4)).astype(np.float32)
    single, vec = [], []
    for d in (cuda, torch.device("cpu")):
        p = tbase.build_params(cfg, d)
        cp, tgt = tbase.build_ctrl_params(cfg, d), tbase.hover_target_pos(cfg, p)
        state, rows = tbase.reset(cfg, p), []
        for a in acts[:, 0]:
            state, obs, *_ = tshell.shell_step(cfg, p, cp, tgt, state, a)
            rows.append(obs)
        single.append(np.stack(rows))
        reset, step = tshell.make_vec_core(cfg, p, cp, tgt, 16, d)
        state, obs = reset()
        rows = [obs]
        for a in acts:
            state, out = step(state, a)
            rows.append(out[0])
        vec.append(np.stack(rows))
    np.testing.assert_allclose(*single, atol=1e-3)
    np.testing.assert_allclose(*vec, atol=1e-3)

    rgb = tshell.shell_config(task="hover", pyb_freq=240, ctrl_freq=30, obstacles=True,
                              action_buffer_size=15, obs=tspec.ObservationType.RGB,
                              frame_stack=4)
    frames = []
    for d in (cuda, torch.device("cpu")):
        p = tbase.build_params(rgb, d)
        reset, step = tshell.make_vec_core(rgb, p, tbase.build_ctrl_params(rgb, d),
                                           tbase.hover_target_pos(rgb, p), 4, d)
        state, obs = reset()
        before = trv.render_views_cuda.launches
        rows = [obs]
        for a in acts[:6, :4]:
            state, out = step(state, a)
            rows.append(out[0])
        if d.type == "cuda":
            assert trv.render_views_cuda.launches - before == 6
        frames.append(np.stack(rows))
    assert frames[0].dtype == np.uint8 and frames[0].shape[-1] == 16
    np.testing.assert_array_equal(*frames)


# ---------------- the sharded swarms' rectangular passes; the native bridges ----------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_swarm_passes_match_plain_versions(cuda, world):
    """runtime/swarm.make_sharded_swarm_physics's pair-pass path: each rank's
    slab of N / world targets against the gathered N sources, through the
    factories' rectangular entries (K2 z-sorted from 8192 drones, K4), against
    the same factories on the CPU (the plain versions)."""
    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    n = 16384
    _, cloud = _pair_cloud("cpu", n)
    pos, vel = cloud[:3].T.contiguous(), cloud[3:].T.contiguous()
    dw = {d: tdw.make_downwash(p, device=d) for d in (cuda, "cpu")}
    co = {d: tco.make_collide(p, return_delta=True, device=d) for d in (cuda, "cpu")}
    before = (tdw.downwash_cuda.launches, tco.collide_cuda.launches)
    fired = 0.0
    for r in range(world):
        rows = slice(r * n // world, (r + 1) * n // world)
        got = dw[cuda](pos[rows].to(cuda), src_pos=pos.to(cuda))
        _wake_close(got.cpu(), dw["cpu"](pos[rows], src_pos=pos))
        dp, dv = co[cuda](pos[rows].to(cuda), vel[rows].to(cuda), src_pos=pos.to(cuda),
                          src_vel=vel.to(cuda))
        wp, wv = co["cpu"](pos[rows], vel[rows], src_pos=pos, src_vel=vel)
        torch.testing.assert_close(pos[rows] + dp.cpu(), pos[rows] + wp, rtol=0, atol=1e-6)
        torch.testing.assert_close(vel[rows] + dv.cpu(), vel[rows] + wv, rtol=0, atol=1e-6)
        fired = max(fired, float(dp.abs().max()))
    assert fired > 0  # contacts fired
    assert (tdw.downwash_cuda.launches - before[0], tco.collide_cuda.launches - before[1]) == (
        world, world)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_binned_passes_match_plain_versions(cuda, world):
    """ops/swarm_binned's sharded pair passes: a rank's slab of a binned layout
    (whole cells) against every rank's gathered slot columns and padding, K3
    and K6 through the masked factories' ``src`` / ``src_valid`` entries,
    against the CPU's plain versions and against the square pass's rows."""
    from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state
    from gym_pybullet_drones_tpu_torch.ops.swarm_binned import make_binned_swarm

    p = tbase.build_params(tbase.AviaryConfig(), "cpu")
    pos, vel = _spread_fleet(4096)
    kin = init_kin_state(pos, np.tile([0.0, 0.0, 0.0, 1.0], (4096, 1)), device="cpu")
    kin = kin.replace(vel=torch.as_tensor(vel))
    init, _, _ = make_binned_swarm(p, 1 / 240, 5, cell_size=10.0, nx=2, ny=2, cap=2048,
                                   device="cpu")
    s = init(kin)
    cols = [s[k] for k in ("px", "py", "pz", "vx", "vy", "vz")]
    valid, nslots = s["valid"], s["px"].shape[0]
    opts = dict(bt=2048, bs=2048, neighbor_cap=4, dense_fallback=False)
    for maker, k in ((tdw.make_downwash_masked, 3), (tia.make_interact_masked, 6)):
        dev_pass, cpu_pass = maker(p, device=cuda, **opts), maker(p, device="cpu", **opts)
        square = cpu_pass.cols(*cols[:k], valid=valid)
        for r in range(world):
            rows = slice(r * nslots // world, (r + 1) * nslots // world)
            args = dict(valid=valid[rows], src=tuple(cols[:k]), src_valid=valid)
            want = cpu_pass.cols(*(c[rows] for c in cols[:k]), **args)
            got = dev_pass.cols(*(c[rows].to(cuda) for c in cols[:k]),
                                valid=valid[rows].to(cuda),
                                src=tuple(c.to(cuda) for c in cols[:k]),
                                src_valid=valid.to(cuda))
            if k == 3:
                _wake_close(got.cpu(), want)
                assert torch.equal(want, square[rows])
                continue
            _wake_close(got[0].cpu(), want[0])
            assert torch.equal(want[0], square[0][rows])
            for g, w, c in zip(got[1] + got[2], want[1] + want[2], cols):
                torch.testing.assert_close(c[rows] + g.cpu(), c[rows] + w, rtol=0, atol=1e-6)


def test_native_bridges_build_and_run_on_the_gpu_machine(cuda):
    """The bridges build with the machine's g++ into the port's _build/, the
    firmware's planner and the UDP bridge run, and the firmware loop flies
    one second on the card as on the CPU."""
    import socket
    import struct

    from gym_pybullet_drones_tpu_torch.bridges import betaflight, cffirmware
    from gym_pybullet_drones_tpu_torch.runtime.firmware import CFShellEnv

    firm = cffirmware
    firm.crtpCommanderHighLevelInit()
    state = firm.state_t()
    state.attitudeQuaternion.w = 1.0
    firm.crtpCommanderHighLevelTellState(state)
    firm.crtpCommanderHighLevelUpdateTime(0.0)
    firm.crtpCommanderHighLevelTakeoff(1.0, 2.0)
    sp = firm.setpoint_t()
    firm.crtpCommanderHighLevelUpdateTime(2.0)
    firm.crtpCommanderHighLevelGetSetpoint(sp, state)
    assert abs(sp.position.z - 1.0) < 1e-5

    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.2", 9003 + 10 * 7))
    recv.settimeout(1.0)
    bridge = betaflight.BetaBridge(7, "127.0.0.2")
    try:
        assert bridge.send_fdm(1.25, [0.1, 0.2, 0.3])
        vals = struct.unpack("@dddddddddddddddddd", recv.recvfrom(1024)[0])
    finally:
        bridge.close()
        recv.close()
    np.testing.assert_allclose(vals[:4], [1.25, 0.1, -0.2, -0.3])

    flights = []
    for d in (cuda, "cpu"):
        env = CFShellEnv(pyb_freq=500, ctrl_freq=25, device=d)
        env.reset()
        env.sendTakeoffCmd(1.0, 2.0)
        for i in range(25):
            obs = env.step(i)[0]
        assert not env._error and env.tick == 500
        assert env._state.kin.pos.device.type == torch.device(d).type
        env.close()
        flights.append(obs[0, :3])
    np.testing.assert_allclose(*flights, atol=0.03)
