"""Kernels K1 (csrc/velocity_rollout.cu) and K2, K4, K5 (csrc/pair_kernels.cu)
against their plain PyTorch versions on the card. Needs a CUDA card and nvcc: run on the GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (the card is looked for inside a fixture, so all
pytest workers collect the same tests)."""

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.ops import _pairs as tpairs
from gym_pybullet_drones_tpu_torch.ops import collide_pairs as tco
from gym_pybullet_drones_tpu_torch.ops import downwash_pairs as tdw
from gym_pybullet_drones_tpu_torch.ops import interact_pairs as tia
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as tro
from gym_pybullet_drones_tpu_torch.ops import velocity_soa as tsoa
from gym_pybullet_drones_tpu_torch.runtime import rollout as troll

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


# ---------------- K2, K4, K5 (csrc/pair_kernels.cu) ----------------


def _pair_cloud(device, n, n_src=None, seed=11):
    """tests/test_soa.py's cloud (4 x 4 x 1.5 m per 1024 drones, scaled with
    N), with overlapping pairs sprinkled in, stacked as (6, N) float32."""
    rng = np.random.RandomState(seed)
    m = n if n_src is None else n_src
    scale = (m / 1024) ** (1 / 3)
    pos = rng.uniform(-1, 1, (m, 3)) * np.array([4, 4, 1.5]) * scale + [0, 0, 2.0]
    pos[1::64] = pos[0::64] + [0.08, 0.0, 0.05]
    vel = rng.uniform(-0.5, 0.5, (m, 3))
    src = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), dtype=torch.float32,
                          device=device)
    tgt = src if n_src is None else (src[:, :n] + 0.01).contiguous()
    return tgt, src


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
@pytest.mark.parametrize("n,n_src", [(1000, None), (4096, None), (16384, None), (4096, 16384)])
def test_k2_k4_match_plain_versions(cuda, n, n_src, sort):
    """Square and rectangular, z-sorted (culled) and not; ragged at 1000."""
    c = _pair_consts()
    tgt, src = _pair_cloud(cuda, n, n_src)
    square = n_src is None
    if sort:
        tgt, src = _sorted(tgt, src, square)
    w = tdw.downwash_cuda(tgt[:3].contiguous(), src[:3].contiguous(), c, cull=sort, square=square)
    _wake_close(w, tdw.downwash_plain(tgt[:3].contiguous(), src[:3].contiguous(), c))
    d = tco.collide_cuda(tgt, src, c, cull=sort, square=square)
    want = tco.collide_plain(tgt, src, c)
    assert float(d[:3].abs().max()) > 0  # contacts fired
    torch.testing.assert_close(tgt[:3] + d[:3], tgt[:3] + want[:3], rtol=0, atol=1e-6)
    torch.testing.assert_close(tgt[3:] + d[3:], tgt[3:] + want[3:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n", [1000, 4096, 16384])
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
