"""Kernel K1 (csrc/velocity_rollout.cu) against its plain PyTorch version on the
card. Needs a CUDA card and nvcc: run on the GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (the card is looked for inside a fixture, so all
pytest workers collect the same tests)."""

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu_torch.envs import base as tbase
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
