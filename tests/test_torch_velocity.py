"""The port's SoA velocity step and its rollout (K1's plain version) against the
JAX package: the general env step in float64, the JAX SoA step in float32,
and the Pallas rollout in interpret mode."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import base as jbase
from gym_pybullet_drones_tpu.ops import velocity_soa as jsoa
from gym_pybullet_drones_tpu.ops.velocity_pallas import make_velocity_rollout_pallas
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import base as tbase
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as tro
from gym_pybullet_drones_tpu_torch.ops import velocity_soa as tsoa
from torch_parity import jit_reference

# The JAX runtime package re-exports a function named `rollout` over its module.
jroll = importlib.import_module("gym_pybullet_drones_tpu.runtime.rollout")
troll = importlib.import_module("gym_pybullet_drones_tpu_torch.runtime.rollout")


def _setup(dtype):
    jcfg = jbase.AviaryConfig(task=jbase.TASK_VELOCITY, pyb_freq=240, ctrl_freq=48,
                              dtype=dtype)
    tcfg = tbase.AviaryConfig(task=tbase.TASK_VELOCITY, pyb_freq=240, ctrl_freq=48,
                              dtype=dtype)
    jp, jcp = jbase.build_params(jcfg), jbase.build_ctrl_params(jcfg)
    tp, tcp = tbase.build_params(tcfg, "cpu"), tbase.build_ctrl_params(tcfg, "cpu")
    sl = 0.03 * float(tp.max_speed_kmh) * (1000.0 / 3600.0)
    return jcfg, tcfg, jp, jcp, tp, tcp, sl


def _actions(seed, E):
    rng = np.random.RandomState(seed)
    a = np.zeros((E, 4))
    a[:, 0:3] = rng.uniform(-1, 1, (E, 3))
    a[:, 3] = rng.uniform(0, 1, E)
    return a


def _cols(a, dtype):
    return {k: torch.as_tensor(a[:, i], dtype=dtype) for i, k in enumerate(tsoa.ACTION_KEYS)}


def test_soa_float64_matches_general_jax_step():
    """(a) The port's SoA step in float64 against the JAX package's general env
    step in float64, through soa_to_state: 20 steps at E = 64, 1e-9 (plus
    1e-11 relative: the SoA form skips the reference's matrix -> euler ->
    matrix round trip, and the attitude gains carry that last-ulp difference
    into RPMs of ~1e4)."""
    jcfg, tcfg, jp, jcp, tp, tcp, sl = _setup("float64")
    E, T = 64, 20
    a = _actions(0, E)
    jstep = jit_reference(jroll.make_batched_step(jcfg, jp, jcp, jnp.zeros((1, 3)),
                                            auto_reset=False))
    js = jroll.batch_reset(jcfg, jp, E)
    for _ in range(T):
        js, _ = jstep(js, jnp.asarray(a[:, None, :]))
    template = troll.batch_reset(tcfg, tp, E, device="cpu")
    s = tsoa.soa_from_state(template)
    consts, act = tsoa.soa_consts(tcp, tp), _cols(a, torch.float64)
    for _ in range(T):
        s = tsoa.velocity_step_soa(consts, tcfg.ctrl_timestep, tcfg.pyb_timestep,
                                   tcfg.steps_per_ctrl, sl, s, *act.values())
    got = convert.aviary_state_to_numpy(
        tsoa.soa_to_state(s, template, pyb_steps=T * tcfg.steps_per_ctrl))
    want = convert.aviary_state_to_numpy(js)
    for k in convert.AVIARY_STATE_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-11, atol=1e-9, err_msg=k)


def test_soa_float32_matches_jax_soa():
    """(b) Float32 SoA against the JAX SoA step (whose inverse trig is the
    Pallas-compatible approximation), at tests/test_soa.py:52-59's tolerances."""
    jcfg, tcfg, jp, jcp, tp, tcp, sl = _setup("float32")
    E, T = 64, 20
    a = _actions(0, E).astype(np.float32)
    jconsts = jsoa.soa_consts(jcp, jp)
    jstep = jit_reference(lambda s, a: jsoa.velocity_step_soa(
        jconsts, jcfg.ctrl_timestep, jcfg.pyb_timestep, jcfg.steps_per_ctrl, sl, s,
        a[:, 0], a[:, 1], a[:, 2], a[:, 3]))
    js = jsoa.soa_from_state(jroll.batch_reset(jcfg, jp, E))
    ts = tsoa.soa_from_state(troll.batch_reset(tcfg, tp, E, device="cpu"))
    consts, act = tsoa.soa_consts(tcp, tp), _cols(a, torch.float32)
    for _ in range(T):
        js = jstep(js, jnp.asarray(a))
        ts = tsoa.velocity_step_soa(consts, tcfg.ctrl_timestep, tcfg.pyb_timestep,
                                    tcfg.steps_per_ctrl, sl, ts, *act.values())
    limits = dict(px=1e-3, py=1e-3, pz=1e-3, vx=2e-3, vy=2e-3, vz=2e-3, qx=1e-3, qy=1e-3,
                  qz=1e-3, qw=1e-3, r0=20.0, r1=20.0, r2=20.0, r3=20.0)
    for k, lim in limits.items():
        assert ts[k].dtype == torch.float32
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=0, atol=lim, err_msg=k)


def test_plain_rollout_matches_pallas_interpret():
    """(c) make_velocity_rollout on the CPU (K1's plain version) against
    make_velocity_rollout_pallas(interpret=True): E = 1024, T = 8, atol 1e-5
    on px, py, pz, qw, vx, vz as in tests/test_soa.py:91-93."""
    jcfg, tcfg, jp, jcp, tp, tcp, sl = _setup("float32")
    E, T = 1024, 8
    rng = np.random.RandomState(1)
    a = np.stack([rng.uniform(-1, 1, E), rng.uniform(-1, 1, E), rng.uniform(-1, 1, E),
                  rng.uniform(0, 1, E)], -1).astype(np.float32)
    jro = make_velocity_rollout_pallas(jsoa.soa_consts(jcp, jp), jcfg.ctrl_timestep,
                                       jcfg.pyb_timestep, jcfg.steps_per_ctrl, sl, T,
                                       interpret=True)
    want = jro(jsoa.soa_from_state(jroll.batch_reset(jcfg, jp, E)),
               {k: jnp.asarray(a[:, i]) for i, k in enumerate(tsoa.ACTION_KEYS)})
    tro_fn = tro.make_velocity_rollout(tsoa.soa_consts(tcp, tp), tcfg.ctrl_timestep,
                                       tcfg.pyb_timestep, tcfg.steps_per_ctrl, sl, T,
                                       device="cpu")
    got = tro_fn(tsoa.soa_from_state(troll.batch_reset(tcfg, tp, E, device="cpu")),
                 _cols(a, torch.float32))
    for k in ("px", "py", "pz", "qw", "vx", "vz"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_soa_round_trip_and_step_count():
    _, tcfg, _, _, tp, _, _ = _setup("float32")
    state = troll.batch_reset(tcfg, tp, 5, device="cpu")
    s = tsoa.soa_from_state(state)
    assert tuple(s) == tsoa.SOA_KEYS and all(v.shape == (5,) for v in s.values())
    back = tsoa.soa_to_state(s, state, pyb_steps=40)
    a, b = convert.aviary_state_to_numpy(back), convert.aviary_state_to_numpy(state)
    for k in convert.AVIARY_STATE_FIELDS:
        if k != "step_count":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["step_count"], b["step_count"] + 40)
    multi = troll.batch_reset(tbase.AviaryConfig(num_drones=2), tp, 2, device="cpu")
    with pytest.raises(ValueError, match="single-drone"):
        tsoa.soa_from_state(multi)


def test_consts_pack_matches_the_kernel_struct():
    """The host packing has the 60 floats of K1's VelConsts
    (csrc/velocity_rollout.cuh), with the two host-formed products in double."""
    _, tcfg, _, _, tp, tcp, sl = _setup("float32")
    c = tsoa.soa_consts(tcp, tp)
    packed = list(tro._pack_consts(c, tcfg.ctrl_timestep, tcfg.pyb_timestep, sl))
    assert len(packed) == 60
    f32 = lambda v: float(np.float32(v))
    assert packed[31] == f32(4.0 * c["kf_c"])
    assert packed[41:44] == [f32(tcfg.pyb_timestep * v) for v in c["Jinv"]]
    assert packed[56] == f32(c["z_min"])
    assert packed[57:] == [f32(tcfg.ctrl_timestep), f32(tcfg.pyb_timestep), f32(sl)]


def test_rollout_keeps_to_its_device():
    """CPU tensors run the plain version; the kernel's wrapper refuses them,
    and device=None means the card (raising when there is none)."""
    _, tcfg, _, _, tp, tcp, sl = _setup("float32")
    args = (tsoa.soa_consts(tcp, tp), tcfg.ctrl_timestep, tcfg.pyb_timestep,
            tcfg.steps_per_ctrl, sl)
    s = tsoa.soa_from_state(troll.batch_reset(tcfg, tp, 4, device="cpu"))
    act = _cols(_actions(2, 4), torch.float32)
    launches = tro.velocity_rollout_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tro.velocity_rollout_cuda(*args, 2, s, act)
    assert tro.velocity_rollout_cuda.launches == launches
    out = tro.make_velocity_rollout(*args, 2, device="cpu")(s, act)
    ref = tro.velocity_rollout_plain(*args, 2, s, act)
    assert all(torch.equal(out[k], ref[k]) for k in tsoa.SOA_KEYS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tro.make_velocity_rollout(*args, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            troll.batch_reset(tcfg, tp, 4)
