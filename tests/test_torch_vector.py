"""The port's Gymnasium vector shell (compat/vector.py, runtime/shell.py) on the
CPU: step for step against gymnasium's own SyncVectorEnv (SAME_STEP) over the
port's single env and against the JAX package's VecAviary, with domain
randomization fed JAX's draws; and the ``cuda/`` ids beside the JAX ids."""

import warnings

import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium.vector import AutoresetMode, SyncVectorEnv

import gym_pybullet_drones_tpu  # noqa: F401  (registers the JAX ids)
import gym_pybullet_drones_tpu.compat.gym as jgym
import gym_pybullet_drones_tpu.compat.vector as jvec
import gym_pybullet_drones_tpu_torch  # noqa: F401  (registers the cuda/ ids)
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.compat.gym import CtrlAviary, HoverAviary, MultiHoverAviary
from gym_pybullet_drones_tpu_torch.compat.vector import VecAviary, make_vec_env
from gym_pybullet_drones_tpu_torch.runtime.shell import host_copy, make_vec_core

CPU = "cpu"
# Vector against single shells, and against JAX's VecAviary: tests/test_vector.py's
# limit, atol 1e-5 on obs, reward and final obs; term and trunc equal.
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*drop-in compatibility.*")
        yield


def _drive(vec, ref, steps, seed=7, check_final=True):
    """Step both with the same seeded actions; returns how many envs ended."""
    rng = np.random.default_rng(seed)
    ended = 0
    for t in range(steps):
        acts = rng.uniform(-0.3, 0.3, size=vec.action_space.shape).astype(np.float32)
        obs_v, rew_v, term_v, trunc_v, inf_v = vec.step(acts)
        obs_r, rew_r, term_r, trunc_r, inf_r = ref.step(acts)
        np.testing.assert_array_equal(term_v, term_r, err_msg=f"step {t}")
        np.testing.assert_array_equal(trunc_v, trunc_r, err_msg=f"step {t}")
        np.testing.assert_allclose(rew_v, rew_r, atol=ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(obs_v, obs_r, atol=ATOL, err_msg=f"step {t}")
        assert obs_v.dtype == np.float32 and rew_v.dtype == np.float32
        done = term_v | trunc_v
        if done.any():
            ended += int(done.sum())
            np.testing.assert_array_equal(inf_v["_final_obs"], done)
            if check_final:
                np.testing.assert_array_equal(inf_r["_final_obs"], done)
            for i in range(len(done)):
                if done[i] and check_final:
                    np.testing.assert_allclose(inf_v["final_obs"][i], inf_r["final_obs"][i],
                                               atol=ATOL, err_msg=f"step {t} env {i}")
                elif not done[i]:
                    assert inf_v["final_obs"][i] is None
        else:
            assert inf_v == {}
    return ended


@pytest.mark.parametrize("env_class,n_envs", [(HoverAviary, 3), (MultiHoverAviary, 2)])
def test_equivalence_vs_sync_vector_env(env_class, n_envs):
    """tests/test_vector.py:56 on the port: gymnasium's SyncVectorEnv over the
    port's single env, 1 s episodes, 45 steps across the boundary."""
    kwargs = dict(episode_len_sec=1.0, device=CPU)
    vec = VecAviary(n_envs, env_class, **kwargs)
    ref = SyncVectorEnv([lambda: env_class(**kwargs) for _ in range(n_envs)],
                        autoreset_mode=AutoresetMode.SAME_STEP)
    obs_v, _ = vec.reset(seed=0)
    obs_r, _ = ref.reset(seed=0)
    np.testing.assert_array_equal(obs_v, obs_r)
    assert _drive(vec, ref, int(1.5 * 30)) > 0
    vec.close()
    ref.close()


@pytest.mark.parametrize("env_name,n_envs", [("HoverAviary", 3), ("MultiHoverAviary", 2),
                                             ("CtrlAviary", 2)])
def test_vec_aviary_matches_jax_vec_aviary(env_name, n_envs):
    """The same actions through the port's VecAviary and JAX's, 45 steps of
    1 s episodes (the Ctrl env never ends)."""
    tcls = {"HoverAviary": HoverAviary, "MultiHoverAviary": MultiHoverAviary,
            "CtrlAviary": CtrlAviary}[env_name]
    kwargs = dict(episode_len_sec=1.0)
    if env_name == "CtrlAviary":
        kwargs.update(num_drones=2, pyb_freq=240, ctrl_freq=30)
    vec = VecAviary(n_envs, tcls, device=CPU, **kwargs)
    ref = jvec.VecAviary(n_envs, getattr(jgym, env_name), **kwargs)
    assert vec.single_observation_space == ref.single_observation_space
    assert vec.single_action_space == ref.single_action_space
    np.testing.assert_allclose(vec.reset(seed=0)[0], ref.reset(seed=0)[0], atol=ATOL)
    if env_name == "CtrlAviary":
        hover = vec.template.HOVER_RPM
        rng = np.random.default_rng(1)
        for t in range(20):
            acts = (hover * rng.uniform(0.95, 1.05, vec.action_space.shape)).astype(np.float32)
            got, want = vec.step(acts), ref.step(acts)
            np.testing.assert_allclose(got[0][..., :16], want[0][..., :16], atol=ATOL)
            np.testing.assert_allclose(got[0][..., 16:], want[0][..., 16:], rtol=1e-6)
            assert not (got[2].any() or got[3].any() or want[2].any() or want[3].any())
    else:
        assert _drive(vec, ref, 45) > 0
    vec.close()


def test_domain_rand_with_jax_draws_matches_jax():
    """JAX's VecAviary with domain_rand, its randomize_params draws carried into
    the port's make_vec_core: the same stream of outputs over 45 steps."""
    spec = {"m": 0.1, "kf": 0.05}
    ref = jvec.VecAviary(4, jgym.HoverAviary, domain_rand=spec, domain_rand_seed=3,
                         episode_len_sec=1.0)
    t = HoverAviary(episode_len_sec=1.0, device=CPU)
    tp = convert.drone_params_from_numpy(convert.record_to_numpy(ref._params), device=CPU)
    assert tp.m.shape == (4,) and float(tp.m.std()) > 0
    reset, step = make_vec_core(t.cfg, tp, t.ctrl_params, t.target_pos, 4, CPU)
    state, obs = reset()
    np.testing.assert_allclose(obs, ref.reset(seed=0)[0], atol=ATOL)
    rng = np.random.default_rng(2)
    ended = 0
    for k in range(45):
        acts = rng.uniform(-0.3, 0.3, (4, 1, 4)).astype(np.float32)
        state, (obs, rew, term, trunc, final_obs) = step(state, acts)
        o, r, te, tr, info = ref.step(acts)
        np.testing.assert_allclose(obs, o, atol=ATOL, err_msg=f"step {k}")
        np.testing.assert_allclose(rew, r, atol=ATOL)
        np.testing.assert_array_equal(term, te)
        np.testing.assert_array_equal(trunc, tr)
        done = term | trunc
        ended += int(done.sum())
        for i in np.flatnonzero(done):
            np.testing.assert_allclose(final_obs[i], info["final_obs"][i], atol=ATOL)
    assert ended > 0
    assert np.ptp(obs[:, 0, 2]) > 1e-4  # the envs stepped different plants


def test_domain_rand_envs_diverge_and_draw_on_the_cpu_generator():
    """tests/test_vector.py's divergence check on the port; the draws come from
    a CPU generator seeded with domain_rand_seed, the same for any seed reuse."""
    vec = VecAviary(4, HoverAviary, domain_rand={"m": 0.1}, device=CPU)
    again = VecAviary(4, HoverAviary, domain_rand={"m": 0.1}, device=CPU)
    other = VecAviary(4, HoverAviary, domain_rand={"m": 0.1}, domain_rand_seed=1, device=CPU)
    assert torch.equal(vec._params.m, again._params.m)
    assert not torch.equal(vec._params.m, other._params.m)
    vec.reset()
    acts = np.zeros(vec.action_space.shape, dtype=np.float32)
    for _ in range(5):
        obs, *_ = vec.step(acts)
    assert np.ptp(obs[:, 0, 2]) > 1e-6
    nom = VecAviary(4, HoverAviary, device=CPU)
    nom.reset()
    for _ in range(5):
        obs, *_ = nom.step(acts)
    assert np.ptp(obs[:, 0, 2]) == 0.0
    vec.close()
    nom.close()


def test_spaces_shapes_and_dtypes():
    vec = VecAviary(8, HoverAviary, device=CPU)
    single = HoverAviary(device=CPU)
    assert vec.num_envs == 8
    assert vec.single_action_space == single.action_space
    assert vec.single_observation_space == single.observation_space
    assert vec.action_space.shape == (8,) + single.action_space.shape
    assert vec.observation_space.shape == (8,) + single.observation_space.shape
    assert vec.metadata["autoreset_mode"] is AutoresetMode.SAME_STEP
    obs, infos = vec.reset(seed=0)
    assert obs.shape == vec.observation_space.shape and obs.dtype == np.float32
    obs, rew, term, trunc, infos = vec.step(np.zeros(vec.action_space.shape, np.float32))
    assert rew.shape == (8,) and rew.dtype == np.float32
    assert term.dtype == bool and trunc.dtype == bool and term.shape == (8,)
    vec.close()
    single.close()


def test_ctrl_aviary_vector_and_make_vec_env():
    vec = VecAviary(2, CtrlAviary, num_drones=3, device=CPU)
    obs, _ = vec.reset()
    assert obs.shape == (2, 3, 20)
    hover = np.full(vec.action_space.shape, vec.template.HOVER_RPM, dtype=np.float32)
    obs, rew, term, trunc, _ = vec.step(hover)
    assert obs.shape == (2, 3, 20) and not term.any() and not trunc.any()
    vec.close()
    helper = make_vec_env(HoverAviary, n_envs=2, env_kwargs=dict(device=CPU))
    assert isinstance(helper, VecAviary) and helper.num_envs == 2
    helper.close()


def test_rgb_vector_env_obs_are_uint8_frames():
    from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, ObservationType

    vec = VecAviary(2, HoverAviary, obs=ObservationType.RGB, act=ActionType.ONE_D_RPM,
                    device=CPU)
    obs, _ = vec.reset()
    assert obs.shape == (2, 1, 48, 64, 4) and obs.dtype == np.uint8
    obs, *_ = vec.step(np.zeros(vec.action_space.shape, np.float32))
    assert obs.dtype == np.uint8 and obs.max() > 0
    vec.close()


def test_host_copy_is_exact_for_every_dtype():
    parts = (torch.randn(3, 5, dtype=torch.float32), torch.tensor(True),
             torch.arange(7, dtype=torch.uint8), torch.randn(2, dtype=torch.float64),
             torch.tensor([1, -2], dtype=torch.int32), torch.tensor(0.5))
    for got, want in zip(host_copy(*parts), parts):
        assert got.dtype == want.numpy().dtype and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got, want.numpy())


def test_cuda_ids_make_and_make_vec_and_leave_the_jax_ids_alone():
    for name in ("ctrl", "velocity", "hover", "multihover"):
        spec = gym.spec(f"cuda/{name}-aviary-v0")
        assert spec.entry_point.startswith("gym_pybullet_drones_tpu_torch.compat.gym:")
        assert spec.vector_entry_point.startswith(
            "gym_pybullet_drones_tpu_torch.compat.vector:")
        jspec = gym.spec(f"{name}-aviary-v0")
        assert jspec.entry_point.startswith("gym_pybullet_drones_tpu.compat.gym:")
        assert jspec.vector_entry_point.startswith("gym_pybullet_drones_tpu.compat.vector:")
    env = gym.make("cuda/hover-aviary-v0", device=CPU)
    assert isinstance(env.unwrapped, HoverAviary)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (1, 72)
    env.close()
    vec = gym.make_vec("cuda/multihover-aviary-v0", num_envs=3, device=CPU)
    assert isinstance(vec, VecAviary)
    obs, _ = vec.reset(seed=0)
    assert obs.shape[:2] == (3, 2)
    _, rew, *_ = vec.step(np.zeros(vec.action_space.shape, dtype=np.float32))
    assert rew.shape == (3,)
    vec.close()
    jv = gym.make_vec("hover-aviary-v0", num_envs=2)
    assert isinstance(jv, jvec.VecAviary)
    jv.close()
