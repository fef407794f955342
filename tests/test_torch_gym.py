"""The port's Gymnasium shells (compat/gym.py) against the JAX package's on
the CPU: the four envs step for step, the reference subclassing protocol of
tests/test_compat_subclassing.py, the reference method snapshot of
tests/test_api_parity.py, gymnasium's env checker, and the camera surfaces
(record=True, _getDroneImages, gui=True)."""

import os
import warnings

import numpy as np
import pytest
import torch
from gymnasium import spaces

import gym_pybullet_drones_tpu.compat.gym as jgym
import gym_pybullet_drones_tpu_torch.compat.gym as tgym
from gym_pybullet_drones_tpu_torch.control import compat as tcc
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, ImageType
from gym_pybullet_drones_tpu_torch.utils import logger as tlogger
from test_api_parity import _SNAPSHOT

CPU = "cpu"


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*drop-in compatibility.*")
        yield


# Shell against shell, float32 in both packages: the JAX step is jitted with
# XLA's FMA contraction, the port's is not, so the float32 trajectories part by
# rounding, and the DSLPID loops amplify it into the RPMs. Limits over the 40
# steps, tests/test_soa.py:52-59's float32 ones: kinematic obs columns and
# reward atol 2e-3, RPMs (the last four columns of the 20-dim state, the
# applied RPMs) atol 20; term / trunc / info equal.
OBS_ATOL, RPM_ATOL = 2e-3, 20.0


def _obs_close(got, want, what=""):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.shape[-1] == 20:
        np.testing.assert_allclose(got[..., 16:], want[..., 16:], rtol=0, atol=RPM_ATOL,
                                   err_msg=what)
        got, want = got[..., :16], want[..., :16]
    np.testing.assert_allclose(got, want, rtol=0, atol=OBS_ATOL, err_msg=what)

ENVS = {
    "ctrl": (tgym.CtrlAviary, jgym.CtrlAviary, dict(num_drones=2)),
    "velocity": (tgym.VelocityAviary, jgym.VelocityAviary, dict(num_drones=2)),
    "hover": (tgym.HoverAviary, jgym.HoverAviary, dict(act=ActionType.ONE_D_RPM)),
    "multihover": (tgym.MultiHoverAviary, jgym.MultiHoverAviary, dict()),
}


def _actions(name, env, rng, n):
    if name == "ctrl":
        return rng.uniform(0.9, 1.1, (n,) + env.action_space.shape) * env.HOVER_RPM
    return rng.uniform(-0.8, 0.8, (n,) + env.action_space.shape)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_shell_steps_like_the_jax_shell(name):
    """reset plus 40 steps of seeded actions: obs, reward, terminated,
    truncated and info against the JAX shell's."""
    tcls, jcls, kw = ENVS[name]
    kw = dict(kw, episode_len_sec=1.0)
    tenv, jenv = tcls(device=CPU, **kw), jcls(**{k: v if not isinstance(v, ActionType)
                                                   else type(jgym.ActionType.RPM)(v.value)
                                                   for k, v in kw.items()})
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    (to, ti), (jo, ji) = tenv.reset(seed=0), jenv.reset(seed=0)
    _obs_close(to, jo, "reset")
    assert ti == ji and to.dtype == jo.dtype == np.float32
    dones = 0
    for k, a in enumerate(_actions(name, tenv, np.random.default_rng(3), 40)):
        got, want = tenv.step(a), jenv.step(a)
        _obs_close(got[0], want[0], f"obs step {k}")
        assert abs(got[1] - want[1]) <= OBS_ATOL, (k, got[1], want[1])
        assert type(got[1]) is float and got[2:] == want[2:], (k, got[2:], want[2:])
        dones += got[2] or got[3]
        np.testing.assert_allclose(tenv.last_clipped_action, jenv.last_clipped_action,
                                   rtol=0, atol=RPM_ATOL)
    if name in ("hover", "multihover"):
        assert dones > 0  # the 1 s episodes end within the 40 steps at 30 Hz
    assert tenv.step_counter == jenv.step_counter
    _obs_close(tenv._getDroneStateVector(0), jenv._getDroneStateVector(0), "state vector")
    tenv.close()
    jenv.close()


def test_shell_attributes_match_the_jax_shell():
    """The reference attribute surface, number for number."""
    for tcls, jcls in ((tgym.CtrlAviary, jgym.CtrlAviary),
                       (tgym.MultiHoverAviary, jgym.MultiHoverAviary)):
        tenv, jenv = tcls(device=CPU), jcls()
        for name in ("NUM_DRONES", "CTRL_FREQ", "PYB_FREQ", "PYB_STEPS_PER_CTRL", "G",
                     "GRAVITY", "M", "L", "KF", "KM", "HOVER_RPM", "MAX_RPM", "MAX_THRUST",
                     "MAX_XY_TORQUE", "MAX_Z_TORQUE", "GND_EFF_H_CLIP", "SPEED_LIMIT",
                     "CAPTURE_FREQ", "IMG_CAPTURE_FREQ", "URDF", "COLLISION_R"):
            assert getattr(tenv, name) == pytest.approx(getattr(jenv, name), rel=1e-7), name
        for name in ("INIT_XYZS", "INIT_RPYS", "J", "J_INV", "DRAG_COEFF", "IMG_RES"):
            np.testing.assert_allclose(getattr(tenv, name), getattr(jenv, name), rtol=1e-6)
        np.testing.assert_allclose(tenv._addObstacles(), jenv._addObstacles(), rtol=1e-6)
        np.testing.assert_array_equal(tenv._getAdjacencyMatrix(), jenv._getAdjacencyMatrix())
        tenv.close()
        jenv.close()
    tenv = tgym.HoverAviary(device=CPU)
    np.testing.assert_array_equal(tenv.TARGET_POS, [[0.0, 0.0, 1.0]])
    assert tenv.device == torch.device(CPU) and tenv._state.kin.pos.device.type == CPU


# ---------------------------------------------------------------------------
# tests/test_compat_subclassing.py's custom aviaries and hooks on the port
# ---------------------------------------------------------------------------


class _WaypointAviary(tgym.CtrlAviary):
    TARGET = np.array([0.0, 0.0, 0.5])

    def _observationSpace(self):
        return spaces.Box(low=-np.inf, high=np.inf, shape=(3,), dtype=np.float32)

    def _computeObs(self):
        return (self.pos[0] - self.TARGET).astype(np.float32)

    def _computeReward(self):
        return -float(np.linalg.norm(self.pos[0] - self.TARGET))

    def _computeTerminated(self):
        return bool(np.linalg.norm(self.pos[0] - self.TARGET) < 0.05)

    def _computeTruncated(self):
        return bool(self.step_counter / self.PYB_FREQ > 2.0)

    def _computeInfo(self):
        return {"dist": float(np.linalg.norm(self.pos[0] - self.TARGET))}


def test_custom_hooks_drive_step_and_reset():
    env = _WaypointAviary(num_drones=1, device=CPU)
    assert env.observation_space.shape == (3,)
    obs, info = env.reset(seed=0)
    assert obs.shape == (3,) and "dist" in info
    obs, reward, term, trunc, info = env.step(np.zeros((1, 4)))
    assert reward == -info["dist"] and reward < -0.1
    assert not term and not trunc
    for _ in range(2 * env.CTRL_FREQ):
        obs, reward, term, trunc, info = env.step(np.zeros((1, 4)))
        if trunc:
            break
    assert trunc
    env.close()


class _RawRPMHover(tgym.CtrlAviary):
    def _preprocessAction(self, action):
        return np.full((self.NUM_DRONES, 4), self.HOVER_RPM)


def test_custom_preprocess_action_injects_rpms():
    env = _RawRPMHover(num_drones=1, initial_xyzs=np.array([[0.0, 0.0, 1.0]]), device=CPU)
    env.reset(seed=0)
    for _ in range(env.CTRL_FREQ):
        env.step(np.zeros((1, 4)))
    assert abs(env.pos[0, 2] - 1.0) < 5e-3, env.pos
    np.testing.assert_allclose(env.last_clipped_action, np.full((1, 4), env.HOVER_RPM),
                               rtol=1e-6)
    env.close()


def test_zero_action_without_override_free_falls():
    env = tgym.CtrlAviary(num_drones=1, initial_xyzs=np.array([[0.0, 0.0, 1.0]]), device=CPU)
    env.reset(seed=0)
    for _ in range(env.CTRL_FREQ):
        env.step(np.zeros((1, 4)))
    assert env.pos[0, 2] < 0.5
    env.close()


def test_kinematic_mirrors_live_and_preconstruction():
    env = tgym.HoverAviary(act=ActionType.ONE_D_RPM, device=CPU)
    assert env.pos.shape == (1, 3) and env.quat.shape == (1, 4)
    np.testing.assert_allclose(env.pos, env.INIT_XYZS, atol=1e-6)
    env.reset(seed=0)
    p0 = env.pos.copy()
    for _ in range(5):
        env.step(np.full((1, 1), -1.0))
    assert env.pos[0, 2] < p0[0, 2]
    assert env.vel[0, 2] < 0
    assert env.rpy.shape == (1, 3) and env.ang_v.shape == (1, 3)
    assert env.rpy_rates.shape == (1, 3)
    assert env.last_clipped_action.shape == (1, 4)
    env.close()


def test_parse_urdf_parameters_matches_constants():
    env = tgym.CtrlAviary(num_drones=1, device=CPU)
    jenv = jgym.CtrlAviary(num_drones=1)
    got, want = env._parseURDFParameters(), jenv._parseURDFParameters()
    assert len(got) == len(want) == 17
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    (m, arm, t2w, J, J_inv, kf, km, col_h, col_r, col_z, max_kmh,
     gnd_eff, prop_r, drag, dw1, dw2, dw3) = got
    assert m == pytest.approx(env.M) and arm == pytest.approx(env.L)
    np.testing.assert_allclose(J, env.J, rtol=1e-6)
    assert kf == pytest.approx(env.KF) and dw1 == pytest.approx(env.DW_COEFF_1)
    env.close()


def test_calculate_next_step_caps_distance():
    env = tgym.CtrlAviary(num_drones=1, device=CPU)
    cur = np.zeros(3)
    np.testing.assert_allclose(env._calculateNextStep(cur, np.array([10.0, 0, 0]), 1),
                               [1.0, 0.0, 0.0], atol=1e-6)
    near = np.array([0.2, 0.0, 0.0])
    np.testing.assert_allclose(env._calculateNextStep(cur, near, 1), near, atol=1e-6)
    env.close()


def test_default_hooks_preserve_builtin_behavior():
    env = tgym.HoverAviary(device=CPU)
    env.reset(seed=0)
    _, reward, term, trunc, info = env.step(np.zeros((1, 4)))
    err = np.linalg.norm(np.array([0, 0, 1]) - env.pos[0])
    assert reward == pytest.approx(max(0.0, 2.0 - err**4), rel=1e-5)
    assert info == {"answer": 42}
    assert env._computeReward() == pytest.approx(reward)
    assert env._computeTerminated() == term and env._computeTruncated() == trunc
    env.close()


def test_physics_term_probes_match_the_jax_shell():
    """The per-drone physics probes (BaseAviary.py:679-892) against the JAX
    shell's, and tests/test_compat_subclassing.py's checks of them."""
    xyz = np.array([[0, 0, 0.05], [0, 0, 1.0]])
    env, jenv = tgym.CtrlAviary(num_drones=2, initial_xyzs=xyz, device=CPU), \
        jgym.CtrlAviary(num_drones=2, initial_xyzs=xyz)
    env.reset(seed=0)
    jenv.reset(seed=0)
    rpm = np.full(4, env.HOVER_RPM)
    for k in range(2):
        for a, b in zip(env._physics(rpm, k), jenv._physics(rpm, k)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(env._groundEffect(rpm, k), jenv._groundEffect(rpm, k),
                                   rtol=1e-5)
        np.testing.assert_allclose(env._drag(rpm, k), jenv._drag(rpm, k), atol=1e-12)
        np.testing.assert_allclose(env._downwash(k), jenv._downwash(k), rtol=1e-5)
        for a, b in zip(env._dynamics(rpm, k), jenv._dynamics(rpm, k)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    forces, z_torque = env._physics(rpm, 0)
    np.testing.assert_allclose(forces, env.KF * rpm**2, rtol=1e-5)
    assert z_torque == pytest.approx(0.0, abs=1e-9)
    assert np.all(env._groundEffect(rpm, 1) < env._groundEffect(rpm, 0))
    dw = env._downwash(0)
    assert dw[2] < 0 and dw[0] == dw[1] == 0 and env._downwash(1)[2] == 0
    q = env._integrateQ(np.array([0, 0, 0, 1.0]), np.array([0, 0, np.pi / 2]), 1.0)
    np.testing.assert_allclose(np.abs(q), [0, 0, np.sqrt(0.5), np.sqrt(0.5)], atol=1e-6)
    np.testing.assert_allclose(q, jenv._integrateQ(np.array([0, 0, 0, 1.0]),
                                                   np.array([0, 0, np.pi / 2]), 1.0), atol=1e-7)
    env.close()


class _ScalarThrottleAviary(tgym.CtrlAviary):
    def _actionSpace(self):
        return spaces.Box(low=0.0, high=1.0, shape=(self.NUM_DRONES,), dtype=np.float32)

    def _preprocessAction(self, action):
        return np.tile((np.asarray(action) * self.MAX_RPM)[:, None], (1, 4))


def test_custom_action_shape_steps_without_builtin_reshape():
    env = _ScalarThrottleAviary(num_drones=2, initial_xyzs=np.array([[0.0, 0.0, 1.0],
                                                                     [1.0, 0.0, 1.0]]),
                                device=CPU)
    env.reset(seed=0)
    hover_frac = env.HOVER_RPM / env.MAX_RPM
    for _ in range(env.CTRL_FREQ):
        env.step(np.full(2, hover_frac, dtype=np.float32))
    assert abs(env.pos[0, 2] - 1.0) < 5e-3, env.pos
    np.testing.assert_allclose(env.last_clipped_action, np.full((2, 4), env.HOVER_RPM),
                               rtol=1e-6)
    env.close()


def test_save_last_action_stores_arrays_and_mappings():
    env = tgym.CtrlAviary(num_drones=2, device=CPU)
    env._saveLastAction(np.arange(8.0))
    np.testing.assert_array_equal(env.last_action, np.arange(8.0).reshape(2, 4))
    env._saveLastAction({"1": [9.0, 9.0, 9.0, 9.0]})
    np.testing.assert_array_equal(env.last_action[1], 9.0)
    np.testing.assert_array_equal(env.last_action[0], [0.0, 1.0, 2.0, 3.0])
    env.close()


# ---------------------------------------------------------------------------
# The reference method snapshot (tests/test_api_parity.py), on the port
# ---------------------------------------------------------------------------

_PORT_CLASSES = {
    "BaseAviary": tgym.BaseAviaryEnv, "CtrlAviary": tgym.CtrlAviary,
    "VelocityAviary": tgym.VelocityAviary, "BaseRLAviary": tgym._RLAviary,
    "HoverAviary": tgym.HoverAviary, "MultiHoverAviary": tgym.MultiHoverAviary,
    "BaseControl": tcc.BaseControl, "DSLPIDControl": tcc.DSLPIDControl,
    "CTBRControl": tcc.CTBRControl, "MRAC": tcc.MRAC, "Logger": tlogger.Logger,
}


@pytest.mark.parametrize("cls_name", sorted(_PORT_CLASSES))
def test_reference_methods_present_on_the_port(cls_name):
    have = set(dir(_PORT_CLASSES[cls_name]))
    missing = sorted(m for m in _SNAPSHOT[cls_name] if m not in have and not m.startswith("__"))
    assert not missing, f"{cls_name} missing reference methods: {missing}"


def test_the_port_has_save_last_action():
    assert "_saveLastAction" in _SNAPSHOT["BaseAviary"]
    assert callable(tgym.BaseAviaryEnv._saveLastAction)


def test_gymnasium_env_checker_conformance():
    """gymnasium's check_env on the port's shells with device="cpu": the
    control shells pass; the RL shells fail the same one probe as the JAX
    package's (tests/test_api_parity.py: the action buffer persists across
    reset, BaseRLAviary.py:153-155), and fresh instances are deterministic."""
    from gymnasium.utils.env_checker import check_env

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(tgym.CtrlAviary(device=CPU), skip_render_check=True)
        check_env(tgym.VelocityAviary(device=CPU), skip_render_check=True)
        with pytest.raises(AssertionError, match="Deterministic step observations"):
            check_env(tgym.HoverAviary(device=CPU), skip_render_check=True)

    def run():
        env = tgym.HoverAviary(device=CPU)
        obs, _ = env.reset(seed=7)
        traj = [obs]
        for _ in range(5):
            obs, *_ = env.step(np.full((1, 4), 0.3, np.float32))
            traj.append(obs)
        env.close()
        return np.concatenate([o.ravel() for o in traj])

    np.testing.assert_array_equal(run(), run())


# ---------------------------------------------------------------------------
# The camera surfaces
# ---------------------------------------------------------------------------


def test_record_true_writes_frames_and_a_video(tmp_path):
    """record=True: a 128 x 96 drone-0 frame a capture (CAPTURE_FREQ 1 at 30
    Hz), the first equal to the JAX shell's on all but 0.1 % of the pixels
    (the render limit of tests/test_torch_render.py), and a video on close."""
    from PIL import Image

    env = tgym.HoverAviary(record=True, output_folder=str(tmp_path / "t"), device=CPU)
    jenv = jgym.HoverAviary(record=True, output_folder=str(tmp_path / "j"))
    assert env.CAPTURE_FREQ == 1
    env.reset(seed=0)
    jenv.reset(seed=0)
    for _ in range(12):
        env.step(np.zeros((1, 4)))
    jenv.step(np.zeros((1, 4)))
    (rec,) = os.listdir(tmp_path / "t")
    frames = sorted(f for f in os.listdir(tmp_path / "t" / rec) if f.endswith(".png"))
    assert len(frames) == 12
    (jrec,) = os.listdir(tmp_path / "j")
    got = np.asarray(Image.open(tmp_path / "t" / rec / "frame_0.png"))
    want = np.asarray(Image.open(tmp_path / "j" / jrec / "frame_0.png"))
    assert got.shape == (96, 128, 4)
    assert np.mean(np.abs(got.astype(int) - want.astype(int)).max(-1) > 1) <= 1e-3
    env.close()
    jenv.close()
    assert any(f.endswith((".avi", ".mp4")) for f in os.listdir(tmp_path / "t" / rec))


def test_drone_images_and_export(tmp_path):
    env, jenv = tgym.CtrlAviary(num_drones=2, device=CPU), jgym.CtrlAviary(num_drones=2)
    env.reset(seed=0)
    jenv.reset(seed=0)
    rgb, dep, seg = env._getDroneImages(1)
    w, h = env.IMG_RES
    assert rgb.shape == (h, w, 4) and rgb.dtype == np.uint8
    assert dep.shape == (h, w) and dep.dtype == np.float32
    assert seg.shape == (h, w) and seg.dtype == np.int32
    jrgb, jdep, jseg = jenv._getDroneImages(1)
    assert np.mean(seg != np.asarray(jseg)) <= 1e-3
    for i, (img_type, img) in enumerate(((ImageType.RGB, rgb), (ImageType.DEP, dep),
                                         (ImageType.SEG, seg), (ImageType.BW, rgb))):
        env._exportImage(img_type, img, str(tmp_path), i)
        assert os.path.exists(tmp_path / f"frame_{i}.png")
    env.close()


def test_gui_viewer_sliders_and_axes_headless():
    """gui=True on the Agg backend (tests/test_runtime_aux.py's check): the
    viewer captures frames, the GUI-RPM switch replaces the actions, the
    body axes draw."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    env = tgym.CtrlAviary(num_drones=2, gui=True, user_debug_gui=True, ctrl_freq=48,
                          pyb_freq=240, device=CPU)
    env.reset(seed=0)
    zero = np.zeros((2, 4))
    env.step(zero)
    assert env._viewer is not None and len(env._viewer.frames) >= 1
    z0 = env.pos[:, 2].copy()
    env._viewer.set_gui_rpm(np.full(4, 1.05 * env.HOVER_RPM), use=True)
    for _ in range(24):
        env.step(zero)
    assert np.all(env.pos[:, 2] > z0)
    assert set(env._viewer._axis_lines.keys()) == {0, 1}
    env._showDroneLocalAxes(0)
    env.close()
    assert env._viewer is None


def test_shell_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgym.CtrlAviary()


def test_render_prints_the_fleet(capsys):
    env = tgym.CtrlAviary(num_drones=2, device=CPU)
    env.reset(seed=0)
    env.step(np.zeros((2, 4)))
    env.render()
    assert "drone 1" in capsys.readouterr().out
    assert env.getPyBulletClient() == -1
    np.testing.assert_array_equal(env.getDroneIds(), [0, 1])
    np.testing.assert_allclose(env._normalizedActionToRPM(np.array([-1.0, 0.0, 1.0])),
                               [0.0, env.HOVER_RPM, env.MAX_RPM])
    env.close()
