"""The port's ten examples and two asset generators against the JAX package's,
on the CPU.

Each example's ``run()`` runs here with ``device="cpu"`` at
tests/test_examples.py's settings and is held to its gates; ``pid`` and
``play`` are also held against the JAX package's runs of the same example,
and tests/test_torch_example_parity.py holds the other flights (and the
gymnasium-free branches of ``cf`` and ``beta``) against them.
The generators write files byte-equal to the JAX package's and to the port's
committed ``assets/``. ``learn`` writes its policy in flax's msgpack format,
which flax, the JAX package's ``play`` and the port's ``play`` all read.
``learn``'s multi-agent case at the CI budget runs on the card only
(``chip_smoke.py`` phase 13): a ``learn`` run costs about 50 s here, most of
it the 2,600-step final evaluation on the eager env step.

The Betaflight case binds 127.0.0.3: the JAX package's tests bind 127.0.0.1
and tests/test_torch_bridges.py 127.0.0.2 on the same UDP ports, in other
pytest workers at the same time, and two sockets on one address and port
take each other's packets without an error."""

import functools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")

from flax import serialization

import gym_pybullet_drones_tpu.examples.pid as jpid
import gym_pybullet_drones_tpu.examples.play as jplay
from gym_pybullet_drones_tpu.assets import make_beta_traj as jtraj
from gym_pybullet_drones_tpu.assets import make_urdfs as jurdfs
from gym_pybullet_drones_tpu_torch.assets import make_beta_traj, make_urdfs
from gym_pybullet_drones_tpu_torch.convert import (
    actor_critic_from_flax,
    actor_critic_to_flax,
    load_flax_msgpack,
)
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel
from gym_pybullet_drones_tpu_torch.examples import (
    beta,
    cf,
    debug,
    downwash,
    learn,
    mrac,
    pid,
    pid_velocity,
    play,
    trajopt,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BETA_IP = "127.0.0.3"


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*drop-in compatibility.*")
        yield


def _recording(module, monkeypatch):
    """Replace ``module.Logger`` by a subclass that keeps each instance."""
    made = []

    class Recording(module.Logger):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(module, "Logger", Recording)
    return made


# ------------------------------------------------------------------ assets


def test_make_urdfs_byte_equal(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir(), ref.mkdir()
    paths = make_urdfs.write_urdfs(str(port))
    jurdfs.write_urdfs(str(ref))
    assert sorted(m.value for m in paths) == sorted(m.value for m in DroneModel)
    for model, path in paths.items():
        name = f"{model.value}.urdf"
        data = open(path, "rb").read()
        assert data == (ref / name).read_bytes(), name
        committed = os.path.join(os.path.dirname(make_urdfs.__file__), name)
        assert data == open(committed, "rb").read(), name


def test_make_beta_traj_byte_equal(tmp_path):
    out = make_beta_traj.write_csv(str(tmp_path / "port.csv"))
    jtraj.write_csv(str(tmp_path / "jax.csv"))
    data = open(out, "rb").read()
    assert data == (tmp_path / "jax.csv").read_bytes()
    assert data == open(make_beta_traj.default_path(), "rb").read()
    assert make_beta_traj.ensure_csv() == make_beta_traj.default_path()
    np.testing.assert_array_equal(make_beta_traj.trajectory(), jtraj.trajectory())


# ------------------------------------------------------------------ pid


def _pid_pair(tmp_path, duration_sec):
    """JAX's pid.run and the port's over ``duration_sec``: their loggers."""
    with jax.enable_x64(False):
        want = jpid.run(plot=False, output_folder=str(tmp_path / "jax"),
                        duration_sec=duration_sec)
    got = pid.run(plot=False, output_folder=str(tmp_path / "port"),
                  duration_sec=duration_sec, device=CPU)
    return got.states, want.states


def test_pid_matches_jax_float32(tmp_path):
    """Float32, as both examples run: the two part by rounding from the first
    control step (the RPMs by an ulp; XLA contracts multiply-adds, the port
    does not), and the helix's closed loop grows that gap about tenfold every
    0.15 s: 7e-6 m at 0.5 s, 1e-4 m near 0.75 s, 1e-3 m at 1 s. So the
    float32 limits hold over the first 0.5 s (24 control steps); the whole
    first second is held in float64 below."""
    got, want = _pid_pair(tmp_path, 1)
    assert got.shape == want.shape == (3, 16, 48)
    head = slice(0, 24)
    np.testing.assert_allclose(got[:, 0:3, head], want[:, 0:3, head], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 3:6, head], want[:, 3:6, head], rtol=0, atol=1e-3)


def test_pid_matches_jax_float64(tmp_path, monkeypatch):
    """The same helix with both examples' configs and controllers in float64,
    over the whole first second (48 control steps)."""
    from gym_pybullet_drones_tpu.control import dsl_pid as jdsl

    monkeypatch.setattr(jpid, "AviaryConfig", functools.partial(jpid.AviaryConfig,
                                                                 dtype="float64"))
    monkeypatch.setattr(jpid, "dsl_pid_params", functools.partial(jdsl.dsl_pid_params,
                                                                   dtype=jnp.float64))
    monkeypatch.setattr(jpid, "dsl_pid_reset", functools.partial(jdsl.dsl_pid_reset,
                                                                  dtype=jnp.float64))
    monkeypatch.setattr(pid, "AviaryConfig", functools.partial(pid.AviaryConfig,
                                                               dtype="float64"))
    want = jpid.run(plot=False, output_folder=str(tmp_path / "jax"), duration_sec=1)
    got = pid.run(plot=False, output_folder=str(tmp_path / "port"), duration_sec=1,
                  device=CPU)
    assert got.states.shape == want.states.shape == (3, 16, 48)
    np.testing.assert_allclose(got.states[:, 0:3], want.states[:, 0:3], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.states[:, 3:6], want.states[:, 3:6], rtol=0, atol=1e-8)


def test_pid(tmp_path):
    """tests/test_examples.py::test_pid's gates on the port: the drones hold
    their helix altitudes (pid.py:64: H + i * 0.05) after 4 s, and the CSV
    directory is written."""
    logger = pid.run(gui=False, plot=False, output_folder=str(tmp_path), duration_sec=4,
                     device=CPU)
    st = logger.states
    assert st.shape == (3, 16, 192)
    assert np.allclose(st[:, 2, -1], [0.1, 0.15, 0.2], atol=0.02)
    assert any(p.name.startswith("save-flight-pid-") and p.is_dir() for p in tmp_path.iterdir())


# ------------------------------------------------------------------ the other flights


def test_pid_velocity(tmp_path):
    logger = pid_velocity.run(gui=False, plot=False, output_folder=str(tmp_path), device=CPU)
    st = logger.states
    assert st.shape[0] == 4 and st.shape[2] == 48 * 5
    assert np.all(np.isfinite(st))


def test_downwash(tmp_path):
    logger = downwash.run(gui=False, plot=False, output_folder=str(tmp_path), duration_sec=4,
                          device=CPU)
    st = logger.states
    # Both drones survive the wake crossings near their start altitudes
    assert abs(st[0, 2, -1] - 1.0) < 0.1
    assert abs(st[1, 2, -1] - 0.5) < 0.15


def test_mrac(tmp_path):
    final_pos = mrac.run(plot=False, output_folder=str(tmp_path), duration_sec=10, device=CPU)
    assert abs(final_pos[2] - 1.0) < 0.05


def test_cf_example(tmp_path, capsys):
    """Through envs.cf.CFAviary: the tests run where gymnasium is installed."""
    logger = cf.run(plot=False, output_folder=str(tmp_path), duration_sec=8, device=CPU)
    assert "envs.cf.CFAviary" in capsys.readouterr().out
    st = logger.states
    assert np.all(np.isfinite(st))
    assert abs(st[0, 2, -1] - 0.5) < 0.15  # holding the square's altitude


def test_beta_example(tmp_path):
    logger = beta.run(gui=False, plot=False, output_folder=str(tmp_path), duration_sec=5,
                      udp_ip=BETA_IP, device=CPU)
    st = logger.states
    assert np.all(np.isfinite(st))
    assert st[0, 2, -1] > 0.5  # airborne after climb-out


def test_debug_probes():
    """The DYN hover holds z, the kick spins the drone up, and the free fall
    lands where the explicit Euler integrator puts it: velocity then
    position, so z_N = z_0 - g dt^2 N (N + 1) / 2 (5.0796 m after 240 steps,
    not the continuous 10 - g / 2 = 5.1)."""
    out = debug.main(device=CPU)
    np.testing.assert_allclose(out["hover_pos"], [0.0, 0.0, 1.0], atol=1e-5)
    assert np.abs(out["hover_vel"]).max() < 1e-5
    assert np.all(np.isfinite(out["kick_ang_v"])) and np.abs(out["kick_ang_v"][:2]).min() > 0.1
    n, dt = 240, 1.0 / 240.0
    assert abs(out["fall_z"] - (10.0 - 9.8 * dt * dt * n * (n + 1) / 2)) < 1e-3


# ------------------------------------------------------------------ learn and play


@pytest.fixture(scope="module")
def learned(tmp_path_factory):
    """One single-agent learn run at the CI budget, shared by the cases below."""
    out = tmp_path_factory.mktemp("learn")
    evals = learn.run(gui=False, plot=False, output_folder=str(out), local=False, num_envs=4,
                      device=CPU)
    return evals, out


def test_learn_ci_budget(learned):
    evals, out = learned
    assert len(evals) >= 1
    assert np.isfinite(evals[-1][1])
    assert (out / "best_model.msgpack").exists()


def _leaves_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _leaves_equal(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_learn_model_is_flax_msgpack(learned):
    """flax restores the file leaf for leaf as the port's policy maps to flax,
    and writes those leaves back to the same bytes."""
    _, out = learned
    data = (out / "best_model.msgpack").read_bytes()
    restored = serialization.msgpack_restore(data)
    net = actor_critic_from_flax(load_flax_msgpack(str(out / "best_model.msgpack")), device=CPU)
    tree = actor_critic_to_flax(net)
    _leaves_equal(restored, tree)
    assert restored["params"]["Dense_0"]["kernel"].dtype == np.float32
    assert serialization.to_bytes(tree) == data


def test_save_flax_msgpack_equals_flax(tmp_path):
    """The writer against flax.serialization.to_bytes on a tree with every
    kind of leaf it takes: ndarrays (one past 64 KiB), numpy scalars and
    Python scalars of each msgpack width; load_flax_msgpack reads it back."""
    from gym_pybullet_drones_tpu_torch.convert import save_flax_msgpack

    rng = np.random.default_rng(0)
    tree = {"params": {"Dense_0": {"bias": rng.standard_normal(64).astype(np.float32),
                                   "kernel": rng.standard_normal((300, 64)).astype(np.float32)},
                       "log_std": torch.zeros(4)},
            "scalars": {"f32": np.float32(1.5), "i64": np.int64(-3), "f64": np.zeros((), np.float64),
                        "ints": {str(i): v for i, v in enumerate(
                            (0, 127, 128, 300, 70000, 10**10, -1, -32, -33, -200, -40000))},
                        "float": 2.5, "true": True, "none": None, "long": "x" * 40},
            "wide": {f"k{i}": np.float32(i) for i in range(20)}}
    path = save_flax_msgpack(tree, str(tmp_path / "t.msgpack"))
    data = open(path, "rb").read()
    tree["params"]["log_std"] = np.zeros(4, np.float32)
    assert data == serialization.to_bytes(tree)
    back = load_flax_msgpack(path)
    assert back["scalars"]["ints"]["5"] == 10**10 and back["scalars"]["none"] is None
    assert back["scalars"]["f32"] == np.float32(1.5) and back["scalars"]["f32"].dtype == np.float32
    _leaves_equal(back["params"], serialization.msgpack_restore(data)["params"])


def test_play_reads_learned_model(learned, tmp_path, monkeypatch):
    """The port's play and the JAX package's play both replay the port's file;
    a ONE_D_RPM Hover replay is the same in both packages (its float32
    closed loop has no controller to part them), so their returns agree."""
    _, out = learned
    model = str(out / "best_model.msgpack")
    total = play.play(model_path=model, output_folder=str(tmp_path), plot=False,
                      duration_sec=2, device=CPU)
    with jax.enable_x64(False):
        jtotal = jplay.play(model_path=model, output_folder=str(tmp_path), plot=False,
                            duration_sec=2)
    assert np.isfinite(total) and np.isfinite(jtotal)
    assert abs(total - jtotal) < 1e-3 * abs(jtotal), (total, jtotal)
    # the default path: the output folder's best_model.msgpack
    assert play.play(output_folder=str(out), plot=False, duration_sec=1, device=CPU) > 0


def test_play_checkpoint_matches_jax(tmp_path, monkeypatch):
    """checkpoints/one_d_rpm_hover.msgpack replayed for 1 s by both packages'
    play: the logged states agree at pos 1e-4 m."""
    model = os.path.join(ROOT, "checkpoints", "one_d_rpm_hover.msgpack")
    port_loggers = _recording(play, monkeypatch)
    jax_loggers = _recording(jplay, monkeypatch)
    total = play.play(model_path=model, output_folder=str(tmp_path), plot=False,
                      duration_sec=1, device=CPU)
    with jax.enable_x64(False):
        jtotal = jplay.play(model_path=model, output_folder=str(tmp_path), plot=False,
                            duration_sec=1)
    got, want = port_loggers[0].states, jax_loggers[0].states
    assert got.shape == want.shape == (1, 16, 30)
    np.testing.assert_allclose(got[:, 0:3], want[:, 0:3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=0, atol=1e-3)
    assert abs(total - jtotal) < 1e-3 * abs(jtotal), (total, jtotal)


# ------------------------------------------------------------------ the device rule

_ENTRY_POINTS = {
    "pid": lambda o: pid.run(plot=False, output_folder=o, duration_sec=1),
    "pid_velocity": lambda o: pid_velocity.run(plot=False, output_folder=o, duration_sec=1),
    "downwash": lambda o: downwash.run(plot=False, output_folder=o, duration_sec=1),
    "mrac": lambda o: mrac.run(plot=False, output_folder=o, duration_sec=1),
    "cf": lambda o: cf.run(plot=False, output_folder=o, duration_sec=1),
    "beta": lambda o: beta.run(plot=False, output_folder=o, duration_sec=1, udp_ip=BETA_IP),
    "debug": lambda o: debug.main(),
    "learn": lambda o: learn.run(plot=False, output_folder=o, local=False, num_envs=4),
    "play": lambda o: play.play(output_folder=o, plot=False),
    "trajopt": lambda o: trajopt.run(iters=1, plot=False, output_folder=o),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_example_without_a_card_raises(name, tmp_path, monkeypatch):
    """``device=None`` means the CUDA card: with none, every example raises
    before it starts any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name](str(tmp_path))
    assert not any(tmp_path.iterdir())
