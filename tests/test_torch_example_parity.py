"""The port's examples held to the JAX package's runs of the same examples,
on the CPU.

``pid_velocity``, ``downwash`` and ``mrac`` run for 1 s with both packages'
configs and controllers in float64, and their logged states agree at 1e-9 m
and 1e-8 m/s (``pid_velocity``'s over its first 0.75 s). ``debug``'s three probes run in float32, as
both examples do, against the JAX probes' own substep results. ``cf``'s
flight takes the JAX example's steps bit for bit when the port's firmware
loop drives the JAX package's simulation (against the port's own physics
the two part by float32 rounding, which the firmware's loop amplifies:
tests/test_torch_bridges.py), and the gymnasium-free ``CFShellEnv`` branch,
the one the card's machine takes, flies the ``CFAviary`` branch's flight bit
for bit. ``beta``'s flight depends on the host's timing (a late PWM packet
keeps the last one), so the example is held by the setpoints it gives its
controllers, which follow from the clock and the trajectory table alone:
equal to the JAX example's, through the gymnasium-free ``BetaShellEnv``.

The Betaflight case binds 127.0.0.4: the JAX package's tests bind 127.0.0.1,
tests/test_torch_bridges.py 127.0.0.2 and tests/test_torch_examples.py
127.0.0.3 on the same UDP ports, in other pytest workers at the same time,
and two sockets on one address and port take each other's packets without
an error."""

import functools
import importlib.util
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_pybullet_drones_tpu.examples.beta as jbeta_ex
import gym_pybullet_drones_tpu.examples.cf as jcf
import gym_pybullet_drones_tpu.examples.debug as jdebug
import gym_pybullet_drones_tpu.examples.downwash as jdownwash
import gym_pybullet_drones_tpu.examples.mrac as jmrac
import gym_pybullet_drones_tpu.examples.pid_velocity as jpid_velocity
from gym_pybullet_drones_tpu.bridges.betaflight import MockSITL as JMockSITL
from gym_pybullet_drones_tpu.compat.gym import BaseAviaryEnv as JBaseAviaryEnv
from gym_pybullet_drones_tpu.control import dsl_pid as jdsl
from gym_pybullet_drones_tpu.control import mrac as jmrac_ctrl
from gym_pybullet_drones_tpu.envs.beta import BetaAviary as JBetaAviary
from gym_pybullet_drones_tpu.envs.cf import CFAviary as JCFAviary
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JDroneModel
from gym_pybullet_drones_tpu.envs.spec import Physics as JPhysics
from gym_pybullet_drones_tpu_torch.examples import beta, cf, debug, downwash, mrac, pid_velocity
from gym_pybullet_drones_tpu_torch.runtime.firmware import CFFirmware

CPU = "cpu"
BETA_IP = "127.0.0.4"
POS_F64, VEL_F64 = 1e-9, 1e-8  # m, m/s: float64 runs of the same flight


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*drop-in compatibility.*")
        yield


def _recording(module, monkeypatch, name="Logger"):
    """Replace ``module.<name>`` by a subclass that keeps each instance."""
    made = []

    class Recording(getattr(module, name)):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(module, name, Recording)
    return made


def _float64(monkeypatch, *modules):
    """Both packages' examples build their ``AviaryConfig`` in float64."""
    for module in modules:
        monkeypatch.setattr(module, "AviaryConfig",
                            functools.partial(module.AviaryConfig, dtype="float64"))


def _assert_states_agree(got, want, shape, steps):
    """The logged (drones, 16, T) states over their first ``steps`` control
    steps: position, velocity, attitude and body rates (1e-6 rad, rad/s) and
    the RPMs (1e-7 relative)."""
    assert got.shape == want.shape == shape
    got, want = got[:, :, :steps], want[:, :, :steps]
    np.testing.assert_allclose(got[:, 0:3], want[:, 0:3], rtol=0, atol=POS_F64)
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=0, atol=VEL_F64)
    np.testing.assert_allclose(got[:, 6:12], want[:, 6:12], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 12:16], want[:, 12:16], rtol=1e-7, atol=0)


# ------------------------------------------------------------------ float64 flights


def test_pid_velocity_matches_jax_float64(tmp_path, monkeypatch):
    """Four drones under the 1-s velocity table: the table switches the
    drones' commands at control steps 6, 14, 22 and 30, so the loop order and
    the initial yaws are in the comparison, and so are the logged controls.
    The two float64 runs part from an ulp (XLA contracts multiply-adds, the
    port does not) and the velocity loop grows the gap about fiftyfold every
    0.25 s: 1.4e-10 m/s at 0.75 s, 1e-8 m/s at 1 s. So the states are held
    over the first 0.75 s (36 control steps)."""
    _float64(monkeypatch, jpid_velocity, pid_velocity)
    want = jpid_velocity.run(plot=False, output_folder=str(tmp_path / "jax"), duration_sec=1)
    got = pid_velocity.run(plot=False, output_folder=str(tmp_path / "port"), duration_sec=1,
                           device=CPU)
    _assert_states_agree(got.states, want.states, (4, 16, 48), 36)
    np.testing.assert_array_equal(got.controls, want.controls)


def test_downwash_matches_jax_float64(tmp_path, monkeypatch):
    """The two stacked drones of PYB_DW over the whole first second: the
    wake term, the cosine sweep's phase and the DSLPID loop against JAX's."""
    _float64(monkeypatch, jdownwash, downwash)
    monkeypatch.setattr(jdownwash, "dsl_pid_params",
                        functools.partial(jdsl.dsl_pid_params, dtype=jnp.float64))
    monkeypatch.setattr(jdownwash, "dsl_pid_reset",
                        functools.partial(jdsl.dsl_pid_reset, dtype=jnp.float64))
    want = jdownwash.run(plot=False, output_folder=str(tmp_path / "jax"), duration_sec=1)
    got = downwash.run(plot=False, output_folder=str(tmp_path / "port"), duration_sec=1,
                       device=CPU)
    _assert_states_agree(got.states, want.states, (2, 16, 48), 48)
    np.testing.assert_array_equal(got.controls, want.controls)


def test_mrac_matches_jax_float64(tmp_path, monkeypatch):
    """MRAC's climb over 1 s at 240/120 Hz: the final position it returns and
    the 120 logged states, with the adaptive gains riding the loop."""
    _float64(monkeypatch, jmrac, mrac)
    monkeypatch.setattr(jmrac, "mrac_params",
                        functools.partial(jmrac_ctrl.mrac_params, dtype=jnp.float64))
    jloggers, loggers = _recording(jmrac, monkeypatch), _recording(mrac, monkeypatch)
    want = jmrac.run(plot=False, output_folder=str(tmp_path / "jax"), duration_sec=1)
    got = mrac.run(plot=False, output_folder=str(tmp_path / "port"), duration_sec=1, device=CPU)
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_F64)
    assert got[2] > 0.2  # climbing from 0.1 m toward 1 m
    _assert_states_agree(loggers[0].states, jloggers[0].states, (1, 16, 120), 120)


# ------------------------------------------------------------------ debug


def test_debug_probes_match_jax(monkeypatch):
    """The three probes in float32 against the JAX probes' substep results:
    the DYN hover after 240 substeps, the PYB kick's body rates after 24 and
    the free fall after 240. The two packages' float32 substeps part by an
    ulp a step (XLA contracts multiply-adds, the port does not), so the
    limits are float32 accumulation over 240 steps, not bits: the JAX hover
    drifts sideways at 2.1e-6 m/s from its rounding where the port's stays at
    exactly 0, and the kick's rates agree to 1e-7 relative."""
    dyn, pyb = [], []

    def keep(fn, out):
        def wrapped(*a, **k):
            kin = fn(*a, **k)
            out.append(kin)
            return kin
        return wrapped

    monkeypatch.setattr(jdebug, "substep_dyn", keep(jdebug.substep_dyn, dyn))
    monkeypatch.setattr(jdebug, "substep_pyb", keep(jdebug.substep_pyb, pyb))
    with jax.enable_x64(False):
        jdebug.main()
    assert len(dyn) == 240 and len(pyb) == 24 + 240
    got = debug.main(device=CPU)
    hover, kick, fall = dyn[-1], pyb[23], pyb[-1]
    assert hover.pos.dtype == jnp.float32
    np.testing.assert_allclose(got["hover_pos"], np.asarray(hover.pos[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["hover_vel"], np.asarray(hover.vel[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["kick_ang_v"], np.asarray(kick.ang_v[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["kick_rpy_rates"], np.asarray(kick.rpy_rates[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["fall_z"], float(fall.pos[0, 2]), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ the firmware flights

CF_SECONDS = 3.5  # the 3 s takeoff and the first half second of the square


class _PortLoopOverJaxSim(CFFirmware, JBaseAviaryEnv):
    """The port's firmware loop over the JAX package's simulation."""

    _action_space = JCFAviary._action_space
    _observation_space = JCFAviary._observation_space


def _without_gymnasium(monkeypatch):
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a, **k: None if name == "gymnasium"
                        else find_spec(name, *a, **k))


def test_cf_example_matches_jax(tmp_path, monkeypatch):
    """The port's cf.run, its env the port's firmware loop over the JAX
    package's simulation, logs the JAX example's flight bit for bit: the
    takeoff command, the square's full-state commands and their times."""
    def port_loop(drone, simulation_freq_hz, control_freq_hz, output_folder, device):
        return _PortLoopOverJaxSim(drone_model=JDroneModel(drone.value), physics=JPhysics.PYB,
                                   pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz,
                                   output_folder=output_folder)

    want = jcf.run(plot=False, output_folder=str(tmp_path / "jax"), duration_sec=CF_SECONDS)
    monkeypatch.setattr(cf, "make_env", port_loop)
    got = cf.run(plot=False, output_folder=str(tmp_path / "port"), duration_sec=CF_SECONDS,
                 device=CPU)
    assert got.states.shape == want.states.shape == (1, 16, 87)
    np.testing.assert_array_equal(got.states, want.states)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)


def test_cf_example_shell_branch_flies_cf_aviarys_flight(tmp_path, capsys, monkeypatch):
    """Without gymnasium, cf.run takes runtime.firmware.CFShellEnv, and its
    flight equals the envs.cf.CFAviary branch's bit for bit."""
    want = cf.run(plot=False, output_folder=str(tmp_path / "aviary"), duration_sec=CF_SECONDS,
                  device=CPU)
    assert "envs.cf.CFAviary" in capsys.readouterr().out
    _without_gymnasium(monkeypatch)
    got = cf.run(plot=False, output_folder=str(tmp_path / "shell"), duration_sec=CF_SECONDS,
                 device=CPU)
    assert "runtime.firmware.CFShellEnv" in capsys.readouterr().out
    np.testing.assert_array_equal(got.states, want.states)


def _setpoints(ctrls):
    """(drone, step, 6): the target position and velocity each controller got."""
    return np.array([[np.concatenate([np.asarray(k["target_pos"], np.float64),
                                      np.asarray(k["target_vel"], np.float64)])
                      for k in c.calls] for c in ctrls])


def _keep_setpoints(module, monkeypatch):
    made = _recording(module, monkeypatch, "CTBRControl")
    base = module.CTBRControl.__mro__[1]

    def compute(self, *a, **k):
        self.__dict__.setdefault("calls", []).append(k)
        return base.computeControlFromState(self, *a, **k)

    monkeypatch.setattr(module.CTBRControl, "computeControlFromState", compute)
    return made


def test_beta_example_setpoints_match_jax(tmp_path, capsys, monkeypatch):
    """Two drones over 2 s (the 1.5 s climb-out, then the trajectory table,
    drone 1 flying it reversed and 0.3 m to the side): the setpoints the
    port's beta.run gives its CTBR controllers, through BetaShellEnv, equal
    the JAX example's (its MockSITLs and env moved to BETA_IP)."""
    monkeypatch.setattr(jbeta_ex, "MockSITL", lambda i: JMockSITL(i, BETA_IP))
    monkeypatch.setattr(jbeta_ex, "BetaAviary", functools.partial(JBetaAviary, udp_ip=BETA_IP))
    jctrls, ctrls = _keep_setpoints(jbeta_ex, monkeypatch), _keep_setpoints(beta, monkeypatch)
    jbeta_ex.run(plot=False, output_folder=str(tmp_path / "jax"), duration_sec=2, num_drones=2)
    _without_gymnasium(monkeypatch)
    logger = beta.run(plot=False, output_folder=str(tmp_path / "port"), duration_sec=2,
                      num_drones=2, udp_ip=BETA_IP, device=CPU)
    assert "runtime.firmware.BetaShellEnv" in capsys.readouterr().out
    got, want = _setpoints(ctrls), _setpoints(jctrls)
    assert got.shape == want.shape == (2, 1000, 6)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0, -1], got[0, 0])  # the table is streaming
    assert np.all(np.isfinite(logger.states))
