"""The firmware-in-the-loop pieces of the port against the JAX package's on the
CPU: the native Crazyflie firmware bindings (bridges/cffirmware) and the
Betaflight bridge (bridges/betaflight) unit by unit, CFAviary
(envs/cf.py over runtime/firmware.CFFirmware) and BetaAviary (envs/beta.py)
at tests/test_cffirmware.py's and tests/test_betaflight.py's gates.

Every socket here binds 127.0.0.2: the JAX package's bridge tests bind
127.0.0.1 on the same ports and may run at the same time in another pytest
worker, and two UDP sockets on one address and port take each other's
packets without an error."""

import csv
import socket
import struct
import time
import types
import warnings

import numpy as np
import pytest

import gym_pybullet_drones_tpu.bridges.betaflight as jbeta
import gym_pybullet_drones_tpu.bridges.cffirmware as jfirm
import gym_pybullet_drones_tpu_torch.bridges.betaflight as tbeta
import gym_pybullet_drones_tpu_torch.bridges.cffirmware as tfirm
from gym_pybullet_drones_tpu.compat.gym import BaseAviaryEnv as JBaseAviaryEnv
from gym_pybullet_drones_tpu.envs.beta import BetaAviary as JBetaAviary
from gym_pybullet_drones_tpu.envs.cf import CFAviary as JCFAviary
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JDroneModel
from gym_pybullet_drones_tpu.envs.spec import Physics as JPhysics
from gym_pybullet_drones_tpu_torch.control.compat import CTBRControl
from gym_pybullet_drones_tpu_torch.envs.beta import BetaAviary
from gym_pybullet_drones_tpu_torch.envs.cf import CFAviary
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel
from gym_pybullet_drones_tpu_torch.runtime.firmware import BetaSITL, CFFirmware, CFShellEnv

IP = "127.0.0.2"
DRONE = 7  # ports 9072/9073/9074
CPU = "cpu"


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*drop-in compatibility.*")
        yield


# ---------------------------------------------------------------- cffirmware


def _lpf_run(firm, sig, cutoff):
    f = firm.lpf2pData()
    firm.lpf2pInit(f, 500, cutoff)
    return np.array([firm.lpf2pApply(f, s) for s in sig])


def test_lpf2p_equals_jax_and_attenuates():
    t = np.arange(500) / 500.0
    sig = np.sin(2 * np.pi * 200 * t) + 1.0
    for cutoff in (30, 80):
        got, want = _lpf_run(tfirm, sig, cutoff), _lpf_run(jfirm, sig, cutoff)
        np.testing.assert_array_equal(got, want)
    # tests/test_cffirmware.py:9-22: unit DC gain, a 200 Hz tone through 80 Hz cut
    assert abs(_lpf_run(tfirm, np.ones(200), 80)[-1] - 1.0) < 1e-4
    tone = _lpf_run(tfirm, sig - 1.0, 80)
    assert np.abs(tone[250:]).max() < 0.2


def test_controller_inits():
    tfirm.controllerPidInit()
    assert tfirm.controllerPidTest()
    tfirm.controllerMellingerInit()
    assert tfirm.controllerMellingerTest()


def _hover_state(firm, z):
    state = firm.state_t()
    state.attitudeQuaternion.w = 1.0
    state.position.z = z
    state.acc.z = 1.0
    return state


def _mellinger_case(firm, controller):
    """tests/test_cffirmware.py:45-62, with PID and Mellinger: the control
    outputs for a climb and a descent demand."""
    getattr(firm, f"controller{controller}Init")()
    control, setpoint, sensors = firm.control_t(), firm.setpoint_t(), firm.sensorData_t()
    sensors.acc.z = 1.0
    setpoint.position.z = 1.5
    setpoint.mode.x = setpoint.mode.y = setpoint.mode.z = firm.modeAbs
    out = []
    for z, sp_z in ((1.0, 1.5), (1.5, 1.0)):
        getattr(firm, f"controller{controller}Init")()
        setpoint.position.z = sp_z
        for tick in (0, 1, 2):
            getattr(firm, f"controller{controller}")(control, setpoint, sensors,
                                                     _hover_state(firm, z), tick)
            out.append([control.roll, control.pitch, control.yaw, control.thrust])
    return np.array(out)


@pytest.mark.parametrize("controller", ["Mellinger", "Pid"])
def test_controllers_equal_jax(controller):
    got, want = _mellinger_case(tfirm, controller), _mellinger_case(jfirm, controller)
    np.testing.assert_array_equal(got, want)
    if controller == "Mellinger":
        climb, descend = got[0, 3], got[3, 3]
        assert climb > descend and climb > 0


def _septic(firm):
    firm.crtpCommanderHighLevelInit()
    state = _hover_state(firm, 0.0)
    firm.crtpCommanderHighLevelTellState(state)
    firm.crtpCommanderHighLevelUpdateTime(0.0)
    firm.crtpCommanderHighLevelTakeoff(1.0, 2.0)
    sp = firm.setpoint_t()
    rows = []
    for k in range(101):
        firm.crtpCommanderHighLevelUpdateTime(k * 0.02)
        firm.crtpCommanderHighLevelGetSetpoint(sp, state)
        rows.append([sp.position.z, sp.velocity.z, sp.acceleration.z])
    return np.array(rows)


def test_septic_takeoff_profile_equals_jax():
    got = _septic(tfirm)
    np.testing.assert_array_equal(got, _septic(jfirm))
    zs, vzs = got[:, 0], got[:, 1]
    assert abs(zs[0]) < 1e-5 and abs(zs[-1] - 1.0) < 1e-5
    assert abs(vzs[0]) < 1e-5 and abs(vzs[-1]) < 1e-4
    assert np.all(np.diff(zs) >= -1e-5) and vzs.max() > 0.5


def test_firmware_contexts_are_separate():
    """Two contexts keep their own planners: a takeoff planned in one does
    not move the other's setpoint."""
    a, b = tfirm.FirmwareContext(), tfirm.FirmwareContext()
    with a:
        first = _septic(tfirm)
    with b:
        tfirm.crtpCommanderHighLevelInit()
    with a:  # a's planner still holds its finished takeoff
        sp = tfirm.setpoint_t()
        tfirm.crtpCommanderHighLevelUpdateTime(2.0)
        tfirm.crtpCommanderHighLevelGetSetpoint(sp, _hover_state(tfirm, 0.0))
    assert sp.position.z == pytest.approx(first[-1, 0])
    a.close()
    b.close()
    tfirm.controllerMellingerSetKdOmegaRP(0.0)  # the escape hatch is callable
    tfirm.controllerMellingerSetKdOmegaRP(200.0)


# ---------------------------------------------------------------- betaflight


def _listen(port):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind((IP, port))
    s.settimeout(1.0)
    return s


def _fdm_bytes(mod):
    recv = _listen(9003 + 10 * DRONE)
    b = mod.BetaBridge(DRONE, IP)
    try:
        assert b.send_fdm(1.25, [0.1, 0.2, 0.3], lin_acc=(0.5, -0.25, 9.8),
                          quat_wxyz=(0.9, 0.1, -0.2, 0.3), vel=(1, 2, 3), pos=(4, 5, 6),
                          pressure=0.75)
        data, _ = recv.recvfrom(1024)
    finally:
        b.close()
        recv.close()
    return data


def _rc_bytes(mod):
    recv = _listen(9004 + 10 * DRONE)
    b = mod.BetaBridge(DRONE, IP)
    try:
        assert b.send_rc(0.5, np.array([1500, 1400, 1000, 1600] + [1000 + i for i in range(12)]))
        data, _ = recv.recvfrom(1024)
    finally:
        b.close()
        recv.close()
    return data


def test_fdm_and_rc_packets_equal_jax_byte_for_byte():
    fdm = _fdm_bytes(tbeta)
    assert fdm == _fdm_bytes(jbeta)
    assert len(fdm) == 18 * 8
    vals = struct.unpack("@dddddddddddddddddd", fdm)
    assert vals[0] == 1.25
    np.testing.assert_allclose(vals[1:4], [0.1, -0.2, -0.3])  # ENU -> NED gyro y, z
    rc = _rc_bytes(tbeta)
    assert rc == _rc_bytes(jbeta)
    vals = struct.unpack("@dHHHHHHHHHHHHHHHH", rc)
    assert vals[0] == 0.5 and list(vals[1:5]) == [1500, 1400, 1000, 1600]


def test_stale_pwm_kept_on_a_miss():
    b = tbeta.BetaBridge(DRONE, IP)
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        pwm, fresh = b.recv_pwm()
        assert not fresh and np.all(pwm == 0)
        send.sendto(struct.pack("@ffff", 0.1, 0.2, 0.3, 0.4), (IP, 9002 + 10 * DRONE))
        deadline = time.time() + 2.0
        while not fresh and time.time() < deadline:
            time.sleep(0.01)
            pwm, fresh = b.recv_pwm()
        assert fresh
        np.testing.assert_allclose(pwm, [0.1, 0.2, 0.3, 0.4], rtol=1e-6)
        pwm2, fresh2 = b.recv_pwm()
        assert not fresh2
        np.testing.assert_array_equal(pwm2, pwm)
    finally:
        b.close()
        send.close()


def test_ctbr2beta_and_pwm_to_rpm_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        cmd = rng.uniform([-5, -10, -10, -10], [60, 10, 10, 10])
        assert BetaSITL.ctbr2beta(None, *cmd) == JBetaAviary.ctbr2beta(None, *cmd)
    plant = types.SimpleNamespace(MAX_THRUST=0.5983, KF=3.16e-10)
    pwm = rng.uniform(-0.2, 1.0, (5, 4))
    np.testing.assert_allclose(BetaSITL._beta_pwm_to_rpm(plant, pwm),
                               JBetaAviary._beta_pwm_to_rpm(plant, pwm), rtol=1e-12, atol=0)


def test_parse_bf_profile_equals_jax(tmp_path):
    import os

    jpreset = os.path.join(os.path.dirname(jbeta.__file__), "..", "..", "assets",
                           "bf_preset.txt")
    assert tbeta.parse_bf_profile(tbeta.BF_PRESET) == jbeta.parse_bf_profile(jpreset)
    p = tmp_path / "presets.txt"
    p.write_text("# profile 0\nset p_roll = 40\nset i_roll = 50\n"
                 "set d_pitch = 22\nset pidsum_limit = 700\nset junk == bad\n")
    prof = tbeta.parse_bf_profile(str(p))
    assert prof == jbeta.parse_bf_profile(str(p))
    assert prof["p_roll"] == 40.0 and prof["p_pitch"] == tbeta.DEFAULT_BF_PROFILE["p_pitch"]


def test_bf_rate_pid_over_the_beta_trajectory_equals_jax():
    """The rate PID fed the beta trajectory's rates (its jerk columns as
    setpoints in deg/s, the accelerations as gyro readings) at the SITL's
    500 Hz, port against JAX, every output at 1e-12."""
    import os

    path = os.path.join(tbeta.ASSETS, "beta-traj.csv")
    with open(path) as f:
        rows = list(csv.DictReader(f))[:2000]
    sp = np.array([[float(r[k]) for k in ("j_lin_x", "j_lin_y", "j_lin_z")] for r in rows])
    gyro = np.array([[float(r[k]) for k in ("a_lin_x", "a_lin_y", "a_lin_z")] for r in rows])
    pt, pj = tbeta.BFRatePID(), jbeta.BFRatePID()
    for i in range(len(rows)):
        t = i / 500.0
        got, want = pt.update(t, sp[i], gyro[i]), pj.update(t, sp[i], gyro[i])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert np.abs(pt._f_state).max() > 0  # the feedforward stages ran


def test_mock_sitl_mixers_equal_jax():
    for model in (DroneModel.CF2X, DroneModel.RACE, "cf2p"):
        np.testing.assert_array_equal(tbeta.MockSITL.MIX_CF2X, jbeta.MockSITL.MIX_CF2X)
        np.testing.assert_array_equal(tbeta.MockSITL.MIX_RACE, jbeta.MockSITL.MIX_RACE)
        name = getattr(model, "value", model)
        want = jbeta.MockSITL.MIX_CF2X if name.startswith("cf2") else jbeta.MockSITL.MIX_RACE
        s = tbeta.MockSITL.for_model(model, DRONE, IP)
        for sock in (s.sock_state, s.sock_rc, s.sock_out):  # never started
            sock.close()
        np.testing.assert_array_equal(s.mix, want)


# ---------------------------------------------------------------- CFAviary


class _PortLoopOverJaxSim(CFFirmware, JBaseAviaryEnv):
    """The port's firmware loop over the JAX package's simulation."""

    _action_space = JCFAviary._action_space
    _observation_space = JCFAviary._observation_space


def _first_second(env):
    env.reset()
    env.sendTakeoffCmd(1.0, 2.0)
    obs, pwms = [], []
    for i in range(25):
        obs.append(env.step(i)[0])
        pwms.append(np.array(env.pwms))
    assert env.tick == 500
    env.close()
    return np.array(obs), np.array(pwms)


def test_cf_firmware_loop_equals_jax_over_the_first_second():
    """runtime/firmware.CFFirmware over the JAX package's sim takes JAX's
    CFAviary's steps bit for bit: the obs of the 25 control steps and the
    PWMs at each. (Against the port's own physics the two envs part: the
    JAX step's FMA contraction leaves 1e-11 rad of roll where the port's stays
    exactly 0, and the Mellinger loop amplifies that about 1e4-fold in 0.12 s:
    the obs agree at the shells' float32 limits, tests/test_torch_gym.py's
    2e-3 and 20 RPM, for the first two control steps, and the positions
    within 3 cm over the second.)"""
    got_obs, got_pwm = _first_second(_PortLoopOverJaxSim(
        drone_model=JDroneModel.CF2X, physics=JPhysics.PYB, pyb_freq=500, ctrl_freq=25))
    want_obs, want_pwm = _first_second(JCFAviary(pyb_freq=500, ctrl_freq=25))
    np.testing.assert_array_equal(got_obs, want_obs)
    np.testing.assert_array_equal(got_pwm, want_pwm)
    port_obs, _ = _first_second(CFAviary(pyb_freq=500, ctrl_freq=25, device=CPU))
    np.testing.assert_allclose(port_obs[:2, :, :16], want_obs[:2, :, :16], atol=2e-3, rtol=0)
    np.testing.assert_allclose(port_obs[:2, :, 16:], want_obs[:2, :, 16:], atol=20.0, rtol=0)
    np.testing.assert_allclose(port_obs[:, 0, :3], want_obs[:, 0, :3], atol=0.03, rtol=0)


def test_cf_mission_and_flat_takeoff():
    """tests/test_cffirmware.py:80-96's mission at its gates, and :148-177's
    takeoff flown flat (the firmware's default D term with its low-pass)."""
    env = CFAviary(pyb_freq=500, ctrl_freq=25, device=CPU)
    obs, info = env.reset()
    assert obs.shape == (1, 20)
    env.sendTakeoffCmd(1.0, 2.0)
    max_tilt = 0.0
    for i in range(25 * 3):
        out = env.step(i)
        max_tilt = max(max_tilt, float(np.abs(np.array(out[0][0][7:9])).max()))
    assert max_tilt < 0.05, max_tilt
    assert abs(out[0][0][2] - 1.0) < 0.15
    env.sendGotoCmd([0.5, 0.5, 1.0], 0.0, 3.0, False)
    for i in range(25 * 3, 25 * 7):
        out = env.step(i)
    pos = np.array(out[0][0][:3])
    assert np.linalg.norm(pos[:2] - [0.5, 0.5]) < 0.05
    assert abs(pos[2] - 1.0) < 0.15
    assert not env._error and env.tick == 3500
    env.close()


def test_cf_shell_env_takes_cf_aviarys_steps():
    """runtime/firmware.CFShellEnv, the gymnasium-free loop chip_smoke.py
    drives on the card, takes CFAviary's steps bit for bit."""
    got = _first_second(CFShellEnv(pyb_freq=500, ctrl_freq=25, device=CPU))
    want = _first_second(CFAviary(pyb_freq=500, ctrl_freq=25, device=CPU))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cf_pid_full_state():
    cls = type("PidCF", (CFAviary,), {"CONTROLLER": "pid"})
    env = cls(pyb_freq=1000, ctrl_freq=25, device=CPU)
    env.reset()
    env.sendFullStateCmd([0.2, 0.0, 1.0], [0, 0, 0], [0, 0, 0], 0.0, [0, 0, 0], 0.0)
    for i in range(25 * 6):
        out = env.step(i)
    assert np.linalg.norm(np.array(out[0][0][:3]) - [0.2, 0.0, 1.0]) < 0.05
    assert not env._error
    env.close()


def test_two_cf_aviaries_interleaved_equal_a_solo_flight():
    def fly_solo():
        env = CFAviary(pyb_freq=500, ctrl_freq=25, device=CPU)
        env.reset()
        env.sendTakeoffCmd(1.0, 2.0)
        for i in range(25 * 3):
            out = env.step(i)
        env.close()
        return np.array(out[0][0][:3])

    ref = fly_solo()
    env_a = CFAviary(pyb_freq=500, ctrl_freq=25, device=CPU)
    env_b = CFAviary(pyb_freq=500, ctrl_freq=25, device=CPU)
    env_a.reset()
    env_b.reset()
    env_a.sendTakeoffCmd(1.0, 2.0)
    env_b.sendGotoCmd([0.4, -0.4, 0.7], 0.0, 2.5, False)
    for i in range(25 * 3):
        out_a = env_a.step(i)
        out_b = env_b.step(i)
    np.testing.assert_allclose(np.array(out_a[0][0][:3]), ref, atol=1e-9)
    assert np.linalg.norm(np.array(out_b[0][0][:2]) - [0.4, -0.4]) < 0.1
    assert not env_a._error and not env_b._error
    env_a.close()
    env_b.close()


# ---------------------------------------------------------------- BetaAviary


def _fly_beta(num_drones, seconds, targets, initial_xyzs=None):
    sitls = [tbeta.MockSITL(j, IP).start() for j in range(num_drones)]
    env = BetaAviary(drone_model=DroneModel.RACE, num_drones=num_drones, pyb_freq=500,
                     ctrl_freq=500, initial_xyzs=initial_xyzs, udp_ip=IP, device=CPU)
    ctrl = [CTBRControl(DroneModel.RACE, device=CPU) for _ in range(num_drones)]
    obs, info = env.reset(seed=0)
    action = np.zeros((num_drones, 4))
    try:
        for i in range(500 * seconds):
            obs, *_ = env.step(action, i)
            if i / 500 > env.TRAJ_TIME:
                for j in range(num_drones):
                    action[j] = ctrl[j].computeControlFromState(1 / 500, obs[j],
                                                                target_pos=targets[j])
    finally:
        env.close()
        for s in sitls:
            s.stop()
    return obs


def test_beta_aviary_closed_loop():
    """tests/test_betaflight.py:65-95: within 0.08 m after 7 s (the stale-PWM
    policy makes the error depend on the host's load)."""
    target = np.array([0.3, -0.2, 0.8])
    obs = _fly_beta(1, 7, [target])
    assert np.linalg.norm(obs[0][:3] - target) < 0.08


def test_beta_aviary_two_drones():
    targets = np.array([[0.0, 0.0, 0.7], [1.0, 0.3, 0.9]])
    obs = _fly_beta(2, 6, targets, initial_xyzs=[[0, 0, 0.1], [1.0, 0, 0.1]])
    for j in range(2):
        assert np.linalg.norm(obs[j][:3] - targets[j]) < 0.1, (j, obs[j][:3])
