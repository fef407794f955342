"""ctypes bindings for the Betaflight SITL UDP bridge (port of the JAX
package's ``bridges/betaflight``; ``src/betabridge.cpp`` is the same source,
built with g++ into the package's ``_build/`` at first import).

``BetaBridge`` wraps one SITL channel triple (state out 9003+10i, rc out
9004+10i, pwm in 9002+10i) with the reference's wire formats
(BetaAviary.py:126-170). ``MockSITL`` is a pure-Python stand-in flight
controller on the same wire protocol for when the external
``betaflight_SITL.elf`` is not present: Betaflight's rate-mode PID pipeline
(``BFRatePID``) and an X mixer. Every socket binds ``udp_ip``; processes that
run bridges at the same time on one host need addresses of their own (any
127.x.y.z loopback address works on Linux).
"""

import ctypes
import os
import threading

import numpy as np

from gym_pybullet_drones_tpu_torch.bridges._native import load

_HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "assets")
BF_PRESET = os.path.join(ASSETS, "bf_preset.txt")  # the MockSITL profile

_lib = load(os.path.join(_HERE, "src", "betabridge.cpp"))
_lib.bb_create.restype = ctypes.c_void_p
_lib.bb_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
_lib.bb_destroy.argtypes = [ctypes.c_void_p]
_lib.bb_send_fdm.restype = ctypes.c_int
_lib.bb_send_fdm.argtypes = [ctypes.c_void_p, ctypes.c_double] + \
    [ctypes.POINTER(ctypes.c_double)] * 5 + [ctypes.c_double]
_lib.bb_send_rc.restype = ctypes.c_int
_lib.bb_send_rc.argtypes = [ctypes.c_void_p, ctypes.c_double,
                            ctypes.POINTER(ctypes.c_uint16)]
_lib.bb_recv_pwm.restype = ctypes.c_int
_lib.bb_recv_pwm.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]


def _dptr(arr):
    a = np.ascontiguousarray(arr, dtype=np.float64)
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class BetaBridge:
    """One drone's UDP channel triple to a Betaflight SITL instance."""

    def __init__(self, drone_index: int = 0, udp_ip: str = "127.0.0.1"):
        self._h = _lib.bb_create(udp_ip.encode(), drone_index)
        if not self._h:
            raise OSError(f"betabridge: failed to bind PWM port for drone {drone_index}")

    def close(self):
        if self._h:
            _lib.bb_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def _handle(self):
        if not self._h:
            raise RuntimeError("betabridge: channel is closed")
        return self._h

    def send_fdm(self, t, gyro_body, lin_acc=(0, 0, 0),
                 quat_wxyz=(1, 0, 0, 0), vel=(0, 0, 0), pos=(0, 0, 0),
                 pressure=1.0):
        """FDM state packet; ENU->NED gyro sign flips happen in the bridge."""
        return _lib.bb_send_fdm(self._handle(), float(t), _dptr(gyro_body),
                                _dptr(lin_acc), _dptr(quat_wxyz), _dptr(vel),
                                _dptr(pos), float(pressure)) == 0

    def send_rc(self, t, channels):
        ch = np.ascontiguousarray(channels, dtype=np.uint16)
        assert ch.shape == (16,), ch.shape
        return _lib.bb_send_rc(self._handle(), float(t),
                               ch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))) == 0

    def recv_pwm(self):
        """(pwm[4] in 0..1, fresh: bool); stale values repeat on miss."""
        out = (ctypes.c_float * 4)()
        fresh = _lib.bb_recv_pwm(self._handle(), out)
        return np.array(out[:]), bool(fresh)


# ---------------------------------------------------------------------------
# Betaflight rate-PID pipeline: the gains and limits of the reference's
# shipped FC configuration (its assets/beta-presets-bak.txt) driven through
# Betaflight's own pidSum pipeline, so that MockSITL closes a realistic
# attitude loop, not just a wire-parity one.
# ---------------------------------------------------------------------------

# Betaflight pid.c gain scales (user gain -> pidSum units; pidSum / 1000
# enters the motor mixer, mixer.c PID_MIXER_SCALING).
BF_PTERM_SCALE = 0.032029
BF_ITERM_SCALE = 0.244381
BF_DTERM_SCALE = 0.000529
BF_FF_SCALE = 0.013754
BF_ITERM_LIMIT = 400.0  # pidSum units (Betaflight itermLimit default)

# profile 0 / rateprofile 0 of the reference's beta-presets-bak.txt
# (p/i/d/f per axis; d_yaw is Betaflight's default 0; rates_type BETAFLIGHT
# with rc_rate 180, srate 0 => max commanded rate 200 * 1.8 = 360 deg/s —
# exactly the reference's ctbr2beta full-scale, BetaAviary.py:176-188).
DEFAULT_BF_PROFILE = {
    "p_roll": 58.0, "i_roll": 62.0, "d_roll": 42.0, "f_roll": 187.0,
    "p_pitch": 70.0, "i_pitch": 75.0, "d_pitch": 43.0, "f_pitch": 224.0,
    "p_yaw": 58.0, "i_yaw": 62.0, "d_yaw": 0.0, "f_yaw": 187.0,
    "pidsum_limit": 1000.0, "pidsum_limit_yaw": 1000.0,
    "roll_rc_rate": 180.0, "pitch_rc_rate": 180.0, "yaw_rc_rate": 180.0,
}


def parse_bf_profile(path):
    """Parse ``set key = value`` lines of a Betaflight diff/dump (e.g. the
    reference's assets/beta-presets-bak.txt) into a profile dict; keys not
    present fall back to DEFAULT_BF_PROFILE."""
    prof = dict(DEFAULT_BF_PROFILE)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("set "):
                continue
            try:
                key, val = line[4:].split("=", 1)
                key = key.strip()
                if key in prof:
                    prof[key] = float(val.strip())
            except ValueError:
                continue
    return prof


class BFRatePID:
    """Betaflight rate-mode PID for one drone (per-axis P+I+D+FF).

    Axes are the (p, q, r) body-rate errors in whatever frame the caller's
    mixer expects (MockSITL uses ENU with its model-derived mixers); the
    pipeline itself is frame-agnostic. Per Betaflight pid.c:
      P = PTERM_SCALE * p_gain * errDps
      I = sum(ITERM_SCALE * i_gain * errDps * dt), clamped to itermLimit
      D = -DTERM_SCALE * d_gain * dGyro/dt, 1st-order LPF (dterm_lpf ~75 Hz)
      F = FF_SCALE * f_gain * shaped dSetpoint/dt (see below), ON by default
    pidSum clamped to pidsum_limit (yaw: pidsum_limit_yaw) then / 1000 into
    the mixer. Omitted Betaflight extras (documented): iterm_relax, TPA,
    antigravity, d_min scheduling (d_min == d here), absolute control.

    Feedforward follows the shaping stages of
    the validated BF revision's pipeline (cafe727 / BF 4.5-dev
    src/main/flight/feedforward.c, firmware defaults in parentheses;
    semantics are best-known reconstructions — byte-exact calibration rides
    the real-SITL integration test once networked, like the PYB goldens):
      0. rc-smoothing stand-in (rc_smoothing_auto_factor's feedforward
         cutoff; ``ff_rc_lpf_hz`` = 30): a PT1 on the setpoint stream feeds
         the FF derivative — the firmware never differentiates the raw RX
         stream; without this the 500 Hz BetaAviary uplink's packet noise
         rides straight into pidSum (measured 0.12 m hover offset);
      1. setpoint speed = dSmoothedSetpoint/dt per update;
      2. jitter attenuation (feedforward_jitter_factor = 7): deltas smaller
         than ``jitter_factor`` RC counts (of the ±500 stick range mapped
         over the profile's max rate) attenuate linearly to zero — this is
         what makes FF stable on BetaAviary's 500 Hz streamed setpoints,
         whose per-packet deltas are far below one stick count (a raw
         derivative of the setpoint measurably diverged within 2 s);
      3. boost (feedforward_boost = 15): + 0.1 * boost * setpoint accel,
         under the same attenuator;
      4. first-order smoothing (feedforward_smooth_factor = 25):
         alpha = 1 - factor/100 per update;
      5. max-rate limit (feedforward_max_rate_limit = 90): FF pushing past
         90% of the profile's max commanded rate is zeroed.
    Steady state is shaping-invariant: a constant-slope ramp big enough to
    defeat stage 2 yields F = FF_SCALE * f_gain * slope exactly — the
    parity anchor tests/test_betaflight.py pins against the preset table.
    """

    def __init__(self, profile=None, dterm_lpf_hz=75.0,
                 use_ff=True, ff_smooth_factor=25.0, ff_jitter_factor=7.0,
                 ff_boost=15.0, ff_max_rate_limit=90.0, ff_rc_lpf_hz=30.0):
        self.use_ff = use_ff
        prof = dict(DEFAULT_BF_PROFILE)
        if profile:
            prof.update(profile)
        self.kp = np.array([prof["p_roll"], prof["p_pitch"], prof["p_yaw"]])
        self.ki = np.array([prof["i_roll"], prof["i_pitch"], prof["i_yaw"]])
        self.kd = np.array([prof["d_roll"], prof["d_pitch"], prof["d_yaw"]])
        self.kf = np.array([prof["f_roll"], prof["f_pitch"], prof["f_yaw"]])
        self.limit = np.array([prof["pidsum_limit"], prof["pidsum_limit"],
                               prof["pidsum_limit_yaw"]])
        # BETAFLIGHT rates, srate 0: max rate = 200 * rc_rate/100 deg/s
        # (360 at the preset's 180 — the ctbr2beta full scale)
        self.max_rate = np.array([2.0 * prof["roll_rc_rate"],
                                  2.0 * prof["pitch_rc_rate"],
                                  2.0 * prof["yaw_rc_rate"]])
        self.dterm_lpf_hz = dterm_lpf_hz
        self.ff_rc_lpf_hz = ff_rc_lpf_hz
        self.ff_smooth_factor = ff_smooth_factor
        self.ff_jitter_factor = ff_jitter_factor
        self.ff_boost = ff_boost
        self.ff_max_rate_limit = ff_max_rate_limit
        self.reset()

    def reset(self):
        self.iterm = np.zeros(3)
        self._prev_t = None
        self._prev_gyro = np.zeros(3)
        self._prev_sp = np.zeros(3)
        self._d_state = np.zeros(3)
        self._f_state = np.zeros(3)
        self._prev_sp_speed = np.zeros(3)
        self._sp_filt = np.zeros(3)

    def update(self, t, setpoint_dps, gyro_dps):
        """pidSum/1000 per axis — the mixer-scale correction vector."""
        if self._prev_t is None:
            # Seed the derivative histories on the first armed frame so a
            # mid-rotation arm does not kick a full-scale D/FF transient
            # (real Betaflight's gyro history predates arming).
            self._prev_gyro = np.array(gyro_dps, dtype=float)
            self._prev_sp = np.array(setpoint_dps, dtype=float)
            self._sp_filt = np.array(setpoint_dps, dtype=float)
        if self._prev_t is None or t <= self._prev_t:
            dt = 1.0 / 500.0
        else:
            dt = min(t - self._prev_t, 0.1)
        err = setpoint_dps - gyro_dps
        p = BF_PTERM_SCALE * self.kp * err
        self.iterm = np.clip(self.iterm + BF_ITERM_SCALE * self.ki * err * dt,
                             -BF_ITERM_LIMIT, BF_ITERM_LIMIT)
        d_raw = -BF_DTERM_SCALE * self.kd * (gyro_dps - self._prev_gyro) / dt
        a_d = 1.0 - np.exp(-2.0 * np.pi * self.dterm_lpf_hz * dt)
        self._d_state += a_d * (d_raw - self._d_state)
        # Feedforward shaping pipeline (class docstring stages 0-5)
        a_rc = 1.0 - np.exp(-2.0 * np.pi * self.ff_rc_lpf_hz * dt)
        self._sp_filt = self._sp_filt + a_rc * (np.asarray(setpoint_dps,
                                                           dtype=float)
                                                - self._sp_filt)
        delta = self._sp_filt - self._prev_sp
        sp_speed = delta / dt
        # stage 2: delta in RC counts of the ±500 stick range
        counts = np.abs(delta) * 500.0 / np.maximum(self.max_rate, 1e-9)
        atten = np.clip(counts / max(self.ff_jitter_factor, 1e-9), 0.0, 1.0)
        # stage 3: boost from setpoint acceleration, same attenuator
        accel = sp_speed - self._prev_sp_speed
        f_raw = BF_FF_SCALE * self.kf * atten * (
            sp_speed + 0.1 * self.ff_boost * accel)
        # stage 4: first-order smoothing
        a_f = 1.0 - self.ff_smooth_factor / 100.0
        self._f_state += a_f * (f_raw - self._f_state)
        # stage 5: no extra push past 90% of max commanded rate
        near_max = (np.abs(setpoint_dps)
                    >= 0.01 * self.ff_max_rate_limit * self.max_rate)
        ff_vec = np.where(near_max & (np.sign(self._f_state)
                                      == np.sign(setpoint_dps)),
                          0.0, self._f_state)
        self._prev_sp_speed = sp_speed
        self._prev_t, self._prev_gyro = t, np.array(gyro_dps)
        self._prev_sp = np.array(self._sp_filt)
        ff = ff_vec if self.use_ff else 0.0
        pid_sum = np.clip(p + self.iterm + self._d_state + ff,
                          -self.limit, self.limit)
        return pid_sum / 1000.0


class MockSITL:
    """Pure-Python stand-in Betaflight flight controller.

    Listens on the drone's state (9003+10i) and RC (9004+10i) ports, replies
    motor PWM fractions on 9002+10i. Arms when aux1 >= 1500 like the real
    SITL driven by the reference (BetaAviary.py:149-159).

    Two control modes:
      * ``mode="bf"`` (default): Betaflight's rate-mode PID pipeline with
        the gains of the reference's shipped profile (BFRatePID /
        beta-presets-bak.txt) — a behavioral stand-in, not just plumbing.
      * ``mode="p"``: a plain rate-P loop (wire-parity mode).

    The mixer must match the aviary's drone model: the default ``mix`` is
    ``MIX_RACE`` (the reference's beta.py flies the racer), which has the
    yaw-reaction signs FLIPPED relative to CF2X — pass ``mix=MIX_CF2X`` (or
    use :meth:`for_model`) when the env is built with ``DroneModel.CF2X``,
    or rate-mode corrections destabilize immediately.
    """

    @classmethod
    def for_model(cls, drone_model, drone_index: int = 0,
                  udp_ip: str = "127.0.0.1"):
        """MockSITL with the mixer matching ``drone_model`` (DroneModel or
        its string value)."""
        name = getattr(drone_model, "value", drone_model)
        mix = cls.MIX_CF2X if str(name).startswith("cf2") else cls.MIX_RACE
        return cls(drone_index, udp_ip, mix=mix)

    # pwm-fraction per deg/s of rate error. Sized for the RACE model's
    # authority (tau/err ~ 21/s closed-loop pole, stable with the ~2-tick
    # wire delay at 500 Hz); the real SITL replaces this loop entirely.
    RATE_P = np.array([0.0005, 0.0005, 0.001])
    MAX_RATE_DPS = 360.0

    # Mixer rows in Betaflight motor order, columns (p, q, r) gains. Derived
    # from the reference's sim-motor remap [2,1,3,0] (BetaAviary.py:258-266)
    # against each model's URDF prop layout: the racer's motors sit at
    # (+x,+y), (-x,+y), (-x,-y), (+x,-y) with the yaw reaction sign flipped
    # (racer.urdf:36-74, BaseAviary.py:695-697), unlike the cf2x X layout.
    MIX_RACE = np.array([
        [-1.0, -1.0, -1.0],  # BF0 -> sim m3 (+x, -y)
        [1.0, 1.0, -1.0],    # BF1 -> sim m1 (-x, +y)
        [1.0, -1.0, 1.0],    # BF2 -> sim m0 (+x, +y)
        [-1.0, 1.0, 1.0],    # BF3 -> sim m2 (-x, -y)
    ])
    MIX_CF2X = np.array([
        [1.0, -1.0, 1.0],    # BF0 -> sim m3 (+x, +y)
        [-1.0, 1.0, 1.0],    # BF1 -> sim m1 (-x, -y)
        [-1.0, -1.0, -1.0],  # BF2 -> sim m0 (+x, -y)
        [1.0, 1.0, -1.0],    # BF3 -> sim m2 (-x, +y)
    ])

    def __init__(self, drone_index: int = 0, udp_ip: str = "127.0.0.1",
                 mix: np.ndarray = None, mode: str = "bf", profile=None):
        import socket

        self.index = drone_index
        self.ip = udp_ip
        self.mix = self.MIX_RACE if mix is None else mix
        self.mode = mode
        self._pid = BFRatePID(profile) if mode == "bf" else None
        self.sock_state = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock_state.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock_state.bind((udp_ip, 9003 + 10 * drone_index))
        self.sock_state.settimeout(0.05)
        self.sock_rc = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock_rc.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock_rc.bind((udp_ip, 9004 + 10 * drone_index))
        self.sock_rc.settimeout(0.0)
        self.sock_out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._rc = np.array([1500, 1500, 1000, 1500] + [1000] * 12, dtype=np.uint16)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        for s in (self.sock_state, self.sock_rc, self.sock_out):
            s.close()

    def _loop(self):
        import socket
        import struct

        while not self._stop.is_set():
            try:
                data, _ = self.sock_state.recvfrom(1024)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) != 18 * 8:
                continue
            vals = struct.unpack("@dddddddddddddddddd", data)
            # Wire gyro carries ENU body rates with NED sign flips on y,z
            # (BetaAviary.py:129-131); undo them to work in ENU.
            gyro_enu = np.array(vals[1:4]) * np.array([1.0, -1.0, -1.0])
            # Drain RC to the latest packet
            while True:
                try:
                    rc_raw, _ = self.sock_rc.recvfrom(1024)
                    if len(rc_raw) == 8 + 32:
                        self._rc = np.array(
                            struct.unpack("@dHHHHHHHHHHHHHHHH", rc_raw)[1:],
                            dtype=np.uint16)
                except (BlockingIOError, socket.error):
                    break
            roll_c, pitch_c, thro_c, yaw_c = self._rc[0:4].astype(float)
            armed = self._rc[4] >= 1500
            if not armed:
                pwm = np.zeros(4, dtype=np.float32)
                if self._pid is not None:
                    self._pid.reset()
            else:
                # Channel deviations encode desired ENU body rates (p, q, -r):
                # the inverse of ctbr2beta (BetaAviary.py:176-188).
                dev = (np.array([roll_c, pitch_c, yaw_c]) - 1500.0) / 500.0
                sp_dps = dev * self.MAX_RATE_DPS * np.array([1.0, 1.0, -1.0])
                if self.mode == "bf":
                    # Betaflight pidSum pipeline with the reference profile's
                    # gains; pidSum/1000 is the mixer-scale correction.
                    u = self._pid.update(vals[0], sp_dps,
                                         np.degrees(gyro_enu))
                else:
                    err = sp_dps - np.degrees(gyro_enu)
                    u = self.RATE_P * err  # pwm-fraction corrections
                throttle = (thro_c - 1000.0) / 1000.0
                pwm = throttle + self.mix @ u
                pwm = np.clip(pwm, 0.0, 1.0).astype(np.float32)
            packet = struct.pack("@ffff", *pwm)
            try:
                self.sock_out.sendto(packet, (self.ip, 9002 + 10 * self.index))
            except OSError:
                break
