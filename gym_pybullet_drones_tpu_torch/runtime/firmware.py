"""The firmware-in-the-loop envs' host loops, without gymnasium.

``envs/cf.py`` (``CFAviary``) and ``envs/beta.py`` (``BetaAviary``) are thin
gymnasium classes over the two mixins here, which import nothing of
gymnasium, so that a machine without it still runs the same loops:

* ``CFFirmware`` ticks the native Crazyflie firmware
  (``bridges/cffirmware``) once a physics step, until the sim reaches the
  next control step (CFAviary.step, CFAviary.py:187-261): finite-difference
  rates and g-normalised acceleration, the state and sensor updates through
  the 2nd-order LPFs, the position/attitude controller gating, the tumble
  check, the X power distribution, the brushed-motor PWM curve and the
  high-level command queue;
* ``BetaSITL`` steps the sim on the last PWM received, then exchanges one
  FDM, RC and PWM packet a drone with a Betaflight SITL over UDP
  (``bridges/betaflight``; BetaAviary.step, BetaAviary.py:111-174).

Each mixin calls ``super().step(rpm)`` and ``super().reset()`` for the
simulation: ``compat/gym.BaseAviaryEnv`` in the gymnasium envs, or
``ShellEnv`` here, one env stepped through ``runtime/shell.shell_step``
(``CFShellEnv``, ``BetaShellEnv``).
"""

import math
import subprocess
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.envs import base as envbase
from gym_pybullet_drones_tpu_torch.envs.base import TASK_CTRL, TASK_HOVER, TASK_MULTIHOVER
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.runtime.shell import host_copy, shell_config, shell_step


class ShellEnv:
    """One env stepped through ``shell_step``, with the shell's constructor
    keywords (``runtime/shell.shell_config``) and its ``reset()`` /
    ``step(action)`` signatures, but no gymnasium: no spaces, no
    rendering. ``device=None`` means the CUDA card."""

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X, num_drones: int = 1,
                 physics: Physics = Physics.PYB, pyb_freq: int = 240, ctrl_freq: int = 240,
                 initial_xyzs=None, initial_rpys=None, task: str = TASK_CTRL, device=None,
                 **keywords):
        self.device = resolve_device(device)
        self.cfg = shell_config(drone_model=drone_model, num_drones=num_drones, physics=physics,
                                pyb_freq=pyb_freq, ctrl_freq=ctrl_freq,
                                initial_xyzs=initial_xyzs, initial_rpys=initial_rpys, task=task,
                                **keywords)
        self.params = envbase.build_params(self.cfg, self.device)
        self.ctrl_params = envbase.build_ctrl_params(self.cfg, self.device)
        self.target_pos = (
            envbase.hover_target_pos(self.cfg, self.params)
            if task in (TASK_HOVER, TASK_MULTIHOVER)
            else torch.zeros((num_drones, 3), dtype=self.cfg.torch_dtype, device=self.device))
        p = self.params.to("cpu")
        self.NUM_DRONES, self.PYB_FREQ, self.CTRL_FREQ = num_drones, pyb_freq, ctrl_freq
        self.KF, self.MAX_RPM, self.MAX_THRUST = float(p.kf), float(p.max_rpm), float(p.max_thrust)
        self._state = envbase.reset(self.cfg, self.params)

    def reset(self, seed=None, options=None):
        self._state = envbase.reset(self.cfg, self.params)
        (obs,) = host_copy(envbase.compute_obs(self.cfg, self._state))
        return obs, {}

    def step(self, action):
        self._state, obs, reward, term, trunc = shell_step(
            self.cfg, self.params, self.ctrl_params, self.target_pos, self._state, action)
        return obs, float(reward), bool(term), bool(trunc), {}

    def _getDroneStateVector(self, nth_drone: int) -> np.ndarray:
        """The reference's 20-dim state of one drone (BaseAviary.py:541-561)."""
        (vec,) = host_copy(envbase.drone_state_vector(self.cfg, self._state)[nth_drone])
        return vec

    def close(self):
        pass


def _firmware():
    # The native library is built with g++ at its first import.
    import gym_pybullet_drones_tpu_torch.bridges.cffirmware as firm
    return firm


class CFFirmware:
    """The Crazyflie firmware in the loop (the JAX package's ``envs/cf.py``),
    over a simulation class that follows it in the MRO.

    500 Hz firmware (Mellinger) or 1000 Hz (PID), one drone (CFAviary.py:80-83);
    2nd-order LPFs on the gyro and the accelerometer (:24-25, :127-131);
    ``step(i)`` ticks the firmware until the sim reaches ``(i + 1) /
    ctrl_freq``. Each instance owns a native firmware context, activated
    around its calls, so live envs do not share integrators or planners."""

    ACTION_DELAY = 0
    SENSOR_DELAY = 0
    CONTROLLER = "mellinger"

    GYRO_LPF_CUTOFF_FREQ = 80
    ACCEL_LPF_CUTOFF_FREQ = 30
    QUAD_FORMATION_X = True
    MOTOR_SET_ENABLE = True
    BRUSHED = True
    SUPPLY_VOLTAGE = 3

    RAD_TO_DEG = 180 / math.pi

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X, num_drones: int = 1,
                 physics: Physics = Physics.PYB, pyb_freq: int = 500, ctrl_freq: int = 25,
                 initial_xyzs=None, initial_rpys=None, verbose=False, **kwargs):
        firmware_freq = 500 if self.CONTROLLER == "mellinger" else 1000
        if pyb_freq % firmware_freq != 0:
            raise ValueError(f"pyb_freq ({pyb_freq}) must be a multiple of firmware_freq "
                             f"({firmware_freq}) for CFAviary.")
        if num_drones != 1:
            raise NotImplementedError("CFAviary is single-drone (CFAviary.py:82-83)")
        super().__init__(
            drone_model=drone_model, num_drones=1, physics=physics, pyb_freq=pyb_freq,
            ctrl_freq=firmware_freq, task=TASK_CTRL, initial_xyzs=initial_xyzs,
            initial_rpys=initial_rpys, **kwargs)
        self.firmware_freq = firmware_freq
        self.ctrl_freq = ctrl_freq
        self.PWM2RPM_SCALE, self.PWM2RPM_CONST = 0.2685, 4070.3
        self.MIN_PWM, self.MAX_PWM = 20000, 65535
        self.verbose = verbose
        self.firmware_dt = 1.0 / firmware_freq
        self.ctrl_dt = 1.0 / ctrl_freq

    # -- lifecycle -------------------------------------------------------------

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed=seed, options=options)
        self._initialize_firmware(obs)
        return obs, info

    def _initialize_firmware(self, init_obs):
        firm = _firmware()
        if not hasattr(self, "_firm_ctx") or self._firm_ctx._handle is None:
            self._firm_ctx = firm.FirmwareContext()
        self._firm_ctx.activate()
        self.states = []
        self.takeoff_sent = False
        # Hardware-latency buffers (CFAviary.py:121-124): zero-filled
        # histories of length {ACTION,SENSOR}_DELAY ticks.
        self.action_history = [[0, 0, 0, 0] for _ in range(self.ACTION_DELAY)]
        self.sensor_history = [[[0, 0, 0], [0, 0, 0]] for _ in range(self.SENSOR_DELAY)]
        self.acclpf = [firm.lpf2pData() for _ in range(3)]
        self.gyrolpf = [firm.lpf2pData() for _ in range(3)]
        for i in range(3):
            # A reference quirk kept for parity: CFAviary.py:130-131 set up the
            # ACC filters with GYRO_LPF_CUTOFF_FREQ (80 Hz) and the GYRO filters
            # with ACCEL_LPF_CUTOFF_FREQ (30 Hz); the constants are swapped
            # upstream, and the reference flies with that swap.
            firm.lpf2pInit(self.acclpf[i], self.firmware_freq, self.GYRO_LPF_CUTOFF_FREQ)
            firm.lpf2pInit(self.gyrolpf[i], self.firmware_freq, self.ACCEL_LPF_CUTOFF_FREQ)
        self.control = firm.control_t()
        self.setpoint = firm.setpoint_t()
        self.sensorData = firm.sensorData_t()
        self.state = firm.state_t()
        self.tick = 0
        self.pwms = [0.0, 0.0, 0.0, 0.0]
        self.action = np.zeros((1, 4))
        self.command_queue = []
        self.tumble_counter = 0
        self.prev_vel = np.array(init_obs[0][10:13])
        self.prev_rpy = np.array(init_obs[0][7:10])
        self.last_pos_pid_call = 0.0
        self.last_att_pid_call = 0.0
        self._error = False
        self.full_state_cmd_override = True
        self.first_motor_killed_print = True

        if self.CONTROLLER == "pid":
            firm.controllerPidInit()
        else:
            firm.controllerMellingerInit()
            if self.firmware_freq != 500:
                raise ValueError("Mellinger requires 500 Hz firmware")

        firm.crtpCommanderHighLevelInit()
        init_pos = np.array(init_obs[0][0:3])
        init_vel = np.array(init_obs[0][10:13])
        init_rpy = np.array(init_obs[0][7:10])
        self._update_state(0, init_pos, init_vel, np.array([0.0, 0.0, 1.0]),
                           init_rpy * self.RAD_TO_DEG)
        firm.crtpCommanderHighLevelTellState(self.state)

    # -- main loop -------------------------------------------------------------

    def step(self, i):
        """Advance to sim time (i + 1) / ctrl_freq, ticking the firmware once a
        physics step (CFAviary.step, :187-261). Returns the last sim step's
        5-tuple."""
        t = i / self.ctrl_freq
        self._firm_ctx.activate()
        self._process_command_queue(t)

        out = (None,) * 5
        while self.tick / self.firmware_freq < t + self.ctrl_dt:
            out = super().step(self.action)
            obs = out[0]
            cur_pos = np.array(obs[0][0:3])
            cur_vel = np.array(obs[0][10:13])
            cur_rpy = np.array(obs[0][7:10])
            body_rot = R.from_euler("XYZ", cur_rpy).inv()
            if self.takeoff_sent:
                self.states.append([self.tick / self.firmware_freq, *cur_pos])

            cur_rotation_rates = (cur_rpy - self.prev_rpy) / self.firmware_dt
            self.prev_rpy = cur_rpy
            cur_acc = (cur_vel - self.prev_vel) / self.firmware_dt / 9.8 + np.array([0, 0, 1])
            self.prev_vel = cur_vel

            state_timestamp = int(self.tick / self.firmware_freq * 1e3)
            self._update_state(state_timestamp, cur_pos, cur_vel, cur_acc,
                               cur_rpy * self.RAD_TO_DEG)
            sensor_timestamp = int(self.tick / self.firmware_freq * 1e6)
            if self.SENSOR_DELAY:
                # Hardware sensing latency (CFAviary.py:230-233): the firmware
                # reads the sample of SENSOR_DELAY ticks ago.
                self._update_sensor_data(sensor_timestamp, *self.sensor_history[0])
                self.sensor_history = self.sensor_history[1:] + [
                    [body_rot.apply(cur_acc), cur_rotation_rates * self.RAD_TO_DEG]]
            else:
                self._update_sensor_data(sensor_timestamp, body_rot.apply(cur_acc),
                                         cur_rotation_rates * self.RAD_TO_DEG)
            self._update_setpoint(self.tick / self.firmware_freq)
            self._step_controller()

            new_action = self.PWM2RPM_SCALE * np.clip(
                np.array(self.pwms), self.MIN_PWM, self.MAX_PWM) + self.PWM2RPM_CONST
            if self.ACTION_DELAY:
                # Hardware response latency (CFAviary.py:254-257): the command
                # of ACTION_DELAY ticks ago.
                delayed = np.asarray(self.action_history[0], dtype=float)
                self.action_history = self.action_history[1:] + [new_action]
                new_action = delayed
            if self._error:
                new_action = np.zeros(4)
                if self.first_motor_killed_print:
                    print("[WARNING] CFAviary: firmware error, motors killed.")
                    self.first_motor_killed_print = False
            self.action = new_action.reshape(1, 4)
        return out

    # -- firmware data plumbing ------------------------------------------------

    def _update_sensor_data(self, timestamp, acc_vals, gyro_vals):
        firm = _firmware()
        self.sensorData.acc.x = firm.lpf2pApply(self.acclpf[0], acc_vals[0])
        self.sensorData.acc.y = firm.lpf2pApply(self.acclpf[1], acc_vals[1])
        self.sensorData.acc.z = firm.lpf2pApply(self.acclpf[2], acc_vals[2])
        self.sensorData.gyro.x = firm.lpf2pApply(self.gyrolpf[0], gyro_vals[0])
        self.sensorData.gyro.y = firm.lpf2pApply(self.gyrolpf[1], gyro_vals[1])
        self.sensorData.gyro.z = firm.lpf2pApply(self.gyrolpf[2], gyro_vals[2])
        self.sensorData.interruptTimestamp = timestamp

    def _update_state(self, timestamp, pos, vel, acc, rpy_deg):
        att = self.state.attitude
        att.timestamp = timestamp
        att.roll = rpy_deg[0]
        att.pitch = -rpy_deg[1]  # the legacy CF2 frame's inverted pitch (CFAviary.py:363)
        att.yaw = rpy_deg[2]
        if self.CONTROLLER == "mellinger":
            q = R.from_euler("xyz", np.asarray(rpy_deg) / self.RAD_TO_DEG).as_quat()
            aq = self.state.attitudeQuaternion
            aq.timestamp = timestamp
            aq.x, aq.y, aq.z, aq.w = map(float, q)
        for target, vals in ((self.state.position, pos), (self.state.velocity, vel),
                             (self.state.acc, acc)):
            target.timestamp = timestamp
            target.x, target.y, target.z = map(float, vals)

    # -- the reference's plumbing names (CFAviary.py:112-361) ------------------
    # The loop above uses snake_case; these keep the reference's method names
    # and decompositions, so that code written against CFAviary keeps working.

    def _initalize_cffirmware(self):  # sic: the reference's spelling (:112)
        """Reset the firmware from the live sim state."""
        self._initialize_firmware(self._getDroneStateVector(0).reshape(1, -1))

    def _update_initial_state(self, obs):
        """(CFAviary.py:263-265): seed the finite-difference memory."""
        self.prev_vel = np.array(obs[10:13])
        self.prev_rpy = np.array(obs[7:10])

    def _update_sensorData(self, timestamp, acc_vals, gyro_vals, baro_vals=(1013.25, 25)):
        """(CFAviary.py:272-291). The native firmware subset has no barometer
        input (neither controller reads one): ``baro_vals`` is accepted for
        the signature and ignored."""
        self._update_sensor_data(timestamp, acc_vals, gyro_vals)

    def _update_gyro(self, x, y, z):
        firm = _firmware()
        self.sensorData.gyro.x = firm.lpf2pApply(self.gyrolpf[0], x)
        self.sensorData.gyro.y = firm.lpf2pApply(self.gyrolpf[1], y)
        self.sensorData.gyro.z = firm.lpf2pApply(self.gyrolpf[2], z)

    def _update_acc(self, x, y, z):
        firm = _firmware()
        self.sensorData.acc.x = firm.lpf2pApply(self.acclpf[0], x)
        self.sensorData.acc.y = firm.lpf2pApply(self.acclpf[1], y)
        self.sensorData.acc.z = firm.lpf2pApply(self.acclpf[2], z)

    @staticmethod
    def _update_baro(baro, pressure, temperature):
        """(CFAviary.py:303-311): barometric altitude from the pressure [hPa]
        and temperature [C], written onto any object with baro_t's fields."""
        baro.pressure = pressure
        baro.temperature = temperature
        # As in the reference, the formula takes 25 C (298.15 K) whatever the
        # temperature argument (CFAviary.py:311).
        baro.asl = (((1015.7 / baro.pressure) ** 0.1902630958 - 1)
                    * (25 + 273.15)) / 0.0065

    @staticmethod
    def _update_3D_vec(point, timestamp, x, y, z):
        point.x, point.y, point.z = x, y, z
        point.timestamp = timestamp

    def _update_attitudeQuaternion(self, quaternion_t, timestamp, qx, qy, qz, qw=None):
        """(CFAviary.py:341-355): an xyzw quaternion, or roll/pitch/yaw in
        degrees when ``qw`` is omitted."""
        quaternion_t.timestamp = timestamp
        if qw is None:
            q = R.from_euler("xyz", np.array([qx, qy, qz]) / self.RAD_TO_DEG).as_quat()
            qx, qy, qz, qw = map(float, q)
        quaternion_t.x, quaternion_t.y = qx, qy
        quaternion_t.z, quaternion_t.w = qz, qw

    def _update_attitude_t(self, attitude_t, timestamp, roll, pitch, yaw):
        """(CFAviary.py:357-361): the legacy CF2 frame, pitch inverted."""
        attitude_t.timestamp = timestamp
        attitude_t.roll = roll
        attitude_t.pitch = -pitch
        attitude_t.yaw = yaw

    def _updateSetpoint(self, timestep):
        self._update_setpoint(timestep)

    def _powerDistribution(self, control):
        self._power_distribution(control)

    def _motorsGetPWM(self, thrust):
        return self._motors_get_pwm(thrust)

    @staticmethod
    def _limitThrust(val):
        return CFFirmware._limit_thrust(val)

    def _step_controller(self):
        # Tumble detection (CFAviary.py:376-386)
        if self.state.acc.z < -0.5:
            self.tumble_counter += 1
        else:
            self.tumble_counter = 0
        if self.tumble_counter >= 30:
            print("[WARNING] CFAviary: tumble detected, killing motors.")
            self.pwms = [0, 0, 0, 0]
            self.tick += 1
            self._error = True
            return

        # Rate gating (CFAviary.py:388-398)
        cur_time = self.tick / self.firmware_freq
        if (cur_time - self.last_att_pid_call > 0.002
                and cur_time - self.last_pos_pid_call > 0.01):
            _tick = 0
            self.last_pos_pid_call = cur_time
            self.last_att_pid_call = cur_time
        elif cur_time - self.last_att_pid_call > 0.002:
            self.last_att_pid_call = cur_time
            _tick = 2
        else:
            _tick = 1

        firm = _firmware()
        if self.CONTROLLER == "pid":
            firm.controllerPid(self.control, self.setpoint, self.sensorData, self.state, _tick)
        else:
            firm.controllerMellinger(self.control, self.setpoint, self.sensorData, self.state,
                                     _tick)
        self._power_distribution(self.control)
        self.tick += 1

    def _update_setpoint(self, timestep):
        if not self.full_state_cmd_override:
            firm = _firmware()
            firm.crtpCommanderHighLevelTellState(self.state)
            firm.crtpCommanderHighLevelUpdateTime(timestep)
            firm.crtpCommanderHighLevelGetSetpoint(self.setpoint, self.state)

    # -- power stage (CFAviary.py:609-652) ------------------------------------

    def _motors_get_pwm(self, thrust):
        if not self.BRUSHED:
            raise NotImplementedError("brushless motors not supported")
        thrust = thrust / 65536 * 60
        volts = -0.0006239 * thrust**2 + 0.088 * thrust
        percentage = min(1.0, volts / self.SUPPLY_VOLTAGE)
        return percentage * self.MAX_PWM

    @staticmethod
    def _limit_thrust(val):
        return float(np.clip(val, 0, 65535))

    def _power_distribution(self, control):
        pwm, lim = self._motors_get_pwm, self._limit_thrust
        if self.QUAD_FORMATION_X:
            r = control.roll / 2
            p = control.pitch / 2
            pwms = [
                pwm(lim(control.thrust - r + p + control.yaw)),
                pwm(lim(control.thrust - r - p - control.yaw)),
                pwm(lim(control.thrust + r - p + control.yaw)),
                pwm(lim(control.thrust + r + p - control.yaw)),
            ]
        else:
            pwms = [
                pwm(lim(control.thrust + control.pitch + control.yaw)),
                pwm(lim(control.thrust - control.roll - control.yaw)),
                pwm(lim(control.thrust - control.pitch + control.yaw)),
                pwm(lim(control.thrust + control.roll - control.yaw)),
            ]
        self.pwms = pwms if self.MOTOR_SET_ENABLE else np.clip(pwms, self.MIN_PWM, None).tolist()

    # -- command queue (CFAviary.py:428-606) ----------------------------------

    def _process_command_queue(self, sim_time):
        if self.command_queue:
            firm = _firmware()
            firm.crtpCommanderHighLevelStop()
            firm.crtpCommanderHighLevelUpdateTime(sim_time)
            command, args = self.command_queue.pop(0)
            getattr(self, command)(*args)

    def sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        self.command_queue.append(["_sendFullStateCmd", [pos, vel, acc, yaw, rpy_rate, timestep]])

    def _sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        firm = _firmware()
        sp = self.setpoint
        sp.position.x, sp.position.y, sp.position.z = map(float, pos)
        sp.velocity.x, sp.velocity.y, sp.velocity.z = map(float, vel)
        sp.acceleration.x, sp.acceleration.y, sp.acceleration.z = map(float, acc)
        sp.attitudeRate.roll = rpy_rate[0] * self.RAD_TO_DEG
        sp.attitudeRate.pitch = rpy_rate[1] * self.RAD_TO_DEG
        sp.attitudeRate.yaw = rpy_rate[2] * self.RAD_TO_DEG
        q = R.from_euler("xyz", [0, 0, yaw]).as_quat()
        sp.attitudeQuaternion.x, sp.attitudeQuaternion.y = float(q[0]), float(q[1])
        sp.attitudeQuaternion.z, sp.attitudeQuaternion.w = float(q[2]), float(q[3])
        sp.mode.x = sp.mode.y = sp.mode.z = firm.modeAbs
        sp.mode.quat = firm.modeAbs
        sp.mode.roll = sp.mode.pitch = sp.mode.yaw = firm.modeDisable
        sp.timestamp = int(timestep * 1000)
        self.full_state_cmd_override = True

    def sendTakeoffCmd(self, height, duration):
        self.command_queue.append(["_sendTakeoffCmd", [height, duration]])

    def _sendTakeoffCmd(self, height, duration):
        self.takeoff_sent = True
        _firmware().crtpCommanderHighLevelTakeoff(height, duration)
        self.full_state_cmd_override = False

    def sendTakeoffYawCmd(self, height, duration, yaw):
        self.command_queue.append(["_sendTakeoffYawCmd", [height, duration, yaw]])

    def _sendTakeoffYawCmd(self, height, duration, yaw):
        _firmware().crtpCommanderHighLevelTakeoffYaw(height, duration, yaw)
        self.full_state_cmd_override = False

    def sendTakeoffVelCmd(self, height, vel, relative):
        self.command_queue.append(["_sendTakeoffVelCmd", [height, vel, relative]])

    def _sendTakeoffVelCmd(self, height, vel, relative):
        _firmware().crtpCommanderHighLevelTakeoffWithVelocity(height, vel, relative)
        self.full_state_cmd_override = False

    def sendLandCmd(self, height, duration):
        self.command_queue.append(["_sendLandCmd", [height, duration]])

    def _sendLandCmd(self, height, duration):
        _firmware().crtpCommanderHighLevelLand(height, duration)
        self.full_state_cmd_override = False

    def sendLandYawCmd(self, height, duration, yaw):
        self.command_queue.append(["_sendLandYawCmd", [height, duration, yaw]])

    def _sendLandYawCmd(self, height, duration, yaw):
        _firmware().crtpCommanderHighLevelLandYaw(height, duration, yaw)
        self.full_state_cmd_override = False

    def sendLandVelCmd(self, height, vel, relative):
        self.command_queue.append(["_sendLandVelCmd", [height, vel, relative]])

    def _sendLandVelCmd(self, height, vel, relative):
        _firmware().crtpCommanderHighLevelLandWithVelocity(height, vel, relative)
        self.full_state_cmd_override = False

    def sendStopCmd(self):
        self.command_queue.append(["_sendStopCmd", []])

    def _sendStopCmd(self):
        _firmware().crtpCommanderHighLevelStop()
        self.full_state_cmd_override = False

    def sendGotoCmd(self, pos, yaw, duration_s, relative):
        self.command_queue.append(["_sendGotoCmd", [pos, yaw, duration_s, relative]])

    def _sendGotoCmd(self, pos, yaw, duration_s, relative):
        _firmware().crtpCommanderHighLevelGoTo(*pos, yaw, duration_s, relative)
        self.full_state_cmd_override = False

    def notifySetpointStop(self):
        self.command_queue.append(["_notifySetpointStop", []])

    def _notifySetpointStop(self):
        _firmware().crtpCommanderHighLevelTellState(self.state)
        self.full_state_cmd_override = False

    def close(self):
        """Release the native firmware context (safe to call again)."""
        if hasattr(self, "_firm_ctx"):
            self._firm_ctx.close()
        super().close()


class BetaSITL:
    """A Betaflight SITL in the loop (the JAX package's ``envs/beta.py``),
    over a simulation class that follows it in the MRO.

    One UDP channel triple a drone at ports 9002/9003/9004 + 10 i on
    ``udp_ip`` (BetaAviary.py:14-16, :104): the 18-double FDM packet with
    ENU->NED gyro sign flips (:126-137), the 16-channel RC packet arming
    through aux1 after ARM_TIME (:149-159), a non-blocking PWM read that keeps
    the stale PWM on a miss (:161-170), ``ctbr2beta`` (:176-188) and the SITL
    motor remap [2, 1, 3, 0] with rpm = sqrt(MAX_THRUST / (4 kf) a) (:258-266).

    ``sitl_paths`` spawns real ``betaflight_SITL.elf`` binaries; otherwise run
    ``bridges.betaflight.MockSITL`` instances on the same ports."""

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X, num_drones: int = 1,
                 physics: Physics = Physics.PYB, pyb_freq: int = 240, ctrl_freq: int = 240,
                 initial_xyzs=None, initial_rpys=None, udp_ip: str = "127.0.0.1",
                 sitl_paths=None, **kwargs):
        from gym_pybullet_drones_tpu_torch.bridges.betaflight import BetaBridge

        super().__init__(
            drone_model=drone_model, num_drones=num_drones, physics=physics,
            pyb_freq=pyb_freq, ctrl_freq=ctrl_freq, task=TASK_CTRL,
            initial_xyzs=initial_xyzs, initial_rpys=initial_rpys, **kwargs)
        self.UDP_IP = udp_ip
        self.ARM_TIME = 1.0
        self.TRAJ_TIME = 1.5
        self._sitl_procs = []
        if sitl_paths:
            for path in sitl_paths:
                self._sitl_procs.append(subprocess.Popen(
                    [path], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
            time.sleep(2)
        self.bridges = [BetaBridge(i, udp_ip) for i in range(num_drones)]
        self.beta_action = np.zeros((num_drones, 4))

    def close(self):
        for b in self.bridges:
            b.close()
        for p in self._sitl_procs:
            p.terminate()
        super().close()

    def step(self, action, i):
        """``action`` is (N, 4) CTBR [thrust, p, q, r] (BetaAviary.py:111-174):
        the sim steps on the last PWM received, then each drone's packets are
        exchanged."""
        out = super().step(self._beta_pwm_to_rpm(self.beta_action))
        obs = out[0]
        t = i / self.CTRL_FREQ
        for j in range(self.NUM_DRONES):
            o = np.asarray(obs[j])
            quat_xyzw = np.asarray(o[3:7], dtype=float)
            w_world = np.asarray(o[13:16], dtype=float)
            # World -> body: rotate by the conjugate quaternion, in numpy (a
            # 3-vector on the host needs no device launch).
            x, y, z, w = -quat_xyzw[0], -quat_xyzw[1], -quat_xyzw[2], quat_xyzw[3]
            t2 = 2.0 * np.cross([x, y, z], w_world)
            w_body = w_world + w * t2 + np.cross([x, y, z], t2)

            self.bridges[j].send_fdm(t, w_body)

            thro, roll, pitch, yaw = 1000.0, 1500.0, 1500.0, 1500.0
            if t > self.TRAJ_TIME:
                thro, roll, pitch, yaw = self.ctbr2beta(*action[j])
            aux1 = 1000 if t < self.ARM_TIME else 1500
            channels = np.array([round(roll), round(pitch), round(thro), round(yaw), aux1]
                                + [1000] * 11, dtype=np.uint16)
            self.bridges[j].send_rc(t, channels)

            pwm, fresh = self.bridges[j].recv_pwm()
            self.beta_action[j] = pwm
        return out

    def ctbr2beta(self, thrust, roll, pitch, yaw):
        """CTBR (thrust in N, body rates in rad/s) -> 1000-2000 RC channels
        (BetaAviary.py:176-188)."""
        MIN_CHANNEL, MAX_CHANNEL = 1000, 2000
        MAX_RATE, MAX_THRUST = 360.0, 40.9
        mid = (MAX_CHANNEL + MIN_CHANNEL) / 2
        d = (MAX_CHANNEL - MIN_CHANNEL) / 2
        thrust = thrust / MAX_THRUST * d * 2 + MIN_CHANNEL
        rates = np.array([roll, pitch, -yaw]) / np.pi * 180 / MAX_RATE * d + mid
        return (float(np.clip(thrust, MIN_CHANNEL, MAX_CHANNEL)),
                *np.clip(rates, MIN_CHANNEL, MAX_CHANNEL))

    def _beta_pwm_to_rpm(self, beta_action):
        """The SITL motor remap [2, 1, 3, 0] and pwm fraction -> RPM
        (BetaAviary._preprocessAction, :258-266)."""
        remapped = beta_action[:, [2, 1, 3, 0]]
        return np.sqrt(self.MAX_THRUST / 4 / self.KF * np.maximum(remapped, 0.0))


class CFShellEnv(CFFirmware, ShellEnv):
    """``CFAviary``'s loop over ``ShellEnv``: the same firmware ticks, no
    gymnasium."""


class BetaShellEnv(BetaSITL, ShellEnv):
    """``BetaAviary``'s loop over ``ShellEnv``: the same packet exchange, no
    gymnasium."""
