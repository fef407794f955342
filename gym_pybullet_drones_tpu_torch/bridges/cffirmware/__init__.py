"""ctypes bindings for the native cffirm library, a Crazyflie firmware subset
(port of the JAX package's ``bridges/cffirmware``; ``src/cffirm.cpp`` is the
same source).

The Python surface mirrors the ``pycffirmware`` calls the reference drives
(CFAviary.py:127-131, :401-416, :422-433): ``lpf2pData/lpf2pInit/lpf2pApply``,
``control_t/setpoint_t/sensorData_t/state_t``, ``controllerPid*``,
``controllerMellinger*`` and the ``crtpCommanderHighLevel*`` planner calls,
with the ``modeAbs/modeDisable/modeVelocity`` constants. The library is built
from ``src/cffirm.cpp`` with g++ into the package's ``_build/`` at first
import (``bridges/_native.py``).
"""

import ctypes
import os

from gym_pybullet_drones_tpu_torch.bridges._native import load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "cffirm.cpp")
_lib = load(_SRC)

# -- mode constants (enum stab_mode_t) ----------------------------------------
modeDisable = 0
modeAbs = 1
modeVelocity = 2


# -- struct mirrors (must match cffirm.cpp layouts) ---------------------------

class vec3(ctypes.Structure):
    _fields_ = [("x", ctypes.c_float), ("y", ctypes.c_float), ("z", ctypes.c_float)]


class attitude_t(ctypes.Structure):
    _fields_ = [("timestamp", ctypes.c_uint32), ("roll", ctypes.c_float),
                ("pitch", ctypes.c_float), ("yaw", ctypes.c_float)]


class quaternion_t(ctypes.Structure):
    _fields_ = [("timestamp", ctypes.c_uint32), ("x", ctypes.c_float),
                ("y", ctypes.c_float), ("z", ctypes.c_float), ("w", ctypes.c_float)]


class point_t(ctypes.Structure):
    _fields_ = [("timestamp", ctypes.c_uint32), ("x", ctypes.c_float),
                ("y", ctypes.c_float), ("z", ctypes.c_float)]


class state_t(ctypes.Structure):
    _fields_ = [("attitude", attitude_t), ("attitudeQuaternion", quaternion_t),
                ("position", point_t), ("velocity", point_t), ("acc", point_t)]


class sensorData_t(ctypes.Structure):
    _fields_ = [("acc", vec3), ("gyro", vec3), ("mag", vec3),
                ("interruptTimestamp", ctypes.c_uint64)]


class setpoint_mode_t(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in
                ("x", "y", "z", "roll", "pitch", "yaw", "quat")]


class setpoint_t(ctypes.Structure):
    _fields_ = [("timestamp", ctypes.c_uint32), ("attitude", attitude_t),
                ("attitudeRate", attitude_t), ("attitudeQuaternion", quaternion_t),
                ("thrust", ctypes.c_float), ("position", point_t),
                ("velocity", point_t), ("acceleration", point_t),
                ("velocity_body", ctypes.c_int32), ("mode", setpoint_mode_t)]


class control_t(ctypes.Structure):
    _fields_ = [("roll", ctypes.c_float), ("pitch", ctypes.c_float),
                ("yaw", ctypes.c_float), ("thrust", ctypes.c_float)]


class lpf2pData(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float) for n in
                ("a1", "a2", "b0", "b1", "b2", "delay1", "delay2")]


# -- function prototypes ------------------------------------------------------

_lib.lpf2pInit.argtypes = [ctypes.POINTER(lpf2pData), ctypes.c_float, ctypes.c_float]
_lib.lpf2pApply.argtypes = [ctypes.POINTER(lpf2pData), ctypes.c_float]
_lib.lpf2pApply.restype = ctypes.c_float
_lib.controllerPidInit.argtypes = []
_lib.controllerPidTest.restype = ctypes.c_int
_lib.controllerPid.argtypes = [
    ctypes.POINTER(control_t), ctypes.POINTER(setpoint_t),
    ctypes.POINTER(sensorData_t), ctypes.POINTER(state_t), ctypes.c_uint32]
_lib.controllerMellingerInit.argtypes = []
_lib.controllerMellingerTest.restype = ctypes.c_int
_lib.controllerMellinger.argtypes = _lib.controllerPid.argtypes
_lib.crtpCommanderHighLevelInit.argtypes = []
_lib.crtpCommanderHighLevelTellState.argtypes = [ctypes.POINTER(state_t)]
_lib.crtpCommanderHighLevelUpdateTime.argtypes = [ctypes.c_float]
_lib.crtpCommanderHighLevelIsTrajectoryFinished.restype = ctypes.c_int
_lib.crtpCommanderHighLevelStop.argtypes = []
_lib.crtpCommanderHighLevelTakeoff.argtypes = [ctypes.c_float, ctypes.c_float]
_lib.crtpCommanderHighLevelTakeoffYaw.argtypes = [ctypes.c_float] * 3
_lib.crtpCommanderHighLevelLand.argtypes = [ctypes.c_float, ctypes.c_float]
_lib.crtpCommanderHighLevelLandYaw.argtypes = [ctypes.c_float] * 3
_lib.crtpCommanderHighLevelTakeoffWithVelocity.argtypes = [
    ctypes.c_float, ctypes.c_float, ctypes.c_int]
_lib.crtpCommanderHighLevelLandWithVelocity.argtypes = [
    ctypes.c_float, ctypes.c_float, ctypes.c_int]
_lib.crtpCommanderHighLevelGoTo.argtypes = [
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_int]
_lib.crtpCommanderHighLevelGetSetpoint.argtypes = [
    ctypes.POINTER(setpoint_t), ctypes.POINTER(state_t)]


# -- pycffirmware-style free functions ----------------------------------------

def lpf2pInit(f, sample_freq, cutoff_freq):
    _lib.lpf2pInit(ctypes.byref(f), sample_freq, cutoff_freq)


def lpf2pApply(f, sample):
    return _lib.lpf2pApply(ctypes.byref(f), float(sample))


def controllerPidInit():
    _lib.controllerPidInit()


def controllerPidTest():
    return bool(_lib.controllerPidTest())


def controllerPid(control, setpoint, sensorData, state, tick):
    _lib.controllerPid(ctypes.byref(control), ctypes.byref(setpoint),
                       ctypes.byref(sensorData), ctypes.byref(state), tick)


def controllerMellingerInit():
    _lib.controllerMellingerInit()


def controllerMellingerTest():
    return bool(_lib.controllerMellingerTest())


def controllerMellinger(control, setpoint, sensorData, state, tick):
    _lib.controllerMellinger(ctypes.byref(control), ctypes.byref(setpoint),
                             ctypes.byref(sensorData), ctypes.byref(state), tick)


def crtpCommanderHighLevelInit():
    _lib.crtpCommanderHighLevelInit()


def crtpCommanderHighLevelTellState(state):
    _lib.crtpCommanderHighLevelTellState(ctypes.byref(state))


def crtpCommanderHighLevelUpdateTime(t):
    _lib.crtpCommanderHighLevelUpdateTime(float(t))


def crtpCommanderHighLevelIsTrajectoryFinished():
    return bool(_lib.crtpCommanderHighLevelIsTrajectoryFinished())


def crtpCommanderHighLevelStop():
    _lib.crtpCommanderHighLevelStop()


def crtpCommanderHighLevelTakeoff(height, duration):
    _lib.crtpCommanderHighLevelTakeoff(height, duration)


def crtpCommanderHighLevelTakeoffYaw(height, duration, yaw):
    _lib.crtpCommanderHighLevelTakeoffYaw(height, duration, yaw)


def crtpCommanderHighLevelLand(height, duration):
    _lib.crtpCommanderHighLevelLand(height, duration)


def crtpCommanderHighLevelLandYaw(height, duration, yaw):
    _lib.crtpCommanderHighLevelLandYaw(height, duration, yaw)


def crtpCommanderHighLevelTakeoffWithVelocity(height, vel, relative):
    _lib.crtpCommanderHighLevelTakeoffWithVelocity(height, vel, int(relative))


def crtpCommanderHighLevelLandWithVelocity(height, vel, relative):
    _lib.crtpCommanderHighLevelLandWithVelocity(height, vel, int(relative))


def crtpCommanderHighLevelGoTo(x, y, z, yaw, duration, relative):
    _lib.crtpCommanderHighLevelGoTo(x, y, z, yaw, duration, int(relative))


def crtpCommanderHighLevelGetSetpoint(setpoint, state):
    _lib.crtpCommanderHighLevelGetSetpoint(ctypes.byref(setpoint),
                                           ctypes.byref(state))


def controllerMellingerSetKdOmegaRP(kd):
    _lib.controllerMellingerSetKdOmegaRP(ctypes.c_float(kd))


# -- instance contexts --------------------------------------------------------
# All firmware state (PID integrators, Mellinger gains/integrals, high-level
# planner) lives in an opaque context; the legacy global functions above act on
# the *active* one. Each CFAviary owns a FirmwareContext and activates it
# around its calls, so concurrently-live envs cannot corrupt each other
# (each env activates its own).

_lib.firmContextCreate.restype = ctypes.c_void_p
_lib.firmContextDestroy.argtypes = [ctypes.c_void_p]
_lib.firmContextActivate.argtypes = [ctypes.c_void_p]
_lib.firmContextActive.restype = ctypes.c_void_p


class FirmwareContext:
    """Opaque per-instance firmware state. Use as a context manager or call
    ``activate()`` before driving the controller/commander functions."""

    def __init__(self):
        self._handle = _lib.firmContextCreate()

    def activate(self):
        if self._handle is None:
            raise RuntimeError("FirmwareContext already destroyed")
        _lib.firmContextActivate(ctypes.c_void_p(self._handle))

    def __enter__(self):
        self._prev = _lib.firmContextActive()
        self.activate()
        return self

    def __exit__(self, *exc):
        _lib.firmContextActivate(ctypes.c_void_p(self._prev))
        return False

    def close(self):
        if self._handle is not None:
            _lib.firmContextDestroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
