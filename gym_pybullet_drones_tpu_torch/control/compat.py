"""Stateful controller shells with the reference's ``computeControlFromState`` API
(port of the JAX ``control/compat.py``).

The reference exposes controllers as mutable classes
(control/BaseControl.py:55-93: ``computeControlFromState(control_timestep,
state, target_pos, ...) -> (rpm, pos_e, yaw_e)`` slicing the 20-dim state
vector). These shells hold the pure-function controller state and call the
plain functions on float32 tensors, numpy in and numpy out, so scripts written
against the reference port unchanged. Each call is one host round trip: for
fleets use the functions directly (``dsl_pid_control`` and the others
broadcast over batch axes). ``device=None`` means the CUDA card.
"""

import os
import xml.etree.ElementTree as etxml

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.control.ctbr import ctbr_control, ctbr_params
from gym_pybullet_drones_tpu_torch.control.dsl_pid import (
    _attitude_control,
    _position_control,
    dsl_pid_control,
    dsl_pid_params,
    dsl_pid_reset,
    one23d_interface,
)
from gym_pybullet_drones_tpu_torch.control.mrac import mrac_control, mrac_params, mrac_reset
from gym_pybullet_drones_tpu_torch.core.params import ASSETS, G
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel


def _np(x):
    return x.detach().cpu().numpy()


class BaseControl:
    """API anchor (reference control/BaseControl.py): subclasses implement
    ``computeControl``; ``computeControlFromState`` slices the 20-dim state."""

    def __init__(self, drone_model: DroneModel, g: float = G, device=None):
        self.DRONE_MODEL = drone_model
        self.device = resolve_device(device)
        # Reference BaseControl.__init__ derives these from the URDF (:32-41)
        self.GRAVITY = g * self._getURDFParameter("m")
        self.KF = self._getURDFParameter("kf")
        self.KM = self._getURDFParameter("km")
        self.control_counter = 0

    def _t(self, x):
        """A float32 tensor on the shell's device from a number or array."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def reset(self):
        self.control_counter = 0

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3), target_rpy_rates=np.zeros(3)):
        """Abstract per-drone control step (BaseControl.computeControl, :97-134)."""
        raise NotImplementedError

    def setPIDCoefficients(self, p_coeff_pos=None, i_coeff_pos=None,
                           d_coeff_pos=None, p_coeff_att=None,
                           i_coeff_att=None, d_coeff_att=None):
        """Swap PID gains by attribute (BaseControl.setPIDCoefficients,
        :138-177). Errors out, like the reference, when the instantiated
        controller has no PID coefficient attributes (e.g. CTBR, MRAC)."""
        ATTR_LIST = ["P_COEFF_FOR", "I_COEFF_FOR", "D_COEFF_FOR",
                     "P_COEFF_TOR", "I_COEFF_TOR", "D_COEFF_TOR"]
        if not all(hasattr(self, attr) for attr in ATTR_LIST):
            print("[ERROR] in BaseControl.setPIDCoefficients(), not all PID "
                  "coefficients exist as attributes in the instantiated "
                  "control class.")
            raise SystemExit(1)
        # Only the gains supplied: a None argument keeps the current gain.
        for attr, value in zip(ATTR_LIST, (p_coeff_pos, i_coeff_pos,
                                           d_coeff_pos, p_coeff_att,
                                           i_coeff_att, d_coeff_att)):
            if value is not None:
                setattr(self, attr, value)

    def _getURDFParameter(self, parameter_name: str) -> float:
        """Positional-XML URDF parameter read (BaseControl._getURDFParameter,
        :181-216), against the port's own URDFs (``assets/``, the reference
        assets' element layout)."""
        path = os.path.join(ASSETS, self.DRONE_MODEL.value + ".urdf")
        root = etxml.parse(path).getroot()
        if parameter_name == "m":
            return float(root[1][0][1].attrib["value"])
        if parameter_name in ("ixx", "iyy", "izz"):
            return float(root[1][0][2].attrib[parameter_name])
        if parameter_name in ("arm", "thrust2weight", "kf", "km", "max_speed_kmh",
                              "gnd_eff_coeff", "prop_radius", "drag_coeff_xy",
                              "drag_coeff_z", "dw_coeff_1", "dw_coeff_2",
                              "dw_coeff_3"):
            return float(root[0].attrib[parameter_name])
        if parameter_name in ("length", "radius"):
            return float(root[1][2][1][0].attrib[parameter_name])
        if parameter_name == "collision_z_offset":
            offsets = [float(s) for s in root[1][2][0].attrib["xyz"].split(" ")]
            return offsets[2]
        raise KeyError(parameter_name)

    def computeControlFromState(self, control_timestep, state, target_pos,
                                target_rpy=np.zeros(3), target_vel=np.zeros(3),
                                target_rpy_rates=np.zeros(3)):
        """Slice the 20-dim state (BaseControl.py:84-93) and delegate."""
        state = np.asarray(state)
        return self.computeControl(
            control_timestep=control_timestep,
            cur_pos=state[0:3], cur_quat=state[3:7], cur_vel=state[10:13],
            cur_ang_vel=state[13:16], target_pos=np.asarray(target_pos),
            target_rpy=np.asarray(target_rpy), target_vel=np.asarray(target_vel),
            target_rpy_rates=np.asarray(target_rpy_rates),
        )


class DSLPIDControl(BaseControl):
    """Reference control/DSLPIDControl.py as a shell over ``dsl_pid_control``."""

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X, g: float = G,
                 device=None):
        super().__init__(drone_model, g, device)
        self.params = dsl_pid_params(drone_model, g=g, dtype=torch.float32, device=self.device)
        # Reference constant attributes (DSLPIDControl.py:43-60)
        self.PWM2RPM_SCALE = float(self.params.pwm2rpm_scale)
        self.PWM2RPM_CONST = float(self.params.pwm2rpm_const)
        self.MIN_PWM = float(self.params.min_pwm)
        self.MAX_PWM = float(self.params.max_pwm)
        self.MIXER_MATRIX = _np(self.params.mixer)
        self.reset()

    def _set_gain(self, field, value):
        self.params = self.params.replace(**{field: self._t(value)})

    # Reference gain attributes (DSLPIDControl.py:37-42), backed by the params
    # record so the base setPIDCoefficients and direct writes both retune.
    P_COEFF_FOR = property(lambda s: _np(s.params.p_for),
                           lambda s, v: s._set_gain("p_for", v))
    I_COEFF_FOR = property(lambda s: _np(s.params.i_for),
                           lambda s, v: s._set_gain("i_for", v))
    D_COEFF_FOR = property(lambda s: _np(s.params.d_for),
                           lambda s, v: s._set_gain("d_for", v))
    P_COEFF_TOR = property(lambda s: _np(s.params.p_tor),
                           lambda s, v: s._set_gain("p_tor", v))
    I_COEFF_TOR = property(lambda s: _np(s.params.i_tor),
                           lambda s, v: s._set_gain("i_tor", v))
    D_COEFF_TOR = property(lambda s: _np(s.params.d_tor),
                           lambda s, v: s._set_gain("d_tor", v))

    def reset(self):
        super().reset()
        self.state = dsl_pid_reset((), device=self.device)

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3), target_rpy_rates=np.zeros(3)):
        self.control_counter += 1
        t = self._t
        rpm, self.state, pos_e, yaw_e = dsl_pid_control(
            self.params, self.state, t(control_timestep), t(cur_pos), t(cur_quat),
            t(cur_vel), t(target_pos), t(target_rpy), t(target_vel), t(target_rpy_rates))
        return _np(rpm), _np(pos_e), float(yaw_e)

    def _dslPIDPositionControl(self, control_timestep, cur_pos, cur_quat,
                               cur_vel, target_pos, target_rpy, target_vel):
        """Position loop only (DSLPIDControl._dslPIDPositionControl, :149-209).
        Updates the carried position integral; returns
        (thrust [PWM units], computed_target_rpy, pos_e)."""
        t = self._t
        thrust, target_euler, pos_e, integral_pos_e = _position_control(
            self.params, self.state.integral_pos_e, t(control_timestep), t(cur_pos),
            t(cur_quat), t(cur_vel), t(target_pos), t(target_rpy), t(target_vel))
        self.state = self.state.replace(integral_pos_e=integral_pos_e)
        return float(thrust), _np(target_euler), _np(pos_e)

    def _dslPIDAttitudeControl(self, control_timestep, thrust, cur_quat,
                               target_euler, target_rpy_rates):
        """Attitude loop only (DSLPIDControl._dslPIDAttitudeControl, :212-259).
        Updates last_rpy and the attitude integral; returns (4,) RPMs."""
        t = self._t
        rpm, cur_rpy, integral_rpy_e = _attitude_control(
            self.params, self.state.last_rpy, self.state.integral_rpy_e,
            t(control_timestep), t(thrust), t(cur_quat), t(target_euler),
            t(target_rpy_rates))
        self.state = self.state.replace(last_rpy=cur_rpy, integral_rpy_e=integral_rpy_e)
        return _np(rpm)

    def _one23DInterface(self, thrust):
        """1/2/4-dim desired thrust -> (4,) per-motor PWM
        (DSLPIDControl._one23DInterface, :263-287)."""
        return _np(one23d_interface(self.params, self._t(np.atleast_1d(thrust))))


class CTBRControl(BaseControl):
    """Reference control/CTBRControl.py: collective thrust + body rates."""

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X, g: float = G,
                 device=None):
        super().__init__(drone_model, g, device)
        self.params = ctbr_params(drone_model, g=g, device=self.device)

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3), target_rpy_rates=np.zeros(3)):
        self.control_counter += 1
        t = self._t
        out = ctbr_control(self.params, t(cur_pos), t(cur_quat), t(cur_vel),
                           t(target_pos), t(target_vel))
        thrust, p, q, r = _np(out)
        return thrust, p, q, r


class MRAC(BaseControl):
    """Reference control/MRAC.py: model-reference adaptive control shell."""

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X, g: float = G,
                 device=None):
        super().__init__(drone_model, g, device)
        self.g = g
        self.params = mrac_params(drone_model, g=g, device=self.device)
        self.reset()

    def reset(self):
        # Reference MRAC.reset only zeroes the counter (MRAC.py:106-107):
        # the adapted gains Kx/Kr persist across flights; Xm re-snaps to the
        # measured state on the next call via the `initialized` flag.
        super().reset()
        if not hasattr(self, "state"):
            self.state = mrac_reset(self.params)
        else:
            self.state = self.state.replace(
                initialized=torch.zeros_like(self.state.initialized))

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel, target_pos, target_rpy=np.zeros(3),
                       target_vel=np.zeros(3), target_rpy_rates=np.zeros(3)):
        self.control_counter += 1
        t = self._t
        rpm, self.state, pos_e, rpy_e = mrac_control(
            self.params, self.state, t(control_timestep), t(cur_pos), t(cur_quat),
            t(cur_vel), t(cur_ang_vel), t(target_pos), t(target_rpy), t(target_vel),
            t(target_rpy_rates))
        return _np(rpm), _np(pos_e), _np(rpy_e)

    def _compute_K(self, psi=0):
        """Linearized-model gain design (MRAC._compute_K, :56-104): pole
        placement at -1..-12 plus the Lyapunov solve. Sets the reference-named
        linear-algebra attributes and returns the initial (Kx, Kr)."""
        params = mrac_params(self.DRONE_MODEL, g=self.g, psi=float(psi), device=self.device)
        self.Am = _np(params.Am)
        self.Bm = _np(params.Bm)
        self.P = _np(params.P)
        self.Kr_ref_gain = _np(params.Kr_ref_gain)
        self.Gamma_x = np.eye(12) * float(params.gamma_x)
        self.Gamma_r = np.eye(4) * float(params.gamma_r)
        return _np(params.Kx0), _np(params.Kr0)
