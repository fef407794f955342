"""Enumerations shared across the suite.

Mirrors the reference's public enum surface (gym_pybullet_drones/utils/enums.py:3-48)
so user code can switch imports without edits.
"""

from enum import Enum


class DroneModel(Enum):
    """Drone models (numeric parameter sets embedded in core/params.py)."""

    CF2X = "cf2x"  # Bitcraze Crazyflie 2.x, X configuration
    CF2P = "cf2p"  # Bitcraze Crazyflie 2.x, + configuration
    RACE = "racer"  # 5-inch racer, X configuration


class Physics(Enum):
    """Physics implementations.

    PYB* modes replicate the force-level PyBullet pipeline (forces applied at prop
    link offsets, semi-implicit Euler, ground contact); DYN is the explicit
    closed-form dynamics model (reference BaseAviary._dynamics, BaseAviary.py:815).
    """

    PYB = "pyb"
    DYN = "dyn"
    PYB_GND = "pyb_gnd"
    PYB_DRAG = "pyb_drag"
    PYB_DW = "pyb_dw"
    PYB_GND_DRAG_DW = "pyb_gnd_drag_dw"


class ImageType(Enum):
    """Camera capture image types."""

    RGB = 0
    DEP = 1
    SEG = 2
    BW = 3


class ActionType(Enum):
    """Action types (reference utils/enums.py:35-41)."""

    RPM = "rpm"
    PID = "pid"
    VEL = "vel"
    ONE_D_RPM = "one_d_rpm"
    ONE_D_PID = "one_d_pid"


class ObservationType(Enum):
    """Observation types (reference utils/enums.py:45-48)."""

    KIN = "kin"
    RGB = "rgb"
