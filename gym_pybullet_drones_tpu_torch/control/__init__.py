from gym_pybullet_drones_tpu_torch.control.dsl_pid import (
    DSLPIDParams,
    DSLPIDState,
    dsl_pid_control,
    dsl_pid_params,
    dsl_pid_reset,
)
from gym_pybullet_drones_tpu_torch.control.ctbr import CTBRParams, ctbr_control, ctbr_params
from gym_pybullet_drones_tpu_torch.control.mrac import (
    MRACParams,
    MRACState,
    mrac_control,
    mrac_params,
    mrac_reset,
)
from gym_pybullet_drones_tpu_torch.control.mellinger import (
    MellingerParams,
    MellingerState,
    mellinger_control,
    mellinger_params,
    mellinger_reset,
    mellinger_rpm,
)
from gym_pybullet_drones_tpu_torch.control.commander import (
    MissionLegs,
    mission_finished,
    mission_setpoint,
    plan_mission,
)
from gym_pybullet_drones_tpu_torch.control.compat import (
    BaseControl,
    CTBRControl,
    DSLPIDControl,
    MRAC,
)
