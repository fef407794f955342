from gym_pybullet_drones_tpu_torch.envs.spec import (
    ActionType,
    DroneModel,
    ImageType,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_CTRL,
    TASK_HOVER,
    TASK_MULTIHOVER,
    TASK_VELOCITY,
    Aviary,
    AviaryConfig,
    AviaryState,
)


# The firmware-in-the-loop envs build their native bridges with g++ and need
# gymnasium: they load on first access.
def __getattr__(name):
    if name == "CFAviary":
        from gym_pybullet_drones_tpu_torch.envs.cf import CFAviary
        return CFAviary
    if name == "BetaAviary":
        from gym_pybullet_drones_tpu_torch.envs.beta import BetaAviary
        return BetaAviary
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
