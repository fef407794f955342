from gym_pybullet_drones_tpu_torch.compat.gym import (
    BaseAviaryEnv,
    CtrlAviary,
    HoverAviary,
    MultiHoverAviary,
    VelocityAviary,
)
