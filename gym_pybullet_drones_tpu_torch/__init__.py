"""PyTorch and CUDA port of gym_pybullet_drones_tpu (slice 1: the VelocityAviary
main path; slice 2: the coupled swarm's SoA backend).

The JAX package ``gym_pybullet_drones_tpu`` stays the reference; this package
never imports it or JAX. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. Gymnasium registration comes with a later slice,
under ids of its own.
"""

from gym_pybullet_drones_tpu_torch.control.dsl_pid import (
    DSLPIDParams,
    DSLPIDState,
    dsl_pid_control,
    dsl_pid_params,
    dsl_pid_reset,
)
from gym_pybullet_drones_tpu_torch.core.collisions import (
    ObstacleSet,
    base_obstacles,
    rl_obstacles,
)
from gym_pybullet_drones_tpu_torch.core.dynamics import KinState, init_kin_state, step_physics
from gym_pybullet_drones_tpu_torch.core.params import DroneParams, drone_params, from_urdf
from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_CTRL,
    TASK_HOVER,
    TASK_MULTIHOVER,
    TASK_VELOCITY,
    Aviary,
    AviaryConfig,
    AviaryState,
)
from gym_pybullet_drones_tpu_torch.envs.spec import (
    ActionType,
    DroneModel,
    ImageType,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.ops.velocity_rollout import make_velocity_rollout
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step
from gym_pybullet_drones_tpu_torch.runtime.swarm import (
    make_big_swarm_physics,
    make_swarm_physics,
    select_swarm_backend,
)

__all__ = [
    "ActionType", "Aviary", "AviaryConfig", "AviaryState", "DSLPIDParams", "DSLPIDState",
    "DroneModel", "DroneParams", "ImageType", "KinState", "ObservationType", "ObstacleSet",
    "Physics", "TASK_CTRL", "TASK_HOVER", "TASK_MULTIHOVER", "TASK_VELOCITY",
    "base_obstacles", "batch_reset", "drone_params", "dsl_pid_control", "dsl_pid_params",
    "dsl_pid_reset", "from_urdf", "init_kin_state", "make_batched_step",
    "make_big_swarm_physics", "make_swarm_physics", "make_velocity_rollout", "rl_obstacles",
    "select_swarm_backend", "step_physics",
]
