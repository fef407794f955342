from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step
from gym_pybullet_drones_tpu_torch.runtime.swarm import (
    make_big_swarm_physics,
    make_swarm_physics,
    select_swarm_backend,
)
