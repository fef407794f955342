from gym_pybullet_drones_tpu_torch.runtime.rollout import (
    batch_reset,
    make_batched_step,
    rollout,
)
from gym_pybullet_drones_tpu_torch.runtime.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from gym_pybullet_drones_tpu_torch.runtime.profiling import (
    RealtimeMonitor,
    measure_throughput,
    trace,
)
from gym_pybullet_drones_tpu_torch.runtime.swarm import (
    make_big_swarm_physics,
    make_sharded_swarm_physics,
    make_swarm_physics,
    select_swarm_backend,
)
