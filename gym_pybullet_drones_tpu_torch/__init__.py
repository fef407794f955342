"""PyTorch and CUDA port of gym_pybullet_drones_tpu (slice 1: the VelocityAviary
main path; slice 2: the coupled swarm's SoA, sorted and binned backends;
slice 3: the sequential-impulse contact solver, ``contact_mode="impulse"``;
slice 4: PPO and the BC warm start, ``rl/``, with domain-randomized params,
``core.params.randomize_params``, and the checkpoints read by
``convert.load_flax_msgpack``; slice 6: the pixel path, the onboard camera
``render/`` with its kernel K7, RGB observations and ``CnnActorCritic``;
slice 7: the controllers ``control/`` (CTBR, MRAC, Mellinger, the mission
commander and the stateful shells of ``control/compat.py``), ``utils/``, and
the Gymnasium shells ``compat/gym.py`` and ``compat/vector.py``; slice 8:
the firmware-in-the-loop envs ``envs/cf.py`` and ``envs/beta.py`` over the
native ``bridges/`` (built with g++ at first use), ``runtime/checkpoint.py``,
``runtime/profiling.py`` and ``runtime/mesh.py`` over ``torch.distributed``
with the sharded swarms).

The JAX package ``gym_pybullet_drones_tpu`` stays the reference; this package
never imports it or JAX. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. With gymnasium installed, importing the package
registers the shells under ids of their own, ``cuda/ctrl-aviary-v0``,
``cuda/velocity-aviary-v0``, ``cuda/hover-aviary-v0`` and
``cuda/multihover-aviary-v0``, each with a ``vector_entry_point``
(``gymnasium.make_vec`` builds a ``compat.vector.VecAviary``); the JAX
package's ids stay its own.
"""

# envs.spec first: control.dsl_pid imports it, and envs/__init__ imports
# envs.base, which imports control.dsl_pid again.
from gym_pybullet_drones_tpu_torch.envs.spec import (
    ActionType,
    DroneModel,
    ImageType,
    ObservationType,
    Physics,
)
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

# Gymnasium registration under the port's own ids (the JAX package registers
# the reference ids, gym_pybullet_drones_tpu/__init__.py:27-54; registering
# one again would override it).
try:
    from gymnasium.envs.registration import register as _register

    for _name, _cls, _vec in (("ctrl", "CtrlAviary", "_vec_ctrl"),
                              ("velocity", "VelocityAviary", "_vec_velocity"),
                              ("hover", "HoverAviary", "_vec_hover"),
                              ("multihover", "MultiHoverAviary", "_vec_multihover")):
        _register(
            id=f"cuda/{_name}-aviary-v0",
            entry_point=f"gym_pybullet_drones_tpu_torch.compat.gym:{_cls}",
            vector_entry_point=f"gym_pybullet_drones_tpu_torch.compat.vector:{_vec}",
        )
except Exception:  # pragma: no cover - gymnasium absent or double registration
    pass
