from gym_pybullet_drones_tpu_torch.ops.velocity_soa import (
    SOA_KEYS,
    soa_consts,
    soa_from_state,
    soa_to_state,
    velocity_step_soa,
)
