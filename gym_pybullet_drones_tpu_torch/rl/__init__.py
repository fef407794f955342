from gym_pybullet_drones_tpu_torch.rl.ppo import (
    ActorCritic,
    CnnActorCritic,
    PPOConfig,
    PPORunnerState,
    evaluate_policy,
    make_ppo_train_loop,
    make_ppo_train_step,
    ppo_init,
)
