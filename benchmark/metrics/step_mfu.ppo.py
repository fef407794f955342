"""step_mfu.ppo: the share of the card's float32 peak that the window's PPO
work would need, in %: the operations an env-step of a train step needs
(the env step with auto-reset, the policy's forward passes in collect, and
the update's forward, backward and Adam steps; ``opcount.ppo_ops``, counted
on the frozen reference), times the env-steps completed, over window
seconds x 67 TFLOP/s."""

from benchmark import opcount, peaks


def read(run):
    if "env_steps" not in run.work or not run.window_s:
        return None
    per = opcount.ppo_ops(run.config)["per_env_step"]
    return 100.0 * per * run.work["env_steps"] / (run.window_s * peaks.FP32_FLOPS)
