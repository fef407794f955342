"""ppo_env_steps_per_s: envs x n_steps x whole train steps completed, over
the time from the first step's start to the last step's end, collect and
update included (host clock; each step ends at a synchronize)."""


def read(run):
    if "env_steps" not in run.work or not run.window_s:
        return None
    return run.work["env_steps"] / run.window_s
