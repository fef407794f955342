"""drone_steps_per_s: drones times control steps completed in the window,
over the whole window (host clock, the window ends in a synchronize)."""


def read(run):
    if "drone_steps" not in run.work or not run.window_s:
        return None
    return run.work["drone_steps"] / run.window_s
