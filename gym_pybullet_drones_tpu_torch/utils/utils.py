"""General utilities (reference gym_pybullet_drones/utils/utils.py:10-54)."""

import argparse
import time


def sync(i: int, start_time: float, timestep: float) -> None:
    """Wall-clock-pace the i-th simulation step (reference utils.py:10-29).

    Only meaningful for interactive/GUI runs; sleeps so that step i lands at
    `start_time + i * timestep` when the timestep is coarse (> 0.04 s — the
    same threshold the reference uses).
    """
    if timestep > 0.04 or i % (int(1 / (24 * timestep))) == 0:
        elapsed = time.time() - start_time
        if elapsed < (i * timestep):
            time.sleep(timestep * i - elapsed)


def str2bool(val) -> bool:
    """Argparse-friendly bool converter (reference utils.py:33-54)."""
    if isinstance(val, bool):
        return val
    if val.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if val.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("[ERROR] in str2bool(), a Boolean value is expected")
