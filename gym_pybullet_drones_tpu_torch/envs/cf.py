"""CFAviary: the Crazyflie firmware in the loop (port of the JAX package's
``envs/cf.py``, the reference's envs/CFAviary.py).

The native firmware subset (``bridges/cffirmware``, built with g++ at first
use) ticks at 500 Hz (Mellinger) or 1000 Hz (PID) against the env step on
the device. The loop (``runtime/firmware.CFFirmware``) imports no gymnasium;
this class adds the Gymnasium shell (``compat/gym.BaseAviaryEnv``): spaces,
the reference's attribute surface, ``device=`` (``None``: the CUDA card).
"""

import numpy as np
from gymnasium import spaces

from gym_pybullet_drones_tpu_torch.compat.gym import BaseAviaryEnv
from gym_pybullet_drones_tpu_torch.runtime.firmware import CFFirmware


class CFAviary(CFFirmware, BaseAviaryEnv):
    """One Crazyflie flown by its firmware: ``reset()``, then high-level
    commands (``sendTakeoffCmd``, ``sendGotoCmd``, ``sendFullStateCmd``, ...)
    and ``step(i)`` once a control step (CFAviary.py:187-261). Reference
    quirks kept: the swapped LPF cutoffs, the ``_initalize_cffirmware``
    spelling."""

    def _action_space(self):
        return spaces.Box(low=0.0, high=self.MAX_RPM, shape=(1, 4), dtype=np.float32)

    def _observation_space(self):
        return self._state_obs_bounds()
