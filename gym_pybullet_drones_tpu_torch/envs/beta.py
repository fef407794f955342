"""BetaAviary: a Betaflight SITL in the loop (port of the JAX package's
``envs/beta.py``, the reference's envs/BetaAviary.py).

The packet exchange (``runtime/firmware.BetaSITL``, over the C++ UDP bridge
``bridges/betaflight`` built with g++ at first use) imports no gymnasium;
this class adds the Gymnasium shell (``compat/gym.BaseAviaryEnv``). The SITL
is an external binary (``sitl_paths``) or ``bridges.betaflight.MockSITL``
instances on the same ports of ``udp_ip``.
"""

import numpy as np
from gymnasium import spaces

from gym_pybullet_drones_tpu_torch.compat.gym import BaseAviaryEnv
from gym_pybullet_drones_tpu_torch.runtime.firmware import BetaSITL


class BetaAviary(BetaSITL, BaseAviaryEnv):
    """Drones flown by Betaflight in rate mode: ``step(action, i)`` takes
    (N, 4) CTBR commands [thrust, p, q, r], applied after TRAJ_TIME; the
    SITL's PWM drives the next sim step (the stale one on a missed packet)."""

    def _action_space(self):
        """The CTBR action box; the reference reuses the raw-RPM bounds
        (BetaAviary.py:200-204)."""
        n = self.NUM_DRONES
        return spaces.Box(low=np.zeros((n, 4), dtype=np.float32),
                          high=np.full((n, 4), self.MAX_RPM, dtype=np.float32),
                          dtype=np.float32)

    def _observation_space(self):
        return self._state_obs_bounds()
