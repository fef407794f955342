"""Check that the cone cull of the masked wake passes drops no pair whose
term is not zero (PyTorch port; needs a CUDA card).

The cone cull of ``ops/spatial.py`` reads beta = c2 dz + c3 -> 0 as an ever
narrower Gaussian. The JAX package's pair term puts beta^2 = 1 where float32
beta is exactly 0 (dz = 0.6875 m for the CF2X), a Gaussian 1 m wide that a
culled tile pair can hold; the port's term is 0 there, so the cull is exact.
This script runs the sorted z backend with contact for three control steps
on chip_smoke.py's fleet of co-planar contact pairs beside unique-z towers
(whose levels drift through that dz), holds every K6 launch against the
unmasked plain pass on the same inputs, prints each term that a dead
sub-slice held, and exits non-zero if there is any.

    python3 scripts/torch_cone_guard.py
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gym_pybullet_drones_tpu_torch.envs.base import (  # noqa: E402
    TASK_VELOCITY,
    AviaryConfig,
    build_params,
)
from gym_pybullet_drones_tpu_torch.ops import _pairs, interact_pairs  # noqa: E402
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import wake_terms  # noqa: E402
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import interact_plain  # noqa: E402
from gym_pybullet_drones_tpu_torch.runtime.swarm import make_swarm_physics  # noqa: E402

N = 16384


def main():
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line())
    cfg = AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    params_cpu = build_params(cfg, "cpu")
    params = params_cpu.to(dev)
    kin = cs.fleet_kin(*cs.contact_fleet(N), dev)
    rpm = [torch.full((N,), float(params_cpu.hover_rpm), device=dev) for _ in range(4)]
    launch_masked, seen = _pairs.launch_masked, [0, 0]

    def checking(name, tgt, src, words, grid, c, n_out, *args):
        out = launch_masked(name, tgt, src, words, grid, c, n_out, *args)
        if name != interact_pairs.MASKED_NAME:
            return out
        k = seen[0]
        seen[0] += 1
        want = interact_plain(tgt, c)
        share = (out[0] - want[0]).abs() / (cs.WAKE_ATOL + cs.WAKE_RTOL * want[0].abs())
        wake_live, _ = _pairs.slice_gates(words, grid, tgt.shape[1], src.shape[1])
        for i in (share > 1).nonzero()[:, 0].tolist():
            terms = wake_terms(tgt[:3, i:i + 1, None], src[:3, None, :], c)[0]
            gate = _pairs.pair_gate(wake_live, grid, i, i + 1)[0]
            lost = ((terms != 0) & ~gate).nonzero()[:, 0].tolist()
            print(f"K6 launch {k}, target slot {i}: kernel {float(out[0, i])!r}, unmasked plain "
                  f"{float(want[0, i])!r} ({float(share[i]):.3g} of the wake's limit); "
                  f"{len(lost)} non-zero terms in dead sub-slices")
            for j in lost:
                dz = src[2, j] - tgt[2, i]
                dxy = torch.hypot(src[0, j] - tgt[0, i], src[1, j] - tgt[1, i])
                print(f"    source slot {j}: term {float(terms[j])!r}, dz {float(dz)!r}, float32 "
                      f"beta {float(c.c2 * dz + c.c3)!r}, lateral distance {float(dxy)!r}")
            seen[1] += len(lost)
        return out

    _pairs.launch_masked = checking
    try:
        init, step, _ = make_swarm_physics(params, 1 / 240, 5, collisions=True, backend="soa",
                                           sorted=True, order="z")
        s = init(kin)
        for _ in range(3):
            s = step(s, rpm)
        torch.cuda.synchronize()
    finally:
        _pairs.launch_masked = launch_masked
    print(f"{seen[0]} K6 launches held against the unmasked plain pass; {seen[1]} dropped terms")
    return 1 if seen[1] else 0


if __name__ == "__main__":
    sys.exit(main())
