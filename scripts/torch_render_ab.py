"""Time the camera kernel K7 on chip_smoke.py phase 10b's views, to compare
two versions of the PyTorch port on one card.

    PYTHONPATH=<tree> python3 scripts/torch_render_ab.py LABEL [CASE ...]

Times the K7 of the ``gym_pybullet_drones_tpu_torch`` package found on the
path, so run it once per tree, in turns (A, B, B, A), in one run on one card.
The views, the timers and the comparison are this checkout's
``chip_smoke.py`` (``render_case``, ``per_pass_ms``, ``device_ms``,
``render_gaps``), loaded from its file, so every tree is timed on the same
worlds as phase 10b. CASE is one of a1 (E = 64 x 1 drone, "rl"), a2 (32 x 2,
mesh proxy), a3 (one 12-drone world, X-frame), a4 (16 x 1, "base"), a5
(4096 x 1, "rl"); all by default. For each case: K7 against the tree's plain
version (in chunks of 64 worlds: the plain version's intermediates for 4096
cameras do not fit on the card), pixels whose seg differs and the largest
rgba and depth gaps, and K7's ms with CUDA events (median of 5 runs of 20
calls after a warm-up) and on the device (torch.profiler, 10 calls). Prints
one JSON line: the label, the card, nvidia-smi's name and power limit, and
the cases. Needs a CUDA card.
"""

import importlib.util
import json
import os
import sys

import torch

from gym_pybullet_drones_tpu_torch.ops.render_views import render_views_cuda
from gym_pybullet_drones_tpu_torch.render import camera

_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# name -> (worlds, drones, seed, camera config, placement): chip_smoke.py phase 10b (a)
CASES = {"a1": (64, 1, 1, {}, "landmarks"), "a2": (32, 2, 2, {}, "landmarks"),
         "a3": (1, 12, 3, {}, "line"), "a4": (16, 1, 4, dict(scene="base"), "base"),
         "a5": (4096, 1, 5, {}, "landmarks")}


def main():
    label, names = sys.argv[1], sys.argv[2:] or list(CASES)
    dev = torch.device("cuda")
    out = {}
    for name in names:
        B, N, seed, extra, spread = CASES[name]
        cfg = camera.CameraConfig(**extra)
        pos, quat, arm = cs.render_case(dev, B, N, seed, spread)
        cam = list(range(N))
        kernel = lambda: render_views_cuda(pos, quat, arm, cam, cfg)
        plain = lambda sl: camera.render_drone_views_plain(pos[sl], quat[sl], arm[sl], cam, cfg)
        got = kernel()
        torch.cuda.synchronize()
        g = cs.render_gaps(got, plain, B)
        out[name] = dict(pixels=g["pixels"], seg_differs=g["seg_differs"],
                         rgba_max=g["rgba_max"], dep_max=g["dep_max"],
                         bit_equal=g["seg_differs"] == 0 and g["rgba_max"] == 0
                         and g["dep_max"] == 0.0,
                         ms=cs.per_pass_ms(kernel, 20, 5), device_ms=cs.device_ms(kernel, 10))
        print(f"{label} {name}: {json.dumps(out[name])}", file=sys.stderr, flush=True)
    print(json.dumps(dict(label=label, device=torch.cuda.get_device_name(0),
                          smi=cs.nvidia_smi_line(), cases=out)))


if __name__ == "__main__":
    main()
