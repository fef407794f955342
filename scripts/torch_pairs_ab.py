"""Time the pair kernels K2, K4 and K5 per pass on the dense swarm's fleets,
to compare two versions of the PyTorch port on one card.

    PYTHONPATH=<tree> python3 scripts/torch_pairs_ab.py LABEL [KERNEL ...]

KERNEL is K2, K4 or K5 (default: all three).

Times the kernels of the ``gym_pybullet_drones_tpu_torch`` package found on
the path, so run it once per tree, in turns (A, B, B, A), in one run on one
card. Per pass, square, unsorted and sorted by z (the culls on), on the
fleets of chip_smoke.py phase 8:

* tests/test_soa.py's cloud scaled to N = 4096 and 16384 (an overlapping
  pair every 64 drones);
* scripts/collide_bench.py's lattice (0.5 m pitch) at N = 4096 and 16384;
* that 16384-drone lattice after 48 control steps of the ``"soa"`` swarm step
  with collisions (hover RPM), the fleet phase 8's profiler sees. The steps
  run on the tree's own kernels, so the two trees' fleets differ by the
  float32 order of their pair sums.

Each time is given twice: CUDA events around 20 passes (median of 5 runs,
after a warm-up), which at N = 4096 time the host's launch path, and the
device time of the pass's kernels and memsets under torch.profiler over 20
passes.
Prints one JSON line: the label, the card, nvidia-smi's name and power limit,
and ms per pass by fleet, order and kernel. Needs a CUDA card.
"""

import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state
from gym_pybullet_drones_tpu_torch.envs.base import TASK_VELOCITY, AviaryConfig, build_params
from gym_pybullet_drones_tpu_torch.ops import _pairs
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import collide_cuda
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import downwash_cuda
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import interact_cuda
from gym_pybullet_drones_tpu_torch.ops.swarm_soa import (
    make_swarm_step_soa,
    swarm_soa_from_kin,
    swarm_soa_to_kin,
)


def cloud(n, dev, seed=11):
    """tests/test_soa.py's cloud (as chip_smoke.py's pair_cloud builds it)."""
    rng = np.random.RandomState(seed)
    scale = (n / 1024) ** (1 / 3)
    pos = rng.uniform(-1, 1, (n, 3)) * np.array([4, 4, 1.5]) * scale + [0, 0, 2.0]
    pos[1::64] = pos[0::64] + [0.08, 0.0, 0.05]
    vel = rng.uniform(-0.5, 0.5, (n, 3))
    return torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), dtype=torch.float32, device=dev)


def lattice(n, pitch=0.5, seed=0):
    """scripts/collide_bench.py:34-40 (as chip_smoke.py builds it)."""
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1 / 3))) + 1
    g = np.stack(np.meshgrid(*[np.arange(side) * pitch] * 3), -1).reshape(-1, 3)[:n]
    return (g + rng.uniform(-0.2 * pitch, 0.2 * pitch, g.shape) + [0, 0, 1.0]).astype(np.float32)


def fleets(dev, params):
    """(name, (6, N) columns) of each fleet."""
    identity = lambda n: np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    for n in (4096, 16384):
        yield f"cloud {n}", cloud(n, dev)
    for n in (4096, 16384):
        kin = init_kin_state(lattice(n), identity(n), device=dev)
        yield f"lattice {n}", torch.cat([kin.pos.T, kin.vel.T]).contiguous()
    n = 16384
    kin = init_kin_state(lattice(n), identity(n), device=dev)
    step = make_swarm_step_soa(params, 1 / 240, 5, collisions=True)
    rpm = [torch.full((n,), float(params.hover_rpm), device=dev) for _ in range(4)]
    state = swarm_soa_from_kin(kin)
    for _ in range(48):
        state = step(state, rpm)
    kin = swarm_soa_to_kin(state, kin)
    yield f"lattice {n} after 48 steps with contact", torch.cat([kin.pos.T, kin.vel.T]).contiguous()


def event_ms(fn, reps=20, repeats=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def device_ms(fn, reps=20):
    """The device time of one call under torch.profiler over ``reps`` calls:
    for each kernel or memset name in the chrome trace, its mean duration
    times the launches a call makes of it (its count over ``reps``,
    rounded), summed, so that an event the trace loses or gains does not
    move the sum by a launch; None if none of three traces holds a launch a
    call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        durs = collections.defaultdict(list)
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memset"):
                durs[e["name"]].append(e["dur"])
        per_call = {name: round(len(d) / reps) for name, d in durs.items()}
        if any(per_call.values()):
            return sum(statistics.fmean(d) * per_call[name] for name, d in durs.items()) / 1e3
    return None


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    params = build_params(AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48), dev)
    c = _pairs.pair_consts(params)
    kernels = sys.argv[2:] or ["K2", "K4", "K5"]
    out = {}
    for name, cols in fleets(dev, params):
        out[name] = {}
        for sort in (False, True):
            t = _pairs.sort_by_z(cols)[0] if sort else cols
            t3 = t[:3].contiguous()
            passes = {"K2": lambda: downwash_cuda(t3, t3, c, cull=sort, square=True),
                      "K4": lambda: collide_cuda(t, t, c, cull=sort),
                      "K5": lambda: interact_cuda(t, c, cull=sort)}
            out[name]["z-sorted" if sort else "unsorted"] = {
                k: {"events": event_ms(passes[k]), "device": device_ms(passes[k])}
                for k in kernels}
    print(json.dumps({"label": sys.argv[1] if len(sys.argv) > 1 else "",
                      "device": torch.cuda.get_device_name(0), "smi": smi, "ms": out}))


if __name__ == "__main__":
    main()
