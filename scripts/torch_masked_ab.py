"""Time the masked pair kernels K3 and K6 per pass on the swarm's masked
fleets, to compare two versions of the PyTorch port on one card.

    PYTHONPATH=<tree> python3 scripts/torch_masked_ab.py LABEL

Times the kernels of the ``gym_pybullet_drones_tpu_torch`` package found on
the path, so run it once per tree, in turns (A, B, B, A), in one run on
one card. Per pass with CUDA events (median of 5 runs of 20 passes after a
warm-up), compacted and dense masked grid, on the fleets of chip_smoke.py
phase 8b:

* scripts/collide_bench.py's lattice at N = 16384, 2.5 m pitch, and
  N = 65536, 4 m pitch, in their binned layouts (cell blocks as tiles, the
  list at the ring cap, the valid column passed where the kernel takes it);
* the sorted loop's pass: the 16384-drone lattice sorted by z, 256 x 256
  tiles, the list at the full row.

Prints one JSON line: the label, the card, nvidia-smi's name and power
limit, and ms per pass by fleet, kernel and grid. Needs a CUDA card.
"""

import inspect
import json
import math
import statistics
import subprocess
import sys

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state
from gym_pybullet_drones_tpu_torch.envs.base import TASK_VELOCITY, AviaryConfig, build_params
from gym_pybullet_drones_tpu_torch.ops import _pairs, spatial
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import downwash_masked_cuda
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import interact_masked_cuda
from gym_pybullet_drones_tpu_torch.ops.swarm_binned import binned_geometry, make_binned_swarm


def lattice(n, pitch, seed=0):
    """scripts/collide_bench.py:34-40 (as chip_smoke.py builds it)."""
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1 / 3))) + 1
    g = np.stack(np.meshgrid(*[np.arange(side) * pitch] * 3), -1).reshape(-1, 3)[:n]
    return (g + rng.uniform(-0.2 * pitch, 0.2 * pitch, g.shape) + [0, 0, 1.0]).astype(np.float32)


def per_pass_ms(fn, reps=20, repeats=5):
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


def fleets(dev, params):
    """(name, (6, N) columns, valid or None, tile, list cap) of each fleet."""
    identity = lambda n: np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    for n, pitch in ((16384, 2.5), (65536, 4.0)):
        pos = lattice(n, pitch)
        cell, nx, ny, cap = binned_geometry(pos)
        kin = init_kin_state(pos, identity(n), device=dev)
        s = make_binned_swarm(params, 1 / 240, 5, cell_size=cell, nx=nx, ny=ny, cap=cap,
                              device=dev)[0](kin)
        cols = torch.stack([s[k] for k in ("px", "py", "pz", "vx", "vy", "vz")])
        ring = 2 * int(math.ceil(10.0 / cell)) + 1
        yield f"binned {n}", cols, s["valid"], cap, min(nx * ny, 2 * ring * ring)
        if n == 16384:
            cols = torch.cat([kin.pos.T, kin.vel.T]).contiguous()
            yield f"sorted z {n}", _pairs.sort_by_z(cols)[0], None, 256, n // 256


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    params = build_params(AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48), dev)
    c = _pairs.pair_consts(params)
    out = {}
    for name, cols, valid, tile, nbr in fleets(dev, params):
        out[name] = {}
        n_tiles = cols.shape[1] // tile
        sub = spatial.subtile_count(tile)
        for kname, kernel, rows in (("K3", downwash_masked_cuda, 3), ("K6", interact_masked_cuda, 6)):
            t = cols[:rows].contiguous()
            words = spatial.subtile_packed_mask(
                t[0], t[1], t[2], tile, tile, min_dist=c.min_dist if rows == 6 else None,
                params=params, valid=valid, sub=sub)
            lists, _ = spatial.compact_live_tiles(words, n_tiles, n_tiles, nbr)
            dense = _pairs.TileGrid(tile, tile, sub, n_tiles, False)
            compact = _pairs.TileGrid(tile, tile, sub, nbr, True)
            extra = (valid,) if "valid" in inspect.signature(kernel).parameters else ()
            out[name][kname] = {
                "compact": per_pass_ms(lambda: kernel(t, t, lists, compact, c, *extra)),
                "dense": per_pass_ms(lambda: kernel(t, t, words, dense, c, *extra))}
    print(json.dumps({"label": sys.argv[1] if len(sys.argv) > 1 else "",
                      "device": torch.cuda.get_device_name(0), "smi": smi, "ms": out}))


if __name__ == "__main__":
    main()
