"""Time kernel K1 (the VelocityAviary rollout) over a range of batch sizes,
to compare two versions of the PyTorch port on one card.

    PYTHONPATH=<tree> python3 scripts/torch_k1_ab.py LABEL [--fmad | --commands]

Times the K1 of the ``gym_pybullet_drones_tpu_torch`` package found on the
path, so run it once per tree, in turns (A, B, B, A), in one run on one
card. The scaling line: E = 32, 4096, 16384 and 65536 envs from
``batch_reset`` with chip_smoke.py's formation actions, T = 4800 control
steps a launch, CUDA events (median of 5 launches after a warm-up). The
split: at E = 4096, the same launch with no substeps (the DSLPID pipeline
alone) and with one.

``--commands`` times K1 alone by command instead, at E = 4096 and 65536, T
= 4800: the turned, compass and hover commands of the benchmark's formation
traffic (``benchmark/traffic.FormationHeadings``, seed ``SEED``), one command
for all envs of a call, CUDA events (median of 5 launches after a warm-up).
Where the tree has K1's counting build (``velocity_rollout_counts``), also its
counts for one call of each command, as totals and per env and control step
(``replayed`` counts env-steps recomputed in warps of 32 envs).

``--fmad`` also builds K1 with FMA contraction (``-fmad=true``) and prints
its largest gap per column to the plain version at T = 8 and T = 240 (E =
4096): the test of whether the closed loop leaves room for contraction.

Prints one JSON line: the label, the card, nvidia-smi's name and power
limit, and ms per launch by E. Needs a CUDA card.
"""

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_VELOCITY,
    AviaryConfig,
    build_ctrl_params,
    build_params,
)
from gym_pybullet_drones_tpu_torch.ops import _build
from gym_pybullet_drones_tpu_torch.ops import velocity_rollout as vr
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import SOA_KEYS, soa_consts, soa_from_state
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset

SIZES = (32, 4096, 16384, 65536)
T_TIME = 4800
COMMAND_SIZES = (4096, 65536)
COMMANDS = {"turned": "rotated", "compass": "compass", "hover": "hover"}
SEED = 2_718_281_828


def formation_actions(n, device):
    """Unit compass headings at a quarter of the speed limit (bench.py:47-52)."""
    angles = np.arange(n, dtype=np.float64) * (2.0 * np.pi / n)
    cols = dict(ax=np.cos(angles), ay=np.sin(angles), az=np.zeros(n), amag=np.full(n, 0.25))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in cols.items()}


def event_ms(fn, repeats=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def command_times(cfg, args, params, dev):
    """ms a K1 call by E and command, and the counting build's counts where
    the tree has one."""
    from benchmark.traffic import FormationHeadings

    counted = getattr(vr, "velocity_rollout_counts", None)
    ms, counts = {}, {}
    for E in COMMAND_SIZES:
        soa = soa_from_state(batch_reset(cfg, params, E, device=dev))
        ms[E], counts[E] = {}, {}
        for name, kind in COMMANDS.items():
            act = FormationHeadings({"speed_fraction": 0.25, "commands": [kind]}, E, SEED,
                                    dev).action(0)
            ms[E][name] = event_ms(lambda: vr.velocity_rollout_cuda(*args, T_TIME, soa, act))
            if counted is not None:
                n = counted(*args, T_TIME, soa, act)
                counts[E][name] = {"total": n, "per_env_step": {
                    k: v / (E * T_TIME) for k, v in n.items()}}
        print(f"E={E}: ms {json.dumps(ms[E])}", flush=True)
        if counted is not None:
            print(f"E={E}: counts {json.dumps(counts[E])}", flush=True)
    return ms, counts


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    p, cp = build_params(cfg, "cpu"), build_ctrl_params(cfg, "cpu")
    sl = 0.03 * float(p.max_speed_kmh) * (1000.0 / 3600.0)
    args = (soa_consts(cp, p), cfg.ctrl_timestep, cfg.pyb_timestep, cfg.steps_per_ctrl, sl)
    params = p.to(dev)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else "", "device":
           torch.cuda.get_device_name(0), "smi": smi, "T": T_TIME, "ms": {}}
    if "--commands" in sys.argv:
        out["ms"], counts = command_times(cfg, args, params, dev)
        if counts[COMMAND_SIZES[0]]:
            out["counts"] = counts
        print(json.dumps(out))
        return
    cases = {}
    for E in SIZES:
        soa, act = soa_from_state(batch_reset(cfg, params, E, device=dev)), formation_actions(E, dev)
        cases[E] = (soa, act)
        out["ms"][E] = event_ms(lambda: vr.velocity_rollout_cuda(*args, T_TIME, soa, act))
        print(f"E={E}: {out['ms'][E]:.4f} ms", flush=True)
    soa, act = cases[4096]
    split = {}
    for n_sub in (0, 1):
        sub_args = args[:3] + (n_sub,) + args[4:]
        split[f"{n_sub} substeps"] = event_ms(
            lambda: vr.velocity_rollout_cuda(*sub_args, T_TIME, soa, act))
    out["split at E=4096"] = split
    print(f"split at E=4096: {json.dumps(split)}", flush=True)
    if "--fmad" in sys.argv:
        flags = _build.NVCC_FLAGS[vr.KERNEL]
        _build.NVCC_FLAGS[vr.KERNEL] = tuple("-fmad=true" if f == "-fmad=false" else f
                                             for f in flags)
        vr._library.cache_clear()
        gaps = {}
        for T in (8, 240):
            got = vr.velocity_rollout_cuda(*args, T, soa, act)
            want = vr.velocity_rollout_plain(*args, T, soa, act)
            gaps[T] = {k: float((got[k] - want[k]).abs().max()) for k in SOA_KEYS}
            print(f"fmad=true T={T}: largest gap {max(gaps[T].values()):.3g} "
                  f"({max(gaps[T], key=gaps[T].get)})", flush=True)
        out["fmad=true max |kernel - plain|"] = gaps
        _build.NVCC_FLAGS[vr.KERNEL] = flags
        vr._library.cache_clear()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
