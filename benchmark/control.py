"""The readings that the check's limits are set from, for one cell.

    python3 benchmark/control.py --workload NAME [--config CONFIG] --kind KIND
        --seeds S [S ...] [--seconds 2] [--override JSON]

``KIND``: ``program`` (the lower readings: the program's own runs),
``program_tf32`` (the program with its TF32 path switched on) or
``reference_tf32`` (the reference computed in TF32 in the program's place):
the controls, which the check has to refuse. ``NAME`` is a cell of
``BENCHMARK.json``; with ``--config``, the cell of ``workloads/NAME.json``
under ``configs/CONFIG.json``, which ``BENCHMARK.json`` need not name. One
process, one JSON line a seed. Runs on the CUDA card, or with ``--device cpu`` at the sizes of
``--override`` (the tests).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--config")
    p.add_argument("--kind", required=True, choices=("program", "program_tf32",
                                                       "reference_tf32"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default="{}")
    args = p.parse_args(argv)
    if sys.path[0] != ROOT:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    cell = (harness.files_cell(args.workload, args.config) if args.config
            else harness.load_cell(args.workload))
    for seed in args.seeds:
        t0 = time.perf_counter()
        values, run = harness.readings(cell, seed, args.seconds, args.device, args.kind,
                                       json.loads(args.override))
        print(json.dumps(dict(workload=args.workload, kind=args.kind, seed=seed,
                              readings=values, info=run.info,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
