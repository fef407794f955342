"""Run one cell of the benchmark once on the CUDA card and print its result.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up (imports, the port's kernel build, the
cell's warm-up) is timed from the start of this script; then the window
runs for ``--seconds``; with ``--trace 1`` a short part after it runs under
``torch.profiler`` and the line carries the cell's per-layer metrics instead
of its end-to-end ones. The check against the plain reference runs last.
The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits with 2.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Build caches inside the checkout, at fixed paths; no JAX through
    libraries that would load it themselves."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path[0] != ROOT:
        sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, run = harness.run_cell(cell, args.seed, args.seconds, args.trace, "cuda", STARTED)
    bad = harness.foreign_modules()
    if bad:
        print(f"run.py: modules that the benchmark must not load are loaded: {bad}",
              file=sys.stderr)
        return 3
    print("info " + json.dumps(dict(run.info, window_s=run.window_s)), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
