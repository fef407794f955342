"""What the benchmark may load: no JAX and no JAX package anywhere under
``benchmark/`` (compared by whole top-level names), nothing of the port in
``benchmark/reference/``, and no file outside the benchmark named by it."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "gym_pybullet_drones_tpu"}
PORT = "gym_pybullet_drones_tpu_torch"


def _modules():
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if os.sep + "tests" + os.sep not in path:  # nothing the runs load reads bench.py
        with open(path) as fh:
            assert "bench" + ".py" not in fh.read()


@pytest.mark.parametrize("path", sorted(p for p in _modules() if os.sep + "reference" + os.sep in p),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert PORT not in tops
    assert tops <= {"torch", "numpy", "math", "benchmark"}, tops


def test_a_cpu_run_loads_no_jax():
    """A whole run of a cell on the CPU, in a fresh process, leaves no JAX
    module in ``sys.modules``."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "cell = harness.files_cell('velocity.vector_env', 'velocity_cf2x_e4096')\n"
        "res, _ = harness.run_cell(cell, 3, 0.2, 0, 'cpu', time.perf_counter(),\n"
        "    {'config': {'env': {'num_envs': 8}}, 'workload': {'check': {'stride': 1}}})\n"
        "print(json.dumps([res['correct'], harness.foreign_modules()]))\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"
