"""The port's package surface against the JAX package's: each subpackage
exports the JAX one's public names, every file of the JAX package has its
counterpart in the port, every submodule imports cleanly in a fresh
interpreter, and the port never imports JAX or the JAX package."""

import ast
import importlib
import json
import os
import pkgutil
import subprocess
import sys
import types

import pytest

import gym_pybullet_drones_tpu
import gym_pybullet_drones_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.dirname(gym_pybullet_drones_tpu_torch.__file__)

SUBPACKAGES = ("", "assets", "bridges", "compat", "control", "core", "envs", "examples", "ops",
               "render", "rl", "runtime", "utils")
# Names with no counterpart in the port: the Pallas maker of K2 (the port's is
# ops/downwash_pairs.make_downwash) and tpu_math, which exists only because
# Mosaic lacks inverse trigonometry.
PALLAS_ONLY = {"ops": {"make_downwash_pallas", "tpu_math"}}
# The JAX package's files whose port has another name: the Pallas kernels'
# modules map to the modules of their hand-written CUDA kernels, and
# tpu_math.py has none.
RENAMED = {
    "ops/velocity_pallas.py": "ops/velocity_rollout.py",  # K1
    "ops/downwash_pallas.py": "ops/downwash_pairs.py",  # K2, K3
    "ops/collide_pallas.py": "ops/collide_pairs.py",  # K4
    "ops/interact_pallas.py": "ops/interact_pairs.py",  # K5, K6
}
NOT_PORTED = {
    "ops/tpu_math.py": "inverse trigonometry written out for Mosaic, which lacks it; "
                       "PyTorch and CUDA have atan2 and asin",
}
# Names a subpackage loads on first access (envs/__init__.py's __getattr__).
LAZY = {"envs": ("CFAviary", "BetaAviary")}


def _module(pkg, sub):
    return importlib.import_module(pkg.__name__ + (f".{sub}" if sub else ""))


def _public(mod):
    return {n for n in dir(mod)
            if not n.startswith("_") and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    jmod = _module(gym_pybullet_drones_tpu, sub)
    tmod = _module(gym_pybullet_drones_tpu_torch, sub)
    missing = _public(jmod) - _public(tmod) - PALLAS_ONLY.get(sub, set())
    assert not missing, f"{tmod.__name__} lacks {sorted(missing)}"
    for name in _public(jmod) - PALLAS_ONLY.get(sub, set()):
        jx, tx = getattr(jmod, name), getattr(tmod, name)
        assert callable(jx) == callable(tx), name
    for name in LAZY.get(sub, ()):
        assert getattr(tmod, name).__name__ == getattr(jmod, name).__name__ == name


def _files(root):
    """The package's files relative to ``root``: sources and assets, not the
    native libraries built at first use."""
    out = set()
    for d, dirs, fs in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "_build")]
        out |= {os.path.relpath(os.path.join(d, f), root) for f in fs if not f.endswith(".so")}
    return out


def test_every_jax_file_has_a_port():
    """Each file of the JAX package has a same-named file in the port, but for
    the explicit maps above (whose entries must name real files)."""
    jax_files = _files(os.path.dirname(gym_pybullet_drones_tpu.__file__))
    port_files = _files(PORT)
    assert set(RENAMED) | set(NOT_PORTED) <= jax_files
    assert set(RENAMED.values()) <= port_files
    missing = sorted(f for f in jax_files - set(NOT_PORTED) if RENAMED.get(f, f) not in port_files)
    assert not missing, missing
    assert len(jax_files) > 70


def test_runtime_rollout_is_the_function():
    import gym_pybullet_drones_tpu.runtime as jrt
    import gym_pybullet_drones_tpu_torch.runtime as trt

    assert isinstance(jrt.rollout, types.FunctionType)
    assert isinstance(trt.rollout, types.FunctionType)
    assert trt.rollout.__module__ == "gym_pybullet_drones_tpu_torch.runtime.rollout"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PORT], "gym_pybullet_drones_tpu_torch."))


def test_every_submodule_imports_first_in_a_fresh_interpreter():
    """Each submodule imported as the first module of the package: one fresh
    interpreter, the package's modules dropped from sys.modules before each
    import (torch stays loaded)."""
    code = r"""
import importlib, json, sys, traceback
import torch  # noqa: F401
bad = {}
for name in sys.argv[1:]:
    for k in [k for k in sys.modules if k.split(".")[0] == "gym_pybullet_drones_tpu_torch"]:
        del sys.modules[k]
    try:
        importlib.import_module(name)
    except Exception:
        bad[name] = traceback.format_exc(limit=3)
    if any(k.split(".")[0] in ("jax", "gym_pybullet_drones_tpu") for k in sys.modules):
        bad[name] = "imported jax or the JAX package"
print(json.dumps(bad))
"""
    mods = _port_modules()
    assert len(mods) > 40
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code, *mods], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not bad, json.dumps(bad, indent=1)


def test_port_source_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or any module
    of the JAX package (not even one free of JAX)."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "gym_pybullet_drones_tpu")]
    assert not bad, bad


def test_bridges_build_inside_the_port():
    """The native libraries load from the port's own _build/, never from (or
    into) the JAX package's tree."""
    import gym_pybullet_drones_tpu_torch.bridges.betaflight as tbeta
    import gym_pybullet_drones_tpu_torch.bridges.cffirmware as tfirm
    from gym_pybullet_drones_tpu_torch.bridges import _native

    for lib in (tfirm._lib, tbeta._lib):
        assert os.path.dirname(lib._name) == _native.BUILD_DIR
        assert _native.BUILD_DIR.startswith(PORT + os.sep)
