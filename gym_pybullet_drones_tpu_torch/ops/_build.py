"""Build the port's CUDA kernels with ``nvcc`` into shared libraries for ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so one ``nvcc`` call builds it in seconds. The shared library goes
into ``_build/`` beside the package (listed in ``.gitignore``), named by a
hash of the source, of every file under ``csrc/`` that it includes, and of
its flags, at first use: a change to a shared header rebuilds every kernel
that uses it, a change to one source's flags that source's library alone.
"""

import hashlib
import os
import re
import shutil
import subprocess

from gym_pybullet_drones_tpu_torch import _spans

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _flags(fmad: bool):
    # sm_90a: Hopper with its arch-specific instructions. No --use_fast_math.
    return ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            f"-fmad={str(fmad).lower()}", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# Each source's flags. K1 (velocity_rollout) equals its plain version bit for
# bit only if adds and multiplies round separately, as in PyTorch: -fmad=false;
# its counting build (velocity_rollout_counts) runs the same step, with the
# same flags. K2, K4, K5 (wake_pair_kernels) and K3, K6 (masked_pair_kernels)
# contract multiply-adds into FMAs: fewer instructions a pair. The wake is held
# to tolerances; the contact term rounds each step itself (csrc/pair_terms.cuh),
# so K4 still equals its plain version bit for bit. K7 (render_views) follows
# its plain version's rounding: -fmad=false.
NVCC_FLAGS = {"velocity_rollout": _flags(fmad=False),
              "velocity_rollout_counts": _flags(fmad=False),
              "wake_pair_kernels": _flags(fmad=True), "masked_pair_kernels": _flags(fmad=True),
              "render_views": _flags(fmad=False)}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen=None):
    """``path`` and, recursively, every file under ``csrc/`` that it includes
    with ``#include "..."``, each once, in the order met."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as fh:
        text = fh.read()
    for inc in _INCLUDE.findall(text):
        child = os.path.join(CSRC, inc.decode())
        if os.path.exists(child):
            _sources(child, seen)
    return seen


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    sha = hashlib.sha1(" ".join(NVCC_FLAGS[name]).encode())
    for path in _sources(src):
        with open(path, "rb") as fh:
            sha.update(fh.read())
    digest = sha.hexdigest()[:12]
    stem = os.path.join(BUILD_DIR, f"{name}-{digest}")
    return src, stem + ".so", stem + ".log"


def build(name: str) -> str:
    """Build ``csrc/<name>.cu`` if it is not built yet and return the path of
    its shared library; raises with the compiler's output when nvcc fails.
    A build is recorded as the set-up span ``nvcc.<name>``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    with _spans.setup_span(f"nvcc.{name}"):
        proc = subprocess.run([nvcc, *NVCC_FLAGS[name], "-o", tmp, src], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stdout}")
    with open(log, "w") as fh:
        fh.write(proc.stdout)
    os.replace(tmp, lib)
    return lib


def ptxas_report(name: str) -> str:
    """The compiler's output of a built kernel: the ``-Xptxas -v`` lines
    (registers, stack, spills)."""
    _, _, log = _paths(name)
    with open(log) as fh:
        return fh.read()

