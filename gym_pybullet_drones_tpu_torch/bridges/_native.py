"""Build the firmware-in-the-loop bridges' C++ sources with ``g++`` into
shared libraries for ``ctypes`` (host code, not CUDA kernels).

A library goes into ``_build/`` beside the package (listed in
``.gitignore``), named by a hash of its source and flags, at first use. It
is compiled to a temporary file of this process and renamed into place, so
that several processes (pytest workers) may build it at once.
"""

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def build(src_path: str) -> str:
    """Build ``src_path`` if it is not built yet and return its library's
    path; raises with the compiler's output when ``g++`` fails."""
    with open(src_path, "rb") as fh:
        digest = hashlib.sha1(" ".join(FLAGS).encode() + fh.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(src_path))[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *FLAGS, src_path, "-o", tmp], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src_path} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def load(src_path: str) -> ctypes.CDLL:
    """The library of ``src_path``, built at first use."""
    return ctypes.CDLL(build(src_path))
