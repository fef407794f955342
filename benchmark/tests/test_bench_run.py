"""run.py's refusals: without a card, and in a directory that holds only
the benchmark's files, it exits with another code than 0 and prints no
result."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ARGS = ["--workload", "velocity.chunked", "--seed", "2147483651", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_refuses(request):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_alone_in_a_directory_it_refuses(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_an_unknown_cell_is_refused():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "no.such_cell",
                          *ARGS[2:]], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
