"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``): the
repository root on the import path, one torch thread."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)
