"""setup_s: seconds from the start of run.py to the window: imports, the
port's kernel build (nvcc, first run in a checkout only), the cell's inputs
and warm-up (host clock)."""


def read(run):
    return run.setup_s
