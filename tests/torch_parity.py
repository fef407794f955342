"""Shared by the tests/test_torch_*.py files: the JAX reference, compiled
cheaply, and one intra-op thread for the port's torch.

The suite runs in several pytest workers at once, each importing every test
module while it collects, so importing this module sets every worker's
torch to one thread: a worker's torch would otherwise start a thread per
core, and six workers' threads would share the cores many times over (the
port's test files then took about four times the CPU seconds)."""

import jax
import torch

torch.set_num_threads(1)

# XLA's CPU backend optimizations cost about two thirds of each reference
# step's compile time and change nothing the parity tolerances can see.
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jit_reference(fn):
    """``jax.jit`` of a JAX reference function with a quick CPU compile."""
    return jax.jit(fn, compiler_options=_FAST_COMPILE)
