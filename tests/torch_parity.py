"""Shared by the tests/test_torch_*.py files: the JAX reference, compiled cheaply."""

import jax

# XLA's CPU backend optimizations cost about two thirds of each reference
# step's compile time and change nothing the parity tolerances can see.
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jit_reference(fn):
    """``jax.jit`` of a JAX reference function with a quick CPU compile."""
    return jax.jit(fn, compiler_options=_FAST_COMPILE)
