"""Plain PyTorch references of the benchmark's cells.

A frozen copy of the arithmetic the cells reach (the VelocityAviary step in
columns, the Hover env step with auto-reset, PPO's collect and update), kept
to those functions and computing from the configuration files alone. It
imports nothing of ``gym_pybullet_drones_tpu_torch`` or of the JAX package.
"""
