"""The benchmark of the PyTorch and CUDA port (``gym_pybullet_drones_tpu_torch``).

``python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once on the CUDA card and prints one JSON
line. Everything that belongs to one configuration, traffic mix, driver or
metric sits in a file of its own under ``configs/``, ``workloads/``,
``drivers/`` and ``metrics/``, found by name. ``reference/`` holds the plain
PyTorch reference that decides ``correct``; it imports nothing of the port.
"""
