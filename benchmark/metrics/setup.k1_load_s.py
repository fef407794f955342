"""setup.k1_load_s: seconds K1 took to be ready: its library's load (the
set-up span ``k1.load``: hashing the sources, nvcc where no library matched,
``ctypes.CDLL``) and its first launch, where CUDA loads the module
(``k1.first_launch``), from ``runtime/profiling.py``'s set-up spans."""

SPANS = ("k1.load", "k1.first_launch")


def read(run):
    from gym_pybullet_drones_tpu_torch.runtime import profiling

    found = [t1 - t0 for name, t0, t1 in getattr(profiling, "setup_spans", list)()
             if name in SPANS]
    return 1e-9 * sum(found) if found else None
