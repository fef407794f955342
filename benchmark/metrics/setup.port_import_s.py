"""setup.port_import_s: seconds the port's import took, from the first to
the last statement of its package ``__init__`` (the set-up span
``port.import``, ``runtime/profiling.py``): the subpackages, the
controllers with what they import, the Gymnasium registration."""


def read(run):
    from gym_pybullet_drones_tpu_torch.runtime import profiling

    found = [t1 - t0 for name, t0, t1 in getattr(profiling, "setup_spans", list)()
             if name == "port.import"]
    return 1e-9 * sum(found) if found else None
