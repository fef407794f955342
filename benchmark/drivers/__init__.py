"""The cells' drivers, one module a kind of traffic: ``setup(run)``,
``window(run, seconds)``, ``traced(run)`` (a list of ``trace.profiled``
parts) and ``check(run)`` (fills ``run.checks``)."""
