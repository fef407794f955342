"""The cells the tests run: those of ``BENCHMARK.json``, and those whose
files wait for the entries of a later PR (PERF.md, Open questions), each
built from its traffic and configuration files."""

from benchmark import harness

LATER = {
    "velocity.vector_env": "velocity_cf2x_e4096",
    "hover_ppo.train": "hover_ppo_cf2x_e4096",
    "hover_ppo.domain_rand": "hover_ppo_cf2x_e4096",
}


def cell(name):
    """The cell ``name``, from ``BENCHMARK.json`` or from ``LATER``."""
    if name in LATER:
        return harness.files_cell(name, LATER[name])
    return harness.load_cell(name)
