"""Port parameter records against the JAX package's, field by field in float64."""

import dataclasses
import filecmp
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.control.dsl_pid import dsl_pid_params as jax_dsl_pid_params
from gym_pybullet_drones_tpu.core.params import drone_params as jax_drone_params
from gym_pybullet_drones_tpu.core.params import from_urdf as jax_from_urdf
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JaxDroneModel
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.control.dsl_pid import dsl_pid_params
from gym_pybullet_drones_tpu_torch.core.params import drone_params, from_urdf, urdf_path
from gym_pybullet_drones_tpu_torch.envs import spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "gym_pybullet_drones_tpu_torch"
MODELS = ("CF2X", "CF2P", "RACE")


def _assert_fields_equal(port, ref):
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    got = convert.record_to_numpy(port)
    for name in names:
        want = np.asarray(getattr(ref, name))
        assert got[name].shape == want.shape, name
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_enums_match_jax():
    from gym_pybullet_drones_tpu.envs import spec as jax_spec

    for name in ("DroneModel", "Physics", "ImageType", "ActionType", "ObservationType"):
        ours, ref = getattr(spec, name), getattr(jax_spec, name)
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in ref]


@pytest.mark.parametrize("model", MODELS)
def test_drone_params_match_jax(model):
    port = drone_params(spec.DroneModel[model], dtype=torch.float64, device="cpu")
    ref = jax_drone_params(JaxDroneModel[model], dtype=jnp.float64)
    _assert_fields_equal(port, ref)


@pytest.mark.parametrize("model", MODELS)
def test_from_urdf_matches_jax(model):
    """The port's own URDF copies parse to the JAX loader's values."""
    m = spec.DroneModel[model]
    jax_path = os.path.join(ROOT, "gym_pybullet_drones_tpu", "assets", f"{m.value}.urdf")
    assert filecmp.cmp(urdf_path(m), jax_path, shallow=False)
    port = from_urdf(urdf_path(m), m, dtype=torch.float64, device="cpu")
    ref = jax_from_urdf(jax_path, JaxDroneModel[model], dtype=jnp.float64)
    _assert_fields_equal(port, ref)
    _assert_fields_equal(port, jax_drone_params(JaxDroneModel[model], dtype=jnp.float64))


@pytest.mark.parametrize("model", ("CF2X", "CF2P"))
def test_dsl_pid_params_match_jax(model):
    port = dsl_pid_params(spec.DroneModel[model], dtype=torch.float64, device="cpu")
    ref = jax_dsl_pid_params(JaxDroneModel[model], dtype=jnp.float64)
    _assert_fields_equal(port, ref)


def test_dsl_pid_rejects_race():
    with pytest.raises(ValueError):
        dsl_pid_params(spec.DroneModel.RACE, device="cpu")


@pytest.mark.parametrize("model", MODELS)
def test_convert_carries_params_across(model):
    ref = jax_drone_params(JaxDroneModel[model], dtype=jnp.float64)
    fields = {f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)}
    port = convert.drone_params_from_numpy(fields, device="cpu", dtype=torch.float64)
    _assert_fields_equal(port, ref)
    cref = jax_dsl_pid_params(dtype=jnp.float64)
    cfields = {f.name: np.asarray(getattr(cref, f.name)) for f in dataclasses.fields(cref)}
    _assert_fields_equal(
        convert.dsl_pid_params_from_numpy(cfields, device="cpu", dtype=torch.float64), cref)


def test_float32_params_round_like_jax():
    port = drone_params(dtype=torch.float32, device="cpu")
    _assert_fields_equal(port, jax_drone_params(dtype=jnp.float32))


def test_default_device_is_the_card():
    """device=None means CUDA: without a card it raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        assert drone_params().m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            drone_params()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dsl_pid_params()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports neither JAX nor the
    JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gym_pybullet_drones_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gym_pybullet_drones_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    pattern = re.compile(r"^\s*(import|from) (jax|flax|gym_pybullet_drones_tpu)\b")
    sources = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, PORT))
        for f in fs if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            assert not any(pattern.match(line) for line in fh), path
