"""Gradients through the port's physics, against the JAX package's, on the CPU
in float64 (the port's twin of tests/test_differentiability.py).

``torch.autograd`` flows through ``core.dynamics.step_physics`` (DYN, PYB
with the ground clamp, PYB with the impulse contact solver) as ``jax.grad``
does through the JAX step: the gradient of the final altitude equals JAX's
at 1e-9 relative and central differences at 1e-3 (PYB and DYN), and is
finite and non-zero in all three. ``torch.optim.Adam``'s
iterates on the 24-step schedule equal ``optax.adam``'s at 1e-9 relative, and
so do the port's ``examples/trajopt.run``'s first ten against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import gym_pybullet_drones_tpu.examples.trajopt as jtrajopt
from gym_pybullet_drones_tpu.core.dynamics import init_kin_state as j_init_kin_state
from gym_pybullet_drones_tpu.core.dynamics import step_physics as j_step_physics
from gym_pybullet_drones_tpu.core.params import drone_params as j_drone_params
from gym_pybullet_drones_tpu.envs.spec import DroneModel as JDroneModel
from gym_pybullet_drones_tpu.envs.spec import Physics as JPhysics
from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state, step_physics
from gym_pybullet_drones_tpu_torch.core.params import drone_params
from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.examples import trajopt

F64 = dict(dtype=torch.float64, device="cpu")
STEPS = 24  # 0.5 s at 48 Hz, tests/test_differentiability.py's rollouts
TARGET_Z = 1.0


@pytest.fixture(scope="module")
def params():
    return drone_params(DroneModel.CF2X, **F64)


@pytest.fixture(scope="module")
def jparams():
    return j_drone_params(JDroneModel.CF2X, dtype=jnp.float64)


def _rollout_z(rpm_scalar, params, physics, contact_mode="clamp"):
    """Final altitude after STEPS control periods at one constant RPM."""
    kin = init_kin_state(torch.tensor([[0.0, 0.0, 0.5]], **F64),
                         torch.tensor([[0.0, 0.0, 0.0, 1.0]], **F64))
    rpm = rpm_scalar.expand(1, 4)
    last = rpm
    for _ in range(STEPS):
        kin, last = step_physics(kin, rpm, last, params, 1 / 240, 5, physics,
                                 contact_mode=contact_mode)
    return kin.pos[0, 2]


def _j_rollout_z(rpm_scalar, params, physics, contact_mode="clamp"):
    """tests/test_differentiability.py's ``_rollout_z``."""
    kin = j_init_kin_state(jnp.asarray([[0.0, 0.0, 0.5]]), jnp.asarray([[0.0, 0.0, 0.0, 1.0]]))
    rpm = jnp.full((1, 4), rpm_scalar)

    def body(carry, _):
        kin, last = carry
        kin, last = j_step_physics(kin, rpm, last, params, 1 / 240, 5, physics,
                                   contact_mode=contact_mode)
        return (kin, last), None

    (kin, _), _ = jax.lax.scan(body, (kin, rpm), None, length=STEPS)
    return kin.pos[0, 2]


def _grad(f, x):
    x = torch.tensor(x, **F64, requires_grad=True)
    (g,) = torch.autograd.grad(f(x), x)
    return float(g)


@pytest.mark.parametrize("physics", ["PYB", "DYN"])
def test_grad_through_physics_matches_jax_and_finite_difference(params, jparams, physics):
    """d(final z)/d(rpm) through 120 substeps at the hover RPM: JAX's jax.grad
    at 1e-9 relative, central differences at 1e-3."""
    hover = float(params.hover_rpm)
    f = lambda r: _rollout_z(r, params, Physics[physics])
    g = _grad(f, hover)
    want = jax.grad(lambda r: _j_rollout_z(r, jparams, JPhysics[physics]))(jnp.float64(hover))
    np.testing.assert_allclose(g, float(want), rtol=1e-9)
    eps = 1e-3
    with torch.no_grad():
        fd = (f(torch.tensor(hover + eps, **F64)) - f(torch.tensor(hover - eps, **F64))) / (2 * eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, float(fd), rtol=1e-3)


@pytest.mark.parametrize("physics,mode", [("DYN", "clamp"), ("PYB", "clamp"),
                                          ("PYB", "impulse")])
def test_gradients_flow_through_both_physics_and_contact_modes(params, physics, mode):
    """Finite, non-zero gradients through DYN, PYB + clamp and PYB + impulse
    (the sequential-impulse solver is a loop of smooth clamps, differentiable
    almost everywhere), below the hover RPM."""
    r0 = 0.99 * float(params.hover_rpm)
    g = _grad(lambda r: _rollout_z(r, params, Physics[physics], contact_mode=mode), r0)
    assert np.isfinite(g) and abs(g) > 0.0, (physics, mode)


def _schedule_loss(sched, params, hover):
    """tests/test_differentiability.py's trajectory-optimization loss, on the port."""
    kin = init_kin_state(torch.tensor([[0.0, 0.0, 0.5]], **F64),
                         torch.tensor([[0.0, 0.0, 0.0, 1.0]], **F64))
    last = torch.full((1, 4), hover, **F64)
    vzs = []
    for r in sched.unbind(0):
        kin, last = step_physics(kin, (hover + r).expand(1, 4), last, params, 1 / 240, 5,
                                 Physics.PYB)
        vzs.append(kin.vel[0, 2])
    return (kin.pos[0, 2] - TARGET_Z) ** 2 + 1e-4 * torch.sum(torch.stack(vzs) ** 2)


def _j_schedule_loss(sched, params, hover):
    kin = j_init_kin_state(jnp.asarray([[0.0, 0.0, 0.5]]), jnp.asarray([[0.0, 0.0, 0.0, 1.0]]))
    last = jnp.full((1, 4), hover)

    def body(carry, r):
        kin, last = carry
        kin, last = j_step_physics(kin, jnp.full((1, 4), hover + r), last, params, 1 / 240, 5,
                                   JPhysics.PYB)
        return (kin, last), kin.vel[0, 2]

    (kin, _), vzs = jax.lax.scan(body, (kin, last), sched)
    return (kin.pos[0, 2] - TARGET_Z) ** 2 + 1e-4 * jnp.sum(vzs ** 2)


def test_adam_iterates_equal_optax(params, jparams):
    """The first 10 torch.optim.Adam iterates of the 24-step RPM schedule
    equal optax.adam(200.0)'s at 1e-9 relative (tests/test_differentiability.py's
    optimizer and loss), and the loss falls."""
    hover = float(params.hover_rpm)
    sched = torch.zeros(STEPS, **F64, requires_grad=True)
    opt = torch.optim.Adam([sched], lr=200.0)
    jsched = jnp.zeros(STEPS, jnp.float64)
    jopt = optax.adam(200.0)
    jstate = jopt.init(jsched)
    jgrad = jax.jit(jax.value_and_grad(lambda s: _j_schedule_loss(s, jparams, hover)))
    losses = []
    for k in range(10):
        opt.zero_grad()
        loss = _schedule_loss(sched, params, hover)
        loss.backward()
        opt.step()
        jloss, g = jgrad(jsched)
        updates, jstate = jopt.update(g, jstate, jsched)
        jsched = optax.apply_updates(jsched, updates)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-9)
        np.testing.assert_allclose(sched.detach().numpy(), np.asarray(jsched), rtol=1e-9,
                                   atol=1e-9 * float(jnp.abs(jsched).max()), err_msg=f"iter {k}")
        losses.append(loss.item())
    assert losses[-1] < 0.5 * losses[0], losses


def _recording_adam_step(monkeypatch):
    """Wrap ``torch.optim.Adam.step`` so each call keeps a copy of the
    parameters it leaves (the port's twin of wrapping optax.apply_updates)."""
    iterates = []
    step = torch.optim.Adam.step

    def recording_step(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        iterates.append(self.param_groups[0]["params"][0].detach().cpu().numpy().copy())
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", recording_step)
    return iterates


def test_trajopt_iterates_equal_jax(tmp_path, monkeypatch):
    """examples/trajopt.run's first 10 Adam iterates (1 s horizon, 48 steps)
    equal the JAX package's trajopt.run's at 1e-9 relative, and so do the
    final errors it reports; its loss, |pos - target|^2 + 0.1 |vel|^2, falls
    from the hover schedule's."""
    jiterates = []
    apply = optax.apply_updates

    def recording_apply(p, u):
        out = apply(p, u)
        jiterates.append(np.asarray(out))
        return out

    monkeypatch.setattr(optax, "apply_updates", recording_apply)
    jerr, jvel = jtrajopt.run(iters=10, plot=False, output_folder=str(tmp_path))
    monkeypatch.undo()
    iterates = _recording_adam_step(monkeypatch)
    err, vel = trajopt.run(iters=10, plot=False, output_folder=str(tmp_path), device="cpu")
    assert len(iterates) == len(jiterates) == 10
    for k, (got, want) in enumerate(zip(iterates, jiterates)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max(),
                                   err_msg=f"iter {k}")
    np.testing.assert_allclose([err, vel], [jerr, jvel], rtol=1e-9)
    err0, vel0 = trajopt.run(iters=0, plot=False, output_folder=str(tmp_path), device="cpu")
    assert len(iterates) == 10
    loss0, loss = err0 ** 2 + 0.1 * vel0 ** 2, err ** 2 + 0.1 * vel ** 2
    assert loss < 0.5 * loss0, (loss0, loss)
