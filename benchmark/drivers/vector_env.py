"""One control step a call through the port's vector-env core
(``runtime/shell.make_vec_core``: the gymnasium-free core of
``compat/vector.py``), as a Gymnasium vector user drives VelocityAviary:
numpy actions (E, 1, 4) in, the batched step with auto-reset on the card,
obs, rewards, flags and final obs back as numpy, every step.

Commands come from ``traffic.SphereCommands``. The window starts from the
reset state after a warm-up of ``warm_steps`` steps on a state of its own,
and times each ``step()`` call from the call to its numpy return.

Check: the float32 closed loop parts from any other rounding within a
simulated second (the DSLPID derivative term amplifies it), so the reference
follows the program one step at a time from the program's own state: for
the steps drawn from the seed (one in ``stride``), the frozen VelocityAviary
step (``reference/velocity.py``) in float64, from the state the program
stepped, gives the state and observation the program must return. Compared:
the returned obs and final obs and the state carried to the next step, each
quantity by its largest gap over the envs (the kinematics over the envs
clear of the ground by ``contact_margin_m`` before and after the step, as
the reference computes them); the reward (-1), the flags
(never set in VelocityAviary) and the step counter exactly; and, once, the
reset observation against the reference's reset state.
"""

import contextlib
import time

import numpy as np
import torch

from benchmark import trace, traffic
from benchmark.reference import params as refparams
from benchmark.reference import velocity as ref

GROUPS = {"pos_m": (0, 3), "quat": (3, 7), "rpy_rad": (7, 10), "vel_ms": (10, 13),
          "angv_rads": (13, 16), "rpm": (16, 20)}
# Held only on envs clear of the ground: at the plane clamp a rounding flips
# the contact branch, which clamps the fall and zeroes the spin of a drone
# pressed into it (gaps of 1e-4 m and 0.7 rad/s in one step). The motor
# speeds and the controller's memory come before the physics and are held
# on every env.
KINEMATIC = ("pos_m", "quat", "rpy_rad", "vel_ms", "angv_rads")


def setup(run):
    from gym_pybullet_drones_tpu_torch.envs.base import (
        TASK_VELOCITY,
        AviaryConfig,
        build_ctrl_params,
        build_params,
    )
    from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel, Physics
    from gym_pybullet_drones_tpu_torch.runtime.shell import make_vec_core

    env = run.config["env"]
    E = int(env["num_envs"])
    cfg = AviaryConfig(drone_model=DroneModel.CF2X, num_drones=int(env["drones_per_env"]),
                       physics=Physics.PYB, pyb_freq=int(env["pyb_freq"]),
                       ctrl_freq=int(env["ctrl_freq"]), task=TASK_VELOCITY,
                       episode_len_sec=float(run.traffic["episode_len_sec"]), dtype=env["dtype"])
    params = build_params(cfg, run.device)
    ctrl = build_ctrl_params(cfg, run.device)
    target = torch.zeros((cfg.num_drones, 3), dtype=cfg.torch_dtype, device=run.device)
    reset, step = make_vec_core(cfg, params, ctrl, target, E, device=run.device)
    cmds = traffic.SphereCommands(run.traffic, E, run.seed)
    state, _ = reset()
    for t in range(int(run.traffic["warm_steps"])):
        state, _ = step(state, cmds.action(t))
    state, obs0 = reset()
    r = traffic.rng(run.seed, 10)
    stride = int(run.check_spec["stride"])
    run.state.update(step=step, cmds=cmds, state=state, obs0=obs0, E=E, t=0,
                     stride=stride, phase=int(r.integers(0, stride)), kept=[])


def _steps(run, until, times=None):
    st = run.state
    step, cmds, state, t = st["step"], st["cmds"], st["state"], st["t"]
    while not until(t):
        act = cmds.action(t)
        t0 = time.perf_counter()
        new, out = step(state, act)
        if times is not None:
            times.append(time.perf_counter() - t0)
        if times is not None and t % st["stride"] == st["phase"]:
            st["kept"].append((t, state, act, out, new))
        state, t = new, t + 1
    st["state"], st["t"] = state, t


def window(run, seconds):
    st = run.state
    times = []
    run.fence()
    t0 = time.perf_counter()
    _steps(run, lambda t: time.perf_counter() - t0 >= seconds, times)
    run.window_s = time.perf_counter() - t0
    run.attempted = run.completed = st["t"]
    run.work["drone_steps"] = st["t"] * st["E"] * int(run.config["env"]["drones_per_env"])
    run.samples["step_s"] = times


def traced(run):
    st = run.state
    n = int(run.workload["trace"]["steps"])
    first = st["t"]
    part = trace.profiled("vec_step", lambda: _steps(run, lambda t: t >= first + n))
    part["control_steps"] = n
    return [part]


def columns(state, dtype):
    """The program's AviaryState as the reference's (E,) columns."""
    groups = [(("px", "py", "pz"), state.kin.pos), (("qx", "qy", "qz", "qw"), state.kin.quat),
              (("vx", "vy", "vz"), state.kin.vel), (("wx", "wy", "wz"), state.kin.ang_v),
              (("r0", "r1", "r2", "r3"), state.last_rpm),
              (("ipx", "ipy", "ipz"), state.ctrl.integral_pos_e),
              (("irx", "iry", "irz"), state.ctrl.integral_rpy_e),
              (("lrx", "lry", "lrz"), state.ctrl.last_rpy)]
    return {k: x[:, 0, i].to(dtype) for keys, x in groups for i, k in enumerate(keys)}


def reference_step(run, cols, act, mode=None):
    """The reference's control step from ``cols`` under numpy ``act``."""
    env = run.config["env"]
    a = torch.as_tensor(act[:, 0, :], device=cols["px"].device).to(cols["px"].dtype)
    args = (refparams.velocity_consts(run.config), 1.0 / env["ctrl_freq"],
            1.0 / env["pyb_freq"], env["pyb_freq"] // env["ctrl_freq"],
            refparams.f32(refparams.speed_limit(run.config)), cols, a[:, 0], a[:, 1], a[:, 2],
            a[:, 3])
    with mode or contextlib.nullcontext():
        return ref.control_step(*args)


def compare(run, kept, step_fn=None):
    """The gaps of the kept steps: ``{name: largest gap}``. ``step_fn(cols,
    act)`` gives the columns the program is held to (the reference's float64
    step by default)."""
    step_fn = step_fn or (lambda cols, act: reference_step(run, cols, act))
    gaps = {k: 0.0 for k in (*GROUPS, "ctrl", "signals_wrong")}

    def worst(name, got, want):
        gaps[name] = max(gaps[name], float(np.nanmax(np.abs(got - want), initial=0.0))
                         if np.isfinite(got).all() else float("inf"))

    def hold_obs(got, want, clear=None):
        for name, (a, b) in GROUPS.items():
            g, w = got[..., a:b].astype(np.float64), want[..., a:b]
            if clear is not None and name in KINEMATIC:
                g, w = g[clear], w[clear]
            worst(name, g, w)

    floor = refparams.velocity_consts(run.config)["z_min"] + float(
        run.check_spec["contact_margin_m"])

    hold_obs(run.state["obs0"][:, 0], ref.obs_columns(
        ref.reset_columns(run.config, run.state["E"], torch.float64, "cpu")).numpy())
    for t, before, act, (obs, reward, term, trunc, final), after in kept:
        cols = columns(before, torch.float64)
        want = step_fn(cols, act)
        want_obs = ref.obs_columns(want).cpu().numpy()
        clear = ((cols["pz"] > floor) & (want["pz"] > floor)).cpu().numpy()
        gaps["clear_share"] = min(gaps.get("clear_share", 1.0), float(clear.mean()))
        hold_obs(obs[:, 0], want_obs, clear)
        hold_obs(final[:, 0], want_obs, clear)
        carried = columns(after, torch.float64)
        carried_obs = ref.obs_columns(carried).cpu().numpy()
        hold_obs(carried_obs, want_obs, clear)
        for k in ("ipx", "ipy", "ipz", "irx", "iry", "irz", "lrx", "lry", "lrz"):
            worst("ctrl", carried[k].cpu().numpy(), want[k].cpu().numpy())
        wrong = int((reward != -1.0).sum() + term.sum() + trunc.sum())
        nsub = run.config["env"]["pyb_freq"] // run.config["env"]["ctrl_freq"]
        wrong += int((after.step_count != before.step_count + nsub).sum())
        gaps["signals_wrong"] += wrong
    return gaps


def check(run):
    st = run.state
    kept = st["kept"]
    for k in ("state", "step"):  # the program's own state is freed first
        st.pop(k)
    run.info["steps_checked"] = len(kept)
    gaps = compare(run, kept)
    run.info["clear_share"] = gaps.pop("clear_share", None)
    for name, value in gaps.items():
        run.checks[name] = (value, run.check_spec["limits"][name])
    st.clear()


def control(run):
    """The reference computed in TF32 (float32 columns, every result rounded
    to TF32) in the program's place, from the program's states."""
    from benchmark.reference.tf32 import TF32

    st = run.state
    kept = st["kept"]
    for k in ("state", "step"):
        st.pop(k)

    def tf32_step(cols, act):
        out = reference_step(run, {k: v.float() for k, v in cols.items()}, act, mode=TF32())
        return {k: v.double() for k, v in out.items()}

    def with_outputs(item):
        t, before, act, outs, after = item
        want = tf32_step(columns(before, torch.float64), act)
        obs = ref.obs_columns(want).float().cpu().numpy()[:, None]
        return t, before, act, (obs, outs[1], outs[2], outs[3], obs), _State(want, after)

    gaps = compare(run, [with_outputs(item) for item in kept])
    gaps.pop("clear_share", None)
    for name, value in gaps.items():
        run.checks[name] = (value, run.check_spec["limits"][name])
    st.clear()


class _State:
    """The control's state in the shape ``columns`` reads."""

    def __init__(self, cols, like):
        import types

        stack = lambda ks: torch.stack([cols[k] for k in ks], -1)[:, None, :]
        self.kin = types.SimpleNamespace(pos=stack(("px", "py", "pz")),
                                         quat=stack(("qx", "qy", "qz", "qw")),
                                         vel=stack(("vx", "vy", "vz")),
                                         ang_v=stack(("wx", "wy", "wz")))
        self.last_rpm = stack(("r0", "r1", "r2", "r3"))
        self.ctrl = types.SimpleNamespace(integral_pos_e=stack(("ipx", "ipy", "ipz")),
                                          integral_rpy_e=stack(("irx", "iry", "irz")),
                                          last_rpy=stack(("lrx", "lry", "lrz")))
        self.step_count = like.step_count
