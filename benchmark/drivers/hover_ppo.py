"""Whole PPO train steps back to back through the port's
``rl/ppo.make_ppo_train_step``: ``collect`` (the rollout of ``n_steps``
control steps of the batched Hover env, the bootstrap, GAE), then ``update``
(``n_epochs`` passes of minibatch Adam steps), each train step ending at a
synchronize, as a training loop that logs its loss does.

The benchmark makes the inputs: the network's initial weights
(``traffic.orthogonal_weights``), the generator that draws the policy noise
and the epoch permutations, and, with ``traffic.domain_rand``, the
generator that draws each env's plant. Set-up drives the train step from
them through ``setup_train_steps`` steps, through the window's own calls,
and records each step's loss, the first gradient as the optimizer gets it
(an Adam step pre-hook) and the weights after the last; the window goes on
with the same runner.

Check: the frozen reference (``reference/ppo.py`` on ``reference/hover.py``)
follows the same set-up steps from the same seed on the same device.
Compared, each by the worst case: the steps' mean losses (relative gap), the
first gradient's norm per leaf, and the norm of each leaf's change over the
set-up steps, each as the gap between the program's norm and the
reference's against the reference's norm of that leaf or of the median leaf,
whichever is larger. Leaves whose reference gradient is under
``nought_grad_share`` of the median leaf's move by round-off alone and are
left out of the change.
"""

import contextlib
import statistics
import time

import torch

from benchmark import trace, traffic
from benchmark.reference import ppo as refppo
from benchmark.reference.hover import Hover


def _shapes(cfg):
    env, ppo = cfg["env"], cfg["ppo"]
    N = int(env["drones_per_env"])
    obs = N * (12 + int(env["action_buffer_size"]))
    h1, h2 = ppo["hidden"]
    shapes = {"log_std": (N,), "mean.weight": (N, h2), "mean.bias": (N,),
              "value.weight": (1, h2), "value.bias": (1,)}
    for tower in ("pi", "vf"):
        shapes.update({f"{tower}.0.weight": (h1, obs), f"{tower}.0.bias": (h1,),
                       f"{tower}.1.weight": (h2, h1), f"{tower}.1.bias": (h2,)})
    gains = {f"{t}.{i}.weight": 2 ** 0.5 for t in ("pi", "vf") for i in (0, 1)}
    gains.update({"mean.weight": 0.01, "value.weight": 1.0})
    return {k: shapes[k] for k in refppo.PARAM_ORDER}, gains


def weights(run):
    """The network's initial weights, from the seed, on the run's device."""
    shapes, gains = _shapes(run.config)
    w = traffic.orthogonal_weights(shapes, gains, run.seed, run.device)
    w["log_std"].fill_(float(run.config["ppo"]["log_std_init"]))
    return w


def generators(run):
    """The noise generator and, with domain randomization, the plant one."""
    g = torch.Generator(device=run.device).manual_seed(traffic.torch_seed(run.seed, 8))
    dr = torch.Generator(device=run.device).manual_seed(traffic.torch_seed(run.seed, 9))
    return g, dr


def setup(run):
    from gym_pybullet_drones_tpu_torch.core.params import randomize_params
    from gym_pybullet_drones_tpu_torch.envs.base import TASK_HOVER, AviaryConfig
    from gym_pybullet_drones_tpu_torch.envs.spec import (
        ActionType,
        DroneModel,
        ObservationType,
        Physics,
    )
    from gym_pybullet_drones_tpu_torch.rl.ppo import PPOConfig, make_ppo_train_step, ppo_init

    env, ppo = run.config["env"], run.config["ppo"]
    E = int(ppo["num_envs"])
    env_cfg = AviaryConfig(
        drone_model=DroneModel.CF2X, num_drones=int(env["drones_per_env"]),
        physics=Physics.PYB, pyb_freq=int(env["pyb_freq"]), ctrl_freq=int(env["ctrl_freq"]),
        task=TASK_HOVER, action_type=ActionType.ONE_D_RPM, obs_type=ObservationType.KIN,
        action_buffer_size=int(env["action_buffer_size"]),
        episode_len_sec=float(env["episode_len_sec"]), dtype=env["dtype"])
    ppo_cfg = PPOConfig(
        num_envs=E, n_steps=int(ppo["n_steps"]), learning_rate=ppo["learning_rate"],
        gamma=ppo["gamma"], gae_lambda=ppo["gae_lambda"], clip_range=ppo["clip_range"],
        ent_coef=ppo["ent_coef"], vf_coef=ppo["vf_coef"], max_grad_norm=ppo["max_grad_norm"],
        n_epochs=int(ppo["n_epochs"]), minibatch_size=int(ppo["minibatch_size"]),
        hidden=tuple(ppo["hidden"]), log_std_init=ppo["log_std_init"],
        log_std_anneal_to=ppo["log_std_anneal_to"],
        log_std_anneal_updates=int(ppo["log_std_anneal_updates"]))
    runner, aux = ppo_init(env_cfg, ppo_cfg, traffic.torch_seed(run.seed, 7), device=run.device)
    w0 = weights(run)
    with torch.no_grad():
        for name, p in runner.params.named_parameters():
            p.copy_(w0[name])
    gen, dr = generators(run)
    runner = runner.replace(generator=gen)
    spec = run.traffic.get("domain_rand")
    if spec:
        aux["train_params_env"] = randomize_params(dr, aux["params_env"], E, spec)
    train = make_ppo_train_step(env_cfg, ppo_cfg, aux)

    grads = []

    def first_grads(opt, args, kwargs):
        if not grads:
            grads.extend(p.grad.detach().clone() for g in opt.param_groups for p in g["params"])

    hook = runner.opt_state.register_step_pre_hook(first_grads)
    losses = []
    for _ in range(int(run.traffic["setup_train_steps"])):
        runner, rollout = train.collect(runner)
        runner, metrics = train.update(runner, rollout)
        losses.append(float(metrics["loss"]))
        hook.remove()
    names = [n for n, _ in runner.params.named_parameters()]
    run.state.update(
        runner=runner, train=train, E=E, n_steps=int(ppo["n_steps"]), names=names,
        losses=losses, grad_norms=[float(torch.linalg.vector_norm(g)) for g in grads],
        change_norms=[float(torch.linalg.vector_norm(p.detach() - w0[n]))
                      for n, p in runner.params.named_parameters()])


def _train_step(run, events):
    st = run.state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if run.cuda else None
    t = [time.perf_counter()]
    if ev:
        ev[0].record()
    runner, rollout = st["train"].collect(st["runner"])
    if ev:
        ev[1].record()
    t.append(time.perf_counter())
    runner, metrics = st["train"].update(runner, rollout)
    if ev:
        ev[2].record()
    float(metrics["loss"])  # the loop logs its loss: the step ends on the host
    t.append(time.perf_counter())
    st["runner"] = runner
    if ev:
        events.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    else:
        events.append(((t[1] - t[0]) * 1e3, (t[2] - t[1]) * 1e3))


def window(run, seconds):
    st = run.state
    events = []
    run.fence()
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        run.attempted += 1
        _train_step(run, events)
        k += 1
    run.window_s = time.perf_counter() - t0
    run.completed = k
    run.work["env_steps"] = k * st["E"] * st["n_steps"]
    run.samples["collect_ms"] = [c for c, _ in events]
    run.samples["update_ms"] = [u for _, u in events]


def traced(run):
    st = run.state
    parts = []
    for _ in range(int(run.workload["trace"]["train_steps"])):
        out = {}
        parts.append(trace.profiled(
            "collect", lambda: out.update(c=st["train"].collect(st["runner"]))))
        runner, rollout = out["c"]
        parts.append(trace.profiled(
            "update", lambda: out.update(u=st["train"].update(runner, rollout))))
        st["runner"] = out["u"][0]
        parts[-2]["control_steps"] = st["n_steps"]
    return parts


def reference(run, steps, weights0, mode=None):
    """The reference's ``steps`` train steps from the seed: ``(losses, first
    gradients, the network after the last step)``."""
    cfg = run.config
    E = int(cfg["ppo"]["num_envs"])
    gen, dr = generators(run)
    spec = run.traffic.get("domain_rand")
    scale = None
    if spec:
        scale = {}
        for name in sorted(spec):
            u = torch.empty(E, dtype=torch.float32, device=dr.device).uniform_(
                -1.0, 1.0, generator=dr)
            scale[name] = 1.0 + float(spec[name]) * u.to(run.device)
    env = Hover(cfg, run.device, plant_scale=scale)
    algo = refppo.PPO(env, cfg["ppo"], weights0, gen, E)
    with mode or contextlib.nullcontext():
        losses = [float(algo.train_step()) for _ in range(steps)]
    return losses, algo.grads, {k: algo.net[k].detach() for k in refppo.PARAM_ORDER}


def _worst(prog, ref, keep=None):
    """max over leaves of |prog - ref| / max(ref, median ref)."""
    med = statistics.median(ref)
    idx = range(len(ref)) if keep is None else keep
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in idx)


def _compare(run, names, losses_p, grads_p, change_p):
    w0 = weights(run)
    losses_r, grads_r, net_r = reference(run, len(losses_p), w0)
    if names != list(refppo.PARAM_ORDER) or len(grads_p) != len(names):
        run.checks["leaves_differ"] = (1, 0)
        return
    grad_r = [float(torch.linalg.vector_norm(g)) for g in grads_r]
    change_r = [float(torch.linalg.vector_norm(net_r[n] - w0[n])) for n in names]
    med = statistics.median(grad_r)
    share = float(run.check_spec["nought_grad_share"])
    moving = [i for i, g in enumerate(grad_r) if g >= share * med]
    lim = run.check_spec["limits"]
    run.checks["loss_gap"] = (max(abs(p - r) / abs(r) for p, r in zip(losses_p, losses_r)),
                              lim["loss_gap"])
    run.checks["grad_gap"] = (_worst(grads_p, grad_r), lim["grad_gap"])
    run.checks["change_gap"] = (_worst(change_p, change_r, moving), lim["change_gap"])
    run.info.update(losses=losses_p, losses_ref=losses_r,
                    left_out=[names[i] for i in range(len(names)) if i not in moving])


def check(run):
    st = run.state
    args = (st["names"], st["losses"], st["grad_norms"], st["change_norms"])
    st.clear()  # the program's state is freed before the reference runs
    if run.cuda:
        torch.cuda.empty_cache()
    _compare(run, *args)


def control(run):
    """The reference computed in TF32 (every float32 result rounded) in the
    program's place."""
    from benchmark.reference.tf32 import TF32

    run.state.clear()
    if run.cuda:
        torch.cuda.empty_cache()
    w0 = weights(run)
    losses, grads, net = reference(run, int(run.traffic["setup_train_steps"]), w0, mode=TF32())
    names = list(refppo.PARAM_ORDER)
    _compare(run, names, losses, [float(torch.linalg.vector_norm(g)) for g in grads],
             [float(torch.linalg.vector_norm(net[n] - w0[n])) for n in names])
