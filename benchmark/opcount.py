"""Operation counts of the cells' algorithms, counted on the frozen
reference, so that a count stays the same whatever implements the step.

Elementwise operations count one per element; ``clamp`` one per bound it
applies; transcendentals (sin, cos, atan2, asin, sqrt, exp, tanh, pow) one
each. Counts are taken on one-env tensors on the CPU. A dense layer's
forward pass counts ``2 in out`` for the product, ``out`` for the bias.
"""

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import params as refparams
from benchmark.reference import velocity as refvel
from benchmark.reference.hover import Hover

_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "sin", "cos",
        "atan2", "asin", "exp", "rsqrt", "maximum", "minimum", "gt", "lt", "ge", "le",
        "where", "bitwise_and", "logical_and", "bitwise_or", "logical_or", "bitwise_not",
        "logical_not", "pow", "tanh", "isfinite", "eq", "ne", "sum"}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__.rstrip("_")
        out = func(*args, **kwargs)
        if name in _OPS:
            self.ops[name] += max(1, out.numel() if isinstance(out, torch.Tensor) else 1)
        elif name == "clamp":
            bounds = list(args[1:3]) + [kwargs.get("min"), kwargs.get("max")]
            n = out.numel() if isinstance(out, torch.Tensor) else 1
            self.ops[name] += n * sum(b is not None for b in bounds)
        return out


def count(fn) -> int:
    """Operations of ``fn()``, by the rule above."""
    with _OpCount() as c:
        fn()
    return sum(c.ops.values())


def velocity_ops(cfg: dict) -> dict:
    """Per env: ``target`` (the command's velocity, once a call) and
    ``control_step`` (one VelocityAviary control step less the target)."""
    env = cfg["env"]
    c = refparams.velocity_consts(cfg)
    sl = refparams.speed_limit(cfg)
    nsub = env["pyb_freq"] // env["ctrl_freq"]
    s = refvel.reset_columns(cfg, 1, torch.float32, "cpu")
    a = [torch.full((1,), v) for v in (1.0, 0.0, 0.0, 0.25)]
    target = count(lambda: refvel.velocity_target(sl, *a))
    step = count(lambda: refvel.control_step(c, 1.0 / env["ctrl_freq"], 1.0 / env["pyb_freq"],
                                             nsub, sl, s, *a))
    return dict(target=target, control_step=step - target)


def mlp_forward_ops(sizes) -> int:
    """Operations of one sample through dense layers of ``sizes`` (in, ...,
    out) with tanh after every hidden layer."""
    ops = 0
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        ops += 2 * n_in * n_out + n_out
        if i < len(sizes) - 2:
            ops += n_out  # tanh
    return ops


def ppo_ops(cfg: dict) -> dict:
    """Per env-step of a PPO train step: the env step with auto-reset, the
    policy's forward pass in collect (with the truncation bootstrap's second
    one), and the update's forward, backward (twice the forward's products)
    and Adam steps over ``n_epochs`` passes of the batch."""
    env, ppo = cfg["env"], cfg["ppo"]
    hover = Hover(cfg, "cpu")
    s = hover.reset(1)
    act = torch.zeros((1, hover.N, hover.A))
    env_step = count(lambda: hover.batched_step(s, act))
    obs_dim = hover.N * (12 + hover.B * hover.A)
    hidden = list(ppo["hidden"])
    pi = mlp_forward_ops([obs_dim, *hidden, hover.N * hover.A])
    vf = mlp_forward_ops([obs_dim, *hidden, 1])
    forward = pi + vf
    n_params = sum(a * b + b for a, b in zip([obs_dim, *hidden], [*hidden, hover.N * hover.A]))
    n_params += sum(a * b + b for a, b in zip([obs_dim, *hidden], [*hidden, 1])) + hover.A
    batch = ppo["num_envs"] * ppo["n_steps"]
    steps = ppo["n_epochs"] * (batch // ppo["minibatch_size"])
    adam_per_param = 13  # moments, bias corrections, the update, the clip's scale
    update = ppo["n_epochs"] * 3 * forward + steps * n_params * adam_per_param / batch
    collect = env_step + 2 * forward + 10
    return dict(env_step=env_step, collect=collect, update=update,
                per_env_step=collect + update, n_params=n_params)
