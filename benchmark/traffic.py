"""The traffic generators: inputs of every cell, made from ``--seed`` alone.

Each generator reads the parameters of a workload file's ``traffic`` group.
The same seed gives the same inputs; a seed changes the values, never the
sizes or the amount of work.
"""

import math

import numpy as np
import torch

MAX_CALLS = 1 << 17  # headings drawn up front: far more calls than a window holds


def rng(seed, *stream):
    """A numpy generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng([abs(int(seed)) % (1 << 63), *stream])


def torch_seed(seed, stream):
    """A seed for a ``torch.Generator``, from ``seed`` and a stream id."""
    return int(rng(seed, stream, 99).integers(0, 1 << 62))


class FormationHeadings:
    """Velocity commands of formation flight, one command for all envs of a
    call. Each call flies one of the traffic file's ``commands``, in an order
    drawn from the seed anew for every ``len(commands)`` calls, so that every
    seed gives each command the same share of the calls:

    * ``rotated``: env ``i`` flies the compass heading ``2 pi i / E`` in the
      horizontal plane at ``speed_fraction`` of the speed limit, the whole
      formation turned by an angle drawn from the seed for the call;
    * ``compass``: the same headings unturned, made as a formation script
      makes them (cosine and sine in float64, rounded to float32), so the
      headings along an axis keep a component of about 1e-16, not 0;
    * ``hover``: the zero command, every env holding its position.
    """

    KINDS = ("rotated", "compass", "hover")

    def __init__(self, traffic: dict, num_envs: int, seed, device):
        self.E, self.device = num_envs, device
        self.speed = float(traffic["speed_fraction"])
        self.commands = list(traffic.get("commands", ["rotated"]))
        unknown = set(self.commands) - set(self.KINDS)
        if unknown:
            raise ValueError(f"unknown formation commands {sorted(unknown)}")
        self.base = torch.arange(num_envs, dtype=torch.float64, device=device) * (
            2.0 * math.pi / num_envs)
        self.turn = rng(seed, 1).uniform(0.0, 2.0 * math.pi, size=MAX_CALLS)
        n = len(self.commands)
        blocks = -(-MAX_CALLS // n)
        self.order = np.argsort(rng(seed, 7).random((blocks, n)), axis=1).ravel()

    def kind(self, call: int) -> str:
        """The command of call ``call``."""
        return self.commands[self.order[call]]

    def action(self, call: int):
        """The (E,) float32 command columns ``ax, ay, az, amag`` of call ``call``."""
        kind = self.kind(call)
        z = torch.zeros(self.E, dtype=torch.float32, device=self.device)
        if kind == "hover":
            return dict(ax=z, ay=z.clone(), az=z.clone(), amag=z.clone())
        ang = self.base + (float(self.turn[call]) if kind == "rotated" else 0.0)
        return dict(ax=torch.cos(ang).float(), ay=torch.sin(ang).float(), az=z,
                    amag=torch.full((self.E,), self.speed, dtype=torch.float32,
                                    device=self.device))


class SphereCommands:
    """Velocity commands of independent envs: each env flies a direction
    uniform on the unit sphere at a magnitude uniform in [0, 1], redrawn every
    ``period`` control steps at a phase of its own (``traffic``: ``period``).
    ``action(t)`` is the (E, 1, 4) float32 numpy action of step ``t``."""

    def __init__(self, traffic: dict, num_envs: int, seed):
        self.E, self.seed = num_envs, seed
        self.period = int(traffic["period"])
        self.phase = rng(seed, 2).integers(0, self.period, size=num_envs)
        self._segments = {}

    def _segment(self, j):
        if j not in self._segments:
            r = rng(self.seed, 3, j)
            d = r.standard_normal((self.E, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            self._segments[j] = np.concatenate(
                [d, r.uniform(0.0, 1.0, (self.E, 1))], 1).astype(np.float32)
            self._segments.pop(j - 2, None)
        return self._segments[j]

    def action(self, t: int):
        j = (t + self.phase) // self.period
        lo = int(j.min())
        out = np.where((j == lo)[:, None], self._segment(lo), self._segment(lo + 1)
                       if (j > lo).any() else 0.0)
        return out[:, None, :].astype(np.float32)


def orthogonal_weights(shapes: dict, gains: dict, seed, device):
    """Initial weights of a network from the seed (SB3's init): each matrix
    orthogonal with its gain, biases zero, drawn from a ``torch.Generator`` on
    ``device``. ``shapes`` maps names to shapes; a name without a gain (the
    log-std, biases) starts at zero."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 4))
    out = {}
    for name, shape in shapes.items():
        w = torch.zeros(shape, dtype=torch.float32, device=device)
        if name in gains:
            torch.nn.init.orthogonal_(w, gains[name], generator=gen)
        out[name] = w
    return out
