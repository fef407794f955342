"""Checkpoint and resume of a whole training run (port of the JAX
``runtime/checkpoint.py``).

The reference persists only the policy (learn.py:98, play.py:26) and never
the env state (SURVEY §5). Here the whole run state is saved: for a
``PPORunnerState`` the network's and Adam's ``state_dict()``s, the
generator's ``get_state()``, the env-state tensors and ``update_count``,
with ``torch.save``. The port's runner holds live objects (an ``nn.Module``,
a ``torch.optim.Adam``, a ``torch.Generator``), so a restore writes into a
template of the same structure in place: ``load_state_dict`` and
``set_state``, so that the restored Adam still points at the restored
parameters, and the next train step equals the one the saved run would
have taken, bit for bit.

A save writes ``path/step_<n>.tmp-<pid>-<ns>/tree.pt`` and renames the
directory to ``step_<n>``: ``latest_step`` skips what an interrupted save
leaves behind.
"""

import dataclasses
import os
import shutil
import time
from typing import Any

import torch
from torch import nn

_FILE = "tree.pt"


def _cpu(tree):
    """A copy of a ``state_dict``-like tree with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _pack(x, gather):
    """``x`` as plain containers of CPU tensors and Python scalars.
    ``gather`` maps each tensor that is not inside a module, an optimizer or
    a generator (the env-state tensors)."""
    if isinstance(x, nn.Module):
        return {"kind": "module", "state": _cpu(x.state_dict())}
    if isinstance(x, torch.optim.Optimizer):
        return {"kind": "optimizer", "state": _cpu(x.state_dict())}
    if isinstance(x, torch.Generator):
        return {"kind": "generator", "state": x.get_state()}
    if isinstance(x, torch.Tensor):
        return {"kind": "tensor", "value": gather(x).detach().cpu()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"kind": "fields", "items": {f.name: _pack(getattr(x, f.name), gather)
                                            for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {"kind": "dict", "items": {k: _pack(v, gather) for k, v in x.items()}}
    if isinstance(x, (list, tuple)):
        return {"kind": "seq", "items": [_pack(v, gather) for v in x]}
    return {"kind": "value", "value": x}


def _unpack(template, saved):
    """``saved`` written into ``template``'s structure: modules, optimizers
    and generators in place, tensors on the template's device and dtype."""
    kind = saved["kind"]
    if isinstance(template, nn.Module) and kind == "module":
        template.load_state_dict(saved["state"])
        return template
    if isinstance(template, torch.optim.Optimizer) and kind == "optimizer":
        template.load_state_dict(saved["state"])
        return template
    if isinstance(template, torch.Generator) and kind == "generator":
        template.set_state(saved["state"])
        return template
    if isinstance(template, torch.Tensor) and kind == "tensor":
        value = saved["value"]
        if tuple(value.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint tensor of shape {tuple(value.shape)} does not fit "
                             f"the template's {tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    if dataclasses.is_dataclass(template) and kind == "fields":
        return dataclasses.replace(template, **{
            f.name: _unpack(getattr(template, f.name), saved["items"][f.name])
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, dict) and kind == "dict":
        return {k: _unpack(v, saved["items"][k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)) and kind == "seq":
        items = [_unpack(t, s) for t, s in zip(template, saved["items"], strict=True)]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    if kind == "value":
        return saved["value"]
    raise ValueError(f"checkpoint entry of kind {kind!r} does not fit a template "
                     f"{type(template).__name__}")


def save_checkpoint(path: str, tree: Any, step: int = 0, mesh=None) -> str:
    """Write ``tree`` under ``path/step_<step>`` (replacing one there) and
    return that directory.

    ``mesh`` (``runtime/mesh.make_mesh``): every rank calls this together.
    The tensors outside modules, optimizers and generators (a runner's env
    state and observations) are then each rank's slice of the env axis: they
    are all-gathered along their first axis, and rank 0 writes the whole
    batch, which a single process can restore. The rest is the same on every
    rank and is written once."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, f"step_{step}")
    if mesh is None:
        packed = _pack(tree, lambda t: t)
    else:
        from gym_pybullet_drones_tpu_torch.runtime.mesh import all_gather, barrier

        packed = _pack(tree, lambda t: all_gather(mesh, t))
        if mesh.rank != 0:
            barrier(mesh)
            return ckpt_dir
    os.makedirs(path, exist_ok=True)
    tmp = f"{ckpt_dir}.tmp-{os.getpid()}-{time.monotonic_ns()}"
    os.makedirs(tmp)
    torch.save(packed, os.path.join(tmp, _FILE))
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.replace(tmp, ckpt_dir)
    if mesh is not None:
        barrier(mesh)
    return ckpt_dir


def restore_checkpoint(path: str, template: Any, step: int = None) -> Any:
    """Restore into ``template``'s structure (shapes must match): modules,
    optimizers and generators are loaded in place and returned, tensors come
    back on the template's device and dtype. With ``step=None``, picks the
    highest ``step_<n>`` under ``path``."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step < 0:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(os.path.join(path, f"step_{step}", _FILE), map_location="cpu",
                       weights_only=True)
    return _unpack(template, saved)


def latest_step(path: str) -> int:
    """The largest completed step under ``path``, or -1. Entries named
    ``step_`` plus anything but digits (an interrupted save's
    ``step_<n>.tmp-*``) are skipped."""
    steps = []
    for d in os.listdir(path):
        if not d.startswith("step_"):
            continue
        suffix = d.split("_", 1)[1]
        if suffix.isdigit():
            steps.append(int(suffix))
    return max(steps) if steps else -1
