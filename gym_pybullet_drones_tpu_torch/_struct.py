"""Frozen dataclasses of tensors, and the device rule of the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Without a
card it raises instead of running on the CPU; callers that want the CPU (the
tests) ask for it with ``device="cpu"``.
"""

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present), else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, TensorStruct):
        return x.map(fn)
    return x


@dataclasses.dataclass(frozen=True)
class TensorStruct:
    """Base of the port's state and parameter records: frozen, nested, and
    mapped leaf by leaf (``map``, ``to``, ``replace``)."""

    def map(self, fn):
        """A copy with ``fn`` applied to every tensor leaf (recursively)."""
        return type(self)(**{f.name: _map(fn, getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def to(self, device):
        return self.map(lambda t: t.to(device))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def struct_where(mask, a, b):
    """Select struct ``a`` where the per-env bool ``mask`` holds, else ``b``;
    ``mask`` broadcasts over each leaf's trailing dims. A ``None`` leaf (a
    field the config does not use) stays ``None``."""

    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)

    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return sel(a, b)
    return type(a)(**{f.name: struct_where(mask, getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})
