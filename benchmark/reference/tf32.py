"""The control's precision: TF32, float32 with a 10-bit mantissa.

``TF32()`` is a dispatch mode under which every float32 result of a PyTorch
operation is rounded to the nearest TF32 value (ties to even), the precision
a float32 configuration would fall to with TF32 switched on. The reference
run under it is the control that the comparison has to refuse.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def round_tf32(x):
    """``x`` (float32) rounded to 10 mantissa bits, ties to even."""
    i = x.view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


class TF32(TorchDispatchMode):
    """Rounds the results of operations that make new tensors; views and
    in-place results alias their inputs and pass through."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out
        rnd = lambda t: round_tf32(t) if isinstance(t, torch.Tensor) \
            and t.dtype == torch.float32 else t
        if isinstance(out, (tuple, list)):
            return type(out)(rnd(t) for t in out)
        return rnd(out)
