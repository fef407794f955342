"""The all-pairs wake sum: kernel K2 and its plain version (port of the JAX
``ops/downwash_pallas.make_downwash_pallas``).

For each target, ``-sum K/dz^2 * exp(-dxy^2 / (2 beta^2))`` over the sources
strictly above it (dz > 0) within 10 m laterally (dxy^2 < 100), with
beta = c2 dz + c3: BaseAviary._downwash (BaseAviary.py:798-811) in the
squared-distance form of ``core/aero.downwash_forces_body_z``.

``make_downwash`` builds ``dw(pos, src_pos=None)`` and its column entry
``dw.cols(x, y, z, src=None)``:

* on CUDA tensors it launches K2 (``csrc/pair_kernels.cu``,
  ``downwash_pairs``); a failed build or launch raises;
* on CPU tensors it runs the plain version, ``downwash_plain``.

With ``z_sort`` (default: on from ``Z_SORT_MIN_N`` drones) the pass runs on
the fleet sorted by z, which lets the kernel skip tiles that are provably
masked, and scatters the result back. Sorting reorders the float32 sum.
"""

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.ops import _pairs
from gym_pybullet_drones_tpu_torch.ops._pairs import Z_SORT_MIN_N  # noqa: F401

NAME = "downwash_pairs"


def wake_terms(t, s, c: _pairs.PairConsts):
    """The wake magnitude of each source on each target (subtracted by the
    pass); ``t`` (3, ...) targets and ``s`` (3, ...) sources broadcast."""
    dx, dy, dz = s[0] - t[0], s[1] - t[1], s[2] - t[2]
    dxy2 = dx * dx + dy * dy
    above = dz > 0
    safe_dz = torch.where(above, dz, 1.0)
    alpha = _pairs._div(c.K, safe_dz * safe_dz)
    beta = c.c2 * safe_dz + c.c3
    safe_beta2 = torch.where(torch.abs(beta) > 1e-12, beta * beta, 1.0)
    mag = alpha * torch.exp(-0.5 * dxy2 / safe_beta2)
    return torch.where(above & (dxy2 < 100.0), mag, 0.0)


def downwash_plain(tgt: torch.Tensor, src: torch.Tensor, c: _pairs.PairConsts) -> torch.Tensor:
    """K2's plain version: (3, Nt) targets, (3, Ns) sources -> (Nt,) wake."""
    return -_pairs.plain_rows(lambda t, s: (wake_terms(t, s, c),), tgt, src, 1)[0]


def downwash_cuda(tgt: torch.Tensor, src: torch.Tensor, c: _pairs.PairConsts,
                  cull: bool = False, square: bool = True, tiles=None) -> torch.Tensor:
    """Launch K2 on stacked float32 CUDA columns; ``cull`` takes them as
    sorted by z. ``downwash_cuda.launches`` counts the launches."""
    out = _pairs.launch(NAME, tgt, src, c, 1, cull, square, tiles)
    downwash_cuda.launches += 1
    return out[0]


downwash_cuda.launches = 0


def make_downwash(params, z_sort=None, device=None):
    """Build ``dw(pos, src_pos=None) -> (Nt,)`` for (Nt, 3) positions, with
    ``dw.cols(x, y, z, src=None)`` over (Nt,) columns; ``src`` is an
    (xs, ys, zs) tuple of another source set (the rectangular form).
    ``device=None`` means the CUDA card, whose kernel is built here. Inputs
    are cast to float32 and the result back to their dtype."""
    device = resolve_device(device)
    if device.type == "cuda":
        _pairs.library()
    c = _pairs.pair_consts(params)

    def dw_cols(x, y, z, src=None):
        _pairs.check_device(device, x.device, "downwash pass")
        tgt = _pairs.stack((x, y, z))
        srcs = tgt if src is None else _pairs.stack(src)
        use_sort = _pairs.use_z_sort(z_sort, tgt.shape[1], srcs.shape[1])
        if use_sort:
            tgt, order = _pairs.sort_by_z(tgt)
            srcs = tgt if src is None else _pairs.sort_by_z(srcs)[0]
        if x.device.type == "cuda":
            res = downwash_cuda(tgt, srcs, c, cull=use_sort, square=src is None)
        else:
            res = downwash_plain(tgt, srcs, c)
        if use_sort:
            res = _pairs.unsort(res[None], order)[0]
        return res.to(x.dtype)

    def dw(pos, src_pos=None):
        src = None if src_pos is None else (src_pos[:, 0], src_pos[:, 1], src_pos[:, 2])
        return dw_cols(pos[:, 0], pos[:, 1], pos[:, 2], src=src)

    dw.cols = dw_cols
    return dw
