"""All-pairs drone-drone contact: kernel K4 and its plain version (port of the
JAX ``ops/collide_pallas.make_collide_pallas``).

Per target, the sum over partners with eps^2 < d^2 < min_dist^2 of the
pushout ``min(overlap / 2, max_push) * n`` and of the velocity correction
``-min(vn, 0) / 2 * n``, where n is the unit normal from the partner to the
target: ``core/collisions.resolve_drone_collisions`` (Jacobi projection,
equal masses) in the squared-distance, rsqrt form of the TPU kernel.

``make_collide`` builds ``resolve(pos, vel, src_pos=None, src_vel=None)``
and its column entry ``resolve.cols(x, y, z, vx, vy, vz, src=None)``, which
always returns the deltas. CUDA tensors launch K4 (``csrc/pair_kernels.cu``,
``collide_pairs``); CPU tensors run ``collide_plain``. ``z_sort`` sorts the
fleet by z so that the kernel skips tiles whose z intervals lie more than
min_dist apart, and scatters the corrections back.
"""

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.ops import _pairs

NAME = "collide_pairs"


def contact_terms(t, s, c: _pairs.PairConsts):
    """Per pair (dpx, dpy, dpz, dvx, dvy, dvz) of each partner ``s`` on each
    target ``t``; both (6, ...) rows x, y, z, vx, vy, vz that broadcast."""
    dx, dy, dz = t[0] - s[0], t[1] - s[1], t[2] - s[2]
    d2 = dx * dx + dy * dy + dz * dz
    contact = (d2 < c.min_dist2) & (d2 > c.eps2)
    inv = torch.rsqrt(torch.clamp(d2, min=c.eps2))
    dist = d2 * inv
    overlap = torch.where(contact, c.min_dist - dist, 0.0)
    nx, ny, nz = dx * inv, dy * inv, dz * inv
    push = torch.clamp(0.5 * overlap, max=c.max_push)
    rvx, rvy, rvz = t[3] - s[3], t[4] - s[4], t[5] - s[5]
    vn = rvx * nx + rvy * ny + rvz * nz
    appr = torch.where(contact & (vn < 0.0), vn, 0.0)
    return (push * nx, push * ny, push * nz,
            -0.5 * appr * nx, -0.5 * appr * ny, -0.5 * appr * nz)


def collide_plain(tgt: torch.Tensor, src: torch.Tensor, c: _pairs.PairConsts) -> torch.Tensor:
    """K4's plain version: (6, Nt) targets, (6, Ns) sources -> (6, Nt) deltas."""
    return _pairs.plain_rows(lambda t, s: contact_terms(t, s, c), tgt, src, 6)


def collide_cuda(tgt: torch.Tensor, src: torch.Tensor, c: _pairs.PairConsts,
                 cull: bool = False, square: bool = True, tiles=None) -> torch.Tensor:
    """Launch K4 on stacked float32 CUDA columns; ``cull`` takes them as
    sorted by z. ``collide_cuda.launches`` counts the launches."""
    out = _pairs.launch(NAME, tgt, src, c, 6, cull, square, tiles)
    collide_cuda.launches += 1
    return out


collide_cuda.launches = 0


def make_collide(params, max_push: float = 0.01, return_delta: bool = False, z_sort=None,
                 device=None):
    """Build ``resolve(pos, vel, src_pos=None, src_vel=None)`` for (Nt, 3)
    fleets: ``(new_pos, new_vel)``, or ``(dpos, dvel)`` with
    ``return_delta``. ``resolve.cols(x, y, z, vx, vy, vz, src=None)`` takes
    (Nt,) columns and a 6-tuple ``src`` of other partners and returns
    ``((dpx, dpy, dpz), (dvx, dvy, dvz))``. ``device=None`` means the CUDA
    card, whose kernel is built here."""
    device = resolve_device(device)
    if device.type == "cuda":
        _pairs.library()
    c = _pairs.pair_consts(params, max_push)

    def resolve_cols(x, y, z, vx, vy, vz, src=None):
        _pairs.check_device(device, x.device, "contact pass")
        tgt = _pairs.stack((x, y, z, vx, vy, vz))
        srcs = tgt if src is None else _pairs.stack(src)
        use_sort = _pairs.use_z_sort(z_sort, tgt.shape[1], srcs.shape[1])
        if use_sort:
            tgt, order = _pairs.sort_by_z(tgt)
            srcs = tgt if src is None else _pairs.sort_by_z(srcs)[0]
        if x.device.type == "cuda":
            res = collide_cuda(tgt, srcs, c, cull=use_sort, square=src is None)
        else:
            res = collide_plain(tgt, srcs, c)
        if use_sort:
            res = _pairs.unsort(res, order)
        res = res.to(x.dtype)
        return (res[0], res[1], res[2]), (res[3], res[4], res[5])

    def resolve(pos, vel, src_pos=None, src_vel=None):
        src = (None if src_pos is None else
               tuple(src_pos[:, i] for i in range(3)) + tuple(src_vel[:, i] for i in range(3)))
        dp, dv = resolve_cols(pos[:, 0], pos[:, 1], pos[:, 2],
                              vel[:, 0], vel[:, 1], vel[:, 2], src=src)
        dpos, dvel = torch.stack(dp, -1), torch.stack(dv, -1)
        if return_delta:
            return dpos, dvel
        return pos + dpos, vel + dvel

    resolve.cols = resolve_cols
    return resolve
