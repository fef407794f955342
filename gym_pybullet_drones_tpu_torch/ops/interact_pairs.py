"""The wake and the contact in one square pair pass: kernel K5 and its plain
version (port of the JAX ``ops/interact_pallas.make_interact_pallas``).

Outputs per drone: the wake magnitude of ``ops/downwash_pairs`` and the
pushout and velocity correction of ``ops/collide_pairs``, from one walk over
the pairs. The pair arithmetic is theirs (``wake_terms``, ``contact_terms``;
in CUDA, ``wake_term`` and ``contact_term``), so K5 is K2 plus K4.

Stated deviation from the dense pipeline (kept from the JAX kernel): the
wake is computed from the same pre-pushout positions as the contact, where
the dense path feeds the next substep's wake the post-pushout positions. The
two differ only for drones in contact, by at most the wake's change over one
pushout (max_push = 1 cm). In the ill-conditioned regime of near-coincident
drones any reordering diverges from the dense path, this one included.

``make_interact`` builds ``interact(pos, vel) -> (mag, dpos, dvel)`` and
``interact.cols(x, y, z, vx, vy, vz)``. CUDA tensors launch K5
(``csrc/pair_kernels.cu``, ``interact_pairs``); CPU tensors run
``interact_plain``. ``z_sort`` culls the wake section by the sorted index
triangle and the contact section by the z band, each on its own.
"""

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.ops import _pairs
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import contact_terms
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import wake_terms

NAME = "interact_pairs"


def interact_plain(cols: torch.Tensor, c: _pairs.PairConsts) -> torch.Tensor:
    """K5's plain version: (6, N) columns -> (7, N): the wake, then the
    pushout and the velocity correction."""

    def terms(t, s):
        return (-wake_terms(t, s, c),) + contact_terms(t, s, c)

    return _pairs.plain_rows(terms, cols, cols, 7)


def interact_cuda(cols: torch.Tensor, c: _pairs.PairConsts, cull: bool = False,
                  tiles=None) -> torch.Tensor:
    """Launch K5 on stacked float32 CUDA columns; ``cull`` takes them as
    sorted by z. ``interact_cuda.launches`` counts the launches."""
    out = _pairs.launch(NAME, cols, cols, c, 7, cull, True, tiles)
    interact_cuda.launches += 1
    return out


interact_cuda.launches = 0


def make_interact(params, max_push: float = 0.01, z_sort=None, device=None):
    """Build ``interact(pos, vel) -> (mag (N,), dpos (N, 3), dvel (N, 3))``
    and ``interact.cols(x, y, z, vx, vy, vz) -> (mag, (dpx, dpy, dpz),
    (dvx, dvy, dvz))``. ``device=None`` means the CUDA card, whose kernel is
    built here."""
    device = resolve_device(device)
    if device.type == "cuda":
        _pairs.library()
    c = _pairs.pair_consts(params, max_push)

    def interact_cols(x, y, z, vx, vy, vz):
        _pairs.check_device(device, x.device, "interaction pass")
        cols = _pairs.stack((x, y, z, vx, vy, vz))
        use_sort = _pairs.use_z_sort(z_sort, cols.shape[1], cols.shape[1])
        if use_sort:
            cols, order = _pairs.sort_by_z(cols)
        if x.device.type == "cuda":
            res = interact_cuda(cols, c, cull=use_sort)
        else:
            res = interact_plain(cols, c)
        if use_sort:
            res = _pairs.unsort(res, order)
        res = res.to(x.dtype)
        return res[0], (res[1], res[2], res[3]), (res[4], res[5], res[6])

    def interact(pos, vel):
        mag, dp, dv = interact_cols(pos[:, 0], pos[:, 1], pos[:, 2],
                                    vel[:, 0], vel[:, 1], vel[:, 2])
        return mag, torch.stack(dp, -1), torch.stack(dv, -1)

    interact.cols = interact_cols
    return interact
