"""The wake and the contact in one pair pass: kernels K5 and K6 and their
plain versions (port of the JAX ``ops/interact_pallas.py``:
``make_interact_pallas`` and ``make_interact_masked``).

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
(``csrc/wake_pair_kernels.cu``, ``interact_pairs``); CPU tensors run
``interact_plain``. ``z_sort`` culls the wake section by the sorted index
triangle and the contact section by the z band, each on its own.

``make_interact_masked`` builds the same seven sums for a fleet kept in any
permutation, square or rectangular: ``ops/spatial.py``'s live words gate the
wake section (bits 0-7) and the contact section (bits 8-15) of each sub-slice
separately. CUDA tensors launch K6 (``csrc/masked_pair_kernels.cu``,
``interact_masked``); CPU tensors run ``interact_masked_plain``. Both put
exactly 0 in the seven rows of padding targets (``valid`` false), where the
JAX package computes at most about 1e-17 N of wake and no contact.
"""

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.ops import _pairs, spatial
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import contact_terms, make_collide
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import (
    make_downwash,
    masked_grid,
    run_masked,
    wake_terms,
)

NAME = "interact_pairs"
MASKED_NAME = "interact_masked"


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
    out = _pairs.launch_units(NAME, cols, cols, c, 7, cull, True, tiles)
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
        _pairs.unit_library()
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


def interact_masked_plain(tgt: torch.Tensor, src: torch.Tensor, words: torch.Tensor,
                          grid: _pairs.TileGrid, c: _pairs.PairConsts,
                          valid=None) -> torch.Tensor:
    """K6's plain version: (6, Nt) targets, (6, Ns) sources and the words of
    ``grid`` -> (7, Nt). It gates the wake by the words' bits 0-7 and the
    contact by bits 8-15, per tile pair and sub-slice, as the kernel does,
    and puts 0 where the bool column ``valid`` of the targets is false."""
    wake, contact = _pairs.slice_gates(words, grid, tgt.shape[1], src.shape[1])

    def gates(r0, r1):
        return ((_pairs.pair_gate(wake, grid, r0, r1),)
                + (_pairs.pair_gate(contact, grid, r0, r1),) * 6)

    def terms(t, s):
        return (-wake_terms(t, s, c),) + contact_terms(t, s, c)

    return _pairs.plain_rows(terms, tgt, src, 7, gates, valid)


def interact_masked_cuda(tgt: torch.Tensor, src: torch.Tensor, words: torch.Tensor,
                         grid: _pairs.TileGrid, c: _pairs.PairConsts, valid=None,
                         split=None) -> torch.Tensor:
    """Launch K6 on stacked float32 CUDA columns and int32 CUDA words; the
    rows where the bool column ``valid`` is false come out 0. ``split``: the
    source ranks (``_pairs.masked_split`` by default).
    ``interact_masked_cuda.launches`` counts the launches."""
    out = _pairs.launch_masked(MASKED_NAME, tgt, src, words, grid, c, 7, valid, split)
    interact_masked_cuda.launches += 1
    return out


interact_masked_cuda.launches = 0


def make_interact_masked(params, bt: int = 256, bs=None, max_push: float = 0.01,
                         cone: bool = True, neighbor_cap=None, dense_fallback: bool = True,
                         sub=None, device=None):
    """Build the mask-gated fused pass ``interact(pos, vel) -> (mag, dpos,
    dvel)`` with ``interact.cols(x, y, z, vx, vy, vz, valid=None, src=None,
    src_valid=None) -> (mag, (dpx, dpy, dpz), (dvx, dvy, dvz))`` for a fleet
    in any permutation. Options as ``ops/downwash_pairs.make_downwash_masked``;
    ``src`` is a 6-tuple (xs, ys, zs, vxs, vys, vzs) of another source set.
    With ``dense_fallback=False`` the overflow branch is the z-sorted K5
    (square), or the z-sorted rectangular K2 plus K4: the same outputs with
    the float32 pair sums in another order. ``make_interact_masked.overflows``
    counts the passes that took the overflow branch."""
    device = resolve_device(device)
    if device.type == "cuda":
        _pairs.masked_library()
    c = _pairs.pair_consts(params, max_push)
    sorted_pass = not dense_fallback and neighbor_cap is not None
    opts = dict(z_sort=True, device=device)
    sorted_ia = make_interact(params, max_push, **opts) if sorted_pass else None
    sorted_dw = make_downwash(params, **opts) if sorted_pass else None
    sorted_co = make_collide(params, max_push, return_delta=True, **opts) if sorted_pass else None

    def interact_cols(x, y, z, vx, vy, vz, valid=None, src=None, src_valid=None):
        _pairs.check_device(device, x.device, "masked interaction pass")
        valid = None if valid is None else valid.to(torch.bool).contiguous()
        tgt = _pairs.stack((x, y, z, vx, vy, vz))
        srcs = tgt if src is None else _pairs.stack(src)
        dense = masked_grid(tgt.shape[1], srcs.shape[1], bt, bs, sub)
        mask = spatial.subtile_packed_mask(
            tgt[0], tgt[1], tgt[2], dense.bt, dense.bs, min_dist=c.min_dist, params=params,
            cone=cone, valid=valid,
            src_cols=None if src is None else (srcs[0], srcs[1], srcs[2]),
            src_valid=None if src is None else src_valid, sub=dense.sub)
        kernel = interact_masked_cuda if x.device.type == "cuda" else interact_masked_plain

        def overflow():
            if src is None:
                mag, dp, dv = sorted_ia.cols(*tgt)
            else:
                mag = sorted_dw.cols(*tgt[:3], src=tuple(srcs[:3]))
                dp, dv = sorted_co.cols(*tgt, src=tuple(srcs))
            return torch.stack((mag, *dp, *dv))

        res = run_masked(
            make_interact_masked, lambda words, grid: kernel(tgt, srcs, words, grid, c, valid),
            overflow, mask, tgt.shape[1], dense, neighbor_cap, dense_fallback, valid)
        res = res.to(x.dtype)
        return res[0], (res[1], res[2], res[3]), (res[4], res[5], res[6])

    def interact(pos, vel):
        mag, dp, dv = interact_cols(pos[:, 0], pos[:, 1], pos[:, 2],
                                    vel[:, 0], vel[:, 1], vel[:, 2])
        return mag, torch.stack(dp, -1), torch.stack(dv, -1)

    interact.cols = interact_cols
    return interact


make_interact_masked.overflows = 0
