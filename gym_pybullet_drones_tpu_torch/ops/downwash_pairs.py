"""The all-pairs wake sum: kernels K2 and K3 and their plain versions (port of
the JAX ``ops/downwash_pallas.py``: ``make_downwash_pallas`` and
``make_downwash_masked``).

For each target, ``-sum K/dz^2 * exp(-dxy^2 / (2 beta^2))`` over the sources
strictly above it (dz > 0) within 10 m laterally (dxy^2 < 100), with
beta = c2 dz + c3: BaseAviary._downwash (BaseAviary.py:798-811) in the
squared-distance form of ``core/aero.downwash_forces_body_z``.

``make_downwash`` builds ``dw(pos, src_pos=None)`` and its column entry
``dw.cols(x, y, z, src=None)``:

* on CUDA tensors it launches K2 (``csrc/wake_pair_kernels.cu``,
  ``downwash_pairs``); a failed build or launch raises;
* on CPU tensors it runs the plain version, ``downwash_plain``.

With ``z_sort`` (default: on from ``Z_SORT_MIN_N`` drones) the pass runs on
the fleet sorted by z, which lets the kernel skip tiles that are provably
masked, and scatters the result back. Sorting reorders the float32 sum.

``make_downwash_masked`` builds the same sum for a fleet kept in any
permutation: ``ops/spatial.py``'s exact live words gate each (target tile,
source tile) pair and each sub-slice of the source tile, with no sort, gather
or scatter around the pass. CUDA tensors launch K3
(``csrc/masked_pair_kernels.cu``, ``downwash_masked``); CPU tensors run
``downwash_masked_plain``, which reads the same words. Both put exactly 0 in
the rows of padding targets (``valid`` false); the JAX package evaluates
those rows against the z = -1e9 sentinels, to at most about 1e-17 N.
"""

import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.ops import _pairs, spatial
from gym_pybullet_drones_tpu_torch.ops._pairs import Z_SORT_MIN_N  # noqa: F401

NAME = "downwash_pairs"
MASKED_NAME = "downwash_masked"


def wake_terms(t, s, c: _pairs.PairConsts):
    """The wake magnitude of each source on each target (subtracted by the
    pass); ``t`` (3, ...) targets and ``s`` (3, ...) sources broadcast.

    Where float32 beta = c2 dz + c3 is 0 (dz = 0.6875 m for the CF2X) the
    term is exactly 0: the limit of the reference simulator's Gaussian
    exp(-dxy^2 / (2 beta^2)) as beta goes to 0 (BaseAviary.py:798-811). The
    JAX package puts beta^2 = 1 there, a Gaussian 1 m wide; this is the
    port's one deliberate deviation from it, and it makes the live masks'
    cone cull (``ops/spatial.py``), which reads beta -> 0 as an ever narrower
    Gaussian, exact."""
    dx, dy, dz = s[0] - t[0], s[1] - t[1], s[2] - t[2]
    dxy2 = dx * dx + dy * dy
    above = dz > 0
    safe_dz = torch.where(above, dz, 1.0)
    alpha = _pairs._div(c.K, safe_dz * safe_dz)
    beta = c.c2 * safe_dz + c.c3
    spread = torch.abs(beta) > 1e-12
    safe_beta2 = torch.where(spread, beta * beta, 1.0)
    mag = alpha * torch.exp(-0.5 * dxy2 / safe_beta2)
    return torch.where(above & (dxy2 < 100.0) & spread, mag, 0.0)


def downwash_plain(tgt: torch.Tensor, src: torch.Tensor, c: _pairs.PairConsts) -> torch.Tensor:
    """K2's plain version: (3, Nt) targets, (3, Ns) sources -> (Nt,) wake."""
    return -_pairs.plain_rows(lambda t, s: (wake_terms(t, s, c),), tgt, src, 1)[0]


def downwash_cuda(tgt: torch.Tensor, src: torch.Tensor, c: _pairs.PairConsts,
                  cull: bool = False, square: bool = True, tiles=None) -> torch.Tensor:
    """Launch K2 on stacked float32 CUDA columns; ``cull`` takes them as
    sorted by z. ``downwash_cuda.launches`` counts the launches."""
    out = _pairs.launch_units(NAME, tgt, src, c, 1, cull, square, tiles)
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
        _pairs.unit_library()
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


def downwash_masked_plain(tgt: torch.Tensor, src: torch.Tensor, words: torch.Tensor,
                          grid: _pairs.TileGrid, c: _pairs.PairConsts,
                          valid=None) -> torch.Tensor:
    """K3's plain version: (3, Nt) targets, (3, Ns) sources and the words of
    ``grid`` -> (Nt,) wake. It gates each tile pair and sub-slice by the
    words' wake bits, as the kernel does, and puts 0 where the bool column
    ``valid`` of the targets is false."""
    wake, _ = _pairs.slice_gates(words, grid, tgt.shape[1], src.shape[1])
    gates = lambda r0, r1: (_pairs.pair_gate(wake, grid, r0, r1),)
    out = _pairs.plain_rows(lambda t, s: (wake_terms(t, s, c),), tgt, src, 1, gates, valid)
    return -out[0]


def downwash_masked_cuda(tgt: torch.Tensor, src: torch.Tensor, words: torch.Tensor,
                         grid: _pairs.TileGrid, c: _pairs.PairConsts, valid=None,
                         split=None) -> torch.Tensor:
    """Launch K3 on stacked float32 CUDA columns and int32 CUDA words; the
    rows where the bool column ``valid`` is false come out 0. ``split``: the
    source ranks (``_pairs.masked_split`` by default).
    ``downwash_masked_cuda.launches`` counts the launches."""
    out = _pairs.launch_masked(MASKED_NAME, tgt, src, words, grid, c, 1, valid, split)
    downwash_masked_cuda.launches += 1
    return out[0]


downwash_masked_cuda.launches = 0


def masked_grid(n: int, n_src: int, bt: int, bs, sub) -> _pairs.TileGrid:
    """The masked passes' dense tiling of ``n`` targets and ``n_src``
    sources, the tiles clamped to divisors of the fleet."""
    bt_e = spatial.fit_block(bt, n)
    bs_e = spatial.fit_block(spatial.auto_bs(bs), n_src)
    return _pairs.TileGrid(bt_e, bs_e, spatial.subtile_count(bs_e) if sub is None else sub,
                           n_src // bs_e, False)


def run_masked(maker, run, overflow, mask, n: int, dense: _pairs.TileGrid, neighbor_cap,
               dense_fallback: bool, valid=None):
    """What the two masked passes share after the words are formed: the dense
    grid, or the compacted one with its overflow branch. ``run(words, grid)``
    evaluates the pass, ``overflow()`` is the ``dense_fallback=False`` branch,
    whose rows of padding targets (``valid`` false) are zeroed as the kernels
    zero them. A row over the cap is found by reading one device scalar on
    the host; ``maker.overflows`` counts the passes that took the branch."""
    if neighbor_cap is None:
        return run(mask, dense)
    ns = dense.row_len
    cap = spatial.auto_nbr_cap(ns) if neighbor_cap is True else neighbor_cap
    cap = min(cap, ns)
    idx, count_max = spatial.compact_live_tiles(mask, n // dense.bt, ns, cap)
    if int(count_max) > cap:
        maker.overflows += 1
        if dense_fallback:
            return run(mask, dense)
        res = overflow()
        return res if valid is None else torch.where(valid, res, 0.0)
    return run(idx, dense._replace(row_len=cap, compact=True))


def make_downwash_masked(params, bt: int = 256, bs=None, cone: bool = True, neighbor_cap=None,
                         dense_fallback: bool = True, sub=None, device=None):
    """Build the mask-gated wake pass ``dw(pos) -> (N,)`` with
    ``dw.cols(x, y, z, valid=None, src=None, src_valid=None)`` for a fleet in
    any permutation (persistently sorted, binned, a few control steps stale).

    ``bt``/``bs``/``sub``: targets and sources per tile (clamped to divisors
    of the fleet) and sub-slices per source tile. ``cone`` adds the float32
    cone cull to the masks. ``neighbor_cap`` compacts each target row's live
    source tiles into a list of that many slots (True: ``auto_nbr_cap``) and
    the pass walks the list; rows keep ascending source order, so the result
    is bit-identical to the dense masked grid at equal tiles. If a row holds
    more live tiles than the cap, the pass takes its overflow branch: the
    dense masked grid (exact), or with ``dense_fallback=False`` the z-sorted
    K2 pass, which reorders the float32 sums. ``make_downwash_masked
    .overflows`` counts those passes.

    ``valid``: the bool column of real slots in a padded binned layout; it
    tightens the tile bounds, padding being inert per pair (z = -1e9 fails
    dz > 0 against any real drone), and the padding targets' rows come out 0
    (the kernel skips them). ``src``/``src_valid``: (xs, ys, zs)
    columns of another source set with its own padding column, the
    rectangular form. ``device=None`` means the CUDA card, whose kernel is
    built here."""
    device = resolve_device(device)
    if device.type == "cuda":
        _pairs.masked_library()
    c = _pairs.pair_consts(params)
    sorted_dw = (None if dense_fallback or neighbor_cap is None
                 else make_downwash(params, z_sort=True, device=device))

    def dw_cols(x, y, z, valid=None, src=None, src_valid=None):
        _pairs.check_device(device, x.device, "masked downwash pass")
        valid = None if valid is None else valid.to(torch.bool).contiguous()
        tgt = _pairs.stack((x, y, z))
        srcs = tgt if src is None else _pairs.stack(src)
        dense = masked_grid(tgt.shape[1], srcs.shape[1], bt, bs, sub)
        mask = spatial.subtile_packed_mask(
            tgt[0], tgt[1], tgt[2], dense.bt, dense.bs, params=params, cone=cone, valid=valid,
            src_cols=None if src is None else (srcs[0], srcs[1], srcs[2]),
            src_valid=None if src is None else src_valid, sub=dense.sub)
        kernel = downwash_masked_cuda if x.device.type == "cuda" else downwash_masked_plain
        res = run_masked(
            make_downwash_masked, lambda words, grid: kernel(tgt, srcs, words, grid, c, valid),
            lambda: sorted_dw.cols(tgt[0], tgt[1], tgt[2],
                                   src=None if src is None else (srcs[0], srcs[1], srcs[2])),
            mask, tgt.shape[1], dense, neighbor_cap, dense_fallback, valid)
        return res.to(x.dtype)

    def dw(pos):
        return dw_cols(pos[:, 0], pos[:, 1], pos[:, 2])

    dw.cols = dw_cols
    return dw


make_downwash_masked.overflows = 0
