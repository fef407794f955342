"""What the pair passes K2 to K6 share: constants, the z-sort, the CUDA
launches and the chunked plain evaluation.

The three wrapper modules (``ops/downwash_pairs.py``, ``ops/collide_pairs.py``,
``ops/interact_pairs.py``) each hold one pass's pair arithmetic in plain
PyTorch and its kernels' wrappers; the kernels themselves are
``csrc/wake_pair_kernels.cu`` (K2, K4, K5: one unit kernel over the work
units of ``pair_units``) and ``csrc/masked_pair_kernels.cu`` (the mask-gated
K3 and K6), which share their pair constants and terms through
``csrc/pair_terms.cuh``.

Layout at the kernel boundary: the target columns stacked into one contiguous
(rows, Nt) float32 tensor (x, y, z and, for contact, vx, vy, vz), the source
columns into (rows, Ns), and the outputs (outputs, Nt).
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.ops import _build

UNIT_KERNEL = "wake_pair_kernels"
MASKED_KERNEL = "masked_pair_kernels"
BLOCK = 256  # targets per block and sources per tile (csrc/wake_pair_kernels.cu)
# K2, K4 and K5: units a target block is cut into at most (one bit each of the
# kernel's 32-bit mask word).
UNIT_SLOTS = 32
# Fleet size above which the passes sort by z and cull tiles (the JAX
# package's measured crossover, ops/downwash_pallas.py Z_SORT_MIN_N).
Z_SORT_MIN_N = 8192
# Target rows per step of the plain versions: (rows, Ns) intermediates of at
# most 2^22 floats, so N = 16384 makes no (N, N) tensor.
_PLAIN_PAIRS = 1 << 22


class PairConsts(NamedTuple):
    """The passes' constants as host doubles, rounded once to float32 where
    the arithmetic meets them (the field order of the kernel's struct)."""

    K: float  # c1 * r_prop^2 / 16: the wake's alpha = K / dz^2
    c2: float
    c3: float
    min_dist: float  # 2 * collision_r
    min_dist2: float
    eps2: float
    max_push: float


def pair_consts(params, max_push: float = 0.01) -> PairConsts:
    """Constants of all three passes from a DroneParams record. Call it when a
    pass is built: ``float()`` of a CUDA tensor waits for the card."""
    min_dist = 2.0 * float(params.collision_r)
    eps = 1e-9
    return PairConsts(
        K=float(params.dw_coeff_1) * float(params.prop_radius) ** 2 / 16.0,
        c2=float(params.dw_coeff_2), c3=float(params.dw_coeff_3),
        min_dist=min_dist, min_dist2=min_dist * min_dist, eps2=eps * eps,
        max_push=float(max_push))


def use_z_sort(z_sort, nt: int, ns: int) -> bool:
    """``z_sort=None`` sorts when the larger side reaches ``Z_SORT_MIN_N``."""
    return max(nt, ns) >= Z_SORT_MIN_N if z_sort is None else bool(z_sort)


def pair_units(nt: int, ns: int, triangle: bool = False):
    """K2's, K4's and K5's work units: ``(units, per_unit)``, ``units`` an
    (n_units, 4) int32 array of (target block, first source tile, slot, units
    of the block) and ``per_unit`` the source tiles a unit spans at most.

    A block's tiles are cut into runs of ``per_unit`` = ceil(tiles /
    ``UNIT_SLOTS``) tiles, so a block has at most ``UNIT_SLOTS`` units; slot k
    is the block's k-th unit in tile order, and the kernel adds the units'
    partial sums in slot order. ``triangle`` (the square wake cull on a fleet
    sorted by z) lists only the tiles from the first one holding a source
    index above the block's first target, where every listed tile is live. A
    block with no tile still gets one empty unit, which writes its zeros. The
    shapes alone fix the list, and with it the order of the float32 sums."""
    n_tiles = math.ceil(ns / BLOCK)
    blocks = math.ceil(nt / BLOCK)
    per = max(1, math.ceil(n_tiles / UNIT_SLOTS))
    block = np.arange(blocks, dtype=np.int64)
    first = np.zeros(blocks, dtype=np.int64)
    if triangle:
        # Tile b's last source index, min(256 b + 255, ns - 1), exceeds the
        # block's first target 256 b unless tile b holds a single source.
        first = np.where(ns - 1 > BLOCK * block, block, block + 1)
        first = np.minimum(first, n_tiles)
    count = np.maximum(1, -(-(n_tiles - first) // per))
    start = np.cumsum(count) - count
    slot = np.arange(int(count.sum()), dtype=np.int64) - np.repeat(start, count)
    units = np.stack([np.repeat(block, count), np.repeat(first, count) + slot * per, slot,
                      np.repeat(count, count)], axis=1)
    return units.astype(np.int32), per


def check_device(built: torch.device, got: torch.device, what: str):
    """A pass built for ``built`` takes tensors of that device type only."""
    if got.type != built.type:
        raise ValueError(f"this {what} was built for {built}; its input is on {got}")
    if got.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} path for device {got}")


def stack(cols) -> torch.Tensor:
    """(rows, N) contiguous float32 from a sequence of (N,) columns."""
    return torch.stack([c.to(torch.float32) for c in cols])


def sort_by_z(cols: torch.Tensor):
    """``(cols[:, order], order)`` with ``order`` the stable ascending sort of
    row 2 (z), as ``jnp.argsort`` sorts."""
    order = torch.argsort(cols[2], stable=True)
    return cols[:, order], order


def unsort(res: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Scatter sorted results (outputs, N) back to the original order."""
    out = torch.empty_like(res)
    out[:, order] = res
    return out


def plain_rows(terms, tgt: torch.Tensor, src: torch.Tensor, n_out: int,
               gates=None, valid=None) -> torch.Tensor:
    """The plain evaluation of a pass: ``terms(t, s)`` maps target rows
    (rows, r, 1) and sources (rows, 1, Ns) to ``n_out`` (r, Ns) pair-term
    tensors, summed over the sources here, a chunk of target rows at a
    time. ``gates(r0, r1)``, for the masked passes, gives one (r, Ns) bool
    per output: a pair term counts only where its gate holds. ``valid``, a
    bool column of the targets, zeroes the rows where it is false. Returns
    (n_out, Nt)."""
    nt, ns = tgt.shape[1], src.shape[1]
    out = torch.empty((n_out, nt), dtype=torch.float32, device=tgt.device)
    step = max(1, _PLAIN_PAIRS // max(ns, 1))
    for r0 in range(0, nt, step):
        t, s = tgt[:, r0:r0 + step, None], src[:, None, :]
        if gates is None:
            parts = terms(t, s)
        else:
            # Only the sources some gate of this chunk lets through are evaluated.
            g = gates(r0, min(r0 + step, nt))
            keep = torch.stack(list({id(x): x for x in g}.values())).any(0).any(0).nonzero()[:, 0]
            parts = [torch.where(x[:, keep], p, 0.0) for x, p in zip(g, terms(t, s[:, :, keep]))]
        for o, p in enumerate(parts):
            out[o, r0:r0 + step] = torch.sum(p, dim=1)
    return out if valid is None else torch.where(valid, out, 0.0)


class TileGrid(NamedTuple):
    """The tiling a masked pass runs on: ``bt`` targets and ``bs`` sources a
    tile, ``sub`` sub-slices a source tile, and the words' form: dense
    (``row_len`` = source tiles, one word per tile pair) or ``compact``
    (``row_len`` = the cap, each word ``source tile << 16 | bits``)."""

    bt: int
    bs: int
    sub: int
    row_len: int
    compact: bool


def slice_gates(words: torch.Tensor, grid: TileGrid, nt: int, ns: int):
    """The words as the kernels read them: ``(wake, contact)``, each a
    (target tiles, source sub-slices) bool, bit k of a word gating the wake
    of its tile's k-th sub-slice and bit 8+k its contact. A compacted row is
    read up to its first zero word."""
    n_tt, n_st = nt // grid.bt, ns // grid.bs
    w = words.reshape(n_tt, grid.row_len).to(torch.int64)
    if grid.compact:
        listed = torch.cumprod((w != 0).to(torch.int64), dim=1) != 0
        dense = torch.zeros((n_tt, n_st + 1), dtype=torch.int64, device=w.device)
        dense.scatter_(1, torch.where(listed, w >> 16, n_st), w & 0xFFFF)
        w = dense[:, :n_st]
    bits = torch.arange(grid.sub, dtype=torch.int64, device=w.device)
    wake = ((w[:, :, None] >> bits) & 1) != 0
    contact = ((w[:, :, None] >> (bits + 8)) & 1) != 0
    return wake.reshape(n_tt, -1), contact.reshape(n_tt, -1)


def pair_gate(live: torch.Tensor, grid: TileGrid, r0: int, r1: int) -> torch.Tensor:
    """The (r1 - r0, Ns) bool gate of target rows r0..r1 from a (target
    tiles, source sub-slices) live matrix."""
    tiles = torch.arange(r0, r1, device=live.device) // grid.bt
    return torch.repeat_interleave(live[tiles], grid.bs // grid.sub, dim=1)


def _div(k: float, x: torch.Tensor) -> torch.Tensor:
    """``k / x`` for a host float ``k``, as one true division (PyTorch's
    ``k / x`` multiplies by ``x``'s reciprocal: two roundings)."""
    return torch.full((), k, dtype=x.dtype, device=x.device) / x


# Target warps times source ranks that a masked launch aims for: twice the
# warps an H100 holds at once (132 SMs x 64), since the padding skip leaves
# about half of a binned layout's warps idle. A constant, not the card's
# count, so that a pass's bits never depend on the card.
_MASKED_WARPS = 16384
MASKED_SPLITS = (1, 2, 4, 8)


def masked_split(nt: int, bt: int, bs: int, sub: int) -> int:
    """S, the source ranks of a masked launch (``csrc/masked_pair_kernels.cu``):
    the least of 1, 2, 4, 8 with which the target warps, ceil(bt / 32) a
    target tile, times S reach ``_MASKED_WARPS``, and that divides the
    sub-slice width ``bs / sub``. The shapes alone fix it, and with it the
    order of the float32 sums."""
    warps = (nt // bt) * math.ceil(bt / 32)
    split = 1
    while (split < MASKED_SPLITS[-1] and warps * split < _MASKED_WARPS
           and (bs // sub) % (2 * split) == 0):
        split *= 2
    return split


@functools.cache
def masked_library():
    """The two C entry points of ``csrc/masked_pair_kernels.cu``, built at
    first use and typed once."""
    lib = ctypes.CDLL(_build.build(MASKED_KERNEL))
    fns = {}
    for name in ("downwash_masked", "interact_masked"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    fn = lib.masked_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fns["masked_blocks_per_sm"] = fn
    return fns


def masked_blocks_per_sm(contact: bool, split: int) -> int:
    """Blocks of the K3 (``contact`` False) or K6 kernel with ``split``
    source ranks that one SM of the current card holds at once."""
    blocks = ctypes.c_int(0)
    rc = masked_library()["masked_blocks_per_sm"](int(contact), split, ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: cudaError {rc}")
    return blocks.value


def check_columns(name: str, tgt: torch.Tensor, src: torch.Tensor):
    """Raise unless targets and sources are contiguous (rows, N) float32
    columns on one CUDA device, few enough for 32-bit indices."""
    rows = tgt.shape[0]
    for what, x in (("targets", tgt), ("sources", src)):
        if x.device.type != "cuda" or x.device != tgt.device:
            raise ValueError(f"{name} takes CUDA tensors on one device; {what} are on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} computes in float32 only; {what} are {x.dtype}")
        if x.ndim != 2 or x.shape[0] != rows or not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous ({rows}, N) columns; {what} have shape "
                             f"{tuple(x.shape)}")
    nt, ns = tgt.shape[1], src.shape[1]
    if max(nt, ns) * 8 >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2^28 drones a side; got {nt} x {ns}")


def launch_masked(name: str, tgt: torch.Tensor, src: torch.Tensor, words: torch.Tensor,
                  grid: TileGrid, c: PairConsts, n_out: int, valid=None,
                  split=None) -> torch.Tensor:
    """Run the masked kernel ``name`` on stacked float32 CUDA columns and the
    int32 words of ``grid`` and return its (n_out, Nt) output. ``valid``, a
    bool column of the targets or None, marks the real ones: the others'
    rows come out 0. ``split``: the source ranks S, ``masked_split``'s
    choice by default. Raises on anything the kernel does not take and on a
    failed launch."""
    check_columns(name, tgt, src)
    nt, ns = tgt.shape[1], src.shape[1]
    if nt % grid.bt or ns % grid.bs or grid.bs % grid.sub or not 1 <= grid.sub <= 8:
        raise ValueError(f"{name}: tiles of {grid.bt} x {grid.bs} in {grid.sub} sub-slices do "
                         f"not divide {nt} targets x {ns} sources")
    if (words.device != tgt.device or words.dtype != torch.int32 or not words.is_contiguous()
            or words.numel() != (nt // grid.bt) * grid.row_len):
        raise ValueError(f"{name} takes {nt // grid.bt} x {grid.row_len} contiguous int32 words "
                         f"on {tgt.device}; got {tuple(words.shape)} {words.dtype} on "
                         f"{words.device}")
    if grid.compact and ns // grid.bs > 32768:
        raise ValueError(f"{name}: a compacted word indexes at most 32768 source tiles")
    if not grid.compact and grid.row_len != ns // grid.bs:
        raise ValueError(f"{name}: a dense row holds one word per source tile")
    if valid is not None and (valid.device != tgt.device or valid.dtype != torch.bool
                              or valid.shape != (nt,) or not valid.is_contiguous()):
        raise ValueError(f"{name} takes a contiguous bool valid column of {nt} targets on "
                         f"{tgt.device}; got {tuple(valid.shape)} {valid.dtype} on "
                         f"{valid.device}")
    split = masked_split(nt, grid.bt, grid.bs, grid.sub) if split is None else split
    if split not in MASKED_SPLITS or (grid.bs // grid.sub) % split:
        raise ValueError(f"{name}: the source ranks are one of {MASKED_SPLITS} that divides the "
                         f"sub-slice width {grid.bs // grid.sub}; got {split}")
    out = torch.empty((n_out, nt), dtype=torch.float32, device=tgt.device)
    host = (ctypes.c_float * len(c))(*c)
    fn = masked_library()[name]
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = fn(tgt.data_ptr(), nt, src.data_ptr(), ns, words.data_ptr(), grid.row_len,
                int(grid.compact), grid.bt, grid.bs, grid.sub,
                None if valid is None else valid.data_ptr(), split,
                ctypes.addressof(host), len(host), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out


@functools.cache
def unit_library():
    """The C entry points of ``csrc/wake_pair_kernels.cu`` (K2, K4, K5 and the
    occupancy query), built at first use and typed once."""
    lib = ctypes.CDLL(_build.build(UNIT_KERNEL))
    fns = {}
    for name in ("downwash_pairs", "collide_pairs", "interact_pairs"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    fn = lib.unit_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fns["unit_blocks_per_sm"] = fn
    return fns


def unit_blocks_per_sm(wake: bool, contact: bool) -> int:
    """Units of K2 (``wake`` alone), K4 (``contact`` alone) or K5 (both) that
    one SM of the current card holds at once."""
    blocks = ctypes.c_int(0)
    rc = unit_library()["unit_blocks_per_sm"](int(wake), int(contact), ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: cudaError {rc}")
    return blocks.value


def _check_tiles(name: str, tiles, device: torch.device):
    if tiles is not None and (tiles.device != device or tiles.dtype != torch.int32
                              or tiles.numel() != 2):
        raise ValueError(f"{name}'s tile counter is an int32 tensor of 2 on {device}")


def units_triangle(n_out: int, cull: bool, square: bool) -> bool:
    """Whether a unit pass lists the triangle's units alone: K2 (one output)
    with the square wake cull. K4 and K5 list every unit, sorted or not."""
    return cull and square and n_out == 1


@functools.cache
def unit_table(nt: int, ns: int, triangle: bool, device: torch.device):
    """``pair_units`` on ``device``: ``(units tensor, n_units, per_unit,
    scratch rows)``, copied there once per shape."""
    units, per = pair_units(nt, ns, triangle)
    return torch.as_tensor(units, device=device), len(units), per, int(units[:, 3].max())


def launch_units(name: str, tgt: torch.Tensor, src: torch.Tensor, c: PairConsts, n_out: int,
                 cull: bool, square: bool, tiles=None) -> torch.Tensor:
    """Run K2, K4 or K5 (``name``, ``csrc/wake_pair_kernels.cu``) on stacked
    float32 CUDA columns and return its (n_out, Nt) output, over the work
    units of ``pair_units`` (the live ones alone where K2's square wake cull
    holds): one launch after one memset. ``tiles``, an int32 CUDA tensor of
    2, receives the (block, tile) pairs each section evaluated. Raises on
    anything the kernel does not take and on a failed launch."""
    check_columns(name, tgt, src)
    _check_tiles(name, tiles, tgt.device)
    nt, ns = tgt.shape[1], src.shape[1]
    out = torch.empty((n_out, nt), dtype=torch.float32, device=tgt.device)
    if nt == 0:
        return out
    units, n_units, per, rows = unit_table(nt, ns, units_triangle(n_out, cull, square),
                                           tgt.device)
    scratch = torch.empty((rows, n_out, nt), dtype=torch.float32, device=tgt.device)
    # The units' counts, one word per target block, zeroed by the launcher.
    sync = torch.empty(math.ceil(nt / BLOCK), dtype=torch.int64, device=tgt.device)
    host = (ctypes.c_float * len(c))(*c)
    fn = unit_library()[name]
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = fn(tgt.data_ptr(), nt, src.data_ptr(), ns, int(cull), int(square),
                ctypes.addressof(host), len(host), units.data_ptr(), n_units, per, rows,
                scratch.data_ptr(), sync.data_ptr(), out.data_ptr(),
                None if tiles is None else tiles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out
