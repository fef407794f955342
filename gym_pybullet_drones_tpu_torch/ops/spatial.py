"""Spatial orderings and exact tile-level live masks for the masked pair
passes K3 and K6 (port of the JAX ``ops/spatial.py``). Plain PyTorch: these
are tensor ops around the kernels, as they are in the JAX package.

The masked passes take the fleet in any permutation. Per pass, each tile's
axis-aligned bounding box is reduced from the coordinate columns, and each
(target tile, source tile) pair gets exact, value-based live bits:

* wake-live only if the source box can lie strictly above the target box
  (``dz > 0``, BaseAviary.py:798-811), the boxes' closest lateral approach
  is inside the 10 m cutoff (:801) and, with the cone cull, the Gaussian can
  produce a non-zero float32 value anywhere in the box pair (for small dz
  the wake's ``beta = c2 dz + c3`` makes it narrower than one drone spacing);
* contact-live only if the boxes approach within the collision diameter on
  every axis.

The masks are conservative (they never cull a contributing pair), so they
hold for any permutation; sorting by z or by a Morton key only gathers the
live pairs into few tiles.

Sizes. A tile is a block's worth of targets (``bt``) or sources (``bs``); a
sub-slice is one of up to 8 equal parts of a source tile, each with its own
live bit. All sizes are arguments; ``fit_block``, ``auto_bs``,
``subtile_count`` and ``auto_nbr_cap`` only give the callers' defaults.
"""

import torch

from gym_pybullet_drones_tpu_torch.ops._pairs import _div

# float32 exp underflow margin for the cone cull: exp(x) is subnormal below
# x = -87.3 and flushes to 0 below -103.3; alpha = K/dz^2 can multiply the
# Gaussian back up by at most ~exp(28) for dz >= 1e-6, so -0.5 q < -(103+60)
# guarantees an exact-zero float32 contribution, with a 2x margin on top.
# The bits are the JAX package's word for word. Where float32 beta is
# exactly 0 (dz = 0.6875 m for the CF2X) the JAX pair term puts beta^2 = 1, a
# Gaussian 1 m wide that a culled tile pair can hold; the port's pair term is
# 0 there (ops/downwash_pairs.wake_terms), so the cull is exact.
_CONE_Q = 2.0 * (103.3 + 60.0)

# Default source tile: what the masked kernels stage through shared memory at
# once (csrc/masked_pair_kernels.cu kStage).
_BS = 256
# Narrowest sub-slice worth a live bit of its own: one warp's worth of sources.
_MIN_SLICE = 32


def fit_block(b: int, n: int) -> int:
    """The largest tile size <= ``b`` that divides an axis of length ``n``
    (tiles never straddle the end of the fleet or of a binned cell)."""
    b = max(1, min(int(b), int(n)))
    while n % b != 0:
        b -= 1
    return b


def auto_bs(bs) -> int:
    """The source tile: the explicit value, or what the kernel stages at once."""
    return _BS if bs is None else bs


def subtile_count(bs: int) -> int:
    """Sub-slices per source tile, the default: the most equal parts, at most
    8 (one byte of live bits per section), that are at least a warp wide."""
    for sub in range(8, 0, -1):
        if bs % sub == 0 and bs // sub >= _MIN_SLICE:
            return sub
    return 1


def auto_nbr_cap(ns: int) -> int:
    """Default live-tile cap per target row: a quarter of the source tiles,
    at least 8. The list is (target tiles, cap) int32 in device memory; a row
    over the cap takes the pass's overflow branch, never drops a tile."""
    return int(max(8, ns // 4))


def tile_bounds(col: torch.Tensor, block: int):
    """(N,) column -> per-tile (min, max), each (N // block,)."""
    t = col.reshape(-1, block)
    return t.amin(dim=1), t.amax(dim=1)


def tile_bounds6(x, y, z, block: int, valid=None):
    """All six per-tile bounds in one reduction: (xmin, ymin, zmin, xmax,
    ymax, zmax), each (N // block,).

    ``valid``: optional (N,) bool column of a padded binned layout. Padding
    slots are left out of the bounds, so a tile of padding only gets an empty
    box (min = +1e30 > max = -1e30), which every box-gap test reads as
    infinitely far: the tile is dead in all masks. Mixed tiles get the exact
    bounds of their real members."""
    a = torch.stack([x, y, z, -x, -y, -z]).reshape(6, -1, block)
    if valid is not None:
        a = torch.where(valid.reshape(1, -1, block), a, 1e30)
    m = a.amin(dim=2)
    return m[0], m[1], m[2], -m[3], -m[4], -m[5]


def _box_gap(tmin, tmax, smin, smax):
    """Closest approach of target-tile and source-tile intervals: (nt, ns)."""
    return torch.clamp(torch.maximum(smin[None, :] - tmax[:, None],
                                     tmin[:, None] - smax[None, :]), min=0.0)


def _wake_live_from_bounds(tb, sb, params, cone: bool):
    """Wake-live (nt, ns) bool from target and source tile bounds."""
    txmin, tymin, tzmin, txmax, tymax, tzmax = tb
    sxmin, symin, szmin, sxmax, symax, szmax = sb
    gx = _box_gap(txmin, txmax, sxmin, sxmax)
    gy = _box_gap(tymin, tymax, symin, symax)
    dxy2_min = gx * gx + gy * gy
    dz_max = szmax[None, :] - tzmin[:, None]  # the largest source-above
    live = (dz_max > 0.0) & (dxy2_min < 100.0)
    if cone and params is not None:
        # |beta| is largest at an end of the tile pair's dz range (clipped to
        # the wake's dz > 0 domain).
        c2, c3 = float(params.dw_coeff_2), float(params.dw_coeff_3)
        dz_min = torch.clamp(szmin[None, :] - tzmax[:, None], min=0.0)
        dz_hi = torch.clamp(dz_max, min=0.0)
        beta_abs = torch.maximum(torch.abs(c2 * dz_min + c3), torch.abs(c2 * dz_hi + c3))
        live = live & (dxy2_min < _CONE_Q * beta_abs * beta_abs)
    return live


def _contact_live_from_bounds(tb, sb, min_dist: float):
    txmin, tymin, tzmin, txmax, tymax, tzmax = tb
    sxmin, symin, szmin, sxmax, symax, szmax = sb
    live = None
    for tmin, tmax, smin, smax in ((txmin, txmax, sxmin, sxmax), (tymin, tymax, symin, symax),
                                   (tzmin, tzmax, szmin, szmax)):
        g = _box_gap(tmin, tmax, smin, smax) < min_dist
        live = g if live is None else live & g
    return live


def _bounds_pair(x, y, z, bt, bs, src_cols=None, valid=None, src_valid=None):
    tb = tile_bounds6(x, y, z, bt, valid=valid)
    if src_cols is None and bt == bs:
        sb = tb
    else:
        xs, ys, zs = (x, y, z) if src_cols is None else src_cols
        sb = tile_bounds6(xs, ys, zs, bs, valid=src_valid if src_cols is not None else valid)
    return tb, sb


def wake_live_mask(x, y, z, bt, bs, params=None, cone=True, src_cols=None):
    """(nt, ns) int32 mask: 1 where a (bt-target, bs-source) tile pair can
    hold a wake-contributing pair. Exact for the reference's dz > 0 and 10 m
    lateral cutoff; the cone cull also drops tile pairs whose every pair's
    Gaussian underflows float32, exact zeros in the dense pass too."""
    tb, sb = _bounds_pair(x, y, z, bt, bs, src_cols)
    return _wake_live_from_bounds(tb, sb, params, cone).to(torch.int32)


def contact_live_mask(x, y, z, bt, bs, min_dist, src_cols=None):
    """(nt, ns) int32 mask: 1 where the tile boxes approach within
    ``min_dist`` on every axis (a superset of the sphere-contact condition)."""
    tb, sb = _bounds_pair(x, y, z, bt, bs, src_cols)
    return _contact_live_from_bounds(tb, sb, min_dist).to(torch.int32)


def packed_live_mask(x, y, z, bt, bs, min_dist, params=None, cone=True, src_cols=None):
    """Flat (nt*ns,) int32: bit 0 = wake-live, bit 1 = contact-live."""
    tb, sb = _bounds_pair(x, y, z, bt, bs, src_cols)
    wake = _wake_live_from_bounds(tb, sb, params, cone)
    contact = _contact_live_from_bounds(tb, sb, min_dist)
    return (wake.to(torch.int32) | (contact.to(torch.int32) << 1)).reshape(-1)


def subtile_packed_mask(x, y, z, bt, bs, min_dist=None, params=None, cone=True, valid=None,
                        src_cols=None, src_valid=None, sub=None):
    """Flat (nt*ns,) int32 with one live bit per sub-slice: bit k of a word
    is the wake-live bit of the k-th of ``sub`` equal slices of the source
    tile (bits 0-7), bit 8+k its contact-live bit (bits 8-15). The kernels
    evaluate live slices only.

    ``min_dist`` None: wake bits only (the downwash pass). ``valid``: the
    padding column of a binned layout (``tile_bounds6``); tiles and slices of
    padding only get empty boxes and go dead. ``src_cols``/``src_valid``:
    another source set (xs, ys, zs) with its own padding column, the
    rectangular form. ``sub`` defaults to ``subtile_count(bs)``."""
    sub = subtile_count(bs) if sub is None else sub
    sub_w = bs // sub
    tb, sb = _bounds_pair(x, y, z, bt, sub_w, src_cols=src_cols, valid=valid,
                          src_valid=src_valid)
    nt = tb[0].shape[0]
    bits = torch.arange(sub, dtype=torch.int32, device=x.device)
    wake = _wake_live_from_bounds(tb, sb, params, cone)  # (nt, ns * sub)
    packed = (wake.reshape(nt, -1, sub).to(torch.int32) << bits).sum(-1, dtype=torch.int32)
    if min_dist is not None:
        contact = _contact_live_from_bounds(tb, sb, min_dist)
        packed = packed | (contact.reshape(nt, -1, sub).to(torch.int32)
                           << (bits + 8)).sum(-1, dtype=torch.int32)
    return packed.reshape(-1)


def compact_live_tiles(packed, nt: int, ns: int, cap: int):
    """Compact a flat (nt*ns,) packed tile mask into each target row's list
    of live source tiles.

    Returns ``(packed_idx, count_max)``:

    * ``packed_idx``: (nt*cap,) int32, each ``source_tile << 16 | word``
      (the tile's 16-bit mask word; 0 marks a padding slot). Rows keep
      ascending source order, so a pass that walks the list sums in the
      order of the dense masked grid: the results are bit-identical.
    * ``count_max``: () int32, the largest live count of a row. Above
      ``cap`` the compaction dropped live tiles and the caller must take its
      overflow branch: correctness never depends on ``cap``."""
    m = packed.reshape(nt, ns).to(torch.int32)
    live = m != 0
    # The position of each live column within its row; dead and overflowing
    # columns all land in the scratch column `cap` of a (cap+1)-wide row,
    # which is cut away (so their duplicate indices never show).
    pos = torch.cumsum(live, dim=1) - 1
    pos = torch.where(live & (pos < cap), pos, cap)
    cols = torch.arange(ns, dtype=torch.int32, device=packed.device)[None, :]
    vals = (cols << 16) | (m & 0xFFFF)
    out = torch.zeros((nt, cap + 1), dtype=torch.int32, device=packed.device)
    out.scatter_(1, pos, vals)
    return out[:, :cap].reshape(-1), live.sum(dim=1).max().to(torch.int32)


def _spread_bits(v):
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_key(x, y, z, bits: int = 10):
    """Interleaved-bit (Morton, z-order curve) key per drone: (N,) int64
    holding the JAX package's 30-bit uint32 value. Coordinates are quantized
    to ``bits`` levels over the fleet's bounding box; sorting by the key makes
    runs of consecutive drones compact in all three axes."""
    lo = torch.stack([x.min(), y.min(), z.min()])
    hi = torch.stack([x.max(), y.max(), z.max()])
    top = (1 << bits) - 1
    scale = _div(float(top), torch.clamp(hi - lo, min=1e-9))
    q = [torch.clamp((c - lo[i]) * scale[i], 0, top).to(torch.int64)  # truncates toward zero
         for i, c in enumerate((x, y, z))]
    return _spread_bits(q[0]) | (_spread_bits(q[1]) << 1) | (_spread_bits(q[2]) << 2)


def sort_key(x, y, z, order: str):
    """Per-drone sort key for ``order`` in {"z", "morton"}."""
    if order == "z":
        return z
    if order == "morton":
        return morton_key(x, y, z)
    raise ValueError(f"unknown order {order!r}")
