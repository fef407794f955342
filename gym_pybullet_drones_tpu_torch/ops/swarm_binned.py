"""The binned coupled-swarm backend: the fleet in padded xy cells, the pair
passes K3 and K6 over each cell's few neighbour cells (port of the JAX
``ops/swarm_binned.py``, its single-device form).

The layout does the culling:

* the footprint is cut into an (nx, ny) grid of square cells (correctness
  never depends on ``cell_size``: the masks are exact, value-based, and
  computed from the actual coordinates);
* each cell owns a block of ``cap`` slots of the state columns; its drones
  fill the first slots sorted by z, the rest is padding;
* the pair passes' tiles are cell blocks (or equal parts of one), so a tile's
  bounding box is one cell's real extent: ``ops/spatial.py``'s masks with
  ``valid``-aware bounds kill every tile pair whose cells lie further apart
  than the wake's 10 m cutoff, and the sub-slice bits kill slices of padding,
  so spare capacity costs next to no pair work;
* the compacted live lists (``neighbor_cap``) then hold only each cell's
  ring of neighbour tiles: the pair work is O(N k) at a fixed density.

Padding slots hold inert sentinels (position (0, 0, -1e9), identity
quaternion, zero velocity): z = -1e9 fails the wake's dz > 0 against any
real drone and puts contact distances near 1e18, and coincident padding
pairs fail the passes' own d2 > eps^2 and dz > 0 guards. Padding rows are
frozen back to their sentinels right after every substep, BEFORE the pair
pass (the substep's ground clamp would otherwise park them at (0, 0, z_min),
where they would push real drones landed near the origin), and again after
the pair updates.

A layout overflow never drops a drone: if a cell holds more than ``cap``
drones at a rebin, the whole (cell, z)-sorted fleet is packed densely into
the first N slots instead. The masks stay exact for any permutation; only
the culling loosens. A row of live tiles over ``neighbor_cap`` takes the
masked passes' overflow branch, the z-sorted dense kernels.

Semantics match ``ops/swarm_soa.make_sorted_swarm``: the same substep chain
and the same carried wake.

With ``mesh`` (a ``runtime/mesh.Mesh``) the slot axis is split over the
ranks in whole-cell slabs. The substeps and the target side of each pair
pass run on the rank's slab; the sources come through one all-gather per
pair pass into K3's and K6's rectangular ``src`` / ``src_valid`` entries.
The rebin is a global argsort: every rank gathers the whole layout, rebins
it the same way and keeps its slab.
"""

import math

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import make_downwash_masked
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import make_interact_masked
from gym_pybullet_drones_tpu_torch.ops.spatial import fit_block
from gym_pybullet_drones_tpu_torch.ops.swarm_soa import (
    SWARM_KEYS,
    check_step_device,
    swarm_soa_from_kin,
    swarm_soa_to_kin,
)
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import (
    _div,
    motor_wrench_soa,
    physics_consts,
    physics_substep_soa,
)

_ZPAD = -1e9  # the padding slots' z: far below any altitude flown

# The state columns and their padding sentinels.
_SENT = dict(px=0.0, py=0.0, pz=_ZPAD, qx=0.0, qy=0.0, qz=0.0, qw=1.0,
             vx=0.0, vy=0.0, vz=0.0, wx=0.0, wy=0.0, wz=0.0, mag=0.0)
_COLS = tuple(_SENT)  # SWARM_KEYS and the carried wake
assert _COLS[:-1] == SWARM_KEYS

def binned_geometry(pos, occ_target=256, headroom=1.25, max_cap=2048, min_cell=10.0, cell=None):
    """Host-side helper: pick ``(cell_size, nx, ny, cap)`` for an initial
    fleet.

    Aims for about ``occ_target`` drones per cell column (cells span all z:
    the wake's dz is unbounded, only xy is cut at 10 m); the capacity is the
    largest occupancy times ``headroom``, rounded up to a multiple of 128.
    Cells are clamped at ``min_cell``, the 10 m wake cutoff: a smaller cell
    widens the live ring from 3 x 3 to 5 x 5 tiles. A choice of speed only:
    any (cell_size, nx, ny, cap) is correct.

    ``cell`` pins the cell size; the grid and the cap are computed for it."""
    p = np.asarray(pos)
    x, y = p[:, 0], p[:, 1]
    n = x.shape[0]
    ex = max(float(x.max() - x.min()), 1e-6)
    ey = max(float(y.max() - y.min()), 1e-6)
    s = float(cell) if cell is not None else max(math.sqrt(ex * ey * occ_target / n), min_cell)
    nx = int(np.ceil(ex / s)) + 1
    ny = int(np.ceil(ey / s)) + 1
    cx = np.clip(np.floor((x - x.min()) / s).astype(np.int64), 0, nx - 1)
    cy = np.clip(np.floor((y - y.min()) / s).astype(np.int64), 0, ny - 1)
    occ = int(np.bincount(cx * ny + cy, minlength=nx * ny).max())
    cap = min(max_cap, int(np.ceil(occ * headroom / 128)) * 128)
    cap = max(cap, 128)
    while nx * ny * cap < n:  # the dense overflow layout must fit the whole fleet
        cap += 128
    return float(s), nx, ny, cap


def shard_binned_state(mesh, s, axis: str = "env"):
    """This rank's slab of a binned state from ``init``: the slot-axis
    columns split over ``mesh``, the step counter ``t`` kept whole."""
    from gym_pybullet_drones_tpu_torch.runtime.mesh import env_sharding

    sh = env_sharding(mesh, axis)
    return {k: v if k == "t" else v[sh.rows(v.shape[0])] for k, v in s.items()}


def make_binned_swarm(params: DroneParams, dt, n_substeps: int, collisions: bool = False,
                      cell_size: float = 10.0, nx: int = 8, ny: int = 8, cap: int = 256,
                      resort_every: int = 4, cone: bool = True, neighbor_cap=None, bt=None,
                      bs=None, mesh=None, axis: str = "env", device=None):
    """The binned cell-list coupled-swarm loop. Returns ``(init, step,
    export)`` with the contract of ``ops/swarm_soa.make_sorted_swarm`` (rpm
    columns in the drones' original order; ``export`` scatters back).

    ``cap`` slots per cell; ``bt``/``bs`` cut the cell block into target and
    source tiles, both clamped to divisors of ``cap`` so that no tile
    straddles two cells (its box would span both and loosen the masks). Both
    default to the whole cell: the kernel cuts a target tile into blocks
    itself. ``neighbor_cap`` live source tiles are kept per target row
    (default: twice the wake ring (2 ceil(10 / cell) + 1)^2 times cap // bs);
    a row over it takes the z-sorted dense passes, never drops a tile.

    ``mesh``/``axis``: split the slot axis over the ranks (``nx * ny`` must
    divide over them). ``init`` still takes and returns the whole fleet;
    ``shard_binned_state`` keeps a rank's slab of it, ``step`` advances the
    slab (rpm columns whole, in the drones' order) and ``export`` gathers the
    whole fleet back on every rank. The result equals the single-process
    loop's at equal tiles. ``device=None`` means the CUDA card, whose kernels
    are built here."""
    device = resolve_device(device)
    ncells = nx * ny
    nslots = ncells * cap
    if mesh is not None:
        from gym_pybullet_drones_tpu_torch.runtime.mesh import all_gather, env_sharding

        if ncells % mesh.shape[axis] != 0:
            raise ValueError(f"cell count {nx}x{ny} must divide over the {mesh.shape[axis]} "
                             f"ranks of the {axis!r} mesh axis (whole-cell slabs per rank)")
        slab = env_sharding(mesh, axis).rows(nslots)
        gather = lambda x: all_gather(mesh, x)
    bs = cap if bs is None else fit_block(bs, cap)
    bt = cap if bt is None else fit_block(bt, cap)
    if neighbor_cap is None:
        ring = 2 * int(math.ceil(10.0 / cell_size)) + 1
        neighbor_cap = min(nslots // bs, 2 * ring * ring * (cap // bs))
    c = physics_consts(params)
    opts = dict(bt=bt, bs=bs, cone=cone, neighbor_cap=neighbor_cap, dense_fallback=False,
                device=device)
    dw_m = make_downwash_masked(params, **opts)
    ia_m = make_interact_masked(params, **opts) if collisions else None

    def _layout(ox, oy, oz):
        """Original-order coordinate columns -> (ids, valid) slot arrays.

        ids[slot] is the original index of the slot's drone (N for padding;
        int64, what PyTorch indexes with). A cell's drones fill its block
        sorted by z, so sub-slices are z slabs and their live bits cull along
        z too. If a cell overflows ``cap``, the whole fleet is packed into the
        first N slots in (cell, z) order instead: no drone is dropped and the
        order stays coherent. The choice stays on the device."""
        n = ox.shape[0]
        cx = torch.clamp(torch.floor(_div(ox - ox.min(), cell_size)), 0, nx - 1)
        cy = torch.clamp(torch.floor(_div(oy - oy.min(), cell_size)), 0, ny - 1)
        cell = cx.to(torch.int64) * ny + cy.to(torch.int64)
        o1 = torch.argsort(oz, stable=True)
        o2 = torch.argsort(cell[o1], stable=True)  # stable: the z order is kept
        perm = o1[o2]
        cell_p = cell[perm]
        counts = torch.bincount(cell, minlength=ncells)
        starts = torch.cumsum(counts, 0) - counts
        arange = torch.arange(n, device=ox.device)
        rank = arange - starts[cell_p]
        overflow = counts.max() > cap
        # Where a cell overflows, cell_p * cap + rank may leave the layout; the
        # dense packing is selected for the whole fleet then.
        slot = torch.where(overflow, arange, cell_p * cap + rank)
        ids = torch.full((nslots,), n, dtype=torch.int64, device=ox.device)
        ids[slot] = perm
        return ids, ids < n

    def _freeze(cols, valid):
        """Pin padding rows to their sentinels after a substep or a pair pass."""
        return {k: torch.where(valid, v, _SENT[k]) for k, v in cols.items()}

    def _gather(orig, ids, valid):
        """Original-order column dict -> sentinel-padded slot columns."""
        safe = torch.clamp(ids, 0, orig["px"].shape[0] - 1)
        return _freeze({k: v[safe] for k, v in orig.items()}, valid)

    def _unbin(s, n):
        """Slot columns -> original-order columns, padding dropped. Padding
        slots hold ids == n: they all write the spare row n of an (n + 1,)
        buffer, which is cut away; every real slot writes its own row once."""
        orig = {}
        for k in _COLS:
            buf = torch.zeros((n + 1,), dtype=s[k].dtype, device=s[k].device)
            buf[s["ids"]] = s[k]
            orig[k] = buf[:n]
        return orig

    def _rebin(s, n):
        orig = _unbin(s, n)
        ids, valid = _layout(orig["px"], orig["py"], orig["pz"])
        out = _gather(orig, ids, valid)
        out.update(ids=ids, valid=valid, t=s["t"])
        return out

    def init(kin):
        orig = swarm_soa_from_kin(kin)
        check_step_device(device, orig)
        n = orig["px"].shape[0]
        if nslots < n:
            raise ValueError(f"binned layout too small: {nslots} slots < {n} drones")
        orig["mag"] = torch.zeros_like(orig["px"])
        ids, valid = _layout(orig["px"], orig["py"], orig["pz"])
        s = _gather(orig, ids, valid)
        s.update(ids=ids, valid=valid, t=0)
        s["mag"] = torch.where(valid, dw_m.cols(s["px"], s["py"], s["pz"], valid=valid), 0.0)
        return s

    def _substeps(cols, valid, wrench):
        """The substep chain over one rpm period. Sharded, the pair passes'
        sources are the gathered slot columns of every rank."""
        src = src_valid = None
        if mesh is not None:
            src_valid = gather(valid)
        src_keys = ("px", "py", "pz", "vx", "vy", "vz") if collisions else ("px", "py", "pz")
        for _ in range(n_substeps):
            stepped = physics_substep_soa(c, dt, *(cols[k] for k in SWARM_KEYS), wrench,
                                          fz_body=cols["mag"])
            cols.update(zip(SWARM_KEYS, stepped))
            # Freeze BEFORE the pair pass: the substep's plane-contact clamp
            # snaps padding rows from pz = -1e9 to z_min, which would turn
            # every padding slot of a live tile into a phantom drone resting
            # at the world origin. A real drone landed within min_dist of
            # (0, 0, z_min) would be pushed by it: the valid-aware tile bounds
            # leave padding out of the boxes, but the pass still evaluates the
            # padding slots of live tiles with only its per-pair guards, and
            # (0, 0, z_min) passes them.
            cols = _freeze(cols, valid)
            if mesh is not None:
                src = tuple(gather(cols[k]) for k in src_keys)
            if collisions:
                mag, dp, dv = ia_m.cols(cols["px"], cols["py"], cols["pz"],
                                        cols["vx"], cols["vy"], cols["vz"], valid=valid,
                                        src=src, src_valid=src_valid)
                cols["mag"] = mag
                for k, d in zip(("px", "py", "pz", "vx", "vy", "vz"), dp + dv):
                    cols[k] = cols[k] + d
            else:
                cols["mag"] = dw_m.cols(cols["px"], cols["py"], cols["pz"], valid=valid,
                                        src=src, src_valid=src_valid)
            cols = _freeze(cols, valid)
        return cols

    def _whole(s):
        """The whole layout from every rank's slab."""
        return {k: v if k == "t" else gather(v) for k, v in s.items()}

    def step(s, rpm_cols):
        check_step_device(device, s)
        n = rpm_cols[0].shape[0]
        if s["t"] % resort_every == 0:
            if mesh is None:
                s = _rebin(s, n)
            else:  # a global permutation: the same on every rank, then the slab
                s = {k: v if k == "t" else v[slab] for k, v in _rebin(_whole(s), n).items()}
        ids, valid = s["ids"], s["valid"]
        safe = torch.clamp(ids, 0, n - 1)  # padding rows are frozen anyway
        wrench = motor_wrench_soa(c, [r[safe] for r in rpm_cols])
        out = _substeps({k: s[k] for k in _COLS}, valid, wrench)
        out.update(ids=ids, valid=valid, t=s["t"] + 1)
        return out

    def export(s, template):
        if mesh is not None:
            s = _whole(s)
        orig = _unbin(s, template.pos.shape[0])
        orig.pop("mag")
        return swarm_soa_to_kin(orig, template)

    return init, step, export
