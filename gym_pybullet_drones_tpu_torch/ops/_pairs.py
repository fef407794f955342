"""What the pair passes K2, K4 and K5 share: constants, the z-sort, the CUDA
launch and the chunked plain evaluation.

The three wrapper modules (``ops/downwash_pairs.py``, ``ops/collide_pairs.py``,
``ops/interact_pairs.py``) each hold one pass's pair arithmetic in plain
PyTorch and its kernel's wrapper; the kernels themselves are
``csrc/pair_kernels.cu``, one source built once for all three.

Layout at the kernel boundary: the target columns stacked into one contiguous
(rows, Nt) float32 tensor (x, y, z and, for contact, vx, vy, vz), the source
columns into (rows, Ns), and the outputs (outputs, Nt).
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.ops import _build

KERNEL = "pair_kernels"
BLOCK = 256  # targets per block and sources per tile (csrc/pair_kernels.cu kBlock)
# Blocks wanted in flight: a few waves over the H100's 132 SMs. The source
# split S is chosen so that target blocks x S reaches it where the tiles allow.
_WANTED_BLOCKS = 4 * 132
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


def source_split(nt: int, ns: int):
    """``(S, tiles_per_chunk)``: the source tiles split into S chunks of whole
    tiles, none empty, so that the target blocks times S fill the card."""
    n_tiles = max(1, math.ceil(ns / BLOCK))
    blocks = max(1, math.ceil(nt / BLOCK))
    want = max(1, min(n_tiles, math.ceil(_WANTED_BLOCKS / blocks)))
    per = n_tiles // want
    return math.ceil(n_tiles / per), per


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


def plain_rows(terms, tgt: torch.Tensor, src: torch.Tensor, n_out: int) -> torch.Tensor:
    """The plain evaluation of a pass: ``terms(t, s)`` maps target rows
    (rows, r, 1) and sources (rows, 1, Ns) to ``n_out`` (r, Ns) pair-term
    tensors, summed over the sources here, a chunk of target rows at a
    time. Returns (n_out, Nt)."""
    nt, ns = tgt.shape[1], src.shape[1]
    out = torch.empty((n_out, nt), dtype=torch.float32, device=tgt.device)
    step = max(1, _PLAIN_PAIRS // max(ns, 1))
    s = src[:, None, :]
    for r0 in range(0, nt, step):
        parts = terms(tgt[:, r0:r0 + step, None], s)
        for o, p in enumerate(parts):
            out[o, r0:r0 + step] = torch.sum(p, dim=1)
    return out


def _div(k: float, x: torch.Tensor) -> torch.Tensor:
    """``k / x`` for a host float ``k``, as one true division (PyTorch's
    ``k / x`` multiplies by ``x``'s reciprocal: two roundings)."""
    return torch.full((), k, dtype=x.dtype, device=x.device) / x


@functools.cache
def library():
    """The three C entry points of ``csrc/pair_kernels.cu``, built at first
    use and typed once."""
    lib = ctypes.CDLL(_build.build(KERNEL))
    fns = {}
    for name in ("downwash_pairs", "collide_pairs", "interact_pairs"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(name: str, tgt: torch.Tensor, src: torch.Tensor, c: PairConsts, n_out: int,
           cull: bool, square: bool, tiles=None) -> torch.Tensor:
    """Run the kernel ``name`` on stacked float32 CUDA columns and return its
    (n_out, Nt) output. ``tiles``, an int32 CUDA tensor of 2, receives the
    (block, tile) pairs each section evaluated. Raises on anything the kernel
    does not take and on a failed launch."""
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
    if tiles is not None and (tiles.device != tgt.device or tiles.dtype != torch.int32
                              or tiles.numel() != 2):
        raise ValueError(f"{name}'s tile counter is an int32 tensor of 2 on {tgt.device}")
    split, per = source_split(nt, ns)
    out = torch.empty((n_out, nt), dtype=torch.float32, device=tgt.device)
    partial = (torch.empty((split, n_out, nt), dtype=torch.float32, device=tgt.device)
               if split > 1 else out)
    host = (ctypes.c_float * len(c))(*c)
    fn = library()[name]
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = fn(tgt.data_ptr(), nt, src.data_ptr(), ns, int(cull), int(square),
                ctypes.addressof(host), len(host), split, per, partial.data_ptr(),
                out.data_ptr(), None if tiles is None else tiles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out
