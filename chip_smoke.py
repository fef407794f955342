#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without them
or on any failed check. Imports nothing of JAX or of the JAX package.

Phases, one or more lines each:
  1. the device, and nvidia-smi's name and power limit;
  2. build every kernel, one nvcc per source started together (K1,
     csrc/velocity_rollout.cu; K2, K4, K5, csrc/pair_kernels.cu), and print
     ptxas's registers and spills;
  3. hold K1 against its plain PyTorch version on the card at E = 4096
     (batch_reset state, formation actions): T = 8 and T = 240 (5 s) at atol
     1e-5 on every column, and at T = 240 finiteness and the ground clamp;
  4. the main path through the user entry points, launch counts reset just
     before and read just after: batch_reset -> soa_from_state ->
     make_velocity_rollout (K1) -> soa_to_state -> compute_obs, at E = 4096
     and T = 240; then make_batched_step on the card against the CPU for 24
     steps (tests/test_soa.py's limits over the first 12);
  5. K1's time with CUDA events (E = 4096, T = 4800, after a warm-up, 5
     repeats), the plain version's time for the same T, and K1's bound;
  6. the pair kernels K2, K4, K5 against their plain versions on the card,
     on tests/test_soa.py's cloud scaled to N = 4096 and 16384 with
     overlapping pairs: square with the z-sorted culls off and on, K2 and K4
     rectangular (4096 targets x 16384 sources); the wake per drone at rtol
     1e-4 plus atol 1e-6 (every wake term has one sign, so a reordered
     float32 sum errs relative to the sum itself), positions and velocities
     after the contact deltas at atol 1e-6; contacts fired, the culls
     skipped tiles, launch counts; the whole z-sorted passes against the
     unsorted ones;
  7. the coupled swarm's main path through the user entry points:
     make_swarm_physics(init_pos=...) ("auto" -> "soa") on
     scripts/collide_bench.py's lattice (0.5 m pitch, +-0.1 m jitter) at
     N = 4096 (unsorted) and 16384 (z-sorted), collisions off and on, 48
     control steps each, launch counts reset before and read after each
     run (finite; z at or above the ground clamp; with collisions, the
     clamp held before the last contact pass, and no drone sits deeper
     below it than max_push times the partners it had in that pass); then
     one control step of the kernel path on the card against the plain
     path on the CPU, and make_big_swarm_physics against the SoA step, at
     N = 4096, on unique-z towers and, with collisions, co-planar contact
     pairs beside such towers (so that K5's wake moves what is compared);
  8. times with CUDA events: each pair kernel per pass (N = 4096 and 16384,
     culls off and on), its plain version and its bound; the swarm step per
     control step, split into the pair kernels and the rest, and the card's
     idle share (1 - busy time under torch.profiler / event time);
  9. one JSON line of kernels, the nvidia-smi line, and the result line.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state
from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_VELOCITY,
    AviaryConfig,
    build_ctrl_params,
    build_params,
    compute_obs,
)
from gym_pybullet_drones_tpu_torch.envs.spec import Physics
from gym_pybullet_drones_tpu_torch.ops import _build, _pairs, collide_pairs
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import (
    collide_cuda,
    collide_plain,
    contact_terms,
    make_collide,
)
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import (
    downwash_cuda,
    downwash_plain,
    make_downwash,
    wake_terms,
)
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import (
    interact_cuda,
    interact_plain,
    make_interact,
)
from gym_pybullet_drones_tpu_torch.ops.swarm_soa import (
    make_swarm_step_soa,
    swarm_soa_from_kin,
    swarm_soa_to_kin,
)
from gym_pybullet_drones_tpu_torch.ops.velocity_rollout import (
    KERNEL,
    make_velocity_rollout,
    velocity_rollout_cuda,
    velocity_rollout_plain,
)
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import (
    SOA_KEYS,
    soa_consts,
    soa_from_state,
    soa_to_state,
    motor_wrench_soa,
    physics_substep_soa,
    velocity_step_soa,
    velocity_target,
)
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step
from gym_pybullet_drones_tpu_torch.runtime.swarm import (
    make_big_swarm_physics,
    make_swarm_physics,
    select_swarm_backend,
)

E = 4096
T_SHORT, T_LONG, T_TIME = 8, 240, 4800
REPEATS = 5
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
# The float32 peak counts a fused multiply-add as two operations; K1 is built
# with -fmad=false, so its own ceiling is half this rate. The bound below is
# that of the function, for a kernel that fuses every multiply-add pair.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Elementwise ops counted as one operation per element; clamp counts one per
# bound it applies. Transcendentals (sin, cos, atan2, asin, sqrt) count one
# each, though each costs many instructions on the card.
_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "sin", "cos",
        "atan2", "asin", "exp", "rsqrt", "maximum", "minimum", "gt", "lt", "ge", "le",
        "where", "bitwise_and", "logical_and"}
# The coupled swarm (phases 6-8): sizes, the pair kernels, and the control
# steps of the main path.
SWARM_N = (4096, 16384)
SWARM_T = 48
PAIRS = {  # name -> (rows in, outputs, kernel, plain version, TPU kernel)
    "K2": (3, 1, downwash_cuda, downwash_plain, "gym_pybullet_drones_tpu/ops/downwash_pallas.py:140"),
    "K4": (6, 6, collide_cuda, collide_plain, "gym_pybullet_drones_tpu/ops/collide_pallas.py:145"),
    "K5": (6, 7, interact_cuda, None, "gym_pybullet_drones_tpu/ops/interact_pallas.py:160"),
}
# tests/test_soa.py:187-196 (and tests/test_torch_swarm.py)
SWARM_LIMITS = dict(pos=1e-5, vel=1e-4, quat=1e-6, ang_v=1e-4, rpy_rates=1e-4)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def formation_actions(n, device):
    """Unit compass headings at a quarter of the speed limit (bench.py:47-52)."""
    angles = np.arange(n, dtype=np.float64) * (2.0 * np.pi / n)
    cols = dict(ax=np.cos(angles), ay=np.sin(angles), az=np.zeros(n),
                amag=np.full(n, 0.25))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in cols.items()}


class _OpCount(TorchDispatchMode):
    """Counts elementwise operations per element (run on one-env tensors)."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _OPS:
            self.ops[name] += 1
        elif name == "clamp":
            bounds = list(args[1:3]) + [kwargs.get("min"), kwargs.get("max")]
            self.ops[name] += sum(b is not None for b in bounds)
        return func(*args, **kwargs)


def _count(fn):
    with _OpCount() as counter:
        fn()
    return counter.ops


def ops_per_env(consts, cfg, sl, num_steps):
    """Operations one env needs for a launch of ``num_steps`` control steps,
    counted on the plain version's pieces without repeating loop-invariant
    work: the action-only velocity target once per launch; per control step
    the DSLPID pipeline and the motor wrench once (``velocity_step_soa`` with
    no substeps, less the target), then ``steps_per_ctrl`` substeps."""
    one = {k: torch.zeros(1) for k in SOA_KEYS}
    one["qw"] = torch.ones(1)
    act = formation_actions(1, "cpu")
    a = (act["ax"], act["ay"], act["az"], act["amag"])
    target = _count(lambda: velocity_target(sl, *a))
    control = _count(lambda: velocity_step_soa(consts, cfg.ctrl_timestep, cfg.pyb_timestep,
                                               0, sl, one, *a)) - target
    wrench = motor_wrench_soa(consts, [one[k] for k in ("r0", "r1", "r2", "r3")])
    substep = _count(lambda: physics_substep_soa(
        consts, cfg.pyb_timestep, *(one[k] for k in SOA_KEYS[:13]), wrench))
    per_step = control + Counter({k: cfg.steps_per_ctrl * v for k, v in substep.items()})
    parts = {"target": target.total(), "control": control.total(),
             "substep": substep.total(), "per_step": per_step.total()}
    return target.total() + num_steps * per_step.total(), parts


def event_ms(fn, repeats):
    times = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def pair_cloud(device, n, n_src=None, seed=11):
    """tests/test_soa.py's cloud (4 x 4 x 1.5 m for 1024 drones), scaled to
    keep its density at N, with an overlapping pair every 64 drones; stacked
    (6, N) float32: x, y, z, vx, vy, vz. With ``n_src`` the sources are that
    many drones and the targets their first ``n``, moved 1 cm."""
    rng = np.random.RandomState(seed)
    m = n if n_src is None else n_src
    scale = (m / 1024) ** (1 / 3)
    pos = rng.uniform(-1, 1, (m, 3)) * np.array([4, 4, 1.5]) * scale + [0, 0, 2.0]
    pos[1::64] = pos[0::64] + [0.08, 0.0, 0.05]
    vel = rng.uniform(-0.5, 0.5, (m, 3))
    src = torch.as_tensor(np.concatenate([pos, vel], 1).T.copy(), dtype=torch.float32,
                          device=device)
    tgt = src if n_src is None else (src[:, :n] + 0.01).contiguous()
    return tgt, src


def pair_pass(name, tgt, src, c, cull, square, plain=False, tiles=None):
    """One pass of the kernel ``name`` (or its plain version) on stacked
    columns: (outputs, Nt)."""
    rows, n_out, kernel, plain_fn, _ = PAIRS[name]
    t = tgt[:rows].contiguous()
    s = t if square else src[:rows].contiguous()
    if name == "K5":
        out = interact_plain(t, c) if plain else kernel(t, c, cull=cull, tiles=tiles)
    elif plain:
        out = plain_fn(t, s, c)
    else:
        out = kernel(t, s, c, cull=cull, square=square, tiles=tiles)
    return out.reshape(n_out, -1)


WAKE_RTOL, WAKE_ATOL = 1e-4, 1e-6


def wake_report(name, w, wp):
    """Holds the wake ``w`` against ``wp`` per drone at rtol 1e-4 plus atol
    1e-6: every wake term has one sign, so summing them in another order
    errs relative to the sum itself. Returns a line with the worst share of
    the limit and the median and largest |wake| beside it."""
    share = (w - wp).abs() / (WAKE_ATOL + WAKE_RTOL * wp.abs())
    worst = float(share.max())
    if not worst <= 1.0:
        i = int(share.argmax())
        fail(f"{name}'s wake disagrees beyond rtol {WAKE_RTOL} plus atol {WAKE_ATOL}: drone {i} "
             f"has {float(w[i])!r} against {float(wp[i])!r}")
    mag = wp.abs()
    return (f"wake within {worst:.3g} of its limit (rtol {WAKE_RTOL} + atol {WAKE_ATOL}; "
            f"|wake| median {float(mag.median()):.3g}, max {float(mag.max()):.3g})")


def pair_error(name, got, want, tgt):
    """``(max |kernel - plain| over the outputs, the wake's report)``; fails
    beyond the wake's limit above or, after the contact deltas, beyond atol
    1e-6 (tests/test_torch_pairs.py)."""
    o, note = 0, ""
    if name in ("K2", "K5"):
        note = wake_report(name, got[0], want[0])
        o = 1
    if name in ("K4", "K5"):
        base = tgt[:6]
        gap = float(((base + got[o:]) - (base + want[o:])).abs().max())
        if not gap <= 1e-6:
            fail(f"{name}'s positions or velocities after the deltas differ by {gap:.3g} > 1e-6")
        if not float(got[o:o + 3].abs().max()) > 0:
            fail(f"{name}: no contact fired on a cloud with overlapping pairs")
    return float((got - want).abs().max()), note


def as_rows(res):
    """A pass's result (``dw.cols``, ``resolve.cols`` or ``interact.cols``)
    as one (outputs, N) tensor: the wake, then dpx ... dvz."""
    if isinstance(res, torch.Tensor):
        return res[None]
    head = [res[0]] if len(res) == 3 else []
    return torch.stack(head + list(res[-2]) + list(res[-1]))


def pair_launches():
    return {name: PAIRS[name][2].launches for name in PAIRS}


def reset_pair_launches():
    for name in PAIRS:
        PAIRS[name][2].launches = 0


def ops_per_pair(c):
    """Operations per pair, counted on the plain pair terms (1 x 1 inputs),
    plus one accumulating add per output."""
    t, s = torch.ones((6, 1, 1)), torch.full((6, 1, 1), 0.75)
    wake = _count(lambda: wake_terms(t, s, c)).total() + 1
    contact = _count(lambda: contact_terms(t, s, c)).total() + 6
    return {"K2": wake, "K4": contact, "K5": wake + contact}


def lattice(n, pitch=0.5, seed=0):
    """scripts/collide_bench.py:34-40: a cubic lattice, +-0.2 pitch jitter,
    lifted by 1 m."""
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1 / 3))) + 1
    g = np.stack(np.meshgrid(*[np.arange(side) * pitch] * 3), -1).reshape(-1, 3)[:n]
    return (g + rng.uniform(-0.2 * pitch, 0.2 * pitch, g.shape) + [0, 0, 1.0]).astype(np.float32)


def towers(n, seed=11):
    """tests/test_collisions.py:256's unique-z towers (8 drones 0.3 m apart
    in xy cells 1 m apart), 1 m wide rows of 32 cells, lateral velocities:
    wake-active and well conditioned. The jittered lattice is not: its
    same-layer pairs sit at |dz| < 0.2 m with 0.5 m of lateral gap, where
    the order of the float32 wake sums alone moves velocities by 1e-3 m/s
    within one control step (the repo's parity notes)."""
    rng = np.random.RandomState(seed)
    k = np.arange(n)
    cell = k // 8
    pos = np.stack([(cell % 32) * 1.0, (cell // 32) * 1.0,
                    1.0 + (k % 8) * 0.3 + cell * 0.3 / (n // 8)], -1)
    vel = rng.uniform(-0.2, 0.2, (n, 3))
    vel[:, 2] = 0.0
    return pos.astype(np.float32), vel.astype(np.float32)


def coplanar_pairs(n, seed=7):
    """tests/test_collisions.py:295's co-planar layer of overlapping pairs
    (dz = 0 keeps the wake off between partners), n // 2 grid points."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(64) * 0.5, np.arange(n // 128) * 0.5),
                    -1).reshape(-1, 2)
    xy = np.concatenate([base, base + [0.1, 0.0]], axis=0)
    pos = np.concatenate([xy, np.full((n, 1), 1.0)], 1)
    vel = rng.uniform(-0.2, 0.2, (n, 3))
    vel[:, 2] = 0.0
    return pos.astype(np.float32), vel.astype(np.float32)


def contact_fleet(n):
    """Co-planar contact pairs (n / 2 drones) beside unique-z towers (n / 2),
    45 m apart in x, beyond the wake's 10 m cutoff: every pair in contact
    and every tower under its own wake, so that the contact step's K5 pass
    computes both and both move the state."""
    pairs, towers_ = coplanar_pairs(n // 2), towers(n - n // 2)
    shift = np.array([45.0, 0.0, 0.0], np.float32)
    return (np.concatenate([pairs[0], towers_[0] + shift]),
            np.concatenate([pairs[1], towers_[1]]))


@contextlib.contextmanager
def last_launch(kernel):
    """Records the stacked target columns and the output of the last launch
    of the pair kernel ``kernel`` (by wrapping ``_pairs.launch``; the
    launch counters are the kernel wrappers' and stay as they are)."""
    seen, launch = {}, _pairs.launch

    def recording(name, tgt, *args, **kwargs):
        out = launch(name, tgt, *args, **kwargs)
        if name == kernel:
            seen.update(tgt=tgt, out=out)
        return out

    _pairs.launch = recording
    try:
        yield seen
    finally:
        _pairs.launch = launch


def contact_partners(pos, c):
    """Per drone, the other drones within min_dist of it (with 1e-4 of
    slack on min_dist^2, so the count never falls short of the kernel's);
    ``pos`` (3, N) on the card, in row chunks."""
    n = pos.shape[1]
    out = torch.empty(n, dtype=torch.int64, device=pos.device)
    for r in range(0, n, 1024):
        d2 = ((pos[:, r:r + 1024, None] - pos[:, None, :]) ** 2).sum(0)
        out[r:r + 1024] = ((d2 < c.min_dist2 * (1 + 1e-4)) & (d2 > c.eps2)).sum(1)
    return out


def fleet_kin(pos, vel, device):
    n = pos.shape[0]
    quat = np.tile(np.array([[0.0, 0.0, 0.0, 1.0]], np.float32), (n, 1))
    kin = init_kin_state(pos, quat, device=device)
    return kin.replace(vel=torch.as_tensor(vel, device=device))


def kin_gaps(a, b):
    return {k: float((getattr(a, k) - getattr(b, k)).abs().max()) for k in SWARM_LIMITS}


def check_kin_gaps(what, gaps):
    bad = [f"{k}: {v:.3g} > {SWARM_LIMITS[k]}" for k, v in gaps.items()
           if not v <= SWARM_LIMITS[k]]
    if bad:
        fail(f"{what}: " + "; ".join(bad))


def per_pass_ms(fn, reps, repeats=REPEATS):
    """Median over ``repeats`` of the CUDA-event time of ``reps`` calls, per
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(event_ms(lambda: [fn() for _ in range(reps)], repeats)) / reps


def profile_steps(fn, steps):
    """Run ``fn`` ``steps`` times under torch.profiler and read the device's
    kernels from its chrome trace: per step, the host wall time, the time
    the card was busy (the union of kernel intervals), and the kernel time
    of the pair kernels and of all others, in ms. None if the trace holds no
    kernel."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    if not kernels:
        return None
    pair = sum(e["dur"] for e in kernels
               if "pair_kernel" in e["name"] or "reduce_kernel" in e["name"])
    busy, end = 0.0, -math.inf
    for e in kernels:  # the union of the kernels' [ts, ts + dur) intervals
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    total = sum(e["dur"] for e in kernels)
    return dict(wall_ms=wall * 1e3 / steps, busy_ms=busy / 1e3 / steps,
                pair_ms=pair / 1e3 / steps, other_ms=(total - pair) / 1e3 / steps,
                kernels_per_step=len(kernels) / steps)


def phase6_pairs(dev, c, params):
    """The pair kernels against their plain versions on the card."""
    errs = {name: 0.0 for name in PAIRS}
    expect = Counter()
    before = pair_launches()
    shapes = [(n, None, sort) for n in SWARM_N for sort in (False, True)]
    shapes += [(SWARM_N[0], SWARM_N[1], sort) for sort in (False, True)]
    for nt, ns, sort in shapes:
        tgt, src = pair_cloud(dev, nt, ns)
        square = ns is None
        if sort:
            tgt = _pairs.sort_by_z(tgt)[0]
            src = tgt if square else _pairs.sort_by_z(src)[0]
        total = math.ceil(nt / _pairs.BLOCK) * math.ceil(src.shape[1] / _pairs.BLOCK)
        split, per = _pairs.source_split(nt, src.shape[1])
        for name in (PAIRS if square else ("K2", "K4")):
            tiles = torch.zeros(2, dtype=torch.int32, device=dev)
            got = pair_pass(name, tgt, src, c, sort, square, tiles=tiles)
            want = pair_pass(name, tgt, src, c, sort, square, plain=True)
            torch.cuda.synchronize()
            err, note = pair_error(name, got, want, tgt)
            errs[name] = max(errs[name], err)
            expect[name] += 1
            counts = tiles.tolist()
            evaluated = [counts[0]] if name == "K2" else [counts[1]] if name == "K4" else counts
            if sort and not all(e < total for e in evaluated):
                fail(f"{name} N={nt}x{src.shape[1]} sorted: no tile was culled ({evaluated}/{total})")
            if not sort and not all(e == total for e in evaluated):
                fail(f"{name} N={nt}x{src.shape[1]} unsorted: {evaluated} tiles of {total}")
            print(f"[6] {name} {'square' if square else 'rectangular'} {nt}x{src.shape[1]} "
                  f"z_sort={sort}: S={split} ({per} tiles a chunk), max |kernel - plain| "
                  f"{err:.3g}, tiles evaluated {evaluated} of {total} "
                  f"(culled {[total - e for e in evaluated]}){'; ' + note if note else ''}",
                  flush=True)

    # The whole passes (stack, sort, cull, scatter back) against the unsorted ones.
    cols = pair_cloud(dev, SWARM_N[0])[0]
    x = [cols[i] for i in range(6)]
    for name, make, args in (("K2", make_downwash, x[:3]), ("K4", make_collide, x),
                             ("K5", make_interact, x)):
        flat = [as_rows(make(params, z_sort=sort, device=dev).cols(*args)) for sort in (False, True)]
        expect[name] += 2
        err, note = pair_error(name, flat[1], flat[0], cols)
        print(f"[6] {name} whole pass N={SWARM_N[0]}, z-sorted against unsorted: max |diff| "
              f"{err:.3g}{'; ' + note if note else ''}", flush=True)
    after = pair_launches()
    rose = {name: after[name] - before[name] for name in PAIRS}
    if rose != dict(expect):
        fail(f"the pair kernels' launch counts rose by {rose}, not {dict(expect)}")
    return errs


def phase7_swarm(dev, params):
    """The coupled swarm's main path, then the kernel path against the plain
    path on the CPU and the AoS form against the SoA step."""
    hover = float(params.hover_rpm)
    pc = _pairs.pair_consts(params)
    z_min = np.float32(float(params.collision_h) / 2.0 - float(params.collision_z_offset))
    main = Counter()
    for n in SWARM_N:
        pos = lattice(n)
        backend = select_swarm_backend(pos)
        rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
        for coll in (False, True):
            init, step, export = make_swarm_physics(params, 1 / 240, 5, collisions=coll,
                                                    init_pos=pos)
            if backend != "soa" or init is not swarm_soa_from_kin:
                fail(f"make_swarm_physics picked {backend!r} at N={n}, not 'soa'")
            kin = init_kin_state(pos, np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), device=dev)
            reset_pair_launches()
            t0 = time.perf_counter()
            with last_launch(collide_pairs.NAME) as k4:
                s = init(kin)
                for _ in range(SWARM_T):
                    s = step(s, rpm)
                kin = export(s, kin)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = pair_launches()
            want = (dict(K2=SWARM_T, K4=SWARM_T, K5=4 * SWARM_T) if coll
                    else dict(K2=5 * SWARM_T, K4=0, K5=0))
            if got != want:
                fail(f"swarm N={n} collisions={coll}: launches {got}, not {want}")
            main.update(got)
            leaves = (kin.pos, kin.quat, kin.vel, kin.ang_v, kin.rpy_rates)
            if not all(bool(torch.isfinite(x).all()) for x in leaves):
                fail(f"swarm N={n} collisions={coll}: the state is not finite")
            z, low = kin.pos[:, 2], float(kin.pos[:, 2].min())
            what = f"swarm N={n} collisions={coll}"
            if not coll:
                if not low >= z_min:
                    fail(f"{what}: a drone is at z {low} < the clamp {z_min}")
                ground = f"min z {low:.6f} (clamp {z_min})"
            else:
                # The contact pass runs after each substep's ground clamp (as
                # in the JAX package, ops/swarm_soa.py:193-202): it may leave
                # a grounded drone below the plane by its pushout, at most
                # max_push from each partner; the next substep's clamp lifts
                # it back. So: the clamp held before the last pass, the state
                # is that pass's result, and each drone's depth is within
                # max_push times the partners it had in it.
                pre, delta = k4["tgt"], k4["out"]
                if not float(pre[2].min()) >= z_min:
                    fail(f"{what}: z {float(pre[2].min())} < the clamp {z_min} before the "
                         "last contact pass")
                after = pre[2] + delta[2]
                if not torch.equal(torch.sort(after).values, torch.sort(z).values):
                    fail(f"{what}: the final z is not the last contact pass's result")
                partners = contact_partners(pre[:3], pc)
                room = pc.max_push * partners.to(torch.float32) + 1e-6
                depth = torch.clamp(float(z_min) - after, min=0.0)
                if not bool((depth <= room).all()):
                    i = int((depth - room).argmax())
                    fail(f"{what}: a drone is {float(depth[i])} m below the clamp with "
                         f"{int(partners[i])} partners in the last contact pass")
                deep = int(depth.argmax())
                ground = (f"min z {low:.6f} (clamp {z_min}; held before the last contact "
                          f"pass; deepest drone {float(depth[deep]):.6f} m below it with "
                          f"{int(partners[deep])} partners; {int((depth > 0).sum())} drones "
                          f"below it, each within max_push x its partners)")
            print(f"[7] main path N={n} collisions={coll}: backend {backend}, z_sort "
                  f"{_pairs.use_z_sort(None, n, n)}, {SWARM_T} control steps in {wall:.3f} s "
                  f"wall, launches {got}, finite, {ground}", flush=True)

    n = SWARM_N[0]
    params_cpu = params.to("cpu")
    rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
    rpm4 = torch.full((n, 4), hover, device=dev)
    for coll, (pos, vel) in ((False, towers(n)), (True, contact_fleet(n))):
        kin = fleet_kin(pos, vel, dev)
        kernel = make_swarm_step_soa(params, 1 / 240, 5, collisions=coll)
        plain = make_swarm_step_soa(params_cpu, 1 / 240, 5, collisions=coll, device="cpu")
        a = swarm_soa_to_kin(kernel(swarm_soa_from_kin(kin), rpm), kin)
        kin_cpu = fleet_kin(pos, vel, "cpu")
        b = swarm_soa_to_kin(plain(swarm_soa_from_kin(kin_cpu), [r.cpu() for r in rpm]),
                             kin_cpu)
        gaps = kin_gaps(a, b.to(dev))
        check_kin_gaps(f"swarm step, kernels on the card against plain on the CPU, "
                       f"collisions={coll}", gaps)
        # The wake must move what is compared: the towers' lowest drones sink
        # under the wake of those above, their highest do not.
        towers_at = slice(n // 2, n) if coll else slice(0, n)
        dvz = (a.vel[towers_at, 2] - kin.vel[towers_at, 2]).reshape(-1, 8)
        sink = float(dvz[:, 0].mean() - dvz[:, 7].mean())
        if not sink < -0.1:
            fail(f"collisions={coll}: the wake did not move the towers ({sink} m/s)")
        if coll and not float((a.pos[:n // 2, :2] - kin.pos[:n // 2, :2]).abs().max()) > 1e-4:
            fail("no contact fired in the co-planar pairs")
        big = make_big_swarm_physics(params, 1 / 240, 5, Physics.PYB_DW, collisions=coll)
        reset_pair_launches()
        aos, _ = big(kin, rpm4, rpm4)
        torch.cuda.synchronize()
        got = pair_launches()
        want = dict(K2=1, K4=1, K5=4) if coll else dict(K2=5, K4=0, K5=0)
        if got != want:
            fail(f"make_big_swarm_physics collisions={coll}: launches {got}, not {want}")
        big_gaps = kin_gaps(aos, a)
        check_kin_gaps(f"make_big_swarm_physics against the SoA step, collisions={coll}",
                       big_gaps)
        fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})
        print(f"[7] N={n} {'co-planar pairs beside towers' if coll else 'towers'}, "
              f"collisions={coll}, one control step: kernels on the card against plain on "
              f"the CPU {fmt(gaps)} (the towers' lowest drones sink {-sink:.4f} m/s faster "
              f"than their highest); make_big_swarm_physics (launches {got}) against the SoA "
              f"step {fmt(big_gaps)}", flush=True)
    return main


def phase8_times(dev, c, params, ops):
    """Each pair kernel's time per pass, its plain version's and its bound;
    then the swarm step per control step."""
    res = {}
    for n in SWARM_N:
        cols = pair_cloud(dev, n)[0]
        for sort in (False, True) if n >= _pairs.Z_SORT_MIN_N else (False,):
            t = _pairs.sort_by_z(cols)[0] if sort else cols
            total = math.ceil(n / _pairs.BLOCK) ** 2
            for name in PAIRS:
                tiles = torch.zeros(2, dtype=torch.int32, device=dev)
                pair_pass(name, t, t, c, sort, True, tiles=tiles)
                counts = tiles.tolist()
                k_ms = per_pass_ms(lambda: pair_pass(name, t, t, c, sort, True), 20)
                p_ms = per_pass_ms(lambda: pair_pass(name, t, t, c, sort, True, plain=True), 1, 3)
                rows, n_out = PAIRS[name][:2]
                flops = ops[name] * n * n
                nbytes = (rows + n_out) * n * 4
                bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
                bound_by = ("operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES_PER_S
                            else "bytes")
                if name == "K2":
                    left = counts[0] * _pairs.BLOCK ** 2 * (ops["K2"])
                elif name == "K4":
                    left = counts[1] * _pairs.BLOCK ** 2 * (ops["K4"])
                else:
                    left = (counts[0] * ops["K2"] + counts[1] * ops["K4"]) * _pairs.BLOCK ** 2
                left_ms = left / PEAK_FP32_FLOPS * 1e3
                res[(name, n, sort)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                                            bound_by=bound_by)
                print(f"[8] {name} N={n} z_sort={sort}: {k_ms:.5f} ms per pass "
                      f"({n * n / (k_ms / 1e3):.4g} pairs/s over N^2), plain {p_ms:.3f} ms; "
                      f"bound {bound_ms:.5f} ms by {bound_by} ({ops[name]} ops per pair x "
                      f"{n * n} pairs = {flops:.4g} ops / {PEAK_FP32_FLOPS:.3g}; {nbytes} bytes / "
                      f"{PEAK_BYTES_PER_S:.3g} = {nbytes / PEAK_BYTES_PER_S * 1e3:.3g} ms); tiles "
                      f"left by the culls {counts} of {total}, whose pairs need {left_ms:.5f} ms; "
                      "library_ms null (no PyTorch call computes this function)", flush=True)

    hover = float(params.hover_rpm)
    per_step = {False: dict(K2=5, K4=0, K5=0), True: dict(K2=1, K4=1, K5=4)}
    for n in SWARM_N:
        kin = init_kin_state(lattice(n), np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), device=dev)
        rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
        sort = _pairs.use_z_sort(None, n, n)
        # The kernels' time per pass on the swarm's own lattice (the culls
        # depend on the geometry), z-sorted as the main path sorts it.
        cols = torch.cat([kin.pos.T, kin.vel.T]).contiguous()
        cols = _pairs.sort_by_z(cols)[0] if sort else cols
        lat_ms = {name: per_pass_ms(lambda: pair_pass(name, cols, cols, c, sort, True), 20)
                  for name in PAIRS}
        print(f"[8] pair kernels on the swarm lattice N={n} z_sort={sort}: ms per pass "
              f"{json.dumps({k: float(f'{v:.5g}') for k, v in lat_ms.items()})}", flush=True)
        for coll in (False, True):
            step = make_swarm_step_soa(params, 1 / 240, 5, collisions=coll)
            state = [swarm_soa_from_kin(kin)]

            def advance():
                state[0] = step(state[0], rpm)

            ms = per_pass_ms(advance, 10, 3)
            pair_ms = sum(k * lat_ms[name] for name, k in per_step[coll].items())
            print(f"[8] swarm step N={n} collisions={coll} z_sort={sort}: {ms:.4f} ms per control "
                  f"step ({n / (ms / 1e3):.6g} drone-steps/s); pair kernels {pair_ms:.4f} ms "
                  f"(launches per step x ms per pass above), the rest (substep chain, sort, "
                  f"gather, scatter, stacking) {ms - pair_ms:.4f} ms", flush=True)
            prof = profile_steps(advance, 5)
            if prof is None:
                print("[8]   torch.profiler saw no device kernel: not measured", flush=True)
            else:
                # The profiler's own host work stretches the wall time it
                # sees; the idle share is taken against the event time above.
                print(f"[8]   under torch.profiler, per control step: card busy "
                      f"{prof['busy_ms']:.4f} ms, idle share {1 - prof['busy_ms'] / ms:.4f} "
                      f"(1 - busy / {ms:.4f} ms event time), pair kernels "
                      f"{prof['pair_ms']:.4f} ms, other kernels {prof['other_ms']:.4f} ms in "
                      f"{prof['kernels_per_step']:.0f} kernels; wall {prof['wall_ms']:.4f} ms "
                      "with the profiler's overhead", flush=True)
    return res


def main():
    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[1] device: {kind}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        list(pool.map(_build.build, (KERNEL, _pairs.KERNEL)))
    print(f"[2] built {KERNEL} and {_pairs.KERNEL} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib in (KERNEL, _pairs.KERNEL):
        for line in _build.ptxas_report(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[2]   {lib}: {line.strip()}", flush=True)

    cfg = AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48)
    params_cpu, cp_cpu = build_params(cfg, "cpu"), build_ctrl_params(cfg, "cpu")
    consts = soa_consts(cp_cpu, params_cpu)  # host floats, no card syncs
    sl = 0.03 * float(params_cpu.max_speed_kmh) * (1000.0 / 3600.0)
    z_min = consts["z_min"]
    args = (consts, cfg.ctrl_timestep, cfg.pyb_timestep, cfg.steps_per_ctrl, sl)
    params = params_cpu.to(dev)
    action = formation_actions(E, dev)

    # ---------------- 3. K1 against its plain version ----------------
    soa0 = soa_from_state(batch_reset(cfg, params, E, device=dev))
    before = velocity_rollout_cuda.launches
    got = velocity_rollout_cuda(*args, T_SHORT, soa0, action)
    want = velocity_rollout_plain(*args, T_SHORT, soa0, action)
    torch.cuda.synchronize()
    errs, bad = {}, []
    for k in SOA_KEYS:
        err = float((got[k] - want[k]).abs().max())
        errs[k] = err
        if not err <= 1e-5:
            bad.append(f"{k}: {err:.3g} > 1e-05")
    print(f"[3] K1 vs plain, E={E} T={T_SHORT}: max |err| per column "
          + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}), flush=True)
    if bad:
        fail("K1 disagrees with its plain version: " + "; ".join(bad))
    long_k = velocity_rollout_cuda(*args, T_LONG, soa0, action)
    long_p = velocity_rollout_plain(*args, T_LONG, soa0, action)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(long_k[k]).all()) for k in SOA_KEYS):
        fail(f"K1 state is not finite after T={T_LONG}")
    long_errs = {k: float((long_k[k] - long_p[k]).abs().max()) for k in SOA_KEYS}
    low = float(long_k["pz"].min())
    print(f"[3] K1 vs plain, E={E} T={T_LONG}: finite, max |err| per column "
          + json.dumps({k: float(f"{v:.3g}") for k, v in long_errs.items()})
          + f", min pz {low:.6f} (clamp {z_min})", flush=True)
    bad = [f"{k}: {v:.3g} > 1e-05" for k, v in long_errs.items() if not v <= 1e-5]
    if bad:
        fail(f"K1 disagrees with its plain version after T={T_LONG}: " + "; ".join(bad))
    max_abs_err = max(*errs.values(), *long_errs.values())
    if not low >= np.float32(z_min):
        fail(f"a drone is below the ground clamp: pz {low} < {z_min}")
    if velocity_rollout_cuda.launches - before != 2:
        fail("K1's launch count did not rise by the 2 launches of this phase")

    # ---------------- 4. the main path ----------------
    velocity_rollout_cuda.launches = 0
    state = batch_reset(cfg, params, E, device=dev)
    rollout = make_velocity_rollout(*args, T_LONG, device=dev)
    soa = rollout(soa_from_state(state), action)
    state = soa_to_state(soa, state, pyb_steps=cfg.steps_per_ctrl * T_LONG)
    obs = compute_obs(cfg, state)
    torch.cuda.synchronize()
    launches = {KERNEL: velocity_rollout_cuda.launches}
    print(f"[4] main path E={E} T={T_LONG}: obs {tuple(obs.shape)}, launches {launches}",
          flush=True)
    if launches[KERNEL] == 0:
        fail("the main path never launched K1")
    if tuple(obs.shape) != (E, 1, 20) or not bool(torch.isfinite(obs).all()):
        fail(f"main-path obs has shape {tuple(obs.shape)} or is not finite")
    if not bool((state.step_count == cfg.steps_per_ctrl * T_LONG).all()):
        fail("step_count did not advance by the rollout's substeps")
    if not all(bool(torch.equal(soa[k], long_k[k])) for k in SOA_KEYS):
        fail("the main path's rollout differs from phase 3's K1 run on the same input")

    # The general step on the card against the CPU. Float32 closed loops drift
    # apart chaotically (this config has the suite's largest Lyapunov
    # exponent, tests/test_golden_pyb.py:244-249): tests/test_soa.py's limits
    # hold for the first 12 steps (0.25 s); position and velocity for all 24.
    # The CPU's own float32-vs-float64 gap is printed beside them for scale.
    limits = dict(pos=1e-3, vel=2e-3, quat=1e-3, last_rpm=20.0)  # tests/test_soa.py:52-59
    act = torch.stack([action[k] for k in ("ax", "ay", "az", "amag")], -1)[:, None, :]
    runs = {}
    for key, p, cp in (("cuda", params, cp_cpu.to(dev)), ("cpu", params_cpu, cp_cpu),
                       ("cpu64", params_cpu.map(torch.Tensor.double),
                        cp_cpu.map(torch.Tensor.double))):
        c = AviaryConfig(task=TASK_VELOCITY, pyb_freq=240, ctrl_freq=48,
                         dtype=str(p.m.dtype).removeprefix("torch."))
        step = make_batched_step(c, p, cp, torch.zeros((1, 3), dtype=p.m.dtype,
                                                       device=p.m.device), auto_reset=False)
        s, a, trace = batch_reset(c, p, E, device=p.m.device), act.to(p.m), []
        for _ in range(24):
            s, _ = step(s, a)
            trace.append({k: getattr(s.kin, k).double().cpu() for k in ("pos", "vel", "quat")}
                         | {"last_rpm": s.last_rpm.double().cpu()})
        runs[key] = trace

    def gap(a, b, t):
        return {k: float((runs[a][t][k] - runs[b][t][k]).abs().max()) for k in limits}

    for t in range(24):
        d = gap("cuda", "cpu", t)
        for k in (limits if t < 12 else ("pos", "vel")):
            if not d[k] <= limits[k]:
                fail(f"make_batched_step on the card differs from the CPU in {k} at step "
                     f"{t + 1}: {d[k]}")
    fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})
    print(f"[4] make_batched_step card vs CPU, E={E}: after 12 steps {fmt(gap('cuda', 'cpu', 11))}"
          f"; after 24 steps {fmt(gap('cuda', 'cpu', 23))}; CPU float32 vs float64 after 24 "
          f"steps {fmt(gap('cpu', 'cpu64', 23))}", flush=True)

    # ---------------- 5. timing and bound ----------------
    velocity_rollout_cuda(*args, 48, soa0, action)  # warm-up
    torch.cuda.synchronize()
    k_times = event_ms(lambda: velocity_rollout_cuda(*args, T_TIME, soa0, action), REPEATS)
    k_ms = statistics.median(k_times)
    velocity_rollout_plain(*args, 2, soa0, action)  # warm-up
    torch.cuda.synchronize()
    p_ms = event_ms(lambda: velocity_rollout_plain(*args, T_TIME, soa0, action), 1)[0]
    per_env, parts = ops_per_env(consts, cfg, sl, T_TIME)
    flops = per_env * E
    nbytes = (len(SOA_KEYS) + 4 + len(SOA_KEYS)) * 4 * E
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    print(f"[5] K1 E={E} T={T_TIME}: ms per repeat {[round(t, 4) for t in k_times]}, "
          f"median {k_ms:.4f} ms, {E * T_TIME / (k_ms / 1e3):.6g} env-steps/s", flush=True)
    print(f"[5] plain version, same E and T, one run: {p_ms:.1f} ms "
          f"({E * T_TIME / (p_ms / 1e3):.6g} env-steps/s)", flush=True)
    print(f"[5] bound: {per_env} ops per env for T={T_TIME} (ops per piece: "
          f"{json.dumps(parts)}; FMA counts 2 in the peak), {flops:.4g} ops / {PEAK_FP32_FLOPS:.3g} = {flops / PEAK_FP32_FLOPS * 1e3:.4g} ms; "
          f"{nbytes} bytes / {PEAK_BYTES_PER_S:.3g} = {nbytes / PEAK_BYTES_PER_S * 1e3:.4g} ms; "
          f"bound {bound_ms:.4g} ms by {bound_by}; library_ms null (no PyTorch call "
          "computes this function)", flush=True)

    # ---------------- 6. pair kernels against their plain versions ----------------
    swarm_params = params_cpu  # CF2X float32; the constants are read on the host
    pc = _pairs.pair_consts(swarm_params)
    pair_errs = phase6_pairs(dev, pc, swarm_params)

    # ---------------- 7. the coupled swarm's main path ----------------
    pair_main = phase7_swarm(dev, params)

    # ---------------- 8. times ----------------
    ops = ops_per_pair(pc)
    print(f"[8] operations per pair, counted on the plain pair terms: {json.dumps(ops)}",
          flush=True)
    pair_times = phase8_times(dev, pc, params, ops)

    # ---------------- 9. result ----------------
    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "gym_pybullet_drones_tpu_torch/csrc/velocity_rollout.cu",
        "replaces": "gym_pybullet_drones_tpu/ops/velocity_pallas.py:74",
        "launches": launches[KERNEL], "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]
    for pid in PAIRS:
        if pair_main[pid] == 0:
            fail(f"the swarm's main path never launched {pid}")
        kernels.append({
            "name": f"{pid} {PAIRS[pid][2].__name__.removesuffix('_cuda')}_pairs",
            "route": "cuda", "source": "gym_pybullet_drones_tpu_torch/csrc/pair_kernels.cu",
            "replaces": PAIRS[pid][4], "launches": pair_main[pid],
            "max_abs_err": pair_errs[pid], **pair_times[(pid, SWARM_N[0], False)],
            "library_ms": None,
        })
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite measurement for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
