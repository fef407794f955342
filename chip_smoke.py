#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without them
or on any failed check. Imports nothing of JAX or of the JAX package.

Phases, one or more lines each:
  1. the device, and nvidia-smi's name and power limit;
  2. build every kernel of the path (K1, csrc/velocity_rollout.cu) and print
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
  6. one JSON line of kernels, the nvidia-smi line, and the result line.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_VELOCITY,
    AviaryConfig,
    build_ctrl_params,
    build_params,
    compute_obs,
)
from gym_pybullet_drones_tpu_torch.ops import _build
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
        "atan2", "asin", "maximum", "minimum", "gt", "lt", "ge", "le",
        "where", "bitwise_and", "logical_and"}


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


def main():
    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[1] device: {name}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    _build.build(KERNEL)
    print(f"[2] built {KERNEL} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.ptxas_report(KERNEL).splitlines():
        print(f"[2]   {line.strip()}", flush=True)

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

    # ---------------- 6. result ----------------
    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "gym_pybullet_drones_tpu_torch/csrc/velocity_rollout.cu",
        "replaces": "gym_pybullet_drones_tpu/ops/velocity_pallas.py:74",
        "launches": launches[KERNEL], "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite measurement for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
