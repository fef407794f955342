#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without them
or on any failed check. Imports nothing of JAX or of the JAX package.

Phases, one or more lines each:
  1. the device, and nvidia-smi's name and power limit;
  2. build every kernel, one nvcc per source started together (K1,
     csrc/velocity_rollout.cu; K2, K4, K5, csrc/wake_pair_kernels.cu; K3, K6,
     csrc/masked_pair_kernels.cu; K7, csrc/render_views.cu), and print
     ptxas's registers and spills,
     the units of K2, K4 and K5 and the blocks of K3 and K6 (at each source
     split S) resident per SM;
  3. hold K1 against its plain PyTorch version on the card at E = 4096
     (batch_reset state, formation actions): T = 8 and T = 240 (5 s) at atol
     1e-5 on every column, and at T = 240 finiteness and the ground clamp;
     at T = 8 bit for bit;
  4. the main path through the user entry points, launch counts reset just
     before and read just after: batch_reset -> soa_from_state ->
     make_velocity_rollout (K1) -> soa_to_state -> compute_obs, at E = 4096
     and T = 240; then make_batched_step on the card against the CPU for 24
     steps (tests/test_soa.py's limits over the first 12);
  5. K1's time with CUDA events (E = 4096, T = 4800, after a warm-up, 5
     repeats), the plain version's time for T = 480 (a tenth of the depth:
     it is launch-bound and would take a minute), and K1's bound; the
     scaling line (E = 32, 4096, 16384, 65536, T = 4800);
  6. the pair kernels K2, K4, K5 against their plain versions on the card,
     on tests/test_soa.py's cloud scaled to N = 4096 and 16384 with
     overlapping pairs: square with the z-sorted culls off and on, K2 and K4
     rectangular (4096 targets x 16384 sources); the wake per drone at rtol
     1e-4 plus atol 1e-6 (every wake term has one sign, so a reordered
     float32 sum errs relative to the sum itself), positions and velocities
     after the contact deltas at atol 1e-6; contacts fired, the culls
     skipped tiles, launch counts, each pass's work units; the whole
     z-sorted passes against the unsorted ones;
  6b. the masked pair kernels K3, K6 against their plain versions on the
     card: the cloud under a random permutation, sorted by z and by Morton
     key at N = 4096 and 16384, the cone cull on and off, with a padding
     column, and rectangular 4096 x 16384, at the limits of phase 6 on real
     slots, padding rows exactly 0; the compacted grid equal to the dense
     masked one and a second pass equal to the first, bit for bit;
     the share of sub-slices the masks leave live; a forced small cap takes
     the overflow branch and the counters say so;
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
  7b. the binned and the sorted backends through make_swarm_physics:
     "auto" on the lattice at N = 16384, pitch 2.5 m and N = 65536, pitch 4 m
     picks "binned"; collisions off and on, 48 control steps each, K3 / K6
     launch counts as the code implies (one K3 at init, then 5 K3 or 5 K6 a
     control step), no pass on the overflow branch, the layout cell-aligned,
     real slots finite and at or above the ground clamp (with contact, by
     phase 7's rule), export returning each drone once; backend="soa" with
     sorted=True at N = 16384, pitch 2 m, both orders, 12 control steps, the
     same checks; binned and sorted against "soa" over 3 control steps on
     that fleet and, with contact, on co-planar contact pairs beside unique-z
     towers (tests/test_soa.py:623-628's limits), the z order also with the
     cone cull off, whose gap to "soa" bounds the cone-on gap (at most 10x:
     the cull is exact); one control step of the
     binned kernel path on the card against the binned plain path on the CPU
     at N = 4096, on towers and on co-planar pairs beside towers;
  8. times: each pair kernel per pass (N = 4096 and 16384, culls off and
     on), with CUDA events and as device time under torch.profiler (the
     events of a pass at N = 4096 time the host), its plain version and its
     bound (``op_bound``): the largest of the operations ceiling (each
     term's gate on the pairs the pass must test, the rest of the term on
     the pairs its gate lets through), the special-function (MUFU) ceiling
     and the bytes ceiling; the swarm step per control step, split
     into the pair kernels and the rest, and the card's idle share (1 - busy
     time under torch.profiler / event time);
  8b. K3 and K6 on both binned fleets and on the sorted loop's fleet (N =
     16384, 2.5 m, z order, 256 x 256 tiles), at the tiles, padding and list
     cap the main path gives them: dense and compacted against their plain
     versions on the real slots at phase 6's limits (padding rows exactly
     0), on the lattice and on the lattice with drones in touch, and the
     wake against the unmasked plain wake of the real drones; then per pass,
     dense and compacted, with events and device time, beside the bound
     (phase 8's, for the pairs of real drones the masks leave) and
     time/bound, at every source split S and with the
     padding skip off, K2 / K5 z-sorted on the same drones and the plain
     versions; the blocks the padding skip drops; the mask and compaction
     ops per pass; the overflow check's host read; the rebin; the binned and
     the sorted step per control step with phase 8's split;
  9. the impulse contact path (core/contact.py, plain PyTorch ops, no
     kernel of its own), float32, CF2X at 240 Hz: (a) the
     one_d_rpm_hover_contact env (1 drone, ONE_D_RPM, 240/30 Hz, buffer 15,
     collisions, impulse, RL landmarks) through make_batched_step at E =
     4096 and (b) the one_d_rpm_multihover_contact env (2 drones, the exact
     pair rows) at E = 2048, from the plane, 30 control steps (1 s) of
     actions that lift each env off and land it at its own phase, the card
     against the CPU on 512 of the envs at tests/test_soa.py:52-59's limits; (c)
     scripts/impulse_ladder.py's lattice (10 cm pitch, +-5 mm, hovering at
     1 m) through step_physics at N = 16384 (dense candidates; one control
     period with the hash grid's candidates equal bit for bit) and 65536
     (hash grid), finite with z in (-0.1, 5) m; for each cell the ms a
     control step (events), kernels and memsets a control step, card-busy
     ms and idle share (torch.profiler), the candidate build's ms and
     env-steps/s or drone-steps/s;
  10. PPO (rl/ppo.py) on the card, examples/learn.py's ONE_D_RPM Hover
     settings (240/30 Hz, action buffer 15, float32, TF32 off): (a) three
     train steps from ppo_init at E = 128, n_steps = 128, minibatch 1024,
     log-std annealed toward -2.5: finite metrics, params moved, update_count
     3, the env state on the card; (b) one train step on the card and on the
     CPU from the same converted initial params (E = 64, n_steps = 32, 0.5 s
     episodes so that truncation and auto-reset occur, det_frac 1, one
     minibatch, 2 epochs) at tests/test_torch_ppo.py's limits; (c) one train
     step at E = 4096, n_steps = 128, auto minibatches, after a warm-up
     one: ms of its rollout and update halves (CUDA events), env-steps/s;
     a rollout control step alone: ms (events), kernels and memsets,
     card-busy ms and idle share (torch.profiler); (d) the same with
     domain_rand {"m": 0.1, "kf": 0.05}, finite, and 30 deterministic
     control steps from reset spreading z over the envs by more than 1 mm
     (none on the nominal plant); (e)
     checkpoints/one_d_rpm_hover.msgpack (>= 474.0) and pid_multihover
     (>= 920.0) through load_flax_msgpack and evaluate_policy over 2,600
     control steps on one env, the two in two processes at once
     (``python3 chip_smoke.py --eval NAME``), each return, episode count and
     seconds;
  10b. the pixel path (render/camera.py, K7, the RGB env, CnnActorCritic),
     float32, TF32 off for matmuls and cuDNN: (a) K7 against its plain
     version on the card at the CPU tests' render limits (seg equal on 99.9 %
     of the pixels; where seg agrees rgba within 1, depth within 1e-6), on
     E = 64 one-drone envs facing the RL landmarks, E = 32 two-drone envs (the
     mesh proxy), one 12-drone world (the X-frame), E = 16 envs in
     BaseAviary's scene and E = 4096 one-drone envs (the KIN PPO width; the
     plain version 64 worlds at a time): the differing pixels and whether
     K7 is bit-equal (it must be), K7's ms (events) and device ms, the plain
     version's ms and kernels, both peak memories, and two bounds over the
     float32 peak (12 bytes a pixel over the memory rate): the work K7 needs
     (the camera once a camera, a gate for every object and other drone
     once a tile, the rays, plane, sky and depth once a pixel, and a
     primitive's exact test and an object's selection and shading only where
     the pixel's ray enters its bounding sphere) and the plain version's
     whole work (its operations on one pixel, counted element by element);
     ``python3 chip_smoke.py --render`` runs (a) alone;
     (b) scripts/rgb_scratch.py's RGB Hover env (ONE_D_RPM, 240/30 Hz,
     buffer 15, frame_stack 4) through make_batched_step at E = 64 for 30
     control steps, the card against the CPU on 8 of the envs (kinematics at
     tests/test_soa.py:52-59's limits, frames at most 0.1 % of the pixels
     past 1); (c) one RGB PPO train step at rgb_scratch.py's settings (E =
     64, n_steps 128, minibatch 1024, target_kl 0.01, det_frac 0.25) after a
     warm-up one: ms of its halves, env-steps/s, K7's launches (one a control
     step, counted from 0 over the step), peak memory, and a rollout control
     step's kernels, busy ms and idle share (torch.profiler); (d) the same
     with domain_rand {"m": 0.1, "kf": 0.05}, K7 under torch.func.vmap; (e)
     the five RGB checkpoints at tests/test_checkpoints.py's gates (two over
     260 control steps, three over 2,600), each in its own ``python3
     chip_smoke.py --eval NAME`` process, all at once;
  11. the controllers (control/), float32: (a) tests/test_commander_jax.py's
     mission (takeoff, own corner with hold, land; commander + Mellinger
     through envs/base.step with preprocessed RPMs) for 4,096 drones in one
     world on a 64 x 64 grid at 1.5 m pitch, PYB 500/500 Hz, 4,100 ticks, at
     the test's gates (corners at 4.5 s within 0.06 m in xy and 0.12 m in z,
     pads within 0.06 m and 0.15 m): ms a tick (events), a tick's kernels,
     busy ms and idle share (torch.profiler); (b) the single-step gates of
     tests/test_controllers_extra.py at E = 4096 (MRAC at the hover point
     0.25-2.5x hover RPM; CTBR asks g there and climbs to a target above),
     then MRAC (240/120 Hz) and CTBR (240/240 Hz, through a body-rate P loop
     and the X mixer's inverse) closed loops of 4,096 one-drone CtrlAviary
     envs over 2 s to seeded targets, within 0.1 and 0.05 m at the end; (c)
     the mission (an 8 x 8 grid, 500 ticks), MRAC and CTBR at 64 drones over
     1 s, the card against the CPU at tests/test_soa.py:52-59's limits;
  11b. the Gymnasium shells (compat/), through gymnasium.make / make_vec
     where gymnasium is installed, else through the device functions they
     wrap (runtime/shell.py: shell_step, make_vec_core, record_frame) at the
     same sizes, saying so: (a) one Hover env for 300 steps of seeded RPM
     actions, reset at each episode's end, steps/s, its first second against
     the CPU (atol 1e-3); (b) a Hover vector env at E = 4096 for 256 steps,
     every env the same action: ms a step, env-steps/s, the batched device
     step alone and the one host copy alone, the first episode boundary with
     its final obs; (c) the same with per-env plants {"m": 0.1, "kf": 0.05}
     spreading z; (d) an RGB Hover vector env (frame_stack 4) at E = 64 for
     30 steps: K7 once a control step (counted from 0), frames equal to the
     CPU's on 8 envs byte for byte; (e) record=True for 48 steps: 48 frames
     of 128 x 96 through K7 and a video;
  12. the firmware-in-the-loop envs and the rest of runtime/, through
     envs/cf.py and envs/beta.py where gymnasium is installed, else through
     the loops they wrap (runtime/firmware.py: CFShellEnv, BetaShellEnv over
     runtime/shell.shell_step), saying so; the bridges built with g++: (a)
     tests/test_cffirmware.py's mission (takeoff to 1 m, flown 3 s, then goto
     (0.5, 0.5, 1), flown 4 s; 175 control steps at 500/25 Hz, 3,500 firmware
     ticks) at its gates (z within 0.15 m, xy within 0.05 m, no tumble): ms
     a tick, kernels a tick (torch.profiler), the card against the CPU over
     the first second; (b) the Betaflight closed loop with MockSITL
     (tests/test_betaflight.py:65-95, 500/500 Hz, 7 s) within 0.08 m: ms a
     step; (c) a one-rank NCCL group (runtime/mesh.py):
     make_sharded_swarm_physics on the pair-pass path (K2, K4 rectangular)
     at N = 16384, PYB_DW with contact, 12 control steps, against the
     unsharded "soa" step, and the binned swarm with its slot axis sharded
     (K3, K6 rectangular) at N = 65536 (4 m pitch), with and without
     contact, against the unsharded binned step; ms a control step of each;
     launch counts of the sharded drives join the kernels line; (d) a PPO
     runner at E = 4096 saved and restored into a fresh one: the next train
     step bit for bit; (e) runtime/profiling.measure_throughput on K1's
     rollout at E = 4096 beside phase 5's figure, and a trace written and
     read back;
  13. the ten examples through their entry points on the card
     (gym_pybullet_drones_tpu_torch/examples/), in a few ``python3
     chip_smoke.py --example NAME ...`` processes at once, at
     tests/test_examples.py's settings and gates, each with its wall seconds
     and ms a control step: pid (4 s; the card against the CPU in float32
     over the first 0.5 s, in float64 over the first second), pid_velocity,
     downwash, mrac, cf and beta (through the shell loops where gymnasium is
     absent; MockSITL on 127.0.0.2), learn at the CI budget, single-agent
     (then play on the file it wrote) and multi-agent, play on
     checkpoints/one_d_rpm_hover.msgpack against JAX's return, debug, and
     trajopt's first 10 Adam iterates against the CPU's.
     ``python3 chip_smoke.py --examples [GROUP ...]`` runs this phase alone,
     each GROUP a comma-separated list of names, among them trajopt_full
     (200 iterations, about 530 s on the card), which the full run leaves out;
  14. one JSON line of kernels (``ms``: CUDA events around the wrapper's
     calls; ``device_ms``: the device time of its kernels and memsets under
     torch.profiler, null if not measured), the nvidia-smi line, and the
     result line.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import inspect
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gym_pybullet_drones_tpu_torch.control.commander import mission_setpoint, plan_mission
from gym_pybullet_drones_tpu_torch.control.ctbr import ctbr_control, ctbr_params
from gym_pybullet_drones_tpu_torch.control.mellinger import (
    mellinger_params,
    mellinger_reset,
    mellinger_rpm,
)
from gym_pybullet_drones_tpu_torch.control.mrac import mrac_control, mrac_params, mrac_reset
from gym_pybullet_drones_tpu_torch.convert import (
    actor_critic_from_flax,
    actor_critic_to_flax,
    load_flax_msgpack,
)
from gym_pybullet_drones_tpu_torch.core.contact import (
    NBR_MAX_N,
    build_pair_candidates,
    build_pair_candidates_binned,
)
from gym_pybullet_drones_tpu_torch.core.dynamics import init_kin_state, step_physics, substep_pyb
from gym_pybullet_drones_tpu_torch.core.params import randomize_params
from gym_pybullet_drones_tpu_torch.envs.base import (
    TASK_CTRL,
    TASK_HOVER,
    TASK_MULTIHOVER,
    TASK_VELOCITY,
    AviaryConfig,
    build_ctrl_params,
    build_params,
    compute_obs,
    hover_target_pos,
)
from gym_pybullet_drones_tpu_torch.envs.base import reset as env_reset
from gym_pybullet_drones_tpu_torch.envs.base import step as env_step
from gym_pybullet_drones_tpu_torch.core.rotations import (
    euler_xyz_to_quat,
    quat_to_euler_xyz,
    quat_to_matrix,
)
from gym_pybullet_drones_tpu_torch.envs.spec import ActionType, ObservationType, Physics
from gym_pybullet_drones_tpu_torch.ops import _build, _pairs, collide_pairs, interact_pairs, spatial
from gym_pybullet_drones_tpu_torch.ops.collide_pairs import (
    collide_cuda,
    collide_plain,
    contact_terms,
    make_collide,
)
from gym_pybullet_drones_tpu_torch.ops.downwash_pairs import (
    downwash_cuda,
    downwash_masked_cuda,
    downwash_masked_plain,
    downwash_plain,
    make_downwash,
    make_downwash_masked,
    wake_terms,
)
from gym_pybullet_drones_tpu_torch.ops.interact_pairs import (
    interact_cuda,
    interact_masked_cuda,
    interact_masked_plain,
    interact_plain,
    make_interact,
    make_interact_masked,
)
from gym_pybullet_drones_tpu_torch.ops import render_views as render_ops
from gym_pybullet_drones_tpu_torch.ops.render_views import KERNEL as RENDER_KERNEL
from gym_pybullet_drones_tpu_torch.ops.render_views import render_views_cuda
from gym_pybullet_drones_tpu_torch.ops.swarm_binned import (
    binned_geometry,
    make_binned_swarm,
    shard_binned_state,
)
from gym_pybullet_drones_tpu_torch.ops.swarm_soa import (
    make_sorted_swarm,
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
from gym_pybullet_drones_tpu_torch.render import camera
from gym_pybullet_drones_tpu_torch.render.meshes import ray_tris
from gym_pybullet_drones_tpu_torch.rl.ppo import (
    ActorCritic,
    PPOConfig,
    evaluate_policy,
    make_ppo_train_step,
    ppo_init,
    rollout_step,
)
from gym_pybullet_drones_tpu_torch.runtime import checkpoint, mesh as rmesh, profiling
from gym_pybullet_drones_tpu_torch.runtime.firmware import BetaShellEnv, CFShellEnv
from gym_pybullet_drones_tpu_torch.runtime.rollout import batch_reset, make_batched_step
from gym_pybullet_drones_tpu_torch.runtime.shell import (
    host_copy,
    make_vec_core,
    record_frame,
    shell_config,
    shell_step,
)
from gym_pybullet_drones_tpu_torch.runtime.swarm import (
    make_big_swarm_physics,
    make_sharded_swarm_physics,
    make_swarm_physics,
    select_swarm_backend,
    shard_swarm_kin,
)
from gym_pybullet_drones_tpu_torch.utils.video import png_dir_to_video

E = 4096
T_SHORT, T_LONG, T_TIME, T_PLAIN = 8, 240, 4800, 480
REPEATS = 5
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
# The float32 peak counts a fused multiply-add as two operations; K1 is built
# with -fmad=false, so its own ceiling is half this rate. The bound below is
# that of the function, for a kernel that fuses every multiply-add pair.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# The special-function unit (rcp, ex2, rsqrt): 16 results a clock an SM on
# sm_90 (CUDA C++ Programming Guide, arithmetic instruction throughput), 132
# SMs at the 1.98 GHz boost clock. A wake pair needs two (rcp, ex2), a contact
# pair one (rsqrt).
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9
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
PAIRS = {  # name -> (rows in, outputs, kernel, plain version, TPU kernel, source)
    "K2": (3, 1, downwash_cuda, downwash_plain, "gym_pybullet_drones_tpu/ops/downwash_pallas.py:140",
           "gym_pybullet_drones_tpu_torch/csrc/wake_pair_kernels.cu"),
    "K4": (6, 6, collide_cuda, collide_plain, "gym_pybullet_drones_tpu/ops/collide_pallas.py:145",
           "gym_pybullet_drones_tpu_torch/csrc/wake_pair_kernels.cu"),
    "K5": (6, 7, interact_cuda, None, "gym_pybullet_drones_tpu/ops/interact_pallas.py:160",
           "gym_pybullet_drones_tpu_torch/csrc/wake_pair_kernels.cu"),
}
# The device kernels of the pair passes, by name in a torch.profiler trace:
# K2, K4 and K5 (pair_unit_kernel), K3 and K6 (masked_pair_kernel).
PAIR_KERNEL_NAMES = ("pair_unit_kernel", "masked_pair_kernel")
# The scaling line of K1 (phase 5): envs, at T_TIME control steps.
K1_SIZES = (32, 4096, 16384, 65536)
MASKED = {  # name -> (rows in, outputs, kernel, plain version, maker, TPU kernel)
    "K3": (3, 1, downwash_masked_cuda, downwash_masked_plain, make_downwash_masked,
           "gym_pybullet_drones_tpu/ops/downwash_pallas.py:304"),
    "K6": (6, 7, interact_masked_cuda, interact_masked_plain, make_interact_masked,
           "gym_pybullet_drones_tpu/ops/interact_pallas.py:325"),
}
# tests/test_soa.py:187-196 (and tests/test_torch_swarm.py)
SWARM_LIMITS = dict(pos=1e-5, vel=1e-4, quat=1e-6, ang_v=1e-4, rpy_rates=1e-4)
# tests/test_soa.py:623-628: backends that reorder the pair sums, 3 control steps
REORDER_LIMITS = dict(pos=1e-4, vel=1e-3, quat=1e-5)
# The binned fleets of phase 7b and 8b: (drones, lattice pitch in m). The
# selection rule reads a lattice of pitch p and side k as (k - 1) / k * p, so
# 2.5 m is the pitch that clears its 2 m threshold at 16384 drones.
BINNED_FLEETS = ((16384, 2.5), (65536, 4.0))
SORTED_T = 12


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
    rows, n_out, kernel, plain_fn = PAIRS[name][:4]
    t = tgt[:rows].contiguous()
    s = t if square else src[:rows].contiguous()
    if name == "K5":
        out = interact_plain(t, c) if plain else kernel(t, c, cull=cull, tiles=tiles)
    elif plain:
        out = plain_fn(t, s, c)
    elif name == "K4":
        out = kernel(t, s, c, cull=cull, tiles=tiles)
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


def pair_error(name, got, want, tgt, contacts=True):
    """``(max |kernel - plain| over the outputs, the wake's report)``; fails
    beyond the wake's limit above or, after the contact deltas, beyond atol
    1e-6 (tests/test_torch_pairs.py). ``contacts`` False: a fleet with no two
    drones in touch, on which no contact may fire."""
    o, note = 0, ""
    if name in ("K2", "K5"):
        note = wake_report(name, got[0], want[0])
        o = 1
    if name in ("K4", "K5"):
        base = tgt[:6]
        gap = float(((base + got[o:]) - (base + want[o:])).abs().max())
        if not gap <= 1e-6:
            fail(f"{name}'s positions or velocities after the deltas differ by {gap:.3g} > 1e-6")
        if (float(got[o:o + 3].abs().max()) > 0) != contacts:
            fail(f"{name}: " + ("no contact fired on a cloud with overlapping pairs" if contacts
                                else "a contact fired on a fleet with no two drones in touch"))
    return float((got - want).abs().max()), note


def as_rows(res):
    """A pass's result (``dw.cols``, ``resolve.cols`` or ``interact.cols``)
    as one (outputs, N) tensor: the wake, then dpx ... dvz."""
    if isinstance(res, torch.Tensor):
        return res[None]
    head = [res[0]] if len(res) == 3 else []
    return torch.stack(head + list(res[-2]) + list(res[-1]))


def pair_launches():
    """Launches of K2 to K6 since the last reset."""
    return {name: d[name][2].launches for d in (PAIRS, MASKED) for name in d}


def masked_overflows():
    """Passes of K3 and K6 that took the overflow branch since the last reset."""
    return {name: MASKED[name][4].overflows for name in MASKED}


def reset_pair_launches():
    for d in (PAIRS, MASKED):
        for name in d:
            d[name][2].launches = 0
    for name in MASKED:
        MASKED[name][4].overflows = 0


def pair_gates(t, s, c, wake=True, contact=True):
    """The tests that decide whether a pair term is not 0, formed as the
    plain pair terms form them: the wake's dz > 0 and dxy^2 < 100 and the
    contact's eps^2 < d^2 < min_dist^2 (d^2 = dxy^2 + dz^2 where both run)."""
    dx, dy, dz = s[0] - t[0], s[1] - t[1], s[2] - t[2]
    dxy2 = dx * dx + dy * dy
    out = [(dz > 0) & (dxy2 < 100.0)] if wake else []
    if contact:
        d2 = dxy2 + dz * dz
        out.append((d2 < c.min_dist2) & (d2 > c.eps2))
    return out


def ops_per_pair(c):
    """Operations per pair, counted on the plain pair terms (1 x 1 inputs),
    plus one accumulating add per output; and "gate K2", "gate K4", "gate
    K5": those of ``pair_gates`` for the wake, the contact and both, which
    every pair a pass evaluates needs. The rest of a term is needed only on
    the pairs its gate lets through."""
    t, s = torch.ones((6, 1, 1)), torch.full((6, 1, 1), 0.75)
    wake = _count(lambda: wake_terms(t, s, c)).total() + 1
    contact = _count(lambda: contact_terms(t, s, c)).total() + 6
    gate = lambda **kw: _count(lambda: pair_gates(t, s, c, **kw)).total()
    return {"K2": wake, "K4": contact, "K5": wake + contact, "gate K2": gate(contact=False),
            "gate K4": gate(wake=False), "gate K5": gate()}


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
    of the pair kernel ``kernel`` (by wrapping ``_pairs.launch_units`` and
    ``_pairs.launch_masked``; the launch counters are the kernel wrappers'
    and stay as they are)."""
    seen, launchers = {}, (_pairs.launch_units, _pairs.launch_masked)

    def recording(launch):
        def call(name, tgt, *args, **kwargs):
            out = launch(name, tgt, *args, **kwargs)
            if name == kernel:
                seen.update(tgt=tgt, out=out)
            return out
        return call

    _pairs.launch_units, _pairs.launch_masked = (recording(f) for f in launchers)
    try:
        yield seen
    finally:
        _pairs.launch_units, _pairs.launch_masked = launchers


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


def kin_gaps(a, b, limits=SWARM_LIMITS):
    return {k: float((getattr(a, k) - getattr(b, k)).abs().max()) for k in limits}


def check_kin_gaps(what, gaps, limits=SWARM_LIMITS):
    bad = [f"{k}: {v:.3g} > {limits[k]}" for k, v in gaps.items() if not v <= limits[k]]
    if bad:
        fail(f"{what}: " + "; ".join(bad))


def per_pass_ms(fn, reps, repeats=REPEATS):
    """Median over ``repeats`` of the CUDA-event time of ``reps`` calls, per
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(event_ms(lambda: [fn() for _ in range(reps)], repeats)) / reps


def traced_kernels(fn, steps):
    """Run ``fn`` once, then ``steps`` times under torch.profiler: ``(the
    device kernels and memsets of the chrome trace in time order, host wall
    seconds)``."""
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
    return sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memset")),
                  key=lambda e: e["ts"]), wall


def device_ms(fn, reps=20):
    """The device time of one call of ``fn``, a kernel's wrapper, under
    torch.profiler over ``reps`` calls, in ms: for each kernel or memset
    name in the trace, its mean duration times the launches a call makes of
    it (its count over ``reps``, rounded), summed. The trace on the H100
    machine now and then loses or gains an event; the rounding keeps such
    an event from moving the sum by a launch. None (printed as not
    measured) if none of three traces holds a launch a call."""
    for _ in range(3):
        kernels, _ = traced_kernels(fn, reps)
        durs = defaultdict(list)
        for e in kernels:
            durs[e["name"]].append(e["dur"])
        per_call = {name: round(len(d) / reps) for name, d in durs.items()}
        if any(per_call.values()):
            return sum(statistics.fmean(d) * per_call[name] for name, d in durs.items()) / 1e3
    return None


def profile_steps(fn, steps):
    """Run ``fn`` ``steps`` times under torch.profiler and read the device's
    kernels from its chrome trace: per step, the host wall time, the time
    the card was busy (the union of kernel and memset intervals), and the
    kernel time of the pair kernels (``PAIR_KERNEL_NAMES``) and of all other
    kernels and memsets, in ms.
    None if the trace holds no kernel."""
    kernels, wall = traced_kernels(fn, steps)
    if not kernels:
        return None
    pair = sum(e["dur"] for e in kernels
               if any(name in e["name"] for name in PAIR_KERNEL_NAMES))
    busy, end = 0.0, -math.inf
    for e in kernels:  # the union of the kernels' [ts, ts + dur) intervals
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    total = sum(e["dur"] for e in kernels)
    return dict(wall_ms=wall * 1e3 / steps, busy_ms=busy / 1e3 / steps,
                pair_ms=pair / 1e3 / steps, other_ms=(total - pair) / 1e3 / steps,
                kernels_per_step=len(kernels) / steps)


def unit_schedule(name, nt, ns, sort, square):
    """The work units the pair kernel ``name`` (K2, K4, K5) runs on, as a
    phrase."""
    triangle = _pairs.units_triangle(PAIRS[name][1], sort, square)
    units, per_unit = _pairs.pair_units(nt, ns, triangle)
    return (f"{len(units)} units of up to {per_unit} tiles, "
            f"{int(units[:, 3].max())} a block at most")


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
        for name in (PAIRS if square else ("K2", "K4")):
            schedule = unit_schedule(name, nt, src.shape[1], sort, square)
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
                  f"z_sort={sort}: {schedule}, max |kernel - plain| "
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
            want = (dict(K2=SWARM_T, K4=SWARM_T, K5=4 * SWARM_T, K3=0, K6=0) if coll
                    else dict(K2=5 * SWARM_T, K4=0, K5=0, K3=0, K6=0))
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
        want = (dict(K2=1, K4=1, K5=4, K3=0, K6=0) if coll
                else dict(K2=5, K4=0, K5=0, K3=0, K6=0))
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


def needed_pairs(cols, c, gates=None, real=None):
    """(wake pairs, contact pairs) of the square fleet ``cols`` (3 or more,
    N) on the card: the pairs that ``pair_gates`` lets through, whose wake
    term needs a reciprocal and an exponent, or whose contact term needs a
    reciprocal square root. ``gates(r0, r1)``, for the masked passes, gives
    the (wake, contact) (r1 - r0, N) bools of the pairs the masks leave, and
    ``real`` the bool column of real slots: only pairs of real drones that
    the masks leave are counted. In row chunks."""
    n, wake, touch = cols.shape[1], 0, 0
    for r0 in range(0, n, 1024):
        r1 = min(r0 + 1024, n)
        w, t = pair_gates(cols[:3, r0:r1, None], cols[:3, None, :], c)
        if gates is not None:
            gw, gc = gates(r0, r1)
            w, t = w & gw, t & gc
        if real is not None:
            both = real[r0:r1, None] & real[None, :]
            w, t = w & both, t & both
        wake += int(w.sum())
        touch += int(t.sum())
    return wake, touch


def op_bound(kind, ops, gated, needed, nbytes):
    """``(bound ms, bound_by, the ceilings in ms)`` of one pass of the
    function of ``kind`` (K2: the wake, K4: the contact, K5: both), the
    largest of three ceilings. Operations over the float32 peak: the gates
    on the pairs the pass must test, ``gated`` = (wake, contact) pairs (all
    pairs, or those the culls or masks leave), the contact's own part of
    the gate only where both run, and the rest of each term on the pairs
    its gate lets through, ``needed`` = (wake, contact) from
    ``needed_pairs``. Special-function ops over the MUFU rate: two a wake
    pair and one a contact pair of ``needed``. ``nbytes`` over the memory
    rate."""
    wake_ops, contact_ops = ops["K2"] - ops["gate K2"], ops["K4"] - ops["gate K4"]
    if kind == "K2":
        flops, mufu = ops["gate K2"] * gated[0] + wake_ops * needed[0], 2 * needed[0]
    elif kind == "K4":
        flops, mufu = ops["gate K4"] * gated[1] + contact_ops * needed[1], needed[1]
    else:
        flops = (ops["gate K2"] * gated[0] + (ops["gate K5"] - ops["gate K2"]) * gated[1]
                 + wake_ops * needed[0] + contact_ops * needed[1])
        mufu = 2 * needed[0] + needed[1]
    ceilings = {"float32 operations": flops / PEAK_FP32_FLOPS * 1e3,
                "MUFU": mufu / PEAK_MUFU_PER_S * 1e3, "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    top = max(ceilings, key=ceilings.get)
    return ceilings[top], "bytes" if top == "bytes" else "operations", ceilings


def phase8_times(dev, c, params, ops):
    """Each pair kernel's time per pass (CUDA events and device time), its
    plain version's and its bound; then the swarm step per control step."""
    res = {}
    fmt = lambda d: json.dumps({k: None if v is None else float(f"{v:.5g}") for k, v in d.items()})
    for n in SWARM_N:
        cols = pair_cloud(dev, n)[0]
        need = needed_pairs(cols, c)
        for sort in (False, True) if n >= _pairs.Z_SORT_MIN_N else (False,):
            t = _pairs.sort_by_z(cols)[0] if sort else cols
            total = math.ceil(n / _pairs.BLOCK) ** 2
            for name in PAIRS:
                tiles = torch.zeros(2, dtype=torch.int32, device=dev)
                pair_pass(name, t, t, c, sort, True, tiles=tiles)
                counts = tiles.tolist()
                run = lambda: pair_pass(name, t, t, c, sort, True)
                k_ms, d_ms = per_pass_ms(run, 20), device_ms(run)
                p_ms = per_pass_ms(lambda: pair_pass(name, t, t, c, sort, True, plain=True), 1, 3)
                # The pairs the gates must test: all N^2, or those of the
                # tiles the culls leave.
                gated = [x * _pairs.BLOCK ** 2 for x in counts] if sort else [n * n] * 2
                rows, n_out = PAIRS[name][:2]
                bound_ms, bound_by, ceilings = op_bound(name, ops, gated, need,
                                                        (rows + n_out) * n * 4)
                res[(name, n, sort)] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                                            bound_ms=bound_ms, bound_by=bound_by)
                device = ("not measured" if d_ms is None else
                          f"{d_ms:.5f} ms ({n * n / (d_ms / 1e3):.4g} pairs/s over N^2, time/bound "
                          f"{d_ms / bound_ms:.2f})")
                print(f"[8] {name} N={n} z_sort={sort}: device {device} per pass "
                      f"(torch.profiler), events {k_ms:.5f} ms (time/bound {k_ms / bound_ms:.2f}), "
                      f"plain {p_ms:.3f} ms; bound {bound_ms:.5f} ms by {bound_by}, ceilings "
                      f"{fmt(ceilings)} ms (gates on {gated} wake / contact pairs, the rest of "
                      f"the terms on {need[0]} wake pairs with dz > 0 within 10 m and {need[1]} "
                      f"pairs in touch; ops per pair {ops[name]} in all, {ops['gate ' + name]} "
                      f"of gates; {PEAK_FP32_FLOPS:.3g} ops/s, {PEAK_MUFU_PER_S:.4g} MUFU/s); "
                      f"{unit_schedule(name, n, n, sort, True)}, tiles left by the culls "
                      f"{counts} of {total}; library_ms null (no PyTorch call computes this "
                      "function)", flush=True)

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
        runs = {name: (lambda name=name: pair_pass(name, cols, cols, c, sort, True))
                for name in PAIRS}
        lat_events = {name: per_pass_ms(run, 20) for name, run in runs.items()}
        lat_dev = {name: device_ms(run) for name, run in runs.items()}
        print(f"[8] pair kernels on the swarm lattice N={n} z_sort={sort}: ms per pass, device "
              f"(torch.profiler; null: not measured) {fmt(lat_dev)}, events {fmt(lat_events)}",
              flush=True)
        for coll in (False, True):
            step = make_swarm_step_soa(params, 1 / 240, 5, collisions=coll)
            state = [swarm_soa_from_kin(kin)]

            def advance():
                state[0] = step(state[0], rpm)

            ms = per_pass_ms(advance, 10, 3)
            if all(lat_dev[name] is not None for name, k in per_step[coll].items() if k):
                pair_ms = sum(k * lat_dev[name] for name, k in per_step[coll].items() if k)
                split = (f"pair kernels {pair_ms:.4f} ms (launches per step x device ms per pass "
                         f"above), the rest (substep chain, sort, gather, scatter, stacking) "
                         f"{ms - pair_ms:.4f} ms")
            else:
                split = "pair kernels' device time not measured"
            print(f"[8] swarm step N={n} collisions={coll} z_sort={sort}: {ms:.4f} ms per control "
                  f"step ({n / (ms / 1e3):.6g} drone-steps/s); {split}", flush=True)
            prof = profile_steps(advance, 5)
            if prof is None:
                print("[8]   torch.profiler saw no device kernel: not measured", flush=True)
            else:
                # The profiler's own host work stretches the wall time it
                # sees; the idle share is taken against the event time above.
                print(f"[8]   under torch.profiler, per control step: card busy "
                      f"{prof['busy_ms']:.4f} ms, idle share {1 - prof['busy_ms'] / ms:.4f} "
                      f"(1 - busy / {ms:.4f} ms event time), pair kernels "
                      f"{prof['pair_ms']:.4f} ms, other kernels and memsets "
                      f"{prof['other_ms']:.4f} ms, {prof['kernels_per_step']:.0f} kernels and "
                      f"memsets in all; wall {prof['wall_ms']:.4f} ms "
                      "with the profiler's overhead", flush=True)
    return res


def masked_case(dev, c, params, n, n_src, order, cone, with_valid, contact, seed=5):
    """Phase 6b's inputs: phase 6's cloud in ``order`` ("perm": a random
    permutation; "z", "morton": sorted by that key), its live words, dense
    and compacted (the cap at every source tile, so that it holds), and the
    bool column of real slots. ``with_valid`` turns a fifth of the slots into
    a binned layout's padding sentinels."""
    tgt, src = pair_cloud(dev, n, n_src)
    gen = torch.Generator().manual_seed(seed)

    def ordered(cols):
        if order == "perm":
            o = torch.randperm(cols.shape[1], generator=gen).to(dev)
        else:
            o = torch.argsort(spatial.sort_key(cols[0], cols[1], cols[2], order), stable=True)
        return cols[:, o].contiguous()

    src = ordered(src)
    tgt = src if n_src is None else ordered(tgt)
    valid = src_valid = None
    if with_valid:
        sent = torch.tensor([0.0, 0.0, -1e9, 0.0, 0.0, 0.0], device=dev)[:, None]
        src_valid = (torch.rand(src.shape[1], generator=gen) < 0.8).to(dev)
        src = torch.where(src_valid, src, sent).contiguous()
        if n_src is None:
            tgt, valid = src, src_valid
        else:
            valid = (torch.rand(n, generator=gen) < 0.8).to(dev)
            tgt = torch.where(valid, tgt, sent).contiguous()
    bt = bs = _pairs.BLOCK
    sub = spatial.subtile_count(bs)
    words = spatial.subtile_packed_mask(
        tgt[0], tgt[1], tgt[2], bt, bs, min_dist=c.min_dist if contact else None, params=params,
        cone=cone, valid=valid, src_cols=None if n_src is None else tuple(src[:3]),
        src_valid=None if n_src is None else src_valid, sub=sub)
    nt, ns = tgt.shape[1] // bt, src.shape[1] // bs
    lists, count_max = spatial.compact_live_tiles(words, nt, ns, ns)
    real = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid
    return dict(tgt=tgt, src=src, words=words, lists=lists, count_max=int(count_max), real=real,
                valid=valid, dense=_pairs.TileGrid(bt, bs, sub, ns, False),
                compact=_pairs.TileGrid(bt, bs, sub, ns, True))


def check_padding_rows(what, outs, real):
    """Every output of ``outs`` (kernel and plain, (outputs, Nt)) is exactly
    0 on the padding targets (``real`` false)."""
    for out in outs:
        if not bool((out[:, ~real] == 0).all()):
            fail(f"{what}: a padding target's row is not 0")


def live_share(words, grid, section):
    """The share of (target tile, source sub-slice) pairs whose bit is set in
    ``section`` (0: wake, 1: contact) of dense words."""
    bits = (words.to(torch.int64) >> (8 * section)) & 0xFF
    count = sum(int(((bits >> k) & 1).sum()) for k in range(grid.sub))
    return count / (words.numel() * grid.sub)


def live_pairs(words, grid, section, valid=None):
    """Pairs in the sub-slices that ``section`` of the square dense words
    leaves live: slot pairs, which the kernel evaluates, or with ``valid``
    the pairs of real drones among them, which the function needs."""
    n_tiles = grid.row_len
    real = (torch.ones(n_tiles * grid.bs, device=words.device) if valid is None else valid)
    bits = torch.arange(grid.sub, device=words.device) + 8 * section
    live = ((words.reshape(n_tiles, n_tiles, 1).to(torch.int64) >> bits) & 1).double()
    tgt = real.reshape(n_tiles, grid.bt).sum(1, dtype=torch.float64)
    src = real.reshape(n_tiles, grid.sub, grid.bs // grid.sub).sum(2, dtype=torch.float64)
    return float((tgt[:, None, None] * live * src[None]).sum())


def phase6b_masked(dev, c, params):
    """K3 and K6 against their plain versions on the card."""
    errs = {name: 0.0 for name in MASKED}
    expect = Counter()
    before = pair_launches()
    cases = [(4096, None, "perm", True, False), (4096, None, "perm", False, True),
             (16384, None, "perm", True, False), (16384, None, "z", True, True),
             (16384, None, "morton", False, False), (4096, 16384, "perm", True, True)]
    for n, n_src, order, cone, with_valid in cases:
        for name in MASKED:
            rows, n_out, kernel, plain, _, _ = MASKED[name]
            k = masked_case(dev, c, params, n, n_src, order, cone, with_valid, name == "K6")
            tgt, src, real = k["tgt"][:rows].contiguous(), k["src"][:rows].contiguous(), k["real"]
            valid = k["valid"]
            got = kernel(tgt, src, k["words"], k["dense"], c, valid).reshape(n_out, -1)
            packed = kernel(tgt, src, k["lists"], k["compact"], c, valid).reshape(n_out, -1)
            again = kernel(tgt, src, k["lists"], k["compact"], c, valid).reshape(n_out, -1)
            want = plain(tgt, src, k["words"], k["dense"], c, valid).reshape(n_out, -1)
            torch.cuda.synchronize()
            expect[name] += 3
            what = (f"{name} {'square' if n_src is None else 'rectangular'} {n}x{src.shape[1]} "
                    f"order={order} cone={cone} valid={with_valid}")
            if not torch.equal(packed, got):
                fail(f"{what}: the compacted grid differs from the dense masked grid")
            if not torch.equal(again, packed):
                fail(f"{what}: a second pass differs from the first")
            check_padding_rows(what, (got, want), real)
            err, note = pair_error("K2" if name == "K3" else "K5", got[:, real], want[:, real],
                                   tgt[:, real])
            errs[name] = max(errs[name], err)
            # The masks drop nothing: the unmasked plain wake agrees too.
            wake_report(name, got[0][real], downwash_plain(tgt[:3].contiguous(),
                                                           src[:3].contiguous(), c)[real])
            shares = [live_share(k["words"], k["dense"], sec) for sec in range(1 + (name == "K6"))]
            if order != "perm" and n_src is None and not all(x < 1.0 for x in shares):
                fail(f"{what}: the masks left every sub-slice live on a sorted cloud")
            split = _pairs.masked_split(tgt.shape[1], k["dense"].bt, k["dense"].bs, k["dense"].sub)
            print(f"[6b] {what}: tiles {k['dense'].bt}x{k['dense'].bs} in {k['dense'].sub} "
                  f"sub-slices, S={split}, compacted = dense masked = a second pass bit for bit, "
                  f"padding rows 0 ({int((~real).sum())}) (longest live list "
                  f"{k['count_max']} of {k['dense'].row_len}), max |kernel - plain| {err:.3g}, "
                  f"live sub-slice share {[float(f'{x:.4g}') for x in shares]}; {note}",
                  flush=True)
    after = pair_launches()
    rose = {name: after[name] - before[name] for name in MASKED}
    if rose != dict(expect):
        fail(f"the masked kernels' launch counts rose by {rose}, not {dict(expect)}")

    # A forced small cap takes the overflow branch, and the counters say so.
    cols = pair_cloud(dev, SWARM_N[0])[0]
    x = [cols[i] for i in range(6)]
    for name, args, sorted_name in (("K3", x[:3], "K2"), ("K6", x, "K5")):
        make = MASKED[name][4]
        ref = as_rows(make(params, device=dev).cols(*args))
        for fallback in (True, False):
            reset_pair_launches()
            got = as_rows(make(params, neighbor_cap=1, dense_fallback=fallback,
                               device=dev).cols(*args))
            torch.cuda.synchronize()
            counts, over = pair_launches(), masked_overflows()
            want = {k: 0 for k in counts} | {name if fallback else sorted_name: 1}
            if counts != want or over[name] != 1:
                fail(f"{name} neighbor_cap=1 dense_fallback={fallback}: launches {counts} and "
                     f"overflows {over}, not {want} and 1")
            if fallback and not torch.equal(got, ref):
                fail(f"{name}: the dense fallback differs from the dense masked grid")
            err, note = pair_error(sorted_name, got, ref, cols)
            print(f"[6b] {name} whole pass N={SWARM_N[0]} neighbor_cap=1 dense_fallback="
                  f"{fallback}: overflow branch taken once ({'dense masked grid' if fallback else 'z-sorted ' + sorted_name}), "
                  f"launches {({k: v for k, v in counts.items() if v})}, max |diff| against the "
                  f"dense masked pass {err:.3g}; {note}", flush=True)
    reset_pair_launches()
    return errs


def cell_aligned(s, n, cap):
    """True if the binned state ``s`` holds its ``n`` drones cell by cell:
    each cell block's real slots first, and not the dense layout that a
    cell over ``cap`` falls back to."""
    blocks = s["valid"].reshape(-1, cap).to(torch.int8)
    firsts = bool((blocks[:, 1:] <= blocks[:, :-1]).all())
    dense = bool(s["valid"][:n].all())
    ids = s["ids"][s["valid"]]
    once = bool(torch.equal(torch.sort(ids).values, torch.arange(n, device=ids.device)))
    return firsts and not dense and once


def ground_report(what, kin, k6, real, pc, z_min):
    """Phase 7's ground rule for a run whose last pair pass was K6: the clamp
    held before it on the real slots, the final z is its result, and no
    drone sits deeper below the clamp than max_push times the partners it
    had in that pass."""
    pre, delta = k6["tgt"][:, real], k6["out"][:, real]
    if not float(pre[2].min()) >= z_min:
        fail(f"{what}: z {float(pre[2].min())} < the clamp {z_min} before the last pair pass")
    after = pre[2] + delta[3]
    if not torch.equal(torch.sort(after).values, torch.sort(kin.pos[:, 2]).values):
        fail(f"{what}: the final z is not the last pair pass's result")
    partners = contact_partners(pre[:3].contiguous(), pc)
    room = pc.max_push * partners.to(torch.float32) + 1e-6
    depth = torch.clamp(float(z_min) - after, min=0.0)
    if not bool((depth <= room).all()):
        i = int((depth - room).argmax())
        fail(f"{what}: a drone is {float(depth[i])} m below the clamp with "
             f"{int(partners[i])} partners in the last pair pass")
    return (f"min z {float(kin.pos[:, 2].min()):.6f} (clamp {z_min}; held before the last pair "
            f"pass; {int((depth > 0).sum())} drones below it, each within max_push x its "
            f"partners)")


def run_masked_backend(what, triple, kin, rpm, steps, coll, pc, z_min):
    """Drive ``(init, step, export)`` of a backend on K3 / K6 for ``steps``
    control steps with the counters reset before and read after, and check
    the launches, the overflows, finiteness, the ground rule and export."""
    init, step, export = triple
    n = kin.pos.shape[0]
    reset_pair_launches()
    t0 = time.perf_counter()
    with last_launch(interact_pairs.MASKED_NAME) as k6:
        s = init(kin)
        if not torch.equal(export(s, kin).pos, kin.pos):
            fail(f"{what}: export(init(kin)) does not return the drones in their order")
        for _ in range(steps):
            s = step(s, rpm)
        out = export(s, kin)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, over = pair_launches(), masked_overflows()
    want = dict(K2=0, K4=0, K5=0, K3=1 + (0 if coll else 5 * steps), K6=5 * steps if coll else 0)
    if got != want:
        fail(f"{what}: launches {got}, not {want}")
    if any(over.values()):
        fail(f"{what}: {over} passes took the overflow branch")
    leaves = (out.pos, out.quat, out.vel, out.ang_v, out.rpy_rates)
    if not all(bool(torch.isfinite(x).all()) for x in leaves):
        fail(f"{what}: the state is not finite")
    if out.pos.shape != (n, 3):
        fail(f"{what}: export returned {tuple(out.pos.shape)} positions for {n} drones")
    if coll:
        real = s["valid"] if "valid" in s else torch.ones(n, dtype=torch.bool, device=kin.pos.device)
        ground = ground_report(what, out, k6, real, pc, z_min)
    else:
        low = float(out.pos[:, 2].min())
        if not low >= z_min:
            fail(f"{what}: a drone is at z {low} < the clamp {z_min}")
        ground = f"min z {low:.6f} (clamp {z_min})"
    print(f"[7b] {what}: {steps} control steps in {wall:.3f} s wall, launches "
          f"{({k: v for k, v in got.items() if v})}, overflow passes 0, finite, {ground}",
          flush=True)
    return got, s, out


def phase7b_backends(dev, params):
    """The binned and the sorted backends through make_swarm_physics."""
    hover = float(params.hover_rpm)
    pc = _pairs.pair_consts(params)
    z_min = np.float32(float(params.collision_h) / 2.0 - float(params.collision_z_offset))
    main = Counter()
    identity = lambda n: np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    for n, pitch in BINNED_FLEETS:
        pos = lattice(n, pitch)
        backend = select_swarm_backend(pos)
        if backend != "binned":
            fail(f"select_swarm_backend picked {backend!r} at N={n}, pitch {pitch} m")
        cell, nx, ny, cap = binned_geometry(pos)
        print(f"[7b] N={n} pitch {pitch} m: backend {backend}, cell {cell} m, grid {nx} x {ny}, "
              f"cap {cap}, {nx * ny * cap} slots", flush=True)
        kin = init_kin_state(pos, identity(n), device=dev)
        rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
        for coll in (False, True):
            triple = make_swarm_physics(params, 1 / 240, 5, collisions=coll, init_pos=pos)
            what = f"binned N={n} pitch {pitch} m collisions={coll}"
            got, s, _ = run_masked_backend(what, triple, kin, rpm, SWARM_T, coll, pc, z_min)
            if s["valid"].shape != (nx * ny * cap,) or not cell_aligned(s, n, cap):
                fail(f"{what}: the layout is not cell-aligned in {nx} x {ny} cells of {cap}")
            main.update(got)

    n = BINNED_FLEETS[0][0]
    pos = lattice(n, 2.0)
    kin = init_kin_state(pos, identity(n), device=dev)
    rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
    for order in ("z", "morton"):
        for coll in (False, True):
            triple = make_swarm_physics(params, 1 / 240, 5, collisions=coll, backend="soa",
                                        sorted=True, order=order)
            what = f"sorted N={n} order={order} collisions={coll}"
            got, _, _ = run_masked_backend(what, triple, kin, rpm, SORTED_T, coll, pc, z_min)
            main.update(got)

    # Across backends on the card, on fleets that are robust to the order of
    # the pair sums (tests/test_soa.py:568-587): without contact the 2 m
    # lattice with +-0.4 m jitter; with contact, where that lattice has no
    # two drones in touch, co-planar contact pairs beside unique-z towers.
    rng = np.random.RandomState(11)
    fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})
    for coll in (False, True):
        fpos, fvel = (contact_fleet(n) if coll
                      else (pos, rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)))
        kin = fleet_kin(fpos, fvel, dev)
        outs = {}
        # The towers' levels drift through dz = 0.6875 m, where float32 beta
        # = c2 dz + c3 is exactly 0 and the wake term is 0, so the z order is
        # also run with the cone cull off: the cull must not move the state
        # (scripts/torch_cone_guard.py lists any term a culled sub-slice holds).
        for name, kw in (("soa", dict(backend="soa")),
                         ("binned", dict(backend="binned", init_pos=fpos)),
                         ("sorted z", dict(backend="soa", sorted=True, order="z")),
                         ("sorted z, cone off", dict(order="z", cone=False)),
                         ("sorted morton", dict(backend="soa", sorted=True, order="morton"))):
            make = make_swarm_physics if "backend" in kw else make_sorted_swarm
            init, step, export = make(params, 1 / 240, 5, collisions=coll, **kw)
            s = init(kin)
            for _ in range(3):
                s = step(s, rpm)
            outs[name] = export(s, kin)
        torch.cuda.synchronize()
        line, gaps = [], {}
        for name in ("binned", "sorted z", "sorted z, cone off", "sorted morton"):
            gaps[name] = kin_gaps(outs[name], outs["soa"], REORDER_LIMITS)
            check_kin_gaps(f"{name} against soa, N={n}, collisions={coll}", gaps[name],
                           REORDER_LIMITS)
            line.append(f"{name} {fmt(gaps[name])}")
        # The cone cull drops only pairs whose term is exactly 0 (the wake
        # term is 0 where float32 beta is 0), so the cone on is as close to
        # "soa" as the cone off.
        on, off = gaps["sorted z"], gaps["sorted z, cone off"]
        if not all(on[k] <= 10 * off[k] for k in on):
            fail(f"sorted z with the cone cull, N={n}, collisions={coll}: {fmt(on)} against "
                 f"'soa', more than 10x the cone-off gap {fmt(off)}")
        same = all(bool(torch.equal(getattr(outs["sorted z"], k),
                                    getattr(outs["sorted z, cone off"], k))) for k in on)
        line.append(f"cone on within 10x of cone off, the same state bit for bit: {same}")
        moved = ""
        if coll:  # contact and wake both moved what is compared
            push = float((outs["binned"].pos[:n // 2, :2] - kin.pos[:n // 2, :2]).abs().max())
            dvz = (outs["binned"].vel[n // 2:, 2] - kin.vel[n // 2:, 2]).reshape(-1, 8)
            sink = float(dvz[:, 0].mean() - dvz[:, 7].mean())
            if not (push > 1e-4 and sink < -0.1):
                fail(f"across backends with contact: the pairs moved {push} m and the towers' "
                     f"lowest drones sank {-sink} m/s faster than their highest")
            moved = (f"; contact moved the pairs by up to {push:.4f} m and the towers' lowest "
                     f"drones sank {-sink:.4f} m/s faster than their highest")
        print(f"[7b] N={n} {'co-planar pairs beside towers' if coll else 'pitch 2 m'}, 3 control "
              f"steps, collisions={coll}, against backend 'soa' (limits "
              f"{json.dumps(REORDER_LIMITS)}): " + "; ".join(line) + moved, flush=True)

    # The binned kernel path on the card against the binned plain path on the CPU.
    n = SWARM_N[0]
    params_cpu = params.to("cpu")
    rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
    for coll, (fpos, fvel) in ((False, towers(n)), (True, contact_fleet(n))):
        geo = dict(zip(("cell_size", "nx", "ny", "cap"), binned_geometry(fpos)))
        runs = {}
        for key, p, d in (("card", params, dev), ("cpu", params_cpu, "cpu")):
            init, step, export = make_binned_swarm(p, 1 / 240, 5, collisions=coll, device=d, **geo)
            k0 = fleet_kin(fpos, fvel, d)
            runs[key] = export(step(init(k0), [r.to(d) for r in rpm]), k0)
        gaps = kin_gaps(runs["card"], runs["cpu"].to(dev))
        check_kin_gaps(f"binned step, kernels on the card against plain on the CPU, "
                       f"collisions={coll}", gaps)
        towers_at = slice(n // 2, n) if coll else slice(0, n)
        dvz = (runs["card"].vel[towers_at, 2]
               - torch.as_tensor(fvel[towers_at, 2], device=dev)).reshape(-1, 8)
        sink = float(dvz[:, 0].mean() - dvz[:, 7].mean())
        if not sink < -0.1:
            fail(f"binned collisions={coll}: the wake did not move the towers ({sink} m/s)")
        if coll and not float((runs["card"].pos[:n // 2, :2].cpu()
                               - torch.as_tensor(fpos[:n // 2, :2])).abs().max()) > 1e-4:
            fail("binned: no contact fired in the co-planar pairs")
        print(f"[7b] binned N={n} {'co-planar pairs beside towers' if coll else 'towers'}, "
              f"collisions={coll}, one control step, geometry {json.dumps(geo)}: kernels on the "
              f"card against plain on the CPU {fmt(gaps)} (the towers' lowest drones sink "
              f"{-sink:.4f} m/s faster than their highest)", flush=True)
    return main


def touching_fleet(pos, seed=3):
    """``pos`` with every 64th drone moved into contact with the one before
    it (phase 6's overlapping pairs), and velocities of up to 0.5 m/s."""
    pos = pos.copy()
    pos[1::64] = pos[0::64][:len(pos[1::64])] + np.array([0.08, 0.0, 0.05], np.float32)
    vel = np.random.RandomState(seed).uniform(-0.5, 0.5, pos.shape).astype(np.float32)
    return pos, vel


def layout_pass(name, cols, valid, c, params, tile, nbr):
    """The masked pass ``name`` as a swarm step gives it to its kernel:
    (6, N) columns ``cols`` (binned slots, or the sorted fleet), tiles of
    ``tile`` targets and sources (a binned cell block, or the sorted loop's
    256), ``valid`` the real slots or None, the live words dense and
    compacted at ``nbr`` slots a row."""
    rows = MASKED[name][0]
    t = cols[:rows].contiguous()
    n_tiles = t.shape[1] // tile
    sub = spatial.subtile_count(tile)
    mask_fn = lambda: spatial.subtile_packed_mask(
        t[0], t[1], t[2], tile, tile, min_dist=c.min_dist if name == "K6" else None,
        params=params, valid=valid, sub=sub)
    words = mask_fn()
    compact_fn = lambda: spatial.compact_live_tiles(words, n_tiles, n_tiles, nbr)
    lists, count_max = compact_fn()
    if int(count_max) > nbr:
        fail(f"{name}: a row holds {int(count_max)} live tiles, over the cap {nbr}")
    real = torch.ones(t.shape[1], dtype=torch.bool, device=t.device) if valid is None else valid
    return dict(t=t, valid=valid, real=real, words=words, lists=lists, count_max=int(count_max),
                mask_fn=mask_fn, compact_fn=compact_fn,
                dense=_pairs.TileGrid(tile, tile, sub, n_tiles, False),
                compact=_pairs.TileGrid(tile, tile, sub, nbr, True))


def hold_layout_pass(what, name, k, c, contacts):
    """The kernel on the layout ``k``, dense and compacted, against its plain
    version on the real slots, at phase 6's limits; padding rows exactly 0
    in both; the wake also against the unmasked plain wake of the real
    drones alone (the masks and the padding drop and add nothing). Returns
    the largest |kernel - plain|, a note and the plain version's time."""
    _, n_out, kernel, plain, _, _ = MASKED[name]
    t, valid, real = k["t"], k["valid"], k["real"]
    got = kernel(t, t, k["words"], k["dense"], c, valid).reshape(n_out, -1)
    packed = kernel(t, t, k["lists"], k["compact"], c, valid).reshape(n_out, -1)
    if not torch.equal(packed, got):
        fail(f"{what}: the compacted grid differs from the dense masked grid")
    want = plain(t, t, k["words"], k["dense"], c, valid).reshape(n_out, -1)
    torch.cuda.synchronize()
    check_padding_rows(what, (got, want), real)
    ms_plain = event_ms(lambda: plain(t, t, k["words"], k["dense"], c, valid), 1)[0]
    err, note = pair_error("K2" if name == "K3" else "K5", packed[:, real], want[:, real],
                           t[:, real], contacts)
    alone = t[:3, real].contiguous()
    wake_report(name, packed[0][real], downwash_plain(alone, alone, c))
    return err, note, ms_plain


def skipped_share(real, tile):
    """(blocks of 32 targets with no real one, all blocks, the share of the
    padding targets that sit in such blocks): what K3 and K6 skip."""
    groups = math.ceil(tile / 32)
    r = torch.nn.functional.pad(real.reshape(-1, tile), (0, groups * 32 - tile), value=False)
    empty = ~r.reshape(-1, groups, 32).any(-1)
    pad = int((~real).sum())
    in_empty = int(empty.sum()) * 32 - int(empty[:, -1].sum()) * (groups * 32 - tile)
    return int(empty.sum()), empty.numel(), (in_empty / pad if pad else 0.0)


def masked_fleet(what, fleet, touch, c, params, ops, tile, nbr):
    """K3 and K6 on one fleet at the shapes a swarm step gives them.
    ``fleet`` and ``touch`` are ((6, N) columns, valid or None): the fleet,
    and the same fleet with drones in touch. Each kernel is held against its
    plain version, then timed per pass, dense and compacted, at S from the
    rule and at every S, and with the padding skip off; beside its bound for
    the pairs of real drones the masks leave, K2 / K5 z-sorted on the same
    drones and the plain version. Returns the numbers of the compacted pass."""
    res = {}
    cols, valid = fleet
    real = torch.ones(cols.shape[1], dtype=torch.bool, device=cols.device) if valid is None else valid
    zsorted = _pairs.sort_by_z(cols[:, real].contiguous())[0]
    n, slots = int(real.sum()), cols.shape[1]
    skipped, blocks, pad_share = skipped_share(real, tile)
    for name, sorted_name in (("K3", "K2"), ("K6", "K5")):
        rows, n_out, kernel = MASKED[name][:3]
        label = f"{name} {what}"
        k = layout_pass(name, cols, valid, c, params, tile, nbr)
        err, note, ms_plain = hold_layout_pass(label, name, k, c, False)
        k_touch = layout_pass(name, touch[0], touch[1], c, params, tile, nbr)
        err_touch, note_touch, _ = hold_layout_pass(label + " with drones in touch", name, k_touch,
                                                    c, True)
        t, words, lists, dense, compact = (k[x] for x in ("t", "words", "lists", "dense",
                                                          "compact"))
        split = _pairs.masked_split(slots, tile, tile, dense.sub)
        ms_dense = per_pass_ms(lambda: kernel(t, t, words, dense, c, valid), 10)
        ms_compact = per_pass_ms(lambda: kernel(t, t, lists, compact, c, valid), 10)
        by_split = {s: per_pass_ms(lambda: kernel(t, t, lists, compact, c, valid, s), 10)
                    for s in _pairs.MASKED_SPLITS}
        ms_noskip = (per_pass_ms(lambda: kernel(t, t, lists, compact, c, None), 10)
                     if valid is not None else ms_compact)
        ms_mask = per_pass_ms(k["mask_fn"], 10)
        ms_lists = per_pass_ms(k["compact_fn"], 10)
        ms_read = per_pass_ms(lambda: int(k["compact_fn"]()[1]), 10) - ms_lists
        ms_sorted = per_pass_ms(lambda: pair_pass(sorted_name, zsorted, zsorted, c, True, True), 10)
        d_ms = device_ms(lambda: kernel(t, t, lists, compact, c, valid))
        sections = range(1 + (name == "K6"))
        # The gates are tested on the pairs of real drones in the live
        # sub-slices (the kernel also evaluates their padding slots), the
        # rest of the terms on those the gates and the masks let through.
        pairs = [live_pairs(words, dense, sec, valid) for sec in sections]
        slot_pairs = [live_pairs(words, dense, sec) for sec in sections]
        live = _pairs.slice_gates(words, dense, slots, slots)
        need = needed_pairs(t, c, lambda r0, r1: [_pairs.pair_gate(x, dense, r0, r1)
                                                  for x in live], real)
        nbytes = (2 * rows + n_out) * slots * 4 + lists.numel() * 4
        bound_ms, bound_by, ceilings = op_bound(sorted_name, ops, pairs + [0.0], need, nbytes)
        res[name] = dict(ms=ms_compact, device_ms=d_ms, plain_ms=ms_plain, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=max(err, err_touch))
        shares = [live_share(words, dense, sec) for sec in sections]
        short = lambda xs: [float(f"{x:.4g}") for x in xs]
        held = _pairs.masked_blocks_per_sm(name == "K6", split)
        print(f"[8b] {label} ({n} drones in {slots} slots, tiles {tile}x{tile} in {dense.sub} "
              f"sub-slices, S={split}, {held} blocks of {32 * split} threads resident per SM), "
              f"kernel against plain on the real slots, dense and compacted (bit-equal, padding "
              f"rows 0): max |kernel - plain| {err:.3g}, no contact fired; {note}; with drones "
              f"in touch {err_touch:.3g}; {note_touch}", flush=True)
        device = ("not measured" if d_ms is None else
                  f"{d_ms:.5f} ms (time/bound {d_ms / bound_ms:.2f})")
        print(f"[8b] {label}: compacted (cap {nbr}, longest list {k['count_max']}) "
              f"{ms_compact:.5f} ms per pass (events), device {device} (torch.profiler), dense "
              f"masked {ms_dense:.5f} ms; bound {bound_ms:.5f} ms by {bound_by}, ceilings "
              f"{json.dumps({x: float(f'{v:.4g}') for x, v in ceilings.items()})} ms (live "
              f"sub-slice share {short(shares)}; pairs of real drones in them {short(pairs)}, "
              f"slot pairs of the live sub-slices {short(slot_pairs)}, of {slots * slots:.4g}; "
              f"of those the gates let through {list(need)} wake / contact; {nbytes} bytes); "
              f"{sorted_name} z-sorted on the {n} real drones {ms_sorted:.5f} ms; plain "
              f"{ms_plain:.3f} ms (one run); library_ms null (no PyTorch call computes this "
              "function)", flush=True)
        print(f"[8b] {label}: compacted per pass by S "
              f"{json.dumps({s: float(f'{v:.5g}') for s, v in by_split.items()})} ms; padding "
              f"skip: {skipped} of {blocks} blocks of 32 targets hold no real one "
              f"({pad_share:.4f} of the padding targets), {ms_noskip:.5f} ms per pass with "
              f"valid=None; mask ops {ms_mask:.5f} ms, compaction {ms_lists:.5f} ms, the "
              f"overflow check's host read {ms_read:.5f} ms per pass (event time with the read "
              "less without)", flush=True)
    return res


def phase8b_times(dev, c, params, ops):
    """K3 and K6 on the binned fleets and the sorted fleet, at the shapes the
    main path gives them: held against their plain versions, then timed per
    pass; and the binned and sorted steps per control step. Returns the
    kernels' numbers at the larger binned fleet (compacted grid, the main
    path's form), with the largest error over all fleets."""
    hover = float(params.hover_rpm)
    res = {}
    identity = lambda n: np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    slot_cols = lambda s: torch.stack([s[k] for k in ("px", "py", "pz", "vx", "vy", "vz")])
    for n, pitch in BINNED_FLEETS:
        pos = lattice(n, pitch)
        cell, nx, ny, cap = binned_geometry(pos)
        geo = dict(cell_size=cell, nx=nx, ny=ny, cap=cap)
        kin = init_kin_state(pos, identity(n), device=dev)
        rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
        init = make_binned_swarm(params, 1 / 240, 5, **geo)[0]
        s = init(kin)
        # The same fleet with drones in touch, in the same cells and tiles:
        # the main path's lattice fires no contact.
        s_touch = init(fleet_kin(*touching_fleet(pos), dev))
        if not (cell_aligned(s, n, cap) and cell_aligned(s_touch, n, cap)):
            fail(f"binned N={n}: a layout of phase 8b is not cell-aligned")
        ring = 2 * int(math.ceil(10.0 / cell)) + 1
        res[("binned", n)] = masked_fleet(
            f"binned N={n} pitch {pitch} m", (slot_cols(s), s["valid"]),
            (slot_cols(s_touch), s_touch["valid"]), c, params, ops, cap,
            min(nx * ny, 2 * ring * ring))
        if n == BINNED_FLEETS[0][0]:
            # The sorted loop's pass on the same drones: z order, 256 x 256
            # tiles, the dense grid (the list is timed at the full row).
            cols = torch.cat([kin.pos.T, kin.vel.T]).contiguous()
            touch = fleet_kin(*touching_fleet(pos), dev)
            touch = torch.cat([touch.pos.T, touch.vel.T]).contiguous()
            res[("sorted", n)] = masked_fleet(
                f"sorted z N={n} pitch {pitch} m", (_pairs.sort_by_z(cols)[0], None),
                (_pairs.sort_by_z(touch)[0], None), c, params, ops, _pairs.BLOCK,
                n // _pairs.BLOCK)

        runs = [("binned", coll, dict(init_pos=pos)) for coll in (False, True)]
        if n == BINNED_FLEETS[0][0]:
            runs += [(f"sorted {order}", coll, dict(backend="soa", sorted=True, order=order))
                     for order in ("z", "morton") for coll in (False, True)]
            runs += [("soa (z-sorted passes)", coll, dict(backend="soa")) for coll in (False, True)]
        for label, coll, kw in runs:
            times, profs = {}, {}
            resorts = "sorted" in kw or "init_pos" in kw  # the dense step never re-sorts its state
            for every in (4, 1, 10 ** 9) if resorts else (4,):
                init, step, _ = make_swarm_physics(
                    params, 1 / 240, 5, collisions=coll,
                    **(dict(resort_every=every) if resorts else {}), **kw)
                state = [step(init(kin), rpm)]  # past the re-sort of step 0

                def advance():
                    state[0] = step(state[0], rpm)

                times[every] = per_pass_ms(advance, 8, 3)
                profs[every] = profile_steps(advance, 4)
            ms, prof = times[4], profs[4]
            note = ""
            if resorts:
                # The event times are host times and spread more than the
                # re-sort costs; the card's busy time and the kernel count of
                # a step with a re-sort, less those of one without, repeat.
                each, never = profs[1], profs[10 ** 9]
                on_card = ("not measured" if each is None or never is None else
                           f"{each['kernels_per_step'] - never['kernels_per_step']:.0f} kernels and "
                           f"{each['busy_ms'] - never['busy_ms']:.4f} ms of card busy time")
                note = (f" at resort_every=4; {times[10 ** 9]:.4f} ms without a re-sort, "
                        f"{times[1]:.4f} ms re-sorting every step; the re-sort "
                        f"({'rebin' if 'init_pos' in kw else 'argsort and gather'}) costs "
                        f"{on_card} (torch.profiler, steps with less steps without)")
            print(f"[8b] {label} step N={n} pitch {pitch} m collisions={coll}: {ms:.4f} ms per "
                  f"control step ({n / (ms / 1e3):.6g} drone-steps/s){note}", flush=True)
            if prof is None:
                print("[8b]   torch.profiler saw no device kernel: not measured", flush=True)
            else:
                print(f"[8b]   under torch.profiler, per control step: card busy "
                      f"{prof['busy_ms']:.4f} ms, idle share {1 - prof['busy_ms'] / ms:.4f} "
                      f"(1 - busy / {ms:.4f} ms event time), pair kernels "
                      f"{prof['pair_ms']:.4f} ms, other kernels and memsets "
                      f"{prof['other_ms']:.4f} ms, {prof['kernels_per_step']:.0f} kernels and "
                      f"memsets in all; wall {prof['wall_ms']:.4f} ms "
                      "with the profiler's overhead", flush=True)
    # The times of the larger binned fleet; the error over all fleets.
    return {name: res[("binned", BINNED_FLEETS[-1][0])][name]
            | {"max_abs_err": max(r[name]["max_abs_err"] for r in res.values())}
            for name in MASKED}


# Phase 9: the impulse contact path (core/contact.py), float32, CF2X, 240 Hz.
IMPULSE_T = 30  # control steps of the contact checkpoints' envs at 30 Hz: 1 s
IMPULSE_ENVS = {1: 4096, 2: 2048}  # drones an env -> envs (BASELINE config 5's width)
IMPULSE_CPU_ENVS = 512  # envs are independent: the CPU runs 512 of them, evenly spread
# The general step's float32 card-vs-CPU limits (tests/test_soa.py:52-59,
# phase 4), held here over the whole second: the contact envs' actions are
# open loop (ONE_D_RPM), and the drones of an env stay 22 cm apart.
IMPULSE_LIMITS = dict(pos=1e-3, vel=2e-3, quat=1e-3)
LADDER = ((16384, "dense"), (65536, "binned"))  # scripts/impulse_ladder.py's fleet
LADDER_T = 3


def contact_env(n, dtype, device):
    """The one_d_rpm_hover_contact (n = 1) and one_d_rpm_multihover_contact
    (n = 2) envs (tests/test_checkpoints.py:286-313), every drone starting on
    the plane at the reference's spawn point (BaseAviary.py:194-197)."""
    arm = 0.0397
    init = tuple((4 * arm * i, 4 * arm * i, 0.0125) for i in range(n))
    cfg = AviaryConfig(num_drones=n, task=TASK_HOVER if n == 1 else TASK_MULTIHOVER,
                       action_type=ActionType.ONE_D_RPM, pyb_freq=240, ctrl_freq=30,
                       action_buffer_size=15, collisions=True, contact_mode="impulse",
                       dtype=dtype, initial_xyzs=init)
    p, cp = build_params(cfg, device), build_ctrl_params(cfg, device)
    step = make_batched_step(cfg, p, cp, hover_target_pos(cfg, p), reset_on_nan=False)
    return step, batch_reset(cfg, p, IMPULSE_ENVS[n], device=device)


def land_and_lift(n, E):
    """(T, E, n, 1) ONE_D_RPM actions: each env rests, lifts off (+10 % thrust)
    and lands again, at its own phase of a 0.8 s period."""
    t = np.arange(IMPULSE_T)[:, None, None, None] / 24.0
    phase = np.arange(E)[None, :, None, None] / E + np.arange(n)[None, None, :, None] * 0.25
    return np.clip(1.5 * np.sin(2 * np.pi * (t + phase)), -1.0, 1.0)


def run_contact_env(n, dtype, device, acts, sub=False):
    """IMPULSE_T control steps of the contact env; returns the kinematic
    leaves after each step (of the IMPULSE_CPU_ENVS envs that the CPU runs),
    the CUDA-event ms of each step on the card, and a closure stepping on
    from the final state. With ``sub`` only those envs run."""
    step, state = contact_env(n, dtype, device)
    every = slice(None, None, IMPULSE_ENVS[n] // IMPULSE_CPU_ENVS)
    if sub:
        state = state.map(lambda x: x[every])
        acts = acts[:, every]
    acts = torch.as_tensor(acts, dtype=getattr(torch, dtype), device=device)
    trace, events = [], []
    for a in acts:
        if state.kin.pos.is_cuda:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        state, out = step(state, a)
        if events:
            events[-1][1].record()
        trace.append({k: getattr(state.kin, k).clone() for k in IMPULSE_LIMITS})
    if events:
        torch.cuda.synchronize()
    holder = [state]

    def more():
        holder[0], _ = step(holder[0], acts[-1])

    trace = [{k: (v if sub else v[every]).double().cpu() for k, v in x.items()} for x in trace]
    return trace, [a.elapsed_time(b) for a, b in events], more


def impulse_profile(what, fn, ms, work, unit):
    """Print a cell's line: event ms a control step, then one control step
    under torch.profiler (kernels and memsets, busy ms, idle share)."""
    prof = profile_steps(fn, 1)
    if prof is None:
        fail(f"{what}: torch.profiler saw no kernel on the card")
    print(f"[9] {what}: {ms:.4f} ms a control step (CUDA events, median), "
          f"{work / (ms / 1e3):.6g} {unit}/s; one control step under torch.profiler: "
          f"{prof['kernels_per_step']:.0f} kernels and memsets, card busy {prof['busy_ms']:.4f} "
          f"ms, idle share {1.0 - prof['busy_ms'] / ms:.4f} (1 - busy / event ms), host wall "
          f"{prof['wall_ms']:.2f} ms", flush=True)


def ladder_fleet(n, device, seed=0):
    """scripts/impulse_ladder.py:38-47: 10 cm pitch (every lateral neighbor
    pair in contact), +-5 mm jitter, hovering at 1 m."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.arange(side) * 0.10, np.arange(side) * 0.10),
                 -1).reshape(-1, 2)[:n]
    pos = np.concatenate([g, np.full((n, 1), 1.0)], 1).astype(np.float32)
    pos[:, :2] += rng.uniform(-0.005, 0.005, (n, 2)).astype(np.float32)
    quat = np.tile(np.array([[0.0, 0.0, 0.0, 1.0]], np.float32), (n, 1))
    return init_kin_state(pos, quat, device=device)


def check_ladder(what, kin):
    if not all(bool(torch.isfinite(getattr(kin, k)).all()) for k in ("pos", "quat", "vel",
                                                                      "ang_v")):
        fail(f"{what}: the state is not finite")
    z = kin.pos[:, 2]
    lo, hi = float(z.min()), float(z.max())
    if not (lo > -0.1 and hi < 5.0):  # scripts/impulse_ladder.py's sanity rule
        fail(f"{what}: z in [{lo}, {hi}], outside (-0.1, 5) m")
    return lo, hi


def phase9_impulse(dev, params):
    """The impulse contact path at full width: the contact envs through
    make_batched_step on the card and on the CPU, the ladder fleet through
    step_physics with both candidate sets."""
    before = dict(pair_launches(), K1=velocity_rollout_cuda.launches)
    for n in (1, 2):
        E = IMPULSE_ENVS[n]
        acts = land_and_lift(n, E)
        what = f"({'a' if n == 1 else 'b'}) {n}-drone contact env E={E}"
        card, times, more = run_contact_env(n, "float32", dev, acts)
        cpu, _, _ = run_contact_env(n, "float32", "cpu", acts, sub=True)
        gaps = {k: max(float((a[k] - b[k]).abs().max()) for a, b in zip(card, cpu))
                for k in IMPULSE_LIMITS}
        if not all(bool(torch.isfinite(x[k]).all()) for x in card for k in x):
            fail(f"{what}: the state on the card is not finite")
        zmin = min(float(x["pos"][..., 2].min()) for x in card)
        fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})
        print(f"[9] {what}, {IMPULSE_T} control steps (1 s): card vs CPU on every "
              f"{E // IMPULSE_CPU_ENVS}th env, max over the steps {fmt(gaps)} (limits "
              f"{json.dumps(IMPULSE_LIMITS)}); lowest z "
              f"{zmin:.5f} m (the plane rows hold the drones at 0.0115)", flush=True)
        check_kin_gaps(f"{what}: the card differs from the CPU", gaps, IMPULSE_LIMITS)
        impulse_profile(what, more, statistics.median(times[1:]), E, "env-steps")
    print("[9] (a), (b): no candidate build (the exact pair rows serve N <= 16)", flush=True)

    r = float(params.collision_r)
    rpm_of = lambda n: torch.full((n, 4), float(params.hover_rpm), device=dev)
    for n, cands in LADDER:
        what = f"(c) ladder N={n} ({cands} candidates)"
        kin0, rpm = ladder_fleet(n, dev), rpm_of(n)
        period = lambda kin: step_physics(kin, rpm, rpm, params, 1 / 240, 5, Physics.PYB,
                                          collisions=True, contact_mode="impulse")[0]
        auto = period(kin0)
        torch.cuda.synchronize()
        if n <= NBR_MAX_N:
            # The dense solve against the binned one over one control period.
            dense = build_pair_candidates(kin0.pos, r)
            binned = build_pair_candidates_binned(kin0.pos, r)
            kin = kin0
            for _ in range(5):
                kin = substep_pyb(kin, rpm, rpm, params, 1 / 240, collide=True,
                                  contact_mode="impulse", pair_candidates=binned)
            same = [k for k in ("pos", "quat", "vel", "ang_v", "rpy_rates")
                    if torch.equal(getattr(kin, k), getattr(auto, k))]
            rows = [torch.where(c[1], c[0], -1) for c in (dense, binned)]
            print(f"[9] {what}: one control period with the hash grid's candidates equals "
                  f"step_physics's (dense) bit for bit in {same}; in-band rows dense "
                  f"{int(dense[1].sum())}, binned {int(binned[1].sum())}, slot for slot equal: "
                  f"{bool(torch.equal(*rows))}", flush=True)
            if len(same) != 5:
                fail(f"{what}: the binned solve differs from the dense one")
        build = build_pair_candidates if cands == "dense" else build_pair_candidates_binned
        build(kin0.pos, r)
        build_ms = statistics.median(event_ms(lambda: build(kin0.pos, r), 3))
        holder = [kin0]

        def more():
            holder[0] = period(holder[0])

        times = event_ms(more, LADDER_T)
        lo, hi = check_ladder(what, holder[0])
        print(f"[9] {what}: {1 + LADDER_T} control periods, finite, z in [{lo:.4f}, "
              f"{hi:.4f}] m; candidate build {build_ms:.4f} ms (CUDA events, median of 3)",
              flush=True)
        impulse_profile(what, more, statistics.median(times), n, "drone-steps")
        check_ladder(what, holder[0])
    after = dict(pair_launches(), K1=velocity_rollout_cuda.launches)
    rose = {k: after[k] - before[k] for k in after}
    print(f"[9] K1-K6 launches during phase 9: {rose} (the impulse path runs no kernel of "
          "its own: its rows are plain PyTorch ops)", flush=True)


# Phase 10: PPO on the card. examples/learn.py's ONE_D_RPM Hover env and
# settings; (b) holds the card to the CPU at tests/test_torch_ppo.py's limits
# (float32: a parameter moves by about lr = 3e-4 an Adam step, and 1e-5 is
# 3 % of one; the 32-step deterministic rollouts differ by float32 rounding).
PPO_ENV = dict(num_drones=1, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM, pyb_freq=240,
               ctrl_freq=30, action_buffer_size=15, episode_len_sec=8.0)
PPO_LEARN = dict(n_steps=128, log_std_anneal_to=-2.5, log_std_anneal_updates=366)
PPO_WIDE = 4096  # BASELINE config 5's width, a point of scripts/ppo_bench.py's ladder
PPO_PARAM_ATOL, PPO_METRIC_RTOL = 1e-5, 1e-4
# (e): the checkpoints, their env and the reference's threshold (learn.py:79-82,
# tests/test_checkpoints.py), over the SB3 protocol: 10 consecutive episodes
# on one env, 2,600 control steps.
CHECKPOINT_EVALS = {"one_d_rpm_hover": (TASK_HOVER, ActionType.ONE_D_RPM, 1, 474.0),
                    "pid_multihover": (TASK_MULTIHOVER, ActionType.PID, 2, 920.0)}
EVAL_STEPS = 2600


def checkpoint_eval(name):
    """``python3 chip_smoke.py --eval NAME``: a checkpoint through
    load_flax_msgpack and evaluate_policy on the card (phase 10 (e) and 10b
    (e)); prints one JSON line."""
    if name in RGB_EVALS:
        n, steps, _, _ = RGB_EVALS[name]
        cfg = AviaryConfig(**{**RGB_ENV, "num_drones": n,
                              "task": TASK_HOVER if n == 1 else TASK_MULTIHOVER})
    else:
        task, action, n, _ = CHECKPOINT_EVALS[name]
        steps = EVAL_STEPS
        cfg = AviaryConfig(num_drones=n, task=task, action_type=action, pyb_freq=240,
                           ctrl_freq=30, action_buffer_size=15, episode_len_sec=8.0)
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    net = actor_critic_from_flax(load_flax_msgpack(os.path.join(root, "checkpoints",
                                                                f"{name}.msgpack")))
    _, aux = ppo_init(cfg, PPOConfig(num_envs=1), 0)
    t0 = time.perf_counter()
    ret, episodes = evaluate_policy(cfg, aux, net, num_steps=steps, num_envs=1)
    print(json.dumps(dict(name=name, ret=ret, episodes=episodes,
                          seconds=time.perf_counter() - t0,
                          device=str(next(net.parameters()).device),
                          env_device=str(aux["params_env"].m.device),
                          k7_launches=render_views_cuda.launches)))
    return 0


def on_card(struct):
    leaves = []
    struct.map(lambda t: leaves.append(t.is_cuda) or t)
    return all(leaves)


def ppo_width(dev, what, domain_rand=None):
    """(c) / (d): one train step at E = 4096 after a warm-up one, then the
    rollout's control step alone (events and torch.profiler)."""
    cfg = AviaryConfig(**PPO_ENV)
    ppo_cfg = PPOConfig(num_envs=PPO_WIDE, **PPO_LEARN)
    runner, aux = ppo_init(cfg, ppo_cfg, 1, domain_rand=domain_rand)
    train = make_ppo_train_step(cfg, ppo_cfg, aux)
    times = []  # (rollout, update) ms of each train step, CUDA events
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        runner, rollout = train.collect(runner)
        ev[1].record()
        runner, metrics = train.update(runner, rollout)
        ev[2].record()
        ev[2].synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    if bad or not on_card(runner.env_state):
        fail(f"{what}: metrics {bad} not finite, or the env state left the card")
    step_env = make_batched_step(cfg, aux.get("train_params_env", aux["params_env"]),
                                 aux["ctrl_params"], aux["target_pos"])
    holder = [runner.env_state, runner.obs]

    def one():
        with torch.no_grad():
            holder[0], out, _ = rollout_step(runner.params, step_env, holder[0], holder[1],
                                             runner.generator, 0, (1, 1))
        holder[1] = out.obs

    step_ms = per_pass_ms(one, 16, 3)
    prof = profile_steps(one, 2)
    if prof is None:
        fail(f"{what}: torch.profiler saw no kernel on the card")
    (roll_ms, upd_ms), total = times[1], sum(times[1])
    print(f"[10] {what}: E={PPO_WIDE}, n_steps={ppo_cfg.n_steps}, "
          f"{ppo_cfg.num_minibatches} minibatches of {ppo_cfg.resolved_minibatch_size} x "
          f"{ppo_cfg.n_epochs} epochs: train step {total:.1f} ms = rollout {roll_ms:.1f} "
          f"({roll_ms / ppo_cfg.n_steps:.4f} a control step) + update {upd_ms:.1f} ms (CUDA "
          f"events; warm-up step {times[0][0]:.1f} + {times[0][1]:.1f} ms), "
          f"{PPO_WIDE * ppo_cfg.n_steps / (total / 1e3):.6g} env-steps/s; a rollout control "
          f"step alone {step_ms:.4f} ms (events, median of 3 x 16), under torch.profiler "
          f"{prof['kernels_per_step']:.0f} kernels and memsets, card busy "
          f"{prof['busy_ms']:.4f} ms, idle share {1.0 - prof['busy_ms'] / step_ms:.4f} (against "
          f"the rollout's mean control step {1.0 - prof['busy_ms'] * ppo_cfg.n_steps / roll_ms:.4f}"
          f"), host wall {prof['wall_ms']:.2f} ms; metrics "
          + json.dumps({k: float(f"{float(v):.6g}") for k, v in metrics.items()}), flush=True)
    return runner, aux, cfg, step_ms


def phase10_ppo(dev):
    """PPO through ppo_init, make_ppo_train_step, evaluate_policy on the card."""
    t_phase = time.perf_counter()
    before = dict(pair_launches(), K1=velocity_rollout_cuda.launches)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the PPO path runs in full float32")
    cfg = AviaryConfig(**PPO_ENV)

    # (a) learn.py's settings from ppo_init
    ppo_cfg = PPOConfig(num_envs=128, minibatch_size=1024, **PPO_LEARN)
    runner, aux = ppo_init(cfg, ppo_cfg, 0)
    start = [p.detach().clone() for p in runner.params.parameters()]
    train = make_ppo_train_step(cfg, ppo_cfg, aux)
    t0 = time.perf_counter()
    for _ in range(3):
        runner, metrics = train(runner)
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad:
            fail(f"(a) PPO metrics not finite: {bad}")
    secs = time.perf_counter() - t0
    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(runner.params.parameters(), start))
    where = {p.device.type for p in runner.params.parameters()} | {runner.obs.device.type}
    if runner.update_count != 3 or not moved > 0 or where != {dev.type} \
            or not on_card(runner.env_state):
        fail(f"(a) update_count {runner.update_count}, params moved {moved}, devices {where}")
    print(f"[10] (a) 3 train steps from ppo_init, E=128, n_steps=128, minibatch 1024: "
          f"{secs:.1f} s (host clock); update_count 3, params moved up to {moved:.3g}, all on "
          f"the card; last metrics "
          + json.dumps({k: float(f"{float(v):.6g}") for k, v in metrics.items()}), flush=True)

    # (b) the card against the CPU from the same converted initial params
    cfg_b = AviaryConfig(**{**PPO_ENV, "episode_len_sec": 0.5})
    ppo_b = PPOConfig(num_envs=64, n_steps=32, minibatch_size=64 * 32, n_epochs=2, det_frac=1.0)
    tree = actor_critic_to_flax(ActorCritic(27, 1, generator=torch.Generator().manual_seed(7),
                                            device="cpu"))
    runs = []  # the card's, then the CPU's
    for d in (dev, torch.device("cpu")):
        r, a = ppo_init(cfg_b, ppo_b, 0, device=d)
        r.params.load_state_dict(actor_critic_from_flax(tree, device=d).state_dict())
        r, m = make_ppo_train_step(cfg_b, ppo_b, a)(r)
        runs.append(([p.detach().cpu() for p in r.params.parameters()],
                     {k: float(v) for k, v in m.items()}))
    (pc, mc), (pp, mp) = runs
    p_gap = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    m_gap = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp}
    print(f"[10] (b) one train step, card vs CPU (E=64, n_steps=32, 0.5 s episodes, det_frac 1, "
          f"one minibatch, 2 epochs): max |param gap| {p_gap:.3g} (limit {PPO_PARAM_ATOL}), "
          f"relative metric gaps " + json.dumps({k: float(f"{v:.3g}") for k, v in m_gap.items()})
          + f" (limit {PPO_METRIC_RTOL}, approx_kl 1e-6 absolute); episodes done "
          f"{mc['episodes_done']:.0f}", flush=True)
    if not p_gap <= PPO_PARAM_ATOL:
        fail(f"(b) params after the update differ card vs CPU by {p_gap}")
    if not mp["episodes_done"] > 0 or mc["episodes_done"] != mp["episodes_done"]:
        fail("(b) the episodes done differ, or no episode ended")
    for k in mp:
        if not abs(mc[k] - mp[k]) <= PPO_METRIC_RTOL * abs(mp[k]) + 1e-6:
            fail(f"(b) metric {k} differs card vs CPU: {mc[k]} vs {mp[k]}")

    # (c), (d) BASELINE config 5's width, nominal and per-env plants
    _, _, _, nominal_ms = ppo_width(dev, "(c) nominal")
    _, aux_d, cfg_d, dr_ms = ppo_width(dev, "(d) domain_rand m 0.1, kf 0.05",
                                       {"m": 0.1, "kf": 0.05})
    spread = {}
    for key, params_env in (("per-env", aux_d["train_params_env"]),
                            ("nominal", aux_d["params_env"])):
        step = make_batched_step(cfg_d, params_env, aux_d["ctrl_params"], aux_d["target_pos"])
        state = batch_reset(cfg_d, params_env, PPO_WIDE)
        act = torch.full((PPO_WIDE, 1, 1), 0.3, device=dev)
        for _ in range(30):
            state, _ = step(state, act)
        z = state.kin.pos[:, 0, 2]
        spread[key] = float(z.max() - z.min())
    print(f"[10] (d) rollout control step {dr_ms:.4f} ms per-env against {nominal_ms:.4f} ms "
          f"nominal ({dr_ms / nominal_ms:.3f}x); z spread over the envs after 30 control steps "
          f"of action 0.3 from reset: per-env {spread['per-env']:.4g} m, nominal "
          f"{spread['nominal']:.4g} m", flush=True)
    if not spread["per-env"] > 1e-3 or spread["nominal"] != 0.0:
        fail(f"(d) the per-env plants did not spread z: {spread}")

    # (e) the checkpoints over the protocol, two processes at once
    procs = {name: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--eval", name],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in CHECKPOINT_EVALS}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                fail(f"(e) {name}: the eval exited {proc.returncode}: {err[-2000:]}")
            res = json.loads(out.strip().splitlines()[-1])
            threshold = CHECKPOINT_EVALS[name][3]
            print(f"[10] (e) {name}: mean return {res['ret']:.5f} over {res['episodes']} "
                  f"episodes ({EVAL_STEPS} control steps, one env, policy on "
                  f"{res['device']}, env on {res['env_device']}), threshold {threshold}, "
                  f"{res['seconds']:.1f} s", flush=True)
            if res["device"] != "cuda:0" or res["env_device"] != "cuda:0":
                fail(f"(e) {name} did not run on the card")
            if not (res["episodes"] >= 10 and res["ret"] >= threshold):
                fail(f"(e) {name}: {res['ret']} over {res['episodes']} episodes, under "
                     f"{threshold}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    after = dict(pair_launches(), K1=velocity_rollout_cuda.launches)
    print(f"[10] phase 10: {time.perf_counter() - t_phase:.1f} s; K1-K6 launches during it: "
          f"{ {k: after[k] - before[k] for k in after} } (the PPO path is plain PyTorch ops "
          "and torch.nn; the evals' processes load no kernel)", flush=True)


# Phase 10b: the pixel path. K7 (csrc/render_views.cu) against its plain
# version (render/camera.render_drone_views_plain) at the limits the CPU
# tests hold the port to against JAX: seg equal on at least 99.9 % of the
# pixels; where seg agrees, rgba within 1 and depth within 1e-6. Frames of
# the env on the card against the CPU: at most 0.1 % of the pixels past 1 in
# a channel; kinematics at tests/test_soa.py:52-59's limits.
RENDER_SEG_SHARE, RENDER_RGBA_ATOL, RENDER_DEP_ATOL, FRAME_SHARE = 0.999, 1, 1e-6, 0.001
RGB_KIN_LIMITS = dict(pos=1e-3, vel=2e-3, quat=1e-3, last_rpm=20.0)
# scripts/rgb_scratch.py:60-88: the from-scratch pixel PPO's env and settings
# (its anchor starts only once a probe evaluation clears 250, so a first
# train step has none).
RGB_ENV = dict(num_drones=1, task=TASK_HOVER, action_type=ActionType.ONE_D_RPM,
               obs_type=ObservationType.RGB, pyb_freq=240, ctrl_freq=30,
               action_buffer_size=15, episode_len_sec=8.0, frame_stack=4)
RGB_E = 64
RGB_PPO = dict(num_envs=RGB_E, n_steps=128, minibatch_size=1024, target_kl=0.01,
               det_frac=0.25)
RGB_CPU_ENVS = 8  # phase 10b (b): the CPU replays this many of the card's envs
# (e): the RGB checkpoints, tests/test_checkpoints.py's gates and lengths:
# name -> (drones, control steps, least return, least episodes)
RGB_EVALS = {"rgb_hover_fs4": (1, 260, 472.0, 1), "rgb_multihover_fs4": (2, 260, 945.0, 1),
             "rgb_hover_distilled": (1, 2600, 474.0, 10),
             "rgb_multihover_distilled": (2, 2600, 949.5, 10),
             "rgb_hover_scratch_ppo436": (1, 2600, 430.0, 10)}
RENDER_KERNEL_NAME = "render_kernel"
# Elementwise operations counted per element for K7's bound (the ray tests'
# operations on the plain version's pieces).
_RENDER_OPS = _OPS | {"reciprocal", "floor", "remainder", "eq", "ne", "bitwise_or",
                      "bitwise_not", "logical_not", "isfinite"}


class _ElementOps(TorchDispatchMode):
    """Counts elementwise operations times the elements each makes."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _RENDER_OPS or name == "clamp":
            self.add(out.numel() if isinstance(out, torch.Tensor) else 1)
        return out

    def add(self, n):
        self.ops += n


class _SectionOps(_ElementOps):
    """Counts as ``_ElementOps`` does, by the part of
    ``render_drone_views_plain`` that makes each operation: "drones" (the
    other drones' block), a landmark's index in the scene, or "rest" (the
    camera, the rays, the plane, the sky and the depth). The parts are the
    function's own section comments."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()
        lines, start = inspect.getsourcelines(camera.render_drone_views_plain)
        at = lambda mark: start + next(i for i, ln in enumerate(lines) if mark in ln)
        self.marks = (at("# --- the other drones"), at("# --- landmarks"), at("# --- sky"))

    def add(self, n):
        f = sys._getframe(2)
        while f is not None and f.f_code is not camera.render_drone_views_plain.__code__:
            f = f.f_back
        line = -1 if f is None else f.f_lineno
        key = ("drones" if self.marks[0] <= line < self.marks[1] else
               f.f_locals["k"] if self.marks[1] <= line < self.marks[2] else "rest")
        self.ops[key] += n


def render_ops_per_pixel(pos, quat, arm, cfg):
    """(operations a pixel, the tests a pixel makes and their operations) of
    K7 on the first world of ``pos`` / ``quat`` / ``arm`` (the card's
    tensors): the plain version's elementwise operations on one pixel of
    camera 0, counted element by element, less the camera drone's own tests,
    which the plain version computes and masks and K7 skips."""
    pos1, quat1, arm1 = pos[:1].cpu(), quat[:1].cpu(), arm[:1].cpu()
    one, ray, two = torch.zeros((1, 3)), torch.tensor([[0.3, 0.5, 0.8]]), torch.ones((1, 3))

    def count(fn):
        with _ElementOps() as c:
            fn()
        return c.ops

    n, eye = pos.shape[1], torch.eye(3)[None]
    cone = (torch.zeros(3), torch.eye(3)[[0, 1, 2, 0]], torch.tensor(False))
    tests = dict(ops_triangle=count(lambda: ray_tris(one, ray, one, ray, two)),
                 ops_slab=count(lambda: camera._ray_aabb(one, ray, ray)),
                 ops_sphere=count(lambda: camera._ray_sphere(one, ray, one, 0.25)),
                 ops_frame=2 * count(lambda: camera._rt_apply(eye, one)),
                 ops_gate=count(lambda: render_ops._gate(cone, ray[0], torch.tensor(0.1))))
    mesh = camera.use_mesh_proxy(cfg, n)
    own = tests["ops_frame"] + (68 * tests["ops_triangle"] if mesh
                                else 2 * tests["ops_slab"] + tests["ops_sphere"])
    pixel = dataclasses.replace(cfg, width=1, height=1)
    total = count(lambda: camera.render_drone_views_plain(pos1, quat1, arm1, [0], pixel))
    tests.update(other_drones=n - 1, proxy="mesh" if mesh else "xframe",
                 landmark_triangles=sum(len(o["mesh"][0]) for o in camera._scene_objects(
                     cfg.scene) if o["kind"] == "mesh") if cfg.with_landmarks else 0)
    return total - own, tests


def _unpadded(rows):
    """(T, 4) float64 spheres of (T, 12) triangle rows: centroid, distance to
    the farthest vertex (K7's spheres before their padding)."""
    verts = render_ops._row_vertices(rows)
    centre = verts.mean(1)
    reach = np.linalg.norm(verts - centre[:, None], axis=-1).max(1)
    return np.concatenate([centre, reach[:, None]], 1)


def _entered(o, d, c, r):
    """Whether the rays (o, d unit) enter the spheres (c, r) ahead of o."""
    oc = c - o
    b = (d * oc).sum(-1)
    dist2 = (oc * oc).sum(-1) - b * b
    return (dist2 <= r * r) & (b + torch.sqrt(torch.clamp(r * r - dist2, min=0.0)) > 0)


def _pixel_rays(pos, quat, arm, cam, cfg):
    """Each pixel's eye and unit ray (B, C, H, W, 3), float64, on ``pos``'s device."""
    pos, quat, arm = pos.double(), quat.double(), arm.double()
    sel = torch.as_tensor(cam, device=pos.device)
    R = quat_to_matrix(quat)[:, sel]
    eye = pos[:, sel].clone()
    eye[..., 2] += arm[:, None]
    fwd = R[..., :, 0] / R[..., :, 0].norm(dim=-1, keepdim=True)
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0], dtype=pos.dtype,
                                                 device=pos.device).expand(fwd.shape))
    right = right / right.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    up = torch.linalg.cross(right, fwd)
    th = camera.tan_half_fov(cfg)
    xs = ((torch.arange(cfg.width, device=pos.device) + 0.5) / cfg.width * 2 - 1) * th * cfg.aspect
    ys = (1 - (torch.arange(cfg.height, device=pos.device) + 0.5) / cfg.height * 2) * th
    bc = (slice(None), slice(None), None, None, slice(None))
    d = fwd[bc] + xs[None, :, None] * right[bc] + ys[:, None, None] * up[bc]
    return eye[bc].expand(d.shape), d / d.norm(dim=-1, keepdim=True)


def render_plain_parts(pos, quat, arm, cfg):
    """(operations a camera, operations a pixel by part) of the plain version
    on camera 0 of the first world at the case's size: each part
    (``_SectionOps``) is counted at 1 x 1, 2 x 1, 1 x 2 and 2 x 2 pixels and
    read as a + b W + c H + p W H; p is its work a pixel, the rest its work a
    camera (the world's rotations included)."""
    pos1, quat1, arm1 = pos[:1].cpu(), quat[:1].cpu(), arm[:1].cpu()
    T = {}
    for w, h in ((1, 1), (2, 1), (1, 2), (2, 2)):
        with _SectionOps() as c:
            camera.render_drone_views_plain(pos1, quat1, arm1, [0],
                                            dataclasses.replace(cfg, width=w, height=h))
        T[w, h] = c.ops
    per_camera, per_pixel = 0, {}
    for k in set().union(*T.values()):
        p = T[2, 2][k] - T[2, 1][k] - T[1, 2][k] + T[1, 1][k]
        b, c = T[2, 1][k] - T[1, 1][k] - p, T[1, 2][k] - T[1, 1][k] - p
        per_camera += T[1, 1][k] - b - c - p + b * cfg.width + c * cfg.height
        per_pixel[k] = p
    return per_camera, per_pixel


def render_needed_ops(pos, quat, arm, cfg, tests, chunk=64):
    """(the operations K7's work needs on this case, their pieces). Once a
    camera: the plain version's camera work (``render_plain_parts``). Once a
    K7 tile (``TILE_W`` x ``TILE_H`` pixels): a gate (``ops_gate``) for every
    landmark object and other drone. Every pixel: the rays, the plane, the
    sky and the depth. Only where the pixel's own ray enters an unpadded
    bounding sphere: a landmark's selection and shading and its exact test
    (a mesh's triangles each by its own sphere); a drone's frame and its cf2
    triangles (mesh proxy) or its bars and body (X-frame); and, on a pixel
    that enters any other drone, the drone block's selection and shading.
    Counted over every pixel, ``chunk`` worlds at a time, in float64 on the
    card."""
    B, N = pos.shape[:2]
    cam = list(range(N))
    cf2, objs, tris = render_ops.scene_tables(cfg.scene, cfg.with_landmarks, cfg.frame_angle_deg)
    dev = pos.device
    t_sph = torch.as_tensor(_unpadded(tris), device=dev)
    c_sph = torch.as_tensor(_unpadded(cf2), device=dev)
    r_mesh = float(np.linalg.norm(render_ops._row_vertices(cf2), axis=-1).max())
    kinds = [int(k) for k in objs[:, 0]]
    per_camera, per_pixel = render_plain_parts(pos, quat, arm, cfg)
    mesh = camera.use_mesh_proxy(cfg, N)
    drone_full = tests["ops_frame"] + (68 * tests["ops_triangle"] if mesh
                                       else 2 * tests["ops_slab"] + tests["ops_sphere"])
    reach, test, select = [], [], []
    for m, kind in enumerate(kinds):
        if kind == 2:
            rows = tris[int(objs[m, 12]):int(objs[m, 12] + objs[m, 13])]
            verts = render_ops._row_vertices(rows) - objs[m, 1:4]
            reach.append(float(np.linalg.norm(verts, axis=-1).max()))
            test.append(len(rows) * tests["ops_triangle"])
        else:
            reach.append(float(np.linalg.norm(objs[m, 4:7])) if kind == 0 else float(objs[m, 7]))
            test.append(tests["ops_slab"] if kind == 0 else tests["ops_sphere"])
        select.append(per_pixel[m] - test[m])
    drone_select = per_pixel["drones"] - N * drone_full
    entered = Counter()
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        o, d = _pixel_rays(pos[sl], quat[sl], arm[sl], cam, cfg)
        for m, kind in enumerate(kinds):
            c = torch.as_tensor(objs[m, 1:4], dtype=torch.float64, device=dev)
            r = torch.tensor(reach[m], dtype=torch.float64, device=dev)
            hits = int(_entered(o, d, c, r).sum())
            entered["landmark_selections"] += hits * select[m]
            if kind == 2:
                rows = slice(int(objs[m, 12]), int(objs[m, 12] + objs[m, 13]))
                entered["landmark_triangles"] += int(_entered(
                    o[..., None, :], d[..., None, :], t_sph[rows, :3], t_sph[rows, 3]).sum())
            else:
                entered["boxes" if kind == 0 else "spheres"] += hits
        if N > 1:
            R = quat_to_matrix(quat[sl].double())
            if not mesh:
                ca, sa = camera.frame_rotation(cfg)
                R = R @ torch.tensor([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]],
                                     dtype=torch.float64, device=dev)
            L = arm[sl].double()[:, None, None, None, None]
            P = pos[sl].double()[:, None, None, None]  # (b, 1, 1, 1, N, 3)
            ocb = torch.einsum("bnki,bchwnk->bchwni", R, o[..., None, :] - P)
            ddb = torch.einsum("bnki,bchwk->bchwni", R, d)
            own = (torch.arange(N, device=dev)[None, :] == torch.arange(N, device=dev)[:, None])
            other = ~own[None, :, None, None, :]  # the camera drone c is drone c
            zero = torch.zeros(3, dtype=torch.float64, device=dev)
            r_body = r_mesh if mesh else float(np.linalg.norm(render_ops._BARS_HALF))
            hit = _entered(ocb, ddb, zero, r_body * L) & other
            if not mesh:
                hit |= _entered(o[..., None, :], d[..., None, :], P, 0.75 * L) & other
                entered["xframe_drones"] += int(hit.sum())
            else:
                entered["mesh_drones"] += int(hit.sum())
                tri_hit = _entered(ocb[..., None, :], ddb[..., None, :],
                                   c_sph[:, :3] * L[..., None, None], c_sph[:, 3] * L[..., None]
                                   ) & hit[..., None]
                entered["drone_triangles"] += int(tri_hit.sum())
            entered["drone_pixels"] += int(hit.any(-1).sum())
    cameras = B * N
    pixels = cameras * cfg.height * cfg.width
    tiles = cameras * -(-cfg.height // render_ops.TILE_H) * -(-cfg.width // render_ops.TILE_W)
    ops = (cameras * per_camera + tiles * tests["ops_gate"] * (len(objs) + N - 1)
           + pixels * per_pixel["rest"] + entered["landmark_selections"]
           + entered["landmark_triangles"] * tests["ops_triangle"]
           + entered["boxes"] * tests["ops_slab"] + entered["spheres"] * tests["ops_sphere"]
           + entered["xframe_drones"] * drone_full + entered["mesh_drones"] * tests["ops_frame"]
           + entered["drone_triangles"] * tests["ops_triangle"]
           + entered["drone_pixels"] * drone_select)
    return ops, dict(camera_ops_a_camera=per_camera, rest_ops_a_pixel=per_pixel["rest"],
                     tiles=tiles, **entered)


def render_case(dev, B, N, seed, spread):
    """Seeded worlds: (pos (B, N, 3), quat (B, N, 4), arm (B,)) on the card.
    ``spread`` places the drones: "landmarks" faces each world's first drone
    toward one of the RL landmarks from 0.4-1.2 m and puts its other drones
    0.2-0.8 m ahead of it; "line" puts 12 drones on the x axis (the JAX
    tests' xframe world); "base" faces BaseAviary's obstacles."""
    rng = np.random.default_rng(seed)
    arm = np.full(B, 0.0397)
    if spread == "line":
        pos = np.stack([np.linspace(0, 3, N), rng.uniform(-0.05, 0.05, N),
                        rng.uniform(0.25, 0.35, N)], -1)[None].repeat(B, 0)
        yaw = rng.uniform(-0.3, 0.3, (B, N))
    else:
        targets = (np.array([[1.0, 0, 0.1], [0, 1, 0.1], [-1, 0, 0.1], [0, -1, 0.1]])
                   if spread == "landmarks" else
                   np.array([[-0.5, -2.5, 0.5], [0.0, 2.0, 0.5], [0.0, -4.0, 1.0],
                             [-0.5, -0.5, 0.08]]))
        tgt = targets[np.arange(B) % 4]
        ang = rng.uniform(-np.pi, np.pi, B)
        dist = rng.uniform(0.4, 1.2, B)
        first = tgt + np.stack([dist * np.cos(ang), dist * np.sin(ang),
                                rng.uniform(0.0, 0.4, B)], -1)
        heading = ang + np.pi + rng.uniform(-0.3, 0.3, B)
        pos = np.zeros((B, N, 3))
        pos[:, 0] = first
        yaw = np.repeat(heading[:, None], N, 1) + rng.uniform(-0.5, 0.5, (B, N))
        for j in range(1, N):
            ahead = rng.uniform(0.2, 0.8, B)
            pos[:, j] = first + np.stack([ahead * np.cos(heading), ahead * np.sin(heading),
                                          rng.uniform(-0.15, 0.15, B)], -1)
    tilt = rng.uniform(-0.15, 0.15, (B, N, 2))
    quat = np.asarray(euler_xyz_to_quat(torch.as_tensor(
        np.concatenate([tilt, yaw[..., None]], -1))))
    return [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (pos, quat, arm)]


def render_gaps(got, plain, B, chunk=64):
    """(seg-differing pixels, rgba max gap and pixels past 1, depth max gap
    and pixels past 1e-6, all where seg agrees, pixels) of K7's outputs
    ``got`` against ``plain(world slice)``, ``chunk`` worlds at a time."""
    g = dict(seg_differs=0, rgba_max=0, rgba_past=0, dep_max=0.0, dep_past=0, pixels=0)
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        want = plain(sl)
        same = got[2][sl] == want[2]
        rgba = (got[0][sl].int() - want[0].int()).abs().amax(-1)[same]
        dep = (got[1][sl] - want[1]).abs()[same]
        g["seg_differs"] += int((~same).sum())
        g["rgba_max"] = max(g["rgba_max"], int(rgba.max()))
        g["rgba_past"] += int((rgba > RENDER_RGBA_ATOL).sum())
        g["dep_max"] = max(g["dep_max"], float(dep.max()))
        g["dep_past"] += int((dep > RENDER_DEP_ATOL).sum())
        g["pixels"] += same.numel()
    return g


def peak_mib(fn):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def phase10b_render(dev):
    """(a): K7 against its plain version on the card, bit for bit, timed,
    with two bounds: the work K7 needs (``render_needed_ops``) and the plain
    version's whole work; returns K7's record at the PPO shape (E = 64
    one-drone envs, "rl"), its largest errors and every case's numbers.
    (a5) is the KIN PPO width: the plain version's intermediates for 4096
    cameras do not fit on the card, so it runs 64 worlds at a time."""
    cases = [("(a1) E=64 x 1 drone, rl", 64, 1, 1, {}, "landmarks"),
             ("(a2) E=32 x 2 drones, mesh proxy", 32, 2, 2, {}, "landmarks"),
             ("(a3) one 12-drone world, xframe", 1, 12, 3, {}, "line"),
             ("(a4) E=16 x 1 drone, base scene", 16, 1, 4, dict(scene="base"), "base"),
             ("(a5) E=4096 x 1 drone, rl", 4096, 1, 5, {}, "landmarks")]
    record, worst, summary = None, dict(seg_share=1.0, rgba_max=0, dep_max=0.0), {}
    for name, B, N, seed, extra, spread in cases:
        cfg = camera.CameraConfig(**extra)
        pos, quat, arm = render_case(dev, B, N, seed, spread)
        cam = list(range(N))
        kernel = lambda: render_views_cuda(pos, quat, arm, cam, cfg)
        chunk = lambda sl: camera.render_drone_views_plain(pos[sl], quat[sl], arm[sl], cam, cfg)
        plain = lambda: [chunk(slice(b0, b0 + 64)) for b0 in range(0, B, 64)]
        got = kernel()
        torch.cuda.synchronize()
        gaps = render_gaps(got, chunk, B)
        share = 1.0 - gaps["seg_differs"] / gaps["pixels"]
        bit_equal = gaps["seg_differs"] == 0 and gaps["rgba_max"] == 0 and gaps["dep_max"] == 0.0
        ids = sorted(int(i) for i in torch.unique(got[2]))
        k_ms = per_pass_ms(kernel, 20, 5)
        k_dev = device_ms(kernel, 10)
        p_ms = per_pass_ms(plain, 1, 3)
        p_launches = len(traced_kernels(plain, 1)[0])
        k_mem, p_mem = peak_mib(kernel), peak_mib(lambda: chunk(slice(0, 64)))
        per_pixel, tests = render_ops_per_pixel(pos, quat, arm, cfg)
        needed, parts = render_needed_ops(pos, quat, arm, cfg, tests)
        pixels = gaps["pixels"]
        nbytes = 12 * pixels + (7 * N + 1) * 4 * B
        bounds = {}
        for key, flops in (("needed", needed), ("plain work", per_pixel * pixels)):
            by_ops = flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES_PER_S
            bounds[key] = (max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3,
                           "operations" if by_ops else "bytes", flops)
        bound, bound_by, _ = bounds["needed"]
        print(f"[10b] {name}: {B * N} cameras, {pixels} pixels, ids {ids}; K7 vs plain: seg "
              f"differs on {gaps['seg_differs']} pixels (share equal {share:.6f}, limit "
              f"{RENDER_SEG_SHARE}); where seg agrees rgba max gap {gaps['rgba_max']} "
              f"({gaps['rgba_past']} pixels past {RENDER_RGBA_ATOL}), depth max gap "
              f"{gaps['dep_max']:.3g} ({gaps['dep_past']} past {RENDER_DEP_ATOL}); bit-equal "
              f"{bit_equal}; K7 {k_ms:.5f} ms (events, median of 5 x 20), device "
              f"{'not measured' if k_dev is None else f'{k_dev:.5f} ms'}; plain {p_ms:.3f} ms "
              f"(events, 3 runs, {-(-B // 64)} calls of 64 worlds at most), {p_launches} kernels "
              f"and memsets; peak memory K7 {k_mem:.2f} MiB, plain (64 worlds) {p_mem:.1f} MiB; "
              f"{nbytes} bytes; tests a pixel {json.dumps(tests)}", flush=True)
        for key, (b_ms, by, flops) in bounds.items():
            print(f"[10b] {name}: bound of the {key} {b_ms:.6f} ms by {by} ({flops:.4g} "
                  f"operations{'; ' + json.dumps(parts) if key == 'needed' else ''}); K7 events / "
                  f"bound {k_ms / b_ms:.2f}, device / bound "
                  f"{'not measured' if k_dev is None else f'{k_dev / b_ms:.2f}'}", flush=True)
        if share < RENDER_SEG_SHARE or gaps["rgba_max"] > RENDER_RGBA_ATOL \
                or gaps["dep_max"] > RENDER_DEP_ATOL:
            fail(f"K7 disagrees with its plain version on {name}: {gaps}")
        if not bit_equal:
            fail(f"K7 is not bit-equal to its plain version on {name}: {gaps}")
        if len(ids) < 3:
            fail(f"{name}: the views show too little of the scene ({ids})")
        worst = dict(seg_share=min(worst["seg_share"], share),
                     rgba_max=max(worst["rgba_max"], gaps["rgba_max"]),
                     dep_max=max(worst["dep_max"], gaps["dep_max"]))
        summary[name[:4]] = dict(ms=k_ms, device_ms=k_dev, bound_ms=bound,
                                 plain_work_bound_ms=bounds["plain work"][0], bit_equal=bit_equal)
        if record is None:
            record = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, plain_launches=p_launches,
                          bound_ms=bound, bound_by=bound_by,
                          plain_work_bound_ms=bounds["plain work"][0], peak_mib=k_mem,
                          plain_peak_mib=p_mem)
    return record, worst, summary


def frames_past(a, b):
    """Frame pixels past 1 in a channel, and pixels."""
    gap = (a.int() - b.int()).abs().amax(-1)
    return int((gap > 1).sum()), gap.numel()


def phase10b_env(dev):
    """(b): the RGB Hover env through make_batched_step, E = 64, 30 control
    steps, the card against the CPU on the first RGB_CPU_ENVS envs."""
    cfg = AviaryConfig(**RGB_ENV)
    acts = torch.as_tensor(np.random.default_rng(5).uniform(-0.6, 0.8, (30, RGB_E, 1, 1)),
                           dtype=torch.float32)
    runs = {}
    for key, d, E in (("cuda", dev, RGB_E), ("cpu", torch.device("cpu"), RGB_CPU_ENVS)):
        params = build_params(cfg, d)
        step = make_batched_step(cfg, params, build_ctrl_params(cfg, d),
                                 hover_target_pos(cfg, params))
        state = batch_reset(cfg, params, E, device=d)
        trace, t0 = [], time.perf_counter()
        for a in acts:
            state, out = step(state, a[:E].to(d))
            trace.append(dict(frames=out.obs[:RGB_CPU_ENVS].cpu(), reward=out.reward.cpu(),
                              **{k: getattr(state.kin, k)[:RGB_CPU_ENVS].cpu()
                                 for k in ("pos", "vel", "quat")},
                              last_rpm=state.last_rpm[:RGB_CPU_ENVS].cpu()))
        if d.type == "cuda":
            torch.cuda.synchronize()
        runs[key] = (trace, time.perf_counter() - t0)
    worst, past, pixels = {k: 0.0 for k in RGB_KIN_LIMITS}, 0, 0
    for t, (c, p) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        for k in RGB_KIN_LIMITS:
            worst[k] = max(worst[k], float((c[k] - p[k]).abs().max()))
        n_past, n = frames_past(c["frames"], p["frames"])
        past, pixels = past + n_past, pixels + n
        if n_past > FRAME_SHARE * n:
            fail(f"(b) frames on the card differ from the CPU at step {t + 1}: {n_past} of {n}")
    rewards = torch.stack([c["reward"] for c in runs["cuda"][0]])
    print(f"[10b] (b) RGB Hover env (rgb_scratch.py: ONE_D_RPM, 240/30 Hz, buffer 15, "
          f"frame_stack 4) through make_batched_step, E={RGB_E}, 30 control steps: card "
          f"{runs['cuda'][1]:.2f} s, CPU ({RGB_CPU_ENVS} envs) {runs['cpu'][1]:.2f} s; card vs "
          f"CPU max gaps " + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
          + f" (limits {json.dumps(RGB_KIN_LIMITS)}); frame pixels past 1: {past} of "
          f"{pixels}; rewards finite {bool(torch.isfinite(rewards).all())}", flush=True)
    for k, v in worst.items():
        if not v <= RGB_KIN_LIMITS[k]:
            fail(f"(b) the RGB env on the card differs from the CPU in {k}: {v}")


def rgb_ppo_step(what, domain_rand=None):
    """(c) / (d): one RGB train step after a warm-up one; K7's launches over
    the measured step (counts set to 0 just before it)."""
    cfg = AviaryConfig(**RGB_ENV)
    ppo_cfg = PPOConfig(**RGB_PPO)
    runner, aux = ppo_init(cfg, ppo_cfg, 2, domain_rand=domain_rand)
    train = make_ppo_train_step(cfg, ppo_cfg, aux)
    times = []
    for i in range(2):
        if i == 1:
            render_views_cuda.launches = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        runner, rollout = train.collect(runner)
        ev[1].record()
        runner, metrics = train.update(runner, rollout)
        ev[2].record()
        ev[2].synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    launches = render_views_cuda.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    if bad or not on_card(runner.env_state) or runner.obs.dtype != torch.uint8:
        fail(f"{what}: metrics {bad} not finite, or the env state or obs left the card or uint8")
    if launches != ppo_cfg.n_steps:
        fail(f"{what}: K7 launched {launches} times in a train step of {ppo_cfg.n_steps} "
             "control steps")
    step_env = make_batched_step(cfg, aux.get("train_params_env", aux["params_env"]),
                                 aux["ctrl_params"], aux["target_pos"])
    holder = [runner.env_state, runner.obs]

    def one():
        with torch.no_grad():
            holder[0], out, _ = rollout_step(runner.params, step_env, holder[0], holder[1],
                                             runner.generator, 0, (1, 1))
        holder[1] = out.obs

    step_ms = per_pass_ms(one, 8, 3)
    kernels, wall = traced_kernels(one, 2)
    if not kernels:
        fail(f"{what}: torch.profiler saw no kernel on the card")
    busy, end = 0.0, -math.inf
    for e in kernels:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy_ms = busy / 1e3 / 2
    k7_ms = sum(e["dur"] for e in kernels if RENDER_KERNEL_NAME in e["name"]) / 1e3 / 2
    (roll, upd), total = times[1], sum(times[1])
    print(f"[10b] {what}: E={RGB_E}, n_steps={ppo_cfg.n_steps}, {ppo_cfg.num_minibatches} "
          f"minibatches of {ppo_cfg.resolved_minibatch_size} x {ppo_cfg.n_epochs} epochs, TF32 "
          f"off: train step {total:.1f} ms = rollout {roll:.1f} ({roll / ppo_cfg.n_steps:.3f} a "
          f"control step) + update {upd:.1f} ms (CUDA events; warm-up {times[0][0]:.1f} + "
          f"{times[0][1]:.1f}), {RGB_E * ppo_cfg.n_steps / (total / 1e3):.6g} env-steps/s; K7 "
          f"launches in the step {launches}; peak memory over the step {peak:.1f} MiB; a "
          f"rollout control step alone {step_ms:.3f} ms (events, median of 3 x 8), under "
          f"torch.profiler {len(kernels) / 2:.0f} kernels and memsets, card busy {busy_ms:.4f} "
          f"ms (K7 {k7_ms:.4f}), idle share {1.0 - busy_ms / step_ms:.4f}, host wall "
          f"{wall * 1e3 / 2:.2f} ms; metrics "
          + json.dumps({k: float(f"{float(v):.6g}") for k, v in metrics.items()}), flush=True)
    return launches


def phase10b_pixels(dev):
    """The pixel path: K7, the RGB env, RGB PPO, the five RGB checkpoints."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the pixel path runs in full float32")
    record, worst, cases = phase10b_render(dev)
    phase10b_env(dev)
    launches = rgb_ppo_step("(c) nominal")
    rgb_ppo_step("(d) domain_rand m 0.1, kf 0.05", {"m": 0.1, "kf": 0.05})
    procs = {name: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--eval", name],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in RGB_EVALS}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                fail(f"(e) {name}: the eval exited {proc.returncode}: {err[-2000:]}")
            res = json.loads(out.strip().splitlines()[-1])
            _, steps, gate, episodes = RGB_EVALS[name]
            print(f"[10b] (e) {name}: mean return {res['ret']:.5f} over {res['episodes']} "
                  f"episodes ({steps} control steps, one env, policy on {res['device']}, env on "
                  f"{res['env_device']}, K7 launches {res['k7_launches']}), gate {gate}, "
                  f"{res['seconds']:.1f} s", flush=True)
            if res["device"] != "cuda:0" or res["env_device"] != "cuda:0" \
                    or res["k7_launches"] < steps:
                fail(f"(e) {name} did not run on the card through K7")
            if not (res["episodes"] >= episodes and res["ret"] >= gate):
                fail(f"(e) {name}: {res['ret']} over {res['episodes']} episodes, under {gate}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[10b] phase 10b: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(record, launches=launches, max_abs_err=worst["dep_max"],
                rgba_max_gap=worst["rgba_max"], seg_equal_share=worst["seg_share"], cases=cases)


# Phase 11: the controllers (control/). Card against CPU at
# tests/test_soa.py:52-59's float32 limits over 1 s (the parity rule).
CTRL_LIMITS = dict(pos=1e-3, vel=2e-3, quat=1e-3)
# (a) tests/test_commander_jax.py:102-175's mission for a 64 x 64 grid of drones
# at 1.5 m pitch in one world (PYB, 500/500 Hz, float32, no collisions): its
# legs, its 4,100 ticks, its gates at 4.5 s and at the end.
MISSION_SIDE, MISSION_PITCH, MISSION_TICKS, MISSION_MID = 64, 1.5, 4100, int(4.5 * 500) - 1
CORNER_OFFSETS = np.array([[0.4, 0.4, 0.44], [-0.4, 0.4, 0.44], [0.4, -0.4, 0.44],
                           [-0.4, -0.4, 0.44]], np.float32)
# (b) closed loops of E one-drone CtrlAviary envs over 2 s, each env its own
# target: MRAC at examples/mrac.py's 240/120 Hz from (0, 0, 0.1) to (0, 0, 1)
# plus up to 0.2 m vertically (its lateral loop settles in more than 2 s); CTBR at 240/240 Hz to up to 0.3 m off
# laterally and 0.2 m vertically, through a rate-mode flight stack (a body-rate
# P loop, RATE_GAIN, and the X mixer's inverse, as Betaflight closes CTBR).
LOOP_E, LOOP_SEC, PARITY_E, RATE_GAIN = 4096, 2.0, 64, 30.0
LOOP_GATES = {"MRAC": 0.1, "CTBR": 0.05}  # m, |position error| at 2 s, every env
RAD2DEG = 57.29577951308232


def mission_world(dev, side):
    """(a)'s world: a side x side grid, each drone's legs from its own start."""
    n = side * side
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1).reshape(-1, 2)
    starts = np.concatenate([ij * MISSION_PITCH, np.full((n, 1), 0.06)], 1).astype(np.float32)
    corners = starts + CORNER_OFFSETS[np.arange(n) % 4]
    lands = corners * np.array([1.0, 1.0, 0.0], np.float32) + np.array([0, 0, 0.08], np.float32)
    legs = plan_mission(starts, np.zeros(n, np.float32), [
        {"pos": starts + np.array([0, 0, 0.44], np.float32), "duration": 2.0, "hold": 0.5},
        {"pos": corners, "duration": 2.0, "hold": 0.5},
        {"pos": lands, "duration": 2.0, "hold": 1.0}], device=dev)
    cfg = AviaryConfig(num_drones=n, task=TASK_CTRL, pyb_freq=500, ctrl_freq=500,
                       action_buffer_size=0)
    params = build_params(cfg, dev)
    state = env_reset(cfg, params)
    state = state.replace(kin=state.kin.replace(pos=torch.as_tensor(starts, device=dev)))
    mp, ms = mellinger_params(device=dev), mellinger_reset((n,), device=dev)
    c = dict(cfg=cfg, params=params, cp=build_ctrl_params(cfg, dev), legs=legs, mp=mp,
             target=torch.zeros((n, 3), device=dev), zero=torch.zeros((n, 4), device=dev),
             dt=torch.tensor(1.0 / 500.0, device=dev), r2d=torch.tensor(RAD2DEG, device=dev))
    carry = dict(state=state, ms=ms, prev=quat_to_euler_xyz(state.kin.quat),
                 k=torch.zeros((), device=dev))
    return c, carry, corners, lands


def mission_tick(c, s):
    """One tick of the JAX test's scan body: setpoint, gyro feed, Mellinger,
    the env step with the preprocessed RPMs."""
    n = c["cfg"].num_drones
    sp = mission_setpoint(c["legs"], (s["k"] * c["dt"]).expand(n))
    state = s["state"]
    rpy = quat_to_euler_xyz(state.kin.quat)
    gyro = (rpy - s["prev"]) / c["dt"] * c["r2d"]
    z = torch.zeros_like(sp["yaw_rate"])
    rpm, s["ms"] = mellinger_rpm(c["mp"], s["ms"], state.kin.pos, state.kin.vel, state.kin.quat,
                                 gyro, sp["pos"], sp_vel=sp["vel"], sp_acc=sp["acc"],
                                 sp_quat=sp["quat"],
                                 sp_rate_deg=torch.stack([z, z, sp["yaw_rate"] * c["r2d"]], -1))
    s["state"], *_ = env_step(c["cfg"], c["params"], c["cp"], c["target"], state, c["zero"],
                              preprocessed_rpm=rpm)
    s["prev"], s["k"] = rpy, s["k"] + 1


def kin_of(state):
    return {k: getattr(state.kin, k).detach().cpu().double() for k in CTRL_LIMITS}


def rate_mode_rpm(out, kin, params, mix_inv):
    """CTBR's (..., 4) [thrust (m/s^2), p, q, r] to motor RPMs: a body-rate P
    loop (torque J (RATE_GAIN (w_des - w) ) + w x J w) and the inverse of the
    X mixer (thrust at the prop offsets, the km / kf yaw reaction)."""
    w = torch.einsum("...ji,...j->...i", quat_to_matrix(kin.quat), kin.ang_v)
    jw = torch.einsum("ij,...j->...i", params.J, w)
    tau = torch.einsum("ij,...j->...i", params.J, RATE_GAIN * (out[..., 1:] - w)) \
        + torch.linalg.cross(w, jw)
    f = torch.einsum("ij,...j->...i", mix_inv, torch.cat([params.m * out[..., :1], tau], -1))
    return torch.clamp(torch.sqrt(torch.clamp(f, min=0.0) / params.kf), max=params.max_rpm)


def loop_case(name, dev, E):
    """(b)'s batch: its config, params, the batched step and the controller's
    per-env targets, seeded (the same on every device)."""
    ctrl = 120 if name == "MRAC" else 240
    cfg = AviaryConfig(task=TASK_CTRL, pyb_freq=240, ctrl_freq=ctrl,
                       initial_xyzs=((0.0, 0.0, 0.1),))
    params = build_params(cfg, dev)
    step = make_batched_step(cfg, params, build_ctrl_params(cfg, dev), None, auto_reset=False)
    rng = np.random.default_rng(11)
    span = np.array([0.0, 0.0, 0.2]) if name == "MRAC" else np.array([0.3, 0.3, 0.2])
    target = np.array([0.0, 0.0, 1.0]) + rng.uniform(-1, 1, (E, 1, 3)) * span
    return cfg, params, step, torch.as_tensor(target, dtype=torch.float32, device=dev)


def fly_loop(name, dev, E, seconds, trace=False):
    """(b) / (c): the closed loop from batch_reset; returns the final state,
    the targets, per-control-step kinematics (``trace``) and ms a step."""
    cfg, params, step, target = loop_case(name, dev, E)
    state = batch_reset(cfg, params, E, device=dev)
    if name == "MRAC":
        mp = mrac_params(device=dev)
        ms = [mrac_reset(mp, (E, 1))]

        def control(state):
            rpm, ms[0], _, _ = mrac_control(mp, ms[0], cfg.ctrl_timestep, state.kin.pos,
                                            state.kin.quat, state.kin.vel, state.kin.ang_v,
                                            target)
            return rpm
    else:
        cp = ctbr_params(device=dev)
        p64 = params.to("cpu").map(torch.Tensor.double)
        mix = torch.stack([torch.ones(4, dtype=torch.float64), p64.prop_offsets[:, 1],
                           -p64.prop_offsets[:, 0],
                           (p64.km / p64.kf) * torch.tensor([-1.0, 1.0, -1.0, 1.0],
                                                            dtype=torch.float64)])
        mix_inv = torch.linalg.inv(mix).float().to(dev)

        def control(state):
            out = ctbr_control(cp, state.kin.pos, state.kin.quat, state.kin.vel, target)
            return rate_mode_rpm(out, state.kin, params, mix_inv)
    rpm = torch.zeros((E, 1, 4), device=dev) if name == "MRAC" else control(state)
    steps, rows = int(round(seconds * cfg.ctrl_freq)), []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        # examples/mrac.py's order: step with the last action, then control
        state, _ = step(state, rpm)
        rpm = control(state)
        if trace:
            rows.append(kin_of(state))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return state, target, rows, (time.perf_counter() - t0) * 1e3 / steps, steps


def hover_gates(dev):
    """tests/test_controllers_extra.py's single-step gates at E = LOOP_E:
    MRAC at the hover fixed point commands 0.25-2.5x the hover RPM; CTBR there
    asks g with zero rates, and climbs (thrust > 9) to a target 1 m up."""
    E, params = LOOP_E, build_params(AviaryConfig(), dev)
    pos = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(E, 3)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(E, 4)
    zero = torch.zeros((E, 3), device=dev)
    mp = mrac_params(device=dev)
    rpm, *_ = mrac_control(mp, mrac_reset(mp, (E,)), 1.0 / 120.0, pos, quat, zero, zero, pos)
    hover = float(params.hover_rpm)
    ratio = rpm.mean(-1) / hover
    cp = ctbr_params(device=dev)
    at = ctbr_control(cp, pos, quat, zero, pos)
    up = ctbr_control(cp, pos, quat, zero, pos + torch.tensor([0.0, 0.0, 1.0], device=dev))
    res = dict(mrac_rpm_over_hover=(float(ratio.min()), float(ratio.max())),
               ctbr_hover_thrust_gap=float((at[:, 0] - 9.8).abs().max()),
               ctbr_hover_rates=float(at[:, 1:].abs().max()), ctbr_climb=float(up[:, 0].min()))
    print(f"[11] (b) single-step gates at E={E}: " + json.dumps(res), flush=True)
    if not (0.25 < res["mrac_rpm_over_hover"][0] and res["mrac_rpm_over_hover"][1] < 2.5):
        fail(f"(b) MRAC at the hover point commands {res['mrac_rpm_over_hover']} x hover RPM")
    if not (res["ctbr_hover_thrust_gap"] < 1e-4 and res["ctbr_hover_rates"] < 1e-6
            and res["ctbr_climb"] > 9.0):
        fail(f"(b) CTBR's hover or climb command is off: {res}")


def phase11_controllers(dev):
    """(a) the 4,096-drone mission, (b) CTBR and MRAC closed loops at E = 4096,
    (c) each controller on the card against the CPU."""
    t_phase = time.perf_counter()
    # (a)
    c, s, corners, lands = mission_world(dev, MISSION_SIDE)
    n = c["cfg"].num_drones
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    for k in range(MISSION_TICKS):
        mission_tick(c, s)
        if k == MISSION_MID:
            mid = s["state"].kin.pos.clone()
    ev[1].record()
    ev[1].synchronize()
    wall, event = time.perf_counter() - t0, ev[0].elapsed_time(ev[1])
    mid, final = mid.cpu().numpy(), s["state"].kin.pos.cpu().numpy()
    prof = profile_steps(lambda: mission_tick(c, s), 4)
    if prof is None:
        fail("(a) torch.profiler saw no kernel on the card in a mission tick")
    gaps = dict(mid_xy=float(np.abs(mid[:, :2] - corners[:, :2]).max()),
                mid_z=float(np.abs(mid[:, 2] - corners[:, 2]).max()),
                end_xy=float(np.abs(final[:, :2] - lands[:, :2]).max()),
                end_z=float(np.abs(final[:, 2] - lands[:, 2]).max()))
    print(f"[11] (a) mission (commander + Mellinger through envs/base.step, preprocessed RPMs), "
          f"{n} drones in one world on a {MISSION_SIDE} x {MISSION_SIDE} grid at "
          f"{MISSION_PITCH} m, PYB 500/500 Hz, {MISSION_TICKS} ticks: {wall:.2f} s host, "
          f"{event / MISSION_TICKS:.4f} ms a tick (CUDA events), "
          f"{n * MISSION_TICKS / (event / 1e3):.6g} drone-ticks/s; a tick under torch.profiler "
          f"{prof['kernels_per_step']:.0f} kernels and memsets, card busy {prof['busy_ms']:.4f} "
          f"ms, idle share {1.0 - prof['busy_ms'] / (event / MISSION_TICKS):.4f}, host wall "
          f"{prof['wall_ms']:.3f} ms; worst gaps " + json.dumps(
              {k: float(f"{v:.4g}") for k, v in gaps.items()})
          + " (gates: corners at 4.5 s 0.06 xy, 0.12 z; pads 0.06 xy, 0.15 z)", flush=True)
    if not np.isfinite(final).all():
        fail("(a) the mission's positions are not finite")
    if not (gaps["mid_xy"] < 0.06 and gaps["mid_z"] < 0.12 and gaps["end_xy"] < 0.06
            and gaps["end_z"] < 0.15):
        fail(f"(a) the mission missed the JAX test's gates: {gaps}")
    # (b)
    hover_gates(dev)
    for name in ("MRAC", "CTBR"):
        state, target, _, ms, steps = fly_loop(name, dev, LOOP_E, LOOP_SEC)
        err = (state.kin.pos - target).norm(dim=-1)
        worst = float(err.max())
        print(f"[11] (b) {name} closed loop, E={LOOP_E} one-drone CtrlAviary envs, {LOOP_SEC} s "
              f"({steps} control steps): {ms:.4f} ms a control step (host clock), "
              f"{LOOP_E / (ms / 1e3):.6g} env-steps/s; |position error| at the end max "
              f"{worst:.4f} m, mean {float(err.mean()):.4f} m (gate {LOOP_GATES[name]} m)",
              flush=True)
        if not (bool(torch.isfinite(state.kin.pos).all()) and worst < LOOP_GATES[name]):
            fail(f"(b) {name} did not reach its targets: worst error {worst} m")
    # (c) the card against the CPU, PARITY_E drones over 1 s
    side = int(math.isqrt(PARITY_E))
    runs = {}
    for d in (dev, torch.device("cpu")):
        cm, sm, _, _ = mission_world(d, side)
        rows = []
        for _ in range(500):
            mission_tick(cm, sm)
            rows.append(kin_of(sm["state"]))
        runs[("Mellinger mission", d.type)] = rows
        for name in ("MRAC", "CTBR"):
            runs[(name, d.type)] = fly_loop(name, d, PARITY_E, 1.0, trace=True)[2]
    worst = {}
    for name in ("Mellinger mission", "MRAC", "CTBR"):
        card, cpu = runs[(name, dev.type)], runs[(name, "cpu")]
        worst[name] = {k: max(float((a[k] - b[k]).abs().max()) for a, b in zip(card, cpu))
                       for k in CTRL_LIMITS}
    print(f"[11] (c) card vs CPU over 1 s, {PARITY_E} drones (the mission on an {side} x {side} "
          f"grid, 500 ticks; MRAC 120 and CTBR 240 control steps): max gaps "
          + json.dumps({k: {f: float(f"{x:.3g}") for f, x in v.items()} for k, v in worst.items()})
          + f" (limits {json.dumps(CTRL_LIMITS)})", flush=True)
    for name, v in worst.items():
        for f, x in v.items():
            if not x <= CTRL_LIMITS[f]:
                fail(f"(c) {name} on the card differs from the CPU in {f}: {x}")
    print(f"[11] phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)


# Phase 11b: the Gymnasium shells. Where gymnasium is installed they are driven
# through gymnasium.make / make_vec; where it is not, through the device
# functions they wrap (runtime/shell.py) at the same sizes.
SHELL_HOVER = dict(task=TASK_HOVER, pyb_freq=240, ctrl_freq=30, obstacles=True,
                   action_buffer_size=15)  # HoverAviary's keywords (compat/gym.py)
SHELL_STEPS, VEC_E, VEC_STEPS, RGB_SHELL_E, RGB_SHELL_STEPS, RECORD_STEPS = \
    300, 4096, 256, 64, 30, 48


def shell_hover(dev, **extra):
    """The Hover shell's config, params, control params and target on ``dev``."""
    cfg = shell_config(**{**SHELL_HOVER, **extra})
    params = build_params(cfg, dev)
    return cfg, params, build_ctrl_params(cfg, dev), hover_target_pos(cfg, params)


def single_shell_run(dev, actions, gym_mod):
    """(a): one Hover env stepped with ``actions``, reset at an episode's end;
    the host seconds, the obs of reset and each step, and the episodes
    ended."""
    if gym_mod is not None:
        env = gym_mod.make("cuda/hover-aviary-v0", device=dev)

        def step(a):
            return env.step(a)[:4]

        def reset():
            return env.reset(seed=0)[0]
    else:
        cfg, params, cp, target = shell_hover(dev)
        holder = [None]

        def step(a):
            holder[0], *out = shell_step(cfg, params, cp, target, holder[0], a)
            return out

        def reset():
            holder[0] = env_reset(cfg, params)
            (o,) = host_copy(compute_obs(cfg, holder[0]))
            return o
    trace, ended = [reset()], 0
    t0 = time.perf_counter()
    for a in actions:
        obs, _, term, trunc = step(a)
        trace.append(obs)
        if term or trunc:
            ended += 1
            reset()
    return time.perf_counter() - t0, trace, ended


def vec_runner(dev, E, gym_mod, domain_rand=None, rgb=False):
    """A vector Hover env of E envs as ``(reset() -> obs, step(actions) ->
    (obs, reward, terminated, truncated, final obs)``: gymnasium.make_vec's
    VecAviary where gymnasium is installed, else the make_vec_core it wraps.
    The per-env plants come from the CPU generator VecAviary seeds (seed 0)."""
    extra = dict(obs=ObservationType.RGB, frame_stack=4) if rgb else {}
    if gym_mod is not None:
        vec = gym_mod.make_vec("cuda/hover-aviary-v0", num_envs=E, device=dev,
                               domain_rand=domain_rand, **extra)

        def step(a):
            o, r, te, tr, info = vec.step(a)
            fo = info.get("final_obs")
            return o, r, te, tr, None if fo is None else np.stack(
                [x if x is not None else np.zeros_like(o[0]) for x in fo])
        return lambda: vec.reset(seed=0)[0], step
    cfg, params, cp, target = shell_hover(dev, **extra)
    if domain_rand:
        params = randomize_params(torch.Generator().manual_seed(0), params, E, domain_rand)
    reset_core, step_core = make_vec_core(cfg, params, cp, target, E, dev)
    holder = [None]

    def reset():
        holder[0], obs = reset_core()
        return obs

    def step(a):
        holder[0], out = step_core(holder[0], a)
        return out
    return reset, step


def copy_share(dev, E, domain_rand):
    """The batched device step alone and the one host copy of its outputs
    alone, ms each (host clock after a synchronize, 8 steps)."""
    cfg, params, cp, target = shell_hover(dev)
    if domain_rand:
        params = randomize_params(torch.Generator().manual_seed(0), params, E, domain_rand)
    step_fn = make_batched_step(cfg, params, cp, target, auto_reset=True)
    state = batch_reset(cfg, params, E, device=dev)
    a = torch.zeros((E, 1, 4), device=dev)
    state, out = step_fn(state, a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        state, out = step_fn(state, a)
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) * 1e3 / 8
    t0 = time.perf_counter()
    for _ in range(8):
        host_copy(out.obs, out.reward, out.terminated, out.truncated, out.final_obs)
    return dev_ms, (time.perf_counter() - t0) * 1e3 / 8


def phase11b_shells(dev):
    """The Gymnasium shells on the card; returns K7's launches on their paths."""
    t_phase = time.perf_counter()
    gym_mod = None
    if importlib.util.find_spec("gymnasium") is not None:
        import gymnasium as gym_mod
    else:
        print("[11b] gymnasium absent on this machine: the Gym wrappers were run on the CPU "
              "only", flush=True)
    # (a) one Hover env, an episode boundary at 8 s (step 242), the first
    # second against the CPU
    acts = np.random.default_rng(4).uniform(-0.5, 0.5, (SHELL_STEPS, 1, 4)).astype(np.float32)
    secs, trace, ended = single_shell_run(dev, acts, gym_mod)
    _, trace_cpu, _ = single_shell_run(torch.device("cpu"), acts[:30], gym_mod)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(trace, trace_cpu))
    via = "gymnasium.make" if gym_mod else "runtime.shell.shell_step, the step HoverAviary wraps"
    print(f"[11b] (a) one cuda/hover-aviary-v0 env through {via}, {SHELL_STEPS} steps "
          f"(240/30 Hz, RPM actions, buffer 15): {secs:.2f} s host, {SHELL_STEPS / secs:.2f} "
          f"steps/s, episodes ended {ended}; max |obs gap| card vs CPU over the first second "
          f"(30 steps) {gap:.3g} (limit 1e-3)", flush=True)
    if ended < 1 or not all(np.isfinite(o).all() for o in trace):
        fail(f"(a) the single shell ended no episode in {SHELL_STEPS} steps, or its obs are not "
             "finite")
    if not gap <= 1e-3:
        fail(f"(a) the single shell on the card differs from the CPU over 1 s: {gap}")
    # (b), (c) E = 4096 vector envs, nominal and per-env plants
    vec_acts = np.random.default_rng(9).uniform(-0.3, 0.3, (VEC_STEPS, 1, 1, 4)) \
        .astype(np.float32)
    for what, dr in (("(b) nominal", None),
                     ("(c) domain_rand m 0.1, kf 0.05", {"m": 0.1, "kf": 0.05})):
        reset, step = vec_runner(dev, VEC_E, gym_mod, dr)
        reset()
        outs, t0 = [], time.perf_counter()
        for a in vec_acts:  # every env the same action: only the plants differ
            outs.append(step(np.broadcast_to(a, (VEC_E, 1, 4)).copy()))
        host_ms = (time.perf_counter() - t0) * 1e3 / VEC_STEPS
        dev_ms, copy_ms = copy_share(dev, VEC_E, dr)
        ends = [t for t, o in enumerate(outs) if (o[2] | o[3]).any()]
        if not ends:
            fail(f"{what}: no episode ended in {VEC_STEPS} steps")
        o, _, te, tr, final = outs[ends[0]]
        done = te | tr
        if not (np.isfinite(final[done]).all() and all(np.isfinite(x[0]).all() for x in outs)):
            fail(f"{what}: obs or final obs not finite")
        if np.array_equal(final[done], o[done]):
            fail(f"{what}: the final obs equals the reset obs at the boundary")
        spread = float(np.ptp(outs[29][0][:, 0, 2]))
        print(f"[11b] {what}: cuda/hover-aviary-v0 vector env through "
              f"{'gymnasium.make_vec' if gym_mod else 'runtime.shell.make_vec_core'}, "
              f"E={VEC_E}, {VEC_STEPS} steps: {host_ms:.3f} ms a step (host clock), "
              f"{VEC_E / (host_ms / 1e3):.6g} env-steps/s; the batched device step alone "
              f"{dev_ms:.3f} ms, the one host copy of its outputs alone {copy_ms:.3f} ms "
              f"({copy_ms / host_ms:.4f} of a step); first boundary at step {ends[0] + 1} "
              f"({int(done.sum())} envs, their final obs delivered); z spread over the envs at "
              f"step 30 {spread:.4g} m", flush=True)
        if dr and not spread > 1e-3:
            fail(f"{what}: the per-env plants did not spread z ({spread})")
        if not dr and spread != 0.0:
            fail(f"{what}: the nominal envs, stepped alike, spread in z ({spread})")
    # (d) RGB at E = 64, frame_stack 4: K7 once a control step, frames against
    # the CPU on RGB_CPU_ENVS of the envs, exactly
    rgb_acts = np.random.default_rng(6).uniform(-0.5, 0.5, (RGB_SHELL_STEPS, RGB_SHELL_E, 1, 4)) \
        .astype(np.float32)
    reset, step = vec_runner(dev, RGB_SHELL_E, gym_mod, rgb=True)
    card = [reset()]
    render_views_cuda.launches = 0
    t0 = time.perf_counter()
    card += [step(a) for a in rgb_acts]
    k7_rgb = render_views_cuda.launches
    rgb_ms = (time.perf_counter() - t0) * 1e3 / RGB_SHELL_STEPS
    reset, step = vec_runner(torch.device("cpu"), RGB_CPU_ENVS, None, rgb=True)
    cpu = [reset()] + [step(a[:RGB_CPU_ENVS]) for a in rgb_acts]
    differ = int((card[0][:RGB_CPU_ENVS] != cpu[0]).sum()) + sum(
        int((c[0][:RGB_CPU_ENVS] != p[0]).sum()) for c, p in zip(card[1:], cpu[1:]))
    r_gap = max(float(np.abs(c[1][:RGB_CPU_ENVS] - p[1]).max()) for c, p in zip(card[1:], cpu[1:]))
    shape = card[1][0].shape
    print(f"[11b] (d) RGB cuda/hover-aviary-v0 vector env (frame_stack 4, obs {shape} uint8), "
          f"E={RGB_SHELL_E}, {RGB_SHELL_STEPS} steps: {rgb_ms:.3f} ms a step (host clock); K7 "
          f"launches over the steps {k7_rgb} (one a control step expected); card vs CPU on "
          f"{RGB_CPU_ENVS} envs: frame bytes differing {differ}, max |reward gap| {r_gap:.3g}",
          flush=True)
    if k7_rgb != RGB_SHELL_STEPS:
        fail(f"(d) K7 launched {k7_rgb} times over {RGB_SHELL_STEPS} control steps")
    if differ or not r_gap <= 1e-3 or shape != (RGB_SHELL_E, 1, 48, 64, 16):
        fail(f"(d) RGB frames or rewards on the card differ from the CPU: {differ} bytes, "
             f"reward gap {r_gap}, obs shape {shape}")
    # (e) record=True: drone 0's 128 x 96 camera every control step, K7
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_record_")
    try:
        render_views_cuda.launches = 0
        t0 = time.perf_counter()
        if gym_mod is not None:
            env = gym_mod.make("cuda/hover-aviary-v0", record=True, output_folder=out_dir,
                               device=dev)
            env.reset(seed=0)
            for a in acts[:RECORD_STEPS]:
                env.step(a)
            env.close()
            (rec,) = os.listdir(out_dir)
            rec = os.path.join(out_dir, rec)
        else:
            cfg, params, cp, target = shell_hover(dev)
            state, rec = env_reset(cfg, params), out_dir
            for k, a in enumerate(acts[:RECORD_STEPS]):
                state, *_ = shell_step(cfg, params, cp, target, state, a)
                record_frame(state, params, True, rec, k)
            png_dir_to_video(rec, fps=24)
        k7_rec = render_views_cuda.launches
        secs = time.perf_counter() - t0
        frames = sorted(f for f in os.listdir(rec) if f.endswith(".png"))
        videos = [f for f in os.listdir(rec) if f.endswith((".avi", ".mp4"))]
        print(f"[11b] (e) record=True Hover env, {RECORD_STEPS} steps: {len(frames)} frames of "
              f"128 x 96 written, video {videos}, K7 launches {k7_rec}, {secs:.2f} s host",
              flush=True)
        if len(frames) != RECORD_STEPS or k7_rec != RECORD_STEPS or not videos:
            fail(f"(e) record=True wrote {len(frames)} frames with {k7_rec} K7 launches")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[11b] phase 11b: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k7_rgb + k7_rec

# Phase 12: tests/test_cffirmware.py's mission and tests/test_betaflight.py's
# closed loop, their gates; the sharded swarms' sizes and control steps.
CF_GATES = dict(z=0.15, xy=0.05)
BETA_TARGET, BETA_GATE, BETA_SEC = np.array([0.3, -0.2, 0.8]), 0.08, 7
SHARD_T = 12
# tests/test_swarm_binned_sharded.py: sharded against one device (pos, vel
# 1e-6, quat 1e-7) and against the dense soa step (pos 1e-4, vel 1e-3)
SHARD_EXACT_LIMITS = dict(pos=1e-6, vel=1e-6, quat=1e-7)
SHARD_SOA_LIMITS = dict(pos=1e-4, vel=1e-3)


def cf_env(device, gym_ok):
    if gym_ok:
        from gym_pybullet_drones_tpu_torch.envs.cf import CFAviary
        return CFAviary(pyb_freq=500, ctrl_freq=25, device=device)
    return CFShellEnv(pyb_freq=500, ctrl_freq=25, device=device)


def phase12_cf(dev, gym_ok):
    """(a) the CF mission through the firmware loop on the card."""
    env = cf_env(dev, gym_ok)
    env.reset()
    env.sendTakeoffCmd(1.0, 2.0)
    first, t0 = [], time.perf_counter()
    for i in range(25 * 3):
        obs = env.step(i)[0]
        if i < 25:
            first.append(obs[0, :3].copy())
    z_after_takeoff = float(obs[0, 2])
    env.sendGotoCmd([0.5, 0.5, 1.0], 0.0, 3.0, False)
    for i in range(25 * 3, 25 * 7):
        obs = env.step(i)[0]
    secs = time.perf_counter() - t0
    pos, ticks, err = obs[0, :3].astype(np.float64), env.tick, env._error
    # two more control steps (20 ticks each), the second under torch.profiler:
    # the kernels of a tick
    more = iter(range(25 * 7, 25 * 8))
    prof = profile_steps(lambda: env.step(next(more)), 1)
    env.close()
    xy = float(np.linalg.norm(pos[:2] - [0.5, 0.5]))
    cpu = cf_env("cpu", gym_ok)
    cpu.reset()
    cpu.sendTakeoffCmd(1.0, 2.0)
    gap = max(float(np.abs(cpu.step(i)[0][0, :3] - first[i]).max()) for i in range(25))
    cpu.close()
    ms_tick = secs * 1e3 / ticks
    if prof is None:
        fail("(a) torch.profiler saw no kernel of the firmware loop's sim steps on the card")
    print(f"[12] (a) CF mission, {ticks} firmware ticks in {secs:.2f} s: {ms_tick:.4f} ms a tick "
          f"(host clock; each tick one PYB substep through shell_step and its one copy back), "
          f"{prof['kernels_per_step'] / 20:.1f} kernels and memsets a tick, card busy "
          f"{prof['busy_ms'] / 20:.4f} ms a tick (torch.profiler); z after the takeoff "
          f"{z_after_takeoff:.4f}, final {pos.round(4).tolist()}, |xy - goal| {xy:.4f} m (gates "
          f"{json.dumps(CF_GATES)}), tumble {err}; card vs CPU over the first second (25 control "
          f"steps) max |pos gap| {gap:.3g} m", flush=True)
    if not (abs(z_after_takeoff - 1.0) < CF_GATES["z"] and abs(pos[2] - 1.0) < CF_GATES["z"]
            and xy < CF_GATES["xy"]) or err or ticks != 3500:
        fail("(a) the CF mission missed its gates on the card")
    if not gap < 0.03:
        fail(f"(a) the firmware loop's first second on the card parts from the CPU's by {gap} m")
    return ms_tick


def phase12_beta(dev, gym_ok):
    """(b) the Betaflight closed loop with MockSITL on the card."""
    from gym_pybullet_drones_tpu_torch.bridges.betaflight import MockSITL
    from gym_pybullet_drones_tpu_torch.control.compat import CTBRControl
    from gym_pybullet_drones_tpu_torch.envs.spec import DroneModel

    sitl = MockSITL(0, "127.0.0.2").start()
    kw = dict(drone_model=DroneModel.RACE, num_drones=1, pyb_freq=500, ctrl_freq=500,
              udp_ip="127.0.0.2", device=dev)
    if gym_ok:
        from gym_pybullet_drones_tpu_torch.envs.beta import BetaAviary
        env = BetaAviary(**kw)
    else:
        env = BetaShellEnv(**kw)
    ctrl = CTBRControl(DroneModel.RACE, device=dev)
    obs, _ = env.reset(seed=0)
    action = np.zeros((1, 4))
    t0 = time.perf_counter()
    try:
        for i in range(500 * BETA_SEC):
            obs = env.step(action, i)[0]
            if i / 500 > env.TRAJ_TIME:
                action[0] = ctrl.computeControlFromState(1 / 500, obs[0], target_pos=BETA_TARGET)
    finally:
        env.close()
        sitl.stop()
    secs = time.perf_counter() - t0
    err = float(np.linalg.norm(obs[0][:3] - BETA_TARGET))
    ms_step = secs * 1e3 / (500 * BETA_SEC)
    print(f"[12] (b) Betaflight closed loop (MockSITL, RACE, 500/500 Hz, {BETA_SEC} s): "
          f"{ms_step:.4f} ms a step (host clock: the sim step, the CTBR controller on the card "
          f"and the UDP exchange), final error {err:.4f} m (gate {BETA_GATE})", flush=True)
    if not err < BETA_GATE:
        fail(f"(b) the Betaflight loop ended {err} m from its target")
    return ms_step


def timed_steps(step, state, steps):
    """``steps`` calls of ``state = step(state)`` between two synchronizes:
    (state, ms a call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3 / steps


def phase12_mesh(dev, params):
    """(c) the sharded swarms on a one-rank NCCL group; returns the launches
    of their drives."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rmesh.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    launches = Counter()
    try:
        mesh = rmesh.make_mesh()
        hover = float(params.hover_rpm)
        n = SWARM_N[1]
        rpm4 = torch.full((n, 4), hover, device=dev)
        rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
        sharded = make_sharded_swarm_physics(mesh, params, 1 / 240, 5, Physics.PYB_DW,
                                             collisions=True, pallas=True)
        step = lambda kin_: sharded(kin_, rpm4, rpm4)[0]
        init, soa_step, export = make_swarm_physics(params, 1 / 240, 5, collisions=True,
                                                    backend="soa")
        # The towers lifted 2 m (no drone in touch with another or with the
        # ground in 12 steps, though the lowest of each tower sinks about
        # 1.2 m: the two pipelines differ by the order of their float32 sums
        # alone) over SHARD_T control steps; the contact fleet (pairs in
        # touch, whose thresholds a rounding may flip) over the JAX test's 3.
        lifted = towers(n)
        lifted[0][:, 2] += 2.0
        for what, (pos, vel), steps in (("towers lifted 2 m", lifted, SHARD_T),
                                        ("co-planar pairs beside towers", contact_fleet(n), 3)):
            kin = fleet_kin(pos, vel, dev)
            step(shard_swarm_kin(mesh, kin))  # warm-up
            reset_pair_launches()
            got, shard_ms = timed_steps(step, shard_swarm_kin(mesh, kin), steps)
            counts = pair_launches()
            launches.update(counts)
            if (counts["K2"], counts["K4"]) != (5 * steps, 5 * steps):
                fail(f"(c) the sharded swarm launched {counts}, not K2 = K4 = {5 * steps}")
            soa_step(init(kin), rpm)  # warm-up
            s, soa_ms = timed_steps(lambda s_: soa_step(s_, rpm), init(kin), steps)
            gaps = kin_gaps(got, export(s, kin), SHARD_SOA_LIMITS)
            moved = float((got.pos[:n // 2, :2] - kin.pos[:n // 2, :2]).abs().max())
            print(f"[12] (c) one-rank NCCL group: make_sharded_swarm_physics (pair-pass path, K2 "
                  f"and K4 rectangular, z_sort {_pairs.use_z_sort(None, n, n)}) N={n} {what}, "
                  f"PYB_DW with contact, {steps} control steps: {shard_ms:.4f} ms a control step "
                  f"against the unsharded soa step's {soa_ms:.4f} (host clock between "
                  f"synchronizes); launches {counts}; gaps against the soa step "
                  + json.dumps({k: float(f"{v:.3g}") for k, v in gaps.items()})
                  + f" (limits {json.dumps(SHARD_SOA_LIMITS)}); the first half's largest "
                  f"lateral move {moved:.4f} m", flush=True)
            check_kin_gaps(f"(c) the sharded swarm against the soa step, {what}", gaps,
                           SHARD_SOA_LIMITS)
        if not moved > 1e-4:
            fail("(c) no contact fired in the sharded swarm's co-planar pairs")

        n, pitch = BINNED_FLEETS[1]
        pos = lattice(n, pitch)
        kin = init_kin_state(pos, np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), device=dev)
        rpm = [torch.full((n,), hover, device=dev) for _ in range(4)]
        for coll in (False, True):
            init_s, step_s, export_s = make_swarm_physics(params, 1 / 240, 5, collisions=coll,
                                                          init_pos=pos, mesh=mesh)
            step_s(shard_binned_state(mesh, init_s(kin)), rpm)  # warm-up
            reset_pair_launches()
            s_sh = shard_binned_state(mesh, init_s(kin))
            s_sh, sh_ms = timed_steps(lambda s_: step_s(s_, rpm), s_sh, SHARD_T)
            a = export_s(s_sh, kin)
            torch.cuda.synchronize()
            counts = pair_launches()
            launches.update(counts)
            k = "K6" if coll else "K3"
            if counts[k] < 5 * SHARD_T:
                fail(f"(c) the sharded binned swarm launched {counts}, not {5 * SHARD_T} of {k}")
            init_u, step_u, export_u = make_swarm_physics(params, 1 / 240, 5, collisions=coll,
                                                          init_pos=pos)
            step_u(init_u(kin), rpm)  # warm-up
            s_u, un_ms = timed_steps(lambda s_: step_u(s_, rpm), init_u(kin), SHARD_T)
            b = export_u(s_u, kin)
            equal = all(torch.equal(getattr(a, f), getattr(b, f))
                        for f in ("pos", "quat", "vel", "ang_v"))
            gaps = kin_gaps(a, b, SHARD_EXACT_LIMITS)
            print(f"[12] (c) binned N={n} pitch {pitch} m, slot axis sharded (K3/K6 "
                  f"rectangular), collisions={coll}, {SHARD_T} control steps: {sh_ms:.4f} ms a "
                  f"control step (a rebin every 4) against the unsharded "
                  f"{un_ms:.4f}; launches {counts}; bit for bit equal to the unsharded: {equal}"
                  + ("" if equal else "; gaps " + json.dumps(
                      {f: float(f"{v:.3g}") for f, v in gaps.items()})), flush=True)
            check_kin_gaps(f"(c) the sharded binned swarm collisions={coll}", gaps,
                           SHARD_EXACT_LIMITS)
    finally:
        torch.distributed.destroy_process_group()
    return launches


def phase12_checkpoint(dev):
    """(d) a PPO runner at E = 4096 through save and restore."""
    cfg = AviaryConfig(**PPO_ENV)
    ppo_cfg = PPOConfig(num_envs=PPO_WIDE, n_steps=16)
    runner, aux = ppo_init(cfg, ppo_cfg, 5)
    train = make_ppo_train_step(cfg, ppo_cfg, aux)
    runner, _ = train(runner)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(tmp, runner, step=1)
        save_ms = (time.perf_counter() - t0) * 1e3
        template, _ = ppo_init(cfg, ppo_cfg, 6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = checkpoint.restore_checkpoint(tmp, template)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
    r1, m1 = train(runner)
    r2, m2 = train(restored)
    same = (all(torch.equal(m1[k], m2[k]) for k in m1)
            and all(torch.equal(a, b) for a, b in zip(r1.params.parameters(),
                                                      r2.params.parameters()))
            and torch.equal(r1.env_state.kin.pos, r2.env_state.kin.pos)
            and torch.equal(r1.generator.get_state(), r2.generator.get_state()))
    print(f"[12] (d) PPO runner E={PPO_WIDE}: save {save_ms:.1f} ms, restore {load_ms:.1f} ms "
          f"(host clock), {size} bytes; the next train step after the restore bit for bit equal "
          f"to the saved run's: {same}", flush=True)
    if not same or not on_card(restored.env_state):
        fail("(d) the restored runner's next train step differs, or its state left the card")


def phase12_profiling(args, soa0, action, k_ms):
    """(e) measure_throughput on K1's rollout beside phase 5, and a trace."""
    rollout = make_velocity_rollout(*args, T_TIME, device=soa0["px"].device)
    rate, _ = profiling.measure_throughput(rollout, soa0, action, iters=5, warmup=1,
                                           items_per_call=E * T_TIME)
    phase5 = E * T_TIME / (k_ms / 1e3)
    short = make_velocity_rollout(*args, 48, device=soa0["px"].device)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for _ in range(3):
                short(soa0, action)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "velocity_rollout_kernel" in str(e.get("name", ""))]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]
    print(f"[12] (e) measure_throughput on K1's rollout, E={E}, T={T_TIME}, 5 chained calls: "
          f"{rate:.6g} env-steps/s against phase 5's {phase5:.6g} (events, median); trace.json "
          f"of 3 launches at T = 48 read back: {len(events)} events, {len(host)} host ops and "
          f"runtime calls, {len(kernels)} device kernels, {len(k1)} of them K1's (a fresh "
          "process records K1 here; after this script's earlier profiling, none)", flush=True)
    if not (rate > 0 and host):
        fail("(e) measure_throughput gave no rate, or the trace holds no host event")
    return rate


def phase12_runtime(dev, params, args, soa0, action, k_ms):
    """Phase 12; returns the pair-kernel launches of the sharded drives."""
    t_phase = time.perf_counter()
    gym_ok = importlib.util.find_spec("gymnasium") is not None
    print("[12] " + ("envs/cf.py and envs/beta.py (gymnasium installed)" if gym_ok else
                     "gymnasium absent on this machine: the firmware loops run through "
                     "runtime/firmware.CFShellEnv and BetaShellEnv, the loops CFAviary and "
                     "BetaAviary wrap"), flush=True)
    t0 = time.perf_counter()
    phase12_cf(dev, gym_ok)
    t_cf = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase12_beta(dev, gym_ok)
    t_beta = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase12_checkpoint(dev)
    phase12_profiling(args, soa0, action, k_ms)
    t_de = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = phase12_mesh(dev, params)
    print(f"[12] phase 12: {time.perf_counter() - t_phase:.1f} s ((a) {t_cf:.1f}, (b) "
          f"{t_beta:.1f}, (d) + (e) {t_de:.1f}, (c) {time.perf_counter() - t0:.1f})",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the examples on the card. Each example runs through its run() (or
# play(), main()) in ``python3 chip_smoke.py --example NAME ...`` processes,
# a few at once: the examples are host-bound loops of small launches, and the
# machine has cores to spare. Gates are tests/test_examples.py's.
# ---------------------------------------------------------------------------

# JAX's examples/play.play on checkpoints/one_d_rpm_hover.msgpack (8 s, one
# env) on a CPU in float32, jax 0.9.0, computed once: the port's play on the
# card must return at least this less 0.5.
JAX_PLAY_ONE_D_RPM_HOVER = 470.0426025390625
EXAMPLE_GROUPS = (("learn",), ("learn_multiagent",), ("play_checkpoint", "mrac", "pid", "debug"),
                  ("cf", "beta", "downwash"), ("pid_velocity", "trajopt"))
# phase 13's budget: one deadline for all its workers (a separate
# ``--examples`` call may run longer ones, such as trajopt_full)
EXAMPLE_TIMEOUT = 300
EXAMPLES_ONLY_TIMEOUT = 900
# pid on the card against the CPU (m, m/s): float32 over the first 0.5 s (the
# two part by rounding from the first step, and the helix's closed loop grows
# the gap about tenfold every 0.15 s: 7.3e-4 m at 1 s on the H100), float64
# over the whole first second.
PID_CPU_LIMITS = {"float32": dict(pos=1e-4, vel=1e-3, steps=24),
                  "float64": dict(pos=1e-9, vel=1e-8, steps=48)}
# pid_velocity and downwash on the card against the CPU in float64 over 1 s
# (m, m/s), held over the control steps that tests/test_torch_example_parity.py
# holds the port against JAX: pid_velocity's velocity loop grows an ulp's gap
# about fiftyfold every 0.25 s, so its first 0.75 s.
F64_CPU_LIMITS = {"pid_velocity": dict(pos=1e-9, vel=1e-8, steps=36),
                  "downwash": dict(pos=1e-9, vel=1e-8, steps=48)}
EXAMPLE_BETA_IP = "127.0.0.2"
# learn at the CI budget: one 128-step rollout of 4 envs, the 260-step
# evaluation, the 2,600-step final one and the 240-step logged replay.
LEARN_CI_STEPS = 128 + 260 + 2600 + 240
TRAJOPT_CHECK_ITERS = 10


def example_line(name, secs, count, unit, extra):
    print(f"[13] {name}: {secs:.2f} s wall, {secs * 1e3 / count:.3f} ms a {unit} ({count} "
          f"{unit}s); {extra}", flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def example_dtype(module, dtype):
    """Run ``module``'s example with its ``AviaryConfig`` in ``dtype``."""
    config = module.AviaryConfig
    module.AviaryConfig = functools.partial(config, dtype=dtype)
    try:
        yield
    finally:
        module.AviaryConfig = config


def pid_gaps(a, b):
    """Max |gap| of position and velocity, per control step, of two loggers'
    (drones, 16, T) states over their common steps."""
    t = min(a.shape[2], b.shape[2])
    d = np.abs(a[:, :, :t] - b[:, :, :t])
    return d[:, 0:3].max(axis=(0, 1)), d[:, 3:6].max(axis=(0, 1))


def ex_pid(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import pid

    folder = os.path.join(out, "pid")
    logger, secs = timed(lambda: pid.run(plot=False, output_folder=folder, duration_sec=4,
                                         device=dev))
    st, bad = logger.states, []
    alt = st[:, 2, -1]
    if not (st.shape == (3, 16, 192) and np.allclose(alt, [0.1, 0.15, 0.2], atol=0.02)):
        bad.append(f"altitudes {alt.tolist()} of {st.shape}, gate [0.1, 0.15, 0.2] at 0.02")
    if not any(p.startswith("save-flight-pid-") for p in os.listdir(folder)):
        bad.append("no save-flight-pid-* CSV directory")
    example_line("pid", secs, 192, "control step",
                 f"3 drones, 4 s at 240/48 Hz; final altitudes {alt.round(5).tolist()} (gate "
                 "[0.1, 0.15, 0.2] at 0.02); CSV directory written")
    cpu = pid.run(plot=False, output_folder=folder, duration_sec=1, device="cpu").states
    with example_dtype(pid, "float64"):
        card64 = pid.run(plot=False, output_folder=folder, duration_sec=1, device=dev).states
        cpu64 = pid.run(plot=False, output_folder=folder, duration_sec=1, device="cpu").states
    for what, (a, b) in (("float32", (st, cpu)), ("float64", (card64, cpu64))):
        pos, vel = pid_gaps(a, b)
        lim = PID_CPU_LIMITS[what]
        n = lim["steps"]
        print(f"[13] pid card vs CPU, {what}: max |pos gap| at 0.25 / 0.5 / 0.75 / 1 s "
              f"{pos[11]:.3g} / {pos[23]:.3g} / {pos[35]:.3g} / {pos[47]:.3g} m, |vel gap| "
              f"{vel[11]:.3g} / {vel[23]:.3g} / {vel[35]:.3g} / {vel[47]:.3g} m/s (limits "
              f"{lim['pos']} m, {lim['vel']} m/s over the first {n} control steps)", flush=True)
        if not (pos[:n].max() <= lim["pos"] and vel[:n].max() <= lim["vel"]):
            bad.append(f"card vs CPU ({what}) over {n} control steps: pos {pos[:n].max():.3g} m, "
                       f"vel {vel[:n].max():.3g} m/s")
    return bad


def card_vs_cpu64(name, module, dev, out):
    """``module``'s 1-s flight in float64 on the card and on the CPU, held at
    F64_CPU_LIMITS[name]; returns the gates it missed."""
    with example_dtype(module, "float64"):
        card = module.run(plot=False, output_folder=out, duration_sec=1, device=dev).states
        cpu = module.run(plot=False, output_folder=out, duration_sec=1, device="cpu").states
    pos, vel = pid_gaps(card, cpu)
    lim = F64_CPU_LIMITS[name]
    n = lim["steps"]
    print(f"[13] {name} card vs CPU, float64: max |pos gap| {pos[:n].max():.3g} m, |vel gap| "
          f"{vel[:n].max():.3g} m/s over the first {n} control steps (limits {lim['pos']} m, "
          f"{lim['vel']} m/s); at 1 s {pos[-1]:.3g} m, {vel[-1]:.3g} m/s", flush=True)
    if card.shape == cpu.shape and pos[:n].max() <= lim["pos"] and vel[:n].max() <= lim["vel"]:
        return []
    return [f"card vs CPU (float64) over {n} control steps: pos {pos[:n].max():.3g} m, vel "
            f"{vel[:n].max():.3g} m/s"]


def ex_pid_velocity(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import pid_velocity

    logger, secs = timed(lambda: pid_velocity.run(plot=False, output_folder=out, device=dev))
    st = logger.states
    ok = st.shape == (4, 16, 240) and bool(np.isfinite(st).all())
    example_line("pid_velocity", secs, 240, "control step",
                 f"4 drones, 5 s; states {st.shape}, finite {bool(np.isfinite(st).all())}")
    bad = [] if ok else [f"states {st.shape}, finite {bool(np.isfinite(st).all())}"]
    return bad + card_vs_cpu64("pid_velocity", pid_velocity, dev, out)


def ex_downwash(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import downwash

    logger, secs = timed(lambda: downwash.run(plot=False, output_folder=out, duration_sec=4,
                                              device=dev))
    z0, z1 = logger.states[0, 2, -1], logger.states[1, 2, -1]
    example_line("downwash", secs, 192, "control step",
                 f"2 drones, PYB_DW, 4 s; final z {z0:.5f}, {z1:.5f} (gates 1.0 at 0.1, 0.5 "
                 "at 0.15)")
    bad = [] if abs(z0 - 1.0) < 0.1 and abs(z1 - 0.5) < 0.15 else [f"final z {z0}, {z1}"]
    return bad + card_vs_cpu64("downwash", downwash, dev, out)


def ex_mrac(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import mrac

    pos, secs = timed(lambda: mrac.run(plot=False, output_folder=out, duration_sec=10,
                                       device=dev))
    example_line("mrac", secs, 1200, "control step",
                 f"10 s at 240/120 Hz; final position {pos.round(5).tolist()} (gate z 1.0 at "
                 "0.05)")
    bad = [] if abs(pos[2] - 1.0) < 0.05 else [f"final z {pos[2]}"]
    with example_dtype(mrac, "float64"):
        card = mrac.run(plot=False, output_folder=out, duration_sec=1, device=dev)
        cpu = mrac.run(plot=False, output_folder=out, duration_sec=1, device="cpu")
    gap = float(np.abs(card - cpu).max())
    print(f"[13] mrac card vs CPU, float64: final position gap after 1 s {gap:.3g} m (limit "
          "1e-09 m)", flush=True)
    return bad + ([] if gap <= 1e-9 else [f"card vs CPU (float64) after 1 s: {gap:.3g} m"])


def ex_cf(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import cf

    logger, secs = timed(lambda: cf.run(plot=False, output_folder=out, duration_sec=8,
                                        device=dev))
    st = logger.states
    z = st[0, 2, -1]
    example_line("cf", secs, 200, "control step",
                 f"8 s at 500/25 Hz (4,000 firmware ticks); final z {z:.5f} (gate 0.5 at 0.15)")
    ok = bool(np.isfinite(st).all()) and abs(z - 0.5) < 0.15
    return [] if ok else [f"final z {z}, finite {bool(np.isfinite(st).all())}"]


def ex_beta(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import beta

    logger, secs = timed(lambda: beta.run(plot=False, output_folder=out, duration_sec=5,
                                          udp_ip=EXAMPLE_BETA_IP, device=dev))
    st = logger.states
    z = st[0, 2, -1]
    example_line("beta", secs, 2500, "control step",
                 f"MockSITL on {EXAMPLE_BETA_IP}, RACE, 5 s at 500/500 Hz; final z {z:.5f} "
                 "(gate > 0.5)")
    return [] if bool(np.isfinite(st).all()) and z > 0.5 else [f"final z {z}"]


def ex_debug(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import debug

    res, secs = timed(lambda: debug.main(device=dev))
    n, dt = 240, 1.0 / 240.0
    # the integrator's closed form (velocity, then position): 5.0796 m, not
    # the continuous 10 - 9.8 / 2
    want = 10.0 - 9.8 * dt * dt * n * (n + 1) / 2
    hz, vz = float(res["hover_pos"][2]), float(res["hover_vel"][2])
    example_line("debug", secs, 504, "substep",
                 f"hover z {hz:.7f}, vz {vz:.3g} (gates |z - 1| < 1e-4, |vz| < 1e-4); free-fall "
                 f"z {float(res['fall_z']):.6f} against {want:.6f} (gate 1e-3)")
    ok = abs(hz - 1.0) < 1e-4 and abs(vz) < 1e-4 and abs(float(res["fall_z"]) - want) < 1e-3
    return [] if ok else [f"hover z {hz}, vz {vz}, free fall {res['fall_z']}"]


def ex_learn(dev, out, multiagent=False):
    from gym_pybullet_drones_tpu_torch.examples import learn, play

    name = "learn_multiagent" if multiagent else "learn"
    folder = os.path.join(out, name)
    evals, secs = timed(lambda: learn.run(plot=False, output_folder=folder, local=False,
                                          num_envs=4, multiagent=multiagent, device=dev))
    model = os.path.join(folder, "best_model.msgpack")
    ok = len(evals) >= 1 and math.isfinite(evals[-1][1]) and os.path.exists(model)
    example_line(name, secs, LEARN_CI_STEPS, "control step",
                 f"CI budget (local=False, 4 envs): evaluations {evals}; best_model.msgpack "
                 f"written: {os.path.exists(model)}")
    bad = [] if ok else [f"evaluations {evals}, model written {os.path.exists(model)}"]
    if not multiagent:
        total, secs = timed(lambda: play.play(model_path=model, output_folder=folder,
                                              plot=False, device=dev))
        example_line("play (learn's model)", secs, 240, "control step",
                     f"8 s replay of the file learn wrote: return {total:.5f}")
        if not math.isfinite(total):
            bad.append(f"play on learn's model returned {total}")
    return bad


def ex_learn_multiagent(dev, out):
    return ex_learn(dev, out, multiagent=True)


def ex_play_checkpoint(dev, out):
    from gym_pybullet_drones_tpu_torch.examples import play

    model = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                         "one_d_rpm_hover.msgpack")
    total, secs = timed(lambda: play.play(model_path=model, output_folder=out, plot=False,
                                          device=dev))
    gate = JAX_PLAY_ONE_D_RPM_HOVER - 0.5
    example_line("play (one_d_rpm_hover)", secs, 240, "control step",
                 f"8 s return {total:.5f}; JAX's play on the CPU {JAX_PLAY_ONE_D_RPM_HOVER} "
                 f"(gate >= {gate:.5f})")
    return [] if total >= gate else [f"return {total} under {gate}"]


@contextlib.contextmanager
def adam_iterates():
    """Keep a host copy of the parameters each ``torch.optim.Adam.step``
    leaves (trajopt's schedule), as tests/test_torch_differentiability.py
    does."""
    iterates, step = [], torch.optim.Adam.step

    def recording_step(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        iterates.append(self.param_groups[0]["params"][0].detach().cpu().numpy().copy())
        return out

    torch.optim.Adam.step = recording_step
    try:
        yield iterates
    finally:
        torch.optim.Adam.step = step


def trajopt_run(device, iters, out):
    """trajopt.run: ((err, vel), seconds, loss, the iterates); the loss is
    trajopt's |pos - target|^2 + 0.1 |vel|^2 at the schedule it returns."""
    from gym_pybullet_drones_tpu_torch.examples import trajopt

    with adam_iterates() as iterates:
        (err, vel), secs = timed(lambda: trajopt.run(iters=iters, plot=False, output_folder=out,
                                                     device=device))
    return (err, vel), secs, err ** 2 + 0.1 * vel ** 2, iterates


def ex_trajopt(dev, out):
    _, _, loss0, _ = trajopt_run(dev, 0, out)
    _, secs, loss, card = trajopt_run(dev, TRAJOPT_CHECK_ITERS, out)
    _, cpu_secs, _, cpu = trajopt_run("cpu", TRAJOPT_CHECK_ITERS, out)
    card, cpu = np.stack(card), np.stack(cpu)
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    example_line("trajopt", secs, TRAJOPT_CHECK_ITERS, "iteration",
                 f"{secs * 1e3 / (TRAJOPT_CHECK_ITERS * 48):.3f} ms a control step forward and "
                 f"back (48 steps, float64); loss {loss0:.6f} at the hover schedule -> {loss:.6f} "
                 f"after {TRAJOPT_CHECK_ITERS}; the iterates against the CPU's: max gap "
                 f"{rel:.3g} of the largest (gate 1e-9; the CPU took {cpu_secs:.2f} s)")
    ok = card.shape == cpu.shape == (TRAJOPT_CHECK_ITERS, 48) and rel <= 1e-9 and loss < 0.5 * loss0
    return [] if ok else [f"iterates {card.shape} part from the CPU's by {rel}, loss {loss0} -> "
                          f"{loss}"]


def ex_trajopt_full(dev, out):
    """tests/test_examples.py::test_trajopt_example's settings: 1 s horizon,
    200 Adam iterations, within 1 cm of the target at under 5 cm/s."""
    (err, vel), secs, loss, _ = trajopt_run(dev, 200, out)
    example_line("trajopt (200 iterations)", secs, 200, "iteration",
                 f"final loss {loss:.6g}; final error {err:.6f} m, speed {vel:.6f} m/s (gates "
                 "0.01, 0.05)")
    return [] if err < 0.01 and vel < 0.05 else [f"error {err} m, speed {vel} m/s"]


EXAMPLES = {"pid": ex_pid, "pid_velocity": ex_pid_velocity, "downwash": ex_downwash,
            "mrac": ex_mrac, "cf": ex_cf, "beta": ex_beta, "debug": ex_debug,
            "learn": ex_learn, "learn_multiagent": ex_learn_multiagent,
            "play_checkpoint": ex_play_checkpoint, "trajopt": ex_trajopt,
            "trajopt_full": ex_trajopt_full}


def kernel_launches():
    return dict(K1=velocity_rollout_cuda.launches, **pair_launches(),
                K7=render_views_cuda.launches)


def example_worker(names):
    """``python3 chip_smoke.py --example NAME ...``: the named examples on the
    card, one after the other; exits non-zero if any missed a gate or raised."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.set_num_threads(2)  # a few of these run at once
    dev = torch.device("cuda")
    bad = []
    with tempfile.TemporaryDirectory() as out:
        for name in names:
            try:
                bad += [f"{name}: {b}" for b in EXAMPLES[name](dev, out)]
            except Exception as exc:  # the next examples still run; the process fails
                traceback.print_exc()
                bad.append(f"{name} raised {type(exc).__name__}: {exc}")
    print(f"[13] {'+'.join(names)}: kernel launches {json.dumps(kernel_launches())} (none of "
          "K1-K7 lies on the examples' paths)", flush=True)
    if bad:
        fail("; ".join(bad))
    return 0


def phase13_examples(groups=EXAMPLE_GROUPS, timeout=EXAMPLE_TIMEOUT):
    """The examples in one ``--example`` process a group, all groups at once,
    each writing to its own files (no pipe stalls a worker), under one
    deadline for them all."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[13] the examples through their entry points on the card, {len(groups)} processes "
          f"at once: {' | '.join(', '.join(g) for g in groups)}", flush=True)
    failed, procs = [], []
    with tempfile.TemporaryDirectory() as logs:
        try:
            for k, group in enumerate(groups):
                out = open(os.path.join(logs, f"{k}.out"), "w+")
                err = open(os.path.join(logs, f"{k}.err"), "w+")
                procs.append((group, out, err, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--example", *group],
                    stdout=out, stderr=err, text=True)))
            deadline = time.monotonic() + timeout
            for group, out, err, proc in procs:
                try:
                    proc.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for _, _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for group, out, err, proc in procs:
            out.seek(0)
            err.seek(0)
            print(out.read().rstrip(), flush=True)
            if proc.returncode != 0:
                failed.append(f"{'+'.join(group)} exited {proc.returncode}: {err.read()[-3000:]}")
            out.close()
            err.close()
    print(f"[13] phase 13: {time.perf_counter() - t_phase:.1f} s on {nvidia_smi_line()}",
          flush=True)
    if failed:
        fail("phase 13: " + " || ".join(failed))


def examples_only(groups):
    """``python3 chip_smoke.py --examples [GROUP ...]``: phase 13 alone, each
    GROUP a comma-separated list of example names (default: phase 13's)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[1] device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {nvidia_smi_line()}", flush=True)
    phase13_examples(tuple(tuple(g.split(",")) for g in groups) or EXAMPLE_GROUPS,
                     EXAMPLES_ONLY_TIMEOUT)
    return 0



def render_only():
    """``python3 chip_smoke.py --render``: phase 10b (a) alone, K7 built and
    its compiler's report printed first."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi_line()}",
          flush=True)
    _build.build(RENDER_KERNEL)
    for line in _build.ptxas_report(RENDER_KERNEL).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[2]   {RENDER_KERNEL}: {line.strip()}", flush=True)
    print(f"[2]   K7 blocks resident per SM: {render_ops.blocks_per_sm()}", flush=True)
    record, worst, cases = phase10b_render(torch.device("cuda"))
    print(json.dumps(dict(record, **worst, cases=cases)))
    return 0


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
    sources = (KERNEL, _pairs.UNIT_KERNEL, _pairs.MASKED_KERNEL, RENDER_KERNEL)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, started together
        list(pool.map(_build.build, sources))
    print(f"[2] built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in sources:
        for line in _build.ptxas_report(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[2]   {lib}: {line.strip()}", flush=True)
    for name, wake, contact in (("K2", True, False), ("K4", False, True), ("K5", True, True)):
        held = _pairs.unit_blocks_per_sm(wake, contact)
        print(f"[2]   {name} units of 128 threads resident per SM: {held} ({4 * held} warps)",
              flush=True)
    for name, contact in (("K3", False), ("K6", True)):
        held = {s: _pairs.masked_blocks_per_sm(contact, s) for s in _pairs.MASKED_SPLITS}
        print(f"[2]   {name} blocks (warps) resident per SM by source ranks S: "
              + ", ".join(f"S={s}: {b} ({b * s})" for s, b in held.items()), flush=True)
    print(f"[2]   K7 blocks of four {render_ops.TILE_W} x {render_ops.TILE_H} warp tiles resident per SM: "
          f"{render_ops.blocks_per_sm()}", flush=True)

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
    # Bit for bit: an env's lane runs the plain version's operations in their
    # order.
    unequal = [k for k in SOA_KEYS if not torch.equal(got[k], want[k])]
    if unequal:
        fail("K1 differs from its plain version bit for bit at T=8: " + "; ".join(unequal))
    print(f"[3] K1 vs plain, E={E} T={T_SHORT}: equal bit for bit", flush=True)
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
    k_dev = device_ms(lambda: velocity_rollout_cuda(*args, T_TIME, soa0, action), 3)
    velocity_rollout_plain(*args, 2, soa0, action)  # warm-up
    torch.cuda.synchronize()
    p_ms = event_ms(lambda: velocity_rollout_plain(*args, T_PLAIN, soa0, action), 1)[0]
    per_env, parts = ops_per_env(consts, cfg, sl, T_TIME)
    flops = per_env * E
    nbytes = (len(SOA_KEYS) + 4 + len(SOA_KEYS)) * 4 * E
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    print(f"[5] K1 E={E} T={T_TIME}: ms per repeat {[round(t, 4) for t in k_times]}, "
          f"median {k_ms:.4f} ms, {E * T_TIME / (k_ms / 1e3):.6g} env-steps/s; device "
          f"{'not measured' if k_dev is None else f'{k_dev:.4f} ms'} (torch.profiler, the "
          "wrapper's kernels and memsets)", flush=True)
    print(f"[5] plain version, same E, T={T_PLAIN} (a tenth of the kernel's depth), one run: "
          f"{p_ms:.1f} ms ({E * T_PLAIN / (p_ms / 1e3):.6g} env-steps/s)", flush=True)
    # The scaling line: a warp alone (E = 32) against fuller grids.
    scaling = {}
    for n in K1_SIZES:
        s_n, a_n = soa_from_state(batch_reset(cfg, params, n, device=dev)), formation_actions(n, dev)
        velocity_rollout_cuda(*args, 48, s_n, a_n)
        scaling[n] = statistics.median(
            event_ms(lambda: velocity_rollout_cuda(*args, T_TIME, s_n, a_n), 3))
    print(f"[5] K1 scaling line, T={T_TIME}, ms: "
          + ", ".join(f"E={n} {scaling[n]:.4f}" for n in K1_SIZES), flush=True)
    print(f"[5] bound: {per_env} ops per env for T={T_TIME} (ops per piece: "
          f"{json.dumps(parts)}; FMA counts 2 in the peak), {flops:.4g} ops / {PEAK_FP32_FLOPS:.3g} = {flops / PEAK_FP32_FLOPS * 1e3:.4g} ms; "
          f"{nbytes} bytes / {PEAK_BYTES_PER_S:.3g} = {nbytes / PEAK_BYTES_PER_S * 1e3:.4g} ms; "
          f"bound {bound_ms:.4g} ms by {bound_by}; library_ms null (no PyTorch call "
          "computes this function)", flush=True)

    # ---------------- 6. pair kernels against their plain versions ----------------
    swarm_params = params_cpu  # CF2X float32; the constants are read on the host
    pc = _pairs.pair_consts(swarm_params)
    pair_errs = phase6_pairs(dev, pc, swarm_params)
    pair_errs.update(phase6b_masked(dev, pc, swarm_params))

    # ---------------- 7. the coupled swarm's main paths ----------------
    pair_main = phase7_swarm(dev, params)
    pair_main.update(phase7b_backends(dev, params))

    # ---------------- 8. times ----------------
    ops = ops_per_pair(pc)
    print(f"[8] operations per pair, counted on the plain pair terms: {json.dumps(ops)}",
          flush=True)
    pair_times = phase8_times(dev, pc, params, ops)
    masked_times = phase8b_times(dev, pc, params, ops)

    # ---------------- 9. the impulse contact path ----------------
    phase9_impulse(dev, params)

    # ---------------- 10. PPO ----------------
    phase10_ppo(dev)

    # ---------------- 10b. the pixel path ----------------
    k7 = phase10b_pixels(dev)

    # ---------------- 11. the controllers ----------------
    phase11_controllers(dev)

    # ---------------- 11b. the Gymnasium shells ----------------
    k7["launches"] += phase11b_shells(dev)

    # ---------------- 12. firmware in the loop, the mesh, checkpoint, profiling ----------------
    pair_main.update(phase12_runtime(dev, params, args, soa0, action, k_ms))

    # ---------------- 13. the examples ----------------
    phase13_examples()

    # ---------------- 14. result ----------------
    kernels = [{
        "name": f"K1 {KERNEL}", "route": "cuda",
        "source": "gym_pybullet_drones_tpu_torch/csrc/velocity_rollout.cu",
        "replaces": "gym_pybullet_drones_tpu/ops/velocity_pallas.py:74",
        "launches": launches[KERNEL], "max_abs_err": max_abs_err,
        "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms, "plain_steps": T_PLAIN,
        "one_warp_ms": scaling[32], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }]
    for pid in PAIRS:
        if pair_main[pid] == 0:
            fail(f"the swarm's main path never launched {pid}")
        kernels.append({
            "name": f"{pid} {PAIRS[pid][2].__name__.removesuffix('_cuda')}_pairs",
            "route": "cuda", "source": PAIRS[pid][5],
            "replaces": PAIRS[pid][4], "launches": pair_main[pid],
            "max_abs_err": pair_errs[pid], **pair_times[(pid, SWARM_N[0], False)],
            "library_ms": None,
        })
    for pid in MASKED:
        if pair_main[pid] == 0:
            fail(f"the binned and sorted backends never launched {pid}")
        kernels.append({
            "name": f"{pid} {MASKED[pid][2].__name__.removesuffix('_cuda')}",
            "route": "cuda",
            "source": "gym_pybullet_drones_tpu_torch/csrc/masked_pair_kernels.cu",
            "replaces": MASKED[pid][5], "launches": pair_main[pid],
            **masked_times[pid], "library_ms": None,
            "max_abs_err": max(pair_errs[pid], masked_times[pid]["max_abs_err"]),
        })
    if k7["launches"] == 0:
        fail("the pixel path's train step never launched K7")
    kernels.append({
        "name": f"K7 {RENDER_KERNEL}", "route": "cuda",
        "source": "gym_pybullet_drones_tpu_torch/csrc/render_views.cu",
        "replaces": "gym_pybullet_drones_tpu/render/camera.py:177", **k7, "library_ms": None,
    })
    kernels.sort(key=lambda k: k["name"])
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite measurement for {k['name']}")
        if k["device_ms"] is None:
            print(f"[14] {k['name']}: device_ms null, no torch.profiler trace held its kernels "
                  "(not measured)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--eval"]:
        sys.exit(checkpoint_eval(sys.argv[2]))
    if sys.argv[1:2] == ["--example"]:
        sys.exit(example_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--examples"]:
        sys.exit(examples_only(sys.argv[2:]))
    if sys.argv[1:2] == ["--render"]:
        sys.exit(render_only())
    sys.exit(main())
