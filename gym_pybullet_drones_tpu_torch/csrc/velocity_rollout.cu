// K1: whole VelocityAviary rollout chunks, one lane of a warp an env.
//
// Replaces the TPU kernel `make_velocity_rollout_pallas` in
// gym_pybullet_drones_tpu/ops/velocity_pallas.py (its inner `kernel`). It
// computes what that kernel computes: `num_steps` x `velocity_step_soa`
// (ops/velocity_soa.py): the DSLPID velocity pipeline, then `n_substeps`
// Physics.PYB substeps (thrust at the prop offsets, yaw reaction torque,
// Newton-Euler, axis-angle quaternion update, ground clamp).
//
// Bound. Per launch the kernel moves (30 + 26) * 4 bytes per env, against
// about 10^3 floating-point operations per env-step times `num_steps`; at
// the main path's chunk lengths it is bound by operations, never by bytes.
// On the card it is bound by neither: each env's step is one long dependent
// chain (true divisions and square roots, each a short Newton sequence;
// atan2f, asinf, sinf, cosf; with -fmad=false every multiply-add two
// dependent instructions), so a warp alone takes as long as 512 warps side by
// side (the scaling line in PERF.md). The time is the chain's latency.
//
// Design. One lane runs one env, and the env's state stays in its registers
// for the whole time loop: nothing passes through device memory between
// steps. The lane evaluates exactly the operations of the plain version in
// their order. A step's independent operations of one kind (the atan2 of roll
// and yaw; the divisions of the thrust and of the three rate errors; the
// square roots of the thrust and of |t|; the divisions of the thrust PWM, of
// z_des and of y_des; the substep's accelerations, sin(theta) / |w| and the
// quaternion's four divisions by its norm) overlap by instruction-level
// parallelism: the sequences of csrc/rn_math.cuh have no branch, and
// divisions by one divisor share its reciprocal. Spreading an env over 2 or
// 4 lanes, each stage's operations over the lanes with a tree of selects and
// a shuffle back, was faster while each division, root and atan2f was the
// library's checked, branching sequence; with the branch-free sequences one
// lane an env is as fast or faster at every E measured, from one warp to
// 16,384 envs (PERF.md, the lane line), and the select trees and shuffles
// are gone with the lanes. Bit-exact rewrites that shorten the chain
// further: sincosf in place of sinf and cosf of one angle (equal bit for bit
// to both on every float32, checked on the H100), x * 0.5f for x / 2.0f
// (exact), NaN-propagating max.NaN / min.NaN in the clamps (one instruction
// each, equal to the isnan test with fminf / fmaxf on every number), and
// selects for the branches of the quaternion update and the ground clamp.
//
// Division, root and trigonometry without the library's checks. The
// library's `a / b` and `sqrtf` check their operands and send a zero
// numerator or radicand, or one below about 2^-100, to a long subroutine (a
// zero numerator: 282 clocks against 73 on a dependent chain); the hover and
// compass commands meet those every step. sincosf reduces its argument by pi
// / 2 and branches on its size; atan2f branches on two zeros and on two
// infinities, and divides and takes a reciprocal with the checked sequences.
// Each check holds the next dependent instruction until it resolves. So each
// control step runs first as a fast step (FastMath): the library's own inline
// sequences without their checks, exact on their fast classes, zeros
// included (csrc/rn_math.cuh): div_rn, sqrt_rn; sincos_small_rn for the
// substep's angle |w| pyb_dt / 2, the polynomials alone where the reduction
// is the identity (|x| <= pi / 4; 41 clocks against sincosf's 120); sincos_rn
// for yaw, the reduction without the large-argument branch (|x| < 105615);
// atan2_rn with div_rn inside and no branch in front (116 clocks against
// 251). A guard of running minima and maxima (an angle's magnitude: at most
// 0.78125 for the small angle, below 105615 for yaw) notes any operand outside
// those classes, and a warp in which one did recomputes the step from its
// saved state with the library's routines (LibraryMath), to the same bits.
// No operand of the benchmark's commands leaves the classes. asinf keeps the
// library's: its path has no check.
//
// Math. IEEE atan2f, asinf, sincosf, sqrtf and true division. Build without
// --use_fast_math (no __sinf, no approximate division) and with -fmad=false,
// so every add and multiply rounds separately, as in the plain PyTorch
// version: the closed loop amplifies every extra rounding difference (one
// built with FMA contraction is 0.1 rpm off at T = 8 and 3,400 rpm at T = 240).
// The plain version divides by host constants as true divisions too (`_div`
// in ops/velocity_soa.py). With the same libdevice transcendentals on both
// sides, K1 and the plain version agree bit for bit on the card. Clamps
// propagate NaN like torch.clamp, so a diverged env stays visibly non-finite.
// Every literal is a float (0.5f): a bare 0.5 would promote the expression to
// double.
//
// Layout. `in` is (30, E) float32: the 26 state rows in SOA_KEYS order, then
// the action rows ax, ay, az, amag. `out` is (26, E). Lane e reads
// in[k * E + e] and writes out[k * E + e]. Lanes past the ragged edge compute
// on the last env and store nothing, so that every lane of a warp takes part
// in the guard's vote.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError().
//
// Sources. This file is the library the cells load: the kernel with FastMath
// and its one entry point `velocity_rollout`; it holds no counter and no
// atomic. The state, the step, the time loop, the guard and the library
// recompute are in csrc/velocity_rollout.cuh, shared with K1's counting build
// (csrc/velocity_rollout_counts.cu), a library of its own that only tests and
// scripts build and load.

#include "velocity_rollout.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
velocity_rollout_kernel(const float* __restrict__ in, float* __restrict__ out, long long E,
                        VelConsts c, int n_substeps, int num_steps) {
  FastMath fast{step_guard(c)};
  rollout_lane(in, out, E, c, n_substeps, num_steps, fast);
}

}  // namespace

// K1: out (26, E) = `num_steps` control steps from in (30, E).
extern "C" int velocity_rollout(const void* in, void* out, long long E, const void* consts,
                                int n_consts, int n_substeps, int num_steps, void* stream) {
  if (!launch_args_ok(E, n_consts, n_substeps, num_steps)) return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  VelConsts c;
  memcpy(&c, consts, sizeof(VelConsts));
  const long long blocks = (E + kBlock - 1) / kBlock;
  velocity_rollout_kernel<<<(unsigned int)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, E, c, n_substeps, num_steps);
  return (int)cudaGetLastError();
}
