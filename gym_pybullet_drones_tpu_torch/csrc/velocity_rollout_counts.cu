// K1's counting build: the step of K1 (csrc/velocity_rollout.cuh), with a
// fast arithmetic that also counts the operands it meets. For tests and
// scripts (ops/velocity_rollout.velocity_rollout_counts), in a library of its
// own: the cells' library (csrc/velocity_rollout.cu) holds no counter. Built
// with K1's flags (-fmad=false), so its result is K1's bit for bit.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError().

#include "velocity_rollout.cuh"

namespace {

// The counts, in the order of the counts buffer (ops/velocity_rollout.RN_COUNTS):
// zero numerators, zero radicands and zero atan2 arguments that the fast step
// takes inline, sines and cosines it takes without the reduction, operations
// outside the fast classes, and env-steps recomputed with the library.
enum { kZeroNum, kZeroRad, kZeroAtan2, kSmallAngle, kFallback, kReplayed, kNumCounts };

// FastMath that counts each operation of its lane's env. A recomputed step's
// operations are counted as the fast step met them.
struct CountingMath : FastMath {
  unsigned long long n[kNumCounts] = {};
  __device__ __forceinline__ float div(float a, float b) {
    n[kZeroNum] += a == 0.0f;
    n[kFallback] += !rn_div_fast(a, b);
    return FastMath::div(a, b);
  }
  __device__ __forceinline__ float root(float x) {
    n[kZeroRad] += x == 0.0f;
    n[kFallback] += !rn_sqrt_fast(x);
    return FastMath::root(x);
  }
  __device__ __forceinline__ float arctan(float y, float x) {
    n[kZeroAtan2] += y == 0.0f && x > 0.0f;
    n[kFallback] += !rn_atan2_fast(y, x);
    return FastMath::arctan(y, x);
  }
  __device__ __forceinline__ void sincos_small(float x, float* s, float* c) {
    n[kSmallAngle] += rn_small_angle(x);
    n[kFallback] += !rn_small_angle(x);
    FastMath::sincos_small(x, s, c);
  }
  __device__ __forceinline__ void sincos(float x, float* s, float* c) {
    n[kFallback] += !rn_reduced_angle(x);
    FastMath::sincos(x, s, c);
  }
};

__global__ void __launch_bounds__(kBlock)
velocity_rollout_counted_kernel(const float* __restrict__ in, float* __restrict__ out,
                                long long E, VelConsts c, int n_substeps, int num_steps,
                                unsigned long long* __restrict__ counts) {
  CountingMath fast{{step_guard(c)}};
  fast.n[kReplayed] = rollout_lane(in, out, E, c, n_substeps, num_steps, fast);
  // Lanes past the ragged edge repeat the last env: they count nothing.
  if ((long long)blockIdx.x * blockDim.x + threadIdx.x >= E) return;
#pragma unroll
  for (int k = 0; k < kNumCounts; ++k) {
    if (fast.n[k]) atomicAdd(&counts[k], fast.n[k]);
  }
}

}  // namespace

// K1's counting build: out as K1's, and counts (kNumCounts uint64, zeroed by
// the caller) gains the counts of every env and step; a recomputed env-step counts once for each env of its warp of 32 envs.
extern "C" int velocity_rollout_counted(const void* in, void* out, long long E,
                                        const void* consts, int n_consts, int n_substeps,
                                        int num_steps, void* counts, void* stream) {
  if (!launch_args_ok(E, n_consts, n_substeps, num_steps)) return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  VelConsts c;
  memcpy(&c, consts, sizeof(VelConsts));
  const long long blocks = (E + kBlock - 1) / kBlock;
  velocity_rollout_counted_kernel<<<(unsigned int)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, E, c, n_substeps, num_steps, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
