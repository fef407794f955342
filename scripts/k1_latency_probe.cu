// The latency of the operations on kernel K1's dependent chain
// (gym_pybullet_drones_tpu_torch/csrc/velocity_rollout.cu), in clocks: one
// warp runs a chain of 4096 dependent operations of each kind, timed with
// clock64(), and prints the clocks per operation (the chain's glue, one add
// or multiply, included where an operation needs one to stay dependent and
// in range). Built as K1 is: -fmad=false, no fast math.
//
// Then K1's stages (csrc/velocity_rollout.cuh) as links of a chain, in
// clocks per stage, on one lane against spread over a group of four lanes as
// K1 once laid an env (`over_lanes`). The glue, the adds that form the
// operands and join the results (three dependent adds in the four-division
// pair, two in the one-division pair, one in the arc tangent pair), is the
// same in the two forms of each pair, so their difference is the stage's:
//   four div_rn by one divisor, on one lane against over four lanes (a
//   select tree, one div_rn, four shuffles); one div_rn without and with the
//   shuffle behind it; two atan2_rn on one lane against one a lane and a
//   shuffle.
// Build and run on a machine with an sm_90 card and the CUDA toolkit:
//
//   nvcc -O3 -fmad=false -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//       -o k1_latency_probe scripts/k1_latency_probe.cu && ./k1_latency_probe
#include <cstdio>
#include <cuda_runtime.h>

#include "../gym_pybullet_drones_tpu_torch/csrc/velocity_rollout.cuh"

constexpr int kChain = 4096;
constexpr int kOps = 15;

// y[i] = f(a[i], b[i]) for a stage of K <= 4 operations over the four lanes
// of a group: lane j picks operand j (the last past K) with a tree of selects
// on the bits of j and evaluates it, and a shuffle brings each result to
// every lane of the group.
template <int K, class F>
__device__ __forceinline__ void over_lanes(F f, int j, const float (&a)[K], const float (&b)[K],
                                           float (&y)[K]) {
  float va[4], vb[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) va[m] = a[m < K ? m : K - 1], vb[m] = b[m < K ? m : K - 1];
#pragma unroll
  for (int w = 2; w >= 1; w /= 2) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m < w) va[m] = (j & w) ? va[m + w] : va[m], vb[m] = (j & w) ? vb[m + w] : vb[m];
    }
  }
  const float part = f(va[0], vb[0]);
#pragma unroll
  for (int i = 0; i < K; ++i) y[i] = __shfl_sync(kAll, part, i, 4);
}

__global__ void probe(float seed, long long* clocks, float* sink) {
  const int lane = threadIdx.x;
  float x = seed + lane * 1e-7f;
  long long t0, t1;
  int op = 0;
  const int j = lane & 3;
  const auto div = [](float a, float b) { return div_rn(a, b); };
  const auto arctan = [](float y, float x) { return atan2_rn(y, x); };
#define CHAIN(...)                                   \
  t0 = clock64();                                    \
  for (int i = 0; i < kChain; ++i) { __VA_ARGS__; }  \
  t1 = clock64();                                    \
  if (lane == 0) clocks[op] = t1 - t0;               \
  ++op;
  CHAIN(x = x + 1e-7f)                                    // FADD
  CHAIN(x = x * 1.0000001f)                               // FMUL
  CHAIN(x = 1.0001f / x)                                  // IEEE division
  CHAIN(x = sqrtf(x) + 0.5f)                              // IEEE sqrtf (+ add)
  CHAIN(float s; float c; sincosf(x, &s, &c); x = s + c)  // sincosf (+ add)
  CHAIN(x = sinf(x) + 0.5f)                               // sinf (+ add)
  CHAIN(x = atan2f(x, 1.3f) + 0.5f)                       // atan2f (+ add)
  CHAIN(x = asinf(x * 0.5f))                              // asinf (+ multiply)
  CHAIN(x = __shfl_sync(kAll, x, (lane + 1) & 3, 4))      // SHFL within 4 lanes
  x = x + 0.7f;  // asinf's chain ends near 0; the add keeps it live
  // Four divisions by one divisor, x -> 4 x / (x + 2) about: one lane, then
  // over the group.
  CHAIN(const float d = x + 2.0f;
        const float q0 = div_rn(x, d), q1 = div_rn(x + 0.25f, d);
        const float q2 = div_rn(x + 0.5f, d), q3 = div_rn(x + 0.75f, d);
        x = (q0 + q1) + (q2 + q3))
  CHAIN(const float d = x + 2.0f; float q[4];
        over_lanes<4>(div, j, {x, x + 0.25f, x + 0.5f, x + 0.75f}, {d, d, d, d}, q);
        x = (q[0] + q[1]) + (q[2] + q[3]))
  // One division, without and with a shuffle from the group's first lane.
  CHAIN(x = div_rn(x, x + 2.0f) + 1.0f)
  CHAIN(x = __shfl_sync(kAll, div_rn(x, x + 2.0f), 0, 4) + 1.0f)
  // The roll and yaw pair: two atan2_rn on one lane, then over the group.
  CHAIN(x = atan2_rn(x, 1.3f) + atan2_rn(0.7f, x))
  CHAIN(float r[2]; over_lanes<2>(arctan, j, {x, 0.7f}, {1.3f, x}, r); x = r[0] + r[1])
#undef CHAIN
  sink[lane] = x;
}

int main() {
  long long* d;
  float* sink;
  cudaMalloc(&d, kOps * sizeof(long long));
  cudaMalloc(&sink, 32 * sizeof(float));
  probe<<<1, 32>>>(0.7f, d, sink);  // warm-up
  probe<<<1, 32>>>(0.7f, d, sink);
  long long h[kOps] = {};
  cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost);
  const char* names[kOps] = {
      "fadd", "fmul", "div", "sqrtf+add", "sincosf+add", "sinf+add", "atan2f+add", "asinf+mul",
      "shfl width 4", "4 div_rn one lane+glue", "4 div_rn over 4 lanes+glue",
      "div_rn+glue", "div_rn+shfl+glue", "2 atan2_rn one lane+add", "2 atan2_rn over lanes+add"};
  printf("k1_latency_probe (%s): clocks per dependent link:", cudaGetErrorString(
      cudaGetLastError()));
  for (int i = 0; i < kOps; ++i) printf(" %s %.2f;", names[i], (double)h[i] / kChain);
  printf("\n");
  return 0;
}
