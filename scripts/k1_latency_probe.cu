// The latency of the operations on kernel K1's dependent chain
// (gym_pybullet_drones_tpu_torch/csrc/velocity_rollout.cu), in clocks: one
// warp runs a chain of 4096 dependent operations of each kind, timed with
// clock64(), and prints the clocks per operation (the chain's glue, one add
// or multiply, included where an operation needs one to stay dependent and
// in range). Built as K1 is: -fmad=false, no fast math. Build and run on a
// machine with an sm_90 card and the CUDA toolkit:
//
//   nvcc -O3 -fmad=false -gencode arch=compute_90a,code=sm_90a \
//       -o k1_latency_probe scripts/k1_latency_probe.cu && ./k1_latency_probe
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kChain = 4096;
constexpr int kOps = 9;
constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void probe(float seed, long long* clocks, float* sink) {
  const int lane = threadIdx.x;
  float x = seed + lane * 1e-7f;
  long long t0, t1;
  int op = 0;
#define CHAIN(expr)                                  \
  t0 = clock64();                                    \
  for (int i = 0; i < kChain; ++i) { expr; }         \
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
  long long h[kOps];
  cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost);
  const char* names[kOps] = {"fadd", "fmul", "div", "sqrtf+add", "sincosf+add", "sinf+add",
                             "atan2f+add", "asinf+mul", "shfl width 4"};
  printf("k1_latency_probe (%s): clocks per dependent operation:", cudaGetErrorString(
      cudaGetLastError()));
  for (int i = 0; i < kOps; ++i) printf(" %s %.2f;", names[i], (double)h[i] / kChain);
  printf("\n");
  return 0;
}
