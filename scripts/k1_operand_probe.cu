// Which operands send the CUDA library's IEEE division and square root (and
// atan2f) to their slow subroutines, and what the fast step of kernel K1
// (div_rn, sqrt_rn, atan2_rn, sincos_small_rn, sincos_rn in
// gym_pybullet_drones_tpu_torch/csrc/rn_math.cuh) costs on each class. One
// warp a block runs a chain of dependent operations on one operand class and
// times it with clock64(); each step feeds the next through a select that
// never fires, so the operand's class stays fixed.
//
//  1. Classes: clocks per operation of `a / b`, div_rn, `sqrtf`, sqrt_rn,
//     atan2f, atan2_rn, asinf and sincosf on a normal operand, a zero, a
//     subnormal, a small normal (2^-110) and, for the division, a subnormal
//     quotient and a zero divisor (div_rn is exact only on its fast class;
//     its times show that it has no slow path). Then the trigonometry at the
//     magnitudes of K1's operands: sincosf against sincos_small_rn at the
//     substep's angles (0, 1e-12, 1e-3, 0.1), sincosf against sincos_rn at
//     yaw's (0, +-pi/2, +-3), atan2f against atan2_rn on (y, x) pairs whose
//     angle is about 0, 1e-12, 1e-3, 0.1, +-pi/2 and +-3, and asinf at the
//     substep's angles (its root has no check: there is no asin_rn).
//  2. Scans: clocks per `a / b` for a = 1.5 2^ea, ea = -149 ... 127, and a =
//     0, over b = 1.25 2^eb, eb = -149 ... 127 (FCHK's class: printed as the
//     ranges of ea that run slow for each eb); per `sqrtf` and sqrt_rn for x =
//     1.5 2^e and the specials; per atan2f(y, 0.98) for y = 1.5 2^e. With an
//     output directory, written there as float32: scan_div_lib.f32 (278 x 277,
//     a's row first), scan_sqrt_lib.f32, scan_sqrt_rn.f32 (282 each) and
//     scan_atan2_lib.f32 (278).
//
// Built as K1 is: -fmad=false, no fast math. Build and run on a machine with
// an sm_90 card and the CUDA toolkit:
//
//   nvcc -O3 -fmad=false -gencode arch=compute_90a,code=sm_90a \
//       -o k1_operand_probe scripts/k1_operand_probe.cu && ./k1_operand_probe [OUT_DIR]
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <string>
#include <vector>
#include <cuda_runtime.h>

#include "../gym_pybullet_drones_tpu_torch/csrc/rn_math.cuh"

constexpr int kChain = 32;
constexpr unsigned kNever = 0x7fc0deadu;  // a NaN no operation here returns

// x: the next operand, equal to v but dependent on y.
__device__ __forceinline__ float feed(float y, float v) {
  return __float_as_uint(y) == kNever ? y : v;
}

enum Op {
  kDivLib, kDivRn, kSqrtLib, kSqrtRn, kAtan2, kAsin, kSincos, kFeed, kAtan2Rn, kSincosSmall,
  kSincosRn, kNumOps
};

__device__ __forceinline__ float apply(int op, float x, float b) {
  switch (op) {
    case kDivLib: return x / b;
    case kDivRn: return div_rn(x, b);
    case kSqrtLib: return sqrtf(x);
    case kSqrtRn: return sqrt_rn(x);
    case kAtan2: return atan2f(x, b);
    case kAtan2Rn: return atan2_rn(x, b);
    case kAsin: return asinf(x);
    case kSincos: {
      float s, c;
      sincosf(x, &s, &c);
      return s + c;
    }
    case kSincosSmall: {
      float s, c;
      sincos_small_rn(x, &s, &c);
      return s + c;
    }
    case kSincosRn: {
      float s, c;
      sincos_rn(x, &s, &c);
      return s + c;
    }
    default: return x;
  }
}

// Clocks per operation of a chain of kChain, the operation fixed at compile
// time so that the chain holds nothing else.
template <int OP>
__device__ float chain(float a, float b) {
  float x = a;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) x = feed(apply(OP, x, b), a);  // warm the code
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < kChain; ++i) x = feed(apply(OP, x, b), a);
  const long long t1 = clock64();
  if (__float_as_uint(x) == kNever) printf("never\n");
  return (float)(t1 - t0) / kChain;
}

__device__ float chain_of(int op, float a, float b) {
  switch (op) {
    case kDivLib: return chain<kDivLib>(a, b);
    case kDivRn: return chain<kDivRn>(a, b);
    case kSqrtLib: return chain<kSqrtLib>(a, b);
    case kSqrtRn: return chain<kSqrtRn>(a, b);
    case kAtan2: return chain<kAtan2>(a, b);
    case kAsin: return chain<kAsin>(a, b);
    case kSincos: return chain<kSincos>(a, b);
    case kAtan2Rn: return chain<kAtan2Rn>(a, b);
    case kSincosSmall: return chain<kSincosSmall>(a, b);
    case kSincosRn: return chain<kSincosRn>(a, b);
    default: return chain<kFeed>(a, b);
  }
}

struct Case {
  int op;
  float a, b;
};

__global__ void classes(const Case* cases, int n, float* clocks) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const float c = chain_of(cases[i].op, cases[i].a, cases[i].b);
    if (threadIdx.x == 0) clocks[i] = c;
  }
}

// One chain for each (a, b) of the grid, one warp at a time on each SM.
__global__ void scan(int op, const float* as, int na, const float* bs, int nb, float* clocks) {
  for (int i = blockIdx.x; i < na * nb; i += gridDim.x) {
    const float c = chain_of(op, as[i / nb], bs[i % nb]);
    if (threadIdx.x == 0) clocks[i] = c;
  }
}

static float p2(double m, int e) { return (float)std::ldexp(m, e); }

static std::vector<float> run(int op, const std::vector<float>& as, const std::vector<float>& bs) {
  float *da, *db, *dc;
  const size_t n = as.size() * bs.size();
  cudaMalloc(&da, as.size() * 4);
  cudaMalloc(&db, bs.size() * 4);
  cudaMalloc(&dc, n * 4);
  cudaMemcpy(da, as.data(), as.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, bs.data(), bs.size() * 4, cudaMemcpyHostToDevice);
  scan<<<132, 32>>>(op, da, (int)as.size(), db, (int)bs.size(), dc);
  std::vector<float> out(n);
  cudaMemcpy(out.data(), dc, n * 4, cudaMemcpyDeviceToHost);
  cudaFree(da);
  cudaFree(db);
  cudaFree(dc);
  return out;
}

static void save(const char* dir, const char* name, const std::vector<float>& v) {
  if (!dir) return;
  const std::string path = std::string(dir) + "/" + name;
  FILE* f = fopen(path.c_str(), "wb");
  if (!f) return;
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

int main(int argc, char** argv) {
  const char* dir = argc > 1 ? argv[1] : nullptr;
  const char* names[kNumOps] = {"a / b", "div_rn", "sqrtf", "sqrt_rn", "atan2f(y, x)",
                                "asinf", "sincosf", "feed alone", "atan2_rn(y, x)",
                                "sincos_small_rn", "sincos_rn"};
  // 1. Classes.
  const float dt = 1.0f / 48.0f, m = 0.027f;
  std::vector<Case> cases;
  std::vector<std::string> labels;
  auto add = [&](int op, float a, float b, const char* what) {
    cases.push_back({op, a, b});
    labels.push_back(std::string(names[op]) + ", " + what);
  };
  add(kFeed, 1.3f, 0.7f, "-");
  for (int op : {kDivLib, kDivRn}) {
    add(op, 1.3f, 0.7f, "normal 1.3 / 0.7");
    add(op, 1.3f, dt, "normal 1.3 / ctrl_dt");
    add(op, 0.0f, 0.7f, "zero numerator 0 / 0.7");
    add(op, -0.0f, m, "zero numerator -0 / m");
    add(op, p2(1.5, -140), 0.7f, "subnormal numerator 1.5 2^-140 / 0.7");
    add(op, p2(1.5, -110), 0.7f, "small normal numerator 1.5 2^-110 / 0.7");
    add(op, p2(1.5, -100), 0.7f, "numerator 1.5 2^-100 / 0.7");
    add(op, p2(1.5, -56), dt, "numerator 1.5 2^-56 / ctrl_dt");
    add(op, p2(1.5, -120), p2(1.0, 10), "subnormal quotient 1.5 2^-120 / 2^10");
    add(op, 1.3f, 0.0f, "zero divisor 1.3 / 0");
  }
  for (int op : {kSqrtLib, kSqrtRn}) {
    add(op, 1.3f, 0.0f, "normal 1.3");
    add(op, 0.0f, 0.0f, "zero");
    add(op, p2(1.5, -140), 0.0f, "subnormal 1.5 2^-140");
    add(op, p2(1.5, -110), 0.0f, "small normal 1.5 2^-110");
    add(op, p2(1.5, -100), 0.0f, "1.5 2^-100");
  }
  for (int op : {kAtan2, kAtan2Rn, kAsin, kSincos}) {
    const float b = op == kAtan2 || op == kAtan2Rn ? 0.98f : 0.0f;
    add(op, 0.3f, b, "normal 0.3");
    add(op, 0.0f, b, "zero");
    add(op, p2(1.0, -56), b, "2^-56");
    add(op, p2(1.5, -110), b, "1.5 2^-110");
    add(op, p2(1.5, -140), b, "subnormal 1.5 2^-140");
  }
  // K1's magnitudes: the substep's angle theta, yaw, the atan2 pairs of roll
  // and yaw (x near 1: a level drone), pitch.
  const char* small_names[] = {"0", "1e-12", "1e-3", "0.1"};
  const float smalls[] = {0.0f, 1e-12f, 1e-3f, 0.1f};
  for (int op : {kSincos, kSincosSmall, kAsin}) {
    for (int k = 0; k < 4; ++k) {
      add(op, smalls[k], 0.0f, (std::string("K1 theta ") + small_names[k]).c_str());
    }
  }
  const char* yaw_names[] = {"0", "pi/2", "-pi/2", "3", "-3"};
  const float yaws[] = {0.0f, 1.5707964f, -1.5707964f, 3.0f, -3.0f};
  for (int op : {kSincos, kSincosRn}) {
    for (int k = 0; k < 5; ++k) {
      add(op, yaws[k], 0.0f, (std::string("K1 yaw ") + yaw_names[k]).c_str());
    }
  }
  const char* pair_names[] = {"(0, 1): 0", "(1e-12, 1): 1e-12", "(1e-3, 1): 1e-3",
                              "(0.1, 1): 0.1", "(1, 1e-3): pi/2", "(-1, 1e-3): -pi/2",
                              "(0.14, -0.99): 3", "(-0.14, -0.99): -3"};
  const float pair_y[] = {0.0f, 1e-12f, 1e-3f, 0.1f, 1.0f, -1.0f, 0.14f, -0.14f};
  const float pair_x[] = {1.0f, 1.0f, 1.0f, 1.0f, 1e-3f, 1e-3f, -0.99f, -0.99f};
  for (int op : {kAtan2, kAtan2Rn}) {
    for (int k = 0; k < 8; ++k) {
      add(op, pair_y[k], pair_x[k], (std::string("K1 ") + pair_names[k]).c_str());
    }
  }
  Case* dcases;
  float* dclk;
  cudaMalloc(&dcases, cases.size() * sizeof(Case));
  cudaMalloc(&dclk, cases.size() * 4);
  cudaMemcpy(dcases, cases.data(), cases.size() * sizeof(Case), cudaMemcpyHostToDevice);
  classes<<<1, 32>>>(dcases, (int)cases.size(), dclk);  // one warp on the card
  std::vector<float> clk(cases.size());
  cudaMemcpy(clk.data(), dclk, clk.size() * 4, cudaMemcpyDeviceToHost);
  printf("k1_operand_probe (%s): clocks per dependent operation, the feed's select "
         "included\n", cudaGetErrorString(cudaGetLastError()));
  for (size_t i = 0; i < cases.size(); ++i) printf("  %-60s %8.2f\n", labels[i].c_str(), clk[i]);

  // 2. Scans.
  std::vector<float> as, bs, xs;
  for (int e = -149; e <= 127; ++e) {
    as.push_back(p2(1.5, e));
    bs.push_back(p2(1.25, e));
    xs.push_back(p2(1.5, e));
  }
  as.push_back(0.0f);
  for (float v : {0.0f, -0.0f, -1.0f, INFINITY, NAN}) xs.push_back(v);
  const std::vector<float> one = {0.0f};
  for (int op : {kDivLib}) {
    const std::vector<float> c = run(op, as, bs);
    save(dir, "scan_div_lib.f32", c);
    std::vector<float> sorted(c);
    std::nth_element(sorted.begin(), sorted.begin() + sorted.size() / 4, sorted.end());
    const float base = sorted[sorted.size() / 4];
    printf("scan %s: base %.2f clocks (first quartile); slow (> 1.5x base) numerator "
           "exponents ea by divisor exponent eb:\n", names[op], base);
    std::string last;
    int from = -149;
    for (size_t j = 0; j <= bs.size(); ++j) {
      std::string row;
      if (j < bs.size()) {
        int start = 0;
        bool in = false;
        for (size_t i = 0; i + 1 < as.size(); ++i) {  // the last row is a = 0
          const bool slow = c[i * bs.size() + j] > 1.5f * base;
          if (slow && !in) start = -149 + (int)i;
          if (!slow && in) row += " [" + std::to_string(start) + ", " + std::to_string(-149 + (int)i - 1) + "]";
          in = slow;
        }
        if (in) row += " [" + std::to_string(start) + ", 127]";
        if (c[(as.size() - 1) * bs.size() + j] > 1.5f * base) row += " zero";
      }
      if (j == bs.size() || (j > 0 && row != last)) {
        printf("  eb %d..%d:%s\n", from, -149 + (int)j - 1, last.empty() ? " none" : last.c_str());
        from = -149 + (int)j;
      }
      last = row;
    }
  }
  for (int op : {kSqrtLib, kSqrtRn}) {
    const std::vector<float> c = run(op, xs, one);
    save(dir, op == kSqrtLib ? "scan_sqrt_lib.f32" : "scan_sqrt_rn.f32", c);
    printf("scan %s: clocks at e = -149, -127, -102, -101, -100, 0, 127; 0, -0, -1, inf, nan:",
           names[op]);
    for (int e : {-149, -127, -102, -101, -100, 0, 127}) printf(" %.1f", c[e + 149]);
    for (int k = 0; k < 5; ++k) printf(" %.1f", c[277 + k]);
    printf("\n");
  }
  {
    const std::vector<float> x1 = {0.98f};
    std::vector<float> ys(xs.begin(), xs.begin() + 277);
    ys.push_back(0.0f);
    const std::vector<float> c = run(kAtan2, ys, x1);
    save(dir, "scan_atan2_lib.f32", c);
    printf("scan atan2f(y, 0.98): clocks at e = -149, -127, -110, -103, -102, -101, -90, -60, 0, "
           "100; 0:");
    for (int e : {-149, -127, -110, -103, -102, -101, -90, -60, 0, 100}) printf(" %.1f", c[e + 149]);
    printf(" %.1f\n", c[277]);
  }
  printf("done: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
