// K7: the onboard camera, every camera of every env in one launch.
//
// Replaces no Pallas kernel: the JAX package's camera
// (gym_pybullet_drones_tpu/render/camera.py:177, render_drone_views) is one
// XLA program that builds (C, H, W, N, T, 3) ray-triangle intermediates and
// min-reduces them over T, and XLA fuses the reduce into the build. Eager
// PyTorch would write each intermediate out (24 GB for the teddy landmark at
// 4096 cameras), so the port computes the function here: what
// render_drone_views_plain (render/camera.py) computes, for B worlds of N
// drones and C cameras each.
//
// Bound. A pixel reads nothing from device memory but the scene, which every
// block stages once, and writes 12 bytes (rgba 4, depth 4, segment 4). Its
// work is its ray against the plane, the scene drones (68 triangles each
// with the mesh proxy; two slab tests and a sphere with the X-frame) and the
// landmarks (232 triangles and two slab tests in the "rl" scene), about
// 35 operations a triangle: some 10^4 operations a pixel against 12 bytes,
// so it is bound by operations.
//
// Design (a simple kernel that is right first). One thread per (camera,
// pixel); a block holds 128 pixels of one camera's rows. Shared memory holds
// the cf2 mesh scaled by the world's arm, the landmark triangles (world
// space) and objects, and the world's drones (position, rotation R, and the
// X-frame basis U = R Rz) when there are at most kSharedDrones of them; more
// drones are read from device memory and their frames recomputed in the loop.
// The thread walks the scene in the plain version's order, plane, drones,
// landmarks, and keeps its best hit in registers: a hit replaces the best
// only when strictly nearer, which is the plain version's where(t < best)
// in scene order and its first-index argmin over drones, triangles and slab
// axes. Drone hits are computed in the drone's body frame (oc_b = R^T (o -
// pos), dd_b = R^T d), landmark meshes in the world frame, as the plain
// version does.
//
// Math. Every add and multiply rounds on its own (-fmad=false), divisions
// and square roots are IEEE, and each sum runs in the plain version's order,
// so the kernel follows the plain version's rounding. The checker is
// (floor(x) + floor(y)) mod 2 with Python's sign rule; uint8 truncates
// toward zero. Every literal is a float.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTri = 12;        // floats a triangle: v0, e1, e2, unit normal
constexpr int kObj = 16;        // floats a landmark object (ops/render_views.py)
constexpr int kMaxCf2 = 68;
constexpr int kMaxLandTris = 256;
constexpr int kMaxObjs = 8;
constexpr int kSharedDrones = 32;
constexpr int kDrone = 21;      // floats a drone: pos, R, U

enum { kBox = 0, kSphere = 1, kMesh = 2 };

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// Möller-Trumbore, two-sided (render/meshes.ray_tris); inf on a miss.
__device__ __forceinline__ float ray_tri(const float* o, const float* d, const float* tri) {
  const float* v0 = tri;
  const float* e1 = tri + 3;
  const float* e2 = tri + 6;
  const float h[3] = {d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                      d[0] * e2[1] - d[1] * e2[0]};
  const float a = dot3(e1, h);
  const bool live = fabsf(a) > 1e-9f;
  const float f = 1.0f / (live ? a : 1e-9f);
  const float s[3] = {o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]};
  const float u = f * dot3(s, h);
  const float q[3] = {s[1] * e1[2] - s[2] * e1[1], s[2] * e1[0] - s[0] * e1[2],
                      s[0] * e1[1] - s[1] * e1[0]};
  const float v = f * dot3(d, q);
  const float t = f * dot3(e2, q);
  const bool hit = live && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-4f;
  return hit ? t : INFINITY;
}

// Slab test against a box centred at the origin (camera._ray_aabb): the entry
// distance (inf on a miss) and the entry face's axis, the first on ties.
__device__ __forceinline__ float ray_aabb(const float* oc, const float* dd, const float* half,
                                          int* axis) {
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / (fabsf(dd[k]) > 1e-9f ? dd[k] : 1e-9f);
    const float t1 = (-half[k] - oc[k]) * inv;
    const float t2 = (half[k] - oc[k]) * inv;
    lo[k] = fminf(t1, t2);
    hi[k] = fmaxf(t1, t2);
  }
  int ax = 0;
  float tmin = lo[0];
  if (lo[1] > tmin) { tmin = lo[1]; ax = 1; }
  if (lo[2] > tmin) { tmin = lo[2]; ax = 2; }
  const float tmax = fminf(fminf(hi[0], hi[1]), hi[2]);
  *axis = ax;
  return (tmax >= tmin && tmin > 1e-4f) ? tmin : INFINITY;
}

// camera._ray_sphere with the squared radius r2.
__device__ __forceinline__ float ray_sphere(const float* o, const float* d, const float* c,
                                            float r2) {
  const float oc[3] = {o[0] - c[0], o[1] - c[1], o[2] - c[2]};
  const float b = dot3(d, oc);
  const float cc = dot3(oc, oc) - r2;
  const float disc = b * b - cc;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  const float t = t0 > 1e-4f ? t0 : t1;
  return (disc > 0.0f && t > 1e-4f) ? t : INFINITY;
}

// core/rotations.quat_to_matrix, row major.
__device__ __forceinline__ void quat_to_matrix(const float* q, float* R) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

// A drone's record: position, R and the X-frame basis U = R Rz(angle).
__device__ __forceinline__ void drone_record(const float* pos, const float* quat, float ca,
                                             float sa, float* rec) {
  rec[0] = pos[0];
  rec[1] = pos[1];
  rec[2] = pos[2];
  float* R = rec + 3;
  quat_to_matrix(quat, R);
  const float rz[9] = {ca, -sa, 0.0f, sa, ca, 0.0f, 0.0f, 0.0f, 1.0f};
  float* U = rec + 12;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      U[3 * i + k] = (R[3 * i] * rz[k] + R[3 * i + 1] * rz[3 + k]) + R[3 * i + 2] * rz[6 + k];
    }
  }
}

// M^T v for a row-major 3x3 M.
__device__ __forceinline__ void mt_apply(const float* M, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = (M[i] * v[0] + M[3 + i] * v[1]) + M[6 + i] * v[2];
  }
}

struct Scene {
  int B, N, C, H, W, n_cf2, n_obj, n_tri, use_mesh;
  float tan_half, aspect, far_, inv_far, ca, sa;
};

__global__ void __launch_bounds__(kBlock)
render_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
              const float* __restrict__ arm, const int* __restrict__ cam,
              const float* __restrict__ cf2, const float* __restrict__ objs,
              const float* __restrict__ tris, Scene sc, uint8_t* __restrict__ rgba,
              float* __restrict__ dep, int* __restrict__ seg) {
  __shared__ float s_cf2[kMaxCf2 * kTri];
  __shared__ float s_tri[kMaxLandTris * kTri];
  __shared__ float s_obj[kMaxObjs * kObj];
  __shared__ float s_drone[kSharedDrones * kDrone];

  const int P = sc.H * sc.W;
  const int blocks_per_cam = (P + kBlock - 1) / kBlock;
  const long long view = blockIdx.x / blocks_per_cam;  // b * C + c
  const int pix = (int)(blockIdx.x % blocks_per_cam) * kBlock + threadIdx.x;
  const int b = (int)(view / sc.C);
  const int c = (int)(view % sc.C);
  const float L = arm[b];
  const float* wpos = pos + (long long)b * sc.N * 3;
  const float* wquat = quat + (long long)b * sc.N * 4;
  const bool shared_drones = sc.N <= kSharedDrones;

  // Stage the scene: the cf2 mesh scaled by this world's arm (normals as
  // they are), the landmarks, and the world's drones.
  for (int i = threadIdx.x; i < sc.n_cf2 * kTri; i += kBlock) {
    s_cf2[i] = (i % kTri) < 9 ? cf2[i] * L : cf2[i];
  }
  for (int i = threadIdx.x; i < sc.n_tri * kTri; i += kBlock) s_tri[i] = tris[i];
  for (int i = threadIdx.x; i < sc.n_obj * kObj; i += kBlock) s_obj[i] = objs[i];
  if (shared_drones) {
    for (int j = threadIdx.x; j < sc.N; j += kBlock) {
      drone_record(wpos + 3 * j, wquat + 4 * j, sc.ca, sc.sa, s_drone + kDrone * j);
    }
  }
  __syncthreads();
  if (pix >= P) return;

  // The camera: eye at pos + (0, 0, L), looking along body +x.
  const int me = cam[c];
  float own[kDrone];
  drone_record(wpos + 3 * me, wquat + 4 * me, sc.ca, sc.sa, own);
  const float* R = own + 3;
  const float o[3] = {own[0], own[1], own[2] + L};
  const float fw[3] = {R[0], R[3], R[6]};
  const float fn = sqrtf(dot3(fw, fw));
  const float fwd[3] = {fw[0] / fn, fw[1] / fn, fw[2] / fn};
  // right = fwd x (0, 0, 1); cam_up = right x fwd
  float rt[3] = {fwd[1] * 1.0f - fwd[2] * 0.0f, fwd[2] * 0.0f - fwd[0] * 1.0f,
                 fwd[0] * 0.0f - fwd[1] * 0.0f};
  const float rn = fmaxf(sqrtf(dot3(rt, rt)), 1e-6f);
  const float right[3] = {rt[0] / rn, rt[1] / rn, rt[2] / rn};
  const float up[3] = {right[1] * fwd[2] - right[2] * fwd[1],
                       right[2] * fwd[0] - right[0] * fwd[2],
                       right[0] * fwd[1] - right[1] * fwd[0]};
  const int px_i = pix % sc.W, py_i = pix / sc.W;
  const float px = ((float)px_i + 0.5f) / (float)sc.W * 2.0f - 1.0f;
  const float py = 1.0f - ((float)py_i + 0.5f) / (float)sc.H * 2.0f;
  const float ax = px * sc.tan_half * sc.aspect;
  const float ay = py * sc.tan_half;
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = (fwd[k] + ax * right[k]) + ay * up[k];
  const float dn = sqrtf(dot3(d, d));
  d[0] = d[0] / dn;
  d[1] = d[1] / dn;
  d[2] = d[2] / dn;

  // Plane z = 0: a checker, id 0.
  float best_t = d[2] < -1e-6f ? -o[2] / d[2] : INFINITY;
  int best_id = -1;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (isfinite(best_t)) {
    const float hx = o[0] + d[0] * best_t;
    const float hy = o[1] + d[1] * best_t;
    float m = fmodf(floorf(hx) + floorf(hy), 2.0f);
    if (m != 0.0f && m < 0.0f) m += 2.0f;
    const bool light = m > 0.5f;
    rgb[0] = light ? 150.0f : 120.0f;
    rgb[1] = light ? 150.0f : 130.0f;
    rgb[2] = light ? 150.0f : 120.0f;
    best_id = 0;
  }

  // The other drones, ids 1..N, in the drone's body frame.
  float td = INFINITY;
  int jd = 0, kd = 0, prim_d = 0, ax_d = 0;
  const float body_r = 0.75f * L;
  const float half_a[3] = {1.6f * L, 0.3f * L, 0.2f * L};
  const float half_b[3] = {0.3f * L, 1.6f * L, 0.2f * L};
  for (int j = 0; j < sc.N; ++j) {
    if (j == me) continue;
    float rec_l[kDrone];
    const float* rec;
    if (shared_drones) {
      rec = s_drone + kDrone * j;
    } else {
      drone_record(wpos + 3 * j, wquat + 4 * j, sc.ca, sc.sa, rec_l);
      rec = rec_l;
    }
    const float ocw[3] = {o[0] - rec[0], o[1] - rec[1], o[2] - rec[2]};
    float ocb[3], ddb[3];
    if (sc.use_mesh) {
      mt_apply(rec + 3, ocw, ocb);
      mt_apply(rec + 3, d, ddb);
      float tj = INFINITY;
      int kj = 0;
      for (int k = 0; k < sc.n_cf2; ++k) {
        const float t = ray_tri(ocb, ddb, s_cf2 + kTri * k);
        if (t < tj) { tj = t; kj = k; }
      }
      if (tj < td) { td = tj; jd = j; kd = kj; }
    } else {
      mt_apply(rec + 12, ocw, ocb);
      mt_apply(rec + 12, d, ddb);
      int axa, axb;
      const float ta = ray_aabb(ocb, ddb, half_a, &axa);
      const float tb = ray_aabb(ocb, ddb, half_b, &axb);
      const float ts = ray_sphere(o, d, rec, body_r * body_r);
      float tj = ta;
      int pj = 0;
      if (tb < tj) { tj = tb; pj = 1; }
      if (ts < tj) { tj = ts; pj = 2; }
      if (tj < td) { td = tj; jd = j; prim_d = pj; ax_d = pj == 0 ? axa : axb; }
    }
  }
  if (td < best_t) {
    float rec_l[kDrone];
    const float* rec;
    if (shared_drones) {
      rec = s_drone + kDrone * jd;
    } else {
      drone_record(wpos + 3 * jd, wquat + 4 * jd, sc.ca, sc.sa, rec_l);
      rec = rec_l;
    }
    float nz;
    if (sc.use_mesh) {
      const float* n = s_cf2 + kTri * kd + 9;
      const float* Rh = rec + 3;
      nz = fabsf((Rh[6] * n[0] + Rh[7] * n[1]) + Rh[8] * n[2]);
    } else if (prim_d == 2) {
      nz = ((o[2] + d[2] * td) - rec[2]) / body_r;
    } else {
      nz = fabsf(rec[12 + 6 + ax_d]);
    }
    const float shade = fminf(fmaxf(0.35f + 0.65f * nz, 0.2f), 1.0f);
    best_t = td;
    best_id = jd + 1;
    rgb[0] = 80.0f * shade + 100.0f;
    rgb[1] = 80.0f * shade + 100.0f;
    rgb[2] = 90.0f * shade + 100.0f;
  }

  // Landmarks, ids N+1.., in scene order, world frame.
  for (int m = 0; m < sc.n_obj; ++m) {
    const float* ob = s_obj + kObj * m;
    const int kind = (int)ob[0];
    const float* cpos = ob + 1;
    float t, shade;
    if (kind == kBox) {
      const float oc[3] = {o[0] - cpos[0], o[1] - cpos[1], o[2] - cpos[2]};
      int axk;
      t = ray_aabb(oc, d, ob + 4, &axk);
      shade = axk == 2 ? 1.0f : (axk == 0 ? 0.7f : 0.55f);
    } else if (kind == kSphere) {
      t = ray_sphere(o, d, cpos, ob[8]);
      const float nzk = (o[2] + d[2] * t) - cpos[2];
      shade = fminf(fmaxf(0.4f + 0.6f * nzk / ob[7], 0.3f), 1.0f);
    } else {
      const int first = (int)ob[12], count = (int)ob[13];
      t = INFINITY;
      int kk = 0;
      for (int k = 0; k < count; ++k) {
        const float tk = ray_tri(o, d, s_tri + kTri * (first + k));
        if (tk < t) { t = tk; kk = k; }
      }
      shade = fminf(fmaxf(0.4f + 0.6f * fabsf(s_tri[kTri * (first + kk) + 11]), 0.3f), 1.0f);
    }
    if (t < best_t) {
      best_t = t;
      best_id = sc.N + 1 + m;
      rgb[0] = ob[9] * shade;
      rgb[1] = ob[10] * shade;
      rgb[2] = ob[11] * shade;
    }
  }

  // Sky, RGBA, depth and segment.
  const bool miss = !isfinite(best_t);
  const long long out = view * P + pix;
  uint8_t* px4 = rgba + 4 * out;
  px4[0] = (uint8_t)__float2uint_rz(miss ? 135.0f : rgb[0]);
  px4[1] = (uint8_t)__float2uint_rz(miss ? 180.0f : rgb[1]);
  px4[2] = (uint8_t)__float2uint_rz(miss ? 235.0f : rgb[2]);
  px4[3] = 255;
  float depth = 1.0f;
  if (!miss) {
    float z = dot3(d, fwd) * best_t;
    z = fminf(fmaxf(z, L), sc.far_);
    depth = (1.0f / L - 1.0f / z) / (1.0f / L - sc.inv_far);
  }
  dep[out] = depth;
  seg[out] = miss ? -1 : best_id;
}

}  // namespace

extern "C" int render_views(const void* pos, const void* quat, const void* arm, const void* cam,
                            const void* cf2, int n_cf2, const void* objs, int n_obj,
                            const void* tris, int n_tri, int B, int N, int C, int H, int W,
                            int use_mesh, float tan_half, float aspect, float far_,
                            float inv_far, float ca, float sa, void* rgba, void* dep, void* seg,
                            void* stream) {
  if (B < 0 || N < 1 || C < 0 || H < 1 || W < 1 || n_cf2 < 0 || n_cf2 > kMaxCf2 ||
      n_obj < 0 || n_obj > kMaxObjs || n_tri < 0 || n_tri > kMaxLandTris) {
    return (int)cudaErrorInvalidValue;
  }
  const long long P = (long long)H * W;
  const long long blocks = (long long)B * C * ((P + kBlock - 1) / kBlock);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Scene sc{B, N, C, H, W, n_cf2, n_obj, n_tri, use_mesh, tan_half, aspect, far_, inv_far, ca, sa};
  render_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)quat, (const float*)arm, (const int*)cam,
      (const float*)cf2, (const float*)objs, (const float*)tris, sc, (uint8_t*)rgba,
      (float*)dep, (int*)seg);
  return (int)cudaGetLastError();
}
