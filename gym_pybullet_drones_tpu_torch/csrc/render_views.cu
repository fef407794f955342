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
// Bound. A pixel reads nothing from device memory but the scene and writes
// 12 bytes (rgba 4, depth 4, segment 4). The plain version tests every ray
// against every primitive: the plane, the scene drones (68 triangles each
// with the mesh proxy; two slab tests and a sphere with the X-frame) and the
// landmarks (232 triangles and two slab tests in the "rl" scene), some 10^4
// operations a pixel. A pixel needs far fewer: the primitives its ray comes
// near, about 5 triangles of the 232 in the "rl" views. So the kernel is
// bound by operations, and by how few of them it can get away with.
//
// Design: tiles that cull the scene.
// * A warp owns a tile of kTileW x kTileH pixels of one camera; a block holds
//   kWarpsX x kWarpsY such tiles of the same camera. Edge tiles take any H, W:
//   lanes past the image trace a clamped ray and write nothing.
// * The camera (eye, fwd, right, up) is computed once a block, by one thread,
//   into shared memory, with the operations the plain version does per pixel,
//   so every pixel's ray has the plain version's bits.
// * The tile's cone: the frustum through the four outer corners of its pixel
//   footprints, as four side planes through the eye. Every ray of the tile
//   lies inside it. A bounding sphere is culled when it lies wholly outside
//   one side plane (ops/render_views.py holds the spheres, computed on the
//   host in float64 and padded; tile_lists there is this rule in PyTorch).
// * The scene is walked in the plain version's order, in rounds of 32
//   candidates: each lane gates one candidate, a warp ballot gives the
//   survivors in scene order, and every lane then runs the exact test of each
//   survivor, in order, on its own pixel. The ballot's mask is the tile's
//   list: all lanes walk the same list, so the warp does not diverge.
//   Drones are gated as a whole, in their own frame (the cone mapped by R^T
//   or U^T, so the gate holds for any quaternion), then the cf2 triangles of
//   each drone that survives; landmark objects as a whole, then the
//   triangles of each mesh that survives.
// * Survivors are tested two at a time, so that their dependent chains
//   overlap; a thread keeps to 64 registers, so that an SM holds eight blocks.
// * No staging: the scene tables are read through the read-only cache, one
//   broadcast load a survivor. (A resident grid that staged the scene in
//   shared memory once a block was no faster on the H100.)
//
// Why the result stays bit-equal to the plain version. A primitive is culled
// only when the tile's rays miss its padded sphere, and then the exact test
// would have returned inf on every ray of the tile: the radii are padded by
// 1e-3 relative and 1e-5 m on the host, and the gate adds 1e-3 of the
// distance (1 mrad) and 1e-5 m, far above float32 rounding in the rays and
// the tests. A camera inside a sphere never culls it. Every survivor goes
// through the plain version's arithmetic: every add and multiply rounds on
// its own (-fmad=false), divisions and square roots are IEEE, and each sum
// runs in the plain version's order. A hit replaces the best only when
// strictly nearer, which is the plain version's where(t < best) in scene
// order and its first-index argmin over drones, triangles and slab axes; an
// inf never replaces anything, so skipping it changes nothing. The gates
// only decide what to skip, so they use fused multiply-adds (fmaf) and fast
// reciprocal square roots; no surviving test reads a value they compute.
// Drone hits are computed in the drone's body frame (oc_b = R^T (o - pos),
// dd_b = R^T d), landmark meshes in the world frame, as the plain version
// does. The checker is (floor(x) + floor(y)) mod 2 with Python's sign rule;
// uint8 truncates toward zero. Every literal is a float.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 8;   // a warp's tile: kTileW x kTileH pixels
constexpr int kTileH = 4;
constexpr int kWarpsX = 2;  // a block's tiles
constexpr int kWarpsY = 2;
constexpr int kBlock = 32 * kWarpsX * kWarpsY;
constexpr int kBlockW = kTileW * kWarpsX;
constexpr int kBlockH = kTileH * kWarpsY;
// Resident blocks an SM: at most 64 registers a thread. Eight blocks of 128
// threads beat four of 123 registers (no spills) and six of 80 on the H100.
constexpr int kMinBlocks = 8;
constexpr int kTri = 12;    // floats a triangle: v0, e1, e2, unit normal
constexpr int kObj = 16;    // floats a landmark object (ops/render_views.py)
constexpr int kDrone = 21;  // floats a drone: pos, R, U
constexpr unsigned kAll = 0xffffffffu;
// The gate's own padding (ops/render_views.py GATE_REL, GATE_ABS), on top of
// the padded radii, and its floor on a tile's corner angle (CONE_MIN_SIN2).
constexpr float kGateRel = 1e-3f;
constexpr float kGateAbs = 1e-5f;
constexpr float kConeMinSin2 = 1e-8f;

static_assert(kTileW * kTileH == 32, "a tile is one warp");

enum { kBox = 0, kSphere = 1, kMesh = 2 };

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ void load_tri(const float* __restrict__ src, float* tri) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = __ldg(p + i);
    tri[4 * i] = v.x;
    tri[4 * i + 1] = v.y;
    tri[4 * i + 2] = v.z;
    tri[4 * i + 3] = v.w;
  }
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

// The triangles ``mask`` names (bit i: row ``rows + kTri * (base + i)``,
// its v0, e1, e2 scaled by ``scale`` where kScaled) in ascending order
// against the ray (o, d): a hit replaces (t, k) only when strictly nearer, as
// one test after another would. Two tests at a time, so that their chains
// overlap; the second folds in after the first.
template <bool kScaled>
__device__ __forceinline__ void walk_tris(unsigned mask, int base, const float* __restrict__ rows,
                                          float scale, const float* o, const float* d, float& t,
                                          int& k) {
  while (mask) {
    const int k1 = base + __ffs(mask) - 1;
    mask &= mask - 1;
    float tri1[kTri];
    load_tri(rows + kTri * k1, tri1);
    if (kScaled) {
#pragma unroll
      for (int i = 0; i < 9; ++i) tri1[i] = tri1[i] * scale;
    }
    if (mask) {
      const int k2 = base + __ffs(mask) - 1;
      mask &= mask - 1;
      float tri2[kTri];
      load_tri(rows + kTri * k2, tri2);
      if (kScaled) {
#pragma unroll
        for (int i = 0; i < 9; ++i) tri2[i] = tri2[i] * scale;
      }
      const float t1 = ray_tri(o, d, tri1);
      const float t2 = ray_tri(o, d, tri2);
      if (t1 < t) { t = t1; k = k1; }
      if (t2 < t) { t = t2; k = k2; }
    } else {
      const float t1 = ray_tri(o, d, tri1);
      if (t1 < t) { t = t1; k = k1; }
    }
  }
}

// camera._ray_aabb's reciprocal of a direction, once a ray and frame.
__device__ __forceinline__ void slab_inv(const float* dd, float* inv) {
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = 1.0f / (fabsf(dd[k]) > 1e-9f ? dd[k] : 1e-9f);
}

// Slab test against a box centred at the origin (camera._ray_aabb) with the
// direction's reciprocal ``inv``: the entry distance (inf on a miss) and the
// entry face's axis, the first on ties.
__device__ __forceinline__ float ray_aabb(const float* oc, const float* inv, const float* half,
                                          int* axis) {
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (-half[k] - oc[k]) * inv[k];
    const float t2 = (half[k] - oc[k]) * inv[k];
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

// ---- the gates: they only decide what to skip (fused, approximate) -------

// A tile's cone: the apex and the four side planes' inward unit normals;
// ``all`` keeps everything (a cone too thin to orient, or not finite).
struct Cone {
  float a[3];
  float n[4][3];
  bool all;
};

__device__ __forceinline__ void make_cone(const float* apex, const float (*D)[3], Cone& k) {
  float s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    k.a[c] = apex[c];
    s[c] = (D[0][c] + D[1][c]) + (D[2][c] + D[3][c]);
  }
  bool all = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = D[i];
    const float* q = D[(i + 1) & 3];
    const float n[3] = {fmaf(p[1], q[2], -p[2] * q[1]), fmaf(p[2], q[0], -p[0] * q[2]),
                        fmaf(p[0], q[1], -p[1] * q[0])};
    const float nn = fmaf(n[0], n[0], fmaf(n[1], n[1], n[2] * n[2]));
    const float pp = fmaf(p[0], p[0], fmaf(p[1], p[1], p[2] * p[2]));
    const float qq = fmaf(q[0], q[0], fmaf(q[1], q[1], q[2] * q[2]));
    all |= !(nn > kConeMinSin2 * (pp * qq));
    const float side = fmaf(n[0], s[0], fmaf(n[1], s[1], n[2] * s[2]));
    const float scale = (side < 0.0f ? -1.0f : 1.0f) * rsqrtf(nn);
#pragma unroll
    for (int c = 0; c < 3; ++c) k.n[i][c] = n[c] * scale;
  }
  k.all = all;
}

// Whether a ray of the cone may enter the sphere (c, r).
__device__ __forceinline__ bool gate(const Cone& k, float cx, float cy, float cz, float r) {
  if (k.all) return true;
  const float v[3] = {cx - k.a[0], cy - k.a[1], cz - k.a[2]};
  const float pad = fmaf(kGateRel, fabsf(v[0]) + fabsf(v[1]) + fabsf(v[2]), r + kGateAbs);
  bool in = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    in &= fmaf(k.n[i][0], v[0], fmaf(k.n[i][1], v[1], k.n[i][2] * v[2])) >= -pad;
  }
  return in;  // false only when the sphere is wholly outside a side plane
}

// The cone mapped into a frame by M^T: its apex ``apex`` there, the world
// corner directions D mapped by M^T.
__device__ __forceinline__ void frame_cone(const float* M, const float* apex, const float (*D)[3],
                                           Cone& k) {
  float Db[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Db[i][c] = fmaf(M[c], D[i][0], fmaf(M[3 + c], D[i][1], M[6 + c] * D[i][2]));
    }
  }
  make_cone(apex, Db, k);
}

struct Scene {
  int B, N, C, H, W, n_cf2, n_obj, n_tri, use_mesh;
  float tan_half, aspect, far_, inv_far, ca, sa;
  float r_mesh, r_bars, r_body;  // padded unit radii: the cf2 mesh, the bars, the body
};

struct Camera {
  float o[3], fwd[3], right[3], up[3];
};

__global__ void __launch_bounds__(kBlock, kMinBlocks)
render_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
              const float* __restrict__ arm, const int* __restrict__ cam,
              const float* __restrict__ cf2, const float* __restrict__ cf2_sph,
              const float* __restrict__ objs, const float* __restrict__ tris,
              const float* __restrict__ tri_sph, Scene sc, uint8_t* __restrict__ rgba,
              float* __restrict__ dep, int* __restrict__ seg) {
  __shared__ Camera s_cam;

  const int bx = (sc.W + kBlockW - 1) / kBlockW;
  const int per_view = bx * ((sc.H + kBlockH - 1) / kBlockH);
  const long long view = blockIdx.x / per_view;  // b * C + c
  const int bt = (int)(blockIdx.x % per_view);
  const int b = (int)(view / sc.C);
  const int c = (int)(view % sc.C);
  const float L = arm[b];
  const float* wpos = pos + (long long)b * sc.N * 3;
  const float* wquat = quat + (long long)b * sc.N * 4;
  const int me = cam[c];

  // The camera, once a block: eye at pos + (0, 0, L), looking along body +x.
  if (threadIdx.x == 0) {
    float R[9];
    quat_to_matrix(wquat + 4 * me, R);
    const float* p = wpos + 3 * me;
    Camera& k = s_cam;
    k.o[0] = p[0];
    k.o[1] = p[1];
    k.o[2] = p[2] + L;
    const float fw[3] = {R[0], R[3], R[6]};
    const float fn = sqrtf(dot3(fw, fw));
    k.fwd[0] = fw[0] / fn;
    k.fwd[1] = fw[1] / fn;
    k.fwd[2] = fw[2] / fn;
    // right = fwd x (0, 0, 1); cam_up = right x fwd
    const float* f = k.fwd;
    const float rt[3] = {f[1] * 1.0f - f[2] * 0.0f, f[2] * 0.0f - f[0] * 1.0f,
                         f[0] * 0.0f - f[1] * 0.0f};
    const float rn = fmaxf(sqrtf(dot3(rt, rt)), 1e-6f);
    k.right[0] = rt[0] / rn;
    k.right[1] = rt[1] / rn;
    k.right[2] = rt[2] / rn;
    const float* r = k.right;
    k.up[0] = r[1] * f[2] - r[2] * f[1];
    k.up[1] = r[2] * f[0] - r[0] * f[2];
    k.up[2] = r[0] * f[1] - r[1] * f[0];
  }
  __syncthreads();

  // This warp's tile; a warp wholly past the image has nothing to do.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = (bt % bx) * kBlockW + (warp % kWarpsX) * kTileW;
  const int y0 = (bt / bx) * kBlockH + (warp / kWarpsX) * kTileH;
  if (x0 >= sc.W || y0 >= sc.H) return;
  const int x1 = min(x0 + kTileW, sc.W), y1 = min(y0 + kTileH, sc.H);
  const int px_i = x0 + lane % kTileW, py_i = y0 + lane / kTileW;
  const bool inside = px_i < sc.W && py_i < sc.H;

  const float o[3] = {s_cam.o[0], s_cam.o[1], s_cam.o[2]};
  const float fwd[3] = {s_cam.fwd[0], s_cam.fwd[1], s_cam.fwd[2]};
  const float right[3] = {s_cam.right[0], s_cam.right[1], s_cam.right[2]};
  const float up[3] = {s_cam.up[0], s_cam.up[1], s_cam.up[2]};

  // The pixel's ray (a lane past the image traces the tile's last pixel).
  float d[3];
  {
    const int xi = min(px_i, sc.W - 1), yi = min(py_i, sc.H - 1);
    const float px = ((float)xi + 0.5f) / (float)sc.W * 2.0f - 1.0f;
    const float py = 1.0f - ((float)yi + 0.5f) / (float)sc.H * 2.0f;
    const float ax = px * sc.tan_half * sc.aspect;
    const float ay = py * sc.tan_half;
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = (fwd[k] + ax * right[k]) + ay * up[k];
    const float dn = sqrtf(dot3(d, d));
    d[0] = d[0] / dn;
    d[1] = d[1] / dn;
    d[2] = d[2] / dn;
  }

  // The tile's corner directions: the outer corners of its pixel footprints,
  // in order around the tile.
  float D[4][3];
  {
    const float sx = 2.0f * sc.tan_half * sc.aspect / (float)sc.W;
    const float sy = 2.0f * sc.tan_half / (float)sc.H;
    const float ax_lo = fmaf((float)x0, sx, -sc.tan_half * sc.aspect);
    const float ax_hi = fmaf((float)x1, sx, -sc.tan_half * sc.aspect);
    const float ay_top = fmaf(-(float)y0, sy, sc.tan_half);
    const float ay_bot = fmaf(-(float)y1, sy, sc.tan_half);
    const float cx[4] = {ax_lo, ax_hi, ax_hi, ax_lo};
    const float cy[4] = {ay_top, ay_top, ay_bot, ay_bot};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) D[i][k] = fmaf(cy[i], up[k], fmaf(cx[i], right[k], fwd[k]));
    }
  }

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

  // The other drones, ids 1..N, in the drone's body frame, in rounds of 32:
  // each lane gates one drone, then the warp walks the survivors in order.
  float td = INFINITY;
  int jd = 0, kd = 0, prim_d = 0, ax_d = 0;
  const float body_r = 0.75f * L;
  for (int jb = 0; jb < sc.N; jb += 32) {
    bool keep = false;
    const int jl = jb + lane;
    if (jl < sc.N && jl != me) {
      float rec[kDrone];
      drone_record(wpos + 3 * jl, wquat + 4 * jl, sc.ca, sc.sa, rec);
      const float ocw[3] = {o[0] - rec[0], o[1] - rec[1], o[2] - rec[2]};
      float M[9];  // R for the mesh, U for the X-frame
#pragma unroll
      for (int i = 0; i < 9; ++i) M[i] = sc.use_mesh ? rec[3 + i] : rec[12 + i];
      float ocb[3];
      mt_apply(M, ocw, ocb);
      Cone kb;
      frame_cone(M, ocb, D, kb);
      keep = gate(kb, 0.0f, 0.0f, 0.0f, (sc.use_mesh ? sc.r_mesh : sc.r_bars) * L);
      if (!sc.use_mesh && !keep) {
        Cone kw;
        make_cone(o, D, kw);
        keep = gate(kw, rec[0], rec[1], rec[2], sc.r_body * L);
      }
    }
    for (unsigned mask = __ballot_sync(kAll, keep); mask; mask &= mask - 1) {
      const int j = jb + __ffs(mask) - 1;
      float rec[kDrone];
      drone_record(wpos + 3 * j, wquat + 4 * j, sc.ca, sc.sa, rec);
      const float ocw[3] = {o[0] - rec[0], o[1] - rec[1], o[2] - rec[2]};
      float ocb[3], ddb[3];
      if (sc.use_mesh) {
        mt_apply(rec + 3, ocw, ocb);
        mt_apply(rec + 3, d, ddb);
        Cone kb;
        frame_cone(rec + 3, ocb, D, kb);
        for (int tb = 0; tb < sc.n_cf2; tb += 32) {
          const int tl = tb + lane;
          bool tkeep = false;
          if (tl < sc.n_cf2) {
            const float4 sp = __ldg(reinterpret_cast<const float4*>(cf2_sph) + tl);
            tkeep = gate(kb, sp.x * L, sp.y * L, sp.z * L, sp.w * L);
          }
          int kj = -1;  // the cf2 mesh at this world's arm
          walk_tris<true>(__ballot_sync(kAll, tkeep), tb, cf2, L, ocb, ddb, td, kj);
          if (kj >= 0) { jd = j; kd = kj; }
        }
      } else {
        mt_apply(rec + 12, ocw, ocb);
        mt_apply(rec + 12, d, ddb);
        const float half_a[3] = {1.6f * L, 0.3f * L, 0.2f * L};
        const float half_b[3] = {0.3f * L, 1.6f * L, 0.2f * L};
        float inv[3];
        slab_inv(ddb, inv);
        int axa, axb;
        const float ta = ray_aabb(ocb, inv, half_a, &axa);
        const float tb = ray_aabb(ocb, inv, half_b, &axb);
        const float ts = ray_sphere(o, d, rec, body_r * body_r);
        float tj = ta;
        int pj = 0;
        if (tb < tj) { tj = tb; pj = 1; }
        if (ts < tj) { tj = ts; pj = 2; }
        if (tj < td) { td = tj; jd = j; prim_d = pj; ax_d = pj == 0 ? axa : axb; }
      }
    }
  }
  if (td < best_t) {
    float rec[kDrone];
    drone_record(wpos + 3 * jd, wquat + 4 * jd, sc.ca, sc.sa, rec);
    float nz;
    if (sc.use_mesh) {
      const float* n = cf2 + kTri * kd + 9;
      const float* Rh = rec + 3;
      nz = fabsf((Rh[6] * n[0] + Rh[7] * n[1]) + Rh[8] * n[2]);
    } else if (prim_d == 2) {
      nz = ((o[2] + d[2] * td) - rec[2]) / body_r;
    } else {
      nz = fabsf(ax_d == 0 ? rec[18] : (ax_d == 1 ? rec[19] : rec[20]));
    }
    const float shade = fminf(fmaxf(0.35f + 0.65f * nz, 0.2f), 1.0f);
    best_t = td;
    best_id = jd + 1;
    rgb[0] = 80.0f * shade + 100.0f;
    rgb[1] = 80.0f * shade + 100.0f;
    rgb[2] = 90.0f * shade + 100.0f;
  }

  // Landmarks, ids N+1.., in scene order, world frame: each object gated as a
  // whole, then each triangle of a mesh that survives.
  if (sc.n_obj > 0) {
    Cone kw;
    make_cone(o, D, kw);
    float inv_d[3];
    slab_inv(d, inv_d);  // one ray's reciprocal, for every box
    for (int mb = 0; mb < sc.n_obj; mb += 32) {
      const int ml = mb + lane;
      bool keep = false;
      if (ml < sc.n_obj) {
        const float* ob = objs + kObj * ml;
        keep = gate(kw, __ldg(ob + 1), __ldg(ob + 2), __ldg(ob + 3), __ldg(ob + 14));
      }
      for (unsigned mask = __ballot_sync(kAll, keep); mask; mask &= mask - 1) {
        const int m = mb + __ffs(mask) - 1;
        const float* ob = objs + kObj * m;
        const int kind = (int)__ldg(ob);
        const float cpos[3] = {__ldg(ob + 1), __ldg(ob + 2), __ldg(ob + 3)};
        float t, shade;
        if (kind == kBox) {
          const float oc[3] = {o[0] - cpos[0], o[1] - cpos[1], o[2] - cpos[2]};
          const float half[3] = {__ldg(ob + 4), __ldg(ob + 5), __ldg(ob + 6)};
          int axk;
          t = ray_aabb(oc, inv_d, half, &axk);
          shade = axk == 2 ? 1.0f : (axk == 0 ? 0.7f : 0.55f);
        } else if (kind == kSphere) {
          t = ray_sphere(o, d, cpos, __ldg(ob + 8));
          const float nzk = (o[2] + d[2] * t) - cpos[2];
          shade = fminf(fmaxf(0.4f + 0.6f * nzk / __ldg(ob + 7), 0.3f), 1.0f);
        } else {
          const int first = (int)__ldg(ob + 12), count = (int)__ldg(ob + 13);
          t = INFINITY;
          int kk = 0;
          for (int tb = 0; tb < count; tb += 32) {
            const int tl = tb + lane;
            bool tkeep = false;
            if (tl < count) {
              const float4 sp = __ldg(reinterpret_cast<const float4*>(tri_sph) + first + tl);
              tkeep = gate(kw, sp.x, sp.y, sp.z, sp.w);
            }
            walk_tris<false>(__ballot_sync(kAll, tkeep), tb, tris + kTri * first, 1.0f, o, d, t,
                             kk);
          }
          shade = fminf(fmaxf(0.4f + 0.6f * fabsf(__ldg(tris + kTri * (first + kk) + 11)), 0.3f),
                        1.0f);
        }
        if (t < best_t) {
          best_t = t;
          best_id = sc.N + 1 + m;
          rgb[0] = __ldg(ob + 9) * shade;
          rgb[1] = __ldg(ob + 10) * shade;
          rgb[2] = __ldg(ob + 11) * shade;
        }
      }
    }
  }
  if (!inside) return;

  // Sky, RGBA, depth and segment.
  const bool miss = !isfinite(best_t);
  const long long out = view * sc.H * sc.W + (long long)py_i * sc.W + px_i;
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
                            const void* cf2, const void* cf2_sph, int n_cf2, const void* objs,
                            int n_obj, const void* tris, const void* tri_sph, int n_tri, int B,
                            int N, int C, int H, int W, int use_mesh, float tan_half,
                            float aspect, float far_, float inv_far, float ca, float sa,
                            float r_mesh, float r_bars, float r_body, void* rgba, void* dep,
                            void* seg, void* stream) {
  if (B < 0 || N < 1 || C < 0 || H < 1 || W < 1 || n_cf2 < 0 || n_obj < 0 || n_tri < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (long long)((H + kBlockH - 1) / kBlockH) * ((W + kBlockW - 1) / kBlockW);
  const long long blocks = (long long)B * C * tiles;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Scene sc{B, N, C, H, W, n_cf2, n_obj, n_tri, use_mesh, tan_half, aspect, far_, inv_far, ca, sa,
           r_mesh, r_bars, r_body};
  render_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)quat, (const float*)arm, (const int*)cam,
      (const float*)cf2, (const float*)cf2_sph, (const float*)objs, (const float*)tris,
      (const float*)tri_sph, sc, (uint8_t*)rgba, (float*)dep, (int*)seg);
  return (int)cudaGetLastError();
}

// Blocks of K7 that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int render_blocks_per_sm(int* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, render_kernel, kBlock, 0);
}
