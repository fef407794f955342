"""The onboard camera on the card: kernel K7 and the dispatch to it.

``render_views(pos, quat, arm, cam, cfg)`` renders the cameras ``cam`` (drone
indices) of B worlds, ``pos`` (B, N, 3), ``quat`` (B, N, 4), ``arm`` (B,),
into ``(rgba (B, C, H, W, 4) uint8, dep (B, C, H, W) float32, seg (B, C, H,
W) int32)``. It goes through the custom operator ``gpbd_torch::render_views``:

* on CUDA tensors it launches K7 (``csrc/render_views.cu``: a warp a tile of
  8 x 4 pixels, which culls the scene to the primitives its rays can reach
  and walks them in scene order), which stands for the JAX package's
  XLA-fused camera (gym_pybullet_drones_tpu/render/camera.py:177); a failed
  build or launch raises, and there is no fallback;
* on CPU tensors it runs ``render/camera.render_drone_views_plain``;
* under ``torch.func.vmap`` its batching rule folds the mapped axis into the
  worlds' axis B and calls the operator once on the whole batch, so the
  per-env step of domain-randomized params renders with one launch.

``tile_lists`` is K7's cull in plain PyTorch: each tile's survivors, by the
kernel's rule and padding, for the tests.
"""

import ctypes
import functools

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.core.rotations import quat_to_matrix
from gym_pybullet_drones_tpu_torch.ops import _build
from gym_pybullet_drones_tpu_torch.render.camera import (
    CameraConfig,
    _scene_objects,
    cf2_mesh,
    frame_rotation,
    mesh_arrays,
    render_drone_views_plain,
    tan_half_fov,
    use_mesh_proxy,
)
from gym_pybullet_drones_tpu_torch.render.meshes import _cross, _dot

KERNEL = "render_views"
_KINDS = {"box": 0, "sphere": 1, "mesh": 2}
_OBJ_FLOATS = 16  # a landmark object's floats in the kernel (csrc/render_views.cu)
# K7's tile, a warp's pixels (csrc/render_views.cu kTileW, kTileH).
TILE_W, TILE_H = 8, 4
# The cull's padding. Bounding radii are padded on the host by SPHERE_REL of
# the radius and SPHERE_ABS (m at unit arm for the drones), then rounded up to
# float32; the gate adds GATE_REL of the sphere centre's L1 distance from the
# eye and GATE_ABS. A tile whose adjacent corner rays have a squared sine
# under CONE_MIN_SIN2 keeps everything.
SPHERE_REL, SPHERE_ABS = 1e-3, 1e-5
GATE_REL, GATE_ABS = 1e-3, 1e-5
CONE_MIN_SIN2 = 1e-8
# The X-frame proxy at unit arm: the bars' half extents, the body sphere's
# radius (render/camera.render_drone_views_plain).
_BARS_HALF, _BODY_R = (1.6, 0.3, 0.2), 0.75


def _tri_rows(arrays):
    """(T, 12) float32 rows of ``mesh_arrays``: v0, e1, e2, unit normal."""
    return np.concatenate(arrays, axis=1).astype(np.float32)


def _padded(r):
    """The float32 radius at least ``r`` (float64) padded by SPHERE_REL and
    SPHERE_ABS."""
    want = np.asarray(r, np.float64) * (1.0 + SPHERE_REL) + SPHERE_ABS
    got = want.astype(np.float32)
    return np.where(got < want, np.nextafter(got, np.float32(np.inf)), got)


def _row_vertices(rows):
    """(T, 3, 3) float64 vertices v0, v0 + e1, v0 + e2 of (T, 12) rows: the
    triangles the ray test sees."""
    v0 = rows[:, 0:3].astype(np.float64)
    return np.stack([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]], 1)


def _tri_spheres(rows):
    """(T, 4) float32 spheres of (T, 12) triangle rows: the float32 centroid
    and the padded distance to the farthest vertex."""
    verts = _row_vertices(rows)
    centre = verts.mean(1).astype(np.float32)
    r = np.linalg.norm(verts - centre[:, None].astype(np.float64), axis=-1).max(1)
    return np.concatenate([centre, _padded(r)[:, None]], 1).astype(np.float32)


@functools.cache
def scene_tables(scene: str, with_landmarks: bool, frame_angle_deg: float):
    """The kernel's scene as numpy tables: the unit cf2 mesh (68, 12), the
    landmark objects (M, 16: kind, pos, half, radius, float32 radius
    squared, rgb, first triangle, triangles, the padded radius of a sphere
    about pos that holds the object) and their world-space triangles (T,
    12), in ``_scene_objects`` order."""
    cf2 = _tri_rows(mesh_arrays(cf2_mesh(1.0, frame_angle_deg)))
    objs, tris, first = [], [], 0
    for obj in (_scene_objects(scene) if with_landmarks else ()):
        row = np.zeros(_OBJ_FLOATS, np.float32)
        row[0] = _KINDS[obj["kind"]]
        row[1:4], row[4:7] = obj["pos"], obj["half"]
        row[7] = obj["radius"]
        row[8] = np.float32(float(obj["radius"]) ** 2)
        row[9:12] = obj["rgb"]
        if obj["kind"] == "mesh":
            rows = _tri_rows(obj["mesh"])
            row[12:14] = first, len(rows)
            tris.append(rows)
            first += len(rows)
            reach = np.linalg.norm(_row_vertices(rows) - row[1:4].astype(np.float64),
                                   axis=-1).max()
        elif obj["kind"] == "box":
            reach = np.linalg.norm(row[4:7].astype(np.float64))
        else:
            reach = float(row[7])
        row[14] = _padded(reach)
        objs.append(row)
    objs = np.stack(objs) if objs else np.zeros((0, _OBJ_FLOATS), np.float32)
    tris = np.concatenate(tris) if tris else np.zeros((0, 12), np.float32)
    return cf2, objs, tris


@functools.cache
def scene_bounds(scene: str, with_landmarks: bool, frame_angle_deg: float):
    """The cull's spheres beside ``scene_tables``: the unit cf2 mesh's
    triangles (68, 4) and the landmark triangles (T, 4), each centre and
    padded radius, and the padded unit radii of the drone proxies (the whole
    cf2 mesh about the body origin, the X-frame's bars, its body sphere)."""
    cf2, _, tris = scene_tables(scene, with_landmarks, frame_angle_deg)
    r_mesh = np.linalg.norm(_row_vertices(cf2), axis=-1).max()
    radii = tuple(float(_padded(r)) for r in (r_mesh, np.linalg.norm(_BARS_HALF), _BODY_R))
    return _tri_spheres(cf2), _tri_spheres(tris), radii


@functools.cache
def _device_tables(scene, with_landmarks, frame_angle_deg, device):
    cf2, objs, tris = scene_tables(scene, with_landmarks, frame_angle_deg)
    cf2_sph, tri_sph, _ = scene_bounds(scene, with_landmarks, frame_angle_deg)
    return tuple(torch.as_tensor(t, device=device) for t in (cf2, objs, tris, cf2_sph, tri_sph))


@functools.cache
def _library():
    """K7's C entry point, built at first use and typed once."""
    fn = ctypes.CDLL(_build.build(KERNEL)).render_views
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, i, p, i, p, p, i, i, i, i, i, i, i, f, f, f, f, f, f, f, f,
                   f, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm() -> int:
    """Blocks of K7 (four warps of ``TILE_W * TILE_H`` pixels) that one SM of
    the current card holds at once."""
    fn = ctypes.CDLL(_build.build(KERNEL)).render_blocks_per_sm
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    rc = fn(ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: cudaError {rc}")
    return blocks.value


def _cfg(width, height, fov_deg, aspect, far, frame_angle_deg, with_landmarks, drone_proxy,
         scene):
    return CameraConfig(width=width, height=height, fov_deg=fov_deg, aspect=aspect, far=far,
                        frame_angle_deg=frame_angle_deg, with_landmarks=with_landmarks,
                        drone_proxy=drone_proxy, scene=scene)


def render_views_cuda(pos, quat, arm, cam, cfg: CameraConfig):
    """Launch K7 on CUDA float32 (B, N, 3) ``pos``, (B, N, 4) ``quat`` and
    (B,) ``arm``; ``cam`` lists the C camera drones.
    ``render_views_cuda.launches`` counts the launches."""
    device = pos.device
    for name, x, ndim in (("pos", pos, 3), ("quat", quat, 3), ("arm", arm, 1)):
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"K7 takes CUDA tensors on one device; {name} is on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"K7 computes in float32 only; {name} is {x.dtype}")
        if x.ndim != ndim or not x.is_contiguous():
            raise ValueError(f"K7 takes a contiguous {ndim}-d {name}; got shape "
                             f"{tuple(x.shape)}")
    B, N = pos.shape[0], pos.shape[1]
    if pos.shape != (B, N, 3) or quat.shape != (B, N, 4) or arm.shape != (B,) or N < 1:
        raise ValueError(f"K7 takes pos (B, N, 3), quat (B, N, 4), arm (B,); got "
                         f"{tuple(pos.shape)}, {tuple(quat.shape)}, {tuple(arm.shape)}")
    if any(not 0 <= j < N for j in cam):
        raise ValueError(f"camera drones {cam} out of range for {N} drones")
    H, W, C = cfg.height, cfg.width, len(cam)
    cf2, objs, tris, cf2_sph, tri_sph = _device_tables(cfg.scene, cfg.with_landmarks,
                                                        cfg.frame_angle_deg, device)
    radii = scene_bounds(cfg.scene, cfg.with_landmarks, cfg.frame_angle_deg)[2]
    cam_t = torch.as_tensor(cam, dtype=torch.int32, device=device)
    rgba = torch.empty((B, C, H, W, 4), dtype=torch.uint8, device=device)
    dep = torch.empty((B, C, H, W), dtype=torch.float32, device=device)
    seg = torch.empty((B, C, H, W), dtype=torch.int32, device=device)
    ca, sa = frame_rotation(cfg)
    fn = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(pos.data_ptr(), quat.data_ptr(), arm.data_ptr(), cam_t.data_ptr(),
                cf2.data_ptr(), cf2_sph.data_ptr(), cf2.shape[0], objs.data_ptr(),
                objs.shape[0], tris.data_ptr(), tri_sph.data_ptr(), tris.shape[0], B, N, C, H,
                W, int(use_mesh_proxy(cfg, N)), tan_half_fov(cfg), cfg.aspect, cfg.far,
                1.0 / cfg.far, ca, sa, *radii, rgba.data_ptr(), dep.data_ptr(), seg.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: cudaError {rc}")
    render_views_cuda.launches += 1
    return rgba, dep, seg


render_views_cuda.launches = 0


@torch.library.custom_op("gpbd_torch::render_views", mutates_args=())
def _render_op(pos: torch.Tensor, quat: torch.Tensor, arm: torch.Tensor, cam: list[int],
               width: int, height: int, fov_deg: float, aspect: float, far: float,
               frame_angle_deg: float, with_landmarks: bool, drone_proxy: str,
               scene: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise ValueError(f"no render path for device {pos.device}")


@_render_op.register_kernel("cpu")
def _render_cpu(pos, quat, arm, cam, *cfg):
    return render_drone_views_plain(pos, quat, arm, cam, _cfg(*cfg))


@_render_op.register_kernel("cuda")
def _render_k7(pos, quat, arm, cam, *cfg):
    return render_views_cuda(pos.contiguous(), quat.contiguous(), arm.contiguous(), cam,
                             _cfg(*cfg))


@_render_op.register_vmap
def _render_vmap(info, in_dims, pos, quat, arm, cam, *cfg):
    """Fold the mapped axis V into the worlds' axis: (V, B, ...) -> (V * B,
    ...), one call, then unfold the outputs."""
    V = info.batch_size

    def lead(x, dim):
        x = x.unsqueeze(0).expand((V,) + x.shape) if dim is None else x.movedim(dim, 0)
        return x.reshape((-1,) + x.shape[2:])

    B = pos.shape[1] if in_dims[0] is not None else pos.shape[0]
    outs = _render_op(lead(pos, in_dims[0]), lead(quat, in_dims[1]), lead(arm, in_dims[2]),
                      cam, *cfg)
    return tuple(o.reshape((V, B) + o.shape[1:]) for o in outs), (0, 0, 0)


def render_views(pos, quat, arm, cam, cfg: CameraConfig):
    """The cameras ``cam`` of B worlds: K7 on CUDA tensors, the plain version
    on CPU tensors, one batched call under ``torch.func.vmap``."""
    return _render_op(pos, quat, arm, list(cam), cfg.width, cfg.height, float(cfg.fov_deg),
                      float(cfg.aspect), float(cfg.far), float(cfg.frame_angle_deg),
                      bool(cfg.with_landmarks), cfg.drone_proxy, cfg.scene)


def _cone(apex, D):
    """A tile's cone as K7 builds it: (apex (..., 3), inward unit side
    normals (..., 4, 3), keeps-everything (...)) from the four corner
    directions ``D`` (..., 4, 3) in order around the tile."""
    nxt = D.roll(-1, dims=-2)
    n = _cross(D, nxt)
    nn, pp, qq = _dot(n, n), _dot(D, D), _dot(nxt, nxt)
    keep_all = (~(nn > CONE_MIN_SIN2 * (pp * qq))).any(-1)
    side = _dot(n, D.sum(-2, keepdim=True))
    scale = torch.where(side < 0, -1.0, 1.0) / torch.sqrt(torch.where(nn > 0, nn, 1.0))
    return apex, n * scale[..., None], keep_all


def _gate(cone, centre, r):
    """K7's gate: False only where the sphere (``centre`` (..., 3), ``r``
    (...)) lies wholly outside a side plane of the cone, with the padding."""
    apex, n, keep_all = cone
    v = centre - apex
    pad = r + GATE_REL * (v[..., 0].abs() + v[..., 1].abs() + v[..., 2].abs()) + GATE_ABS
    return keep_all | (_dot(n, v[..., None, :]) >= -pad[..., None]).all(-1)


def _per(cone):
    """A cone with one more axis, for candidates along it."""
    apex, n, keep_all = cone
    return apex[..., None, :], n[..., None, :, :], keep_all[..., None]


def tile_corners(pos, quat, arm, cam, cfg: CameraConfig):
    """The cameras of ``render_drone_views_plain`` and their tiles' corner
    directions: (eye (B, C, 3), D (B, C, TY, TX, 4, 3)), D the outer corners
    of each TILE_W x TILE_H tile's pixel footprints, in order around it."""
    H, W = cfg.height, cfg.width
    sel = torch.as_tensor(cam, dtype=torch.long, device=pos.device)
    R = quat_to_matrix(quat)[:, sel]
    eye = pos[:, sel] + torch.stack([torch.zeros_like(arm), torch.zeros_like(arm), arm],
                                    -1)[:, None]
    fwd = R[..., :, 0] / torch.sqrt(_dot(R[..., :, 0], R[..., :, 0]))[..., None]
    right = _cross(fwd, torch.tensor([0.0, 0.0, 1.0], dtype=pos.dtype).expand(fwd.shape))
    right = right / torch.clamp(torch.sqrt(_dot(right, right)), min=1e-6)[..., None]
    up = _cross(right, fwd)
    th = tan_half_fov(cfg)
    xs = torch.arange(0, W, TILE_W, dtype=pos.dtype)
    ys = torch.arange(0, H, TILE_H, dtype=pos.dtype)
    ax = lambda x: x * (2.0 * th * cfg.aspect / W) - th * cfg.aspect
    ay = lambda y: th - y * (2.0 * th / H)
    lo, hi = ax(xs), ax(torch.clamp(xs + TILE_W, max=W))
    top, bot = ay(ys), ay(torch.clamp(ys + TILE_H, max=H))
    TY, TX = len(ys), len(xs)
    cx = torch.stack([lo, hi, hi, lo], -1).expand(TY, TX, 4)
    cy = torch.stack([top, top, bot, bot], -1)[:, None].expand(TY, TX, 4)
    bc = (slice(None), slice(None), None, None, None)
    D = fwd[bc] + cx[..., None] * right[bc] + cy[..., None] * up[bc]
    return eye, D


def tile_lists(pos, quat, arm, cam, cfg: CameraConfig):
    """K7's cull in plain PyTorch: which primitives each tile keeps, by the
    kernel's rule and padding, on (B, N, 3) ``pos``, (B, N, 4) ``quat``, (B,)
    ``arm`` and the camera drones ``cam``. A dict of bools over (B, C, TY,
    TX, ...): ``drones`` (N; the camera's own drone never), ``drone_tris``
    (N, 68: a kept drone's cf2 triangles, mesh proxy only, else None),
    ``objects`` (M landmark objects) and ``tris`` (T landmark triangles, of
    kept mesh objects). A primitive left out returns inf on every ray of
    the tile, so walking only the kept ones in scene order gives the plain
    version's result."""
    B, N = pos.shape[0], pos.shape[1]
    cf2, objs, tris = (torch.as_tensor(t, dtype=pos.dtype) for t in scene_tables(
        cfg.scene, cfg.with_landmarks, cfg.frame_angle_deg))
    cf2_sph, tri_sph, (r_mesh, r_bars, r_body) = scene_bounds(
        cfg.scene, cfg.with_landmarks, cfg.frame_angle_deg)
    cf2_sph, tri_sph = torch.as_tensor(cf2_sph), torch.as_tensor(tri_sph)
    eye, D = tile_corners(pos, quat, arm, cam, cfg)
    world = _cone(eye[:, :, None, None, :], D)  # (B, C, TY, TX)
    L = arm.reshape(B, 1, 1, 1, 1)

    # Drones, each in its own frame: the cone mapped by M^T, M = R or U.
    R = quat_to_matrix(quat)  # (B, N, 3, 3)
    mesh = use_mesh_proxy(cfg, N)
    if mesh:
        M = R
    else:
        ca, sa = frame_rotation(cfg)
        M = R @ torch.tensor([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]], dtype=pos.dtype)
    apex_b = torch.einsum("bnkl,bcnk->bcnl", M, eye[:, :, None] - pos[:, None])
    D_b = torch.einsum("bnkl,bcyzik->bcyznil", M, D)
    body = _cone(apex_b[:, :, None, None], D_b)  # (B, C, TY, TX, N)
    drones = _gate(body, torch.zeros(3, dtype=pos.dtype), (r_mesh if mesh else r_bars) * L)
    if not mesh:
        drones = drones | _gate(_per(world), pos[:, None, None, None], r_body * L)
    own = torch.as_tensor(cam)[:, None] == torch.arange(N)[None, :]  # (C, N)
    drones = drones & ~own[None, :, None, None, :]
    drone_tris = None
    if mesh:
        Lt = L[..., None]
        drone_tris = drones[..., None] & _gate(_per(body), cf2_sph[:, :3] * Lt[..., None],
                                               cf2_sph[:, 3] * Lt)
    # Landmarks: objects, then the triangles of the kept meshes.
    objects = _gate(_per(world), objs[:, 1:4], objs[:, 14])
    owner = torch.zeros(len(tris), dtype=torch.long)
    for m in range(len(objs)):
        owner[int(objs[m, 12]):int(objs[m, 12] + objs[m, 13])] = m
    tri_keep = _gate(_per(world), tri_sph[:, :3], tri_sph[:, 3]) & objects[..., owner]
    return dict(drones=drones, drone_tris=drone_tris, objects=objects, tris=tri_keep)
