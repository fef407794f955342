"""The onboard camera: a ray caster for drone-POV images (port of the JAX
``render/camera.py``).

It stands in for the reference's PyBullet TinyRenderer camera
(BaseAviary._getDroneImages, BaseAviary.py:565-617) with the same camera
model: the eye at ``pos + (0, 0, L)``, looking along the body +x axis, up
(0, 0, 1), FOV 60 deg, aspect 1, near = L (the arm), far = 1000, 64 x 48
pixels by default (BaseRLAviary.py:34). The scene is the ground plane (a
checker), every other drone, and the obstacle world: the four RL landmarks
(BaseRLAviary._addObstacles, :99-128) or BaseAviary's own scene (:958-981).
Outputs follow ``getCameraImage``: RGBA uint8, OpenGL depth in [0, 1] and a
segmentation mask (-1 sky, 0 plane, 1..N drones, N+1.. landmarks).

Drones render as the 68-triangle cf2 silhouette (``meshes.cf2_mesh``) up to
8 scene drones and as the X-frame proxy (two oriented bars and a body
sphere) above (``drone_proxy="auto"``); the duck and teddy landmarks are
triangle meshes, the block and cube boxes.

``render_drone_views`` takes leading batch axes: each batch entry (an env)
is a world of its own with only its own N drones, as under the JAX
package's vmap. On CUDA tensors it launches K7 (``ops/render_views.py``,
``csrc/render_views.cu``); on CPU tensors it runs ``render_drone_views_plain``,
this module's plain PyTorch version, which computes each product and sum in
the JAX package's order. The plain version holds (..., C, H, W, N, T)
intermediates, where XLA fuses the min over T into the build; on the card
it serves as K7's reference only.
"""

import dataclasses
import math
import os

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.core.collisions import (
    _BASE_OBSTACLE_HALF,
    _BASE_OBSTACLE_POS,
    _BASE_OBSTACLE_R,
    _RL_OBSTACLE_HALF,
    _RL_OBSTACLE_POS,
    _RL_OBSTACLE_R,
)
from gym_pybullet_drones_tpu_torch.core.rotations import quat_to_matrix
from gym_pybullet_drones_tpu_torch.envs.spec import ImageType
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import _div
from gym_pybullet_drones_tpu_torch.render.meshes import (
    _cross,
    _dot,
    cf2_mesh,
    duck_mesh,
    mesh_arrays,
    ray_tris,
    teddy_mesh,
)

_LANDMARK_KIND = tuple(
    "box" if _RL_OBSTACLE_HALF[k].any() else "mesh" for k in range(4))
_LANDMARK_RGB = np.array([
    [200, 60, 60], [90, 90, 220], [240, 210, 60], [170, 110, 70],
])
# The drone proxy's rule: the cf2 mesh up to this many scene drones, the
# X-frame above (the code's rule in the JAX package, camera.py:252-253).
MESH_MAX_DRONES = 8
_SCENES = {}


def _scene_objects(scene: str):
    """The obstacle world of ``scene``, cached: dicts with ``kind`` "box",
    "sphere" or "mesh", world ``pos``, ``half``, ``radius``, ``mesh`` (world
    space ``mesh_arrays``) and ``rgb``.

    "rl": the four BaseRLAviary landmarks (BaseRLAviary.py:108-126).
    "base": BaseAviary's own world (BaseAviary.py:958-981): the duck mesh,
    the 1 m cube, sphere2 and the three-box samurai gate; the geometry is
    core/collisions'."""
    if scene in _SCENES:
        return _SCENES[scene]
    if scene == "rl":
        objs = []
        for k in range(4):
            o = dict(kind=_LANDMARK_KIND[k], pos=_RL_OBSTACLE_POS[k], half=_RL_OBSTACLE_HALF[k],
                     radius=_RL_OBSTACLE_R[k], rgb=_LANDMARK_RGB[k])
            if o["kind"] == "mesh":
                mesh = duck_mesh() if k == 2 else teddy_mesh()
                o["mesh"] = mesh_arrays(mesh + _RL_OBSTACLE_POS[k])
            objs.append(o)
    elif scene == "base":
        kinds = ["mesh", "box", "sphere", "box", "box", "box"]
        rgbs = np.array([[240, 210, 60], [150, 120, 90], [200, 60, 60],
                         [120, 40, 40], [120, 40, 40], [120, 40, 40]])
        objs = []
        for k in range(6):
            o = dict(kind=kinds[k], pos=_BASE_OBSTACLE_POS[k], half=_BASE_OBSTACLE_HALF[k],
                     radius=_BASE_OBSTACLE_R[k], rgb=rgbs[k])
            if o["kind"] == "mesh":
                o["mesh"] = mesh_arrays(duck_mesh() + _BASE_OBSTACLE_POS[k])
            objs.append(o)
    else:
        raise ValueError(f"unknown scene {scene!r}")
    _SCENES[scene] = objs
    return objs


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 64
    height: int = 48
    fov_deg: float = 60.0
    aspect: float = 1.0
    far: float = 1000.0
    # The X-frame proxy's scale (its body sphere is 0.75 * arm);
    # ``frame_angle_deg`` is 45 for the X configuration (CF2X, RACE) and 0
    # for the plus configuration (CF2P).
    drone_radius: float = 0.08
    frame_angle_deg: float = 45.0
    with_landmarks: bool = True
    # "mesh": the 68-triangle cf2 silhouette; "xframe": two bars and a body
    # sphere; "auto": the mesh up to MESH_MAX_DRONES scene drones, then xframe.
    drone_proxy: str = "auto"
    # The obstacle world drawn when with_landmarks: "rl" or "base".
    scene: str = "rl"


def use_mesh_proxy(cfg: CameraConfig, num_drones: int) -> bool:
    return cfg.drone_proxy == "mesh" or (cfg.drone_proxy == "auto"
                                         and num_drones <= MESH_MAX_DRONES)


def _rounded(x, dtype):
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def tan_half_fov(cfg: CameraConfig, dtype=torch.float32) -> float:
    """tan(fov / 2) as the JAX package forms it in ``dtype``: the angle times
    pi / 180, halved, then the tangent, each rounded to ``dtype``."""
    half = _rounded(_rounded(cfg.fov_deg * _rounded(math.pi / 180.0, dtype), dtype) / 2.0, dtype)
    return _rounded(math.tan(half), dtype)


def frame_rotation(cfg: CameraConfig, dtype=torch.float32):
    """(cos, sin) of the X-frame's bar angle, rounded to ``dtype``."""
    ang = _rounded(cfg.frame_angle_deg * _rounded(math.pi / 180.0, dtype), dtype)
    return _rounded(math.cos(ang), dtype), _rounded(math.sin(ang), dtype)


def _ray_sphere(origin, direction, center, radius_sq):
    """Smallest positive hit distance (inf on a miss); ``radius_sq`` is the
    squared radius. Shapes broadcast."""
    oc = origin - center
    b = _dot(direction, oc)
    c = _dot(oc, oc) - radius_sq
    disc = b * b - c
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sqrt_d
    t1 = -b + sqrt_d
    t = torch.where(t0 > 1e-4, t0, t1)
    return torch.where((disc > 0) & (t > 1e-4), t, torch.full_like(t, float("inf")))


def _ray_aabb(oc, dd, half):
    """Ray against an axis-aligned box centred at the origin (slab test).

    ``oc``, ``dd``: (..., 3) ray origin and direction in the box frame;
    ``half``: (..., 3) or (3,) half extents. Returns (t, axis): the entry
    distance (inf on a miss; a ray starting inside counts as a miss) and the
    slab axis of the entry face, the first on ties."""
    inv = 1.0 / torch.where(torch.abs(dd) > 1e-9, dd, torch.full_like(dd, 1e-9))
    t1 = (-half - oc) * inv
    t2 = (half - oc) * inv
    tlo = torch.minimum(t1, t2)
    thi = torch.maximum(t1, t2)
    tmin = torch.amax(tlo, dim=-1)
    tmax = torch.amin(thi, dim=-1)
    hit = (tmax >= tmin) & (tmin > 1e-4)
    axis = torch.argmax(tlo, dim=-1)
    return torch.where(hit, tmin, torch.full_like(tmin, float("inf"))), axis


def _rt_apply(R, v):
    """R^T v over trailing axes: out_i = R[0, i] v0 + R[1, i] v1 + R[2, i] v2."""
    return torch.stack([R[..., 0, i] * v[..., 0] + R[..., 1, i] * v[..., 1]
                        + R[..., 2, i] * v[..., 2] for i in range(3)], -1)


def _take(x, idx):
    """``x`` (..., K, *rest) at the index ``idx`` (...) along axis ``idx.ndim``."""
    rest = x.shape[idx.ndim + 1:]
    gather_idx = idx.reshape(idx.shape + (1,) * (1 + len(rest))).expand(
        idx.shape + (1,) + rest)
    return torch.gather(x, idx.ndim, gather_idx).squeeze(idx.ndim)


def _const(x, like):
    """A numpy constant as a tensor of ``like``'s dtype and device (float64
    values rounded once, as JAX rounds them)."""
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def render_drone_views_plain(pos, quat, arm, cam, cfg: CameraConfig):
    """The plain version of K7 on (B, N, 3) positions, (B, N, 4) xyzw quats,
    (B,) arms and the camera drones ``cam`` (a list of C drone indices):
    ``(rgba (B, C, H, W, 4) uint8, dep (B, C, H, W) float32, seg (B, C, H, W)
    int32)``. Each of the B worlds holds its own N drones. It computes in
    ``pos``'s dtype (K7 in float32 only), as the JAX package computes in its
    state's."""
    B, N = pos.shape[0], pos.shape[1]
    H, W = cfg.height, cfg.width
    dev, dt = pos.device, pos.dtype
    inf = float("inf")
    sel = torch.as_tensor(cam, dtype=torch.long, device=dev)
    C = sel.shape[0]
    arm = arm.to(dt)
    armb = arm[:, None]  # (B, 1): broadcasts over the cameras
    tan_half = tan_half_fov(cfg, dt)

    R_all = quat_to_matrix(quat)  # (B, N, 3, 3)
    R = R_all[:, sel]  # (B, C, 3, 3)
    p_cam = pos[:, sel]  # (B, C, 3)
    eye = torch.stack([p_cam[..., 0], p_cam[..., 1], p_cam[..., 2] + armb], -1)
    forward = R[..., :, 0]
    fwd = forward / torch.sqrt(_dot(forward, forward))[..., None]
    up = torch.zeros_like(fwd)
    up[..., 2] = 1.0
    right = _cross(fwd, up)
    right = right / torch.clamp(torch.sqrt(_dot(right, right)), min=1e-6)[..., None]
    cam_up = _cross(right, fwd)

    # The pixel grid in NDC; y runs top to bottom as in getCameraImage.
    xs = _div(torch.arange(W, device=dev, dtype=dt) + 0.5, W) * 2.0 - 1.0
    ys = 1.0 - _div(torch.arange(H, device=dev, dtype=dt) + 0.5, H) * 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    bc = (slice(None), slice(None), None, None, slice(None))  # (B, C, 1, 1, 3)
    d = (fwd[bc] + px[..., None] * tan_half * cfg.aspect * right[bc]
         + py[..., None] * tan_half * cam_up[bc])  # (B, C, H, W, 3)
    d = d / torch.sqrt(_dot(d, d))[..., None]
    o = eye[bc].expand(d.shape)

    # --- ground plane z = 0 (id 0, a checker) ------------------------------
    t_plane = torch.where(d[..., 2] < -1e-6, -o[..., 2] / d[..., 2],
                          torch.full_like(d[..., 2], inf))
    hit_plane = o + d * t_plane[..., None]
    checker = torch.remainder(torch.floor(hit_plane[..., 0]) + torch.floor(hit_plane[..., 1]),
                              2.0)
    plane_rgb = torch.where(checker[..., None] > 0.5, _const([150.0, 150.0, 150.0], d),
                            _const([120.0, 130.0, 120.0], d))
    finite = torch.isfinite(t_plane)
    best_t = t_plane
    best_id = torch.where(finite, 0, -1).to(torch.int32)
    best_rgb = torch.where(finite[..., None], plane_rgb, torch.zeros_like(plane_rgb))

    def consider(t, obj_id, rgb):
        nonlocal best_t, best_id, best_rgb
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, obj_id, best_id).to(torch.int32)
        best_rgb = torch.where(closer[..., None], rgb, best_rgb)

    # --- the other drones (ids 1..N) -----------------------------------------
    # Hits in each drone's body frame: oc_b = R^T (o - pos), dd_b = R^T d.
    nb = (slice(None), None, None, None, slice(None))  # (B, 1, 1, 1, N, ...)
    self_mask = (sel[:, None] == torch.arange(N, device=dev)[None, :])[None, :, None, None, :]
    oc_w = o[..., None, :] - pos[nb]  # (B, C, H, W, N, 3)
    ar6 = arm.reshape(B, 1, 1, 1, 1, 1)
    if use_mesh_proxy(cfg, N):
        v0u, e1u, e2u, nrm = (_const(a, d) for a in mesh_arrays(
            cf2_mesh(1.0, cfg.frame_angle_deg)))
        Rn = R_all[nb]
        oc_b = _rt_apply(Rn, oc_w)
        dd_b = _rt_apply(Rn, d[..., None, :].expand(oc_w.shape))
        # (B, C, H, W, N, T); the unit mesh scaled by each world's arm
        scale = ar6[..., None]
        t_tri = ray_tris(oc_b, dd_b, v0u * scale, e1u * scale, e2u * scale)
        t_drone = torch.amin(t_tri, dim=-1)
        t_drone = torch.where(self_mask, inf, t_drone)
        j_min = torch.argmin(t_drone, dim=-1)  # (B, C, H, W)
        t_d = _take(t_drone, j_min)
        k_hit = _take(torch.argmin(t_tri, dim=-1), j_min)
        n_local = nrm[k_hit]  # (B, C, H, W, 3)
        R_hit = _take(R_all[:, None, None, None].expand(B, C, H, W, N, 3, 3), j_min)
        n_z = torch.abs(R_hit[..., 2, 0] * n_local[..., 0] + R_hit[..., 2, 1] * n_local[..., 1]
                        + R_hit[..., 2, 2] * n_local[..., 2])
    else:
        ca, sa = frame_rotation(cfg, dt)
        rz = _const([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]], d)
        U = torch.stack([torch.stack([R_all[..., i, 0] * rz[0, k] + R_all[..., i, 1] * rz[1, k]
                                      + R_all[..., i, 2] * rz[2, k] for k in range(3)], -1)
                         for i in range(3)], -2)  # (B, N, 3, 3): R rz
        bar_len, bar_wid, bar_hgt = 1.6 * ar6, 0.3 * ar6, 0.2 * ar6  # (B, 1, 1, 1, 1, 1)
        body_r = 0.75 * arm  # (B,)
        Un = U[nb]
        oc_b = _rt_apply(Un, oc_w)
        dd_b = _rt_apply(Un, d[..., None, :].expand(oc_w.shape))
        half_a = torch.cat([bar_len, bar_wid, bar_hgt], -1)
        half_b = torch.cat([bar_wid, bar_len, bar_hgt], -1)
        t_bar_a, ax_a = _ray_aabb(oc_b, dd_b, half_a)
        t_bar_b, ax_b = _ray_aabb(oc_b, dd_b, half_b)
        br = body_r.reshape(B, 1, 1, 1, 1)
        t_sph = _ray_sphere(o[..., None, :], d[..., None, :], pos[nb], br * br)
        t_prims = torch.stack([t_bar_a, t_bar_b, t_sph], -1)  # (B, C, H, W, N, 3)
        t_drone = torch.where(self_mask, inf, torch.amin(t_prims, dim=-1))
        j_min = torch.argmin(t_drone, dim=-1)
        t_d = _take(t_drone, j_min)
        prim = torch.argmin(_take(t_prims, j_min), dim=-1)  # 0 bar A, 1 bar B, 2 body
        U_hit = _take(Un.expand(B, C, H, W, N, 3, 3), j_min)
        ax_hit = torch.where(prim == 0, _take(ax_a, j_min), _take(ax_b, j_min))
        n_bar_z = torch.gather(U_hit[..., 2, :], -1, ax_hit[..., None])[..., 0]
        hit_center = _take(pos[nb].expand(B, C, H, W, N, 3), j_min)
        n_sph = (o + d * t_d[..., None]) - hit_center
        n_z = torch.where(prim == 2, n_sph[..., 2] / br[..., 0], torch.abs(n_bar_z))
    shade = torch.clamp(0.35 + 0.65 * n_z, 0.2, 1.0)
    rgb_d = torch.stack([80.0 * shade, 80.0 * shade, 90.0 * shade], -1) + 100.0
    consider(t_d, (j_min + 1).to(torch.int32), rgb_d)

    # --- landmarks (ids N+1..) ------------------------------------------------
    if cfg.with_landmarks:
        for k, obj in enumerate(_scene_objects(cfg.scene)):
            c = _const(obj["pos"], d)
            if obj["kind"] == "box":
                t_k, ax_k = _ray_aabb(o - c, d, _const(obj["half"], d))
                # the entry face's world normal is +-e_axis: top faces bright
                shade = torch.where(ax_k == 2, 1.0, torch.where(ax_k == 0, 0.7, 0.55))
            elif obj["kind"] == "sphere":
                r = float(obj["radius"])
                t_k = _ray_sphere(o, d, c, r ** 2)
                n_k = (o + d * t_k[..., None]) - c
                shade = torch.clamp(0.4 + _div(0.6 * n_k[..., 2], r), 0.3, 1.0)
            else:
                v0k, e1k, e2k, nk = (_const(a, d) for a in obj["mesh"])
                t_tri_k = ray_tris(o, d, v0k, e1k, e2k)  # (B, C, H, W, T)
                t_k = torch.amin(t_tri_k, dim=-1)
                nz_k = torch.abs(nk[:, 2][torch.argmin(t_tri_k, dim=-1)])
                shade = torch.clamp(0.4 + 0.6 * nz_k, 0.3, 1.0)
            rgb_k = _const(obj["rgb"], d) * shade[..., None]
            consider(t_k, N + 1 + k, rgb_k)

    # --- sky ------------------------------------------------------------------
    miss = ~torch.isfinite(best_t)
    rgb = torch.where(miss[..., None], _const([135.0, 180.0, 235.0], d), best_rgb)
    rgba = torch.cat([rgb, torch.full_like(best_t, 255.0)[..., None]], -1).to(torch.uint8)

    # OpenGL's depth buffer value (getCameraImage):
    # (1/near - 1/z) / (1/near - 1/far); the background is 1.0.
    near = armb[..., None, None]  # (B, 1, 1, 1)
    z_eye = _dot(d, fwd[bc]) * best_t
    z_eye = torch.minimum(torch.maximum(z_eye, near), torch.tensor(cfg.far, dtype=dt, device=dev))
    dep = (1.0 / near - 1.0 / z_eye) / (1.0 / near - 1.0 / cfg.far)
    dep = torch.where(miss, 1.0, dep).to(torch.float32)
    seg = torch.where(miss, -1, best_id).to(torch.int32)
    return rgba, dep, seg


def render_drone_views(pos, quat, arm, cfg: CameraConfig = CameraConfig(), cam_indices=None):
    """(..., N, 3) positions + (..., N, 4) xyzw quats -> ``(rgba (..., C, H,
    W, 4) uint8, dep (..., C, H, W) float32, seg (..., C, H, W) int32)``.

    Each entry of the leading axes is a world of its own: its N drones
    populate its scene (ids 1..N), and the cameras ride the drones
    ``cam_indices`` selects (an int or a sequence; all N by default, C = N).
    ``arm`` is a float or a tensor broadcastable to the leading axes. CUDA
    tensors launch K7; CPU tensors run ``render_drone_views_plain``."""
    from gym_pybullet_drones_tpu_torch.ops.render_views import render_views

    pos, quat = torch.as_tensor(pos), torch.as_tensor(quat)
    batch, N = pos.shape[:-2], pos.shape[-2]
    if cam_indices is None:
        cam = list(range(N))
    else:
        cam = [int(i) for i in np.atleast_1d(np.asarray(cam_indices))]
    arm = torch.as_tensor(arm, dtype=pos.dtype, device=pos.device).expand(batch)
    rgba, dep, seg = render_views(pos.reshape((-1, N, 3)), quat.reshape((-1, N, 4)),
                                  arm.reshape(-1), cam, cfg)
    tail = (len(cam), cfg.height, cfg.width)
    return (rgba.reshape(batch + tail + (4,)), dep.reshape(batch + tail),
            seg.reshape(batch + tail))


def export_image(img_type: ImageType, img_input, path: str, frame_num: int = 0):
    """PNG export with the reference's per-type normalizations
    (BaseAviary._exportImage, :624-654)."""
    from PIL import Image

    if isinstance(img_input, torch.Tensor):
        img_input = img_input.detach().cpu().numpy()
    img_input = np.asarray(img_input)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"frame_{frame_num}.png")
    if img_type == ImageType.RGB:
        Image.fromarray(img_input.astype("uint8"), "RGBA").save(out)
        return out
    if img_type in (ImageType.DEP, ImageType.SEG):
        lo, hi = img_input.min(), img_input.max()
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        temp = ((img_input - lo) * scale).astype("uint8")
    elif img_type == ImageType.BW:
        temp = (np.sum(img_input[:, :, 0:2], axis=2) / 3).astype("uint8")
    else:
        raise ValueError(f"unknown ImageType {img_type}")
    Image.fromarray(temp).save(out)
    return out
