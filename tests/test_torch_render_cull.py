"""K7's cull (ops/render_views.tile_lists, the rule csrc/render_views.cu
follows) on the CPU: every primitive a tile leaves out returns inf on every
ray of the tile, so walking the kept ones in scene order gives the plain
version's picture bit for bit.

For seeded views like chip_smoke.py phase 10b's (a1)-(a4) and for edge
views (cameras inside the duck's and the teddy's bounding spheres, rays
grazing a box's top face and a drone's prop discs, a drone 0.2 m ahead, 37 x
23 and 1 x 1 images), each pixel's ray is tested against every primitive
with the plain version's arithmetic (render/camera.py, render/meshes.py):
every primitive it hits, and so the one render_drone_views_plain picks, must
be kept by the pixel's tile. The padded bounding spheres must hold every
vertex they bound. The card's tests (tests/test_torch_cuda.py) hold K7 equal
to the plain version bit for bit on the same views."""

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu_torch.core.rotations import quat_to_matrix
from gym_pybullet_drones_tpu_torch.ops import render_views as trv
from gym_pybullet_drones_tpu_torch.ops.velocity_soa import _div
from gym_pybullet_drones_tpu_torch.render import camera as tcam
from gym_pybullet_drones_tpu_torch.render.meshes import _cross, _dot, ray_tris
from torch_render_views import ARM, VIEWS, views

# The views at a quarter of their pixels (CPU time), but for the odd sizes.
SMALL = dict(width=32, height=24)


def _rays(pos, quat, arm, cam, cfg):
    """Each pixel's (o, d) (B, C, H, W, 3), in render_drone_views_plain's
    operations."""
    H, W = cfg.height, cfg.width
    sel = torch.as_tensor(cam)
    R = quat_to_matrix(quat)[:, sel]
    p_cam = pos[:, sel]
    eye = torch.stack([p_cam[..., 0], p_cam[..., 1], p_cam[..., 2] + arm[:, None]], -1)
    forward = R[..., :, 0]
    fwd = forward / torch.sqrt(_dot(forward, forward))[..., None]
    up = torch.zeros_like(fwd)
    up[..., 2] = 1.0
    right = _cross(fwd, up)
    right = right / torch.clamp(torch.sqrt(_dot(right, right)), min=1e-6)[..., None]
    cam_up = _cross(right, fwd)
    tan_half = tcam.tan_half_fov(cfg)
    xs = _div(torch.arange(W, dtype=pos.dtype) + 0.5, W) * 2.0 - 1.0
    ys = 1.0 - _div(torch.arange(H, dtype=pos.dtype) + 0.5, H) * 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    bc = (slice(None), slice(None), None, None, slice(None))
    d = (fwd[bc] + px[..., None] * tan_half * cfg.aspect * right[bc]
         + py[..., None] * tan_half * cam_up[bc])
    d = d / torch.sqrt(_dot(d, d))[..., None]
    return eye[bc].expand(d.shape), d


def _hits(pos, quat, arm, cam, cfg):
    """Which primitives each pixel's ray hits (a finite exact test): a dict
    of bools over (B, C, H, W, ...) keyed as ``tile_lists``' lists."""
    B, N = pos.shape[:2]
    o, d = _rays(pos, quat, arm, cam, cfg)
    cf2, objs, tris = (torch.as_tensor(t) for t in trv.scene_tables(
        cfg.scene, cfg.with_landmarks, cfg.frame_angle_deg))
    R_all = quat_to_matrix(quat)
    nb = (slice(None), None, None, None, slice(None))
    oc_w = o[..., None, :] - pos[nb]
    ar6 = arm.reshape(B, 1, 1, 1, 1, 1)
    out = {}
    if N == 1:
        out["drones"] = torch.zeros(d.shape[:-1] + (1,), dtype=torch.bool)
    elif tcam.use_mesh_proxy(cfg, N):
        Rn = R_all[nb]
        dd_w = d[..., None, :].expand(oc_w.shape)
        oc_b, dd_b = tcam._rt_apply(Rn, oc_w), tcam._rt_apply(Rn, dd_w)
        s = ar6[..., None]
        out["drone_tris"] = torch.isfinite(ray_tris(oc_b, dd_b, cf2[:, 0:3] * s, cf2[:, 3:6] * s,
                                                    cf2[:, 6:9] * s))
        out["drones"] = out["drone_tris"].any(-1)
    else:
        ca, sa = tcam.frame_rotation(cfg)
        rz = torch.tensor([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
        U = torch.stack([torch.stack([R_all[..., i, 0] * rz[0, k] + R_all[..., i, 1] * rz[1, k]
                                      + R_all[..., i, 2] * rz[2, k] for k in range(3)], -1)
                         for i in range(3)], -2)[nb]
        dd_w = d[..., None, :].expand(oc_w.shape)
        oc_b, dd_b = tcam._rt_apply(U, oc_w), tcam._rt_apply(U, dd_w)
        half_a = torch.cat([1.6 * ar6, 0.3 * ar6, 0.2 * ar6], -1)
        half_b = torch.cat([0.3 * ar6, 1.6 * ar6, 0.2 * ar6], -1)
        br = (0.75 * arm).reshape(B, 1, 1, 1, 1)
        t = torch.stack([tcam._ray_aabb(oc_b, dd_b, half_a)[0],
                         tcam._ray_aabb(oc_b, dd_b, half_b)[0],
                         tcam._ray_sphere(o[..., None, :], d[..., None, :], pos[nb], br * br)], -1)
        out["drones"] = torch.isfinite(t).any(-1)
    own = (torch.as_tensor(cam)[:, None] == torch.arange(N)[None, :])[None, :, None, None]
    out["drones"] &= ~own
    if "drone_tris" in out:
        out["drone_tris"] &= ~own[..., None]
    hit_obj, hit_tri = [], []
    for obj in objs:
        c = obj[1:4]
        if int(obj[0]) == 0:
            hit_obj.append(torch.isfinite(tcam._ray_aabb(o - c, d, obj[4:7])[0]))
        elif int(obj[0]) == 1:
            hit_obj.append(torch.isfinite(tcam._ray_sphere(o, d, c, float(obj[8]))))
        else:
            rows = tris[int(obj[12]):int(obj[12] + obj[13])]
            hit = torch.isfinite(ray_tris(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]))
            hit_tri.append(hit)
            hit_obj.append(hit.any(-1))
    lead = d.shape[:-1]
    out["objects"] = torch.stack(hit_obj, -1) if hit_obj else torch.zeros(lead + (0,), dtype=bool)
    out["tris"] = torch.cat(hit_tri, -1) if hit_tri else torch.zeros(lead + (0,), dtype=bool)
    return out


def _per_pixel(lists, H, W):
    """Tile lists (B, C, TY, TX, ...) spread over the pixels (B, C, H, W, ...)."""
    ty = torch.arange(H) // trv.TILE_H
    tx = torch.arange(W) // trv.TILE_W
    return lists[:, :, ty][:, :, :, tx]


@pytest.mark.parametrize("view", list(VIEWS))
def test_every_hit_primitive_is_in_its_tiles_list(view):
    make, extra = VIEWS[view]
    pos, quat, arm = make()
    cfg = tcam.CameraConfig(**{**SMALL, **extra})
    cam = list(range(pos.shape[1]))
    lists = trv.tile_lists(pos, quat, arm, cam, cfg)
    hits = _hits(pos, quat, arm, cam, cfg)
    for key, hit in hits.items():
        kept = _per_pixel(lists[key], cfg.height, cfg.width)
        assert kept.shape == hit.shape, key
        lost = hit & ~kept
        assert not bool(lost.any()), f"{key}: {int(lost.sum())} hits culled"
    # The plain version's pick, its seg id: that drone or object is kept.
    seg = tcam.render_drone_views_plain(pos, quat, arm, cam, cfg)[2]
    N = pos.shape[1]
    drones = _per_pixel(lists["drones"], cfg.height, cfg.width)
    objects = _per_pixel(lists["objects"], cfg.height, cfg.width)
    is_drone, is_obj = (seg >= 1) & (seg <= N), seg > N
    picked = torch.gather(drones, -1, (seg.clamp(1, N) - 1)[..., None])[..., 0]
    assert bool(picked[is_drone].all())
    if objects.shape[-1]:
        idx = (seg - N - 1).clamp(0, objects.shape[-1] - 1)[..., None]
        assert bool(torch.gather(objects, -1, idx)[..., 0][is_obj].all())
    assert bool(is_drone.any() or is_obj.any()) or view == "one_pixel", "the view shows nothing"


def test_the_cull_leaves_few_landmark_triangles_a_tile():
    """(a1)'s views at their 64 x 48 pixels: a tile keeps a few of the 232
    landmark triangles (the point of the cull)."""
    pos, quat, arm = views("landmarks", 4, 1, 1)
    lists = trv.tile_lists(pos, quat, arm, [0], tcam.CameraConfig())
    assert lists["tris"].shape == (4, 1, 12, 8, 232)
    kept = float(lists["tris"].sum(-1).float().mean())
    assert 0 < kept < 0.1 * 232, kept


def test_padded_spheres_hold_every_vertex():
    """Every vertex of every landmark mesh lies inside its triangle's and its
    object's padded sphere; every vertex of the cf2 mesh at the scene's arm
    inside its triangle's sphere and the drone's (both scaled by the arm as
    K7 scales them); the X-frame's bar corners inside the bars' sphere."""
    for scene in ("rl", "base"):
        cf2, objs, tris = trv.scene_tables(scene, True, 45.0)
        cf2_sph, tri_sph, (r_mesh, r_bars, r_body) = trv.scene_bounds(scene, True, 45.0)
        assert tri_sph.shape == (len(tris), 4) and cf2_sph.shape == (68, 4)
        for rows, sph, scale in ((tris, tri_sph, 1.0), (cf2, cf2_sph, np.float32(ARM))):
            v0 = rows[:, 0:3] * scale
            verts = np.stack([v0, v0 + rows[:, 3:6] * scale, v0 + rows[:, 6:9] * scale], 1)
            gap = np.linalg.norm(verts - (sph[:, None, :3] * scale), axis=-1)
            assert (gap < (sph[:, 3] * scale)[:, None]).all(), scene
        v = cf2[:, 0:3][:, None] + np.stack([np.zeros((68, 3)), cf2[:, 3:6], cf2[:, 6:9]], 1)
        assert np.linalg.norm(v * np.float32(ARM), axis=-1).max() < r_mesh * ARM
        corner = np.array([1.6, 0.3, 0.2]) * ARM
        assert np.linalg.norm(corner) < r_bars * ARM and 0.75 < r_body
        for obj in objs:
            reach = float(obj[14])
            if int(obj[0]) == 2:
                rows = tris[int(obj[12]):int(obj[12] + obj[13])]
                verts = np.concatenate([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                                        rows[:, 0:3] + rows[:, 6:9]])
                assert np.linalg.norm(verts - obj[1:4], axis=-1).max() < reach
            elif int(obj[0]) == 0:
                assert np.linalg.norm(obj[4:7]) < reach
            else:
                assert obj[7] < reach
