"""The port's camera (render/meshes.py, render/camera.py) against the JAX
package's on the CPU: the meshes array for array, the ray caster, the
renders at tests/test_render.py's poses and at seeded random poses (both
drone proxies, both scenes, cam_indices, batches of worlds), the batching
rule of the render operator, and the wrappers' device rules.

Both packages render in float32 here (the JAX reference with x64 off inside
the test). The limits are those the port's kernel K7 is held to against its
plain version on the card: seg equal on at least 99.9 % of the pixels, and
where seg agrees, rgba within 1 and depth within 1e-6. XLA's CPU backend
contracts multiply-adds into FMAs (the port's plain version rounds each
operation), so a ray can land a last ulp apart: a plane pixel at a grazing
angle, where one pixel spans many checker squares, can take the other
colour, and a slab test of a near-parallel ray can move its depth. At the
random poses such pixels may make up at most 0.1 % of those where seg
agrees; at tests/test_render.py's poses there are none."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.core.rotations import euler_xyz_to_quat as jeuler
from gym_pybullet_drones_tpu.render import camera as jcam
from gym_pybullet_drones_tpu.render import meshes as jmesh
from gym_pybullet_drones_tpu_torch.envs.spec import ImageType
from gym_pybullet_drones_tpu_torch.ops import render_views as trv
from gym_pybullet_drones_tpu_torch.render import camera as tcam
from gym_pybullet_drones_tpu_torch.render import meshes as tmesh

ARM = 0.0397  # CF2X
SEG_SHARE = 0.999  # seg equal on at least this share of the pixels
RGBA_ATOL, DEP_ATOL = 1, 1e-6  # where seg agrees
FMA_SHARE = 0.001  # at random poses: seg-agreeing pixels allowed past those


def _jax_render(pos, quat, cfg=None, cam=None):
    """JAX's render in float32; ``pos``/``quat`` (..., N, 3/4) with the
    leading axes vmapped (each world alone, as the env batch)."""
    jcfg = jcam.CameraConfig(**(cfg or {}))
    with jax.enable_x64(False):
        fn = lambda p, q: jcam.render_drone_views(p, q, jnp.float32(ARM), jcfg, cam_indices=cam)
        for _ in range(np.ndim(pos) - 2):
            fn = jax.vmap(fn)
        out = jax.jit(fn)(jnp.asarray(pos, jnp.float32), jnp.asarray(quat, jnp.float32))
        return [np.asarray(x) for x in out]


def _port_render(pos, quat, cfg=None, cam=None):
    out = tcam.render_drone_views(torch.as_tensor(np.array(pos, np.float32)),
                                  torch.as_tensor(np.array(quat, np.float32)), ARM,
                                  tcam.CameraConfig(**(cfg or {})), cam_indices=cam)
    return [x.numpy() for x in out]


def _compare(got, want, fma_share=0.0):
    """Holds the three outputs at the limits; returns (seg differs,
    seg-agreeing pixels past the rgba or depth limit)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    same = got[2] == want[2]
    seg_diff = int((~same).sum())
    assert same.mean() >= SEG_SHARE, f"seg differs on {seg_diff} of {same.size} pixels"
    rgba_gap = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32)).max(-1)
    past = same & ((rgba_gap > RGBA_ATOL) | (np.abs(got[1] - want[1]) > DEP_ATOL))
    assert past.sum() <= fma_share * same.sum(), (
        f"{int(past.sum())} of {int(same.sum())} seg-agreeing pixels past rgba {RGBA_ATOL} / "
        f"depth {DEP_ATOL}")
    return seg_diff, int(past.sum())


def _quat_z(yaw):
    return [0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2)]


Q0 = [0.0, 0.0, 0.0, 1.0]
_LINE = np.stack([np.linspace(0, 3, 12), np.zeros(12), np.full(12, 0.3)], -1)
# tests/test_render.py's poses: (pos, quat, CameraConfig fields, cam_indices)
POSES = {
    "level": ([[0, 0, 0.5]], [Q0], dict(with_landmarks=False), None),
    "drone_ahead": ([[0, 0, 1.0], [1, 0, 1.0]], [Q0, Q0], dict(with_landmarks=False), None),
    "landmark_ahead": ([[0, 0, 0.3]], [Q0], {}, None),
    "block_aspect": ([[0.4, 0, 0.1]], [Q0], dict(width=128, height=96), None),
    "mesh_tilted": ([[0, 0, 0.3], [0.5, 0, 0.3]],
                    [Q0, [math.sin(0.2), 0, 0, math.cos(0.2)]], {}, 0),
    "duck": ([[-2, 0, 0.2]], [Q0], {}, None),
    "teddy": ([[0, -2, 0.2]], [_quat_z(math.pi / 2)], {}, None),
    "xframe_12": (_LINE, [Q0] * 12, {}, 0),
    "xframe_12_all": (_LINE, [Q0] * 12, {}, None),
    "base_scene": ([[0, 1, 0.6]], [_quat_z(-math.pi / 2)], dict(scene="base"), None),
    "cam_indices_2": ([[0, 0, 0.5], [1, 0, 0.5], [0.3, 0, 0.5]], [Q0] * 3, {}, 2),
    "proxy_yaw_45": ([[0, 0, 0.3], [0.25, 0, 0.3]], [Q0, _quat_z(math.pi / 4)],
                     dict(with_landmarks=False), None),
    "cf2p_frame": ([[0, 0, 0.3], [0.3, 0.02, 0.32]], [Q0, _quat_z(0.3)],
                   dict(frame_angle_deg=0.0), None),
    "xframe_forced": ([[0, 0, 0.3], [0.4, 0.05, 0.35]], [Q0, _quat_z(0.5)],
                      dict(drone_proxy="xframe"), None),
}


def test_meshes_equal_jax_array_for_array():
    for subdiv in (0, 1):
        for a, b in zip(tmesh.icosphere(subdiv), jmesh.icosphere(subdiv)):
            np.testing.assert_array_equal(a, b)
    meshes = [(tmesh.duck_mesh(), jmesh.duck_mesh()), (tmesh.teddy_mesh(), jmesh.teddy_mesh())]
    for angle in (45.0, 0.0):
        for arm in (1.0, ARM):
            meshes.append((tmesh.cf2_mesh(arm, angle), jmesh.cf2_mesh(arm, angle)))
    assert [len(m[0]) for m in meshes[:3]] == [72, 160, 68]
    for got, want in meshes:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        for a, b in zip(tmesh.mesh_arrays(got), jmesh.mesh_arrays(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for deg in (0.0, 30.0, 45.0):
        np.testing.assert_array_equal(tmesh._rot_z(deg), jmesh._rot_z(deg))


def test_ray_tris_matches_jax():
    """Seeded rays from around the teddy mesh toward it: distances at rtol
    1e-6 (a few float32 ulps), the misses (inf) in the same places, and
    enough hits to mean something."""
    rng = np.random.default_rng(0)
    v0, e1, e2, _ = tmesh.mesh_arrays(tmesh.teddy_mesh())
    o = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d = (rng.uniform(-0.1, 0.1, (64, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tmesh.ray_tris(*(torch.as_tensor(x) for x in (o, d, v0, e1, e2))).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(jmesh.ray_tris)(*(jnp.asarray(x) for x in (o, d, v0, e1, e2))))
    assert got.shape == want.shape == (64, 160)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isfinite(got).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", list(POSES))
def test_render_matches_jax_at_the_reference_poses(name):
    pos, quat, cfg, cam = POSES[name]
    got, want = _port_render(pos, quat, cfg, cam), _jax_render(pos, quat, cfg, cam)
    H, W = cfg.get("height", 48), cfg.get("width", 64)
    C = len(pos) if cam is None else 1
    assert got[0].shape == (C, H, W, 4) and got[0].dtype == np.uint8
    assert got[1].dtype == np.float32 and got[2].dtype == np.int32
    assert (got[0][..., 3] == 255).all()
    _compare(got, want)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("proxy,scene", [("auto", "rl"), ("xframe", "rl"), ("mesh", "base"),
                                         ("auto", "base")])
def test_render_matches_jax_at_random_poses(proxy, scene):
    """Two worlds of three drones each at seeded poses (tilts up to ~0.6
    rad, heights 0.05-1.5 m), every drone a camera; and one world without
    landmarks."""
    rng = np.random.default_rng(11)
    pos = rng.uniform([-1.5, -1.5, 0.05], [1.5, 1.5, 1.5], (2, 3, 3))
    q = rng.normal(size=(2, 3, 4))
    q = 0.3 * q / np.linalg.norm(q, axis=-1, keepdims=True) + np.array(Q0)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cfg = dict(drone_proxy=proxy, scene=scene)
    got, want = _port_render(pos, q, cfg), _jax_render(pos, q, cfg)
    assert got[0].shape == (2, 3, 48, 64, 4)
    seen = set(np.unique(got[2]))
    assert {-1, 0} <= seen and len(seen) > 3, seen  # sky, plane, drones or landmarks
    _compare(got, want, FMA_SHARE)
    bare = dict(cfg, with_landmarks=False)
    _compare(_port_render(pos[0], q[0], bare), _jax_render(pos[0], q[0], bare), FMA_SHARE)


def test_each_world_sees_only_its_own_drones():
    """Two worlds: world 1's second drone hovers 0.5 m in front of world 0's
    camera. World 0 must not see it (nor its own second drone, placed
    behind); world 1's camera, at that drone's place in its own world, sees
    its own world's layout. Each world renders as it renders alone."""
    pos = np.array([[[0, 0, 0.5], [-1.0, 0, 0.5]], [[0, 0, 0.5], [0.5, 0, 0.5]]], np.float32)
    quat = np.tile(np.array(Q0, np.float32), (2, 2, 1))
    rgba, dep, seg = _port_render(pos, quat, dict(with_landmarks=False))
    assert not (seg[0, 0] == 2).any()
    assert (seg[1, 0] == 2).sum() > 3  # the same pose in world 1 sees its drone 2
    for w in range(2):
        alone = _port_render(pos[w], quat[w], dict(with_landmarks=False))
        for a, b in zip((rgba[w], dep[w], seg[w]), alone):
            np.testing.assert_array_equal(a, b)


def test_leading_axes_and_cam_indices():
    rng = np.random.default_rng(2)
    pos = rng.uniform([-1, -1, 0.2], [1, 1, 1], (2, 2, 3, 3))
    quat = np.tile(np.array(Q0), (2, 2, 3, 1))
    full = _port_render(pos, quat)
    assert full[0].shape == (2, 2, 3, 48, 64, 4) and full[2].shape == (2, 2, 3, 48, 64)
    one = _port_render(pos, quat, cam=2)
    two = _port_render(pos, quat, cam=[2, 0])
    for f, o, t in zip(full, one, two):
        np.testing.assert_array_equal(f[:, :, 2:3], o)
        np.testing.assert_array_equal(f[:, :, [2, 0]], t)


def test_render_under_vmap_is_one_batched_call():
    """torch.func.vmap over render_drone_views (the per-env step's path)
    equals the batched call, through the operator's batching rule, with a
    mapped and an unmapped arm."""
    rng = np.random.default_rng(3)
    pos = torch.as_tensor(rng.uniform([-1, -1, 0.2], [1, 1, 1], (3, 2, 3)), dtype=torch.float32)
    quat = torch.as_tensor(np.tile(np.array(Q0), (3, 2, 1)), dtype=torch.float32)
    arm = torch.full((3,), ARM)
    batched = tcam.render_drone_views(pos, quat, arm)
    for in_dims in ((0, 0, 0), (0, 0, None)):
        a = arm if in_dims[2] == 0 else torch.tensor(ARM)
        mapped = torch.func.vmap(tcam.render_drone_views, in_dims=in_dims)(pos, quat, a)
        for m, b in zip(mapped, batched):
            assert torch.equal(m, b)


def test_config_fields_and_proxy_rule_equal_jax():
    fields = lambda cls: [(f.name, f.default) for f in cls.__dataclass_fields__.values()]
    assert fields(tcam.CameraConfig) == fields(jcam.CameraConfig)
    cfg = tcam.CameraConfig()
    assert tcam.use_mesh_proxy(cfg, 8) and not tcam.use_mesh_proxy(cfg, 9)
    assert not tcam.use_mesh_proxy(tcam.CameraConfig(drone_proxy="xframe"), 1)
    assert tcam.use_mesh_proxy(tcam.CameraConfig(drone_proxy="mesh"), 30)
    with jax.enable_x64(False):
        want = float(jnp.tan(jnp.deg2rad(jnp.float32(60.0)) / 2.0))
    assert abs(tcam.tan_half_fov(cfg) - want) <= 1.2e-7 * want
    for scene in ("rl", "base"):
        t, j = tcam._scene_objects(scene), jcam._scene_objects(scene)
        assert [o["kind"] for o in t] == [o["kind"] for o in j]
        for a, b in zip(t, j):
            for k in ("pos", "half", "radius", "rgb"):
                np.testing.assert_array_equal(a[k], b[k])
            for x, y in zip(a.get("mesh", ()), b.get("mesh", ())):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="unknown scene"):
        tcam._scene_objects("moon")


def test_scene_tables_pack_the_scene():
    cf2, objs, tris = trv.scene_tables("rl", True, 45.0)
    assert cf2.shape == (68, 12) and objs.shape == (4, 16) and tris.shape == (232, 12)
    assert objs[:, 0].tolist() == [0, 0, 2, 2]  # block, cube: boxes; duck, teddy: meshes
    assert objs[2, 12:14].tolist() == [0, 72] and objs[3, 12:14].tolist() == [72, 160]
    _, objs_b, tris_b = trv.scene_tables("base", True, 45.0)
    assert objs_b[:, 0].tolist() == [2, 0, 1, 0, 0, 0] and tris_b.shape == (72, 12)
    assert objs_b[2, 8] == np.float32(0.25)
    _, none, no_tris = trv.scene_tables("rl", False, 0.0)
    assert none.shape == (0, 16) and no_tris.shape == (0, 12)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On the CPU the operator runs the plain version because the tensors
    lie there; K7's own wrapper refuses them (a CUDA tensor launches K7 or
    raises, with no fallback)."""
    pos = torch.zeros((1, 1, 3))
    quat = torch.tensor([[Q0]])
    with pytest.raises(ValueError, match="CUDA"):
        trv.render_views_cuda(pos, quat, torch.full((1,), ARM), [0], tcam.CameraConfig())
    before = trv.render_views_cuda.launches
    tcam.render_drone_views(pos[0] + 0.5, quat[0], ARM)
    assert trv.render_views_cuda.launches == before


def test_export_image(tmp_path):
    rgba, dep, seg = tcam.render_drone_views(torch.tensor([[0.0, 0.0, 1.0]]),
                                             torch.tensor([Q0]), ARM)
    for i, (kind, img) in enumerate(((ImageType.RGB, rgba[0]), (ImageType.DEP, dep[0]),
                                     (ImageType.SEG, seg[0]), (ImageType.BW, rgba[0]))):
        out = tcam.export_image(kind, img, str(tmp_path), i)
        assert out.endswith(f"frame_{i}.png") and (tmp_path / f"frame_{i}.png").exists()


def test_attitude_changes_the_silhouette():
    """tests/test_render.py's attitude property through the port: a scene
    drone's yaw changes its pixels (both proxies)."""
    pos = np.array([[0.0, 0.0, 0.3], [0.25, 0.0, 0.3]])
    for proxy in ("mesh", "xframe"):
        masks = []
        for yaw in (0.0, math.pi / 4):
            with jax.enable_x64(False):
                quat = np.asarray(jeuler(jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, yaw]],
                                                     jnp.float32)))
            seg = _port_render(pos, quat, dict(with_landmarks=False, drone_proxy=proxy))[2]
            masks.append(seg[0] == 2)
        assert masks[0].any() and masks[1].any() and (masks[0] != masks[1]).any(), proxy
