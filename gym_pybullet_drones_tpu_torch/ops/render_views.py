"""The onboard camera on the card: kernel K7 and the dispatch to it.

``render_views(pos, quat, arm, cam, cfg)`` renders the cameras ``cam`` (drone
indices) of B worlds, ``pos`` (B, N, 3), ``quat`` (B, N, 4), ``arm`` (B,),
into ``(rgba (B, C, H, W, 4) uint8, dep (B, C, H, W) float32, seg (B, C, H,
W) int32)``. It goes through the custom operator ``gpbd_torch::render_views``:

* on CUDA tensors it launches K7 (``csrc/render_views.cu``, one thread per
  camera pixel, the best hit kept in registers), which stands for the JAX
  package's XLA-fused camera (gym_pybullet_drones_tpu/render/camera.py:177);
  a failed build or launch raises, and there is no fallback;
* on CPU tensors it runs ``render/camera.render_drone_views_plain``;
* under ``torch.func.vmap`` its batching rule folds the mapped axis into the
  worlds' axis B and calls the operator once on the whole batch, so the
  per-env step of domain-randomized params renders with one launch.
"""

import ctypes
import functools

import numpy as np
import torch

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

KERNEL = "render_views"
_KINDS = {"box": 0, "sphere": 1, "mesh": 2}
_OBJ_FLOATS = 16  # a landmark object's floats in the kernel (csrc/render_views.cu)


def _tri_rows(arrays):
    """(T, 12) float32 rows of ``mesh_arrays``: v0, e1, e2, unit normal."""
    return np.concatenate(arrays, axis=1).astype(np.float32)


@functools.cache
def scene_tables(scene: str, with_landmarks: bool, frame_angle_deg: float):
    """The kernel's scene as numpy tables: the unit cf2 mesh (68, 12), the
    landmark objects (M, 16: kind, pos, half, radius, float32 radius
    squared, rgb, first triangle, triangles) and their world-space triangles
    (T, 12), in ``_scene_objects`` order."""
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
        objs.append(row)
    objs = np.stack(objs) if objs else np.zeros((0, _OBJ_FLOATS), np.float32)
    tris = np.concatenate(tris) if tris else np.zeros((0, 12), np.float32)
    return cf2, objs, tris


@functools.cache
def _device_tables(scene, with_landmarks, frame_angle_deg, device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in scene_tables(scene, with_landmarks, frame_angle_deg))


@functools.cache
def _library():
    """K7's C entry point, built at first use and typed once."""
    fn = ctypes.CDLL(_build.build(KERNEL)).render_views
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, i, p, i, p, i, i, i, i, i, i, i, f, f, f, f, f, f, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


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
    cf2, objs, tris = _device_tables(cfg.scene, cfg.with_landmarks, cfg.frame_angle_deg, device)
    cam_t = torch.as_tensor(cam, dtype=torch.int32, device=device)
    rgba = torch.empty((B, C, H, W, 4), dtype=torch.uint8, device=device)
    dep = torch.empty((B, C, H, W), dtype=torch.float32, device=device)
    seg = torch.empty((B, C, H, W), dtype=torch.int32, device=device)
    ca, sa = frame_rotation(cfg)
    fn = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(pos.data_ptr(), quat.data_ptr(), arm.data_ptr(), cam_t.data_ptr(),
                cf2.data_ptr(), cf2.shape[0], objs.data_ptr(), objs.shape[0], tris.data_ptr(),
                tris.shape[0], B, N, C, H, W, int(use_mesh_proxy(cfg, N)), tan_half_fov(cfg),
                cfg.aspect, cfg.far, 1.0 / cfg.far, ca, sa, rgba.data_ptr(), dep.data_ptr(),
                seg.data_ptr(), stream)
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
