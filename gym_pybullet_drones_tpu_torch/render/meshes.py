"""Low-poly triangle meshes and a Möller-Trumbore ray caster (port of the JAX
``render/meshes.py``).

The reference renders the duck and teddy landmarks as meshes
(``duck_vhacd.urdf`` / ``teddy_vhacd.urdf``, BaseRLAviary.py:120-126) and the
drone as its cf2 mesh through TinyRenderer (BaseAviary.py:565-617). The
stand-ins here are procedurally authored closed surfaces (icosahedron blobs,
boxes and prop discs, 60 to 200 triangles each), built in numpy; only
``ray_tris`` computes on tensors. This is the port's own copy of the numpy
construction: the arrays equal the JAX package's, array for array.
"""

import numpy as np
import torch

# ---------------------------------------------------------------------------
# mesh construction (numpy, build time)
# ---------------------------------------------------------------------------

_PHI = (1.0 + 5.0**0.5) / 2.0
_ICO_V = np.array([
    [-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
    [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
    [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1],
], dtype=np.float64)
_ICO_V /= np.linalg.norm(_ICO_V, axis=1, keepdims=True)
_ICO_F = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], dtype=np.int32)


def icosphere(subdiv: int = 0):
    """Unit icosphere: (V, 3) float64 vertices + (T, 3) int32 faces.
    subdiv=0 -> 20 tris, 1 -> 80 tris."""
    v, f = _ICO_V.copy(), _ICO_F.copy()
    for _ in range(subdiv):
        edge_mid = {}
        nv = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = v[a] + v[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(nv)
                nv.append(m)
            return edge_mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.array(nv), np.array(nf, dtype=np.int32)
    return v, f


def _blob(scale, offset, subdiv=0, rot=None):
    """Scaled/rotated/translated icosphere triangle list -> (T, 3, 3)."""
    v, f = icosphere(subdiv)
    v = v * np.asarray(scale, dtype=np.float64)
    if rot is not None:
        v = v @ np.asarray(rot, dtype=np.float64).T
    v = v + np.asarray(offset, dtype=np.float64)
    return v[f]  # (T, 3, 3)


def _box(half, offset=(0, 0, 0), rot=None):
    """Axis-aligned (or rotated) box as 12 triangles -> (12, 3, 3)."""
    hx, hy, hz = half
    c = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 dtype=np.float64)
    # faces of the 2x2x2 corner lattice (indices into c, CCW outward)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, d, e in quads:
        tris += [[c[a], c[b], c[d]], [c[a], c[d], c[e]]]
    t = np.array(tris)
    if rot is not None:
        t = t @ np.asarray(rot, dtype=np.float64).T
    return t + np.asarray(offset, dtype=np.float64)


def _disc(radius, center, n=8):
    """Flat horizontal n-gon fan (two-sided via the |det| hit test) ->
    (n, 3, 3)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(n)], -1) + np.asarray(center, dtype=np.float64)
    c = np.asarray(center, dtype=np.float64)
    return np.array([[c, ring[i], ring[(i + 1) % n]] for i in range(n)])


def _rot_z(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), -np.sin(a), 0],
                     [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])


def duck_mesh():
    """Sitting-duck silhouette (72 tris), bulk matched to the 0.12 m
    collision sphere (core/collisions._RL_OBSTACLE_R[2]); faces +x like
    pybullet_data's duck_vhacd default orientation."""
    parts = [
        _blob((0.11, 0.085, 0.065), (0.0, 0.0, -0.03)),   # body
        _blob((0.05, 0.045, 0.05), (0.065, 0.0, 0.065)),  # head
        _box((0.035, 0.018, 0.01), (0.125, 0.0, 0.055)),  # beak
        _blob((0.04, 0.03, 0.03), (-0.1, 0.0, 0.01)),     # tail bump
    ]
    return np.concatenate(parts).astype(np.float32)


def teddy_mesh():
    """Teddy-bear silhouette (160 tris), bulk matched to the 0.15 m
    collision sphere (core/collisions._RL_OBSTACLE_R[3])."""
    parts = [
        _blob((0.075, 0.06, 0.095), (0.0, 0.0, -0.035)),          # body
        _blob((0.055, 0.05, 0.055), (0.01, 0.0, 0.085)),          # head
        _blob((0.02, 0.022, 0.022), (0.0, 0.045, 0.14)),          # ear L
        _blob((0.02, 0.022, 0.022), (0.0, -0.045, 0.14)),         # ear R
        _blob((0.028, 0.028, 0.045), (0.02, 0.085, -0.01)),       # arm L
        _blob((0.028, 0.028, 0.045), (0.02, -0.085, -0.01)),      # arm R
        _blob((0.032, 0.032, 0.05), (0.035, 0.05, -0.115)),       # leg L
        _blob((0.032, 0.032, 0.05), (0.035, -0.05, -0.115)),      # leg R
    ]
    return np.concatenate(parts).astype(np.float32)


def cf2_mesh(arm: float, frame_angle_deg: float = 45.0):
    """cf2 silhouette in the BODY frame (68 tris): center body box, two
    crossing arm bars (the X/+ frame per ``frame_angle_deg``), and four
    horizontal prop discs at the motor positions — the visual skeleton of
    the reference's cf2.dae (BaseAviary.py:565-617 render path; arm length
    from the URDF). Rotate by the drone quaternion and translate per drone.
    """
    bar_len, bar_wid, bar_hgt = 1.3 * arm, 0.18 * arm, 0.12 * arm
    prop_r, prop_z = 0.55 * arm, 0.16 * arm
    rz = _rot_z(frame_angle_deg)
    parts = [
        _box((0.45 * arm, 0.45 * arm, 0.35 * arm), (0, 0, 0)),  # body
        _box((bar_len, bar_wid, bar_hgt), rot=rz),              # bar A
        _box((bar_wid, bar_len, bar_hgt), rot=rz),              # bar B
    ]
    for sx, sy in ((1, 0), (0, 1), (-1, 0), (0, -1)):
        c = rz @ np.array([sx * arm * 1.1, sy * arm * 1.1, prop_z])
        parts.append(_disc(prop_r, c))
    return np.concatenate(parts).astype(np.float32)


def mesh_arrays(tris):
    """(T, 3, 3) triangle list -> (v0, e1, e2, n) float32 numpy arrays for
    ``ray_tris``; n is each face's unit normal (flat shading)."""
    t = np.asarray(tris, dtype=np.float32)
    v0 = t[:, 0]
    e1 = t[:, 1] - t[:, 0]
    e2 = t[:, 2] - t[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return v0, e1, e2, n.astype(np.float32)


# ---------------------------------------------------------------------------
# ray-triangle intersection (tensors)
# ---------------------------------------------------------------------------

# Möller-Trumbore's determinant floor and the nearest hit counted.
TRI_EPS = 1e-9
T_MIN = 1e-4


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def ray_tris(o, d, v0, e1, e2):
    """Möller-Trumbore, two-sided: rays ``o``, ``d`` (..., 3) against
    triangles (T, 3) -> hit distances (..., T), inf on a miss. Two-sided, so
    the one-sided prop discs are seen from both sides. Each product and sum
    in the JAX package's order (sums over a vector's three components
    left to right), on (..., T) component tensors."""
    dx, dy, dz = (d[..., None, k] for k in range(3))
    ox, oy, oz = (o[..., None, k] for k in range(3))
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    hx, hy, hz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    live = torch.abs(a) > TRI_EPS
    f = 1.0 / torch.where(live, a, torch.full_like(a, TRI_EPS))
    sx, sy, sz = ox - v0[..., 0], oy - v0[..., 1], oz - v0[..., 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx, qy, qz = sy * e1z - sz * e1y, sz * e1x - sx * e1z, sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(hit, t, torch.full_like(t, float("inf")))
