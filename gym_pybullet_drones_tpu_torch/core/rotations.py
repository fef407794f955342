"""Quaternion / rotation utilities on tensors (port of the JAX ``core/rotations.py``).

Conventions:

* Quaternions are stored **xyzw** (PyBullet order, slots 3:7 of the reference
  20-dim state vector, BaseAviary.py:541-561).
* ``quat_to_euler_xyz`` / ``euler_xyz_to_quat``: PyBullet's extrinsic xyz,
  ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``.
* ``matrix_to_euler_intrinsic_xyz`` / ``euler_intrinsic_xyz_to_matrix``: scipy's
  ``as_euler('XYZ')`` used in the DSL PID position loop (DSLPIDControl.py:207),
  ``R = Rx(a) @ Ry(b) @ Rz(c)``.
* ``integrate_quat``: the closed-form axis-angle update of the reference
  explicit dynamics (BaseAviary._integrateQ, BaseAviary.py:879-892).

Norms are written ``sqrt(x0*x0 + x1*x1 + ...)`` with a fixed summation order:
the float64 ``hover_dyn`` golden amplifies any last-ULP change near the quat
update, and a library norm may sum in another order.

All functions operate on the trailing axis and broadcast over leading axes.
"""

import torch


def norm3(v, keepdim=False):
    """Euclidean norm over a trailing axis of 3, in a fixed summation order."""
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
    return n[..., None] if keepdim else n


def cross(a, b):
    """Cross product over a trailing axis of 3."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], -1)


def quat_to_matrix(q):
    """Rotation matrix from an xyzw quaternion. q: (..., 4) -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], -1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], -1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_multiply(q1, q2):
    """Hamilton product of xyzw quaternions (rotation q1 applied after q2)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        -1,
    )


def quat_normalize(q, eps=1e-12):
    n = torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
                   + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])
    return q / torch.clamp(n, min=eps)[..., None]


def quat_rotate(q, v):
    """Rotate vector(s) v by xyzw quaternion(s) q (equivalent to R(q) @ v)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_euler_xyz(q):
    """PyBullet-convention (roll, pitch, yaw): R = Rz(yaw) Ry(pitch) Rx(roll)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    r10 = 2.0 * (x * y + w * z)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    roll = torch.atan2(r21, r22)
    pitch = torch.asin(torch.clamp(-r20, -1.0, 1.0))
    yaw = torch.atan2(r10, r00)
    return torch.stack([roll, pitch, yaw], -1)


def euler_xyz_to_quat(rpy):
    """Inverse of quat_to_euler_xyz: q = qz(yaw) * qy(pitch) * qx(roll), xyzw."""
    half = 0.5 * rpy
    cr, cp, cy = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sr, sp, sy = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        -1,
    )


def matrix_to_euler_intrinsic_xyz(R):
    """scipy 'XYZ' intrinsic Euler angles (a, b, c) with R = Rx(a) Ry(b) Rz(c)."""
    a = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    b = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    c = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([a, b, c], -1)


def euler_intrinsic_xyz_to_matrix(euler):
    """R = Rx(a) Ry(b) Rz(c) for intrinsic-XYZ angles (a, b, c)."""
    ca, cb, cc = torch.cos(euler[..., 0]), torch.cos(euler[..., 1]), torch.cos(euler[..., 2])
    sa, sb, sc = torch.sin(euler[..., 0]), torch.sin(euler[..., 1]), torch.sin(euler[..., 2])
    row0 = torch.stack([cb * cc, -cb * sc, sb], -1)
    row1 = torch.stack([ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb], -1)
    row2 = torch.stack([sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb], -1)
    return torch.stack([row0, row1, row2], -2)


def integrate_quat(quat, omega, dt, eps=1e-9):
    """Closed-form quaternion integration under constant body rates ``omega``.

    The axis-angle update of BaseAviary._integrateQ (BaseAviary.py:879-892):
    with theta = |w| dt / 2, q' = (cos(theta) I + sin(theta)/|w| * M(w)) q.
    The zero-rate branch is a ``where``, and the norm's INPUT is guarded (the
    double-where pattern): small rows see a unit vector, so no NaN gradient
    leaks through the ``where`` at w = 0.
    """
    n2 = omega[..., 0:1] * omega[..., 0:1] + omega[..., 1:2] * omega[..., 1:2] \
        + omega[..., 2:3] * omega[..., 2:3]
    small = n2 <= eps * eps
    ex = torch.zeros_like(omega)
    ex[..., 0] = 1.0
    omega_norm = norm3(torch.where(small, ex, omega), keepdim=True)
    p, q_, r = omega[..., 0:1], omega[..., 1:2], omega[..., 2:3]
    x, y, z, w = quat[..., 0:1], quat[..., 1:2], quat[..., 2:3], quat[..., 3:4]
    # M(w) @ quat with M rows [[0, r, -q, p], [-r, 0, p, q], [q, -p, 0, r], [-p, -q, -r, 0]]
    mq = torch.cat(
        [
            r * y - q_ * z + p * w,
            -r * x + p * z + q_ * w,
            q_ * x - p * y + r * w,
            -p * x - q_ * y - r * z,
        ],
        -1,
    )
    theta = omega_norm * dt / 2.0
    out = torch.cos(theta) * quat + torch.sin(theta) / omega_norm * mq
    return torch.where(small, quat, out)

