"""Quaternion / rotation-matrix helpers, batched over leading dims.

Port of ``thunder_tpu.geom.quat``: quaternions are ``(w, x, y, z)`` unit
vectors and ``rotate3d`` is the reference's body-to-space rotation
(src/Geometry/Euler.cpp:181-189).
"""

import torch


def quat_mul(a, b):
    """Hamilton product, batched. a, b: (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def normalize(q, eps=1e-30):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def rotate3d(q):
    """Unit quaternion(s) (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def random_quat(normals):
    """Uniform random rotations from 4D standard normals (..., 4): the
    caller draws them (``thunder_tpu.geom.quat.random_quat`` draws
    ``jax.random.normal(key, (n, 4))`` and normalises the same way)."""
    return normalize(normals)


def rotate2d(phi):
    """Angle(s) (...,) -> 2x2 rotation matrix (..., 2, 2)."""
    c, s = torch.cos(phi), torch.sin(phi)
    return torch.stack([c, -s, s, c], dim=-1).reshape(phi.shape + (2, 2))


def rotate2d_vec(v):
    """Unit 2-vector(s) (..., 2) = (cos, sin) -> 2x2 rotation matrix."""
    c, s = v[..., 0], v[..., 1]
    return torch.stack([c, -s, s, c], dim=-1).reshape(v.shape[:-1] + (2, 2))
