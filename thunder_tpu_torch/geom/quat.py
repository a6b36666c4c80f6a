"""Quaternion / rotation-matrix helpers, batched over leading dims.

Port of ``thunder_tpu.geom.quat``: quaternions are ``(w, x, y, z)`` unit
vectors and ``rotate3d`` is the reference's body-to-space rotation
(src/Geometry/Euler.cpp:181-189).
"""

import math

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


def quat_from_euler(phi, theta, psi):
    """ZYZ (RELION) Euler angles -> quaternion (Euler.cpp:91-99)."""
    return torch.stack([
        torch.cos((phi + psi) / 2) * torch.cos(theta / 2),
        torch.cos((phi - psi) / 2) * torch.sin(theta / 2),
        torch.sin((phi - psi) / 2) * torch.sin(theta / 2),
        torch.sin((phi + psi) / 2) * torch.cos(theta / 2),
    ], dim=-1)


def euler_from_quat(q):
    """Quaternion -> (phi, theta, psi), ZYZ, phi and psi in [0, 2 pi)
    (Euler.cpp:70-89)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_pi = 2 * math.pi
    phi = torch.atan2(x * z + w * y, w * x - y * z)
    phi = torch.where(phi < 0, phi + two_pi, phi)
    theta = torch.arccos(torch.clamp(w * w - x * x - y * y + z * z, -1.0,
                                     1.0))
    psi = torch.atan2(x * z - w * y, w * x + y * z)
    psi = torch.where(psi < 0, psi + two_pi, psi)
    return phi, theta, psi


def quat_from_axis_angle(axis, phi):
    """Axis (..., 3) + angle (...) -> quaternion (Euler.cpp:102-109)."""
    half = torch.as_tensor(phi, dtype=axis.dtype, device=axis.device)[
        ..., None] / 2
    return torch.cat([torch.cos(half).expand(axis.shape[:-1] + (1,)),
                      torch.sin(half) * axis], dim=-1)


def quat_from_matrix(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion with w >= 0:
    magnitudes from the diagonal, signs from the off-diagonal differences
    (Euler.cpp:112-123)."""
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    half_sqrt = lambda v: 0.5 * torch.sqrt(torch.clamp(v, min=0.0))
    w = half_sqrt(1 + d0 + d1 + d2)
    x = torch.copysign(half_sqrt(1 + d0 - d1 - d2), m[..., 2, 1] - m[..., 1, 2])
    y = torch.copysign(half_sqrt(1 - d0 + d1 - d2), m[..., 0, 2] - m[..., 2, 0])
    z = torch.copysign(half_sqrt(1 - d0 - d1 + d2), m[..., 1, 0] - m[..., 0, 1])
    return normalize(torch.stack([w, x, y, z], dim=-1))


def direction(phi, theta):
    """Spherical angles -> unit direction (Euler.cpp:144-156)."""
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def align_z(v, eps=1e-12):
    """Rotation matrix (..., 3, 3) taking the direction ``v`` (..., 3) to
    +z (Euler.cpp:240-269): row 2 is v / |v|, rows 0 and 1 complete the
    frame; v along +-x takes the fixed frame of the degenerate branch."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    p_yz = torch.sqrt(y * y + z * z)
    p = torch.clamp(torch.linalg.vector_norm(v, dim=-1), min=eps)
    safe = p_yz / p > 1e-6
    pyz = torch.clamp(p_yz, min=eps)
    m_gen = torch.stack([
        p_yz, -x * y / pyz, -x * z / pyz,
        torch.zeros_like(x), z / pyz, -y / pyz,
        x / p, y / p, z / p,
    ], dim=-1).reshape(v.shape[:-1] + (3, 3))
    m_deg = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                          [1.0, 0.0, 0.0]], dtype=v.dtype, device=v.device)
    return torch.where(safe[..., None, None], m_gen, m_deg.expand_as(m_gen))


def reflect3d(plane):
    """Reflection about the plane with normal ``plane``: A^T diag(1, 1, -1)
    A with A = align_z(plane) (Euler.cpp:284-295)."""
    a = align_z(plane)
    m = torch.tensor([1.0, 1.0, -1.0], dtype=a.dtype, device=a.device)
    return torch.einsum("...ji,j,...jk->...ik", a, m, a)


def swing_twist(q, axis):
    """q = swing * twist, twist a rotation about ``axis`` (Euler.cpp:
    294-305). Returns (swing, twist)."""
    p = torch.sum(q[..., 1:4] * axis, dim=-1, keepdim=True)
    twist = normalize(torch.cat([q[..., 0:1], p * axis], dim=-1))
    return quat_mul(q, quat_conj(twist)), twist


def sample_unit_sphere_2d(normals):
    """Uniform unit 2-vectors from 2D standard normals (..., 2) that the
    caller draws (the JAX package draws ``jax.random.normal(key, (n, 2))``
    and normalises the same way)."""
    return normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
