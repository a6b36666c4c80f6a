"""Point-group symmetry (C_n, D_n, T, O, I1-I4).

Port of ``thunder_tpu.geom.symmetry``: group elements are generated with
NumPy in float64 once per run (same generators and closure as the
reference, src/Geometry/Symmetry.cpp:250-277; the identity is not stored),
and ``symmetry_counterpart`` maps quaternions into the fundamental domain
on the tensors' device (Symmetry.cpp:309-337).
"""

import re

import numpy as np
import torch

_SAME_TOL = 1e-4


def _axis_angle_matrix(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    w = np.cos(angle / 2)
    x, y, z = np.sin(angle / 2) * axis
    return _quat_to_matrix(np.array([w, x, y, z]))


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _matrix_to_quat(m):
    w = 0.5 * np.sqrt(max(0.0, 1 + m[0, 0] + m[1, 1] + m[2, 2]))
    x = 0.5 * np.sqrt(max(0.0, 1 + m[0, 0] - m[1, 1] - m[2, 2]))
    y = 0.5 * np.sqrt(max(0.0, 1 - m[0, 0] + m[1, 1] - m[2, 2]))
    z = 0.5 * np.sqrt(max(0.0, 1 - m[0, 0] - m[1, 1] + m[2, 2]))
    x = np.copysign(x, m[2, 1] - m[1, 2])
    y = np.copysign(y, m[0, 2] - m[2, 0])
    z = np.copysign(z, m[1, 0] - m[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


# group -> list of (fold, axis); axes from SymmetryFunctions.cpp:65-148
_GENERATORS = {
    "T": [(3, (0, 0, 1)), (2, (0, 0.816496, 0.577350))],
    "O": [(3, (0.5773502, 0.5773502, 0.5773502)), (4, (0, 0, 1))],
    "I1": [(2, (1, 0, 0)), (5, (0.8506508, 0, -0.5257311)),
           (3, (0.9341724, 0.3568221, 0))],
    "I2": [(2, (0, 0, 1)), (5, (0.5257311, 0, 0.8506508)),
           (3, (0, 0.3568221, 0.9341724))],
    "I3": [(2, (-0.5257311, 0, 0.8506508)), (5, (0, 0, 1)),
           (3, (-0.4911235, 0.3568221, 0.7946545))],
    "I4": [(2, (0.5257311, 0, 0.8506508)), (5, (0.8944272, 0, 0.4472136)),
           (3, (0.4911235, 0.3568221, 0.7946545))],
}


def _parse(symbol):
    symbol = symbol.strip().upper()
    if symbol == "I":
        symbol = "I2"
    m = re.fullmatch(r"C(\d+)", symbol)
    if m:
        return [(int(m.group(1)), (0, 0, 1))]
    m = re.fullmatch(r"D(\d+)", symbol)
    if m:
        return [(int(m.group(1)), (0, 0, 1)), (2, (1, 0, 0))]
    if symbol in _GENERATORS:
        return _GENERATORS[symbol]
    raise ValueError(f"invalid symmetry symbol: {symbol!r}")


def _novo(mats, m):
    for e in mats:
        if np.max(np.abs(e - m)) < _SAME_TOL:
            return False
    return np.max(np.abs(m - np.eye(3))) >= _SAME_TOL


class Symmetry:
    """All non-identity elements of a point group as (N, 3, 3) matrices
    and (N, 4) quaternions (NumPy, float64)."""

    def __init__(self, symbol="C1"):
        self.symbol = symbol.strip().upper()
        mats = []
        for fold, axis in _parse(symbol):
            angle = 2 * np.pi / fold
            for j in range(1, fold):
                r = _axis_angle_matrix(axis, angle * j)
                if _novo(mats, r):
                    mats.append(r)
        changed = True
        while changed:
            changed = False
            for i in range(len(mats)):
                for j in range(len(mats)):
                    r = mats[i] @ mats[j]
                    if _novo(mats, r):
                        mats.append(r)
                        changed = True
        self.rot = np.stack(mats) if mats else np.zeros((0, 3, 3))
        self.quat = (np.stack([_matrix_to_quat(m) for m in mats])
                     if mats else np.zeros((0, 4)))

    @property
    def n_elements(self):
        """|G| - 1, the reference's nSymmetryElement()."""
        return len(self.rot)

    def is_asymmetric(self):
        return self.n_elements == 0

    def rot_with_identity(self):
        """(|G|, 3, 3) matrices, the identity first."""
        return np.concatenate([np.eye(3)[None], self.rot], axis=0)

    def quat_with_identity(self):
        """(|G|, 4) quaternions, the identity first."""
        return np.concatenate([np.array([[1.0, 0.0, 0.0, 0.0]]), self.quat],
                              axis=0)


def symmetry_counterpart(q, sym_quats, anchor=None):
    """Among {conj(g) q : g in G u {e}} pick the candidate maximising
    |<., anchor>| (anchor defaults to the identity quaternion).

    q: (..., 4); sym_quats: (M, 4) tensor WITHOUT the identity; anchor
    broadcastable against q."""
    from .quat import quat_conj, quat_mul

    if sym_quats.shape[0] == 0:
        return q
    if anchor is None:
        anchor = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype,
                              device=q.device)
    g = quat_conj(sym_quats.to(q.dtype)).reshape(
        (sym_quats.shape[0],) + (1,) * (q.ndim - 1) + (4,))
    cand = torch.cat([q[None], quat_mul(g, q[None])], dim=0)  # (M+1, ..., 4)
    score = torch.abs(torch.sum(cand * anchor, dim=-1))
    best = torch.argmax(score, dim=0)
    return torch.gather(
        cand, 0, best[None, ..., None].expand((1,) + q.shape))[0]
