"""Pose sampling for the global scan (port of ``thunder_tpu.core.
sampling``; Particle::reset src/Particle.cpp:87-170 and the scan counts of
Optimiser::expectation src/Optimiser.cpp:645-665). Random normals and
uniforms are drawn by the caller."""

import math

from ..geom import quat
from ..geom.symmetry import symmetry_counterpart

CHI2_INV_Q_05_DF2 = 1.3862943611198906  # chi^2 Q^-1(0.5, df=2) = 2 ln 2


def n_scan_rotations(m_s, n_sym_elements, mode="3d"):
    if mode == "2d":
        return m_s
    return max(1, m_s // (1 + n_sym_elements))


def n_scan_translations(trans_s, trans_search_factor):
    return max(30, int(round(math.pi * (trans_s * CHI2_INV_Q_05_DF2) ** 2
                             * trans_search_factor)))


def sample_rotations_3d(normals, sym_quats=None):
    """Uniform rotations from (n, 4) normals, reduced into the symmetry
    fundamental domain when ``sym_quats`` (M, 4) is non-empty."""
    q = quat.random_quat(normals)
    if sym_quats is not None and sym_quats.shape[0] > 0:
        q = symmetry_counterpart(q, sym_quats.to(q.dtype))
    return q


def sample_rotations_2d(u):
    """Uniform in-plane angles (n,) radians from (n,) uniforms in [0, 1)
    (``thunder_tpu.core.sampling.sample_rotations_2d`` draws
    ``jax.random.uniform(key, (n,), 0, 2 pi)``, the same product)."""
    return u * (2 * math.pi)


def sample_translations(normals, trans_s):
    """(n, 2) Gaussian translations trans_s * normals, first pinned at 0."""
    t = trans_s * normals
    t[0] = 0.0
    return t
