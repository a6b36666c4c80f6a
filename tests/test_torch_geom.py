"""Port parity: geom (quaternions, symmetry groups, ACG statistics).
Inputs from a seeded NumPy generator go through both packages; float32
results agree to the stated tolerances (f32 round-off of different
operation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.geom import directional as jdir
from thunder_tpu.geom import quat as jquat
from thunder_tpu.geom import symmetry as jsym
from thunder_tpu_torch.geom import directional as tdir
from thunder_tpu_torch.geom import quat as tquat
from thunder_tpu_torch.geom import symmetry as tsym

from test_torch_support import nn, tt

torch.set_num_threads(1)


def _quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_ops_match():
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 7, 3), _quats(rng, 7, 3)
    np.testing.assert_allclose(nn(tquat.quat_mul(tt(a), tt(b))),
                               np.asarray(jquat.quat_mul(a, b)), atol=1e-6)
    np.testing.assert_allclose(nn(tquat.quat_conj(tt(a))),
                               np.asarray(jquat.quat_conj(jnp.asarray(a))))
    np.testing.assert_allclose(nn(tquat.rotate3d(tt(a))),
                               np.asarray(jquat.rotate3d(a)), atol=1e-6)
    np.testing.assert_allclose(nn(tquat.normalize(tt(3 * a))),
                               np.asarray(jquat.normalize(3 * a)), atol=1e-6)


@pytest.mark.parametrize("symbol", ["C1", "C4", "D2", "T", "O", "I3"])
def test_symmetry_groups_match(symbol):
    j, t = jsym.Symmetry(symbol), tsym.Symmetry(symbol)
    assert t.n_elements == j.n_elements
    np.testing.assert_array_equal(t.rot, j.rot)
    np.testing.assert_array_equal(t.quat, j.quat)


@pytest.mark.parametrize("symbol", ["C4", "O"])
def test_symmetry_counterpart_matches(symbol):
    rng = np.random.default_rng(1)
    q = _quats(rng, 5, 6)
    anchor = _quats(rng, 5)[:, None, :]
    g = jsym.Symmetry(symbol).quat.astype(np.float32)
    ref = jsym.symmetry_counterpart(jnp.asarray(q), g,
                                    anchor=jnp.asarray(anchor))
    got = tsym.symmetry_counterpart(tt(q), tt(g), anchor=tt(anchor))
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=1e-6)
    ref0 = jsym.symmetry_counterpart(jnp.asarray(q), g)
    np.testing.assert_allclose(nn(tsym.symmetry_counterpart(tt(q), tt(g))),
                               np.asarray(ref0), atol=1e-6)


def test_infer_acg_and_mean_match():
    rng = np.random.default_rng(2)
    sig = np.diag([1.0, 0.05, 0.02, 0.01]).astype(np.float32)
    q = np.asarray(jdir.sample_acg(jax.random.PRNGKey(0), jnp.asarray(sig),
                                   200))
    w = rng.uniform(0.1, 1.0, 200).astype(np.float32)
    a_ref = np.asarray(jdir.infer_acg(jnp.asarray(q), jnp.asarray(w)))
    a_got = nn(tdir.infer_acg(tt(q), tt(w)))
    np.testing.assert_allclose(a_got, a_ref, rtol=2e-4, atol=2e-6)
    m_ref = np.asarray(jdir.infer_acg_mean(jnp.asarray(q)))
    m_got = nn(tdir.infer_acg_mean(tt(q)))
    assert abs(float(np.dot(m_ref, m_got))) > 1 - 1e-5  # sign is free
    # batched leading dims equal the per-item results
    qb = np.stack([q, q[::-1]])
    np.testing.assert_allclose(nn(tdir.infer_acg(tt(qb)))[1],
                               nn(tdir.infer_acg(tt(q[::-1]))), rtol=1e-5,
                               atol=1e-7)


def test_sample_acg_k123_with_shared_normals():
    key = jax.random.PRNGKey(4)
    k1, k2, k3 = 0.3, 0.1, 0.05
    ref = jdir.sample_acg_k123(key, k1, k2, k3, 64)
    normals = jax.random.normal(key, (64, 4), jnp.float32)
    got = tdir.sample_acg_k123(torch.tensor(k1), torch.tensor(k2),
                               torch.tensor(k3), tt(normals))
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=1e-6)


def test_bessel_i0_matches():
    x = np.linspace(0.0, 30.0, 301).astype(np.float32)
    np.testing.assert_allclose(nn(tdir.bessel_i0(tt(x))),
                               np.asarray(jdir._bessel_i0(x)), rtol=1e-6)
