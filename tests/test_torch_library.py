"""Port parity for the JAX package's library functions that neither
package's main path calls (a library user may): ``directional.pdf_acg``,
``sample_acg_k0k1``, ``infer_acg_k0k1``, ``infer_acg_k``,
``infer_acg_k123``, ``infer_acg_mean``; ``pixels.scatter_pixels``;
``ctf.ctf_1d``; ``likelihood.log_likelihood_pose``;
``particle.resample_rotations``. The same NumPy inputs go through both;
where the JAX function draws from a key, the port takes the same draws as
tensors. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.core import particle as jparticle
from thunder_tpu.geom import directional as jdir
from thunder_tpu.ops import ctf as jctf
from thunder_tpu.ops import likelihood as jlik
from thunder_tpu.ops import pixels as jpix
from thunder_tpu_torch.core import particle as tparticle
from thunder_tpu_torch.geom import directional as tdir
from thunder_tpu_torch.ops import ctf as tctf
from thunder_tpu_torch.ops import likelihood as tlik
from thunder_tpu_torch.ops import pixels as tpix

from test_torch_support import nn, tt

torch.set_num_threads(1)

SIG = np.diag([1.0, 0.05, 0.02, 0.01]).astype(np.float32)


def _acg_support(n=200, seed=0):
    """Quaternions (n, 4) drawn from ACG(SIG) and weights (n,)."""
    q = np.asarray(jdir.sample_acg(jax.random.PRNGKey(seed),
                                   jnp.asarray(SIG), n))
    w = np.random.default_rng(seed).uniform(0.1, 1.0, n).astype(np.float32)
    return q, w


def test_pdf_acg():
    """Batched points and scatters; 1e-5 relative."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 50, 4)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    a = rng.normal(size=(3, 1, 4, 4))
    sig = (a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(4)).astype(np.float32)
    np.testing.assert_allclose(nn(tdir.pdf_acg(tt(x), tt(sig))),
                               np.asarray(jdir.pdf_acg(x, sig)), rtol=1e-5)


def test_sample_acg_k0k1():
    """The JAX sampler's own normals through the port: within 1e-6."""
    key = jax.random.PRNGKey(7)
    ref = jdir.sample_acg_k0k1(key, 1.0, 0.2, 64)
    normals = jax.random.normal(key, (64, 4), jnp.float32)
    got = tdir.sample_acg_k0k1(1.0, 0.2, tt(normals))
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_infer_acg_reductions(weighted):
    """k0, k1, k1 / k0 and the diagonal ratios within 2e-4 relative (the
    Tyler iteration's tolerance, tests/test_torch_geom.py); the mean's
    |dot| above 1 - 1e-5 (its sign is free)."""
    q, w = _acg_support()
    w = w if weighted else None
    jq, jw = jnp.asarray(q), None if w is None else jnp.asarray(w)
    tq, tw = tt(q), None if w is None else tt(w)
    for got, ref in zip(tdir.infer_acg_k0k1(tq, tw),
                        jdir.infer_acg_k0k1(jq, jw)):
        np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=2e-4)
    np.testing.assert_allclose(nn(tdir.infer_acg_k(tq, tw)),
                               np.asarray(jdir.infer_acg_k(jq, jw)),
                               rtol=2e-4)
    for got, ref in zip(tdir.infer_acg_k123(tq, tw),
                        jdir.infer_acg_k123(jq, jw)):
        np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=2e-4)
    m_ref = np.asarray(jdir.infer_acg_mean(jq, jw))
    m_got = nn(tdir.infer_acg_mean(tq, tw))
    assert abs(float(np.dot(m_ref, m_got))) > 1 - 1e-5


@pytest.mark.parametrize("hermitian", [False, True])
def test_scatter_pixels(hermitian):
    """A ring reaching row -n/2 (whose mirror drops) scattered back into
    centred spectra with and without the Hermitian mirror: within 1e-6."""
    n = 16
    ring_j = jpix.pixel_ring(n, 0, n // 2)
    ring_t = tpix.pixel_ring(n, 0, n // 2)
    rng = np.random.default_rng(3)
    p = len(ring_t.col)
    v = (rng.normal(size=(2, p)) + 1j * rng.normal(size=(2, p))).astype(
        np.complex64)
    ref = np.asarray(jpix.scatter_pixels(jnp.asarray(v), ring_j, n,
                                         hermitian=hermitian))
    got = nn(tpix.scatter_pixels(tt(v), ring_t, n, hermitian=hermitian))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_ctf_1d():
    """Frequencies to Nyquist at 1.32 A, scalar and per-frequency
    parameters: within 2e-4, the tolerance of ``ctf_pixels``' parity
    (tests/test_torch_ops.py): the f32 phase reaches hundreds of radians
    (read: 1.2e-5)."""
    f = np.linspace(0, 1 / 2.64, 200).astype(np.float32)
    d = np.linspace(1e4, 3e4, 200).astype(np.float32)
    for defocus, ps in ((1.5e4, 0.0), (d, 0.3)):
        ref = jctf.ctf_1d(jnp.asarray(f), 300e3, jnp.asarray(defocus), 2.7e7,
                          0.1, ps)
        got = tctf.ctf_1d(tt(f), 300e3, tt(np.asarray(defocus)), 2.7e7, 0.1,
                          ps)
        np.testing.assert_allclose(nn(got), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_log_likelihood_pose(batched):
    """(B, P) and (B, M, P) predictions, with and without a pixel mask:
    within 1e-5 relative."""
    rng = np.random.default_rng(4)
    b, m, p = 3, 5, 40
    cplx = lambda *s: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(
        np.complex64)
    dat, pri = cplx(b, p), cplx(*((b, m, p) if batched else (b, p)))
    ctf = rng.normal(size=(b, p)).astype(np.float32)
    sig_rcp = -rng.uniform(0.5, 2.0, (b, p)).astype(np.float32)
    mask = (rng.uniform(size=p) > 0.3).astype(np.float32)
    for pm in (None, mask):
        ref = jlik.log_likelihood_pose(dat, ctf, sig_rcp, pri, pixel_mask=pm)
        got = tlik.log_likelihood_pose(
            tt(dat), tt(ctf), tt(sig_rcp), tt(pri),
            pixel_mask=None if pm is None else tt(pm))
        np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=1e-5)


def test_resample_rotations():
    """Per-image keys' uniforms (drawn as the JAX function draws them)
    passed to the port: the same resampled rotations, exactly."""
    rng = np.random.default_rng(5)
    b, n_in, n_out = 8, 30, 20
    w = rng.uniform(0, 1, (b, n_in)).astype(np.float32)
    r = rng.normal(size=(b, n_in, 4)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), b)
    ref = jparticle.resample_rotations(keys, jnp.asarray(w), jnp.asarray(r),
                                       n_out)
    u0 = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys)
    got = tparticle.resample_rotations(tt(w), tt(r), n_out, tt(u0))
    np.testing.assert_array_equal(nn(got), np.asarray(ref))
