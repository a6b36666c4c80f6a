"""Port parity: the E-step likelihoods and kernel K1's plain version.

K1's plain version (``likelihood.scan_plain``, reached through the
wrapper ``scan_fused`` for CPU tensors) is held to the JAX package's f32
``global_search_weights`` at 1e-4 relative, and at one tiny shape to the
Pallas kernel itself in interpret mode at that kernel's own bar
(normalised posteriors within 5e-2, same top pose — bf16 operands)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.ops import likelihood as jlh
from thunder_tpu_torch.ops import likelihood as tlh

from test_torch_support import nn, rel_err, tt

torch.set_num_threads(1)


def _problem(rng, b, p, k, r, t, scale=0.05):
    dat = (rng.normal(size=(b, p)) + 1j * rng.normal(size=(b, p))).astype(
        np.complex64)
    ctf = rng.uniform(-1, 1, size=(b, p)).astype(np.float32)
    sig_rcp = (-0.5 / rng.uniform(0.5, 2, size=(b, p))).astype(np.float32)
    proj = ((rng.normal(size=(k, r, p)) + 1j * rng.normal(size=(k, r, p)))
            * scale).astype(np.complex64)
    proj[0, 3] = dat[0] / ctf[0]
    tra = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(t, p))).astype(
        np.complex64)
    pm = (rng.uniform(size=p) > 0.1).astype(np.float32)
    return dat, ctf, sig_rcp, proj, tra, pm


def _norm(x):
    x = np.asarray(x, np.float64)
    return x / np.maximum(x.sum(axis=tuple(range(1, x.ndim)), keepdims=True),
                          1e-300)


@pytest.mark.parametrize("b,p,k,r,t,priors", [
    (8, 256, 1, 40, 5, False), (5, 96, 2, 33, 7, True),
    (6, 128, 1, 130, 30, True)])
def test_plain_scan_matches_jax(b, p, k, r, t, priors):
    rng = np.random.default_rng(b * 100 + r)
    dat, ctf, sig_rcp, proj, tra, pm = _problem(rng, b, p, k, r, t)
    kw_j, kw_t = {}, {}
    if priors:
        pr = rng.dirichlet(np.ones(r), size=b).astype(np.float32)
        pt = rng.dirichlet(np.ones(t), size=b).astype(np.float32)
        kw_j = dict(prior_r=jnp.asarray(pr), prior_t=jnp.asarray(pt))
        kw_t = dict(prior_r=tt(pr), prior_t=tt(pt))
    ref = jlh.global_search_weights(
        jnp.asarray(dat), jnp.asarray(ctf), jnp.asarray(sig_rcp),
        jnp.asarray(proj), jnp.asarray(tra), pixel_mask=jnp.asarray(pm),
        **kw_j)
    args = (tt(dat), tt(ctf), tt(sig_rcp), tt(proj), tt(tra))
    got = tlh.global_search_weights_fused(*args, pixel_mask=tt(pm), **kw_t)
    np.testing.assert_allclose(nn(got["baseline"]),
                               np.asarray(ref["baseline"]), rtol=1e-5)
    for name in ("wC", "wR", "wT"):
        assert rel_err(nn(got[name]), ref[name]) <= 1e-4, name
    assert tlh.LAUNCHES["scan_fused"] == 0  # CPU tensors never launch


def _scan_inputs(rng, b, p, k, r, t):
    """Port-side scan inputs (q, e, proj, tra, prior_r, prior_t) with
    Dirichlet priors, and the JAX ``global_search_weights`` result."""
    dat, ctf, sig_rcp, proj, tra, pm = _problem(rng, b, p, k, r, t)
    pr = rng.dirichlet(np.ones(r), size=b).astype(np.float32)
    pt = rng.dirichlet(np.ones(t), size=b).astype(np.float32)
    ref = jlh.global_search_weights(
        jnp.asarray(dat), jnp.asarray(ctf), jnp.asarray(sig_rcp),
        jnp.asarray(proj), jnp.asarray(tra), prior_r=jnp.asarray(pr),
        prior_t=jnp.asarray(pt), pixel_mask=jnp.asarray(pm))
    q, e = tlh._q_e(tt(dat), tt(ctf), tt(sig_rcp), tt(pm))
    return (q, e, tt(proj), tt(tra), tt(pr), tt(pt)), ref


@pytest.mark.parametrize("b,p,k,r,t", [
    (6, 96, 2, 33, 7),      # K = 2, ragged R and P, T below one chunk
    (5, 128, 1, 70, 70),    # T over two 32-row chunks, ragged pose tile
    (3, 200, 1, 64, 30),    # whole pose tile, the round's T
    (4, 64, 3, 20, 1)])     # one translation, three classes
def test_tile_contract_merges_to_scan(b, p, k, r, t):
    """K1's tile contract: ``merge_tiles`` of ``scan_tiles_plain`` on the
    pose-padded f32 operands gives ``scan_plain`` and the JAX
    ``global_search_weights`` to 1e-4 relative."""
    rng = np.random.default_rng(b * 1000 + r * 10 + t)
    args, ref = _scan_inputs(rng, b, p, k, r, t)
    packed = tlh.pack_scan(*args)
    assert packed["qa"].shape == (3, b, p)
    assert packed["poses"].shape[0] % tlh.SCAN_NT == 0
    tiles = tlh.scan_tiles_plain(packed)
    n_tiles = packed["poses"].shape[0] // tlh.SCAN_NT
    assert tiles["wt"].shape == (b, n_tiles, t)
    got = tlh.merge_tiles(tiles, k, r)
    plain = tlh.scan_plain(*args)
    np.testing.assert_allclose(nn(got["baseline"]), nn(plain["baseline"]),
                               rtol=1e-5)
    np.testing.assert_allclose(nn(got["baseline"]),
                               np.asarray(ref["baseline"]), rtol=1e-5)
    for name in ("wC", "wR", "wT"):
        assert rel_err(nn(got[name]), nn(plain[name])) <= 1e-4, name
        assert rel_err(nn(got[name]), ref[name]) <= 1e-4, name
    assert tlh.LAUNCHES["scan_fused"] == 0


def test_tile_contract_masks_pad_poses():
    """A pad pose (valid = 0) whose logL would be the largest of its tile
    changes no tile output."""
    rng = np.random.default_rng(21)
    b, p, k, r, t = 4, 64, 1, 40, 7
    args, _ = _scan_inputs(rng, b, p, k, r, t)
    packed = tlh.pack_scan(*args)
    assert float(packed["valid"][r]) == 0.0
    clean = tlh.scan_tiles_plain(packed)
    # E = sigRcp ctf^2 <= 0, so a pad row of |P|^2 = -1000 scores
    # 1000 sum |E|: far above every real pose, for every image
    packed["poses"][r] = 0.0
    packed["poses"][r, 2 * packed["qa"].shape[-1]:] = -1000.0
    unmasked = tlh.scan_tiles_plain(dict(packed, valid=torch.ones_like(
        packed["valid"])))
    assert (unmasked["base"][:, 0] > clean["base"][:, 0] + 100.0).all()
    got = tlh.scan_tiles_plain(packed)
    for name in ("base", "wr", "wc", "wt"):
        torch.testing.assert_close(got[name], clean[name], rtol=0, atol=0)


@pytest.mark.parametrize("b,k,r,t", [(5, 2, 70, 9), (3, 1, 64, 40)])
def test_tile_views_follow_kernel_layout(b, k, r, t):
    """The views that ``scan_tiles_kernel`` returns read the kernel's flat
    tile buffer in the order csrc/global_scan.cu writes it: base (B, n_t),
    wr (B, 64 n_t), wc (B, n_t), wt (B, n_t, T), back to back."""
    n_t, numel = tlh._tiles_numel(b, k, r, t)
    assert n_t == k * -(-r // tlh.SCAN_NT)
    buf = torch.arange(numel + 7, dtype=torch.float32)
    v = tlh._tile_views(buf, b, k, r, t)
    n = b * n_t
    offsets = {"base": 0, "wr": n, "wc": n + n * tlh.SCAN_NT,
               "wt": 2 * n + n * tlh.SCAN_NT}
    shapes = {"base": (b, n_t), "wr": (b, n_t * tlh.SCAN_NT),
              "wc": (b, n_t), "wt": (b, n_t, t)}
    for name, view in v.items():
        assert tuple(view.shape) == shapes[name], name
        flat = view.reshape(-1)
        np.testing.assert_array_equal(
            nn(flat), np.arange(offsets[name], offsets[name] + flat.numel(),
                                dtype=np.float32))
    assert int(v["wt"].reshape(-1)[-1]) == numel - 1


def test_plain_scan_matches_pallas_kernel_interpret():
    from thunder_tpu.ops import pallas_likelihood as jpl

    rng = np.random.default_rng(7)
    b, p, k, r, t = 5, 128, 1, 70, 3
    dat, ctf, sig_rcp, proj, tra, pm = _problem(rng, b, p, k, r, t, 0.02)
    q = (-2.0 * sig_rcp * ctf * pm) * np.conj(dat)
    e = sig_rcp * ctf ** 2 * pm
    pr = np.full((b, r), 1.0 / r, np.float32)
    pt = np.full((b, t), 1.0 / t, np.float32)
    ref = jpl.global_scan_fused(jnp.asarray(q), jnp.asarray(e),
                                jnp.asarray(proj), jnp.asarray(tra),
                                jnp.asarray(pr), jnp.asarray(pt), k=k,
                                interpret=True)
    got = tlh.scan_fused(tt(q.astype(np.complex64)), tt(e), tt(proj),
                         tt(tra), tt(pr), tt(pt))
    for name in ("wC", "wR", "wT"):
        assert np.abs(_norm(nn(got[name])) - _norm(ref[name])).max() < 5e-2
    assert np.argmax(nn(got["wR"])[0]) == np.argmax(np.asarray(ref["wR"])[0])


def test_local_search_weights_match():
    rng = np.random.default_rng(8)
    b, r, t, p = 4, 9, 5, 64
    dat, ctf, sig_rcp, _, _, pm = _problem(rng, b, p, 1, 4, 1)
    proj = (rng.normal(size=(b, r, p)) + 1j * rng.normal(size=(b, r, p))
            ).astype(np.complex64) * 0.1
    tra = np.exp(1j * rng.uniform(0, 2 * np.pi, (b, t, p))).astype(
        np.complex64)
    w_r = rng.dirichlet(np.ones(r), size=b).astype(np.float32)
    w_t = rng.dirichlet(np.ones(t), size=b).astype(np.float32)
    u_r, u_t, _ = jlh.local_search_weights(
        jnp.asarray(dat), jnp.asarray(ctf), jnp.asarray(sig_rcp),
        jnp.asarray(proj), jnp.asarray(tra), jnp.asarray(w_r),
        jnp.asarray(w_t), pixel_mask=jnp.asarray(pm))
    g_r, g_t = tlh.local_search_weights(
        tt(dat), tt(ctf), tt(sig_rcp), tt(proj), tt(tra), tt(w_r), tt(w_t),
        pixel_mask=tt(pm))
    assert rel_err(nn(g_r), u_r) < 1e-4
    assert rel_err(nn(g_t), u_t) < 1e-4
    np.testing.assert_allclose(
        nn(tlh.sigma_reciprocal(tt(np.array([0.5, 2.0], np.float32)))),
        np.asarray(jlh.sigma_reciprocal(jnp.asarray([0.5, 2.0]))))


def test_scan_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(9)
    dat, ctf, sig_rcp, proj, tra, pm = _problem(rng, 3, 32, 1, 4, 2)
    q, e = tt(dat), tt(ctf)
    pr = torch.full((3, 4), 0.25)
    pt = torch.full((3, 2), 0.5)
    with pytest.raises(ValueError):
        tlh.scan_fused(q, e, tt(proj), tt(tra), pr, pt[:, :1])
    with pytest.raises(ValueError):
        tlh.scan_fused(q, e.double(), tt(proj), tt(tra), pr, pt)


@pytest.mark.cuda
def test_scan_kernel_matches_plain_on_card():
    """Kernel K1 against its plain version on the card (chip_smoke.py
    holds it at the slice's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(10)
    dat, ctf, sig_rcp, proj, tra, pm = _problem(rng, 37, 256, 1, 200, 7)
    dev = torch.device("cuda")
    args = [tt(x).to(dev) for x in (dat, ctf, sig_rcp, proj, tra)]
    q, e = tlh._q_e(*args[:3], tt(pm).to(dev))
    ref = tlh.scan_plain(q, e, args[3], args[4],
                         *tlh._uniform_priors(37, 200, 7, dev))
    got = tlh.global_search_weights_fused(*args, pixel_mask=tt(pm).to(dev))
    # the bars of chip_smoke.py: normalised wR/wT within 1e-3, raw
    # marginals within 1e-2 relative (bf16 operands)
    for name in ("wR", "wT"):
        assert np.abs(_norm(nn(got[name])) - _norm(nn(ref[name]))).max() \
            < 1e-3
    for name in ("wC", "wR", "wT"):
        assert rel_err(nn(got[name]), nn(ref[name])) < 1e-2
