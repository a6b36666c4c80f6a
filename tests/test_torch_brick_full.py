"""Port parity: the full-space brick layout and what is built on it.

- ``gather_vol3``, ``insert3`` + ``fold_insert3``, ``pack_real3`` and
  ``gather_real3`` against the JAX package's on the same NumPy inputs;
- the full-space projector (``build_brick_projectee_3d(half=False)`` and
  ``project_brick_3d``), ``project_pixels_3d`` and ``project_pixels_2d``,
  with the band inside the padded box and reaching its edge;
- the brick-state API (``empty_brick_state``, ``insert_brick_3d`` /
  ``insert_brick_2d``, ``finalize_brick``);
- ``Optimiser.run(max_iter=1)`` with the final round under the general
  groups I, D7 and T and with the MKB insert (their rounds are held to
  the JAX package in tests/test_torch_symmetry_general.py and
  tests/test_torch_mkb.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import map_corr, sym_average
from thunder_tpu.core import projector as jproj
from thunder_tpu.core import reconstructor as jrec
from thunder_tpu.geom import quat as jquat
from thunder_tpu.ops import brick as jbrick
from thunder_tpu.ops.pixels import pixel_ring
from thunder_tpu_torch.core import projector as tproj
from thunder_tpu_torch.core import reconstructor as trec
from thunder_tpu_torch.ops import brick as tbrick

from test_optimiser_e2e import _make_dataset
from test_torch_slice import _para, _port
from test_torch_support import nn, rel_err, tt

torch.set_num_threads(1)


def _spectrum(rng, mc):
    x = rng.normal(size=(mc, mc, mc)) + 1j * rng.normal(size=(mc, mc, mc))
    return x.astype(np.complex64)


def _phantom(n, rng):
    g = np.arange(n) - n // 2
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    vol = np.zeros((n, n, n))
    for _ in range(3):
        c = rng.uniform(-n / 6, n / 6, 3)
        vol += np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2
                        + (zz - c[2]) ** 2) / rng.uniform(4, 16))
    return vol.astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_vol3_matches(bf16):
    """Full-space trilinear gather, in and out of band: bit-identical
    tables, equal interpolations (the same f32 products and sums)."""
    rng = np.random.default_rng(0)
    mc = 13
    ft = _spectrum(rng, mc)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jt = jbrick.pack_vol3(jnp.asarray(ft), dtype=jdt)
    tab = tbrick.pack_vol3(tt(ft), dtype=tdt)
    coords = rng.uniform(-8, 8, (4, 50, 3)).astype(np.float32)
    coords[0, :5] = np.round(coords[0, :5])      # exact grid points
    want = np.asarray(jbrick.gather_vol3(jt, jnp.asarray(coords)))
    got = nn(tbrick.gather_vol3(tab, tt(coords)))
    assert (want == 0).any() and (want != 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tbrick.half_rows(mc) == jbrick.half_rows(mc) == 7


def test_insert3_and_fold_match():
    """Trilinear row-major insert with and without extra weights, then the
    fold with and without the Hermitian mirror: within 1e-5 of the JAX
    package's (its scatter adds in another order)."""
    rng = np.random.default_rng(1)
    mc = 11
    coords = rng.uniform(-6, 6, (3, 40, 3)).astype(np.float32)
    fv = (rng.normal(size=(3, 40)) + 1j * rng.normal(size=(3, 40))).astype(
        np.complex64)
    tv = rng.uniform(0, 2, (3, 40)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (3, 40)).astype(np.float32)
    for wt in (None, w):
        jt = jbrick.insert3(jbrick.empty_insert3(mc), jnp.asarray(coords),
                            jnp.asarray(fv), jnp.asarray(tv),
                            None if wt is None else jnp.asarray(wt))
        tab = tbrick.insert3(tbrick.empty_insert3(mc), tt(coords), tt(fv),
                             tt(tv), None if wt is None else tt(wt))
        assert tab.shape == (mc ** 3 + 1, 24)
        assert rel_err(nn(tab), jt) < 1e-5
        for herm in (True, False):
            f_j, t_j = jbrick.fold_insert3(jt, hermitian=herm)
            f_t, t_t = tbrick.fold_insert3(tab, hermitian=herm)
            assert rel_err(nn(f_t), f_j) < 1e-5
            assert rel_err(nn(t_t), t_j) < 1e-5


def test_pack_and_gather_real3_match():
    rng = np.random.default_rng(2)
    mc = 9
    vols = [rng.normal(size=(mc, mc, mc)).astype(np.float32)
            for _ in range(3)]
    jt = jbrick.pack_real3(*map(jnp.asarray, vols))
    tab = tbrick.pack_real3(*map(tt, vols))
    np.testing.assert_array_equal(nn(tab), np.asarray(jt))
    coords = rng.uniform(-5.5, 5.5, (20, 7, 3)).astype(np.float32)
    want = np.asarray(jbrick.gather_real3(jt, jnp.asarray(coords)))
    got = nn(tbrick.gather_real3(tab, tt(coords)))
    assert got.shape == (20, 7, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [8, 11])
def test_full_space_projector_matches(r):
    """The full-space brick table and its central slices, and the padded
    spectrum's ring pixels: a band inside the padded box, and one whose
    crop reaches its edge."""
    rng = np.random.default_rng(3)
    n = 24
    vol = _phantom(n, rng)
    ft_j = jproj.build_projectee_3d(jnp.asarray(vol), pf=2)
    ft_t = tproj.build_projectee_3d(tt(vol), pf=2)
    assert rel_err(nn(ft_t), ft_j) < 1e-5
    jt = jproj.build_brick_projectee_3d(jnp.asarray(vol), r, pf=2, half=False)
    tab = tproj.build_brick_projectee_3d(tt(vol), r, pf=2, half=False)
    assert tab.shape == jt.shape and tab.shape[0] == tab.shape[1]
    assert rel_err(nn(tab), jt) < 1e-5
    ring = pixel_ring(n, 0, r)
    rots = np.asarray(jquat.rotate3d(jquat.random_quat(
        jax.random.PRNGKey(4), 6)))
    args = (jnp.asarray(rots), jnp.asarray(ring.col), jnp.asarray(ring.row))
    targs = (tt(rots), tt(ring.col), tt(ring.row))
    want = np.asarray(jproj.project_brick_3d(jt, *args, pf=2))
    got = nn(tproj.project_brick_3d(tab, *targs, pf=2))
    assert rel_err(got, want) < 1e-5
    # the half-space table of the same volume projects alike
    half = tproj.build_brick_projectee_3d(tt(vol), r, pf=2, half=True)
    assert rel_err(nn(tproj.project_brick_3d(half, *targs, pf=2)), got) < 1e-5
    want = np.asarray(jproj.project_pixels_3d(ft_j, *args, pf=2))
    got = nn(tproj.project_pixels_3d(tt(np.asarray(ft_j)), *targs, pf=2))
    assert rel_err(got, want) < 1e-5
    img = vol[n // 2]
    im_j = jproj.build_projectee_2d(jnp.asarray(img), pf=2)
    im_t = tproj.build_projectee_2d(tt(img), pf=2)
    assert rel_err(nn(im_t), im_j) < 1e-5
    phi = rng.uniform(0, 2 * np.pi, 5)
    rot2 = np.stack([np.stack([np.cos(phi), -np.sin(phi)], -1),
                     np.stack([np.sin(phi), np.cos(phi)], -1)], -2).astype(
        np.float32)
    want = np.asarray(jproj.project_pixels_2d(
        im_j, jnp.asarray(rot2), args[1], args[2], pf=2))
    got = nn(tproj.project_pixels_2d(tt(np.asarray(im_j)), tt(rot2),
                                     targs[1], targs[2], pf=2))
    assert rel_err(got, want) < 1e-5
    tab2 = tproj.build_brick_projectee_2d(tt(img), r, pf=2)
    jt2 = jproj.build_brick_projectee_2d(jnp.asarray(img), r, pf=2)
    assert rel_err(nn(tab2), jt2) < 1e-5


@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_brick_state_api_matches(mode):
    """empty_brick_state -> two insert batches -> finalize_brick."""
    rng = np.random.default_rng(5)
    n, r, b = 24, 8, 6
    ring = pixel_ring(n, 0, r)
    p = len(ring.col)
    if mode == "3d":
        rots = np.asarray(jquat.rotate3d(jquat.random_quat(
            jax.random.PRNGKey(6), 2 * b)))
    else:
        phi = rng.uniform(0, 2 * np.pi, 2 * b)
        rots = np.stack([np.stack([np.cos(phi), -np.sin(phi)], -1),
                         np.stack([np.sin(phi), np.cos(phi)], -1)], -2)
    rots = rots.astype(np.float32)
    vals = (rng.normal(size=(2 * b, p)) + 1j * rng.normal(size=(2 * b, p))
            ).astype(np.complex64)
    ctf = rng.uniform(-1, 1, (2 * b, p)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 2 * b).astype(np.float32)
    pm = np.asarray(ring.mask)
    jst = jrec.empty_brick_state(n, r, pf=2, mode=mode)
    tst = trec.empty_brick_state(n, r, pf=2, mode=mode, device="cpu")
    assert tst["tab"].shape == jst["tab"].shape
    jins = jrec.insert_brick_3d if mode == "3d" else jrec.insert_brick_2d
    tins = trec.insert_brick_3d if mode == "3d" else trec.insert_brick_2d
    for sl in (slice(0, b), slice(b, 2 * b)):
        jst = jins(jst, jnp.asarray(vals[sl]), jnp.asarray(ctf[sl]),
                   jnp.asarray(rots[sl]), jnp.asarray(ring.col),
                   jnp.asarray(ring.row), jnp.asarray(w[sl]), pf=2,
                   pixel_mask=jnp.asarray(pm))
        tst = tins(tst, tt(vals[sl]), tt(ctf[sl]), tt(rots[sl]),
                   tt(ring.col), tt(ring.row), tt(w[sl]), pf=2,
                   pixel_mask=tt(pm))
    f_j, t_j = jrec.finalize_brick(jst, mode=mode)
    f_t, t_t = trec.finalize_brick(tst, mode=mode)
    assert rel_err(nn(f_t), f_j) < 1e-5
    assert rel_err(nn(t_t), t_j) < 1e-5


@pytest.mark.parametrize("sym,mkb", [("I", False), ("D7", False),
                                     ("T", False), ("C1", True)])
def test_run_and_finalise(sym, mkb, tmp_path):
    """``Optimiser.run(max_iter=1)`` with the final round under I, D7 and
    T (trilinear insert) and with the MKB insert: finite half and joined
    maps, the final reference file, and a joined map equal to its own
    group average (correlation > 0.99)."""
    data = _make_dataset(n=32, n_imgs=16)
    para = dataclasses.replace(_para(), sym=sym, mkb_kernel=mkb,
                               output_directory=str(tmp_path) + "/")
    opt = _port(para, data)
    assert opt._insert_kernel() == ("mkb" if mkb else "trilinear")
    hist = opt.run(max_iter=1)
    assert len(hist) == 1 and torch.isfinite(opt.refs).all()
    joined = opt.joined_maps[0]
    assert joined.shape == (32, 32, 32) and torch.isfinite(joined).all()
    assert (tmp_path / "Reference_000_Final.mrc").exists()
    if opt.sym.n_elements:
        corr = map_corr(joined, sym_average(joined, opt.sym.rot))
        assert corr > 0.99, corr
