"""Port parity: the MKB blob gridding kernel (``Para.mkb_kernel``, the
reference's RECONSTRUCTOR_MKB_KERNEL, src/Reconstructor.cpp:452-556).

- ``kernels.mkb_ft`` and ``mkb_blob_vol`` within 1e-6;
- ``brick.mkb_rows3``: indices and validity exactly, weights within 1e-6
  (the two packages' exp and sqrt round differently in the last bit);
- ``insert3_mkb`` + ``fold_insert3`` within 1e-5 of the peak;
- ``reconstruct_cropped(insert_kernel="mkb")`` (its taper radius and
  envelope), and the round trip project -> MKB insert -> reconstruct
  (FSC against the phantom > 0.9 over shells 1-8, the JAX package's bar
  in tests/test_brick.py);
- the engine's ``insert_fold_reduce`` with MKB at K = 1 and K = 2, fused
  and staged class by class;
- chip_smoke.py's float64 gridding of an MKB chunk (``mkb_grid_f64``,
  ``MkbChunkCheck``) against the insert, which path F holds on the card;
- a global round with ``mkb_kernel=True`` from the JAX state, and the
  reconstruction after it, at the slice test's tolerances; the MKB
  reference correlates > 0.9 with the trilinear one from the same state
  (the JAX package's bar, tests/test_optimiser_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from thunder_tpu.config import Para as JPara
from thunder_tpu.core import reconstructor as jrec
from thunder_tpu.core.optimiser import Optimiser as JOptimiser
from thunder_tpu.geom import quat as jquat
from thunder_tpu.ops import brick as jbrick
from thunder_tpu.ops import kernels as jk
from thunder_tpu.ops.pixels import pixel_ring
from thunder_tpu.parallel import engine as jeng
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.core import projector as tproj
from thunder_tpu_torch.core import reconstructor as trec
from thunder_tpu_torch.ops import brick as tbrick
from thunder_tpu_torch.ops import fft as tfft
from thunder_tpu_torch.ops import kernels as tk
from thunder_tpu_torch.ops import spectrum as tspec
from thunder_tpu_torch.parallel import engine as teng

from test_optimiser_e2e import _make_dataset
from test_torch_slice import _angles, _para, _port
from test_torch_support import (JaxDraws, insert_draws, jax_state, nn,
                                rel_err, tt)

torch.set_num_threads(1)


def test_kernel_profiles_match():
    r = np.linspace(0.0, 2.5, 501).astype(np.float32)
    for a, alpha in ((1.9, 15.0), (2.0, 10.0), (1.25, 4.0)):
        want = np.asarray(jk.mkb_ft(jnp.asarray(r), a, alpha))
        got = nn(tk.mkb_ft(tt(r), a, alpha))
        assert want[-1] == got[-1] == 0.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        vol_j = float(jk.mkb_blob_vol(a, alpha))
        assert abs(float(tk.mkb_blob_vol(a, alpha)) - vol_j) <= 1e-6 * vol_j


def _samples(rng, mc, shape=(3, 60)):
    h = mc // 2
    coords = rng.uniform(-h - 1.5, h + 1.5, shape + (3,)).astype(np.float32)
    coords.reshape(-1, 3)[:4] = [[h - 2, 0, 0], [-h + 1, 0.5, 0.0],
                                 [0, h - 1.0, 0], [0, 0, -h]]  # band edge
    fv = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    tv = rng.uniform(0, 2, shape).astype(np.float32)
    return coords, fv, tv


def test_mkb_rows_match():
    """All 8 rows: the same voxel rows and validity (the rows at
    floor(u) - 1 + {0, 2} dropped exactly where the JAX package drops
    them) and the same blob weights."""
    rng = np.random.default_rng(0)
    mc = 15
    coords, _, _ = _samples(rng, mc)
    jr = jbrick.mkb_rows3(jnp.asarray(coords), mc)
    tr_ = tbrick.mkb_rows3(tt(coords), mc)
    assert len(tr_) == len(jr) == 8
    n_drop = 0
    for (ji, jw, jv), (ti, tw, tv_) in zip(jr, tr_):
        np.testing.assert_array_equal(nn(ti), np.asarray(ji))
        np.testing.assert_array_equal(nn(tv_), np.asarray(jv))
        np.testing.assert_allclose(nn(tw), np.asarray(jw), rtol=0, atol=1e-6)
        n_drop += int((~np.asarray(jv)).sum())
    assert n_drop > 0
    # the blob's weights: at most 1, 0 past the radius
    w = np.concatenate([nn(t[1]) for t in tr_], -1)
    assert w.max() <= 1.0 and (w == 0).any()


def test_insert3_mkb_and_fold_match():
    rng = np.random.default_rng(1)
    mc = 15
    coords, fv, tv = _samples(rng, mc)
    w = rng.uniform(0.5, 1.5, fv.shape).astype(np.float32)
    for a, alpha, wt in ((1.9, 15.0, None), (2.0, 10.0, w)):
        jt = jbrick.insert3_mkb(
            jbrick.empty_insert3(mc), jnp.asarray(coords), jnp.asarray(fv),
            jnp.asarray(tv), None if wt is None else jnp.asarray(wt), a=a,
            alpha=alpha)
        tab = tbrick.insert3_mkb(
            tbrick.empty_insert3(mc), tt(coords), tt(fv), tt(tv),
            None if wt is None else tt(wt), a=a, alpha=alpha)
        assert rel_err(nn(tab), jt) < 1e-5
        f_j, t_j = jbrick.fold_insert3(jt)
        f_t, t_t = tbrick.fold_insert3(tab)
        assert rel_err(nn(f_t), f_j) < 1e-5
        assert rel_err(nn(t_t), t_j) < 1e-5


def _hermitian_accumulators(rng, mc):
    f = (rng.normal(size=(mc,) * 3) + 1j * rng.normal(size=(mc,) * 3))
    f = f + np.conj(f[::-1, ::-1, ::-1])
    t = rng.uniform(0.5, 1.5, (mc,) * 3)
    t = t + t[::-1, ::-1, ::-1] + 10.0
    return f.astype(np.complex64), t.astype(np.float32)


@pytest.mark.parametrize("kernel", ["mkb", "trilinear"])
def test_reconstruct_cropped_insert_kernel(kernel):
    """Wiener + C-balance + envelope of each insert kernel, cold and
    joined: within 1e-4 of the JAX package's map and weights."""
    rng = np.random.default_rng(2)
    n, mc = 24, 29
    f, t = _hermitian_accumulators(rng, mc)
    fsc = np.linspace(1.0, 0.1, n // 2).astype(np.float32)
    for join in (False, True):
        v_j, w_j = jrec.reconstruct_cropped(
            jnp.asarray(f), jnp.asarray(t), jnp.asarray(fsc), n, pf=2,
            max_radius=6.0, join_half=join, insert_kernel=kernel,
            return_w=True)
        v_t, w_t = trec.reconstruct_cropped(
            tt(f), tt(t), tt(fsc), n, pf=2, max_radius=6.0, join_half=join,
            insert_kernel=kernel, return_w=True)
        assert rel_err(nn(v_t), v_j) < 1e-4
        assert rel_err(nn(w_t), w_j) < 1e-4
    other = trec.reconstruct_cropped(
        tt(f), tt(t), tt(fsc), n, pf=2, max_radius=6.0,
        insert_kernel="trilinear" if kernel == "mkb" else "mkb")
    assert rel_err(nn(other), v_j) > 1e-3  # the kernel matters


def test_mkb_roundtrip_recovers_phantom():
    """project -> MKB insert -> reconstruct_cropped(insert_kernel="mkb")
    on the JAX package's round-trip drive (tests/test_brick.py)."""
    n, pf = 32, 2
    r = n // 2 - 2
    g = np.arange(n) - n // 2
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    vol = np.exp(-((xx - 3) ** 2 + yy ** 2 + zz ** 2) / 18.0) + 0.7 * np.exp(
        -((xx + 4) ** 2 + (yy - 3) ** 2 + (zz + 2) ** 2) / 8.0)
    vol = tt(vol.astype(np.float32))
    ring = pixel_ring(n, 0, r, bucket=256)
    col, row, pm = tt(ring.col), tt(ring.row), tt(ring.mask)
    rots = tt(jquat.rotate3d(jquat.random_quat(jax.random.PRNGKey(1), 600)))
    tab = tproj.build_brick_projectee_3d(vol, r, pf=pf, half=True)
    slices = tproj.project_brick_3d(tab, rots, col, row, pf=pf)
    coords = tproj.slice_coords_3d(rots, col, row, pf=pf)
    acc = tbrick.empty_insert3(tbrick.crop_size(r, pf))
    tv = pm.expand(slices.shape).float()
    acc = tbrick.insert3_mkb(acc, coords, slices * tv, tv)
    f_c, t_c = tbrick.fold_insert3(acc)
    out = trec.reconstruct_cropped(f_c, t_c, torch.ones(n // 2), n, pf=pf,
                                   max_radius=r, insert_kernel="mkb")
    fsc = nn(tspec.frc_fsc(tfft.fft3_center(out), tfft.fft3_center(vol),
                           n // 2, 3))
    assert (fsc[1:9] > 0.9).all(), fsc


@pytest.fixture(scope="module")
def insert_inputs():
    """Random filter supports with two classes, ring data and keys."""
    rng = np.random.default_rng(3)
    n, s, n_r, n_t, r_u = 24, 6, 7, 5, 7
    ring = pixel_ring(n, 0, r_u)
    p = len(ring.col)
    q = rng.normal(size=(2, s, n_r, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    st = {"r": q.astype(np.float32),
          "t": rng.normal(0, 1.5, (2, s, n_t, 2)).astype(np.float32),
          "c": rng.integers(0, 2, (2, s)).astype(np.int32)}
    dat = (rng.normal(size=(2, s, p)) + 1j * rng.normal(size=(2, s, p))
           ).astype(np.complex64)
    ctf = rng.uniform(-1, 1, (2, s, p)).astype(np.float32)
    valid = np.ones((2, s), np.float32)
    valid[1, -1] = 0
    w = (rng.uniform(0.5, 1.5, (2, s)) * valid).astype(np.float32)
    off = rng.normal(0, 0.5, (2, s, 2)).astype(np.float32)
    keys = jeng.plane_keys(jax.random.PRNGKey(31),
                           np.arange(2 * s).reshape(2, s))
    return dict(n=n, ring=ring, st=st, dat=dat, ctf=ctf, w=w, off=off,
                keys=keys, mc=jbrick.crop_size(8, 2))


@pytest.mark.parametrize("k_cls,staged", [(1, False), (2, False), (2, True)])
def test_insert_fold_reduce_mkb_matches(insert_inputs, k_cls, staged):
    """The MKB insert + fold of both halves, with the same draws: fused
    over a K-fold table or class by class with the other classes' weights
    zeroed (as the optimiser stages classes), within 1e-5 of the peak
    (the same samples added in another order; the port adds each image's
    DC draws once)."""
    s = insert_inputs
    n_draw = 4
    col, row, pm = (np.asarray(s["ring"].col), np.asarray(s["ring"].row),
                    np.asarray(s["ring"].mask))
    st = dict(s["st"])
    if k_cls == 1:
        st["c"] = np.zeros_like(st["c"])
    ri, ti = insert_draws(s["keys"].reshape(-1, 2), n_draw,
                          st["r"].shape[2], st["t"].shape[2])
    sh = s["keys"].shape[:2]
    ri, ti = tt(ri).reshape(sh + (n_draw,)), tt(ti).reshape(sh + (n_draw,))
    passes = [(k, s["w"] * (st["c"] == k), {**st, "c": 0 * st["c"]})
              for k in range(k_cls)] if staged else [(None, s["w"], st)]
    for k, w, st_k in passes:
        kk = 1 if staged else k_cls
        f_j, t_j, o_j = jeng.insert_fold_reduce(
            make_mesh(n_devices=1), jnp.asarray(col), jnp.asarray(row),
            jnp.asarray(pm), jnp.asarray(s["dat"]), jnp.asarray(s["ctf"]),
            {key: jnp.asarray(v) for key, v in st_k.items()}, s["keys"],
            jnp.asarray(w), jnp.asarray(s["off"]), jnp.zeros((0, 3, 3)),
            mode="3d", pf=2, n=s["n"], k_classes=kk, mc=s["mc"],
            n_draw=n_draw, chunk=4, insert_kernel="mkb", apply_sym=False)
        f_t, t_t, o_t = teng.insert_fold_reduce(
            tt(col), tt(row), tt(pm), tt(s["dat"]), tt(s["ctf"]),
            {key: tt(v) for key, v in st_k.items()}, ri, ti, tt(w),
            tt(s["off"]), pf=2, n=s["n"], mc=s["mc"], chunk=4,
            k_classes=kk, insert_kernel="mkb")
        assert f_t.shape == f_j.shape
        assert rel_err(nn(f_t), f_j) < 1e-5, k
        assert rel_err(nn(t_t), t_j) < 1e-5, k
        np.testing.assert_allclose(nn(o_t), np.asarray(o_j), rtol=1e-5,
                                   atol=1e-5)
    # the trilinear insert of the same draws differs
    f_tri, _, _ = teng.insert_fold_reduce(
        tt(col), tt(row), tt(pm), tt(s["dat"]), tt(s["ctf"]),
        {key: tt(v) for key, v in passes[-1][2].items()}, ri, ti,
        tt(passes[-1][1]), tt(s["off"]), pf=2, n=s["n"], mc=s["mc"],
        chunk=4, k_classes=1 if staged else k_cls)
    assert rel_err(nn(f_tri), f_j) > 1e-2


def test_smoke_f64_gridding_matches(insert_inputs):
    """chip_smoke.py's card check of path F, on the CPU: the blob gridded
    anew in float64 (``mkb_grid_f64``) against ``insert3_mkb`` folded
    without the mirror, with samples at the band edge, and
    ``MkbChunkCheck`` around the engine's MKB insert; a wrong blob radius
    shows."""
    rng = np.random.default_rng(9)
    mc = 15
    coords, fv, tv = _samples(rng, mc)
    tab = torch.zeros((mc ** 3 + 1, 24))
    tbrick.insert3_mkb(tab, tt(coords), tt(fv), tt(tv))
    f, t = tbrick.fold_insert3(tab, hermitian=False)
    got = torch.stack([f.real, f.imag, t], -1).double()
    want = cs.mkb_grid_f64(tt(coords), tt(fv), tt(tv), mc, 1.9, 15.0)
    assert rel_err(nn(got), nn(want)) < 1e-6
    wrong = cs.mkb_grid_f64(tt(coords), tt(fv), tt(tv), mc, 2.0, 15.0)
    assert rel_err(nn(got), nn(wrong)) > 1e-2
    s = insert_inputs
    ri, ti = insert_draws(s["keys"].reshape(-1, 2), 4, s["st"]["r"].shape[2],
                          s["st"]["t"].shape[2])
    sh = s["keys"].shape[:2]
    with cs.MkbChunkCheck() as chunk:
        teng.insert_fold_reduce(
            tt(s["ring"].col), tt(s["ring"].row), tt(s["ring"].mask),
            tt(s["dat"]), tt(s["ctf"]),
            {**{k: tt(v) for k, v in s["st"].items()},
             "c": torch.zeros(sh, dtype=torch.int32)},
            tt(ri).reshape(sh + (4,)), tt(ti).reshape(sh + (4,)), tt(s["w"]),
            tt(s["off"]), pf=2, n=s["n"], mc=s["mc"], chunk=4,
            insert_kernel="mkb")
    assert teng._insert_chunk_mkb is chunk.real
    out = chunk.check("CPU")
    assert out["mc"] == s["mc"] and out["samples"] > 0
    assert out["max_rel_err"] < 1e-6


@pytest.fixture(scope="module")
def mkb_round():
    """The JAX optimiser with ``mkb_kernel`` on the slice test's drive:
    its state before and after a global round."""
    data = _make_dataset(n=32, n_imgs=32)
    para = dataclasses.replace(_para(), mkb_kernel=True)
    jo = JOptimiser(JPara(**dataclasses.asdict(para)),
                    mesh=make_mesh(n_devices=1))
    vol, imgs, _, _, cp = data
    jo.set_data(imgs, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    before, key0 = jax_state(jo), jo.key
    jrec_ = jo.run_iteration()
    return dict(data=data, para=para, jo=jo, before=before, key0=key0,
                jrec=jrec_, quats=np.asarray(jo.best_quat))


def _from_state(para, data, state, key):
    opt = convert.load_state(_port(para, data), state)
    opt.draws = JaxDraws(para.seed, state["plane_index"])
    opt.draws.key = key
    return opt


def test_mkb_round_from_jax_state(mkb_round):
    """The global round with the MKB insert, replaying the JAX draws: most
    top poses within 1 deg, the resolution shell within 1, finite maps."""
    m = mkb_round
    opt = _from_state(m["para"], m["data"], m["before"], m["key0"])
    assert opt._insert_kernel() == "mkb"
    rec = opt.run_iteration()
    assert abs(rec["res_shell"] - m["jrec"]["res_shell"]) <= 1
    assert rec["r"] == m["jrec"]["r"]
    ang = _angles(opt.best_quat, m["quats"])
    assert np.mean(ang < 1.0) >= 0.75, np.sort(ang)
    assert torch.isfinite(opt.refs).all()


def test_mkb_reconstruction_from_jax_state(mkb_round):
    """From the JAX state after the round: one more MKB reconstruction in
    both packages with the same draws (the slice test's tolerances), and
    the trilinear reconstruction from the same state correlating > 0.9
    with it."""
    m = mkb_round
    jo = m["jo"]
    st, key = jax_state(jo), jo.key
    opt = _from_state(m["para"], m["data"], st, key)
    opt._w_warm = None
    jo._w_warm = {}
    jo.reconstruct()
    opt.reconstruct()
    assert np.max(np.abs(opt.fsc - np.asarray(jo.fsc))) < 2e-3
    assert rel_err(nn(opt.refs), np.asarray(jo.refs)) < 2e-3
    tri = _from_state(dataclasses.replace(m["para"], mkb_kernel=False),
                      m["data"], st, key)
    tri._w_warm = None
    tri.reconstruct()
    a, b = nn(tri.refs).ravel(), nn(opt.refs).ravel()
    assert float(np.corrcoef(a, b)[0, 1]) > 0.9
    assert rel_err(b, a) > 1e-3  # not the trilinear map
