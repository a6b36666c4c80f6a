"""Port parity for 2D classification: every 2D function the port adds,
fed the same inputs and the same ``jax.random`` draws as its JAX
counterpart, then 2D rounds of the optimiser (K = 2, n = 32,
tests/test_optimiser_2d.py's two-class stack, f32 tables as that test
uses them).

- Geometry, sampling and the von Mises functions: rotations, scan angles,
  kappa, pdf, I0, the sampler on replayed uniforms, the resultant
  inference.
- The 2D filter: perturbation, concentration, posterior update and the
  seeding from the scan, on replayed draws.
- 2D brick tables, projection, the width-12 insert and fold, the 2D
  reconstruction; the engine's 2D scan, phase loop, class-fused insert
  and residual statistics.
- A global and a local round, each from the JAX state before it; and
  ``run(max_iter=4, finalise=False)`` from identical references, the
  port replaying the JAX draws: the same ladder and class purity at least
  the JAX chain's less 5 points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.config import Para as JPara
from thunder_tpu.core import optimiser as jom
from thunder_tpu.core import particle as jpar
from thunder_tpu.core import projector as jproj
from thunder_tpu.core import reconstructor as jrec
from thunder_tpu.core import sampling as jsamp
from thunder_tpu.geom import directional as jdir
from thunder_tpu.geom import quat as jquat
from thunder_tpu.ops import brick as jbrick
from thunder_tpu.ops import pixels as jpixels
from thunder_tpu.ops.translate import translation_phase as jtra
from thunder_tpu.parallel import engine as jeng
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.core import particle as tpar
from thunder_tpu_torch.core import projector as tproj
from thunder_tpu_torch.core import reconstructor as trec
from thunder_tpu_torch.core import sampling as tsamp
from thunder_tpu_torch.geom import directional as tdir
from thunder_tpu_torch.geom import quat as tquat
from thunder_tpu_torch.ops import brick as tbrick
from thunder_tpu_torch.parallel import engine as teng

from test_optimiser_2d import _make_dataset
from test_torch_support import (JaxDraws, insert_draws, jax_state, nn,
                                per_image_draws_2d, rel_err, seed_draws, tt)

torch.set_num_threads(1)

N = 32
CPU = torch.device("cpu")


def _keys(b, seed=0):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(jnp.arange(b))


def _vms_uniforms(keys, n):
    """``sample_vms``'s uniforms from (B, 2) keys, as it draws them."""
    kv = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    r = jdir.VMS_PROPOSAL_ROUNDS
    uni = lambda shape, **kw: jax.vmap(
        lambda k: jax.random.uniform(k, shape, jnp.float32, **kw))
    return {"u_z": tt(uni((r, n))(kv[:, 1])),
            "u_2": tt(uni((r, n), minval=1e-12)(kv[:, 0])),
            "u_s": tt(uni((n,))(kv[:, 2])),
            "theta": tt(uni((n,), maxval=2 * jnp.pi)(kv[:, 1]))}


def _support_2d(rng, b, n, spread):
    phi = rng.uniform(0, 2 * np.pi, (b, 1)) + spread * rng.normal(size=(b, n))
    z = np.zeros_like(phi)
    return np.stack([np.cos(phi), np.sin(phi), z, z], -1).astype(np.float32)


def test_rotations_and_scan_angles():
    rng = np.random.default_rng(0)
    phi = rng.uniform(-4, 4, (3, 5)).astype(np.float32)
    np.testing.assert_allclose(nn(tquat.rotate2d(tt(phi))),
                               np.asarray(jquat.rotate2d(jnp.asarray(phi))),
                               rtol=1e-6, atol=1e-7)
    v = _support_2d(rng, 4, 6, 1.0)[..., :2]
    np.testing.assert_array_equal(nn(tquat.rotate2d_vec(tt(v))),
                                  np.asarray(jquat.rotate2d_vec(
                                      jnp.asarray(v))))
    key = jax.random.PRNGKey(4)
    u = tt(jax.random.uniform(key, (100,)))
    np.testing.assert_array_equal(
        nn(tsamp.sample_rotations_2d(u)),
        np.asarray(jsamp.sample_rotations_2d(key, 100)))
    assert tsamp.n_scan_rotations(100, 3, "2d") == jsamp.n_scan_rotations(
        100, 3, "2d") == 100


def test_vms_functions():
    rng = np.random.default_rng(1)
    k = np.array([1e-7, 0.01, 0.2, 0.5, 0.9, 1.0, 1.5], np.float32)
    np.testing.assert_allclose(nn(tdir._vms_kappa(tt(k))),
                               np.asarray(jdir._vms_kappa(jnp.asarray(k))),
                               rtol=1e-6)
    x = rng.uniform(0, 30, 50).astype(np.float32)
    np.testing.assert_allclose(nn(tdir.bessel_i0(tt(x))),
                               np.asarray(jdir._bessel_i0(jnp.asarray(x))),
                               rtol=1e-5)
    pts = _support_2d(rng, 1, 40, 2.0)[0, :, :2]
    mu = np.array([0.6, 0.8], np.float32)
    for kk in (0.01, 0.3, 0.9):
        np.testing.assert_allclose(
            nn(tdir.pdf_vms(tt(pts), tt(mu), torch.tensor(kk))),
            np.asarray(jdir.pdf_vms(jnp.asarray(pts), jnp.asarray(mu), kk)),
            rtol=1e-5, atol=1e-7)
    w = rng.uniform(0, 1, 40).astype(np.float32)
    m_t, k_t = tdir.infer_vms(tt(pts), tt(w))
    m_j, k_j = jdir.infer_vms(jnp.asarray(pts), jnp.asarray(w))
    np.testing.assert_allclose(nn(m_t), np.asarray(m_j), rtol=1e-5)
    np.testing.assert_allclose(float(k_t), float(k_j), rtol=1e-5)


@pytest.mark.parametrize("k", [0.05, 0.3, 0.95, 1.0])
def test_sample_vms_replays_jax(k):
    """The sampler on the uniforms JAX draws from the same key: the same
    points (the first accepted of 8 proposals, the uniform case at small
    kappa), also as quaternion slots."""
    keys = _keys(6, seed=int(k * 100))
    u = _vms_uniforms(keys, 50)
    mu = np.array([0.28, 0.96], np.float32)
    got = tdir.sample_vms(tt(mu), torch.full((6,), k), **u)
    want = jax.vmap(lambda kk: jdir.sample_vms(kk, jnp.asarray(mu), k, 50))(
        keys)
    np.testing.assert_allclose(nn(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    mu4 = np.array([0.28, 0.96, 0.0, 0.0], np.float32)
    got4 = tdir.sample_vms_quat(tt(mu4), torch.full((6,), k), **u)
    np.testing.assert_allclose(nn(got4)[..., :2], nn(got))
    assert float(got4[..., 2:].abs().max()) == 0.0


def test_filter_2d_matches():
    """Perturbation, concentration, posterior update and vari_shrank in 2D
    mode on replayed draws."""
    rng = np.random.default_rng(2)
    b, n_r, n_t = 5, 9, 6
    r = _support_2d(rng, b, n_r, 0.3)
    k1 = rng.uniform(0.01, 0.5, b).astype(np.float32)
    keys = _keys(b, 7)
    got = tpar.perturb_r_2d(tt(r), tt(k1), 0.5, _vms_uniforms(keys, n_r))
    want = jpar.perturb_r_2d(keys, jnp.asarray(r), jnp.asarray(k1), 0.5)
    np.testing.assert_allclose(nn(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(nn(tpar.cal_vari_r_2d(tt(r))),
                               np.asarray(jpar.cal_vari_r_2d(jnp.asarray(r))),
                               rtol=1e-5)
    assert tpar.peak_idx_r(100, "2d") == jpar.peak_idx_r(100, "2d") == 50
    st = {k: np.asarray(v) for k, v in jpar.make_state(b, n_r, n_t).items()}
    st.update(r=r, t=rng.normal(0, 1, (b, n_t, 2)).astype(np.float32),
              pfR=np.full(b, 0.1, np.float32), pfT=np.full(b, 0.2, np.float32))
    u_r = rng.uniform(0, 1, (b, n_r)).astype(np.float32)
    u_t = rng.uniform(0, 1, (b, n_t)).astype(np.float32)
    k4 = jax.vmap(lambda kk: jax.random.split(kk, 4))(keys)
    ref = jpar.update_from_likelihood(
        {k: jnp.asarray(v) for k, v in st.items()}, k4, jnp.asarray(u_r),
        jnp.asarray(u_t), mode="2d")
    u0 = lambda i: tt(jax.vmap(lambda kk: jax.random.uniform(
        kk, (), jnp.float32))(k4[:, i]))
    new = tpar.update_from_likelihood(
        {k: tt(v) for k, v in st.items()}, tt(u_r), tt(u_t), u0(0), u0(1),
        None, mode="2d")
    for k in ("r", "t", "topR", "topT", "k1", "k2", "k3", "s0", "s1"):
        np.testing.assert_allclose(nn(new[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    prev = {k: tt(v) for k, v in st.items()}
    np.testing.assert_array_equal(
        nn(tpar.vari_shrank(new, prev, mode="2d")),
        np.asarray(jpar.vari_shrank(ref, {k: jnp.asarray(v) for k, v in
                                          st.items()}, mode="2d")))


def test_init_from_scan_2d_matches():
    rng = np.random.default_rng(3)
    b, k, r, t = 6, 3, 40, 30
    w_c = rng.uniform(0, 1, (b, k)).astype(np.float32)
    w_r = rng.uniform(0, 1, (b, k, r)).astype(np.float32) ** 6
    w_t = rng.uniform(0, 1, (b, k, t)).astype(np.float32) ** 6
    phis = rng.uniform(0, 2 * np.pi, r).astype(np.float32)
    z = np.zeros_like(phis)
    quats = np.stack([np.cos(phis), np.sin(phis), z, z], -1)
    trans = rng.normal(0, 2, (t, 2)).astype(np.float32)
    keys = _keys(b, 9)
    ref = jpar.init_from_scan(
        jax.vmap(lambda kk: jax.random.split(kk, 3))(keys), jnp.asarray(w_c),
        jnp.asarray(w_r), jnp.asarray(w_t), jnp.asarray(quats),
        jnp.asarray(trans), 9, 9, 1, mode="2d")
    g, u_r, u_t = (tt(x) for x in seed_draws(keys, k))
    got = tpar.init_from_scan(tt(w_c), tt(w_r), tt(w_t), tt(quats),
                              tt(trans), 9, 9, 1, g, u_r, u_t, mode="2d")
    np.testing.assert_array_equal(nn(got["c"]), np.asarray(ref["c"]))
    for key in ("r", "t", "topR", "topT", "k1", "k2", "k3", "s0", "s1",
                "pfR", "pfT"):
        np.testing.assert_allclose(nn(got[key]), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("bf16", [False, True])
def test_brick_tables_and_projection_2d(bf16):
    """2D brick tables (leading class axes, f32 and packed bf16 pairs)
    bit-identical, slice coordinates and projections at 1e-5, corner
    indices exact."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, N, N)).astype(np.float32)
    dt_t = torch.bfloat16 if bf16 else torch.float32
    dt_j = jnp.bfloat16 if bf16 else jnp.float32
    tab_t = tproj.build_brick_projectee_2d(tt(img), 10, pf=2, dtype=dt_t)
    tab_j = jproj.build_brick_projectee_2d(jnp.asarray(img), 10, pf=2,
                                           dtype=dt_j)
    assert tab_t.shape == tab_j.shape
    assert rel_err(nn(tab_t), np.asarray(tab_j)) < 1e-5
    ring = jpixels.pixel_ring(N, 1, 10)
    rot = np.asarray(jquat.rotate2d(jnp.asarray(
        rng.uniform(0, 6.3, (3, 4)).astype(np.float32))))
    c_t = tproj.slice_coords_2d(tt(rot), tt(ring.col), tt(ring.row))
    c_j = jproj.slice_coords_2d(jnp.asarray(rot), jnp.asarray(ring.col),
                                jnp.asarray(ring.row))
    np.testing.assert_allclose(nn(c_t), np.asarray(c_j), rtol=1e-6,
                               atol=1e-5)
    mc = tab_t.shape[-2]
    for a, b in zip(tbrick._corners2(c_t, mc), jbrick._corners2(c_j, mc)):
        np.testing.assert_allclose(nn(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    p_t = tproj.project_brick_2d(tab_t[1], tt(rot), tt(ring.col),
                                 tt(ring.row))
    p_j = jproj.project_brick_2d(tab_j[1], jnp.asarray(rot),
                                 jnp.asarray(ring.col), jnp.asarray(ring.row))
    assert rel_err(nn(p_t), np.asarray(p_j)) < 1e-5


def test_insert_fold_and_reconstruct_2d():
    """Width-12 insert (index_add_), fold with the Hermitian mirror and the
    2D Wiener/C-balance reconstruction."""
    rng = np.random.default_rng(5)
    mc = jbrick.crop_size(8, 2)
    coords = rng.uniform(-mc / 2, mc / 2, (300, 2)).astype(np.float32)
    fv = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(
        np.complex64)
    tv = rng.uniform(0, 1, 300).astype(np.float32)
    w = rng.uniform(0, 1, 300).astype(np.float32)
    t_tab = tbrick.insert2(tbrick.empty_insert2(mc), tt(coords), tt(fv),
                           tt(tv), tt(w))
    j_tab = jbrick.insert2(jbrick.empty_insert2(mc), jnp.asarray(coords),
                           jnp.asarray(fv), jnp.asarray(tv), jnp.asarray(w))
    assert rel_err(nn(t_tab), np.asarray(j_tab)) < 1e-5
    f_t, t_t = tbrick.fold_insert2(t_tab)
    f_j, t_j = jbrick.fold_insert2(j_tab)
    assert rel_err(nn(f_t), np.asarray(f_j)) < 1e-5
    assert rel_err(nn(t_t), np.asarray(t_j)) < 1e-5
    fsc = np.linspace(1.0, 0.1, N // 2).astype(np.float32)
    t_pos = np.asarray(t_j) + 0.5
    v_t, w_t = trec.reconstruct_cropped(f_t, tt(t_pos), tt(fsc), N, pf=2,
                                        max_radius=8.0, return_w=True, dims=2)
    v_j, w_j = jrec.reconstruct_cropped(f_j, jnp.asarray(t_pos),
                                        jnp.asarray(fsc), N, pf=2,
                                        max_radius=8.0, return_w=True,
                                        dims=2)
    assert rel_err(nn(v_t), np.asarray(v_j)) < 1e-4
    assert rel_err(nn(w_t), np.asarray(w_j)) < 1e-4


@pytest.fixture(scope="module")
def setup():
    """tests/test_optimiser_2d.py's stack and Para (f32 tables), a JAX
    optimiser set up on it, and its first global round's states."""
    classes, imgs, true_cls, phis, cp = _make_dataset()
    para = Para(mode="2d", k=2, size=N, pixel_size=2.0, mask_radius=26.0,
                m_s=256, m_l_r=16, m_l_t=4, m_l_d=4, m_reco=8, trans_s=1.5,
                init_res=8.0, global_search_res=4.2, sym="C1",
                save_ref_each_iter=False, save_thu_each_iter=False, seed=11,
                table_bf16=False)
    jo = jom.Optimiser(JPara(**dataclasses.asdict(para)),
                       mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.init_reference()
    jo.init_sigma()
    states, keys, recs, phi_top = [jax_state(jo)], [jo.key], [], []
    for i in range(4):
        if i == 3:  # a local round: LOCAL at the band the ladder reached
            jo.ladder.search_type = jom.SEARCH_TYPE_LOCAL
            jo.ladder.n_no_decrease = 0
            states[-1] = jax_state(jo)
        recs.append(jo.run_iteration())
        phi_top.append(np.asarray(jo.best_phi))
        states.append(jax_state(jo))
        keys.append(jo.key)
    return dict(imgs=imgs, cp=cp, true_cls=true_cls, para=para, jo=jo,
                states=states, keys=keys, recs=recs, phi_top=phi_top)


def _port(s, draws=None):
    op = tom.Optimiser(s["para"], device=CPU, draws=draws)
    op.set_data(s["imgs"], s["cp"])
    return op


def _from_state(s, i):
    op = convert.load_state(_port(s), s["states"][i])
    op.draws = JaxDraws(s["para"].seed, s["states"][i]["plane_index"])
    op.draws.key = s["keys"][i]
    return op


def test_setup_and_tables_match(setup):
    s = setup
    op = _port(s)
    op.init_reference()
    op.init_sigma()
    st = s["states"][0]
    assert rel_err(nn(op.refs), st["refs"]) < 1e-6
    assert rel_err(nn(op.sig), st["sig"]) < 1e-5
    assert op.refs.shape == (2, 2, N, N)
    assert rel_err(nn(op._bricks()), np.asarray(
        jom._built_tabs(jnp.asarray(st["refs"]), "2d", 8, 2, False))) < 1e-5


def test_engine_2d_matches(setup):
    """The engine's 2D scan (seeding included), three phases of the 2D
    filter, the class-fused 2D insert and the residual statistics, each
    from the state after the first JAX round with the same draws."""
    s = setup
    jo = s["jo"]
    st = s["states"][1]
    mesh = make_mesh(n_devices=1)
    refs = st["refs"]
    tabs = jom._built_tabs(jnp.asarray(refs), "2d", 8, 2, False)
    tb = tt(tabs)
    ring = jpixels.pixel_ring(N, 1, 8)
    col, row, pm = (jnp.asarray(ring.col), jnp.asarray(ring.row),
                    jnp.asarray(ring.mask))
    o = convert.load_state(_port(s), st)
    dat, c, sig = (x.numpy() for x in o._plane_ring_data(ring))
    phis = jsamp.sample_rotations_2d(jax.random.PRNGKey(3), 40)
    z = jnp.zeros_like(phis)
    quats = jnp.stack([jnp.cos(phis), jnp.sin(phis), z, z], -1)
    trans = 1.5 * jax.random.normal(jax.random.PRNGKey(4), (12, 2))
    tra = jtra(col, row, trans[:, 0], trans[:, 1], N)
    keys = jeng.plane_keys(jax.random.PRNGKey(5), st["plane_index"])
    js, jwc = jeng.scan_init(
        mesh, tabs, jquat.rotate2d(phis), quats, tra, trans, col, row, pm,
        jnp.asarray(dat), jnp.asarray(c), jnp.asarray(sig), keys, mode="2d",
        pf=2, m_l_r=16, m_l_t=4, m_l_d=4, chunk=16, fused="off")
    sh = keys.shape[:2]
    g, u_r, u_t = (tt(x).reshape(sh + np.shape(x)[1:]) for x in
                   seed_draws(keys.reshape(-1, 2), 2))
    ts, twc = teng.scan_init(
        tb, tt(jquat.rotate2d(phis)), tt(quats), tt(tra), tt(trans), tt(col),
        tt(row), tt(pm), tt(dat), tt(c), tt(sig), g, u_r, u_t, pf=2,
        m_l_r=16, m_l_t=4, m_l_d=4, chunk=16, mode="2d")
    assert rel_err(nn(twc), jwc) < 1e-4
    np.testing.assert_array_equal(nn(ts["c"]), np.asarray(js["c"]))
    for k in ("r", "t", "topR", "topT", "k1", "s0", "s1"):
        np.testing.assert_allclose(nn(ts[k]), np.asarray(js[k]), atol=1e-4,
                                   err_msg=k)
    # three phases of the filter from the JAX seeding
    st0 = {k: np.asarray(v) for k, v in js.items()}
    st0["d"] = np.asarray(st["par"]["d"])
    s2 = st0["k1"].shape
    jst = {**{k: jnp.asarray(v) for k, v in st0.items()},
           "_done": jnp.zeros(s2, bool), "_noDec": jnp.zeros(s2, jnp.int32),
           "_nph": jnp.zeros(s2, jnp.int32)}
    kb = jeng.plane_keys(jax.random.PRNGKey(21), st["plane_index"])
    f = lambda x: jnp.asarray(x, jnp.float32)
    ref = jeng.local_search(
        mesh, tabs, col, row, pm, jnp.asarray(dat), jnp.asarray(c),
        jnp.asarray(sig), jst, kb, jeng.pack_ctf(jo.ctf_params),
        jnp.zeros((0, 4)), f(2.0), f(0.5), f(0.5), jnp.asarray(0, jnp.int32),
        mode="2d", pf=2, n=N, pixel_size=2.0, ctf_search=False, min_phase=10,
        chunk=16, n_phases=3)
    flat_k = kb.reshape(-1, 2)

    def draws(phase):
        kph = jax.vmap(jax.random.fold_in)(
            flat_k, jnp.full((flat_k.shape[0],), phase, jnp.uint32))
        return {k: tt(v).reshape(sh + np.shape(v)[1:])
                for k, v in per_image_draws_2d(kph, 16, 4).items()}

    got, nph = teng.local_search(
        tb, tt(col), tt(row), tt(pm), tt(dat), tt(c), tt(sig),
        {k: tt(v) for k, v in st0.items()}, draws, torch.zeros(0, 4), 2.0,
        0.5, pf=2, n=N, min_phase=10, max_phase=3, mode="2d")
    agree = np.abs(np.sum(nn(got["topR"]) * np.asarray(ref["topR"]), -1))
    assert np.mean(agree > 0.9999) >= 0.9, agree
    # class-fused 2D insert (width-12 rows)
    ring_i = jpixels.pixel_ring(N, 0, 7)
    ci, ri_, pi_ = (jnp.asarray(ring_i.col), jnp.asarray(ring_i.row),
                    jnp.asarray(ring_i.mask))
    d_i, c_i, _ = (x.numpy() for x in o._plane_ring_data(ring_i, ori=True))
    sti = {k: np.asarray(js[k]) for k in ("r", "t", "c")}
    w = (np.asarray(st["plane_valid"]) / 5).astype(np.float32)
    off = np.random.default_rng(6).normal(0, 0.5, w.shape + (2,)).astype(
        np.float32)
    mc = jbrick.crop_size(8, 2)
    f_r, t_r, o_r = jeng.insert_fold_reduce(
        mesh, ci, ri_, pi_, jnp.asarray(d_i), jnp.asarray(c_i),
        {k: jnp.asarray(v) for k, v in sti.items()}, keys, jnp.asarray(w),
        jnp.asarray(off), jnp.zeros((0, 3, 3)), mode="2d", pf=2, n=N,
        k_classes=2, mc=mc, n_draw=5, chunk=16, apply_sym=False)
    ri, ti = insert_draws(keys.reshape(-1, 2), 5, 16, 4)
    f_g, t_g, o_g = teng.insert_fold_reduce(
        tt(ci), tt(ri_), tt(pi_), tt(d_i), tt(c_i),
        {k: tt(v) for k, v in sti.items()}, tt(ri).reshape(sh + (5,)),
        tt(ti).reshape(sh + (5,)), tt(w), tt(off), pf=2, n=N, mc=mc,
        chunk=7, k_classes=2, mode="2d")
    assert f_g.shape == (2, 2, mc, mc)
    assert rel_err(nn(f_g), f_r) < 1e-5
    assert rel_err(nn(t_g), t_r) < 1e-5
    np.testing.assert_allclose(nn(o_g), np.asarray(o_r), rtol=1e-5,
                               atol=1e-5)
    # residual statistics at the rank-1 pose
    dat_o = o._plane_ring_data(ring, ori=True)[0].numpy()
    state = {k: np.asarray(js[k]) for k in ("topR", "topT", "c")}
    args = (col, row, jnp.asarray(ring.sig), pm, jnp.asarray(dat),
            jnp.asarray(dat_o), jnp.asarray(c))
    gp, vp = jnp.asarray(st["groups_plane"]), jnp.asarray(st["plane_valid"])
    res_j = jeng.residual_stats(
        mesh, tabs, *args, {k: jnp.asarray(v) for k, v in state.items()},
        gp, vp, jnp.asarray(off), mode="2d", pf=2, n=N, n_groups=1,
        n_shell=N // 2, chunk=16)
    res_t = teng.residual_stats(
        tb, *[tt(a) for a in args], {k: tt(v) for k, v in state.items()},
        tt(gp), tt(vp), tt(off), pf=2, n=N, n_groups=1, n_shell=N // 2)
    for a, b in zip(res_t, res_j):
        assert rel_err(nn(a), b) < 1e-4


@pytest.mark.parametrize("rnd", [0, 3])
def test_round_from_copied_state(setup, rnd):
    """The first global round and a local round (LOCAL at the band the
    ladder reached), each from the JAX state before it with the JAX keys:
    the in-plane angles within 1 deg for at least 75 % of the images, the
    resolution shell within 1, the same ladder and classes within one
    image a class."""
    s = setup
    op = _from_state(s, rnd)
    rec = op.run_iteration()
    jrec = s["recs"][rnd]
    assert rec["search_type"] == jrec["search_type"] and rec["r"] == jrec["r"]
    assert abs(rec["res_shell"] - jrec["res_shell"]) <= 1
    d = np.degrees(np.abs(np.angle(np.exp(1j * (op.best_phi
                                                 - s["phi_top"][rnd])))))
    assert np.mean(d < 1.0) >= 0.75, np.sort(d)
    n_img = op.n_imgs
    assert np.max(np.abs(np.asarray(rec["class_distr"])
                         - np.asarray(jrec["class_distr"]))) * n_img <= 1
    if rnd == 3:  # the local 2D round does not re-centre (as in JAX)
        np.testing.assert_array_equal(nn(op.offsets),
                                      s["states"][rnd]["offsets"])


def test_run_from_identical_references(setup):
    """``run(max_iter=4, finalise=False)`` from identical references, the
    port replaying the JAX chain's draws: the same search types and bands,
    and class purity at least the JAX chain's less 5 points."""
    s = setup
    op = _port(s, JaxDraws(s["para"].seed, s["jo"].plane_index))
    op.init_reference()
    op.init_sigma()
    hist = op.run(max_iter=4, finalise=False)
    jrec = s["recs"]
    assert [h["search_type"] for h in hist[:3]] == [
        h["search_type"] for h in jrec[:3]]
    purity = lambda est: max(np.mean(est == s["true_cls"]),
                             np.mean(est != s["true_cls"]))
    jo = jom.Optimiser(JPara(**dataclasses.asdict(s["para"])),
                       mesh=make_mesh(n_devices=1))
    jo.set_data(s["imgs"], s["cp"])
    jo.init_reference()
    jo.init_sigma()
    jo.run(max_iter=4, finalise=False)
    assert purity(op.best_class) >= purity(jo.best_class) - 0.05, (
        purity(op.best_class), purity(jo.best_class))
    assert np.isfinite(nn(op.refs)).all() and op.refs.shape == (2, 2, N, N)
