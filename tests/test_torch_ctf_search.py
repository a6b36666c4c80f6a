"""Port parity for CTF search: the defocus axis of the particle filter.

- Module by module on the same inputs and the same ``jax.random`` draws:
  the CTF at a per-image defocus support, the likelihood's defocus
  marginal, the defocus functions of the particle filter, and the seeding
  of the defocus support on entering CTF search (NumPy, ``seed + 77``).
- The search-type ladder LOCAL -> CTF -> STOP, host state in both
  packages.
- On the slice test's drive (n = 32, 32 particles, C1), after a global
  round: a local round that ends in the switch to CTF search (the port
  seeds the defocus support in ``run_iteration``), CTF search entered by
  hand as the ladder enters it (both packages seed the same support), the
  first phases of ``engine.local_search`` with the CTF search on, from
  that state with the same draws, and one CTF round of ``run_iteration``
  from the JAX state
  (``convert.load_state`` + ``JaxDraws``), held as the slice test holds a
  round: top poses within 1 deg for at least 75 % of images, and the
  refined defocus factor within 1e-4 for as many and within 1e-3 for at
  least 90 %. The defocus supports of the two packages stay equal through
  the first phases (the engine test); over a CTF round's 15-37 phases a
  systematic-resample tie that f32 round-off breaks differently sends a
  few images' supports apart (4 of 32 here, by 1.5e-4 to 5.2e-4, about a
  third of their support's spread), as with poses (ROADMAP Queue 3).
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
from thunder_tpu.ops import ctf as jctf
from thunder_tpu.ops import likelihood as jlh
from thunder_tpu.parallel import engine as jeng
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.core import particle as tpar
from thunder_tpu_torch.ops import ctf as tctf
from thunder_tpu_torch.ops import likelihood as tlh
from thunder_tpu_torch.parallel import engine as teng

from test_optimiser_e2e import _make_dataset
from test_torch_slice import _angles, _para, _port
from test_torch_support import (JaxDraws, jax_state, nn, per_image_draws,
                                rel_err, tt)

torch.set_num_threads(1)

N = 32
N_D = 9  # configs/demo.json's defocus support
R_LOCAL = 12


def _keys(b, seed=0):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(jnp.arange(b))


def _ctf_params(rng, b, cs):
    cp = [np.full(b, 300e3), rng.uniform(1e4, 2e4, b),
          rng.uniform(1e4, 2e4, b), rng.uniform(0, np.pi, b), np.full(b, cs),
          np.full(b, 0.1), np.zeros(b)]
    return [v.astype(np.float32)[:, None] for v in cp]           # (B, 1)


@pytest.mark.parametrize("cs", [0.0, 2.7e7])
def test_ctf_pixels_per_defocus_point(cs):
    """CTF parameters (B, 1) and a defocus factor (B, D) over ring pixels
    (P,) give (B, D, P), as the JAX phase body calls it. The bar is 1e-5
    plus four f32 steps of the phase chi at that pixel: toward Nyquist chi
    reaches ~300 rad (one f32 step 3e-5), where two f32 evaluations of one
    formula part by a step whatever the library."""
    rng = np.random.default_rng(0)
    b, p = 5, 200
    col = rng.integers(-15, 16, p).astype(np.float32)
    row = rng.integers(-15, 16, p).astype(np.float32)
    cp = _ctf_params(rng, b, cs)
    fac = (1 + rng.normal(0, 0.01, (b, N_D))).astype(np.float32)
    ref = jctf.ctf_pixels(jnp.asarray(col), jnp.asarray(row), N, 1.32,
                          *map(jnp.asarray, cp),
                          defocus_factor=jnp.asarray(fac))
    got = tctf.ctf_pixels(tt(col), tt(row), N, 1.32, *map(tt, cp),
                          defocus_factor=tt(fac))
    assert tuple(got.shape) == (b, N_D, p)
    volt, du, dv, theta, c_s = (x.astype(np.float64)[..., None]
                                for x in cp[:5])
    lam = 12.2643247 / np.sqrt(volt * (1 + volt * 0.978466e-6))
    u2 = (col.astype(np.float64) ** 2 + row ** 2) / (1.32 * N) ** 2
    ang = np.arctan2(row, col) - theta
    defocus = -(du + dv + (du - dv) * np.cos(2 * ang)) / 2 * fac[..., None]
    chi = np.pi * lam * defocus * u2 + np.pi / 2 * c_s * lam ** 3 * u2 ** 2
    bar = 1e-5 + 4 * np.spacing(np.abs(chi).astype(np.float32))
    assert (np.abs(nn(got) - np.asarray(ref)) <= bar).all()
    assert float(np.abs(nn(got) - np.asarray(ref))[np.abs(chi) < 32].max()
                 ) < 1e-5


def _weights_problem(rng, b=4, r=9, t=5, p=64, d=N_D):
    dat = ((rng.normal(size=(b, p)) + 1j * rng.normal(size=(b, p)))
           .astype(np.complex64))
    sig_rcp = (-0.5 / rng.uniform(0.5, 2.0, (b, p))).astype(np.float32)
    proj = ((rng.normal(size=(b, r, p)) + 1j * rng.normal(size=(b, r, p)))
            .astype(np.complex64) * 0.1)
    tra = np.exp(1j * rng.uniform(0, 2 * np.pi, (b, t, p))).astype(
        np.complex64)
    ctf_d = rng.uniform(-1, 1, (b, d, p)).astype(np.float32)
    pm = (rng.uniform(size=p) > 0.1).astype(np.float32)
    w = [rng.dirichlet(np.ones(n), size=b).astype(np.float32)
         for n in (r, t, d)]
    return dat, sig_rcp, proj, tra, ctf_d, pm, w


def test_local_search_weights_defocus_axis():
    """u_r, u_t and u_d over a (defocus, rotation, translation) support;
    without ``ctf_d`` the D = 1 result is the one the local round uses."""
    rng = np.random.default_rng(8)
    dat, sig_rcp, proj, tra, ctf_d, pm, (w_r, w_t, w_d) = _weights_problem(
        rng)
    j = jlh.local_search_weights(
        *map(jnp.asarray, (dat, ctf_d[:, 0], sig_rcp, proj, tra, w_r, w_t,
                           w_d)), ctf_d=jnp.asarray(ctf_d),
        pixel_mask=jnp.asarray(pm))
    g = tlh.local_search_weights(
        *map(tt, (dat, ctf_d[:, 0], sig_rcp, proj, tra, w_r, w_t)),
        w_d=tt(w_d), ctf_d=tt(ctf_d), pixel_mask=tt(pm))
    assert tuple(g[2].shape) == w_d.shape
    for a, b in zip(g, j):
        assert rel_err(nn(a), b) < 1e-5
    # D = 1: no defocus axis given, as in local rounds
    j1 = jlh.local_search_weights(
        *map(jnp.asarray, (dat, ctf_d[:, 0], sig_rcp, proj, tra, w_r, w_t)),
        pixel_mask=jnp.asarray(pm))
    g1 = tlh.local_search_weights(
        *map(tt, (dat, ctf_d[:, 0], sig_rcp, proj, tra, w_r, w_t)),
        pixel_mask=tt(pm))
    assert tuple(g1[2].shape) == (dat.shape[0], 1)
    for a, b in zip(g1, j1):
        assert rel_err(nn(a), b) < 1e-5


def test_defocus_particle_functions():
    """perturb_d, cal_vari_d, peak_idx_d and the defocus branch of
    update_from_likelihood on the JAX draws."""
    rng = np.random.default_rng(3)
    b, n_r, n_t = 6, 20, 9
    keys = _keys(b, 4)
    d = (1 + rng.normal(0, 0.01, (b, N_D))).astype(np.float32)
    s = rng.uniform(0.005, 0.02, b).astype(np.float32)
    normals = jax.vmap(lambda k: jax.random.normal(k, (N_D,), jnp.float32))(
        keys)
    np.testing.assert_allclose(
        nn(tpar.perturb_d(tt(d), tt(s), 0.5, tt(normals))),
        np.asarray(jpar.perturb_d(keys, jnp.asarray(d), jnp.asarray(s), 0.5)),
        atol=1e-6)
    np.testing.assert_allclose(nn(tpar.cal_vari_d(tt(d))),
                               np.asarray(jpar.cal_vari_d(jnp.asarray(d))),
                               atol=1e-6)
    for n_d in (1, 2, 4, 9, 30):
        assert tpar.peak_idx_d(n_d) == jpar.peak_idx_d(n_d)

    st = jpar.make_state(b, n_r, n_t, N_D)
    q = rng.normal(size=(b, n_r, 4))
    st = {**st, "r": jnp.asarray((q / np.linalg.norm(q, axis=-1,
                                                     keepdims=True))
                                 .astype(np.float32)),
          "t": jnp.asarray(rng.normal(size=(b, n_t, 2)).astype(np.float32)),
          "d": jnp.asarray(d), "sD": jnp.asarray(s),
          "pfR": jnp.full((b,), 0.1), "pfT": jnp.full((b,), 0.2),
          "pfD": jnp.full((b,), 0.3)}
    u = [rng.uniform(0, 1, (b, n)).astype(np.float32) ** 3
         for n in (n_r, n_t, N_D)]
    ks = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    ref = jpar.update_from_likelihood(st, ks, *map(jnp.asarray, u),
                                      with_d=True)
    uni = lambda k: jax.vmap(lambda x: jax.random.uniform(x, (), jnp.float32)
                             )(k)
    got = tpar.update_from_likelihood(
        {k: tt(v) for k, v in st.items()}, tt(u[0]), tt(u[1]),
        tt(uni(ks[:, 0])), tt(uni(ks[:, 1])), None, u_d=tt(u[2]),
        u0_d=tt(uni(ks[:, 2])))
    for k in ("d", "topD", "sD", "wD"):
        np.testing.assert_allclose(nn(got[k]), np.asarray(ref[k]), atol=1e-6,
                                   err_msg=k)
    for k in ("r", "t", "topR", "topT"):
        np.testing.assert_allclose(nn(got[k]), np.asarray(ref[k]), atol=2e-5,
                                   err_msg=k)


def _ladder_walk(mod):
    """Drive a LadderState through LOCAL -> CTF -> STOP: local rounds whose
    resolution does not pass the best shell switch to CTF search after
    MAX_ITER_RES_NO_IMPROVE rounds, and CTF rounds likewise to STOP."""
    lad = mod.LadderState(r=12, r_global=10, r_init=6, max_r=14,
                          search_type=mod.SEARCH_TYPE_LOCAL)
    seen = []
    for shell in (9, 9, 9, 9, 9):
        lad.record_t_vari(1.0, 1.0)
        lad.elevate(shell)
        seen.append((lad.transition(True, True), lad.r,
                     lad.n_top_res_no_improve, lad.n_no_decrease))
    return seen


def test_ladder_local_ctf_stop():
    seen = _ladder_walk(tom)
    assert seen == _ladder_walk(jom)
    types = [x[0] for x in seen]
    assert tom.SEARCH_TYPE_CTF in types and types[-1] == tom.SEARCH_TYPE_STOP
    # entering CTF search resets the counters
    i = types.index(tom.SEARCH_TYPE_CTF)
    assert seen[i][2:] == (0, 0)


def _para_ctf():
    return dataclasses.replace(
        _para(), c_search=True, m_l_d=N_D, ctf_refine_s=0.01,
        table_bf16=False, save_ref_each_iter=False, save_thu_each_iter=False)


def _from_state(para, data, state, key):
    opt = convert.load_state(_port(para, data), state)
    opt.draws = JaxDraws(para.seed, state["plane_index"])
    opt.draws.key = key
    return opt


def _engine_phases(jo):
    """The JAX engine's first block of CTF-search phases from ``jo``'s
    state (the block the optimiser's CTF round dispatches first, so the
    round reuses its compiled program), and the inputs the port's engine
    needs for the same call."""
    para = jo.para
    ring = jo._ring()
    col, row, pmask = (jnp.asarray(ring.col), jnp.asarray(ring.row),
                       jnp.asarray(ring.mask))
    dat, c, sig = jo._plane_ring_data(ring)
    n_phases = jom.particle.MIN_N_PHASE_PER_ITER_LOCAL + 1
    st = {k: jnp.asarray(v) for k, v in jo.par.items()}
    sh = st["k1"].shape
    jst = {**st, "_done": jnp.zeros(sh, bool),
           "_noDec": jnp.zeros(sh, jnp.int32),
           "_nph": jnp.zeros(sh, jnp.int32)}
    keys = jeng.plane_keys(jax.random.PRNGKey(21), jo.plane_index)
    cp = jeng.pack_ctf(jo.ctf_params)
    f = lambda x: jnp.asarray(x, jnp.float32)
    ref = jeng.local_search(
        jo.mesh, jo._bricks(), col, row, pmask, dat, c, sig, jst, keys, cp,
        jnp.zeros((0, 4), jnp.float32), f(para.perturb_factor_l),
        f(para.perturb_factor_s_local), f(para.perturb_factor_s_ctf),
        jnp.asarray(0, jnp.int32), mode="3d", pf=para.pf, n=jo.n,
        pixel_size=para.pixel_size, ctf_search=True, min_phase=3,
        chunk=jo._chunk(), n_phases=n_phases)
    return dict(ref={k: np.asarray(v) for k, v in ref.items()},
                inputs=dict(col=col, row=row, pmask=pmask, dat=dat, c=c,
                            sig=sig, cp=cp, keys=keys),
                n_phases=n_phases)


def _pin_ctf(opt, mod):
    """A CTF round at band R_LOCAL, entered as the ladder enters it: the
    counters reset (LadderState.transition) and the defocus support seeded
    (run_iteration)."""
    opt.ladder.search_type = mod.SEARCH_TYPE_CTF
    opt.ladder.r = R_LOCAL
    opt.ladder._reset_counters()
    opt._seed_defocus_search()


@pytest.fixture(scope="module")
def chain():
    """JAX: a global round, then a CTF round pinned at r = R_LOCAL; the
    state copied after the global round, after the CTF search was entered,
    and after the CTF round, and the engine's first CTF-search phases from
    the entered state."""
    data = _make_dataset(n=N, n_imgs=32)
    para = _para_ctf()
    jo = jom.Optimiser(JPara(**dataclasses.asdict(para)),
                       mesh=make_mesh(n_devices=1))
    vol, imgs, _, _, cp = data
    jo.set_data(imgs, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    jo.run_iteration()
    after_global = (jax_state(jo), jo.key)
    _pin_ctf(jo, jom)
    before_ctf = (jax_state(jo), jo.key)
    eng = _engine_phases(jo)
    rec_ctf = jo.run_iteration()
    return dict(data=data, para=para, after_global=after_global,
                before_ctf=before_ctf, eng=eng, rec_ctf=rec_ctf,
                after_ctf=jax_state(jo))


def test_seed_defocus_search(chain):
    """Entering CTF search by hand seeds the same defocus support in both
    packages (NumPy draws from seed + 77 around topD)."""
    c = chain
    opt = _from_state(c["para"], c["data"], *c["after_global"])
    _pin_ctf(opt, tom)
    ref = c["before_ctf"][0]
    assert tuple(opt.par["d"].shape) == (2, opt.s_slots, N_D)
    for k in ("d", "sD"):
        np.testing.assert_array_equal(nn(opt.par[k]), ref["par"][k],
                                      err_msg=k)
    assert dataclasses.asdict(opt.ladder) == ref["ladder"]


def test_local_round_switches_to_ctf_search(chain):
    """A local round whose resolution does not pass the best shell for the
    second round running ends in CTF search, and run_iteration seeds the
    defocus support as the JAX optimiser does."""
    c = chain
    opt = _from_state(c["para"], c["data"], *c["after_global"])
    opt.ladder.search_type = tom.SEARCH_TYPE_LOCAL
    opt.ladder.r = R_LOCAL
    opt.ladder.res_top = 10 ** 6
    opt.ladder.n_top_res_no_improve = 1
    rec = opt.run_iteration()
    assert rec["search_type"] == tom.SEARCH_TYPE_CTF
    d0 = nn(opt.par["topD"])[..., None]
    expect = (d0 + np.random.default_rng(c["para"].seed + 77).normal(
        0, c["para"].ctf_refine_s, d0.shape[:2] + (N_D,))).astype(np.float32)
    np.testing.assert_array_equal(nn(opt.par["d"]), expect)
    np.testing.assert_array_equal(nn(opt.par["sD"]),
                                  np.float32(c["para"].ctf_refine_s))


def test_engine_local_search_ctf(chain):
    """The first four phases of the filter with the CTF search on, from the
    seeded state with the same per-phase draws (f32 brick tables)."""
    c = chain
    e = c["eng"]
    inp = e["inputs"]
    opt = _from_state(c["para"], c["data"], *c["before_ctf"])
    para = c["para"]
    sh = opt.par["k1"].shape
    flat_k = inp["keys"].reshape(-1, 2)

    def draws(phase):
        kph = jax.vmap(jax.random.fold_in)(
            flat_k, jnp.full((flat_k.shape[0],), phase, jnp.uint32))
        got = per_image_draws(kph, para.m_l_r, para.m_l_t, N_D)
        return {k: tt(v).reshape(sh + np.shape(v)[1:])
                for k, v in got.items()}

    got, nph = teng.local_search(
        opt._bricks(), *(tt(inp[k]) for k in ("col", "row", "pmask", "dat",
                                               "c", "sig")),
        opt.par, draws, torch.zeros(0, 4), para.perturb_factor_l,
        para.perturb_factor_s_local, pf=para.pf, n=N, min_phase=3,
        max_phase=e["n_phases"], cp=tt(inp["cp"]),
        factor_d=para.perturb_factor_s_ctf, pixel_size=para.pixel_size)
    ref = e["ref"]
    valid = opt.plane_valid > 0
    assert int(nph.max()) == e["n_phases"]
    top_d = np.abs(nn(got["topD"]) - ref["topD"])[valid]
    assert np.mean(top_d <= 1e-4) >= 0.9, top_d
    agree = np.abs(np.sum(nn(got["topR"]) * ref["topR"], -1))[valid]
    assert np.mean(agree > 0.999) >= 0.9, agree
    for k in ("sD", "pfD"):
        a, b = nn(got[k])[valid], ref[k][valid]
        assert np.mean(np.abs(a - b) <= 1e-2 * np.abs(b) + 1e-6) >= 0.9, k


def test_ctf_round_from_jax_state(chain):
    """One CTF round of run_iteration from the JAX state before it, with the
    JAX draws: K1 is not used, the defocus support moves, and the port's
    refined defocus factors and top poses follow the JAX round's."""
    c = chain
    opt = _from_state(c["para"], c["data"], *c["before_ctf"])
    assert opt.ladder.search_type == tom.SEARCH_TYPE_CTF
    rec = opt.run_iteration()
    ref = c["after_ctf"]["par"]
    valid = opt.plane_valid > 0
    assert rec["search_type"] == c["rec_ctf"]["search_type"]
    assert abs(rec["res_shell"] - c["rec_ctf"]["res_shell"]) <= 1
    top_d = np.abs(nn(opt.par["topD"]) - ref["topD"])[valid]
    assert np.mean(top_d <= 1e-4) >= 0.75, np.sort(top_d)
    assert np.mean(top_d <= 1e-3) >= 0.9, np.sort(top_d)
    ang = _angles(nn(opt.par["topR"])[valid], ref["topR"][valid])
    assert np.mean(ang < 1.0) >= 0.75, np.sort(ang)
    s_d = nn(opt.par["sD"])[valid]
    assert np.isfinite(s_d).all() and (s_d >= 0).all()
    assert tuple(opt.par["d"].shape) == (2, opt.s_slots, N_D)
    assert np.abs(opt.best_defocus - 1.0).max() > 0  # the factors moved


