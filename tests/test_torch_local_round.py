"""Port parity for the local-search round (the round bench.py times): a
global round, then two local rounds pinned as bench.py pins them
(search type LOCAL, r = 12 here), in both packages on the slice test's
drive (n = 32, 32 particles, C1), the port replaying the JAX draws.

- Deterministic steps, from the JAX optimiser's state before the second
  local round (copied with ``thunder_tpu_torch.convert``) and fed the same
  residual statistics: norm correction, re-centring and re-masking, the
  group scale correction, sigma after norm correction, and reference
  auto-recentring; the init-time scale re-balance from the set-up state
  with the JAX key replayed. ``engine.sigma_rescaled`` is held to a NumPy
  float64 oracle, and the JAX float32 result only to its cancellation
  error.
- Each round of the path from the JAX state before it: most top poses
  agree within 1 deg and the resolution shell within 1. A chain run from
  the start does not hold the pose bar: a systematic-resample tie that f32
  round-off breaks differently sends an image down another trajectory
  with the same draws, and such images add up round by round. The chain
  is held to the ground truth instead, as closely as the JAX chain.
- ``Optimiser.run`` gives the JAX package's sequence of search types;
  ``debug_nan`` raises ``FloatingPointError`` in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.config import Para as JPara
from thunder_tpu.core import optimiser as jom
from thunder_tpu.parallel import engine as jengine
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.parallel import engine as tengine

from test_optimiser_e2e import _make_dataset
from test_torch_slice import _angles, _para, _port
from test_torch_support import JaxDraws, jax_state, nn, rel_err, tt

torch.set_num_threads(1)

N = 32
R_LOCAL = 12  # bench.py pins r = 40 of 80 shells at 160 px
# the JAX optimiser's attributes a deterministic step may rebind
_JAX_ATTRS = ("imgs_ft", "imgs_ft_ori", "sig", "scale", "offsets", "refs",
              "par", "key")


def _para_run():
    return dataclasses.replace(_para(), save_ref_each_iter=False,
                               save_thu_each_iter=False)


def _pin(opt, mod):
    """bench.py's pin_local."""
    opt.ladder.search_type = mod.SEARCH_TYPE_LOCAL
    opt.ladder.r = R_LOCAL
    opt.ladder.n_no_decrease = 0


def _jax_opt(para, data):
    vol, imgs, _, _, cp = data
    jo = jom.Optimiser(JPara(**dataclasses.asdict(para)),
                       mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    return jo


def _from_state(para, data, state, key):
    """A port optimiser at a JAX state, replaying the JAX keys from
    ``key``."""
    opt = convert.load_state(_port(para, data), state)
    opt.draws = JaxDraws(para.seed, state["plane_index"])
    opt.draws.key = key
    return opt


def _run_step(jo, fn, stats=None):
    """Run ``fn(jo)`` on the live JAX optimiser, then undo its changes;
    with ``stats`` its residual-statistics pass returns them."""
    saved = {k: getattr(jo, k) for k in _JAX_ATTRS}
    saved["par"] = dict(jo.par)
    if stats is not None:
        jo._residual_stats = lambda: stats
    try:
        return fn(jo)
    finally:
        jo.__dict__.pop("_residual_stats", None)
        for k, v in saved.items():
            setattr(jo, k, v)


def _jax_steps(jo, stats):
    """Each deterministic step's outputs on the JAX side, as NumPy."""
    a = lambda x: np.array(x)

    def norm(o):
        fac = o.norm_correction(stats=stats)
        return {"fac": a(fac), "imgs_ft": a(o.imgs_ft),
                "imgs_ft_ori": a(o.imgs_ft_ori)}

    def sigma(o):
        fac = o.norm_correction(stats=stats)
        sums = jengine.sigma_rescaled(
            o.mesh, stats[6], fac, jnp.asarray(o.groups_plane),
            jnp.asarray(o.plane_valid), n_groups=o.n_groups)
        o.maximization_sigma(stats=stats, sig_override=sums)
        return {"fac": a(fac), "sums": [a(x) for x in sums], "sig": a(o.sig)}

    def scale(o):
        o.correct_scale(init=False, group=True)
        return {"scale": a(o.scale), "sig": a(o.sig),
                "imgs_ft": a(o.imgs_ft), "imgs_ft_ori": a(o.imgs_ft_ori)}

    def recentre(o):
        o.re_centre_img()
        o.re_mask_img()
        return {"offsets": a(o.offsets), "t": a(o.par["t"]),
                "topT": a(o.par["topT"]), "imgs_ft": a(o.imgs_ft)}

    def auto(o):
        o._auto_recentre_refs()
        return {"refs": a(o.refs)}

    return {name: _run_step(jo, fn, stats if name == "scale" else None)
            for name, fn in (("norm", norm), ("sigma", sigma),
                             ("scale", scale), ("recentre", recentre),
                             ("auto", auto))}


@pytest.fixture(scope="module")
def path():
    data = _make_dataset(n=N, n_imgs=32)
    para = _para_run()
    jo = _jax_opt(para, data)
    states, keys = [jax_state(jo)], [jo.key]

    def init_scale(o):
        o.correct_scale(init=True, group=False)
        return {"refs": np.array(o.refs), "scale": np.array(o.scale),
                "key": np.array(o.key)}

    init = _run_step(jo, init_scale)
    recs = [jo.run(max_iter=1, finalise=False)[-1]]
    quats = [np.asarray(jo.best_quat)]
    steps = None
    for i in range(2):
        _pin(jo, jom)
        states.append(jax_state(jo))
        keys.append(jo.key)
        if i == 1:
            stats = jo._residual_stats()
            steps = _jax_steps(jo, stats)
        recs.append(jo.run_iteration())
        quats.append(np.asarray(jo.best_quat))
    chain = _port(para, data, JaxDraws(para.seed, jo.plane_index))
    chain_recs = [chain.run(max_iter=1, finalise=False)[-1]]
    chain_quats = [chain.best_quat]
    for _ in range(2):
        _pin(chain, tom)
        chain_recs.append(chain.run_iteration())
        chain_quats.append(chain.best_quat)
    return dict(data=data, para=para, jo=jo, states=states, keys=keys,
                init=init, recs=recs, quats=quats, stats=stats, steps=steps,
                chain=chain, chain_recs=chain_recs, chain_quats=chain_quats)


def _port_stats(stats):
    """The JAX residual statistics in the port's types."""
    sig, cnt, xa, aa, norms, shell_n, oris = stats
    return (sig, cnt, xa, aa, tt(norms), shell_n, tt(oris))


STEPS = ("norm", "sigma", "scale", "recentre", "auto", "init_scale")


@pytest.mark.parametrize("step", STEPS)
def test_step_from_copied_state(path, step):
    """Each deterministic step of the round, from the same state and the
    same residual statistics as the JAX package: factors, stacks, sigma
    and scales within 1e-5 relative, offsets exact."""
    p = path
    if step == "init_scale":
        opt = _from_state(p["para"], p["data"], p["states"][0], p["keys"][0])
        opt._init_model_given = True
        opt.correct_scale(init=True, group=False)
        want = p["init"]
        np.testing.assert_array_equal(np.asarray(opt.draws.key), want["key"])
        assert rel_err(opt.scale, want["scale"]) < 1e-5
        assert rel_err(nn(opt.refs), want["refs"]) < 1e-5
        return
    opt = _from_state(p["para"], p["data"], p["states"][2], p["keys"][2])
    stats = _port_stats(p["stats"])
    want = p["steps"][step]
    if step == "norm":
        fac = opt.norm_correction(stats=stats)
        assert rel_err(nn(fac), want["fac"]) < 1e-5
        assert rel_err(nn(opt.imgs_ft), want["imgs_ft"]) < 1e-5
        assert rel_err(nn(opt.imgs_ft_ori), want["imgs_ft_ori"]) < 1e-5
    elif step == "sigma":
        fac = opt.norm_correction(stats=stats)
        sums = tengine.sigma_rescaled(
            stats[6], fac, opt._t(opt.groups_plane), opt._t(opt.plane_valid),
            n_groups=opt.n_groups)
        opt.maximization_sigma(stats=stats, sig_override=sums)
        # f64 here, f32 in the JAX package: both near the oracle
        assert rel_err(nn(sums[0]), want["sums"][0]) < 1e-5
        np.testing.assert_array_equal(nn(sums[1]), want["sums"][1])
        assert rel_err(nn(opt.sig), want["sig"]) < 1e-5
    elif step == "scale":
        opt._residual_stats = lambda: stats
        opt.correct_scale(init=False, group=True)
        assert rel_err(opt.scale, want["scale"]) < 1e-5
        assert rel_err(nn(opt.sig), want["sig"]) < 1e-5
        assert rel_err(nn(opt.imgs_ft), want["imgs_ft"]) < 1e-5
        assert rel_err(nn(opt.imgs_ft_ori), want["imgs_ft_ori"]) < 1e-5
    elif step == "recentre":
        opt.re_centre_img()
        opt.re_mask_img()
        for k in ("offsets", "topT"):
            got = nn(opt.offsets if k == "offsets" else opt.par[k])
            np.testing.assert_array_equal(got, want[k], err_msg=k)
        np.testing.assert_array_equal(nn(opt.par["t"]), want["t"])
        assert rel_err(nn(opt.imgs_ft), want["imgs_ft"]) < 1e-5
    else:
        opt._auto_recentre_refs()
        assert rel_err(nn(opt.refs), want["refs"]) < 1e-5


def _sigma_oracle(ori, fac, groups, valid, n_groups):
    """sigma_rescaled in NumPy float64."""
    o = np.asarray(ori, np.float64)
    f = np.asarray(fac, np.float64)[..., None]
    v = np.asarray(valid, np.float64)
    img = (f * f * o[..., 0] - 2 * f * o[..., 1] + o[..., 2]) * v[..., None]
    sig = np.zeros((n_groups, o.shape[-2]))
    cnt = np.zeros(n_groups)
    np.add.at(sig, np.asarray(groups).reshape(-1),
              img.reshape(-1, o.shape[-2]))
    np.add.at(cnt, np.asarray(groups).reshape(-1), v.reshape(-1))
    return sig, cnt, np.abs(f * f * o[..., 0]) + np.abs(2 * f * o[..., 1]) \
        + np.abs(o[..., 2])


def _high_snr_ori(seed=3, s=24, n_shell=16):
    """Per-image shells of data that the projection fits to 1e-3: the
    residual power is ~1e-6 of each term."""
    rng = np.random.default_rng(seed)
    n_px = 40
    d = rng.normal(size=(2, s, n_shell, n_px)) + 1j * rng.normal(
        size=(2, s, n_shell, n_px))
    cp = d * (1 + 1e-3 * rng.normal(size=d.shape))
    ori = np.stack([np.sum(np.abs(d) ** 2, -1),
                    np.sum((np.conj(d) * cp).real, -1),
                    np.sum(np.abs(cp) ** 2, -1)], -1).astype(np.float32)
    fac = (1 + 1e-4 * rng.normal(size=(2, s))).astype(np.float32)
    groups = rng.integers(0, 3, (2, s)).astype(np.int32)
    valid = np.ones((2, s), np.float32)
    valid[1, -3:] = 0
    return ori, fac, groups, valid, 3


@pytest.mark.parametrize("case", ["round", "high_snr"])
def test_sigma_rescaled_f64(path, case):
    """The port's sigma_rescaled against the NumPy float64 oracle at
    1e-10; the JAX float32 result within its cancellation error, a few
    f32 roundings of the terms' magnitude."""
    if case == "round":
        jo = path["jo"]
        ori = np.asarray(path["stats"][6])
        fac = path["steps"]["sigma"]["fac"]
        groups, valid, ng = jo.groups_plane, jo.plane_valid, jo.n_groups
    else:
        ori, fac, groups, valid, ng = _high_snr_ori()
    sig, cnt, mag = _sigma_oracle(ori, fac, groups, valid, ng)
    got_s, got_c = tengine.sigma_rescaled(tt(ori), tt(fac), tt(groups),
                                          tt(valid), n_groups=ng)
    assert got_s.dtype == torch.float64
    assert rel_err(nn(got_s), sig) < 1e-10
    np.testing.assert_array_equal(nn(got_c), cnt)
    js, jc = jengine.sigma_rescaled(
        make_mesh(n_devices=1), jnp.asarray(ori), jnp.asarray(fac),
        jnp.asarray(groups), jnp.asarray(valid), n_groups=ng)
    mag_g = np.zeros_like(sig)
    np.add.at(mag_g, np.asarray(groups).reshape(-1),
              (mag * np.asarray(valid)[..., None]).reshape(-1, sig.shape[1]))
    bound = 8 * np.finfo(np.float32).eps * mag_g
    assert np.all(np.abs(np.asarray(js, np.float64) - sig) <= bound)
    if case == "high_snr":
        # the cancellation the f64 form avoids: f32 errs far above 1e-10
        assert rel_err(np.asarray(js), sig) > 1e-6


@pytest.mark.parametrize("rnd", [1, 2])
def test_local_round_from_copied_state(path, rnd):
    """Each pinned local round from the JAX state before it, with the JAX
    keys: top poses within 1 deg for at least 75 % of the images, the
    resolution shell within 1, the same ladder."""
    p = path
    opt = _from_state(p["para"], p["data"], p["states"][rnd], p["keys"][rnd])
    rec = opt.run_iteration()
    jrec = p["recs"][rnd]
    assert rec["search_type"] == jrec["search_type"] and rec["r"] == jrec["r"]
    assert abs(rec["res_shell"] - jrec["res_shell"]) <= 1
    ang = _angles(opt.best_quat, p["quats"][rnd])
    assert np.mean(ang < 1.0) >= 0.75, np.sort(ang)
    assert rec["n_phase"][1] >= tom.particle.MIN_N_PHASE_PER_ITER_LOCAL
    assert np.isfinite(nn(opt.norm_fac)).all()
    assert np.isfinite(nn(opt.offsets)).all()


def test_chain_against_ground_truth(path):
    """The port's own chain (global, local, local from the set-up): the
    same ladder, resolution shells within 1 and median pose errors
    against the ground truth within 3 deg of the JAX chain's."""
    p = path
    truth = p["data"][2]
    for rnd, (rec, jrec) in enumerate(zip(p["chain_recs"], p["recs"])):
        assert rec["search_type"] == jrec["search_type"], rnd
        assert rec["r"] == jrec["r"], rnd
        assert abs(rec["res_shell"] - jrec["res_shell"]) <= 1, rnd
        err_t = np.median(_angles(p["chain_quats"][rnd], truth))
        err_j = np.median(_angles(p["quats"][rnd], truth))
        assert abs(err_t - err_j) < 3.0, (rnd, err_t, err_j)
    assert np.isfinite(nn(p["chain"].refs)).all()


def test_run_search_types(path):
    """Optimiser.run(max_iter=3, finalise=False) from the set-up: the JAX
    package's sequence of search types and bands. The port's run has the
    subtraction pipeline switched on: it belongs to the final round only,
    so the rounds are those of the JAX package's plain run."""
    p = path
    jo = _jax_opt(p["para"], p["data"])
    jhist = jo.run(max_iter=3, finalise=False)
    opt = _port(dataclasses.replace(p["para"], subtract=True), p["data"],
                JaxDraws(p["para"].seed, jo.plane_index))
    hist = opt.run(max_iter=3, finalise=False)
    assert ([(h["search_type"], h["r"]) for h in hist]
            == [(h["search_type"], h["r"]) for h in jhist])
    assert opt.iteration == len(hist) and opt.para.subtract


@pytest.mark.parametrize("stage", ["expectation", "reconstruction"])
def test_debug_nan_raises(path, stage):
    """A NaN injected into one image's translation support (before the
    expectation) or original stack (before the reconstruction) raises
    FloatingPointError after that stage in both packages. (A NaN pixel of
    the working stack does not reach the filter state in either: the
    posterior's log-sum-exp drops it.)"""
    p = path
    para = dataclasses.replace(p["para"], debug_nan=True,
                               skip_m=True, skip_r=stage == "expectation",
                               skip_e=stage == "reconstruction")
    st = dict(p["states"][2])
    if stage == "expectation":
        st["par"] = dict(st["par"])
        st["par"]["t"] = st["par"]["t"].copy()
        st["par"]["t"][0, 0] = np.nan
    else:
        st["imgs_ft_ori"] = st["imgs_ft_ori"].copy()
        st["imgs_ft_ori"][0, 0, N // 2, N // 2 + 1] = np.nan
    opt = _from_state(para, p["data"], st, p["keys"][2])
    with pytest.raises(FloatingPointError, match=f"after {stage}"):
        opt.run_iteration()
    jo = _jax_opt(para, p["data"])
    jo.par = {k: jnp.asarray(v) for k, v in st["par"].items()}
    for k in ("refs", "sig", "offsets", "scores", "imgs_ft", "imgs_ft_ori"):
        setattr(jo, k, jnp.asarray(st[k]))
    jo.fsc, jo.iteration = st["fsc"], st["iteration"]
    jo.ladder = jom.LadderState(**st["ladder"])
    with pytest.raises(FloatingPointError, match=f"after {stage}"):
        jo.run_iteration()
