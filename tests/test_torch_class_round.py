"""Port parity for 3D classification (K = 2 classes, n = 32): the
class-fused insert, the class bookkeeping and the global and local
rounds, in both packages on two distinct phantoms (test_optimiser_e2e's
and a 3-blob one, projected by ``chip_smoke.project_stack``), each class's
reference seeded from its phantom as the smoke seeds them, the port
replaying the JAX draws.

- The fused K-class insert against the JAX engine's (``k_classes=2``,
  sorted-interpret and scatter), and against the port's own staged insert
  (one class at a time), at the engine and at the optimiser with
  ``FUSED_CLASS_BYTES`` forced to 0.
- ``refresh_class_distr``, ``best_class`` and ``balance_class`` (an
  emptied class resigned with replayed random phases) against JAX.
- ``reconstruct`` from a copied JAX state: per-class references, the
  (K, shells) FSC read per class and each class's warm C-balance weights,
  (2, K, 3) insert offsets.
- The global round and a pinned local round, each from the JAX state
  before it: top poses within 1 deg for at least 75 % of the images, the
  resolution shell within 1, the same class distribution within one image
  a class; the round's resolution is the best class's.

(``chip_smoke.class3d_dataset``'s C4 phantoms do not classify at 32 px in
either package: both leave one class with 0-1 images a half, whose maps
are ill-conditioned, so these tests use phantoms that do.)

Run as a script for the smoke's own classification check (path A's data
and configuration) at a smaller box, both packages, purity, resolution
and pose error per round (the study quoted beside
``chip_smoke.CLASS_PURITY_MIN`` in PERF.md):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_class_round.py 64 32 0.3 2
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from thunder_tpu.config import Para as JPara
from thunder_tpu.core import optimiser as jom
from thunder_tpu.ops import brick as jbrick
from thunder_tpu.ops import pixels as jpixels
from thunder_tpu.parallel import engine as jengine
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.ops import spectrum
from thunder_tpu_torch.parallel import engine as tengine

from test_optimiser_e2e import _phantom
from test_torch_c4_round import _pose_err
from test_torch_support import (JaxDraws, insert_draws, jax_state, nn,
                                rel_err, tt)

torch.set_num_threads(1)

N, K, PER_CLASS = 32, 2, 16
CPU = torch.device("cpu")
# the local round's pinned band. At 32 px a band of 12 or more (table band
# 16, capped at 15) crops the brick tables to the even padded box, where
# the JAX package offsets classes past class 0 by mc // 2 + 1 z-rows a
# table (brick.half_rows) but the table holds mc // 2: its K > 1 gathers
# read class 1 one z-plane off. The port takes the rows from the table's
# shape. The parity test pins a band below that.
R_LOCAL = 8


def _para():
    """test_torch_slice's drive with two classes and 8-image chunks
    (several per half)."""
    return Para(mode="3d", k=K, size=N, pixel_size=1.32,
                mask_radius=N * 1.32 / 2.2, trans_s=2.0, init_res=6.5,
                global_search_res=3.4, sym="C1", m_s=800, m_l_r=64,
                m_l_t=9, m_reco=8, l_search=True, pf=2, seed=5,
                image_batch=8, save_ref_each_iter=False,
                save_thu_each_iter=False)


def _phantom2(n):
    g = np.mgrid[:n, :n, :n] - n // 2
    blob = lambda c, s: np.exp(-((g[0] - c[0]) ** 2 + (g[1] - c[1]) ** 2
                                 + (g[2] - c[2]) ** 2) / (2 * s ** 2))
    return (blob((-3, -3, 3), 2.8) + 0.9 * blob((4, 2, 0), 2.0)
            + 0.7 * blob((0, -5, -4), 1.8)).astype(np.float32)


def _class_data(seed=0):
    """(phantoms, stack, true quats, true classes, CTF params): PER_CLASS
    images of each phantom, noise 0.1, shifts N(0, 1.5) px."""
    rng = np.random.default_rng(seed)
    vols = np.stack([_phantom(N), _phantom2(N)])
    parts = [chip_smoke.project_stack(CPU, v, PER_CLASS, rng, 0.1,
                                      trans_sd=1.5) for v in vols]
    cp = {k: np.concatenate([x[2][k] for x in parts]) for k in parts[0][2]}
    return (vols, np.concatenate([x[0] for x in parts]),
            np.concatenate([x[1] for x in parts]),
            np.repeat(np.arange(K), PER_CLASS).astype(np.int32), cp)


def _seeded_refs(para, vols):
    """The smoke's seeded class references (each phantom low-passed to the
    initial band), as NumPy (2, K, n, n, n)."""
    op = tom.Optimiser(para, device=CPU)
    chip_smoke.seed_class_refs(op, vols)
    return nn(op.refs)


def _pin(opt, mod, r):
    opt.ladder.search_type = mod.SEARCH_TYPE_LOCAL
    opt.ladder.r = r
    opt.ladder.n_no_decrease = 0


def _both(para, data):
    """A JAX optimiser and a port one replaying its draws, set up alike:
    seeded references, then the init-time scale re-balance."""
    vols, stack, _, _, cp = data
    refs = _seeded_refs(para, vols)
    jo = jom.Optimiser(JPara(**dataclasses.asdict(para)),
                       mesh=make_mesh(n_devices=1))
    jo.set_data(stack, cp)
    jo.init_reference()
    jo.init_sigma()
    jo.refs = jnp.asarray(refs)
    jo.correct_scale(init=True, group=False)
    op = tom.Optimiser(para, device=CPU,
                       draws=JaxDraws(para.seed, jo.plane_index))
    op.set_data(stack, cp)
    op.init_reference()
    op.init_sigma()
    op.refs = tt(refs)
    op.correct_scale(init=True, group=False)
    return jo, op


def _from_state(para, data, state, key):
    vols, stack, _, _, cp = data
    op = tom.Optimiser(para, device=CPU)
    op.set_data(stack, cp)
    op = convert.load_state(op, state)
    op.draws = JaxDraws(para.seed, state["plane_index"])
    op.draws.key = key
    return op


@pytest.fixture(scope="module")
def path():
    data = _class_data()
    para = _para()
    jo, _ = _both(para, data)
    states, keys, recs, quats = [jax_state(jo)], [jo.key], [], []
    for i in range(2):
        if i:
            _pin(jo, jom, R_LOCAL)
        recs.append(jo.run_iteration())
        quats.append(np.asarray(jo.best_quat))
        states.append(jax_state(jo))
        keys.append(jo.key)
    end, key_end = jax_state(jo), jo.key
    # cold C-balance, as test_torch_slice compares it: warm weights carry
    # each package's f32 round-off of the last round into the tail voxels
    jo._w_warm = {}
    jo.reconstruct()
    reco = {"fsc": np.asarray(jo.fsc), "refs": np.asarray(jo.refs),
            "insert_offsets": np.asarray(jo.insert_offsets)}
    return dict(data=data, para=para, jo=jo, states=states, keys=keys,
                recs=recs, quats=quats, end=end, key_end=key_end, reco=reco)


def _insert_inputs(p, seed=3):
    """Engine inputs of a K = 2 insert from the state after the global
    round (both classes populated): ring r_u = 7, 5 draws."""
    jo = p["jo"]
    st = {k: np.asarray(p["states"][1]["par"][k]) for k in ("r", "t", "c")}
    assert set(np.unique(st["c"])) == {0, 1}
    rng = np.random.default_rng(seed)
    ring = jpixels.pixel_ring(N, 0, 7)
    dat, c, _ = jo._plane_ring_data(ring, ori=True)
    w = (rng.uniform(0.5, 1.5, jo.plane_valid.shape).astype(np.float32)
         * jo.plane_valid / 5)
    off = rng.normal(0, 0.5, jo.plane_valid.shape + (2,)).astype(np.float32)
    keys = jengine.plane_keys(jnp.asarray(np.array([0, 41], np.uint32)),
                              jo.plane_index)
    ri, ti = insert_draws(keys.reshape(-1, 2), 5, st["r"].shape[2],
                          st["t"].shape[2])
    sh = keys.shape[:2]
    return dict(ring=ring, st=st, dat=dat, c=c, w=w, off=off, keys=keys,
                ri=tt(ri).reshape(sh + (5,)), ti=tt(ti).reshape(sh + (5,)),
                mc=jbrick.crop_size(8, 2))


def _port_insert(a, k_classes, st=None, w=None):
    st = a["st"] if st is None else st
    return tengine.insert_fold_reduce(
        tt(a["ring"].col), tt(a["ring"].row), tt(a["ring"].mask),
        tt(a["dat"]), tt(a["c"]), {k: tt(v) for k, v in st.items()},
        a["ri"], a["ti"], tt(a["w"] if w is None else w), tt(a["off"]),
        pf=2, n=N, mc=a["mc"], chunk=3, k_classes=k_classes)


@pytest.mark.parametrize("impl", ["sorted_interpret", "scatter"])
def test_fused_insert_matches_jax(path, impl):
    """The class-fused K = 2 insert (rows offset by cls * n_vox, one
    K n_vox + 1 table, K2's plain version) against the JAX engine's
    ``k_classes=2`` insert with the same draws: F and T (2, K, mc, mc, mc)
    and the per-class offsets at test_torch_engine's tolerances."""
    a = _insert_inputs(path)
    ring = a["ring"]
    f_r, t_r, o_r = jengine.insert_fold_reduce(
        make_mesh(n_devices=1), jnp.asarray(ring.col), jnp.asarray(ring.row),
        jnp.asarray(ring.mask), a["dat"], a["c"],
        {k: jnp.asarray(v) for k, v in a["st"].items()}, a["keys"],
        jnp.asarray(a["w"]), jnp.asarray(a["off"]), jnp.zeros((0, 3, 3)),
        mode="3d", pf=2, n=N, k_classes=K, mc=a["mc"], n_draw=5, chunk=4,
        apply_sym=False, insert_impl=impl)
    f_g, t_g, o_g = _port_insert(a, K)
    assert f_g.shape == (2, K) + (a["mc"],) * 3 and o_g.shape == (2, K, 4)
    assert rel_err(nn(f_g), f_r) < 1e-5
    assert rel_err(nn(t_g), t_r) < 1e-5
    np.testing.assert_allclose(nn(o_g), np.asarray(o_r), rtol=1e-5,
                               atol=1e-5)


def test_fused_insert_equals_staged(path):
    """One fused pass equals K staged passes (each class alone, the
    other classes' weights zeroed), as tests/test_pallas_insert.py holds
    the JAX engine."""
    a = _insert_inputs(path)
    f_f, t_f, o_f = _port_insert(a, K)
    cls = a["st"]["c"]
    for k in range(K):
        st1 = {**a["st"], "c": np.zeros_like(cls)}
        f_1, t_1, o_1 = _port_insert(a, 1, st1, a["w"] * (cls == k))
        scale = float(t_1.abs().max())
        assert float((f_f[:, k] - f_1).abs().max()) / scale < 1e-5
        assert float((t_f[:, k] - t_1).abs().max()) / scale < 1e-5
        np.testing.assert_allclose(nn(o_f[:, k]), nn(o_1[:, 0]), rtol=1e-5,
                                   atol=1e-6)


def test_optimiser_fused_equals_staged(path, monkeypatch):
    """``reconstruct`` from the same state and draws: the fused branch and
    the staged one (FUSED_CLASS_BYTES forced to 0) give the same maps,
    FSC and offsets."""
    p = path
    out = {}
    for name, limit in (("fused", tom.FUSED_CLASS_BYTES), ("staged", 0)):
        monkeypatch.setattr(tom, "FUSED_CLASS_BYTES", limit)
        op = _from_state(p["para"], p["data"], p["end"], p["key_end"])
        op.reconstruct()
        assert op.insert_fused == (name == "fused")
        out[name] = op
    a, b = out["fused"], out["staged"]
    assert np.max(np.abs(a.fsc - b.fsc)) < 1e-4
    assert rel_err(nn(a.refs), nn(b.refs)) < 1e-4
    np.testing.assert_allclose(a.insert_offsets, b.insert_offsets,
                               rtol=1e-5, atol=1e-6)


def test_class_distr_and_best_class(path):
    """From the state after the global round: the class fractions the
    JAX round recorded (its balance_class step) and its best classes."""
    p = path
    op = _from_state(p["para"], p["data"], p["states"][1], p["keys"][1])
    np.testing.assert_array_equal(op.refresh_class_distr(),
                                  p["recs"][0]["class_distr"])
    np.testing.assert_array_equal(
        op.best_class, p["jo"]._from_plane(p["states"][1]["par"]["c"]))
    assert op.best_class.dtype == np.int32


def test_balance_class_matches_jax(path):
    """An emptied class (every image in class 0, class 1's reference
    zeroed) is resigned from class 0 with the same replayed phase fields
    in both packages: references within 1e-5, the same key afterwards
    (tests/test_optimiser_parity.py holds the JAX side)."""
    p = path
    st = dict(p["states"][1])
    st["par"] = {**st["par"], "c": np.zeros_like(st["par"]["c"])}
    refs = np.array(st["refs"])
    refs[:, 1] = 0.0
    st["refs"] = refs
    vols, stack, _, _, cp = p["data"]
    jo = jom.Optimiser(JPara(**dataclasses.asdict(p["para"])),
                       mesh=make_mesh(n_devices=1))
    jo.set_data(stack, cp)
    jo.par = {k: jnp.asarray(v) for k, v in st["par"].items()}
    jo.refs = jnp.asarray(refs)
    jo.key, jo.iteration = p["keys"][1], st["iteration"]
    jo.ladder = jom.LadderState(**st["ladder"])
    jo.balance_class()
    op = _from_state(p["para"], p["data"], st, p["keys"][1])
    op.balance_class()
    got, want = nn(op.refs), np.asarray(jo.refs)
    assert not np.allclose(got[:, 1], 0.0)
    assert rel_err(got, want) < 1e-5
    np.testing.assert_array_equal(np.asarray(op.draws.key),
                                  np.asarray(jo.key))


def test_reconstruct_from_copied_state(path):
    """From the JAX state after the local round (its FSC differs by class):
    per-class references, (K, shells) FSC and (2, K, 3) insert offsets,
    with a cold C-balance in both packages as test_torch_slice holds the
    K = 1 reconstruction."""
    p = path
    st = p["end"]
    assert st["fsc"].shape == (K, N // 2)
    assert not np.allclose(st["fsc"][0], st["fsc"][1])
    op = _from_state(p["para"], p["data"], st, p["key_end"])
    op._w_warm = None
    op.reconstruct()
    want = p["reco"]
    assert op.fsc.shape == (K, N // 2) and op.refs.shape == (2, K) + (N,) * 3
    assert np.max(np.abs(op.fsc - want["fsc"])) < 2e-3, (op.fsc,
                                                          want["fsc"])
    assert rel_err(nn(op.refs), want["refs"]) < 2e-3
    assert op.insert_offsets.shape == (2, K, 3)
    np.testing.assert_allclose(op.insert_offsets, want["insert_offsets"],
                               rtol=1e-4, atol=1e-5)


def test_reconstruct_reads_each_class_fsc_and_warm_weights(path,
                                                           monkeypatch):
    """Each class's Wiener/C-balance step gets ITS class's previous FSC row
    and warm weights (the JAX package's fsc[k] and _w_warm[k]), and each
    class's converged weights are kept under its own key."""
    p = path
    st = p["end"]
    assert sorted(st["w_warm"]) == list(range(K))
    op = _from_state(p["para"], p["data"], st, p["key_end"])
    seen = []
    real = tengine.reconstruct_halves

    def spy(f, t, fsc, w0, r_u, **kw):
        seen.append((nn(fsc), nn(w0), kw["warm"]))
        return real(f, t, fsc, w0, r_u, **kw)

    monkeypatch.setattr(tengine, "reconstruct_halves", spy)
    op.reconstruct()
    assert len(seen) == K
    for k, (fsc, w0, warm) in enumerate(seen):
        assert warm
        np.testing.assert_array_equal(fsc, st["fsc"][k])
        np.testing.assert_array_equal(w0, st["w_warm"][k])
    assert sorted(op._w_warm) == list(range(K))
    assert not np.array_equal(nn(op._w_warm[0]), nn(op._w_warm[1]))


@pytest.mark.parametrize("rnd", [0, 1])
def test_round_from_copied_state(path, rnd):
    """The global round and the pinned local round, each from the JAX
    state before it with the JAX keys: top poses within 1 deg for at least
    75 % of the images, the resolution shell within 1, the same ladder and
    the class distribution within one image a class."""
    p = path
    st = dict(p["states"][rnd])
    if rnd:  # pinned as the JAX round was, after its state was taken
        st["ladder"] = {**st["ladder"], "search_type": tom.SEARCH_TYPE_LOCAL,
                        "r": R_LOCAL, "n_no_decrease": 0}
    op = _from_state(p["para"], p["data"], st, p["keys"][rnd])
    rec = op.run_iteration()
    jrec = p["recs"][rnd]
    assert rec["search_type"] == jrec["search_type"] and rec["r"] == jrec["r"]
    assert abs(rec["res_shell"] - jrec["res_shell"]) <= 1
    ang = 2 * np.degrees(np.arccos(np.clip(np.abs(np.sum(
        op.best_quat * p["quats"][rnd], 1)), -1, 1)))
    assert np.mean(ang < 1.0) >= 0.75, np.sort(ang)
    n_img = op.n_imgs
    assert np.max(np.abs(np.asarray(rec["class_distr"])
                         - np.asarray(jrec["class_distr"]))) * n_img <= 1
    assert rec["res_shell"] == max(
        spectrum.res_p(torch.as_tensor(f), p["para"].thres_cutoff_fsc)
        for f in op.fsc)


def test_round_resolution_is_best_class(path):
    """The ladder reads the best class's FSC crossing (the JAX package's
    max over classes), not class 0's: a round that skips its stages keeps
    the given FSC, whose class 1 crosses later."""
    p = path
    para = dataclasses.replace(p["para"], skip_e=True, skip_m=True,
                               skip_r=True)
    st = dict(p["end"])
    fsc = np.ones((K, N // 2), np.float32)
    fsc[0, 4:] = 0.0
    fsc[1, 9:] = 0.0
    st["fsc"] = fsc
    op = _from_state(para, p["data"], st, p["key_end"])
    assert op.run_iteration()["res_shell"] == 8


def test_state_roundtrip_carries_classes(path):
    """convert carries the (2, K, ...) references, (K, shells) FSC, the
    class distribution and the per-class warm weights both ways."""
    p = path
    st = p["end"]
    op = _from_state(p["para"], p["data"], st, p["key_end"])
    back = convert.state_dict(op)
    for k in ("refs", "fsc", "c_distr"):
        np.testing.assert_array_equal(back[k], np.asarray(st[k]), err_msg=k)
    assert sorted(back["w_warm"]) == sorted(st["w_warm"])
    for k, v in st["w_warm"].items():
        np.testing.assert_array_equal(back["w_warm"][k], v)


def class_study(n, per_class, noise, n_local, k=4):
    """chip_smoke's path A at box ``n`` through both packages (the port
    replaying the JAX draws): seeded references, a global round, then
    ``n_local`` local rounds pinned at r = 40 scaled to the box; purity
    (share of images in their own class), resolution shell and median
    pose error per round."""
    f = n / 160
    para = chip_smoke.class_para("configs/demo_3D.json")
    para = dataclasses.replace(para, size=n, k=k, mask_radius=75.0 * f,
                               init_res=25.0 * f,
                               global_search_res=para.global_search_res * f)
    data = chip_smoke.class3d_dataset(CPU, n, per_class, k, noise=noise)
    cls, q_true = data[3], data[2]
    jo, op = _both(para, data)
    rows = []
    for i in range(1 + n_local):
        for o, mod in ((jo, jom), (op, tom)):
            if i:
                _pin(o, mod, int(round(40 * n / 160)))
        jrec, rec = jo.run_iteration(), op.run_iteration()
        rows.append({pkg: dict(
            purity=round(float(np.mean(np.asarray(o.best_class) == cls)), 4),
            shell=r["res_shell"], pose=round(float(np.median(_pose_err(
                np.asarray(o.best_quat), q_true))), 3))
            for pkg, o, r in (("jax", jo, jrec), ("port", op, rec))})
    return rows


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    n_box, n_per, sd = int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3])
    n_loc = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    for i, row in enumerate(class_study(n_box, n_per, sd, n_loc)):
        print(dict(round=i, **row), flush=True)
