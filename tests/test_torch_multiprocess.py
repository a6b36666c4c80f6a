"""Multi-process runs of the port on the CPU: ranks of
tests/torch_mp_worker.py meet through a ``file://`` rendezvous on gloo, one
thread each, at the JAX package's multi-process test size
(tests/test_multiprocess.py: n = 24, 16 images, its ``_para()``):

(a) against the port's 1-rank run, at that test's bars (round 1 poses
    2e-4, round 2 2e-3, the FSC, sigma, references and shell), on the
    data-only layout (``--halves 1``: (1, W)) 2 ranks x 2 rounds, 4 ranks x
    1 round and 2 ranks x 1 round at K = 2 (the class-fused insert and the
    class counts across ranks), and on the JAX package's (half, data)
    layout 2 ranks x 2 rounds (2, 1), 4 ranks x 1 round (2, 2: a
    hemisphere's data ranks sum its insert tables), 2 ranks at K = 2
    (2, 1) and 3 ranks (odd: (1, 3));
(b) 2 ranks replaying the JAX package's draws (recorded here into an .npz,
    so the workers import no jax) against the JAX package's round on the
    same files: on (1, 2) against its single-device round, on (2, 1)
    against its round on ``make_mesh(n_devices=2)``, its own (2, 1) mesh,
    at the resume tolerances of tests/test_torch_dataset_run.py and the
    single-process round tests;
(c) only rank 0 writes the round files (the other ranks' own output
    directories stay empty: the workers check), and on (2, W/2) each rank
    holds one hemisphere's images, brick tables, insert tables and warm
    C-balance weights, its insert tables summed over its hemisphere's data
    ranks only;
(d) the two-rank subtraction writers on both layouts: Meta_Subtract.thu's
    paths into Subtract_Rank_00000{0,1}.mrcs reassemble every image once,
    each slice against the 1-rank stack;
(e) ``make_mesh`` at 1-6 ranks, the plane blocks, the row- and
    half-cutting draws adapter, the uneven split, a collective on a group
    without this rank, the pair gather's digest check, the launch
    variables, the lockstep phase loop with one rank holding no active
    image, and the refusal to run without the CUDA device a rank asked
    for.
"""

import dataclasses
import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from thunder_tpu.core import optimiser as jom
from thunder_tpu.data import ParticleDataset as JDataset
from thunder_tpu.io import read_mrc as jread_mrc
from thunder_tpu.parallel.mesh import make_mesh as jmake_mesh
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core import particle, sampling
from thunder_tpu_torch.core.draws import Draws, RowDraws
from thunder_tpu_torch.core.optimiser import Optimiser
from thunder_tpu_torch.data import ParticleDataset
from thunder_tpu_torch.io import read_mrc, read_thu
from thunder_tpu_torch.parallel import distributed
from thunder_tpu_torch.parallel.mesh import make_mesh

import torch_mp_worker as worker
from test_engine import B
from test_multiprocess import _para as jax_para
from test_multiprocess import _write_dataset
from test_torch_dataset_run import RESUME_APART
from test_torch_support import JaxDraws, nn, rank_env, run_ranks

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")


def _angles(a, b):
    dots = np.abs(np.sum(a * b, axis=1))
    return 2 * np.degrees(np.arccos(np.clip(dots, -1, 1)))


# each multi-rank run: (world, halves asked for, the layout it takes)
RUNS = {"mp2": (2, 1, (1, 2)), "mp4": (4, 1, (1, 4)), "jx2": (2, 1, (1, 2)),
        "mpk2": (2, 1, (1, 2)), "hp2": (2, 2, (2, 1)), "hp4": (4, 2, (2, 2)),
        "hpk2": (2, 2, (2, 1)), "mp3": (3, 2, (1, 3)), "jh2": (2, 2, (2, 1))}


def _run_argv(workdir, world, rounds, out, *extra):
    """The argvs of a ``world``-rank ``run`` of the worker into ``out``."""
    init = os.path.join(workdir, f"rendezvous_{out}")
    return [[sys.executable, WORKER, "run", workdir, str(r), str(world),
             init, str(rounds), out, *extra] for r in range(world)]


def _record_jax_draws(path, para, plane_index):
    """The JAX optimiser's draws of one global round (scan grid, seeding,
    every phase the loop may take, the insert, the FSC phase fields), in
    the order the port's optimiser asks for them, into ``path`` for the
    workers' ``NpzDraws``."""
    from thunder_tpu_torch.geom.symmetry import Symmetry

    d = JaxDraws(para.seed, plane_index)
    shape = plane_index.shape
    n_r = sampling.n_scan_rotations(para.m_s, Symmetry(para.sym).n_elements,
                                    para.mode)
    n_t = sampling.n_scan_translations(para.trans_s,
                                       para.trans_search_factor)
    out = dict(zip(("scan_grid_0_r", "scan_grid_0_t"), d.scan_grid(n_r,
                                                                  n_t)))
    out.update(zip(("scan_seed_0_g", "scan_seed_0_u_r", "scan_seed_0_u_t"),
                   d.scan_seed(0, shape, para.k)))
    draw = d.phase_draws(0, shape, para.m_l_r, para.m_l_t)
    for ph in range(particle.MAX_N_PHASE_PER_ITER):
        out.update({f"phase_draws_0_{ph}_{k}": v
                    for k, v in draw(ph).items()})
    out.update(zip(("insert_0_ri", "insert_0_ti"), d.insert(
        0, shape, min(para.m_reco, para.m_l_r), para.m_l_r, para.m_l_t)))
    out.update(zip(("fsc_phases_0_a", "fsc_phases_0_b"),
                   d.fsc_phases(para.size)))
    np.savez(path, **{k: nn(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dataset; the port's 1-rank runs (2 rounds + subtraction; K = 2,
    1 round) and the multi-rank runs of RUNS (2 rounds + subtraction at 2
    ranks, 1 round otherwise, the ``jx`` runs on the JAX draws), all
    started at once; meanwhile the JAX package's round here on one device
    and on its (2, 1) mesh."""
    w = str(tmp_path_factory.mktemp("mp"))
    _write_dataset(w)
    jpara = jax_para()
    para = Para(**dataclasses.asdict(jpara))
    with open(os.path.join(w, "para.json"), "w") as f:
        json.dump(dataclasses.asdict(para), f)
    with open(os.path.join(w, "para_k2.json"), "w") as f:
        json.dump(dataclasses.asdict(dataclasses.replace(para, k=2)), f)
    probe = Optimiser(para, device="cpu")
    probe.set_data_from_dataset(ParticleDataset(
        os.path.join(w, "particles.thu"), particle_prefix=w, seed=para.seed))
    _record_jax_draws(os.path.join(w, "jax_draws.npz"), para,
                      probe.plane_index)
    jdraws = ("--draws", os.path.join(w, "jax_draws.npz"))
    extra = {"mp2": ("--subtract",), "hp2": ("--subtract",),
             "jx2": jdraws, "jh2": jdraws,
             "mpk2": ("--para", "para_k2.json"),
             "hpk2": ("--para", "para_k2.json")}
    argvs = (_run_argv(w, 1, 2, "sp", "--subtract")
             + _run_argv(w, 1, 1, "spk2", "--para", "para_k2.json"))
    for name, (world, halves, _) in RUNS.items():
        argvs += _run_argv(w, world, 2 if name in ("mp2", "hp2") else 1,
                           name, "--halves", str(halves),
                           *extra.get(name, ()))
    failed = []

    def ranks():
        try:
            run_ranks(argvs, [rank_env()] * len(argvs), w, timeout=600)
        except AssertionError as e:
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    # the JAX package's round on one device and on its (2, 1) mesh, here
    # while the ranks run
    jax = {}
    for devices in (1, 2):
        jpara.output_directory = os.path.join(w, f"jax_out_{devices}")
        jo = jom.Optimiser(jpara, mesh=jmake_mesh(n_devices=devices))
        jo.set_data_from_dataset(JDataset(os.path.join(w, "particles.thu"),
                                          particle_prefix=w,
                                          seed=jpara.seed))
        jo.init_reference(jread_mrc(os.path.join(w, "init.mrc")))
        jo.init_sigma()
        jrec = jo.run_iteration()
        jax[devices] = dict(top_r=jo.best_quat, res_shell=jrec["res_shell"],
                            refs=np.asarray(jo.refs),
                            mesh=dict(jo.mesh.shape))
    th.join()
    if failed:
        raise failed[0]
    res = {k: dict(np.load(os.path.join(w, f"{k}.npz")))
           for k in ("sp", "spk2", *RUNS)}
    layouts = {k: [json.load(open(os.path.join(w, f"{k}_layout_{r}.json")))
                   for r in range(RUNS[k][0])] for k in RUNS}
    return dict(w=w, res=res, jax=jax, layouts=layouts)


@pytest.mark.parametrize("name,one,rounds", [("mp2", "sp", 2),
                                              ("mp4", "sp", 1),
                                              ("mpk2", "spk2", 1),
                                              ("hp2", "sp", 2),
                                              ("hp4", "sp", 1),
                                              ("hpk2", "spk2", 1),
                                              ("mp3", "sp", 1)])
def test_ranks_match_one_rank(runs, name, one, rounds):
    """(a) The bars of tests/test_multiprocess.py: round 1 near-bitwise
    (the draws are the global batch's on every rank), a second round
    percent-level (float sums in another order compound through sigma and
    the weights; its resampling can flip a tie); the classes equal. (Read:
    every pose and class equal, maps within 4.1e-7 / 2.2e-5 of the peak on
    (1, W). At K = 2 a second round reads only corr 0.996: the
    warm-started C-balance turns the f32 round-off into another iteration
    count, and with a cold start the maps agree to 8.8e-7. On (2, 1) each
    rank inserts and reconstructs its hemisphere as the one rank does, and
    both rounds read bit for bit equal.)"""
    sp, mp = runs["res"][one], runs["res"][name]
    world, _, (halves, n_data) = RUNS[name]
    for r in range(1, rounds + 1):
        # each rank's references and FSC before rank 0's broadcast are
        # rank 0's bits (the CPU sums in one order), the summed insert
        # table's total is the hemisphere's data ranks' own totals' sum,
        # and on two halves each rank held both gathered half maps of each
        # class to their owners' digests
        refs_gap, fsc_gap, t_gap, pair = mp[f"rank_gaps_{r}"]
        assert refs_gap.shape == (world,)
        assert not refs_gap.any() and not fsc_gap.any()
        assert t_gap.max() <= n_data * 2.0 ** -22, t_gap
        if n_data == 1:
            assert not t_gap.any()
        k = mp[f"refs_{r}"].shape[1]  # refs (2, K, ...)
        np.testing.assert_array_equal(pair, 2 * k if halves == 2 else 0)
        np.testing.assert_array_equal(mp[f"class_{r}"], sp[f"class_{r}"])
        tol = 2e-4 if r == 1 else 2e-3
        np.testing.assert_allclose(mp[f"top_r_{r}"], sp[f"top_r_{r}"],
                                   atol=tol)
        np.testing.assert_allclose(mp[f"top_t_{r}"], sp[f"top_t_{r}"],
                                   atol=tol)
        fsc_tol = 5e-3 if r == 1 else 3e-2
        np.testing.assert_allclose(mp[f"fsc_{r}"][:, :5], sp[f"fsc_{r}"][:, :5],
                                   atol=fsc_tol)
        np.testing.assert_allclose(mp[f"fsc_{r}"], sp[f"fsc_{r}"], atol=0.12)
        np.testing.assert_allclose(mp[f"sig_{r}"], sp[f"sig_{r}"], rtol=2e-3)
        a, b = mp[f"refs_{r}"], sp[f"refs_{r}"]
        if r == 1:
            np.testing.assert_allclose(a, b, rtol=2e-3,
                                       atol=1e-3 * float(np.abs(b).max()))
            assert int(mp["res_shell_1"]) == int(sp["res_shell_1"])
        else:
            corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
            assert corr > 0.995, corr
            assert abs(int(mp[f"res_shell_{r}"])
                       - int(sp[f"res_shell_{r}"])) <= 1


def test_ranks_replaying_jax_draws_match_jax(runs):
    """(b) The JAX package's single-process global round and the port's
    2-rank round on (1, 2) on the JAX draws: the top poses within
    RESUME_APART deg of each other (median; tests/test_torch_dataset_run.py)
    and at least 75 % of them within 1 deg (the round-parity share of the
    single-process tests), the references correlated above 0.995 and the
    shells within one. (Read: every pose equal, correlation 1 - 2e-7.)"""
    _check_jax_round(runs, "jx2", 1)


def test_half_layout_replaying_jax_draws_matches_jax_mesh(runs):
    """(b) The port's 2-rank round on (2, 1) on the JAX draws against the
    JAX package's round on ``make_mesh(n_devices=2)``, its own (2, 1)
    mesh, at the bars of the (1, 2) run."""
    _check_jax_round(runs, "jh2", 2)


def _check_jax_round(runs, name, devices):
    jx, j = runs["res"][name], runs["jax"][devices]
    assert j["mesh"] == {"half": devices, "data": 1}
    apart = _angles(jx["top_r_1"], j["top_r"])
    assert float(np.median(apart)) < RESUME_APART, apart
    assert float(np.mean(apart < 1.0)) >= 0.75, apart
    corr = float(np.corrcoef(jx["refs_1"].ravel(), j["refs"].ravel())[0, 1])
    assert corr > 0.995, corr
    assert abs(int(jx["res_shell_1"]) - j["res_shell"]) <= 1


def test_only_rank_zero_writes(runs):
    """(c) On both layouts rank 0's directory holds the 1-rank run's files
    (and rank 1's subtraction stack); the workers held the other ranks'
    directories empty."""
    w = runs["w"]
    sp = set(os.listdir(os.path.join(w, "sp")))
    assert {"Meta_Round_001.thu", "Meta_Round_002.thu",
            "Reference_000_A_Round_002.mrc"} <= sp
    for name in ("mp2", "hp2"):
        mp = set(os.listdir(os.path.join(w, name)))
        assert mp == sp | {"Subtract_Rank_000001.mrcs"}, name
    for name, (world, _, _) in RUNS.items():
        for r in range(1, world):
            d = os.path.join(w, f"{name}_rank{r}")
            assert not os.path.exists(d) or not os.listdir(d)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_rank_holds_its_block(runs, name):
    """(c) Each rank's layout is ``make_mesh``'s: on (2, W/2) rank r holds
    hemisphere r // (W/2) and slice r % (W/2) of its slots, and its images,
    filter state, brick tables, every insert table and its warm C-balance
    weights have a half axis of length 1; each insert table is summed over
    the hemisphere's data ranks only (not at all on (2, 1)). On (1, W)
    every rank holds both planes' slice r and sums over the world."""
    world, _, (halves, n_data) = RUNS[name]
    lh = 2 // halves
    n_imgs = runs["res"]["sp"]["top_r_1"].shape[0]
    rows = [distributed.local_plane_rows(n_imgs - n_imgs // 2, n_data, d)
            for d in range(n_data)]
    for r, lay in enumerate(runs["layouts"][name]):
        h, d = divmod(r, n_data)
        assert lay["shape"] == {"half": halves, "data": n_data}
        assert lay["coords"] == [h if halves == 2 else 0, d]
        assert lay["planes"] == ([h, h + 1] if halves == 2 else [0, 2])
        assert lay["rows"] == [rows[d].start, rows[d].stop]
        assert (lay["images"], lay["par"], lay["bricks"]) == (lh, lh, lh)
        assert lay["w_warm"] == [lh] and set(lay["insert"]) == {lh}
        group = list(range(h * n_data, (h + 1) * n_data))
        assert lay["insert_sum_ranks"] == (
            [] if n_data == 1 else [group] * len(lay["insert"]))


def test_subtraction_writers(runs):
    """(d) On both layouts ((1, 2): each rank its slots of both halves;
    (2, 1): each rank its hemisphere) Meta_Subtract.thu has one row per
    image (C1: 1 + G = 1), its paths into the two rank files reassemble
    every image once, and each slice correlates with the 1-rank stack's
    above 0.99 (the JAX test's bar); where both runs hold the same pose
    (within 1e-4) the slices agree to 1e-4 of the stack's peak. (Read:
    every pose equal, 1 - corr at most 2.6e-10, slices within 5.9e-6 of
    the peak.)"""
    for name in ("mp2", "hp2"):
        _check_subtraction(runs, name)


def _check_subtraction(runs, name):
    w = runs["w"]
    one = read_mrc(os.path.join(w, "sp", "Subtract_Rank_000000.mrcs"))
    one_meta = read_thu(os.path.join(w, "sp", "Meta_Subtract.thu"))
    stacks = {r: read_mrc(os.path.join(w, name,
                                       f"Subtract_Rank_{r:06d}.mrcs"))
              for r in (0, 1)}
    meta = read_thu(os.path.join(w, name, "Meta_Subtract.thu"))
    assert len(meta) == len(one_meta) == B
    assert stacks[0].shape[0] + stacks[1].shape[0] == B
    seen = set()
    sp, mp = runs["res"]["sp"], runs["res"][name]
    same = np.max(np.abs(sp["top_r_2"] - mp["top_r_2"]), axis=1) < 1e-4
    peak = float(np.abs(one).max())
    for row in range(B):
        m = re.fullmatch(r"(\d+)@Subtract_Rank_(\d+)\.mrcs",
                         meta.particle_paths[row])
        sl, rk = int(m.group(1)) - 1, int(m.group(2))
        seen.add((rk, sl))
        img = stacks[rk][sl]
        ref = one[int(one_meta.particle_paths[row].split("@")[0]) - 1]
        c = float(np.corrcoef(img.ravel(), ref.ravel())[0, 1])
        assert c > 0.99, (row, c)
        if same[row]:
            assert np.abs(img - ref).max() < 1e-4 * peak, row
    assert len(seen) == B and same.sum() >= B // 2


def test_row_draws_cut_the_global_batch():
    """(e) ``RowDraws`` hands out the global batch's rows: per-image draws
    equal the uncut stream's rows, the rest pass through, and the two
    streams stay in step."""
    rows = slice(1, 3)
    cut, full = RowDraws(Draws(5, "cpu"), rows), Draws(5, "cpu")
    shape = (2, 4)
    for a, b in zip(cut.scan_grid(7, 3), full.scan_grid(7, 3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(cut.scan_seed(0, shape, 2), full.scan_seed(0, shape, 2)):
        torch.testing.assert_close(a, b[:, rows], rtol=0, atol=0)
    dc, df = (d.phase_draws(0, shape, 5, 3) for d in (cut, full))
    for ph in range(2):
        got, want = dc(ph), df(ph)
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k][:, rows], rtol=0,
                                       atol=0)
    for a, b in zip(cut.insert(0, shape, 4, 5, 3),
                    full.insert(0, shape, 4, 5, 3)):
        torch.testing.assert_close(a, b[:, rows], rtol=0, atol=0)
    torch.testing.assert_close(cut.scale_quats(shape),
                               full.scale_quats(shape)[:, rows])
    torch.testing.assert_close(cut.fsc_phases(4)[0], full.fsc_phases(4)[0])


def test_row_draws_cut_a_hemisphere():
    """(e) With ``planes`` ``RowDraws`` keeps one hemisphere's plane of the
    global batch (the half axis stays, at length 1), and its rows."""
    rows, planes = slice(1, 3), slice(1, 2)
    cut, full = RowDraws(Draws(5, "cpu"), rows, planes), Draws(5, "cpu")
    shape = (2, 4)
    for a, b in zip(cut.scan_seed(0, shape, 2), full.scan_seed(0, shape, 2)):
        assert a.shape[0] == 1
        torch.testing.assert_close(a, b[1:2, rows], rtol=0, atol=0)
    got, want = (d.phase_draws(0, shape, 5, 3)(0) for d in (cut, full))
    for k in want:
        torch.testing.assert_close(got[k], want[k][1:2, rows], rtol=0,
                                   atol=0)
    for a, b in zip(cut.insert(0, shape, 4, 5, 3),
                    full.insert(0, shape, 4, 5, 3)):
        torch.testing.assert_close(a, b[1:2, rows], rtol=0, atol=0)
    torch.testing.assert_close(cut.scale_angles(shape),
                               full.scale_angles(shape)[1:2, rows])


@pytest.mark.parametrize("world,n_halves,shape", [
    (1, 2, (1, 1)), (2, 2, (2, 1)), (3, 2, (1, 3)), (4, 2, (2, 2)),
    (6, 2, (2, 3)), (4, 1, (1, 4)), (2, 1, (1, 2))])
def test_make_mesh(monkeypatch, world, n_halves, shape):
    """(e) The JAX package's ``make_mesh`` shapes: (2, W/2) at an even W,
    (1, W) at an odd one or with ``n_halves=1``; rank r at half r // (W/2)
    and data index r % (W/2), holding one plane (lh = 1) or both; the
    ranks' blocks cover every (plane, slot) of an S = 7 layout once; the
    data group is the hemisphere's ranks, the pair group the two ranks at
    one data index (none on one half); and it matches the JAX package's
    mesh on as many virtual devices."""
    s = 7
    cover = np.zeros((2, s), np.int64)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    for r in range(world):
        monkeypatch.setattr(distributed, "rank", lambda: r)
        m = make_mesh(n_halves)
        assert (m.world, m.rank) == (world, r)
        assert (m.shape["half"], m.shape["data"]) == shape
        assert m.local_halves == 2 // shape[0]
        h, d = m.coords()
        assert (h, d) == divmod(r, shape[1])
        planes, rows = m.block(s)
        assert planes == m.planes
        assert planes.stop - planes.start == m.local_halves
        cover[planes, rows] += 1
        assert rows == distributed.local_plane_rows(s, shape[1], d)
    assert (cover == 1).all()
    assert m.blocks(s) == [m.block(s, r) for r in range(world)]
    if world == 1:
        return
    # the groups of a layout without a process group: the world and single
    # ranks need no torch group, so they are made without one
    if shape[1] in (1, world):
        monkeypatch.setattr(distributed, "rank", lambda: 0)
        m = make_mesh(n_halves)
        monkeypatch.setattr(distributed, "_GROUPS", {})
        assert m.data_group().ranks == tuple(range(shape[1]))
        pair = m.pair_group()
        assert (pair is None if shape[0] == 1
                else pair.ranks == (0, shape[1]))
    if n_halves == 2 and world <= 8:
        jm = jmake_mesh(n_devices=world)
        assert (jm.shape["half"], jm.shape["data"]) == shape


def test_a_collective_on_a_group_without_this_rank_raises():
    """(e) No quiet fallback to the world: a collective naming a group that
    does not hold this rank raises, as does a broadcast from a rank
    outside the group."""
    x = torch.ones(3)
    other = distributed.Group((1, 2))
    for call in (lambda: distributed.all_reduce_sum(x, other),
                 lambda: distributed.broadcast(x, 1, other),
                 lambda: distributed.all_gather_cat(x, other),
                 lambda: distributed.all_gather_object(1, other)):
        with pytest.raises(RuntimeError, match="rank 0"):
            call()
    with pytest.raises(RuntimeError, match="from rank 1"):
        distributed.broadcast(x, 1, distributed.Group((0, 2)))
    # a group of this rank alone hands back its input
    assert distributed.all_reduce_sum(x, distributed.Group((0,))) is x


def test_uneven_split(monkeypatch):
    """(e) ``np.array_split``'s slots per rank, contiguous and covering;
    an optimiser holds its rank's block of the process group's layout
    (by default (2, W/2) at an even W, one hemisphere a rank) and refuses
    more data ranks than slots."""
    assert distributed.split_sizes(7, 3) == [3, 2, 2]
    got = [distributed.local_plane_rows(7, 3, r) for r in range(3)]
    assert got == [slice(0, 3), slice(3, 5), slice(5, 7)]
    assert distributed.split_sizes(8, 1) == [8]
    imgs = np.zeros((4, 8, 8), np.float32)
    cp = {k: np.ones(4, np.float32) for k in (
        "voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
        "amp_contrast")}
    para = Para(size=8, pixel_size=2.0, m_l_r=4, m_l_t=2, m_l_d=1)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    opt = Optimiser(para, device="cpu", mesh=make_mesh(n_halves=1))
    opt.set_data(imgs, cp)
    assert opt.rows == slice(1, 2) and opt.par["r"].shape[:2] == (2, 1)
    assert opt.mesh.shape == {"half": 1, "data": 2}
    # the default layout of two ranks: rank 1 holds hemisphere B
    opt = Optimiser(para, device="cpu")
    opt.set_data(imgs, cp)
    assert make_mesh().shape == {"half": 2, "data": 1}
    assert opt.planes == slice(1, 2) and opt.rows == slice(0, 2)
    assert opt.par["r"].shape[:2] == (1, 2)
    np.testing.assert_array_equal(opt.ctf_params["voltage"].shape, (1, 2))
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    monkeypatch.setattr(distributed, "rank", lambda: 0)
    with pytest.raises(ValueError, match="ranks for 2 slots"):
        Optimiser(para, device="cpu").set_data(imgs, cp)


def test_a_rank_missing_from_the_insert_sum_raises(monkeypatch):
    """(e) ``Optimiser._sum_over_data`` holds the summed insert table's
    total to the sum of the data ranks' own totals: a right sum passes,
    and a sum that lost the other rank's tables (an all-reduce that hands
    back this rank's own) raises. It sums over the hemisphere's data
    group, and on (2, 1), where that group is this rank alone, not at
    all."""
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    opt = Optimiser(Para(size=8, pixel_size=2.0), device="cpu",
                    mesh=make_mesh(n_halves=1))
    t = torch.rand(2, 5, 5, generator=torch.Generator().manual_seed(0))
    tables = (t.to(torch.complex64), t, torch.ones(2, 1, 4))
    groups = []
    monkeypatch.setattr(distributed, "all_gather_object",
                        lambda o, group=None: [o, o])

    def twice(x, group=None):
        groups.append(group.ranks)
        return 2 * x

    monkeypatch.setattr(distributed, "all_reduce_sum", twice)
    out = opt._sum_over_data(tables)
    assert torch.equal(out[1], 2 * t) and set(groups) == {(0, 1)}
    assert opt._rank_gaps["T"] <= 2 * 2.0 ** -22
    monkeypatch.setattr(distributed, "all_reduce_sum",
                        lambda x, group=None: x)
    with pytest.raises(RuntimeError, match="not the sum of the 2 ranks"):
        opt._sum_over_data(tables)
    half = Optimiser(Para(size=8, pixel_size=2.0), device="cpu")
    assert half.mesh.shape == {"half": 2, "data": 1}
    assert half._sum_over_data(tables) is tables


@pytest.mark.parametrize("rank", [0, 1])
def test_a_wrong_half_from_the_pair_gather_raises(monkeypatch, rank):
    """(e) On (2, 1) ``Optimiser._gather_pair`` holds each gathered half
    map to the digest its owner took before the gather: the right gather
    passes and is counted for the round's record, while a gather that hands
    back this rank's own half twice, or the halves swapped, raises."""
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: rank)
    opt = Optimiser(Para(size=8, pixel_size=2.0), device="cpu")
    pair = opt.mesh.pair_group()
    assert pair.ranks == (0, 1)
    g = torch.Generator().manual_seed(0)
    maps = [torch.rand(1, 4, 4, 4, generator=g) for _ in range(2)]
    mine = maps[rank]
    monkeypatch.setattr(
        distributed, "all_gather_object",
        lambda o, group=None: [o if r == rank else
                               int(maps[r].view(torch.int32).sum(
                                   dtype=torch.int64)) for r in range(2)])
    monkeypatch.setattr(distributed, "all_gather_cat",
                        lambda x, group=None: torch.cat(maps))
    out = opt._gather_pair(mine, pair)
    assert torch.equal(out, torch.cat(maps)) and opt._rank_gaps["pair"] == 2
    for wrong in ([mine, mine], maps[::-1]):
        monkeypatch.setattr(distributed, "all_gather_cat",
                            lambda x, group=None, w=wrong: torch.cat(w))
        with pytest.raises(RuntimeError, match="not their owners'"):
            opt._gather_pair(mine, pair)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"JAX_NUM_PROCESSES": "1"}, None),
    ({"JAX_COORDINATOR_ADDRESS": "h:5", "JAX_NUM_PROCESSES": "3",
      "JAX_PROCESS_ID": "2"}, ("tcp://h:5", 3, 2, 2, 3)),
    ({"JAX_COORDINATOR_ADDRESS": "h:5", "JAX_NUM_PROCESSES": "3",
      "JAX_PROCESS_ID": "2", "RANK": "1", "WORLD_SIZE": "2",
      "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, ("env://", 2, 1, 0, 1)),
    ({"JAX_COORDINATOR_ADDRESS": "h:5", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "3", "LOCAL_WORLD_SIZE": "2"},
     ("tcp://h:5", 4, 3, 1, 2)),
    ({"JAX_COORDINATOR_ADDRESS": "h:5"}, ValueError),
    ({"JAX_NUM_PROCESSES": "2"}, ValueError),
])
def test_launch_settings(env, want):
    """(e) The JAX package's variables and torchrun's; torchrun's win."""
    if want is ValueError:
        with pytest.raises(ValueError):
            distributed.launch_settings(env=env)
        return
    got = distributed.launch_settings(env=env)
    if want is None:
        assert got is None
    else:
        assert (got["init_method"], got["world"], got["rank"],
                got["local_rank"], got["local_world"]) == want


def test_lockstep_phase_loop(tmp_path):
    """(e) Two ranks of ``engine.local_search``: rank 1's images all finish
    at phase ``min_phase`` while rank 0's run to ``max_phase``; rank 1 keeps
    taking each phase's draws with no active image (as many as rank 0), and
    each rank's state and phase counts equal its rows run alone."""
    w = str(tmp_path)
    init = os.path.join(w, "rendezvous")
    run_ranks([[sys.executable, WORKER, "lockstep", str(r), "2", init,
                os.path.join(w, f"lock_{r}.npz")] for r in range(2)],
              [rank_env()] * 2, w, timeout=120)
    kw = worker.LOCK_KW
    for r in range(2):
        got = dict(np.load(os.path.join(w, f"lock_{r}.npz")))
        np.testing.assert_array_equal(got.pop("drawn"),
                                      np.arange(kw["max_phase"]))
        st, nph, drawn = worker.lockstep_run(r, 2)
        assert len(drawn) == (kw["max_phase"] if r == 0
                              else kw["min_phase"] + 1)
        np.testing.assert_array_equal(got.pop("nph"), nph.numpy())
        assert set(nph.numpy().ravel()) == {len(drawn)}
        for k, v in st.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_a_rank_without_cuda_raises(monkeypatch):
    """No fallback: asking for CUDA where there is none raises, alone or
    as a rank of a launch; ``cpu`` runs on the CPU without a group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.maybe_initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.maybe_initialize("localhost:1", 2, 0)
    assert distributed.maybe_initialize(cpu=True) == torch.device("cpu")
    assert distributed.world_size() == 1
