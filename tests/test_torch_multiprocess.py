"""Multi-process runs of the port on the CPU: ranks of
tests/torch_mp_worker.py meet through a ``file://`` rendezvous on gloo, one
thread each, at the JAX package's multi-process test size
(tests/test_multiprocess.py: n = 24, 16 images, its ``_para()``):

(a) 2 ranks x 2 rounds and 4 ranks x 1 round against the port's 1-rank
    run, at that test's bars (round 1 poses 2e-4, round 2 2e-3, the FSC,
    sigma, references and shell), and 2 ranks x 1 round at K = 2 (the
    class-fused insert and the class counts across ranks);
(b) 2 ranks replaying the JAX package's draws (recorded here into an .npz,
    so the workers import no jax) against the JAX package's
    single-process round on the same files, at the resume tolerances of
    tests/test_torch_dataset_run.py and the single-process round tests;
(c) only rank 0 writes the round files (the other ranks' own output
    directories stay empty: the workers check);
(d) the two-rank subtraction writers: Meta_Subtract.thu's paths into
    Subtract_Rank_00000{0,1}.mrcs reassemble every image once, each slice
    against the 1-rank stack;
(e) the row-cutting draws adapter, the uneven split, the launch variables,
    the lockstep phase loop with one rank holding no active image, and
    the refusal to run without the CUDA device a rank asked for.
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
    """The dataset; the port's 1-rank (2 rounds + subtraction), 2-rank (2
    rounds + subtraction), 4-rank (1 round), JAX-draws 2-rank (1 round)
    and K = 2 1- and 2-rank (1 round) runs, all started at once; meanwhile
    the JAX package's round here."""
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
    argvs = (_run_argv(w, 1, 2, "sp", "--subtract")
             + _run_argv(w, 2, 2, "mp2", "--subtract")
             + _run_argv(w, 4, 1, "mp4")
             + _run_argv(w, 2, 1, "jx2", "--draws",
                         os.path.join(w, "jax_draws.npz"))
             + _run_argv(w, 1, 1, "spk2", "--para", "para_k2.json")
             + _run_argv(w, 2, 1, "mpk2", "--para", "para_k2.json"))
    failed = []

    def ranks():
        try:
            run_ranks(argvs, [rank_env()] * len(argvs), w, timeout=600)
        except AssertionError as e:
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    # the JAX package's round, here while the ranks run
    jpara.output_directory = os.path.join(w, "jax_out")
    jo = jom.Optimiser(jpara, mesh=jmake_mesh(n_devices=1))
    jo.set_data_from_dataset(JDataset(os.path.join(w, "particles.thu"),
                                      particle_prefix=w, seed=jpara.seed))
    jo.init_reference(jread_mrc(os.path.join(w, "init.mrc")))
    jo.init_sigma()
    jrec = jo.run_iteration()
    th.join()
    if failed:
        raise failed[0]
    res = {k: dict(np.load(os.path.join(w, f"{k}.npz")))
           for k in ("sp", "mp2", "mp4", "jx2", "spk2", "mpk2")}
    return dict(w=w, res=res, jax=dict(top_r=jo.best_quat,
                                       res_shell=jrec["res_shell"],
                                       refs=np.asarray(jo.refs)))


@pytest.mark.parametrize("name,one,rounds", [("mp2", "sp", 2),
                                              ("mp4", "sp", 1),
                                              ("mpk2", "spk2", 1)])
def test_ranks_match_one_rank(runs, name, one, rounds):
    """(a) The bars of tests/test_multiprocess.py: round 1 near-bitwise
    (the draws are the global batch's on every rank), a second round
    percent-level (float sums in another order compound through sigma and
    the weights; its resampling can flip a tie); the classes equal. (Read:
    every pose and class equal, maps within 4.1e-7 / 2.2e-5 of the peak.
    At K = 2 a second round reads only corr 0.996: the warm-started
    C-balance turns the f32 round-off into another iteration count, and
    with a cold start the maps agree to 8.8e-7.)"""
    sp, mp = runs["res"][one], runs["res"][name]
    world = int(name[2:].lstrip("k"))
    for r in range(1, rounds + 1):
        # each rank's references and FSC before rank 0's broadcast are
        # rank 0's bits (the CPU sums in one order), and the summed insert
        # table's total is the ranks' own totals' sum
        refs_gap, fsc_gap, t_gap = mp[f"rank_gaps_{r}"]
        assert refs_gap.shape == (world,)
        assert not refs_gap.any() and not fsc_gap.any()
        assert t_gap.max() <= world * 2.0 ** -22, t_gap
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
    2-rank round on the JAX draws: the top poses within RESUME_APART deg of
    each other (median; tests/test_torch_dataset_run.py) and at least 75 %
    of them within 1 deg (the round-parity share of the single-process
    tests), the references correlated above 0.995 and the shells within
    one. (Read: every pose equal, correlation 1 - 2e-7.)"""
    jx, j = runs["res"]["jx2"], runs["jax"]
    apart = _angles(jx["top_r_1"], j["top_r"])
    assert float(np.median(apart)) < RESUME_APART, apart
    assert float(np.mean(apart < 1.0)) >= 0.75, apart
    corr = float(np.corrcoef(jx["refs_1"].ravel(), j["refs"].ravel())[0, 1])
    assert corr > 0.995, corr
    assert abs(int(jx["res_shell_1"]) - j["res_shell"]) <= 1


def test_only_rank_zero_writes(runs):
    """(c) Rank 0's directory holds the 1-rank run's files (and rank 1's
    subtraction stack); the workers held the other ranks' directories
    empty."""
    w = runs["w"]
    sp, mp = (set(os.listdir(os.path.join(w, k))) for k in ("sp", "mp2"))
    assert {"Meta_Round_001.thu", "Meta_Round_002.thu",
            "Reference_000_A_Round_002.mrc"} <= sp
    assert mp == sp | {"Subtract_Rank_000001.mrcs"}
    for name, world in (("mp2", 2), ("mp4", 4), ("jx2", 2)):
        for r in range(1, world):
            d = os.path.join(w, f"{name}_rank{r}")
            assert not os.path.exists(d) or not os.listdir(d)


def test_subtraction_writers(runs):
    """(d) Meta_Subtract.thu has one row per image (C1: 1 + G = 1), its
    paths into the two rank files reassemble every image once, and each
    slice correlates with the 1-rank stack's above 0.99 (the JAX test's
    bar); where both runs hold the same pose (within 1e-4) the slices
    agree to 1e-4 of the stack's peak. (Read: every pose equal, 1 - corr
    at most 2.6e-10, slices within 5.9e-6 of the peak.)"""
    w = runs["w"]
    one = read_mrc(os.path.join(w, "sp", "Subtract_Rank_000000.mrcs"))
    one_meta = read_thu(os.path.join(w, "sp", "Meta_Subtract.thu"))
    stacks = {r: read_mrc(os.path.join(w, "mp2",
                                       f"Subtract_Rank_{r:06d}.mrcs"))
              for r in (0, 1)}
    meta = read_thu(os.path.join(w, "mp2", "Meta_Subtract.thu"))
    assert len(meta) == len(one_meta) == B
    assert stacks[0].shape[0] + stacks[1].shape[0] == B
    seen = set()
    sp, mp = runs["res"]["sp"], runs["res"]["mp2"]
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


def test_uneven_split(monkeypatch):
    """(e) ``np.array_split``'s slots per rank, contiguous and covering;
    an optimiser holds its rank's rows of the process group's split and
    refuses more ranks than slots."""
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
    opt = Optimiser(para, device="cpu")
    opt.set_data(imgs, cp)
    assert opt.rows == slice(1, 2) and opt.par["r"].shape[1] == 1
    assert make_mesh().shape == {"half": 1, "data": 2}
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    monkeypatch.setattr(distributed, "rank", lambda: 0)
    with pytest.raises(ValueError, match="ranks for 2 slots"):
        Optimiser(para, device="cpu").set_data(imgs, cp)


def test_a_rank_missing_from_the_insert_sum_raises(monkeypatch):
    """(e) ``Optimiser._sum_over_ranks`` holds the summed insert table's
    total to the sum of the ranks' own totals: a right sum passes, and a
    sum that lost the other rank's tables (an all-reduce that hands back
    this rank's own) raises."""
    opt = Optimiser(Para(size=8, pixel_size=2.0), device="cpu")
    t = torch.rand(2, 5, 5, generator=torch.Generator().manual_seed(0))
    tables = (t.to(torch.complex64), t, torch.ones(2, 1, 4))
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "all_gather_object", lambda o: [o, o])
    monkeypatch.setattr(distributed, "all_reduce_sum", lambda x: 2 * x)
    out = opt._sum_over_ranks(tables)
    assert torch.equal(out[1], 2 * t)
    assert opt._rank_gaps["T"] <= 2 * 2.0 ** -22
    monkeypatch.setattr(distributed, "all_reduce_sum", lambda x: x)
    with pytest.raises(RuntimeError, match="not the sum of the 2 ranks"):
        opt._sum_over_ranks(tables)


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
