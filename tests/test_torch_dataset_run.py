"""Port parity for the way in of a user's data and the ``run`` entry
point, on a .thu table + MRC stack written here (n = 32, 48 particles,
two groups, an asymmetric 6-blob phantom, CTF, noise 0.1):

- ``data.ParticleDataset``: permutation, halves, 0-based groups, CTF
  columns, poses and the images read through ``Path of Particles``
  exactly equal to the JAX package's;
- ``Optimiser.set_data_from_dataset``: the half-plane layout and groups
  exactly, the preprocessed spectra (background normalisation, FFT and the
  zero-mask stack) within 1e-5 relative, the paths and micrograph
  coordinates carried into the .thu output;
- ``Optimiser.load_poses``: the particle-filter state exactly equal in 3D
  (stored k1..k3 and translation stddevs, and the defaults) and with the
  2D decode;
- ``python -m thunder_tpu_torch.cli run`` end to end (2 rounds and the
  final round) and a resume from its Meta_Final.thu (Global Search
  false, 1 round): median top-pose error against the truth under 15 deg
  after each (the JAX package's own e2e bar); the file names, the .thu
  paths and coordinates against the JAX package's ``run`` on the same
  config;
- the resume against the JAX package's resume from the same
  Meta_Final.thu: the port's median pose error at most RESUME_TOL deg
  above the JAX package's, the two packages' poses within RESUME_APART
  deg of each other (median), the stored shifts equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from thunder_tpu.cli.main import main as jcli
from thunder_tpu.config import Para as JPara
from thunder_tpu.core import optimiser as jom
from thunder_tpu.data import ParticleDataset as JDataset
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch.cli.main import main as tcli
from thunder_tpu_torch.config import Para, load_para
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.data import ParticleDataset as TDataset
from thunder_tpu_torch.io import ThuColumns, read_thu, write_mrc
from thunder_tpu_torch.io.thu import make_table, write_thu

from test_torch_support import nn, rel_err

torch.set_num_threads(1)

N = 32
B = 48
POSE_MAX = 15.0  # median top-pose error (deg), tests/test_optimiser_e2e.py
# the resume from one Meta_Final.thu in both packages: their draws differ,
# so the round is held to the truth and to the other package's. Read:
# port 4.38 deg, JAX package 4.85 deg, 1.11 deg apart (median)
RESUME_TOL = 1.0
RESUME_APART = 2.5


def _angles(q_est, q_true):
    dots = np.abs(np.sum(q_est * q_true, axis=1))
    return 2 * np.degrees(np.arccos(np.clip(dots, -1, 1)))


def _stack(vol, q, tr, cp, rng):
    """Projections of ``vol`` at poses (q, tr) with the CTFs ``cp``, plus
    noise 0.1 x their std (the port's projector, on the CPU)."""
    from thunder_tpu_torch.core import projector
    from thunder_tpu_torch.geom import quat
    from thunder_tpu_torch.ops import ctf as ctf_ops
    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops.translate import translate_ft

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    vf = projector.build_projectee_3d(t(vol), pf=2)
    f = torch.arange(N).float() - N // 2
    colf, rowf = f[None, :].expand(N, N).reshape(-1), \
        f[:, None].expand(N, N).reshape(-1)
    c2d = ctf_ops.ctf_pixels(colf, rowf, N, 1.32, *[t(cp[k])[:, None] for k in (
        "voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
        "amp_contrast", "phase_shift")]).reshape(-1, N, N)
    sl = projector.project_full_3d(vf, quat.rotate3d(t(q)), N, N // 2 - 1)
    sl = translate_ft(sl * c2d, t(tr[:, 0]), t(tr[:, 1]))
    stack = fft_ops.ifft2_center(sl).real.numpy()
    return (stack + rng.normal(0, 0.1 * stack.std(), stack.shape)).astype(
        np.float32)


def _config(d, out, db, g_search=True, iters=2):
    return {
        "Basic": {
            "2D or 3D Mode": "3D", "Global Search": g_search,
            "Local Search": True, "CTF Search": False,
            "Number of Classes": 1, "Size of Image": N,
            "Pixel Size (Angstrom)": 1.32,
            "Radius of Mask on Images (Angstrom)": N * 1.32 / 2.2,
            "Estimated Translation (Pixel)": 2,
            "Initial Resolution (Angstrom)": 4.5,
            "Perform Global Search Under (Angstrom)": 3.4,
            "Symmetry": "C1", "Initial Model": str(d / "init.mrc"),
            ".thu File Storing Paths and CTFs of Images": str(db),
            "Path of Particles": str(d), "Path of Output": str(out),
            "Prefix of Output": ""},
        "Advanced": {
            "Max Number of Iteration": iters, "Padding Factor": 2,
            "Number of Sampling Points for Scanning in Global Search (3D)":
                800,
            "Number of Sampling Points of Rotation in Local Search (3D)": 64,
            "Number of Sampling Points of Translation in Local Search": 9,
            "Number of Sampling Points Used in Reconstruction": 8,
            "Save Reference(s) Each Iteration": False,
            "Save .thu File Each Iteration": False},
    }


def _write_dataset(d):
    """The dataset in ``d``: stack.mrcs (paths relative to ``Path of
    Particles``), particles.thu (two groups, micrograph names and
    coordinates), init.mrc (the phantom) and run.json."""
    rng = np.random.default_rng(5)
    g = np.mgrid[:N, :N, :N].astype(np.float32) - N // 2
    vol = np.zeros((N, N, N), np.float32)
    for _ in range(6):
        c = rng.uniform(-N / 5, N / 5, 3)
        s = rng.uniform(N / 20, N / 10)
        vol += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0)
                      / (2 * s * s)).astype(np.float32)
    q = rng.normal(size=(B, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, 1.0, (B, 2)).astype(np.float32)
    cp = dict(voltage=np.full(B, 300e3), defocus_u=rng.uniform(1e4, 2e4, B),
              defocus_v=rng.uniform(1e4, 2e4, B),
              defocus_theta=rng.uniform(0, np.pi, B), cs=np.full(B, 2.7e7),
              amp_contrast=np.full(B, 0.1), phase_shift=np.zeros(B))
    cp = {k: v.astype(np.float32) for k, v in cp.items()}
    write_mrc(str(d / "stack.mrcs"), _stack(vol, q, tr, cp, rng),
              voxel_size=1.32)
    write_mrc(str(d / "init.mrc"), vol, voxel_size=1.32)
    t = make_table(
        B, particle_paths=[f"{i + 1}@stack.mrcs" for i in range(B)],
        micrograph_paths=[f"mic_{i % 3}.mrc" for i in range(B)],
        coordinate_x=rng.uniform(0, 4000, B),
        coordinate_y=rng.uniform(0, 4000, B),
        group_id=1 + np.arange(B) % 2, voltage=cp["voltage"],
        defocus_u=cp["defocus_u"], defocus_v=cp["defocus_v"],
        defocus_theta=cp["defocus_theta"], cs=cp["cs"],
        amplitude_contrast=cp["amp_contrast"],
        phase_shift=cp["phase_shift"])
    write_thu(str(d / "particles.thu"), t)
    (d / "run.json").write_text(json.dumps(
        _config(d, d / "out", d / "particles.thu")))
    return dict(dir=d, vol=vol, q=q, table=read_thu(str(d / "particles.thu")))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("dataset"))


def test_dataset_matches_jax(data):
    d = data["dir"]
    jd = JDataset(str(d / "particles.thu"), str(d), seed=7)
    td = TDataset(str(d / "particles.thu"), str(d), seed=7)
    np.testing.assert_array_equal(td.permutation, jd.permutation)
    np.testing.assert_array_equal(td.halves, jd.halves)
    np.testing.assert_array_equal(td.group_ids, jd.group_ids)
    assert set(td.group_ids) == {0, 1}
    jc, tc = jd.ctf_params(), td.ctf_params()
    assert tc.keys() == jc.keys()
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k])
        assert tc[k].dtype == jc[k].dtype
    for a, b in zip(td.poses(), jd.poses()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    idx = np.array([5, 0, 47, 12])
    np.testing.assert_array_equal(td.load_images(idx), jd.load_images(idx))
    np.testing.assert_array_equal(td.load_images(), jd.load_images())


def _para(d, **kw):
    para = load_para(str(d / "run.json"))
    return dataclasses.replace(para, output_directory=str(d / "unused"), **kw)


def test_set_data_from_dataset_matches_jax(data):
    d = data["dir"]
    para = _para(d)
    jo = jom.Optimiser(JPara(**dataclasses.asdict(para)),
                       mesh=make_mesh(n_devices=1))
    jo.set_data_from_dataset(JDataset(para.db, para.par_prefix,
                                      seed=para.seed))
    to = tom.Optimiser(para, device="cpu")
    to.set_data_from_dataset(TDataset(para.db, para.par_prefix,
                                      seed=para.seed))
    for name in ("plane_index", "plane_valid", "groups_plane", "group_ids",
                 "halves"):
        np.testing.assert_array_equal(getattr(to, name), getattr(jo, name))
    assert to.n_groups == jo.n_groups == 2
    for name in ("imgs_ft", "imgs_ft_ori"):
        assert rel_err(nn(getattr(to, name)), getattr(jo, name)) < 1e-5
    for k, v in jo.ctf_params.items():
        np.testing.assert_array_equal(nn(to.ctf_params[k]), v)
    assert to.particle_paths == jo.particle_paths
    assert to.micrograph_paths == jo.micrograph_paths
    np.testing.assert_array_equal(to.coords_xy, jo.coords_xy)
    t = to._build_thu_table()
    assert t.particle_paths == data["table"].particle_paths
    np.testing.assert_array_equal(
        t.values[:, ThuColumns.COORDINATE_X:ThuColumns.COORDINATE_Y + 1],
        data["table"].values[:, ThuColumns.COORDINATE_X:
                             ThuColumns.COORDINATE_Y + 1])


@pytest.mark.parametrize("mode", ["3d", "3d_defaults", "2d"])
def test_load_poses_matches_jax(mode, data):
    rng = np.random.default_rng(11)
    n = 16
    para = Para(mode="2d" if mode == "2d" else "3d", k=2, size=n,
                pixel_size=2.0, m_l_r=5, m_l_t=3, m_l_d=4, seed=2,
                g_search=False)
    imgs = rng.normal(size=(10, n, n)).astype(np.float32)
    cp = dict(voltage=np.full(10, 300e3, np.float32),
              defocus_u=np.full(10, 1.5e4, np.float32),
              defocus_v=np.full(10, 1.5e4, np.float32),
              defocus_theta=np.zeros(10, np.float32),
              cs=np.zeros(10, np.float32),
              amp_contrast=np.full(10, 0.1, np.float32))
    q = rng.normal(size=(10, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tr = rng.normal(size=(10, 2)).astype(np.float32)
    d = rng.uniform(0.9, 1.1, 10).astype(np.float32)
    cls = (np.arange(10) % 2).astype(np.int32)
    extra = {} if mode == "3d_defaults" else dict(
        k123=tuple(rng.uniform(-1e-5, 0.1, 10) for _ in range(3)),
        std_t=tuple(rng.uniform(0.0, 2.0, 10) for _ in range(2)))
    jo = jom.Optimiser(JPara(**dataclasses.asdict(para)),
                       mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.load_poses(q, tr, d, cls, **extra)
    to = tom.Optimiser(para, device="cpu")
    to.set_data(imgs, cp)
    to.load_poses(q, tr, d, cls, **extra)
    for k in ("r", "t", "d", "c", "topR", "topT", "topD", "k1", "k2", "k3",
              "s0", "s1"):
        np.testing.assert_array_equal(nn(to.par[k]), np.asarray(jo.par[k]),
                                      err_msg=k)
    if mode == "2d":
        np.testing.assert_allclose(to.best_phi, jo.best_phi, atol=1e-6)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The port's ``run`` and a resume from its Meta_Final.thu, and the
    JAX package's ``run`` on the same config."""
    d = data["dir"]
    tcli(["--cpu", "run", str(d / "run.json")])
    resume = d / "resume.json"
    resume.write_text(json.dumps(_config(
        d, d / "out_resume", d / "out" / "Meta_Final.thu", g_search=False,
        iters=1)))
    tcli(["--cpu", "run", str(resume)])
    jout = tmp_path_factory.mktemp("jax_run")
    jcli(["--cpu", "run", str(d / "run.json"), "-o", str(jout)])
    jres = tmp_path_factory.mktemp("jax_resume")
    jcli(["--cpu", "run", str(resume), "-o", str(jres)])
    return dict(out=d / "out", resume=d / "out_resume", jax=jout,
                jax_resume=jres)


def test_run_and_resume_against_the_truth(data, runs):
    for out in (runs["out"], runs["resume"]):
        meta = read_thu(str(out / "Meta_Final.thu"))
        assert len(meta) == B
        ang = _angles(meta.values[:, ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1],
                      data["q"])
        assert np.median(ang) < POSE_MAX, (out.name, np.sort(ang))
        assert meta.particle_paths == data["table"].particle_paths
        assert meta.micrograph_paths == data["table"].micrograph_paths
        np.testing.assert_array_equal(
            meta.col(ThuColumns.COORDINATE_X),
            data["table"].col(ThuColumns.COORDINATE_X))
        assert "ROUND" in (out / "thunder.log").read_text()


def test_resume_matches_jax(data, runs):
    """One local round from the same stored poses in both packages. After
    it both store the shifts since the round's re-centring (zero): the
    re-centring offsets are not written to the .thu (ROADMAP Queue 3)."""
    tp, tj = (read_thu(str(runs[k] / "Meta_Final.thu"))
              for k in ("resume", "jax_resume"))
    quat = lambda t: t.values[:, ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1]
    shift = lambda t: t.values[:, ThuColumns.TRANSLATION_X:
                               ThuColumns.TRANSLATION_Y + 1]
    err_p, err_j = (float(np.median(_angles(quat(t), data["q"])))
                    for t in (tp, tj))
    apart = float(np.median(_angles(quat(tp), quat(tj))))
    assert err_p <= err_j + RESUME_TOL, (err_p, err_j)
    assert apart < RESUME_APART, apart
    np.testing.assert_array_equal(shift(tp), shift(tj))


def test_run_prints_the_history(data, runs, capsys):
    """The resume's stored poses seed a LOCAL round; ``run`` prints one
    JSON line per round."""
    d = data["dir"]
    out = d / "out_print"
    cfg = d / "print.json"
    cfg.write_text(json.dumps(_config(d, out, d / "out" / "Meta_Final.thu",
                                      g_search=False, iters=1)))
    tcli(["--cpu", "run", str(cfg)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and lines[0]["search_type"] == tom.SEARCH_TYPE_LOCAL
    assert lines[0]["iter"] == 1


def test_run_files_match_jax(data, runs):
    names = set(os.listdir(runs["out"]))
    assert names == set(os.listdir(runs["jax"]))
    assert {"Reference_000_Final.mrc", "Meta_Final.thu",
            "thunder.log"} <= names
    tp = read_thu(str(runs["out"] / "Meta_Final.thu"))
    tj = read_thu(str(runs["jax"] / "Meta_Final.thu"))
    assert tp.particle_paths == tj.particle_paths
    assert tp.micrograph_paths == tj.micrograph_paths
    cols = [ThuColumns.COORDINATE_X, ThuColumns.COORDINATE_Y,
            ThuColumns.GROUP_ID, ThuColumns.VOLTAGE, ThuColumns.DEFOCUS_U]
    np.testing.assert_array_equal(tp.values[:, cols], tj.values[:, cols])
