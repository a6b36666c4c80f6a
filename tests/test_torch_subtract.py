"""Port parity for signal subtraction and the provided mask volume, on
tests/test_engine.py's drive (n = 24, 16 particles) with C2 symmetry, so
that each image has two subtracted copies:

- ``finalise`` with ``para.subtract`` from the JAX state after a global
  round (``convert.load_state``, the JAX keys replayed), a provided mask
  and a region-centre map, the C-balance of both Nyquist reconstructions
  started cold in both packages (as tests/test_torch_final_round.py
  does: warm-started, it stops after one iteration or runs ten as f32
  round-off puts the first step's change on either side of 1e-2, which
  moves the half maps by ~10 %): Subtract_Rank_000000.mrcs (2 x 16 images)
  within 1e-3 relative (L2) of the JAX package's, image by image within
  2e-3; Meta_Subtract.thu's paths equal, its numeric columns within 1e-4
  (translations, moved into the subtracted frame, within 1e-3 px); the
  final maps within 1e-3 (L2);
- ``set_mask``'s three readers from the same state: solvent flattening
  with the mask low-passed to the band (within 1e-5), the golden FSC
  under ``mask_fsc`` (within 1e-4) and the reference auto-recentring,
  skipped when a mask is set and otherwise equal (within 1e-4);
- the density centroid of the region-centre map exactly;
- the subtraction at the truth, on chip_smoke's path D data at 32 px
  (C4, 32 images, noise 0.3): the phantom at the true poses, shifts and
  defocus factors, each image's projection at its least-squares scale,
  leaves within TRUTH_TOL of the noise's variance inside the mask radius
  over outside it in both packages (the projection, CTF and shift
  conventions agree with the data's), the two packages' ratios within
  1e-3 of each other, at one scale for all images too.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu import io as jio
from thunder_tpu.config import Para as JPara
from thunder_tpu.core import optimiser as jom
from thunder_tpu.ops import fft as jfft
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch import io as tio
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.ops import fft as tfft

from test_engine import N, _dataset
from test_torch_support import JaxDraws, jax_state, nn, rel_err

torch.set_num_threads(1)

TRUTH_TOL = 0.03


def _l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mask():
    """A soft-edged ball off the box centre."""
    g = np.mgrid[:N, :N, :N].astype(np.float32) - N // 2
    r = np.sqrt(((g - np.array([1.0, 0.0, -1.0])[:, None, None, None]) ** 2)
                .sum(0))
    return np.clip((8.0 - r) / 3.0, 0.0, 1.0).astype(np.float32)


def _para(region):
    return Para(size=N, pixel_size=2.0, k=1, mask_radius=22.0, m_s=128,
                m_l_r=16, m_l_t=4, m_l_d=4, m_reco=4, trans_s=1.5,
                init_res=20.0, global_search_res=6.0, sym="C2",
                save_ref_each_iter=False, save_thu_each_iter=False,
                image_batch=2, seed=3, table_bf16=False, subtract=True,
                region_centre=region, ref_auto_recentre=True)


def _port(para, data, state, key, out):
    vol, imgs, cp = data
    opt = tom.Optimiser(dataclasses.replace(para, output_directory=out),
                        device="cpu")
    opt.set_data(imgs, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    convert.load_state(opt, state)
    opt.draws = JaxDraws(para.seed, state["plane_index"])
    opt.draws.key = key
    return opt


def _jax(para, data, out):
    vol, imgs, cp = data
    jo = jom.Optimiser(JPara(**dataclasses.asdict(
        dataclasses.replace(para, output_directory=out))),
        mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.init_reference(vol)
    jo.init_sigma()
    return jo


def _cold_second_reconstruction(o, cold):
    """Drop the warm C-balance weights after the norm correction that the
    pipeline runs just before its second Nyquist reconstruction."""
    norm_correction = o.norm_correction

    def hook(stats=None):
        fac = norm_correction(stats)
        o._w_warm = cold()
        return fac
    o.norm_correction = hook


@pytest.fixture(scope="module")
def sub(tmp_path_factory):
    """A JAX global round; then ``finalise`` with subtraction in both
    packages from its state, a provided mask set in both."""
    data = _dataset()
    region = str(tmp_path_factory.mktemp("region") / "region.mrc")
    jio.write_mrc(region, _mask() * 2.0, voxel_size=2.0)
    para = _para(region)
    d_jax = str(tmp_path_factory.mktemp("sub_jax"))
    d_port = str(tmp_path_factory.mktemp("sub_port"))
    jo = _jax(para, data, d_jax)
    jo.run_iteration()
    state, key = jax_state(jo), jo.key
    opt = _port(para, data, state, key, d_port)
    # no warm weights: an empty dict in the JAX package, None in the port
    for o, cold in ((jo, dict), (opt, lambda: None)):
        o._w_warm = cold()
        o.set_mask(_mask())
        _cold_second_reconstruction(o, cold)
        o.finalise()
    return dict(para=para, data=data, state=state, key=key, jo=jo, opt=opt,
                d_jax=d_jax, d_port=d_port)


def test_subtracted_stack(sub):
    name = "Subtract_Rank_000000.mrcs"
    a, ha = tio.read_mrc(os.path.join(sub["d_port"], name),
                         return_header=True)
    b, hb = jio.read_mrc(os.path.join(sub["d_jax"], name),
                         return_header=True)
    n_imgs = len(sub["data"][1])
    assert a.shape == b.shape == (2 * n_imgs, N, N)
    assert ha.voxel_size == hb.voxel_size
    assert _l2(a, b) < 1e-3
    assert max(_l2(x, y) for x, y in zip(a, b)) < 2e-3
    np.testing.assert_allclose(sub["opt"].region_centre,
                               sub["jo"].region_centre, rtol=1e-12)


def test_meta_subtract(sub):
    tp = tio.read_thu(os.path.join(sub["d_port"], "Meta_Subtract.thu"))
    tj = jio.read_thu(os.path.join(sub["d_jax"], "Meta_Subtract.thu"))
    n_imgs = len(sub["data"][1])
    assert tp.values.shape == tj.values.shape == (2 * n_imgs, 27)
    assert tp.particle_paths == tj.particle_paths
    assert tp.particle_paths[:3] == [
        "1@Subtract_Rank_000000.mrcs", f"{n_imgs + 1}@Subtract_Rank_000000.mrcs",
        "2@Subtract_Rank_000000.mrcs"]
    assert tp.micrograph_paths == tj.micrograph_paths
    tc = tio.ThuColumns
    trans = [tc.TRANSLATION_X, tc.TRANSLATION_Y]
    other = [c for c in range(27) if c not in trans + [tc.PARTICLE_PATH,
                                                        tc.MICROGRAPH_PATH]]
    np.testing.assert_allclose(tp.values[:, other], tj.values[:, other],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tp.values[:, trans], tj.values[:, trans],
                               atol=1e-3)


def test_final_maps_after_subtraction(sub):
    jo, opt = sub["jo"], sub["opt"]
    for h in (0, 1):
        assert _l2(nn(opt.refs[h, 0]), jo.refs[h, 0]) < 1e-3
    # both halves hold the masked average after the subtraction passes
    np.testing.assert_array_equal(nn(opt.refs[0]), nn(opt.refs[1]))
    assert _l2(nn(opt.joined_maps[0]), jo.joined_maps[0]) < 1e-3
    names = {x for x in os.listdir(sub["d_port"]) if "Final" in x
             or "Subtract" in x}
    assert names == {x for x in os.listdir(sub["d_jax"]) if "Final" in x
                     or "Subtract" in x}
    assert "subtract" in opt.final_timing


@pytest.fixture()
def pair(sub, tmp_path):
    """Both optimisers at the state after the global round, the mask set."""
    para = dataclasses.replace(sub["para"], mask_fsc=True)
    jo = _jax(para, sub["data"], str(tmp_path))
    jo.par = {k: jnp.asarray(v) for k, v in sub["state"]["par"].items()}
    for k in ("refs", "sig", "offsets", "scores", "imgs_ft", "imgs_ft_ori"):
        setattr(jo, k, jnp.asarray(sub["state"][k]))
    jo.fsc, jo.iteration = sub["state"]["fsc"], sub["state"]["iteration"]
    jo.insert_offsets = sub["state"]["insert_offsets"]
    jo.ladder = jom.LadderState(**sub["state"]["ladder"])
    jo.key = sub["key"]
    opt = _port(para, sub["data"], sub["state"], sub["key"], str(tmp_path))
    for o in (jo, opt):
        o.set_mask(_mask())
    return jo, opt


def test_solvent_flatten_with_the_mask(pair):
    jo, opt = pair
    jo.solvent_flatten(True)
    opt.solvent_flatten(True)
    assert rel_err(nn(opt.refs), jo.refs) < 1e-5
    jo.solvent_flatten(False)
    opt.solvent_flatten(False)
    assert rel_err(nn(opt.refs), jo.refs) < 1e-5


def test_golden_fsc_with_the_mask(pair):
    jo, opt = pair
    ft_a = jfft.fft3_center(jo.refs[0, 0])
    ft_b = jfft.fft3_center(jo.refs[1, 0])
    want = np.asarray(jo._golden_fsc(ft_a, ft_b))
    got = nn(opt._golden_fsc(tfft.fft3_center(opt.refs[0, 0]),
                             tfft.fft3_center(opt.refs[1, 0])))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the mask, not the spherical core, was used: the core FSC differs
    opt.mask_vol = None
    core = nn(opt._golden_fsc(tfft.fft3_center(opt.refs[0, 0]),
                              tfft.fft3_center(opt.refs[1, 0])))
    assert np.abs(core - got).max() > 1e-3


def test_auto_recentre_skips_with_a_mask(pair):
    jo, opt = pair
    before_j, before_t = np.asarray(jo.refs), nn(opt.refs)
    jo._auto_recentre_refs()
    opt._auto_recentre_refs()
    np.testing.assert_array_equal(np.asarray(jo.refs), before_j)
    np.testing.assert_array_equal(nn(opt.refs), before_t)
    jo.mask_vol = None
    opt.mask_vol = None
    jo._auto_recentre_refs()
    opt._auto_recentre_refs()
    assert rel_err(nn(opt.refs), jo.refs) < 1e-4
    assert np.abs(nn(opt.refs) - before_t).max() > 0


def test_centroid():
    vol = _mask() * 3.0 - 0.5
    np.testing.assert_array_equal(tom._centroid(vol), jom._centroid(vol))


def _ratios_at_the_truth(opt, as_refs, truth, b, n):
    """(each image at its own scale, one scale) residual ratios of the
    phantom subtracted at the truth by ``opt.save_subtract``: I from a
    zero map, M = I - (I - M) from the phantom at unit scale."""
    import chip_smoke

    subs = []
    for scale in (0.0, 1.0):
        opt.load_poses(truth["q"], truth["tr"], truth["dfac"])
        opt.refs = as_refs(truth["vol"] * scale)
        opt.save_subtract()
        subs.append(chip_smoke.subtracted_stack(
            opt.para.output_directory, b, n)[:b].astype(np.float64))
    img, model = subs[0], subs[0] - subs[1]
    each = np.sum(img * model, axis=(1, 2), keepdims=True) / np.sum(
        model * model, axis=(1, 2), keepdims=True)
    one = np.sum(img * model) / np.sum(model * model)
    r_mask = opt.para.mask_radius_px
    return (chip_smoke.residual_ratio(img - each * model, r_mask),
            chip_smoke.residual_ratio(img - one * model, r_mask))


def test_subtraction_at_the_truth(tmp_path):
    import json

    import chip_smoke
    from thunder_tpu.data import ParticleDataset as JDataset
    from thunder_tpu_torch.config import load_para
    from thunder_tpu_torch.data import ParticleDataset as TDataset

    n, b = 32, 32
    _, truth = chip_smoke.write_cli_dataset(torch.device("cpu"),
                                            str(tmp_path), n, b)
    cfg = chip_smoke.cli_config(str(tmp_path), str(tmp_path / "particles.thu"),
                                str(tmp_path / "out"), subtract=True, n=n)
    (tmp_path / "run.json").write_text(json.dumps(cfg))
    para = load_para(str(tmp_path / "run.json"))
    got = {}
    for name in ("port", "jax"):
        p = dataclasses.replace(para, output_directory=str(tmp_path / name))
        if name == "port":
            opt = tom.Optimiser(p, device="cpu")
            opt.set_data_from_dataset(TDataset(p.db, p.par_prefix,
                                               seed=p.seed))
            as_refs = lambda v: torch.as_tensor(v)[None, None].repeat(
                2, 1, 1, 1, 1)
        else:
            opt = jom.Optimiser(JPara(**dataclasses.asdict(p)),
                                mesh=make_mesh(n_devices=1))
            opt.set_data_from_dataset(JDataset(p.db, p.par_prefix,
                                               seed=p.seed))
            as_refs = lambda v: jnp.stack([jnp.asarray(v)[None]] * 2)
        opt.region_centre = np.zeros(3)
        got[name] = _ratios_at_the_truth(opt, as_refs, truth, b, n)
    for name, (each, _) in got.items():
        assert abs(each - 1.0) < TRUTH_TOL, (name, got)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-3)
