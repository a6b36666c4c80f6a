"""Port parity for the final round and the file output
(src/Optimiser.cpp:4075-4363, 8250-9149) on tests/test_engine.py's drive
(n = 24, 16 particles, C1), K = 1 and K = 2:

- ``finalise()`` from the JAX state after a global round, copied with
  ``thunder_tpu_torch.convert`` and replaying the JAX keys: the Nyquist
  reconstruction without hemisphere averaging (each half map), the joined
  map of each class and the final FSC, with the C-balance started cold in
  both packages (as the slice test compares a reconstruction);
- the files each package writes: the same names, MRC headers equal field
  by field (the data statistics within 1e-4 of the map's scale), .thu text
  columns equal and numeric columns within 1e-4, FSC and class-info
  tables within 1e-3;
- the port's ``write_mrc``/``read_mrc`` and ``write_thu``/``read_thu``
  byte for byte against the JAX package's on the same arrays;
- ``Optimiser.run`` with both save flags on writes every round's set and
  the final set, named as the JAX package names them.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from thunder_tpu import io as jio
from thunder_tpu.config import Para as JPara
from thunder_tpu.core import optimiser as jom
from thunder_tpu.io import thu as jthu
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch import io as tio
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core import optimiser as tom
from thunder_tpu_torch.io import thu as tthu

from test_engine import N, _dataset
from test_torch_support import JaxDraws, jax_state, nn

torch.set_num_threads(1)


def _para(k):
    """tests/test_engine.py's Para, with ``k`` classes."""
    return Para(size=N, pixel_size=2.0, k=k, mask_radius=22.0, m_s=128,
                m_l_r=16, m_l_t=4, m_l_d=4, m_reco=4, trans_s=1.5,
                init_res=20.0, global_search_res=6.0, sym="C1",
                save_ref_each_iter=True, save_thu_each_iter=True,
                image_batch=2, seed=3, table_bf16=False)


def _l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port(para, data, out):
    vol, imgs, cp = data
    opt = tom.Optimiser(dataclasses.replace(para, output_directory=out),
                        device="cpu")
    opt.set_data(imgs, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    return opt


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def final(request, tmp_path_factory):
    """The JAX package: a global round and its files, then ``finalise``;
    the port: ``finalise`` from the state after the JAX round. Each writes
    into its own directory."""
    k = request.param
    data = _dataset()
    vol, imgs, cp = data
    para = _para(k)
    d_jax = str(tmp_path_factory.mktemp(f"jax_k{k}"))
    d_port = str(tmp_path_factory.mktemp(f"port_k{k}"))
    jo = jom.Optimiser(JPara(**dataclasses.asdict(
        dataclasses.replace(para, output_directory=d_jax))),
        mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.init_reference(vol)
    jo.init_sigma()
    jo.run_iteration()
    state, key = jax_state(jo), jo.key
    jo.save_outputs()
    round_names = set(os.listdir(d_jax))
    jo._w_warm = {}
    jo.finalise()
    opt = convert.load_state(_port(para, data, d_port), state)
    opt.draws = JaxDraws(para.seed, state["plane_index"])
    opt.draws.key = key
    opt._w_warm = None
    opt.finalise()
    return dict(k=k, para=para, data=data, jo=jo, opt=opt, d_jax=d_jax,
                d_port=d_port, jax_round_names=round_names)


def test_final_maps_match(final):
    jo, opt = final["jo"], final["opt"]
    assert len(opt.joined_maps) == final["k"]
    for c in range(final["k"]):
        for h in (0, 1):
            assert _l2(nn(opt.half_maps[c][h]), jo.half_maps[c][h]) < 1e-3
            # the final round keeps the halves: refs are the half maps
            assert _l2(nn(opt.refs[h, c]), jo.refs[h, c]) < 1e-3
        assert _l2(nn(opt.joined_maps[c]), jo.joined_maps[c]) < 1e-3
    np.testing.assert_allclose(opt.fsc, np.asarray(jo.fsc), atol=1e-3)


def _final_names(d):
    return {x for x in os.listdir(d) if "Final" in x}


def test_final_file_names(final):
    names = _final_names(final["d_port"])
    assert names == _final_names(final["d_jax"])
    assert {f"Reference_{c:03d}_Final.mrc"
            for c in range(final["k"])} <= names
    assert {"FSC_Final.txt", "Class_Info_Final.txt", "Meta_Final.thu"} <= names


_HDR_INTS = ((0, 4), (28, 3), (64, 3), (92, 1))   # (offset, count) of <i
_HDR_FLOATS = ((40, 3), (52, 3))                  # cell, angles
_HDR_STATS = 76                                   # min, max, mean


def test_final_mrc_headers(final):
    for name in sorted(_final_names(final["d_port"])):
        if not name.endswith(".mrc"):
            continue
        hp = open(os.path.join(final["d_port"], name), "rb").read(1024)
        hj = open(os.path.join(final["d_jax"], name), "rb").read(1024)
        for off, cnt in _HDR_INTS:
            assert (struct.unpack_from(f"<{cnt}i", hp, off)
                    == struct.unpack_from(f"<{cnt}i", hj, off)), (name, off)
        for off, cnt in _HDR_FLOATS:
            assert (struct.unpack_from(f"<{cnt}f", hp, off)
                    == struct.unpack_from(f"<{cnt}f", hj, off)), (name, off)
        assert hp[208:216] == hj[208:216]
        assert hp[96:208] == hj[96:208] and hp[216:] == hj[216:]
        sp = np.array(struct.unpack_from("<3f", hp, _HDR_STATS))
        sj = np.array(struct.unpack_from("<3f", hj, _HDR_STATS))
        scale = np.abs(sj[:2]).max()
        assert np.abs(sp - sj).max() <= 1e-4 * scale, (name, sp, sj)
        vp = tio.read_mrc(os.path.join(final["d_port"], name))
        vj = jio.read_mrc(os.path.join(final["d_jax"], name))
        assert vp.shape == vj.shape == (N, N, N)
        assert _l2(vp, vj) < 1e-3


def _table(path):
    return np.loadtxt(path, ndmin=2)


def test_final_tables_and_thu(final):
    dp, dj = final["d_port"], final["d_jax"]
    for name in ("FSC_Final.txt", "Class_Info_Final.txt"):
        a, b = _table(os.path.join(dp, name)), _table(os.path.join(dj, name))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-3, err_msg=name)
    tp = tio.read_thu(os.path.join(dp, "Meta_Final.thu"))
    tj = jio.read_thu(os.path.join(dj, "Meta_Final.thu"))
    assert tp.particle_paths == tj.particle_paths
    assert tp.micrograph_paths == tj.micrograph_paths
    assert tp.values.shape == tj.values.shape == (len(final["data"][1]), 27)
    num = [i for i in range(27) if i not in (7, 8)]
    np.testing.assert_allclose(tp.values[:, num], tj.values[:, num],
                               atol=1e-4)
    np.testing.assert_allclose(
        tp.values[:, tthu.ThuColumns.DEFOCUS_FACTOR],
        final["opt"].best_defocus, atol=1e-6)


def test_mrc_and_thu_writers_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((5, 6, 7), (6, 8)):
        a = rng.normal(size=shape).astype(np.float32)
        tio.write_mrc(tmp_path / "p.mrc", a, voxel_size=1.32)
        jio.write_mrc(tmp_path / "j.mrc", a, voxel_size=1.32)
        assert (tmp_path / "p.mrc").read_bytes() == \
            (tmp_path / "j.mrc").read_bytes()
        vp, hp = tio.read_mrc(tmp_path / "j.mrc", return_header=True)
        vj, hj = jio.read_mrc(tmp_path / "j.mrc", return_header=True)
        np.testing.assert_array_equal(vp, vj)
        assert dataclasses.asdict(hp) == dataclasses.asdict(hj)
    n = 7
    cols = dict(defocus_u=rng.uniform(1e4, 2e4, n), class_id=np.arange(n),
                quat_0=rng.normal(size=n), score=rng.uniform(size=n))
    paths = [f"{i + 1}@stack.mrcs" for i in range(n)]
    tthu.write_thu(tmp_path / "p.thu", tthu.make_table(n, paths, **cols))
    jthu.write_thu(tmp_path / "j.thu", jthu.make_table(n, paths, **cols))
    assert (tmp_path / "p.thu").read_bytes() == \
        (tmp_path / "j.thu").read_bytes()
    tp, tj = tio.read_thu(tmp_path / "j.thu"), jio.read_thu(tmp_path / "j.thu")
    np.testing.assert_array_equal(tp.values, tj.values)
    assert tp.particle_paths == tj.particle_paths


@pytest.mark.parametrize("final", [1], indirect=True, ids=["k1"])
def test_run_writes_round_and_final_sets(final, tmp_path):
    """``run(max_iter=2)`` with both save flags on writes each round's set
    under the names the JAX package gave its round's files, and the final
    set."""
    opt = _port(final["para"], final["data"], str(tmp_path))
    opt.run(max_iter=2)
    names = set(os.listdir(tmp_path))
    want = set(final["jax_round_names"])
    want |= {x.replace("Round_001", "Round_002") for x in want}
    want |= _final_names(final["d_jax"])
    assert names == want
    t = tio.read_thu(str(tmp_path / "Meta_Round_002.thu"))
    assert t.values.shape == (len(final["data"][1]), 27)


@pytest.mark.parametrize("final", [1], indirect=True, ids=["k1"])
def test_unported_final_options_raise(final, tmp_path):
    """Options once refused now run. A provided mask and a subtraction
    run: ``set_mask`` keeps the volume, and ``run`` ends in the
    subtracted stack (one image per particle under C1) and its table
    (parity in tests/test_torch_subtract.py). The MKB insert: an
    optimiser with ``mkb_kernel`` is built and inserts with the MKB
    kernel in 3D, trilinearly in 2D, as the JAX package's
    (its rounds: tests/test_torch_mkb.py)."""
    para = dataclasses.replace(final["para"], subtract=True,
                               save_ref_each_iter=False,
                               save_thu_each_iter=False)
    opt = _port(para, final["data"], str(tmp_path))
    opt.set_mask(np.ones((N, N, N), np.float32))
    assert tuple(opt.mask_vol.shape) == (N, N, N)
    opt.run(max_iter=1)
    n_imgs = len(final["data"][1])
    stack = tio.read_mrc(str(tmp_path / "Subtract_Rank_000000.mrcs"))
    assert stack.shape == (n_imgs, N, N) and np.isfinite(stack).all()
    assert len(tio.read_thu(str(tmp_path / "Meta_Subtract.thu"))) == n_imgs
    mkb = dataclasses.replace(final["para"], mkb_kernel=True)
    assert tom.Optimiser(mkb, device="cpu")._insert_kernel() == "mkb"
    assert tom.Optimiser(dataclasses.replace(mkb, mode="2d"),
                         device="cpu")._insert_kernel() == "trilinear"
