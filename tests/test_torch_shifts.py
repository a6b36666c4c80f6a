"""Stored shifts after a global round in both packages.

Path D (chip_smoke.py) stores shifts that fall short of large true ones: a
least-squares slope of the stored on the true shift of 0.82-1.00 over its
study runs. The resume parity test compares shifts only after a local
round, where both packages store zeros (the re-centring folds them into
the offsets), so it cannot say whether the slope is the port's or the
method's. Here both packages run one global round from one state (the
set-up is deterministic; the port replays the JAX package's draws through
``JaxDraws``) on tests/test_optimiser_e2e.py's drive at n = 32 with true
shifts spread as path D's (N(0, 2 px), "Estimated Translation" 2 px), and
the shifts each package's ``_build_thu_table`` writes are compared with
each other and with the truth.
"""

import dataclasses

import numpy as np
import pytest
import torch

from thunder_tpu.config import Para as JPara
from thunder_tpu.core.optimiser import Optimiser as JOptimiser
from thunder_tpu.io.thu import ThuColumns as JThuColumns
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core.optimiser import Optimiser
from thunder_tpu_torch.io.thu import ThuColumns

from test_optimiser_e2e import _make_dataset
from test_torch_support import JaxDraws

torch.set_num_threads(1)

N = 32
N_IMGS = 48
TRANS_SD = 2.0


def _para():
    return Para(mode="3d", k=1, size=N, pixel_size=1.32,
                mask_radius=N * 1.32 / 2.2, trans_s=TRANS_SD, init_res=6.5,
                global_search_res=3.4, sym="C1", m_s=800, m_l_r=64,
                m_l_t=9, m_reco=8, trans_search_factor=0.25, l_search=True,
                pf=2, seed=5)


def _angles(q_est, q_true):
    dots = np.abs(np.sum(q_est * q_true, axis=1))
    return 2 * np.degrees(np.arccos(np.clip(dots, -1, 1)))


def _slope(got, true):
    """Per axis, the least-squares slope of ``got`` on ``true`` through
    the origin (chip_smoke.shift_readings)."""
    return (got * true).sum(axis=0) / (true * true).sum(axis=0)


@pytest.fixture(scope="module")
def tables():
    vol, imgs, quats, trans, cp = _make_dataset(n=N, n_imgs=N_IMGS,
                                                trans_s=TRANS_SD, seed=7)
    para = _para()
    jo = JOptimiser(JPara(**dataclasses.asdict(para)),
                    mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    jo.run_iteration()
    opt = Optimiser(para, device="cpu",
                    draws=JaxDraws(para.seed, jo.plane_index))
    opt.set_data(imgs, cp)
    opt.init_reference(vol=np.asarray(vol))
    opt.init_sigma()
    opt.run_iteration()
    tj, tp = jo._build_thu_table(), opt._build_thu_table()
    cols = lambda t, c: np.asarray(
        t.values[:, c.TRANSLATION_X:c.TRANSLATION_Y + 1], np.float64)
    quat = lambda t, c: np.asarray(t.values[:, c.QUAT_0:c.QUAT_3 + 1])
    return dict(true=np.asarray(trans, np.float64), q_true=quats,
                jax=cols(tj, JThuColumns), port=cols(tp, ThuColumns),
                q_jax=quat(tj, JThuColumns), q_port=quat(tp, ThuColumns))


def test_stored_shifts_match_jax(tables):
    """Where both packages hold the same top pose (within 1 deg; at least
    75 % of the images, the round-parity share) their stored shifts agree
    to 1e-3 px in the median and 0.1 px at most; over every image the
    median gap is under 0.05 px. (Read: 92 % of the poses the same, gaps
    6.3e-8 px in the median and 0.036 px at most.)"""
    t = tables
    same = _angles(t["q_port"], t["q_jax"]) < 1.0
    assert same.mean() >= 0.75, same.mean()
    gap = np.hypot(*(t["port"] - t["jax"]).T)
    assert np.median(gap[same]) < 1e-3, np.sort(gap[same])
    assert gap[same].max() < 0.1, np.sort(gap[same])
    assert np.median(gap) < 0.05, np.sort(gap)


def test_shift_slope_is_the_methods(tables):
    """Each package's slope of the stored on the true shifts, per axis:
    the port's within 0.02 of the JAX package's, both under 1 (the truth
    spreads as wide as the search's 2 px prior), and the port's median
    error against the truth within 0.05 px of the JAX package's. (Read:
    slopes 0.9325 / 0.9345 in the JAX package, 0.9324 / 0.9349 in the
    port; median errors 0.240 and 0.228 px.)"""
    t = tables
    s_jax, s_port = _slope(t["jax"], t["true"]), _slope(t["port"],
                                                         t["true"])
    np.testing.assert_allclose(s_port, s_jax, atol=0.02)
    err = {k: float(np.median(np.hypot(*(t[k] - t["true"]).T)))
           for k in ("jax", "port")}
    assert err["port"] <= err["jax"] + 0.05, err
    assert (s_jax < 1.0).all() and (s_port < 1.0).all(), (s_jax, s_port)
