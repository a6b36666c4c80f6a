"""Port parity for a C4 global round: the symmetry path of the slice
(scan over C4's fundamental domain, grid-exact C4 symmetrisation of the
halves) in both packages on the same data.

The data are ``chip_smoke.synthetic_dataset``'s (bench.py's 6-blob phantom
made C4-symmetric, CTF, shifts, noise as a fraction of the clean stack's
std), at a box cut from 160 px with the resolution limits scaled so the
round works in the same frequency band (r = 8 at the start). The port
replays the JAX package's draws (``JaxDraws``): most top poses follow the
JAX ones, the resolution shell matches within 1 and the median pose error
against the ground truth within 3 deg — at the smoke's noise (0.3) and at
bench.py's (1.0).

Run as a script for the same comparison at another size, e.g. the 96 px
study quoted in PERF.md (a fourth argument ``asym`` keeps bench.py's
asymmetric phantom; a fifth, L, adds L local rounds pinned as bench.py
pins them, r = 40 scaled to the box, and prints each round's shells and
pose errors):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_c4_round.py 96 64 1.0
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_c4_round.py 96 128 0.3 sym 4
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from thunder_tpu.config import Para as JPara
from thunder_tpu.core.optimiser import Optimiser as JOptimiser
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core.optimiser import SEARCH_TYPE_LOCAL, Optimiser
from thunder_tpu_torch.geom.symmetry import Symmetry

from test_torch_support import JaxDraws

torch.set_num_threads(1)


def _para(n):
    f = n / 160  # chip_smoke's Para with the band kept in pixels
    return Para(mode="3d", k=1, size=n, pixel_size=1.32,
                mask_radius=75.0 * f, trans_s=2.0, init_res=25.0 * f,
                global_search_res=15.0 * f, sym="C4", m_s=1024, m_l_r=125,
                m_l_t=9, m_l_d=9, m_reco=100, c_search=False, l_search=True,
                pf=2, seed=7, image_batch=64, save_ref_each_iter=False,
                save_thu_each_iter=False)


def _pose_err(q_est, q_true):
    """Angle (deg) from each estimate to the nearest C4 mate g q_true."""
    mates = np.concatenate([[[1.0, 0, 0, 0]], Symmetry("C4").quat])
    best = np.zeros(len(q_est))
    w2, x2, y2, z2 = np.asarray(q_true, np.float64).T
    for w1, x1, y1, z1 in mates:
        gq = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                       w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                       w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)
        best = np.maximum(best, np.abs(np.sum(gq * q_est, 1)))
    return 2 * np.degrees(np.arccos(np.clip(best, -1, 1)))


def c4_rounds(n, b, noise, symmetric=True, n_local=0):
    """One global C4 round of each package on the same data, then
    ``n_local`` pinned local rounds; the port replays the JAX draws.
    Returns the readings of both after the last round, and the resolution
    shells and median pose errors of every round."""
    vol, stack, q_true, cp = chip_smoke.synthetic_dataset(
        torch.device("cpu"), n, b, noise=noise, symmetric=symmetric)
    para = _para(n)
    jo = JOptimiser(JPara(**dataclasses.asdict(para)),
                    mesh=make_mesh(n_devices=1))
    jo.set_data(stack, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    op = Optimiser(para, device="cpu",
                   draws=JaxDraws(para.seed, jo.plane_index))
    op.set_data(stack, cp)
    op.init_reference(vol=vol)
    op.init_sigma()
    rounds = []
    for i in range(1 + n_local):
        for o in (jo, op):
            if i:  # bench.py's pin_local
                o.ladder.search_type = SEARCH_TYPE_LOCAL
                o.ladder.r = int(round(40 * n / 160))
                o.ladder.n_no_decrease = 0
        jrec, rec = jo.run_iteration(), op.run_iteration()
        rounds.append({pkg: (r["res_shell"], round(float(np.median(
            _pose_err(np.asarray(o.best_quat), q_true))), 3))
            for pkg, r, o in (("jax", jrec, jo), ("port", rec, op))})
    q_j, q_t = np.asarray(jo.best_quat), np.asarray(op.best_quat)
    err_j, err_t = _pose_err(q_j, q_true), _pose_err(q_t, q_true)
    follow = 2 * np.degrees(np.arccos(np.clip(
        np.abs(np.sum(q_j * q_t, 1)), -1, 1)))
    return dict(
        shell_jax=jrec["res_shell"], shell_port=rec["res_shell"],
        median_jax=float(np.median(err_j)),
        median_port=float(np.median(err_t)),
        under5_jax=float(np.mean(err_j < 5)),
        under5_port=float(np.mean(err_t < 5)),
        follow=float(np.mean(follow < 1.0)),
        finite=bool(torch.isfinite(op.refs).all()), rounds=rounds)


@pytest.mark.parametrize("noise", [0.3, 1.0])
def test_c4_round_replaying_jax_draws(noise):
    r = c4_rounds(64, 32, noise)
    assert r["finite"]
    # identical draws: most filters follow the JAX ones to the same pose
    # (the C1 slice test's bar); f32 round-off breaks a few ties otherwise
    assert r["follow"] >= 0.75, r
    assert abs(r["shell_port"] - r["shell_jax"]) <= 1, r
    assert abs(r["median_port"] - r["median_jax"]) < 3.0, r


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    n_box, n_img, sd = int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3])
    sym = sys.argv[4:5] != ["asym"]
    n_loc = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    print(dict(box=n_box, particles=n_img, noise=sd, symmetric=sym,
               **c4_rounds(n_box, n_img, sd, sym, n_loc)))
