"""Port parity: refinement rounds under a general point group (D7: 12 of
its 13 rotations are not grid-exact and are applied by trilinear
gathers).

A global and a local round pinned at R_LOCAL, each from the JAX state
before it with the JAX draws, at the round tests' tolerances (most top
poses within 1 deg, the resolution shell within 1). The symmetrisation
functions themselves are held to the JAX package in
tests/test_torch_symmetry_general.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from thunder_tpu.config import Para as JPara
from thunder_tpu.core.optimiser import Optimiser as JOptimiser
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.core import optimiser as tom

from test_optimiser_e2e import _make_dataset
from test_torch_slice import _angles, _para, _port
from test_torch_support import JaxDraws, jax_state

torch.set_num_threads(1)

R_LOCAL = 12


@pytest.fixture(scope="module")
def d7_path():
    """The JAX package's global round and a local round pinned at
    R_LOCAL at sym="D7", with its state and key before each."""
    data = _make_dataset(n=32, n_imgs=32)
    para = dataclasses.replace(_para(), sym="D7", save_ref_each_iter=False,
                               save_thu_each_iter=False)
    vol, imgs, _, _, cp = data
    jo = JOptimiser(JPara(**dataclasses.asdict(para)),
                    mesh=make_mesh(n_devices=1))
    jo.set_data(imgs, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    states, keys, recs, quats = [], [], [], []
    for rnd in range(2):
        if rnd:
            jo.ladder.search_type = tom.SEARCH_TYPE_LOCAL
            jo.ladder.r = R_LOCAL
            jo.ladder.n_no_decrease = 0
        states.append(jax_state(jo))
        keys.append(jo.key)
        recs.append(jo.run_iteration())
        quats.append(np.asarray(jo.best_quat))
    return dict(data=data, para=para, states=states, keys=keys, recs=recs,
                quats=quats)


@pytest.mark.parametrize("rnd", [0, 1])
def test_d7_round_from_jax_state(d7_path, rnd):
    p = d7_path
    opt = convert.load_state(_port(p["para"], p["data"]), p["states"][rnd])
    opt.draws = JaxDraws(p["para"].seed, p["states"][rnd]["plane_index"])
    opt.draws.key = p["keys"][rnd]
    rec = opt.run_iteration()
    jrec_ = p["recs"][rnd]
    assert rec["search_type"] == jrec_["search_type"]
    assert rec["r"] == jrec_["r"]
    assert abs(rec["res_shell"] - jrec_["res_shell"]) <= 1
    ang = _angles(opt.best_quat, p["quats"][rnd])
    assert np.mean(ang < 1.0) >= 0.75, np.sort(ang)
    assert torch.isfinite(opt.refs).all()
