"""Port parity: general point-group symmetry (C3, D7, T, I), whose
rotations are not grid-exact and are applied by trilinear gathers.

- ``Symmetry.is_asymmetric`` / ``rot_with_identity`` /
  ``quat_with_identity`` and the ``split_grid_exact`` counts;
- ``reconstructor.symmetrize_cropped`` (band-cropped grid, brick row
  gathers) and ``symmetrize`` (full padded grid) within 1e-5 of the peak;
- ``engine.symmetrize_halves`` with grid-exact and general rotations;
- ``python -m thunder_tpu_torch.cli run --cpu`` on a C3 config to its end:
  the file set, finite poses, a C3-symmetric final map.

A global and a local round at ``sym="D7"`` from the JAX state are in
tests/test_torch_symmetry_rounds.py; ``Optimiser.run`` with the final
round under I, D7, T and the MKB insert is in
tests/test_torch_brick_full.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import map_corr, sym_average
from thunder_tpu.core import reconstructor as jrec
from thunder_tpu.geom.symmetry import Symmetry as JSymmetry
from thunder_tpu.parallel import engine as jeng
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch.cli.main import main as tcli
from thunder_tpu_torch.core import reconstructor as trec
from thunder_tpu_torch.geom.symmetry import Symmetry
from thunder_tpu_torch.io import ThuColumns, read_mrc, read_thu
from thunder_tpu_torch.parallel import engine as teng

from test_torch_dataset_run import B, _config, _write_dataset
from test_torch_support import nn, rel_err, tt

torch.set_num_threads(1)

GROUPS = ("C3", "D7", "T", "I")
# (grid-exact, general) rotations of each group, identity excluded
SPLIT = {"C3": (0, 2), "C4": (3, 0), "D7": (1, 12), "T": (0, 11),
         "O": (23, 0), "I": (1, 58)}


@pytest.mark.parametrize("sym", ["C1", "C3", "D7", "T", "O", "I"])
def test_symmetry_helpers_match(sym):
    t, j = Symmetry(sym), JSymmetry(sym)
    assert t.is_asymmetric() == j.is_asymmetric() == (sym == "C1")
    np.testing.assert_array_equal(t.rot_with_identity(), j.rot_with_identity())
    np.testing.assert_array_equal(t.quat_with_identity(),
                                  j.quat_with_identity())
    assert t.rot_with_identity().shape == (t.n_elements + 1, 3, 3)


@pytest.mark.parametrize("sym", sorted(SPLIT))
def test_split_grid_exact_counts(sym):
    rots = Symmetry(sym).rot
    ex_t, gen_t = trec.split_grid_exact(rots)
    ex_j, gen_j = jrec.split_grid_exact(rots)
    assert (len(ex_t), len(gen_t)) == SPLIT[sym]
    assert ex_t == ex_j
    np.testing.assert_array_equal(gen_t, gen_j)


def _accumulators(seed, mc):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(mc,) * 3) + 1j * rng.normal(size=(mc,) * 3)
    t = rng.uniform(0.5, 1.5, (mc,) * 3)
    return f.astype(np.complex64), t.astype(np.float32)


@pytest.mark.parametrize("sym", GROUPS)
def test_symmetrize_cropped_matches(sym):
    """Every general rotation gathered at the in-band voxels, in slabs of
    z-planes (two slab sizes), within 1e-5 of the JAX package's peak."""
    mc = 29
    f, t = _accumulators(1, mc)
    _, gen = trec.split_grid_exact(Symmetry(sym).rot)
    r_u = (mc // 2 - 2) / 2
    f_j, t_j = jrec.symmetrize_cropped(jnp.asarray(f), jnp.asarray(t),
                                       jnp.asarray(gen), r_u, pf=2)
    for z_chunk in (5, 64):
        f_t, t_t = trec.symmetrize_cropped(tt(f), tt(t), gen, r_u, pf=2,
                                           z_chunk=z_chunk)
        assert rel_err(nn(f_t), f_j) < 1e-5
        assert rel_err(nn(t_t), t_j) < 1e-5
    # out of band: unchanged
    np.testing.assert_array_equal(nn(f_t)[0, 0], f[0, 0])


@pytest.mark.parametrize("sym", GROUPS)
def test_symmetrize_full_grid_matches(sym):
    n, pf = 12, 2
    f, t = _accumulators(2, n * pf)
    rots = Symmetry(sym).rot
    want = jrec.symmetrize({"F": jnp.asarray(f), "T": jnp.asarray(t)},
                           jnp.asarray(rots), n // 2 - 2, pf=pf)
    got = trec.symmetrize({"F": tt(f), "T": tt(t)}, rots, n // 2 - 2, pf=pf)
    assert rel_err(nn(got["F"]), want["F"]) < 1e-5
    assert rel_err(nn(got["T"]), want["T"]) < 1e-5


@pytest.mark.parametrize("sym", ["D7", "I"])
def test_symmetrize_halves_matches(sym):
    """Grid-exact part as transposes, general part gathered from the
    ORIGINAL arrays, added as F_exact + (F_general - F)."""
    mc = 25
    f0, t0 = _accumulators(3, mc)
    f1, t1 = _accumulators(4, mc)
    f, t = np.stack([f0, f1]), np.stack([t0, t1])
    exact, gen = trec.split_grid_exact(Symmetry(sym).rot)
    r_u = (mc // 2 - 2) / 2
    f_j, t_j = jeng.symmetrize_halves(make_mesh(n_devices=1), jnp.asarray(f),
                                      jnp.asarray(t), jnp.asarray(gen),
                                      pf=2, r_u=r_u, exact_ops=exact)
    f_t, t_t = teng.symmetrize_halves(tt(f), tt(t), exact, gen, pf=2,
                                      r_u=r_u)
    assert rel_err(nn(f_t), f_j) < 1e-5
    assert rel_err(nn(t_t), t_j) < 1e-5


def test_cli_run_c3(tmp_path):
    """``cli run --cpu`` with Symmetry C3 (general rotations in every
    round's symmetrisation) to its end: the final file set, finite poses
    for every particle, and a final map equal to its own C3 average
    (correlation > 0.99)."""
    d = _write_dataset(tmp_path)
    cfg = _config(d["dir"], d["dir"] / "out_c3", d["dir"] / "particles.thu",
                  iters=1)
    cfg["Basic"]["Symmetry"] = "C3"
    path = d["dir"] / "c3.json"
    path.write_text(json.dumps(cfg))
    tcli(["--cpu", "run", str(path)])
    out = d["dir"] / "out_c3"
    assert {"Reference_000_Final.mrc", "Meta_Final.thu",
            "thunder.log"} <= {p.name for p in out.iterdir()}
    meta = read_thu(str(out / "Meta_Final.thu"))
    assert len(meta) == B
    q = meta.values[:, ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1]
    assert np.isfinite(q).all()
    vol = torch.as_tensor(read_mrc(str(out / "Reference_000_Final.mrc")))
    assert torch.isfinite(vol).all()
    corr = map_corr(vol, sym_average(vol, Symmetry("C3").rot))
    assert corr > 0.99, corr

