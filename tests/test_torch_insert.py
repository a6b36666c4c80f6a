"""Port parity: kernel K2's plain version (``insert.insert_update_plain``,
reached through the wrapper ``insert_update`` for CPU tensors) against
the JAX package's ``reference_insert_update`` and the Pallas
``sorted_insert_update`` in interpret mode, at relative error < 1e-5 (the
JAX kernel test's bar: only the f32 summation order differs).

The port's table is channel-minor (strides (1, 24)); the tests build it
from the JAX package's lane-major NumPy table as ``tt(tab0.T.copy()).T``
and compare its (24, R_pad) view with the JAX result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.ops import pallas_insert as jpi
from thunder_tpu_torch.ops import insert as tins

from test_torch_support import nn, rel_err, tt

torch.set_num_threads(1)


def _channel_minor(tab0):
    """Lane-major NumPy (24, R_pad) -> the port's channel-minor table."""
    tab = tt(tab0.T.copy()).T
    assert tins.is_channel_minor(tab)
    return tab


def _samples(rng, n, n_rows):
    return (rng.integers(0, n_rows, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("impl", ["reference", "sorted_interpret"])
def test_plain_insert_matches_jax(impl):
    rng = np.random.default_rng(7)
    n_rows = 9 ** 3 + 1
    r_pad = tins.rows_pad(n_rows)
    assert r_pad == jpi.rows_pad(n_rows)
    idx, fr, fi, tv, frac = _samples(rng, 20_000, n_rows)
    tab0 = rng.normal(size=(24, r_pad)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (tab0, idx, fr, fi, tv, frac)]
    if impl == "reference":
        ref = jpi.reference_insert_update(*jargs)
    else:
        ref = jpi.sorted_insert_update(*jargs, interpret=True)
    got = tins.insert_update(_channel_minor(tab0), tt(idx), tt(fr), tt(fi),
                             tt(tv), tt(frac))
    assert rel_err(nn(got), ref) < 1e-5
    assert tins.LAUNCHES["insert_update"] == 0  # CPU tensors never launch


def test_empty_and_all_dropped():
    rng = np.random.default_rng(8)
    mc = 9
    r_pad = tins.rows_pad(mc ** 3 + 1)
    tab0 = rng.normal(size=(24, r_pad)).astype(np.float32)
    n = 1000
    idx = np.full(n, mc ** 3, np.int32)
    z = np.zeros(n, np.float32)
    frac = np.zeros((n, 3), np.float32)
    ref = jpi.sorted_insert_update(
        jnp.asarray(tab0), jnp.asarray(idx), jnp.asarray(z + 1),
        jnp.asarray(z + 2), jnp.asarray(z + 3), jnp.asarray(frac),
        interpret=True)
    got = nn(tins.insert_update(_channel_minor(tab0), tt(idx), tt(z + 1),
                                tt(z + 2), tt(z + 3), tt(frac)))
    np.testing.assert_array_equal(got[:, :mc ** 3], tab0[:, :mc ** 3])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6)
    empty = nn(tins.insert_update(_channel_minor(tab0), tt(idx[:0]),
                                  tt(z[:0]), tt(z[:0]), tt(z[:0]),
                                  tt(frac[:0])))
    np.testing.assert_array_equal(empty, tab0)
    # rows past the table are dropped, as the JAX scatter drops them
    out = nn(tins.insert_update(_channel_minor(tab0),
                                tt(np.full(4, r_pad + 3, np.int32)),
                                tt(z[:4] + 1), tt(z[:4]), tt(z[:4]),
                                tt(frac[:4])))
    np.testing.assert_array_equal(out, tab0)


def test_insert_wrapper_rejects_bad_inputs():
    tab = tins.new_table(512)
    idx = torch.zeros(3, dtype=torch.int64)
    v = torch.zeros(3)
    with pytest.raises(ValueError):
        tins.insert_update(tab, idx, v, v, v, torch.zeros(3, 3))
    with pytest.raises(ValueError):
        tins.insert_update(torch.zeros(23, 512), idx.int(), v, v, v,
                           torch.zeros(3, 3))


def test_insert_refuses_lane_major_table():
    """One table layout: a contiguous lane-major (24, R_pad) table, or a
    channel-minor one off 16-byte alignment, raises."""
    idx = torch.zeros(3, dtype=torch.int32)
    v = torch.zeros(3)
    frac = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="channel-minor"):
        tins.insert_update(torch.zeros(24, 512), idx, v, v, v, frac)
    flat = torch.zeros(512 * 24 + 1)
    off = flat[1:].view(512, 24).T  # base 4 bytes past alignment
    assert off.stride() == (1, 24)
    with pytest.raises(ValueError, match="channel-minor"):
        tins.insert_update(off, idx, v, v, v, frac)
    tab = tins.new_table(512)
    assert tins.insert_update(tab, idx, v, v, v, frac) is tab


@pytest.mark.cuda
def test_insert_kernel_matches_plain_on_card():
    """Kernel K2 against its plain version on the card (chip_smoke.py
    holds it at the slice's sample count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(9)
    n_rows = 21 ** 3 + 1
    idx, fr, fi, tv, frac = _samples(rng, 200_000, n_rows)
    dev = torch.device("cuda")
    tab0 = tins.new_table(tins.rows_pad(n_rows), device=dev)
    args = [tt(x).to(dev) for x in (idx, fr, fi, tv, frac)]
    ref = tins.insert_update_plain(tab0.T.clone().T, *args)
    got = tins.insert_update(tab0.T.clone().T, *args)
    assert rel_err(nn(got), nn(ref)) < 1e-5


def test_kernel_library_is_keyed_by_its_sources(monkeypatch, tmp_path):
    """The built library's name hashes the CUDA sources and flags, so a
    stale build is never loaded; without nvcc the build raises."""
    from thunder_tpu_torch import cuda_build

    path = cuda_build.library_path()
    assert path.parent == cuda_build.BUILD_DIR
    assert path == cuda_build.library_path()
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ["-DX"])
    assert cuda_build.library_path() != path
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()
