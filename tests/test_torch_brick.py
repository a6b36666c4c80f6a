"""Port parity: brick tables (pack, bf16 pair packing, half-space gather,
lane-major fold)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.ops import brick as jbrick
from thunder_tpu.ops import pallas_insert as jpi
from thunder_tpu_torch.ops import brick as tbrick
from thunder_tpu_torch.ops import insert as tinsert

from test_torch_support import nn, tt

torch.set_num_threads(1)


def _spectrum(rng, mc):
    x = (rng.normal(size=(mc, mc, mc)) + 1j * rng.normal(size=(mc, mc, mc)))
    return x.astype(np.complex64)


def test_crop_sizes_and_embed():
    for r, pf in ((8, 2), (40, 2), (14, 1)):
        assert tbrick.crop_size(r, pf) == jbrick.crop_size(r, pf)
    rng = np.random.default_rng(0)
    ft = _spectrum(rng, 20)
    np.testing.assert_array_equal(
        nn(tbrick.crop_center_ft(tt(ft), 11)),
        np.asarray(jbrick.crop_center_ft(jnp.asarray(ft), 11)))
    small = _spectrum(rng, 9)
    np.testing.assert_array_equal(
        nn(tbrick.embed_center_ft(tt(small), 16)),
        np.asarray(jbrick.embed_center_ft(jnp.asarray(small), 16)))


@pytest.mark.parametrize("bf16", [False, True])
def test_pack_tables_bit_identical(bf16):
    rng = np.random.default_rng(1)
    ft = _spectrum(rng, 9)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    ref = np.asarray(jbrick.pack_vol3(jnp.asarray(ft), dtype=jdt))
    got = nn(tbrick.pack_vol3(tt(ft), dtype=tdt))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    ref_h = np.asarray(jbrick.pack_vol3_half(jnp.asarray(ft), dtype=jdt))
    got_h = nn(tbrick.pack_vol3_half(tt(ft), dtype=tdt))
    assert got_h.shape == ref_h.shape == (5, 9, 9, 8 if bf16 else 16)
    np.testing.assert_array_equal(got_h.view(np.uint32),
                                  ref_h.view(np.uint32))
    if bf16:
        rr, ri = tbrick.unpack_pair_rows(tt(ref))
        jr, ji = jbrick.unpack_pair_rows(jnp.asarray(ref))
        np.testing.assert_array_equal(nn(rr), np.asarray(jr))
        np.testing.assert_array_equal(nn(ri), np.asarray(ji))


@pytest.mark.parametrize("bf16", [False, True])
def test_half_gather_matches(bf16):
    rng = np.random.default_rng(2)
    mc = 17
    ft = _spectrum(rng, mc)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    v = rng.normal(size=(300, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    coords = (v * (mc // 2 - 2) * rng.uniform(0, 1, (300, 1))).astype(
        np.float32)
    ref = jbrick.gather_vol3_half(
        jbrick.pack_vol3_half(jnp.asarray(ft), dtype=jdt),
        jnp.asarray(coords))
    got = tbrick.gather_vol3_half(tbrick.pack_vol3_half(tt(ft), dtype=tdt),
                                  tt(coords))
    np.testing.assert_allclose(nn(got), np.asarray(ref), atol=1e-5)
    assert coords[:, 0].min() < 0  # the mirrored branch is exercised


def test_fold_lane_matches():
    rng = np.random.default_rng(3)
    mc = 7
    lane = rng.normal(size=(24, tinsert.rows_pad(mc ** 3 + 1))).astype(
        np.float32)
    assert lane.shape[1] == jpi.rows_pad(mc ** 3 + 1)
    f_r, t_r = jbrick.fold_insert3_lane(jnp.asarray(lane), mc)
    # the port's accumulator is channel-minor: the same (24, R_pad) view
    f_g, t_g = tbrick.fold_insert3_lane(tt(lane.T.copy()).T, mc)
    np.testing.assert_allclose(nn(f_g), np.asarray(f_r), atol=1e-5)
    np.testing.assert_allclose(nn(t_g), np.asarray(t_r), atol=1e-5)
