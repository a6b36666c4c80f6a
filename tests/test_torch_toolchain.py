"""Port parity for the toolchain modules under the command-line tools, on
the same seeded NumPy inputs through the JAX package and the port (CPU):

- ``io.bmp.write_bmp`` and the STAR converters byte for byte;
- the Euler / matrix / axis-angle quaternion functions, ``align_z`` (its
  degenerate branch too), ``reflect3d``, ``swing_twist`` and
  ``sample_unit_sphere_2d`` within 1e-5;
- every mask function: the host ones (threshold search, isolated points,
  extension, soft edge, ``gen_mask``) exactly, the tensor ones within
  1e-6 (``background``, a ratio of two f32 sums over n^3 voxels taken in
  another order, and ``soft_mask`` blending into it, within 1e-4
  relative);
- the filters, ``b_factor_est``, the resolution conversions and the
  spectrum crop / pad within 1e-5 relative;
- ``postprocess`` given the JAX package's random phase fields: FSC curves
  within 1e-4, the resolution shell equal, the B-factor within 1e-3
  relative and the map within 1e-4 relative;
- the interpolation gathers and scatter-adds, ``project_pixels_3d`` and
  the full-grid ``insert_pixels_3d`` within 1e-5 and the JAX package's
  full-grid ``reconstruct`` against ``reconstruct_cropped`` on the whole
  padded grid within 1e-4 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.core import postprocess as jpost
from thunder_tpu.core import projector as jproj
from thunder_tpu.core import reconstructor as jreco
from thunder_tpu.geom import quat as jquat
from thunder_tpu.io import bmp as jbmp
from thunder_tpu.io import star as jstar
from thunder_tpu.io.thu import make_table as jmake_table
from thunder_tpu.io.thu import write_thu as jwrite_thu
from thunder_tpu.ops import fft as jfft
from thunder_tpu.ops import filters as jfilters
from thunder_tpu.ops import interp as jinterp
from thunder_tpu.ops import mask as jmask
from thunder_tpu.ops import spectrum as jspec
from thunder_tpu_torch.core import postprocess as tpost
from thunder_tpu_torch.core import projector as tproj
from thunder_tpu_torch.core import reconstructor as treco
from thunder_tpu_torch.geom import quat as tquat
from thunder_tpu_torch.io import bmp as tbmp
from thunder_tpu_torch.io import star as tstar
from thunder_tpu_torch.ops import fft as tfft
from thunder_tpu_torch.ops import filters as tfilters
from thunder_tpu_torch.ops import interp as tinterp
from thunder_tpu_torch.ops import mask as tmask
from thunder_tpu_torch.ops import spectrum as tspec

from test_torch_support import nn, rel_err, tt

torch.set_num_threads(1)

N = 16
TOL = 1e-5


def _blobs(n, seed=0, k=5):
    """A (n, n, n) map of ``k`` Gaussian blobs at seeded positions."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[:n, :n, :n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(k):
        c = rng.uniform(-n / 5, n / 5, 3)
        s = rng.uniform(n / 16, n / 8)
        vol += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0)
                      / (2 * s * s)).astype(np.float32)
    return vol


def _quats(n, seed=1):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def test_write_bmp_bytes(tmp_path):
    img = np.random.default_rng(0).normal(size=(13, 10)).astype(np.float32)
    jbmp.write_bmp(tmp_path / "j.bmp", img)
    tbmp.write_bmp(tmp_path / "t.bmp", img)
    assert (tmp_path / "j.bmp").read_bytes() == \
        (tmp_path / "t.bmp").read_bytes()


def test_euler_and_matrix_quaternions():
    rng = np.random.default_rng(2)
    phi, theta, psi = (rng.uniform(0, 2 * np.pi, 20).astype(np.float32),
                       rng.uniform(0, np.pi, 20).astype(np.float32),
                       rng.uniform(0, 2 * np.pi, 20).astype(np.float32))
    q = jquat.quat_from_euler(jnp.asarray(phi), jnp.asarray(theta),
                              jnp.asarray(psi))
    np.testing.assert_allclose(
        nn(tquat.quat_from_euler(tt(phi), tt(theta), tt(psi))), q, atol=TOL)
    qs = _quats(20)
    for a, b in zip(tquat.euler_from_quat(tt(qs)),
                    jquat.euler_from_quat(jnp.asarray(qs))):
        np.testing.assert_allclose(nn(a), b, atol=1e-4)
    mats = np.asarray(jquat.rotate3d(jnp.asarray(qs)))
    np.testing.assert_allclose(nn(tquat.quat_from_matrix(tt(mats))),
                               jquat.quat_from_matrix(jnp.asarray(mats)),
                               atol=TOL)
    axis = rng.normal(size=(20, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    np.testing.assert_allclose(
        nn(tquat.quat_from_axis_angle(tt(axis), tt(phi))),
        jquat.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(phi)),
        atol=TOL)
    np.testing.assert_allclose(nn(tquat.direction(tt(phi), tt(theta))),
                               jquat.direction(jnp.asarray(phi),
                                               jnp.asarray(theta)), atol=TOL)


def test_align_z_reflect_swing_twist():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(12, 3)).astype(np.float32)
    v[0] = (1.0, 0.0, 0.0)   # the degenerate branch
    v[1] = (-2.0, 0.0, 0.0)
    np.testing.assert_allclose(nn(tquat.align_z(tt(v))),
                               jquat.align_z(jnp.asarray(v)), atol=TOL)
    np.testing.assert_allclose(nn(tquat.reflect3d(tt(v))),
                               jquat.reflect3d(jnp.asarray(v)), atol=TOL)
    axis = v[2:] / np.linalg.norm(v[2:], axis=1, keepdims=True)
    qs = _quats(10)
    for a, b in zip(tquat.swing_twist(tt(qs), tt(axis)),
                    jquat.swing_twist(jnp.asarray(qs), jnp.asarray(axis))):
        np.testing.assert_allclose(nn(a), b, atol=TOL)
    key = jax.random.PRNGKey(4)
    np.testing.assert_allclose(
        nn(tquat.sample_unit_sphere_2d(tt(jax.random.normal(key, (9, 2))))),
        jquat.sample_unit_sphere_2d(key, 9), atol=TOL)


def _thu(path, n=7):
    rng = np.random.default_rng(5)
    qs = _quats(n, 6)
    t = jmake_table(
        n, particle_paths=[f"{i + 1}@s.mrcs" for i in range(n)],
        micrograph_paths=[f"m{i % 2}.mrc" for i in range(n)],
        voltage=np.full(n, 300e3), defocus_u=rng.uniform(1e4, 2e4, n),
        defocus_v=rng.uniform(1e4, 2e4, n),
        defocus_theta=rng.uniform(0, 1, n), cs=np.full(n, 2.7e7),
        amplitude_contrast=np.full(n, 0.1),
        phase_shift=rng.uniform(0, 0.5, n), coordinate_x=np.arange(n) * 3.0,
        coordinate_y=np.arange(n) * 5.0, group_id=1 + np.arange(n) % 3,
        class_id=np.arange(n) % 2, quat_0=qs[:, 0], quat_1=qs[:, 1],
        quat_2=qs[:, 2], quat_3=qs[:, 3],
        translation_x=rng.normal(size=n), translation_y=rng.normal(size=n))
    jwrite_thu(path, t)


def test_star_round_trip_bytes(tmp_path):
    _thu(tmp_path / "a.thu")
    jstar.thu_to_star(tmp_path / "a.thu", tmp_path / "j.star")
    tstar.thu_to_star(tmp_path / "a.thu", tmp_path / "t.star")
    assert (tmp_path / "j.star").read_bytes() == \
        (tmp_path / "t.star").read_bytes()
    assert tstar.read_star(tmp_path / "j.star") == \
        jstar.read_star(tmp_path / "j.star")
    jt = jstar.star_to_thu(tmp_path / "j.star", tmp_path / "j.thu")
    tt_ = tstar.star_to_thu(tmp_path / "j.star", tmp_path / "t.thu")
    assert (tmp_path / "j.thu").read_bytes() == \
        (tmp_path / "t.thu").read_bytes()
    np.testing.assert_array_equal(tt_.values, jt.values)
    for q in _quats(5, 8):
        np.testing.assert_allclose(tstar._quat_to_relion_euler(q),
                                   jstar._quat_to_relion_euler(q))


def test_host_mask_generation():
    vol = _blobs(N)
    vol += np.random.default_rng(9).normal(0, 0.02, vol.shape).astype(
        np.float32)
    thres = tmask.auto_mask_threshold(vol, N / 2)
    assert thres == jmask.auto_mask_threshold(vol, N / 2) and thres > 0
    binary = vol > thres
    np.testing.assert_array_equal(tmask.remove_isolated_points(binary),
                                  jmask.remove_isolated_points(binary))
    for ext in (2.5, 0, -1.5):
        np.testing.assert_array_equal(tmask.ext_mask(binary, ext),
                                      jmask.ext_mask(binary, ext))
    np.testing.assert_array_equal(tmask.soft_edge(binary, 3.0),
                                  jmask.soft_edge(binary, 3.0))
    np.testing.assert_array_equal(tmask.gen_mask(vol, thres, 2, 3),
                                  jmask.gen_mask(vol, thres, 2, 3))
    np.testing.assert_array_equal(tmask.auto_mask(vol, 2, 3, N / 2),
                                  jmask.auto_mask(vol, 2, 3, N / 2))


def test_tensor_masks():
    vol = _blobs(N) + 0.3
    np.testing.assert_allclose(float(tmask.background(tt(vol), 5.0, 2.0)),
                               float(jmask.background(jnp.asarray(vol), 5.0,
                                                      2.0)), rtol=1e-4)
    # the blend takes the estimated background and its 1e-4 with it
    np.testing.assert_allclose(nn(tmask.soft_mask(tt(vol), 5.0, 2.0)),
                               jmask.soft_mask(jnp.asarray(vol), 5.0, 2.0),
                               rtol=1e-4)
    alpha = np.asarray(jmask.soft_mask_shape((N, N, N), 4.0, 3.0))
    np.testing.assert_allclose(
        nn(tmask.apply_soft_mask(tt(vol), tt(alpha), 0.2)),
        jmask.apply_soft_mask(jnp.asarray(vol), jnp.asarray(alpha), 0.2),
        atol=1e-6)
    for shape in ((N, N, N), (N, N)):
        np.testing.assert_allclose(nn(tmask.shell_mask(shape, 3.0, 6.5, 2.0)),
                                   jmask.shell_mask(shape, 3.0, 6.5, 2.0),
                                   atol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
def test_filters_and_spectrum(dims):
    rng = np.random.default_rng(10 + dims)
    x = rng.normal(size=(N,) * dims).astype(np.float32)
    jft = (jfft.fft3_center if dims == 3 else jfft.fft2_center)(
        jnp.asarray(x))
    ft = tt(np.asarray(jft))
    fsc = np.linspace(1.0, -0.1, N // 2 - 2).astype(np.float32)
    pairs = [
        (tfilters.b_factor_filter(ft, 40.0, dims),
         jfilters.b_factor_filter(jft, 40.0, dims)),
        (tfilters.low_pass_filter(ft, 0.2, 0.05, dims),
         jfilters.low_pass_filter(jft, 0.2, 0.05, dims)),
        (tfilters.high_pass_filter(ft, 0.2, 0.05, dims),
         jfilters.high_pass_filter(jft, 0.2, 0.05, dims)),
        (tfilters.fsc_weighting_filter(ft, tt(fsc), dims),
         jfilters.fsc_weighting_filter(jft, jnp.asarray(fsc), dims)),
        (tfft.crop_ft_center(ft, 10, dims), jfft.crop_ft_center(jft, 10, dims)),
        (tfft.pad_ft_center(ft, 2, dims), jfft.pad_ft_center(jft, 2, dims)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert rel_err(nn(got), want) < TOL
    if dims == 3:
        decay = tfilters.b_factor_filter(ft, 300.0, 3)
        b_t = tspec.b_factor_est(decay, N, 7, 2)
        b_j = float(jspec.b_factor_est(jfilters.b_factor_filter(
            jft, 300.0, 3), N, 7, 2))
        assert abs(b_t - b_j) <= 1e-4 * abs(b_j)
    assert tspec.res_p2a(5, N, 1.3) == pytest.approx(
        float(jspec.res_p2a(5, N, 1.3)))
    assert tspec.res_a2p(4.16, N, 1.3) == pytest.approx(
        float(jspec.res_a2p(4.16, N, 1.3)))


def test_postprocess_with_the_jax_phases(monkeypatch):
    n = N
    vol = _blobs(n, seed=11)
    rng = np.random.default_rng(12)
    half_a = vol + rng.normal(0, 0.05, vol.shape).astype(np.float32)
    half_b = vol + rng.normal(0, 0.05, vol.shape).astype(np.float32)
    mask = np.asarray(jmask.soft_mask_shape((n, n, n), n * 0.4, 2.0))
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    phases = [tt(jax.random.uniform(k, (n, n, n), minval=0.0,
                                    maxval=2 * jnp.pi, dtype=jnp.float32))
              for k in (ka, kb)]
    monkeypatch.setattr(tpost, "phase_fields", lambda seed, n, dev: phases)
    got = tpost.postprocess(half_a, half_b, mask, 1.5, device="cpu")
    want = jpost.postprocess(half_a, half_b, mask, 1.5)
    for key in ("fsc_unmasked", "fsc_masked", "fsc_true"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   atol=1e-4)
    assert got.res_shell == want.res_shell
    assert got.res_a == pytest.approx(want.res_a)
    assert abs(got.b_factor - want.b_factor) <= 1e-3 * abs(want.b_factor)
    assert rel_err(got.map, want.map) < 1e-4


def test_postprocess_steep_b_factor(monkeypatch):
    """A B-factor below -236.6 (a narrow Gaussian: B = -242): the gain
    exp(-B f^2 / 2) overflows f32 at the box's corners, where the JAX
    package's order (sharpen, then low-pass) makes the map NaN. The port
    sharpens inside the band only; it matches the JAX package's pipeline
    with the gain applied in f64 (NumPy, no overflow), within 5e-3: the
    gain (~1e4 at the band's edge) lifts the two FFT implementations' f32
    round-off, ~1e-7 of the DC term, to ~2e-3 of the sharpened map."""
    n = 32
    g = np.mgrid[:n, :n, :n].astype(np.float32) - n // 2
    vol = np.exp(-(g ** 2).sum(0) / (2 * 2.5 ** 2)).astype(np.float32)
    rng = np.random.default_rng(14)
    half_a = vol + rng.normal(0, 1e-4, vol.shape).astype(np.float32)
    half_b = vol + rng.normal(0, 1e-4, vol.shape).astype(np.float32)
    mask = np.ones_like(vol)
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    phases = [jax.random.uniform(k, (n, n, n), minval=0.0, maxval=2 * jnp.pi,
                                 dtype=jnp.float32) for k in (ka, kb)]
    monkeypatch.setattr(tpost, "phase_fields",
                        lambda seed, n, dev: [tt(p) for p in phases])
    assert not np.isfinite(jpost.postprocess(half_a, half_b, mask,
                                             1.0).map).all()

    def gain_f64(ft, b_factor, dims):
        f2 = np.asarray(jfilters._freq_norm(ft.shape[-1], dims),
                        np.float64) ** 2
        return jnp.asarray((np.asarray(ft).astype(np.complex128) * np.exp(
            -0.5 * float(b_factor) * f2)).astype(np.complex64))

    monkeypatch.setattr(jfilters, "b_factor_filter", gain_f64)
    got = tpost.postprocess(half_a, half_b, mask, 1.0, device="cpu")
    want = jpost.postprocess(half_a, half_b, mask, 1.0)
    assert got.b_factor < -236.6 and got.res_shell == want.res_shell
    assert np.isfinite(got.map).all()
    assert rel_err(got.map, want.map) < 5e-3


def test_postprocess_default_phases_are_seeded():
    """Without injected phases the fields come from the seed: two calls
    agree, and the result has the JAX package's layout."""
    vol = _blobs(N, seed=13)
    a = tpost.postprocess(vol, vol * 0.9, np.ones_like(vol), 1.0,
                          device="cpu")
    b = tpost.postprocess(vol, vol * 0.9, np.ones_like(vol), 1.0,
                          device="cpu")
    np.testing.assert_array_equal(a.map, b.map)
    assert a.fsc_true.shape == (N // 2,) and a.map.shape == (N, N, N)


@pytest.mark.parametrize("dims", [2, 3])
def test_interp(dims):
    rng = np.random.default_rng(20 + dims)
    grid = (rng.normal(size=(N,) * dims)
            + 1j * rng.normal(size=(N,) * dims)).astype(np.complex64)
    coords = rng.uniform(-N / 2 - 1, N / 2 + 1, (40, dims)).astype(np.float32)
    jg, jc = jnp.asarray(grid), jnp.asarray(coords)
    assert rel_err(nn(tinterp.linear_gather(tt(grid), tt(coords))),
                   jinterp.linear_gather(jg, jc)) < TOL
    np.testing.assert_array_equal(
        nn(tinterp.nearest_gather(tt(grid), tt(coords))),
        jinterp.nearest_gather(jg, jc))
    vals = (rng.normal(size=40) + 1j * rng.normal(size=40)).astype(
        np.complex64)
    assert rel_err(nn(tinterp.linear_scatter_add(tt(grid), tt(coords),
                                                 tt(vals))),
                   jinterp.linear_scatter_add(jg, jc, jnp.asarray(vals))) < TOL
    real = grid.real.copy()
    assert rel_err(
        nn(tinterp.linear_scatter_add(tt(real), tt(coords), tt(vals.real))),
        jinterp.linear_scatter_add(jnp.asarray(real), jc,
                                   jnp.asarray(vals.real))) < TOL


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_project_pixels_3d(interp):
    vol = _blobs(N, seed=14)
    qs = _quats(6, 15)
    rots = np.asarray(jquat.rotate3d(jnp.asarray(qs)))
    f = np.arange(N) - N // 2
    col = np.repeat(f, N).astype(np.float32)
    row = np.tile(f, N).astype(np.float32)
    jvf = jproj.build_projectee_3d(jnp.asarray(vol), pf=2)
    want = jproj.project_pixels_3d(jvf, jnp.asarray(rots), jnp.asarray(col),
                                   jnp.asarray(row), pf=2, interp=interp)
    args = (tt(rots), tt(col), tt(row))
    if interp == "linear":
        got = tproj.project_pixels_3d(tt(np.asarray(jvf)), *args, pf=2)
    else:
        # the port projects trilinearly only; its nearest gather at the
        # slice coordinates is the JAX package's nearest projection
        got = tinterp.nearest_gather(tt(np.asarray(jvf)),
                                     tproj.slice_coords_3d(*args, pf=2))
    assert rel_err(nn(got), want) < TOL


def test_full_grid_insert_and_reconstruct():
    n, b = N, 12
    rng = np.random.default_rng(16)
    qs = _quats(b, 17)
    rots = np.asarray(jquat.rotate3d(jnp.asarray(qs)))
    f = np.arange(n // 2 - 1)
    col = np.repeat(f, n - 2).astype(np.int32)
    row = np.tile(np.arange(-(n // 2) + 1, n // 2 - 1), len(f)).astype(
        np.int32)
    p = col.size
    vals = (rng.normal(size=(b, p)) + 1j * rng.normal(size=(b, p))).astype(
        np.complex64)
    ctf = rng.uniform(0.2, 1.0, (b, p)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, b).astype(np.float32)
    pmask = (rng.uniform(size=p) > 0.1).astype(np.float32)
    js = jreco.insert_pixels_3d(
        jreco.empty_state(n, pf=2), jnp.asarray(vals), jnp.asarray(ctf),
        jnp.asarray(rots), jnp.asarray(col), jnp.asarray(row), jnp.asarray(w),
        pf=2, pixel_mask=jnp.asarray(pmask))
    ts = treco.insert_pixels_3d(
        treco.empty_state(n, pf=2, device="cpu"), tt(vals), tt(ctf),
        tt(rots), tt(col).long(), tt(row).long(), tt(w), pf=2,
        pixel_mask=tt(pmask))
    assert rel_err(nn(ts["F"]), js["F"]) < TOL
    assert rel_err(nn(ts["T"]), js["T"]) < TOL
    tx, ty = rng.normal(size=b).astype(np.float32), rng.normal(
        size=b).astype(np.float32)
    jo = jreco.insert_offsets(js, jnp.asarray(tx), jnp.asarray(ty),
                              jnp.asarray(w))
    to = treco.insert_offsets(ts, tt(tx), tt(ty), tt(w))
    for key in ("ox", "oy", "counter"):
        assert float(to[key]) == pytest.approx(float(jo[key]), rel=1e-6)
    fsc = np.linspace(0.99, 0.3, n // 2).astype(np.float32)
    want = jreco.reconstruct(js["F"], js["T"], jnp.asarray(fsc), n, pf=2,
                             max_radius=n // 2 - 2)
    got = treco.reconstruct_cropped(
        tt(np.asarray(js["F"])), tt(np.asarray(js["T"])), tt(fsc), n, pf=2,
        max_radius=n // 2 - 2)
    assert got.shape == (n, n, n)
    assert rel_err(nn(got), want) < 1e-4
    assert math.isfinite(float(got.abs().max()))
