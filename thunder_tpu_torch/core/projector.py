"""Fourier-slice projection (port of ``thunder_tpu.core.projector``;
src/Projector.cpp:97-356).

- ``build_projectee_3d``: zero-pad the real-space volume by pf, divide by
  the trilinear grid-correction taper, centered FFT;
- ``build_brick_projectee_3d``: crop that spectrum to the band and pack it
  into the brick gather table: full-space, or the Hermitian half-space
  with ``half=True`` (the refinement rounds' layout);
- ``project_brick_3d``: one row fetch + 8-wide dot per sample, from
  either layout;
- ``project_pixels_3d`` / ``project_pixels_2d``: ring pixels of central
  slices (in-plane rotations) of a full padded spectrum, trilinear (the
  tools and the subtraction pipeline);
- ``project_full_3d``: full n x n central slices (data synthesis, tools);
- the 2D counterparts of the first three (2D classification: a class
  average is rotated in plane, ``slice_coords_2d``).

Outputs are in IMAGE frequency units (cycles per n-box).
"""

import torch

from ..ops import brick
from ..ops.fft import fft2_center, fft3_center
from ..ops.interp import linear_gather
from ..ops.kernels import tik_rl


def _pad_rl(vol, pf, dims=3):
    """Zero-pad the last ``dims`` axes to pf x n, object centre at
    (pf n)//2; leading (class) axes are untouched."""
    n = vol.shape[-1]
    m = n * pf
    lo = m // 2 - n // 2
    hi = m - n - lo
    return torch.nn.functional.pad(vol, (lo, hi) * dims)


def _grid_correct_rl(vol, dims=3):
    n_pad = vol.shape[-1]
    r2 = 0
    for ax in range(dims):
        f = torch.arange(n_pad, dtype=torch.float32, device=vol.device) \
            - n_pad // 2
        s = [1] * dims
        s[ax] = n_pad
        r2 = r2 + f.reshape(s) ** 2
    return vol / tik_rl(torch.sqrt(r2) / n_pad)


def build_projectee_3d(vol_rl, pf=2, grid_correct=True):
    """Real-space volume (..., n, n, n) -> padded centered spectrum."""
    padded = _pad_rl(vol_rl, pf)
    if grid_correct:
        padded = _grid_correct_rl(padded)
    return fft3_center(padded)


def build_brick_projectee_3d(vol_rl, r_max, pf=2, grid_correct=True,
                             dtype=torch.float32, half=False):
    """Real-space volume (n, n, n) -> band-cropped brick table covering
    |k| <= r_max * pf: (mc, mc, mc, C) full-space, or the Hermitian
    half-space (mc//2 + 1, mc, mc, C) with ``half=True``."""
    ft = build_projectee_3d(vol_rl, pf=pf, grid_correct=grid_correct)
    mc = brick.crop_size(r_max, pf)
    crop = brick.crop_center_ft(ft, mc)
    if half:
        return brick.pack_vol3_half(crop, dtype=dtype)
    return brick.pack_vol3(crop, dtype=dtype)


def build_projectee_2d(img_rl, pf=2, grid_correct=True):
    """Real-space images (..., n, n) -> padded centered spectra."""
    padded = _pad_rl(img_rl, pf, dims=2)
    if grid_correct:
        padded = _grid_correct_rl(padded, dims=2)
    return fft2_center(padded)


def build_brick_projectee_2d(img_rl, r_max, pf=2, grid_correct=True,
                             dtype=torch.float32):
    """Real-space images (..., n, n) -> band-cropped bilinear brick tables
    (..., mc, mc, C) covering |k| <= r_max * pf."""
    ft = build_projectee_2d(img_rl, pf=pf, grid_correct=grid_correct)
    mc = brick.crop_size(r_max, pf)
    lo = ft.shape[-1] // 2 - mc // 2
    return brick.pack_vol2(ft[..., lo:lo + mc, lo:lo + mc], dtype=dtype)


def slice_coords_2d(rot, col, row, pf=2):
    """In-plane rotated ring coordinates in array (y, x) order.
    rot: (..., 2, 2); col/row: (P,) -> (..., P, 2) float32."""
    plane = torch.stack([col.float() * pf, row.float() * pf], dim=-1)
    coords = torch.einsum("...ij,pj->...pi", rot.float(), plane)
    return torch.flip(coords, dims=(-1,))


def project_brick_2d(tab, rot, col, row, pf=2):
    """Ring pixels of a class average rotated in plane, through its
    ``build_brick_projectee_2d`` table."""
    return brick.gather_vol2(tab, slice_coords_2d(rot, col, row, pf=pf))


def slice_coords_3d(rot, col, row, pf=2):
    """Rotated central-slice coordinates in array (z, y, x) order.
    rot: (..., 3, 3); col/row: (P,) -> (..., P, 3) float32."""
    plane = torch.stack([col.float() * pf, row.float() * pf,
                         torch.zeros_like(col, dtype=torch.float32)], dim=-1)
    coords = torch.einsum("...ij,pj->...pi", rot.float(), plane)
    return torch.flip(coords, dims=(-1,))


def project_brick_3d(tab, rot, col, row, pf=2):
    """Central-slice projection through a brick table: full-space
    (``brick.gather_vol3``) or Hermitian half-space, whose z axis is
    shorter than y and x (the conjugate-mirror fetch)."""
    coords = slice_coords_3d(rot, col, row, pf=pf)
    if tab.shape[0] != tab.shape[1]:
        return brick.gather_vol3_half(tab, coords)
    return brick.gather_vol3(tab, coords)


def project_pixels_3d(vol_ft, rot, col, row, pf=2):
    """Central-slice projection at ring pixels of a padded centered
    spectrum (m, m, m) (src/Projector.cpp:222-260): rot (..., 3, 3),
    col/row (P,) signed image frequencies -> (..., P) complex, trilinear
    (the JAX package's ``interp="linear"``; nothing calls its nearest
    mode)."""
    return linear_gather(vol_ft, slice_coords_3d(rot, col, row, pf=pf))


def project_pixels_2d(img_ft, rot, col, row, pf=2):
    """In-plane projection: ring pixels of a padded centered 2D spectrum
    (m, m) rotated by rot (..., 2, 2) -> (..., P) complex, bilinear."""
    return linear_gather(img_ft, slice_coords_2d(rot, col, row, pf=pf))


def project_full_3d(vol_ft, rot, n, max_radius, pf=2):
    """Project a padded centered spectrum (m, m, m) onto full centered
    n x n image spectra at rotations rot (..., 3, 3); zero beyond
    ``max_radius``."""
    f = torch.arange(n, dtype=torch.float32, device=vol_ft.device) - n // 2
    colg = f[None, :].expand(n, n).reshape(-1)
    rowg = f[:, None].expand(n, n).reshape(-1)
    vals = project_pixels_3d(vol_ft, rot, colg, rowg, pf).reshape(
        rot.shape[:-2] + (n, n))
    r2 = (colg ** 2 + rowg ** 2).reshape(n, n)
    return torch.where(r2 < float(max_radius) ** 2, vals,
                       torch.zeros_like(vals))
