"""Phase-ramp translations in Fourier space (port of
``thunder_tpu.ops.translate``): shifting by (tx, ty) pixels multiplies the
centered spectrum by exp(-2 pi i (h tx + k ty) / N)."""

import math

import torch


def _cis(phase):
    return torch.complex(torch.cos(phase), torch.sin(phase))


def translation_phase(col, row, tx, ty, n):
    """col/row: (P,) signed integer frequencies; tx/ty: (...,) shifts.
    Returns (..., P) complex64 ramps."""
    col = col.float()
    row = row.float()
    phase = (2 * math.pi / n) * (col * tx[..., None] + row * ty[..., None])
    return _cis(-phase.float())


def translate_ft(ft, tx, ty):
    """Translate centered spectra (..., n, n) by (tx, ty) pixels."""
    from .fft import freq_grid_2d

    n = ft.shape[-1]
    h, k = freq_grid_2d(n, ft.device)
    phase = (2 * math.pi / n) * (h.float() * tx[..., None, None]
                                 + k.float() * ty[..., None, None])
    return ft * _cis(-phase.float())


def translate_ft_3d(ft, tx, ty, tz):
    """Translate centered volume spectra (..., n, n, n) by (tx, ty, tz)
    voxels (the reference's auto-recentring, src/Optimiser.cpp:7425)."""
    from .fft import freq_grid_3d

    n = ft.shape[-1]
    h, k, l = freq_grid_3d(n, ft.device)
    tx, ty, tz = (torch.as_tensor(x, dtype=torch.float32, device=ft.device)
                  [..., None, None, None] for x in (tx, ty, tz))
    phase = (2 * math.pi / n) * (h.float() * tx + k.float() * ty
                                 + l.float() * tz)
    return ft * _cis(-phase.float())
