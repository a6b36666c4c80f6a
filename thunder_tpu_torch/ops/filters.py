"""Fourier-space filters on centered spectra (port of
``thunder_tpu.ops.filters``; src/Functions/Filter.cpp): B-factor
exp(-0.5 B f^2), cosine-edged low- and high-pass, and the FSC weighting
sqrt(2 FSC / (1 + FSC)) (include/Functions/Filter.h:109). Frequencies in
cycles per pixel."""

import math

import torch

from .fft import radius_grid_2d, radius_grid_3d


def _freq_norm(n, spatial_dims, device=None):
    """|f| in cycles per pixel (0 .. ~0.707) of an n^d centered grid."""
    r = (radius_grid_2d(n, device) if spatial_dims == 2
         else radius_grid_3d(n, device))
    return r / n


def b_factor_filter(ft, b_factor, spatial_dims):
    f2 = _freq_norm(ft.shape[-1], spatial_dims, ft.device) ** 2
    return ft * torch.exp(-0.5 * b_factor * f2)


def low_pass_filter(ft, thres, ew, spatial_dims):
    """Cosine-edged low-pass (Filter.cpp:46-93)."""
    f = _freq_norm(ft.shape[-1], spatial_dims, ft.device)
    w = torch.where(f < thres, torch.ones_like(f),
                    torch.where(f > thres + ew, torch.zeros_like(f),
                                torch.cos((f - thres) * math.pi / ew) / 2
                                + 0.5))
    return ft * w


def high_pass_filter(ft, thres, ew, spatial_dims):
    """Cosine-edged high-pass (Filter.cpp:95-135)."""
    f = _freq_norm(ft.shape[-1], spatial_dims, ft.device)
    w = torch.where(f > thres, torch.ones_like(f),
                    torch.where(f < thres - ew, torch.zeros_like(f),
                                torch.cos((thres - f) * math.pi / ew) / 2
                                + 0.5))
    return ft * w


def fsc_weighting_filter(ft, fsc, spatial_dims):
    """Multiply each shell by Cref = sqrt(2 FSC / (1 + FSC)), FSC clamped
    to [0, 1 - 1e-6]; shells past the FSC's end take its last value."""
    from .spectrum import _shell_index

    n = ft.shape[-1]
    fsc = torch.as_tensor(fsc, dtype=torch.float32, device=ft.device)
    u = _shell_index(n, spatial_dims, ft.device)
    fsc_c = torch.clamp(fsc, 0.0, 1.0 - 1e-6)
    cref = torch.sqrt(2 * fsc_c / (1 + fsc_c))
    return ft * cref[torch.clamp(u, max=fsc.shape[-1] - 1)]
