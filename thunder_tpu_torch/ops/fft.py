"""Centered FFT helpers (port of ``thunder_tpu.ops.fft``).

Real space: object centre at index N//2. Fourier space: DC at index N//2
along every axis, signed frequency h at index h + N//2. Inverses normalise
by 1/N^d.
"""

import torch


def fft2_center(x):
    ax = (-2, -1)
    return torch.fft.fftshift(
        torch.fft.fftn(torch.fft.ifftshift(x, dim=ax), dim=ax), dim=ax)


def ifft2_center(x):
    ax = (-2, -1)
    return torch.fft.fftshift(
        torch.fft.ifftn(torch.fft.ifftshift(x, dim=ax), dim=ax), dim=ax)


def fft3_center(x):
    ax = (-3, -2, -1)
    return torch.fft.fftshift(
        torch.fft.fftn(torch.fft.ifftshift(x, dim=ax), dim=ax), dim=ax)


def ifft3_center(x):
    ax = (-3, -2, -1)
    return torch.fft.fftshift(
        torch.fft.ifftn(torch.fft.ifftshift(x, dim=ax), dim=ax), dim=ax)


def freq_grid_2d(n, device=None):
    """Signed integer frequency grids indexed [row, col] = [k, h]:
    returns (col_freq, row_freq), each (n, n) int64."""
    f = torch.arange(n, device=device) - n // 2
    return f[None, :].expand(n, n), f[:, None].expand(n, n)


def freq_grid_3d(n, device=None):
    """(x, y, z) signed frequency grids of an (n, n, n) [z, y, x] array."""
    f = torch.arange(n, device=device) - n // 2
    shape = (n, n, n)
    return (f[None, None, :].expand(shape), f[None, :, None].expand(shape),
            f[:, None, None].expand(shape))


def radius_grid_2d(n, device=None):
    x, y = freq_grid_2d(n, device)
    return torch.sqrt(x.float() ** 2 + y.float() ** 2)


def radius_grid_3d(n, device=None):
    x, y, z = freq_grid_3d(n, device)
    return torch.sqrt(x.float() ** 2 + y.float() ** 2 + z.float() ** 2)


def pad_ft_center(ft, pad, spatial_dims):
    """Zero-pad a centered n^d spectrum to (pad n)^d (the reference's
    PAD_SIZE = pf n, include/Reconstructor.h:57); leading axes are kept."""
    if pad == 1:
        return ft
    n = ft.shape[-1]
    m = n * pad
    lo = m // 2 - n // 2
    return torch.nn.functional.pad(ft, (lo, m - n - lo) * spatial_dims)


def crop_ft_center(ft, out_n, spatial_dims):
    """Crop a centered spectrum to out_n per spatial axis (the inverse of
    ``pad_ft_center`` within the band)."""
    n = ft.shape[-1]
    if out_n == n:
        return ft
    lo = n // 2 - out_n // 2
    idx = ((slice(None),) * (ft.dim() - spatial_dims)
           + (slice(lo, lo + out_n),) * spatial_dims)
    return ft[idx]
