"""Shell statistics: shell sums, FRC/FSC, resolution shell, random-phase
correction (port of ``thunder_tpu.ops.spectrum``; src/Functions/
Spectrum.cpp). Shell index = round(|f|) on CENTERED spectra; sums run over
the full spectrum, so every ratio equals the half-spectrum reference's."""

import torch

from .fft import radius_grid_2d, radius_grid_3d


def _shell_index(n, spatial_dims, device=None):
    r = (radius_grid_2d(n, device) if spatial_dims == 2
         else radius_grid_3d(n, device))
    return torch.round(r).long()


def shell_sum(x, n_shells, spatial_dims):
    """Sum a real array over shells of its centered layout.
    x: (..., n, n[, n]) -> (..., n_shells)."""
    n = x.shape[-1]
    seg = _shell_index(n, spatial_dims, x.device).reshape(-1)
    seg = torch.clamp(seg, max=n_shells)  # out-of-band -> dropped slot
    flat = x.reshape(x.shape[:-spatial_dims] + (-1,))
    out = torch.zeros(flat.shape[:-1] + (n_shells + 1,), dtype=x.dtype,
                      device=x.device)
    out.index_add_(-1, seg, flat)
    return out[..., :n_shells]


def shell_count(n, n_shells, spatial_dims, dtype=torch.float32, device=None):
    ones = torch.ones((n,) * spatial_dims, dtype=dtype, device=device)
    return shell_sum(ones, n_shells, spatial_dims)


def shell_average(x, n_shells, spatial_dims):
    s = shell_sum(x, n_shells, spatial_dims)
    c = shell_count(x.shape[-1], n_shells, spatial_dims, s.dtype, x.device)
    return s / torch.clamp(c, min=1.0)


def power_spectrum(ft, n_shells, spatial_dims):
    """Mean |F|^2 per shell."""
    return shell_average(ft.real ** 2 + ft.imag ** 2, n_shells, spatial_dims)


def frc_fsc(a, b, n_shells, spatial_dims):
    """Fourier ring/shell correlation of two centered spectra."""
    num = shell_sum((a * torch.conj(b)).real, n_shells, spatial_dims)
    pa = shell_sum(a.real ** 2 + a.imag ** 2, n_shells, spatial_dims)
    pb = shell_sum(b.real ** 2 + b.imag ** 2, n_shells, spatial_dims)
    den = torch.sqrt(pa * pb)
    return torch.where(den == 0, torch.zeros_like(num),
                       num / torch.clamp(den, min=1e-30))


def res_p(fsc, thres, pf=1, r_low=1):
    """First shell (from r_low) where ``fsc`` drops below ``thres``, minus
    one, divided by pf (Spectrum.cpp:343-365). Returns a Python int."""
    fsc = torch.as_tensor(fsc)
    n = fsc.shape[-1]
    idx = torch.arange(n, device=fsc.device)
    below = (fsc < thres) & (idx >= r_low)
    hits = torch.nonzero(below)
    result = int(hits[0, 0]) - 1 if hits.shape[0] else n - 1
    return result // pf


def random_phase(ft, r, spatial_dims, phi):
    """Randomise phases above shell r (Spectrum.cpp:365-383), keeping the
    spectrum Hermitian by antisymmetrising the phase field.

    phi: (n,)*spatial_dims uniform draws in [0, 2 pi) from the caller."""
    n = ft.shape[-1]
    u = _shell_index(n, spatial_dims, ft.device)
    flip = phi
    for ax in range(-spatial_dims, 0):
        flip = torch.roll(torch.flip(flip, dims=(ax,)), 1, dims=ax)
    phi = (phi - flip).float()
    rot = torch.complex(torch.cos(phi), torch.sin(phi))
    return torch.where(u > r, ft * rot, ft)


def res_p2a(res_p, size, pixel_size):
    """Shell index -> resolution in angstroms (Spectrum.h resP2A)."""
    return size * pixel_size / max(res_p, 1e-30)


def res_a2p(res_a, size, pixel_size):
    """Resolution in angstroms -> shell index (Spectrum.h resA2P)."""
    return size * pixel_size / res_a


def b_factor_est(ft, size, r_high, r_low):
    """Guinier fit: the slope of log(mean |F| per shell) against
    (shell / size)^2 over shells [r_low, r_high), times 2, the B that
    ``filters.b_factor_filter`` takes (Spectrum.cpp:414-440). Returns a
    float (negative for a decaying spectrum)."""
    spatial_dims = ft.dim()
    amp = shell_average(torch.abs(ft), size // 2, spatial_dims)
    shells = torch.arange(size // 2, device=ft.device)
    w = ((shells >= r_low) & (shells < r_high)).float()
    x = (shells.float() / size) ** 2
    y = torch.log(torch.clamp(amp, min=1e-30))
    sw = torch.sum(w)
    mx = torch.sum(w * x) / sw
    my = torch.sum(w * y) / sw
    slope = torch.sum(w * (x - mx) * (y - my)) / torch.clamp(
        torch.sum(w * (x - mx) ** 2), min=1e-30)
    return float(2 * slope)
