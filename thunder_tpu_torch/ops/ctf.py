"""Contrast transfer function (port of ``thunder_tpu.ops.ctf``; formulas
of src/CTF.cpp:11-113)."""

import math

import torch


def wavelength(voltage):
    """Electron wavelength in angstroms from voltage in volts."""
    return 12.2643247 / torch.sqrt(voltage * (1 + voltage * 0.978466e-6))


def ctf_1d(f, voltage, defocus, cs, amp_contrast, phase_shift=0.0):
    """Radial CTF at frequencies f (1/angstrom), no astigmatism
    (src/CTF.cpp:11-29); the parameters broadcast against f."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=f.device)
    voltage, defocus, cs, amp_contrast, phase_shift = map(
        t, (voltage, defocus, cs, amp_contrast, phase_shift))
    lam = wavelength(voltage)
    chi = (math.pi * lam * defocus * f ** 2
           + math.pi / 2 * cs * lam ** 3 * f ** 4 - phase_shift)
    return (-torch.sqrt(1 - amp_contrast ** 2) * torch.sin(chi)
            + amp_contrast * torch.cos(chi))


def ctf_pixels(col_freq, row_freq, n, pixel_size, voltage, defocus_u,
               defocus_v, defocus_theta, cs, amp_contrast, phase_shift,
               defocus_factor=1.0):
    """CTF at signed integer frequencies of any shape S.

    CTF parameters are tensors broadcastable against a leading batch B;
    returns (B,) + S. ``defocus_factor`` scales dU/dV."""
    dev = col_freq.device
    extra = col_freq.ndim

    def lift(p):
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        return p[(...,) + (None,) * extra]

    (voltage, defocus_u, defocus_v, defocus_theta, cs, amp_contrast,
     phase_shift, defocus_factor) = map(lift, (
         voltage, defocus_u, defocus_v, defocus_theta, cs, amp_contrast,
         phase_shift, defocus_factor))
    cf = col_freq.float()
    rf = row_freq.float()
    u = torch.sqrt((cf / (pixel_size * n)) ** 2 + (rf / (pixel_size * n)) ** 2)
    angle = torch.atan2(rf, cf) - defocus_theta
    defocus = -(defocus_u + defocus_v
                + (defocus_u - defocus_v) * torch.cos(2 * angle)) / 2 \
        * defocus_factor
    lam = wavelength(voltage)
    w1 = torch.sqrt(1 - amp_contrast ** 2)
    w2 = amp_contrast
    k1 = math.pi * lam
    k2 = math.pi / 2 * cs * lam ** 3
    chi = k1 * defocus * u ** 2 + k2 * u ** 4 - phase_shift
    return -w1 * torch.sin(chi) + w2 * torch.cos(chi)
