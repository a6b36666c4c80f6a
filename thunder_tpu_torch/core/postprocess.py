"""Half-map postprocessing (port of ``thunder_tpu.core.postprocess``;
src/Postprocess.cpp:50-232, appsrc/thunder_postprocess.cpp):

1. the unmasked and the masked FSC of the two half maps;
2. both halves' phases randomised past the shell where the unmasked FSC
   drops below 0.8, masked, FSC'd again; past that shell + 2 the true FSC
   is (FSC_masked - FSC_rand) / (1 - FSC_rand);
3. the masked halves averaged, weighted by Cref = sqrt(2 FSC / (1 + FSC)),
   sharpened by the Guinier-fitted B-factor, low-passed at the FSC
   threshold's shell and masked.

The random phase fields come from ``phase_fields(seed, n, device)``,
uniform on [0, 2 pi) from a ``torch.Generator`` seeded with ``seed``.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import FSC_CUTOFF, resolve_device
from ..ops import fft as fft_ops
from ..ops import filters, spectrum

RANDOM_PHASE_THRES = 0.8


@dataclass
class PostprocessResult:
    map: np.ndarray  # sharpened, masked merged map
    fsc_unmasked: np.ndarray
    fsc_masked: np.ndarray
    fsc_true: np.ndarray
    res_shell: int
    res_a: float
    b_factor: float


def phase_fields(seed, n, device):
    """Two uniform [0, 2 pi) phase fields (n, n, n), one per half map."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draw = lambda: torch.rand((n, n, n), generator=gen, device=device) \
        * (2 * math.pi)
    return draw(), draw()


def postprocess(half_a, half_b, mask, pixel_size, thres=FSC_CUTOFF, seed=0,
                device=None):
    """half_a, half_b: (n, n, n) real maps; mask: (n, n, n) in [0, 1]
    (arrays or tensors). Runs on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    a, b, m = as_t(half_a), as_t(half_b), as_t(mask)
    n = a.shape[-1]
    fft3, ifft3 = fft_ops.fft3_center, fft_ops.ifft3_center

    ft_a, ft_b = fft3(a), fft3(b)
    fsc_u = spectrum.frc_fsc(ft_a, ft_b, n // 2, 3)
    ft_am, ft_bm = fft3(a * m), fft3(b * m)
    fsc_m = spectrum.frc_fsc(ft_am, ft_bm, n // 2, 3)

    r_rand = spectrum.res_p(fsc_u, RANDOM_PHASE_THRES, r_low=1)
    phi_a, phi_b = phase_fields(seed, n, dev)
    ar = ifft3(spectrum.random_phase(ft_a, r_rand, 3, phi_a)).real * m
    br = ifft3(spectrum.random_phase(ft_b, r_rand, 3, phi_b)).real * m
    fsc_r = spectrum.frc_fsc(fft3(ar), fft3(br), n // 2, 3)

    shells = torch.arange(n // 2, device=dev)
    corrected = (fsc_m - fsc_r) / torch.clamp(1 - fsc_r, min=1e-6)
    fsc_t = torch.where(shells > r_rand + 2, corrected, fsc_m)

    res_shell = spectrum.res_p(fsc_t, thres, r_low=1)
    res_a = float(n * pixel_size / max(res_shell, 1))

    merged = filters.fsc_weighting_filter((ft_am + ft_bm) / 2, fsc_t, 3)
    b_factor = spectrum.b_factor_est(merged, n, max(res_shell, 4),
                                     min(3, res_shell))
    # sharpen inside the low-pass band only: past it the gain
    # exp(-B f^2 / 2) overflows f32 once B < -236.6 (f^2 = 3/4 at the
    # corners), and inf times the band's zero would be NaN (the JAX
    # package's order, ROADMAP Queue 3)
    band = filters.low_pass_filter(merged, res_shell / n, 2.0 / n, 3)
    sharp = torch.where(band != 0, filters.b_factor_filter(band, b_factor, 3),
                        band)
    out = ifft3(sharp).real * m
    host = lambda x: x.detach().cpu().numpy()
    return PostprocessResult(
        map=host(out), fsc_unmasked=host(fsc_u), fsc_masked=host(fsc_m),
        fsc_true=host(fsc_t), res_shell=res_shell, res_a=res_a,
        b_factor=b_factor)
