"""Gridding-kernel profiles (port of ``thunder_tpu.ops.kernels``;
src/Functions/Functions.cpp with FUNCTIONS_MKB_ORDER_0):

- ``mkb_ft(r, a, alpha)`` = I0(alpha sqrt(1 - (r/a)^2)) / I0(alpha) for
  r <= a, 0 beyond: the blob profile the MKB insert deposits
  (Functions.cpp:105-143);
- ``mkb_rl(r, a, alpha)``: its 3D inverse FT, the C-balance taper of the
  reconstruction and the MKB insert's grid correction;
- ``mkb_blob_vol(a, alpha)``: the blob's volume (Functions.cpp:218-233);
- ``tik_rl(r)`` = sinc^2, the trilinear grid-correction profile.
"""

import math

import torch

from ..geom.directional import bessel_i0


def mkb_ft(r, a, alpha):
    """MKB blob profile (order 0) at distances ``r`` (tensor); 0 past a."""
    u2 = torch.clamp((r / a) ** 2, min=0.0)
    alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=r.device)
    val = bessel_i0(alpha * torch.sqrt(torch.clamp(1 - u2, min=0.0))) \
        / bessel_i0(alpha_t)
    return torch.where(u2 > 1, torch.zeros_like(val), val)


def _bessel_i_3_2(v):
    v = torch.clamp(v, min=1e-6)
    return torch.sqrt(2 / (math.pi * v)) * (torch.cosh(v) - torch.sinh(v) / v)


def _bessel_j_3_2(v):
    v = torch.clamp(v, min=1e-6)
    return torch.sqrt(2 / (math.pi * v)) * (torch.sin(v) / v - torch.cos(v))


def mkb_rl(r, a, alpha):
    """3D inverse FT of the MKB blob (order 0). r: tensor."""
    alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=r.device)
    u = 2 * math.pi * a * r
    inside = u <= alpha_t
    v = torch.sqrt(torch.abs(alpha_t ** 2 - u ** 2))
    w = (2 * math.pi) ** 1.5 * a ** 3 / bessel_i0(alpha_t) \
        / torch.clamp(v, min=1e-6) ** 1.5
    return torch.where(inside, w * _bessel_i_3_2(v), w * _bessel_j_3_2(v))


def _sinc(x):
    small = torch.abs(x) < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def tik_rl(r):
    """sinc^2 grid correction of trilinear interpolation."""
    return _sinc(math.pi * r) ** 2


def mkb_blob_vol(a, alpha):
    """Volume of the 3D MKB blob (order 0): (2 pi / alpha)^{3/2} a^3
    I_{3/2}(alpha) / I0(alpha), a float32 scalar tensor."""
    alpha_t = torch.as_tensor(alpha, dtype=torch.float32)
    return ((2 * math.pi / alpha_t) ** 1.5 * a ** 3
            * _bessel_i_3_2(alpha_t) / bessel_i0(alpha_t))
