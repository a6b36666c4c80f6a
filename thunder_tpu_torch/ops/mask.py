"""Real-space masks (port of ``thunder_tpu.ops.mask``; Mask.cpp): the
soft (cosine-edge) sphere, background estimation and blending, automatic
mask generation and the shell mask.

Mask generation (``gen_mask``, ``auto_mask`` and their steps) runs once
per tool call on the host, with NumPy and SciPy's exact Euclidean
distance transform, as in the JAX package; the other functions take and
return tensors. Arrays are centred: the object at index N//2.
"""

import math

import numpy as np
import torch


def _radius_rl(shape, device=None):
    """Distance from the centre voxel, signed indexing i in [-n/2, n/2)."""
    r2 = 0
    for ax, n in enumerate(shape):
        f = torch.arange(n, dtype=torch.float32, device=device) - n // 2
        s = [1] * len(shape)
        s[ax] = n
        r2 = r2 + f.reshape(s) ** 2
    return torch.sqrt(r2)


def soft_mask_shape(shape, r, ew, device=None):
    """1 inside r, cosine fall-off over ew, 0 outside (Mask.cpp:470-487)."""
    u = _radius_rl(shape, device)
    edge = 0.5 + 0.5 * torch.cos((u - r) / ew * math.pi)
    return torch.where(u > r + ew, torch.zeros_like(u),
                       torch.where(u >= r, edge, torch.ones_like(u))).float()


def background(vol, r, ew):
    """Mean of ``vol`` outside radius r + ew, the cosine edge's voxels
    counted fractionally (Mask.cpp:213-247)."""
    u = _radius_rl(vol.shape, vol.device)
    edge = 0.5 - 0.5 * torch.cos((u - r) / ew * math.pi)
    w = torch.where(u > r + ew, torch.ones_like(u),
                    torch.where(u >= r, edge, torch.zeros_like(u)))
    return torch.sum(w * vol) / torch.clamp(torch.sum(w), min=1e-30)


def soft_mask(vol, r, ew, bg=None):
    """Blend ``vol`` into its background (estimated when ``bg`` is None)
    outside the soft sphere (Mask.cpp:499-521)."""
    if bg is None:
        bg = background(vol, r, ew)
    alpha = soft_mask_shape(vol.shape, r, ew, vol.device)
    return bg * (1 - alpha) + vol * alpha


def apply_soft_mask(vol, alpha, bg=0.0):
    """Generic alpha blend (Mask.cpp:523-544)."""
    return bg * (1 - alpha) + vol * alpha


GEN_MASK_INIT_STEP = 0.2  # include/Functions/Mask.h:31
GEN_MASK_GAP = 0.05       # include/Functions/Mask.h:33


def remove_isolated_points(binary):
    """Zero the 1-voxels without a face-adjacent 1-neighbour
    (removeIsolatedPoint, Mask.cpp:560-586); out-of-bounds neighbours
    count as 0. NumPy in, float32 NumPy out."""
    b = np.asarray(binary) > 0.5
    has = np.zeros_like(b)
    for ax in range(b.ndim):
        lo = [slice(None)] * b.ndim
        hi = [slice(None)] * b.ndim
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        has[tuple(lo)] |= b[tuple(hi)]
        has[tuple(hi)] |= b[tuple(lo)]
    return (b & has).astype(np.float32)


def ext_mask(binary, ext):
    """Extend (ext > 0) or shrink (ext < 0) a binary mask by a Euclidean
    ball of radius |ext|, strict d < |ext| (extMask, Mask.cpp:588-650)."""
    from scipy.ndimage import distance_transform_edt

    b = np.asarray(binary) > 0.5
    if ext > 0:
        return (b | (distance_transform_edt(~b) < ext)).astype(np.float32)
    if ext < 0:
        return (b & (distance_transform_edt(b) >= -ext)).astype(np.float32)
    return b.astype(np.float32)


def soft_edge(binary, ew):
    """Cosine soft edge of width ew: 0.5 + 0.5 cos(d / ew pi) at Euclidean
    distance d < ew from the mask (softEdge, Mask.cpp:652-692)."""
    from scipy.ndimage import distance_transform_edt

    b = np.asarray(binary) > 0.5
    d = distance_transform_edt(~b)
    out = np.where(b, 1.0, np.where(
        d < ew, 0.5 + 0.5 * np.cos(d / max(ew, 1e-6) * np.pi), 0.0))
    return out.astype(np.float32)


def auto_mask_threshold(vol, r):
    """The partial-sum density search (autoMask, Mask.cpp:733-790): sort
    the positive in-sphere densities descending, walk cumulative-mass bins
    of GEN_MASK_GAP from GEN_MASK_INIT_STEP, stop where a bin needs more
    than twice the mean voxel count of the bins before it. Returns the
    threshold density."""
    v = np.asarray(vol)
    u = _radius_rl(v.shape).numpy()
    data = np.sort(np.maximum(v[u < r], 0.0))[::-1].astype(np.float64)
    partial = np.cumsum(data)
    total = partial[-1]
    if total <= 0:
        return 0.0
    start = int(np.searchsorted(partial, total * GEN_MASK_INIT_STEP))
    step = GEN_MASK_INIT_STEP + GEN_MASK_GAP
    n_prev_bin, prev, bin_, thres = 0, 0, 0, 0.0
    for i in range(start, data.size):
        if partial[i] < total * step:
            bin_ += 1
        else:
            if n_prev_bin != 0 and prev * 2 < bin_ * n_prev_bin:
                break
            step += GEN_MASK_GAP
            n_prev_bin += 1
            prev += bin_
            bin_ = 0
            thres = data[i]
    return float(thres)


def gen_mask(vol, thres, ext, ew):
    """genMask (Mask.cpp:694-731): threshold, remove isolated points,
    extend by a Euclidean ball, cosine soft edge. Float32 NumPy in
    [0, 1]."""
    binary = remove_isolated_points(np.asarray(vol) > thres)
    return soft_edge(ext_mask(binary, ext), ew)


def auto_mask(vol, ext, ew, r):
    """autoMask (Mask.cpp:793-811): the threshold search within radius r,
    then ``gen_mask``."""
    return gen_mask(vol, auto_mask_threshold(vol, r), ext, ew)


def shell_mask(shape, inner, outer, ew, device=None):
    """1 between the inner and outer radius, cosine edges of width ew on
    both sides (appsrc/thunder_genmask_shell.cpp:140-200, with the smooth
    0.5 + 0.5 cos profile the JAX package uses in place of the
    reference's clamped one)."""
    u = _radius_rl(shape, device)
    fall_in = 0.5 + 0.5 * torch.cos((inner - u) / ew * math.pi)
    fall_out = 0.5 + 0.5 * torch.cos((u - outer) / ew * math.pi)
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    val = torch.where(
        u < inner - ew, zero,
        torch.where(u < inner, fall_in,
                    torch.where(u < outer, one,
                                torch.where(u < outer + ew, fall_out, zero))))
    return torch.clamp(val, 0.0, 1.0).float()
