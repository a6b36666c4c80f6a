"""Reconstruction from the folded insert: grid-exact symmetrisation and
Wiener-FSC / C-balance inversion (port of the cropped-grid path of
``thunder_tpu.core.reconstructor``; src/Reconstructor.cpp).

Contract (the reference's active config, include/Config.h:95-117):
normalise F and T by T's DC; Wiener MAP T /= clamp(FSC, 1e-3, 1-1e-3) for
shells in [5 pf, maxR pf); C-balance W <- W / |FT(IFT(T W) taper)| until
max||C|-1| < 1e-2 or no decrease (<= 30 iterations); F *= W; zero-embed
into the padded grid, inverse FFT, extract the n-box, divide by the
trilinear grid-correction profile. ``dims = 2`` runs the same contract on
2D class averages (2D classification).

The full-grid path of the tools (``thunder_tpu_torch.cli``'s
``reconstruct`` and the like): ``empty_state`` holds padded (F, T)
accumulators and the re-centring offsets, ``insert_pixels_3d`` scatters
pose-weighted ring pixels and their Hermitian mirrors into them with
``ops.interp.linear_scatter_add``, and ``reconstruct_cropped`` inverts
them as they are: its crop mc is then the padded grid pf n (the JAX
package's full-grid ``reconstruct``).
"""

import numpy as np
import torch

from ..dtypes import complex_dtype, real_dtype
from ..ops import brick
from ..ops.fft import fft2_center, fft3_center, ifft2_center, ifft3_center
from ..ops.interp import linear_scatter_add
from ..ops.kernels import mkb_rl, tik_rl

# include/Reconstructor.h:61-75
MIN_N_ITER_BALANCE = 10
MAX_N_ITER_BALANCE = 30
DIFF_C_THRES = 1e-2
DIFF_C_DECREASE_THRES = 0.95
N_DIFF_C_NO_DECREASE = 2
WIENER_FACTOR_MIN_R = 5
FSC_BASE_L = 1e-3
FSC_BASE_H = 1 - 1e-3

DEFAULT_BLOB_A = 1.9
DEFAULT_BLOB_ALPHA = 15.0


def split_grid_exact(rots_np):
    """Partition point-group rotations into GRID-EXACT ones (entries in
    {0, +-1}: F(g k) is a transpose+flip of F) and general ones.
    Returns (exact_ops, general (G, 3, 3) float32 NumPy), exact_ops a tuple
    of ((perm0, perm1, perm2), (flip0, flip1, flip2)) in (z, y, x) order."""
    exact, general = [], []
    for rot in np.asarray(rots_np, np.float64):
        ri = np.rint(rot)
        ok = np.allclose(rot, ri, atol=1e-9) and np.all(
            np.sum(np.abs(ri) > 0.5, axis=1) == 1)
        if not ok:
            general.append(rot)
            continue
        perm, flips = [], []
        for d in range(3):            # dest array axes (z, y, x)
            row = ri[2 - d, :]        # coord component 2-d of R @ k
            j = int(np.nonzero(np.abs(row) > 0.5)[0][0])
            perm.append(2 - j)        # coord j lives on array axis 2-j
            flips.append(bool(row[j] < 0))
        exact.append((tuple(perm), tuple(flips)))
    return tuple(exact), np.asarray(general, np.float32).reshape(-1, 3, 3)


def _radius_sq_grid(m, dims=3, device=None):
    r2 = 0
    for ax in range(dims):
        f = torch.arange(m, dtype=torch.float32, device=device) - m // 2
        s = [1] * dims
        s[ax] = m
        r2 = r2 + f.reshape(s) ** 2
    return r2


def symmetrize_exact(f, t, exact_ops, max_radius, pf=2):
    """Grid-exact part of SYMMETRIZE_FT: F(k) += F(g k) as transpose+flip,
    masked to |k| < max_radius pf + 1. Odd grids only."""
    if not exact_ops:
        return f, t
    mc = f.shape[-1]
    r2 = _radius_sq_grid(mc, 3, f.device)
    mask = r2 < (float(max_radius) * pf + 1) ** 2

    def ap(x, perm, flips):
        y = x.permute(perm)
        axes = tuple(ax for ax, fl in enumerate(flips) if fl)
        return torch.flip(y, dims=axes) if axes else y

    f_acc, t_acc = f, t
    for perm, flips in exact_ops:
        f_acc = f_acc + torch.where(mask, ap(f, perm, flips),
                                    torch.zeros_like(f))
        t_acc = t_acc + torch.where(mask, ap(t, perm, flips),
                                    torch.zeros_like(t))
    return f_acc, t_acc


def reconstruct_cropped(f, t, fsc, size, pf=2, max_radius=None,
                        grid_corr=True, map_wiener=True, join_half=False,
                        blob_a=DEFAULT_BLOB_A, blob_alpha=DEFAULT_BLOB_ALPHA,
                        w_init=None, return_w=False, dims=3):
    """Band-cropped (F, T) (mc,)*dims + per-shell FSC -> real n-box map (or
    image for ``dims = 2``), and the converged C-balance weights when
    ``return_w``. Trilinear (bilinear) insert only. ``w_init`` warm-starts
    the C-balance iteration."""
    if max_radius is None:
        max_radius = size // 2 - 2
    max_radius = float(max_radius)
    dev = f.device
    mc = f.shape[-1]
    m = size * pf
    fftc = fft3_center if dims == 3 else fft2_center
    ifftc = ifft3_center if dims == 3 else ifft2_center
    r2 = _radius_sq_grid(mc, dims, dev)
    in_rad = r2 < (max_radius * pf) ** 2

    dc = t[(mc // 2,) * dims]
    sf = 1.0 / torch.clamp(dc, min=1e-30)
    f = f * sf
    t = t * sf

    if map_wiener:
        u = torch.round(torch.sqrt(r2)).long()
        fsc = torch.as_tensor(fsc, dtype=real_dtype, device=dev)
        shell = torch.clamp(u // pf, 0, fsc.shape[0] - 1)
        fsc_px = torch.where(u // pf >= fsc.shape[0],
                             torch.zeros((), device=dev), fsc[shell])
        fsc_px = torch.clamp(fsc_px, FSC_BASE_L, FSC_BASE_H)
        if join_half:
            fsc_px = torch.sqrt(2 * fsc_px / (1 + fsc_px))
        wien = (r2 >= float(WIENER_FACTOR_MIN_R * pf) ** 2) & in_rad
        t = torch.where(wien, t / fsc_px, t)

    t = torch.clamp(t, min=1e-25)
    one = torch.ones((), dtype=real_dtype, device=dev)
    zero = torch.zeros((), dtype=real_dtype, device=dev)
    w = torch.where(in_rad, one, zero)
    if w_init is not None:
        # newly opened shells carry w_init == 0: seed them at 1.0
        w = torch.where(in_rad, torch.where(w_init > 0.0, w_init, one), zero)

    if grid_corr:
        taper_a = blob_a * pf
        taper_r = torch.sqrt(_radius_sq_grid(mc, dims, dev)) / mc
        nf = mkb_rl(torch.zeros((), device=dev), taper_a, blob_alpha)
        taper = (mkb_rl(taper_r, taper_a, blob_alpha) / nf).to(real_dtype)
        big = float(np.finfo(np.float32).max)
        diff_c, n_no_dec, it = big, 0, 0
        # the stopping rule reads diff_c each iteration: one host sync per
        # iteration, <= 30 per half per round
        while it < MAX_N_ITER_BALANCE:
            if not (diff_c >= DIFF_C_THRES and (
                    it < MIN_N_ITER_BALANCE
                    or n_no_dec < N_DIFF_C_NO_DECREASE)):
                break
            c = (t * w).to(complex_dtype)
            c = fftc(ifftc(c) * taper)
            c_abs = torch.abs(c)
            w = torch.where(in_rad, w / torch.clamp(c_abs, min=1e-6), w)
            new_diff = float(torch.amax(torch.where(
                in_rad, torch.abs(c_abs - 1.0), zero)))
            n_no_dec = (n_no_dec + 1
                        if new_diff > diff_c * DIFF_C_DECREASE_THRES else 0)
            diff_c = new_diff
            it += 1
    else:
        w = torch.where(in_rad, 1.0 / torch.clamp(torch.abs(t), min=1e-6),
                        zero)

    fw = torch.where(in_rad, f * w, torch.zeros((), dtype=f.dtype,
                                                 device=dev))
    pad_rl = ifftc(brick.embed_center_ft(fw, m)).real
    lo = m // 2 - size // 2
    out = pad_rl[(slice(lo, lo + size),) * dims]
    r_rl = torch.sqrt(_radius_sq_grid(size, dims, dev)) / (pf * size)
    out = out / tik_rl(r_rl)
    return (out, w) if return_w else out


def empty_state(size, pf=2, device=None):
    """Zeroed padded 3D accumulators F (complex) and T (real) of
    (pf size)^3 and the offset sums ox, oy, counter."""
    m = size * pf
    shape = (m, m, m)
    zero = lambda: torch.zeros((), dtype=real_dtype, device=device)
    return {"F": torch.zeros(shape, dtype=complex_dtype, device=device),
            "T": torch.zeros(shape, dtype=real_dtype, device=device),
            "ox": zero(), "oy": zero(), "counter": zero()}


def insert_pixels_3d(state, values, ctf, rot, col, row, w, pf=2,
                     pixel_mask=None):
    """Scatter one batch of pose-weighted ring pixels into the padded
    accumulators (insertP, src/Reconstructor.cpp:569-928): values (B, P)
    complex, ctf (B, P), rot (B, 3, 3), col/row (P,), w (B,). Each value
    goes to R (col pf, row pf, 0) and its conjugate to the mirror point,
    value * CTF * w into F and CTF^2 * w into T. Returns the new state."""
    from .projector import slice_coords_3d

    coords = slice_coords_3d(rot, col, row, pf=pf)
    wv = w[:, None].to(real_dtype)
    if pixel_mask is not None:
        wv = wv * pixel_mask[None, :]
    fv = values * ctf * wv
    tv = ctf ** 2 * wv
    f = linear_scatter_add(state["F"], coords, fv)
    f = linear_scatter_add(f, -coords, torch.conj(fv))
    t = linear_scatter_add(state["T"], coords, tv)
    t = linear_scatter_add(t, -coords, tv)
    return {**state, "F": f, "T": t}


def insert_offsets(state, tx, ty, w):
    """Accumulate weighted translation offsets for re-centring
    (allReduceO)."""
    return {**state, "ox": state["ox"] + torch.sum(tx * w),
            "oy": state["oy"] + torch.sum(ty * w),
            "counter": state["counter"] + torch.sum(w)}

