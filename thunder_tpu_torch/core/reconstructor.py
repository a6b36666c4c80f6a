"""Reconstruction from the folded insert: point-group symmetrisation and
Wiener-FSC / C-balance inversion (port of ``thunder_tpu.core.
reconstructor``; src/Reconstructor.cpp).

Contract (the reference's active config, include/Config.h:95-117):
normalise F and T by T's DC; Wiener MAP T /= clamp(FSC, 1e-3, 1-1e-3) for
shells in [5 pf, maxR pf); C-balance W <- W / |FT(IFT(T W) taper)| until
max||C|-1| < 1e-2 or no decrease (<= 30 iterations); F *= W; zero-embed
into the padded grid, inverse FFT, extract the n-box, divide by the
grid-correction profile of the insert kernel (``insert_kernel``:
"trilinear" -> sinc^2, "mkb" -> the MKB blob's). ``dims = 2`` runs the
same contract on 2D class averages (2D classification).

Symmetrisation F(k) <- sum_g F(g k) over the point group
(SYMMETRIZE_FT, src/Reconstructor.cpp:2676-2692): grid-exact rotations as
transposes and flips (``symmetrize_exact``), the others by trilinear
gathers from a ``brick.pack_real3`` table of [F.re, F.im, T]
(``symmetrize_cropped``), or on the full padded grid (``symmetrize``).

The brick-state API (``empty_brick_state``, ``insert_brick_3d`` /
``insert_brick_2d``, ``finalize_brick``) inserts batches of pose-weighted
pixels into a row-major band-cropped accumulator and folds it.

The full-grid path of the tools (``thunder_tpu_torch.cli``'s
``reconstruct`` and the like): ``empty_state`` holds padded (F, T)
accumulators and the re-centring offsets, ``insert_pixels_3d`` scatters
pose-weighted ring pixels and their Hermitian mirrors into them with
``ops.interp.linear_scatter_add``, ``symmetrize`` symmetrises them and
``reconstruct`` inverts them: ``reconstruct_cropped`` with the padded grid
pf n as its crop.
"""

import numpy as np
import torch

from ..dtypes import complex_dtype, real_dtype, resolve_device
from ..ops import brick
from ..ops.fft import fft2_center, fft3_center, ifft2_center, ifft3_center
from ..ops.interp import linear_gather, linear_scatter_add
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


def _sym_coords(mc, device):
    """Centered (x, y, z) coordinates (mc, mc, mc, 3) of the voxels of an
    (mc,)^3 grid in (z, y, x) array order, and their squared radius."""
    idx = torch.arange(mc, dtype=torch.float32, device=device) - mc // 2
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    return torch.stack([xx, yy, zz], -1), xx ** 2 + yy ** 2 + zz ** 2


def symmetrize(state, sym_rots, max_radius, pf=2):
    """F(k) <- sum_g F(g k), T likewise, over the point group with the
    identity, on the full padded grid of ``empty_state`` with trilinear
    gathers (SYMMETRIZE_FT, LINEAR_INTERP), inside |k| < max_radius pf + 1.
    sym_rots: (G, 3, 3) WITHOUT the identity; no-op when G = 0."""
    if len(sym_rots) == 0:
        return state
    f, t = state["F"], state["T"]
    coords, r2 = _sym_coords(f.shape[-1], f.device)
    mask = r2 < float(max_radius * pf + 1) ** 2
    f_acc, t_acc = f, t
    for rot in torch.as_tensor(sym_rots, dtype=torch.float32,
                               device=f.device):
        rc = torch.flip(coords @ rot.T, dims=(-1,))
        f_acc = f_acc + torch.where(mask, linear_gather(f, rc),
                                    torch.zeros((), dtype=f.dtype,
                                                device=f.device))
        t_acc = t_acc + torch.where(mask, linear_gather(t, rc),
                                    torch.zeros((), device=t.device))
    return {**state, "F": f_acc, "T": t_acc}


def symmetrize_cropped(f, t, sym_rots, max_radius, pf=2, z_chunk=64):
    """F(k) <- sum_g F(g k), T likewise, on the band-cropped grid
    (SYMMETRIZE_FT): every rotation g of sym_rots (G, 3, 3) (WITHOUT the
    identity) gathers [F.re, F.im, T] trilinearly from one
    ``brick.pack_real3`` table at each voxel inside |k| < max_radius pf + 1
    (the others gain nothing). The grid is walked in slabs of ``z_chunk``
    z-planes, and only a slab's in-band voxels are gathered, which bounds
    the (voxels, 24) row temporaries; the result does not depend on
    ``z_chunk``. Returns (F, T)."""
    if len(sym_rots) == 0:
        return f, t
    mc = f.shape[-1]
    dev = f.device
    tab = brick.pack_real3(f.real, f.imag, t)
    coords, r2 = _sym_coords(mc, dev)
    inside = (r2 < float(max_radius * pf + 1) ** 2).reshape(-1)
    sel = torch.nonzero(inside)[:, 0]                # z-major voxel order
    coords = coords.reshape(-1, 3)
    starts = torch.arange(0, mc, z_chunk, device=dev) * (mc * mc)
    bounds = torch.searchsorted(sel, starts).tolist() + [sel.numel()]
    rots = torch.as_tensor(sym_rots, dtype=torch.float32, device=dev)
    acc = torch.zeros((sel.numel(), 3), dtype=torch.float32, device=dev)
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 == b0:
            continue
        xyz = coords[sel[b0:b1]]
        for rot in rots:
            acc[b0:b1] += brick.gather_real3(
                tab, torch.flip(xyz @ rot.T, dims=(-1,)))
    del tab
    f_acc = f.clone().reshape(-1)
    t_acc = t.clone().reshape(-1)
    f_acc[sel] += torch.complex(acc[:, 0], acc[:, 1])
    t_acc[sel] += acc[:, 2]
    return f_acc.reshape(f.shape), t_acc.reshape(t.shape)


def reconstruct_cropped(f, t, fsc, size, pf=2, max_radius=None,
                        grid_corr=True, map_wiener=True, join_half=False,
                        blob_a=DEFAULT_BLOB_A, blob_alpha=DEFAULT_BLOB_ALPHA,
                        w_init=None, return_w=False, dims=3,
                        insert_kernel="trilinear"):
    """Band-cropped (F, T) (mc,)*dims + per-shell FSC -> real n-box map (or
    image for ``dims = 2``), and the converged C-balance weights when
    ``return_w``. ``w_init`` warm-starts the C-balance iteration.
    ``insert_kernel`` names the kernel the insert used: "trilinear"
    (bilinear in 2D) or "mkb", whose C-balance taper has radius
    ``blob_a`` (not ``blob_a * pf``) and whose grid correction divides by
    the blob's own real-space profile instead of sinc^2."""
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
        # the reference's _kernelRL is MKB_RL with a, not pf a
        # (RECONSTRUCTOR_KERNEL_PADDING off, src/Reconstructor.cpp:77-88);
        # for the MKB insert this also matches the deposited MKB_FT(a)
        taper_a = blob_a if insert_kernel == "mkb" else blob_a * pf
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
    if insert_kernel == "mkb":
        # MKB_FT(d) was deposited with d in padded voxels and radius
        # blob_a (brick.mkb_rows3): the envelope at r_rl = x / (pf n) is
        # mkb_rl(r_rl, blob_a), normalised to 1 at the centre
        nf0 = mkb_rl(torch.zeros((), device=dev), blob_a, blob_alpha)
        out = out / (mkb_rl(r_rl, blob_a, blob_alpha) / nf0)
    else:
        out = out / tik_rl(r_rl)
    return (out, w) if return_w else out


def reconstruct(f, t, fsc, size, pf=2, max_radius=None, grid_corr=True,
                map_wiener=True, join_half=False, blob_a=DEFAULT_BLOB_A,
                blob_alpha=DEFAULT_BLOB_ALPHA, dims=3):
    """Full reconstruction from the padded (pf size,)*dims accumulators of
    ``empty_state`` (trilinear insert): ``reconstruct_cropped`` with the
    whole padded grid as its crop, which makes the zero-embedding the
    identity."""
    return reconstruct_cropped(
        f, t, fsc, size, pf=pf, max_radius=max_radius, grid_corr=grid_corr,
        map_wiener=map_wiener, join_half=join_half, blob_a=blob_a,
        blob_alpha=blob_alpha, dims=dims)


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


# ------------------------------------------------------ brick insert path

def empty_brick_state(size, r_max, pf=2, mode="3d", device=None):
    """A zeroed band-cropped brick accumulator for insertion band r_max
    ((mc^d + 1, 3 * 2^d) rows, the last the drop row) and the offset
    sums ox, oy, counter, on ``device`` (default the CUDA device)."""
    device = resolve_device(device)
    mc = brick.crop_size(r_max, pf)
    tab = (brick.empty_insert3(mc, device) if mode == "3d"
           else brick.empty_insert2(mc, device))
    zero = lambda: torch.zeros((), dtype=real_dtype, device=device)
    return {"tab": tab, "ox": zero(), "oy": zero(), "counter": zero()}


def _brick_values(values, ctf, w, pixel_mask):
    wv = w[:, None].to(real_dtype)
    if pixel_mask is not None:
        wv = wv * pixel_mask[None, :]
    return values * ctf * wv, ctf ** 2 * wv


def insert_brick_3d(state, values, ctf, rot, col, row, w, pf=2,
                    pixel_mask=None):
    """Add one batch of pose-weighted ring pixels to the brick state: one
    width-24 row per (image, pixel); the Hermitian mirror is deferred to
    ``finalize_brick``. values (B, P) complex, ctf (B, P), rot (B, 3, 3),
    col/row (P,), w (B,). The table is added to in place."""
    from .projector import slice_coords_3d

    fv, tv = _brick_values(values, ctf, w, pixel_mask)
    coords = slice_coords_3d(rot, col, row, pf=pf)
    return {**state, "tab": brick.insert3(state["tab"], coords, fv, tv)}


def insert_brick_2d(state, values, ctf, rot, col, row, w, pf=2,
                    pixel_mask=None):
    """The 2D gridding insert (insertI2D): rot (B, 2, 2) in-plane
    rotations, otherwise as ``insert_brick_3d``."""
    from .projector import slice_coords_2d

    fv, tv = _brick_values(values, ctf, w, pixel_mask)
    coords = slice_coords_2d(rot, col, row, pf=pf)
    return {**state, "tab": brick.insert2(state["tab"], coords, fv, tv)}


def finalize_brick(state, mode="3d"):
    """Fold the bricks to voxels with the deferred Hermitian mirror:
    cropped (F complex, T real)."""
    fold = brick.fold_insert3 if mode == "3d" else brick.fold_insert2
    return fold(state["tab"])
