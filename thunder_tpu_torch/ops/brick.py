"""Brick-packed spectral volumes and images (port of
``thunder_tpu.ops.brick``).

Every 2x2x2 trilinear neighbourhood ("brick") of a band-cropped centered
spectrum is packed into ONE row of a flat table, so a trilinear complex
gather is one row fetch plus an 8-wide dot, and a gridding insert adds one
width-24 row [F.re x 8, F.im x 8, T x 8]. The Hermitian mirror of the
insert is deferred to the fold (F <- F + conj(reflect(F)), exact by
linearity); crop sizes are odd so reflect() is an axis flip.

Coordinates are SIGNED centered units in array order (z, y, x); voxel index
= coord + mc//2. Corner order inside a row is (dz, dy, dx) binary.

Two 3D layouts: the full-space table (``pack_vol3``, (mc, mc, mc, C),
``gather_vol3``) and the Hermitian half-space one (``pack_vol3_half``,
``gather_vol3_half``), which the refinement rounds use. The insert
accumulator is either K2's channel-minor lane table (``ops.insert``,
``fold_insert3_lane``) or a row-major (mc^3 + 1, 24) table filled with
``index_add_`` (``insert3``, and ``insert3_mkb`` for the MKB blob kernel:
8 rows a sample) and folded by ``fold_insert3``. ``pack_real3`` /
``gather_real3`` pack and interpolate real channels (the symmetrisation).

The 2D counterparts (2D classification) pack the 2x2 bilinear
neighbourhood of a centered image spectrum: 8 f32 channels (or 4 packed
bf16 pairs) per gather row, a width-12 [F.re x 4, F.im x 4, T x 4]
insert row, corner order (dy, dx) binary.
"""

import torch

from . import kernels

# the MKB support's 8 brick rows: start voxel floor(u) - 1 + this offset
MKB_ROW_OFFSETS = tuple((dz, dy, dx) for dz in (0, 2) for dy in (0, 2)
                        for dx in (0, 2))


def crop_half(r_max, pf):
    """Crop half-width: |k| <= r_max*pf plus a +2 margin."""
    return int(r_max) * pf + 2


def crop_size(r_max, pf):
    return 2 * crop_half(r_max, pf) + 1  # odd


def crop_center_ft(ft_full, mc):
    """Center-crop a centered (m,)*d spectrum to (mc,)*d."""
    m = ft_full.shape[-1]
    lo = m // 2 - mc // 2
    return ft_full[tuple(slice(lo, lo + mc) for _ in range(ft_full.ndim))]


def embed_center_ft(ft_crop, m):
    """Zero-embed a centered (mc,)*d spectrum back into (m,)*d."""
    mc = ft_crop.shape[-1]
    lo = m // 2 - mc // 2
    out = torch.zeros((m,) * ft_crop.ndim, dtype=ft_crop.dtype,
                      device=ft_crop.device)
    out[tuple(slice(lo, lo + mc) for _ in range(ft_crop.ndim))] = ft_crop
    return out


def _pack(vol_ft, dtype, z0=0):
    """Bricks of the z-rows [z0, mc) of a centered (mc, mc, mc) spectrum."""
    mc = vol_ft.shape[0]
    vp = torch.nn.functional.pad(vol_ft, (0, 1, 0, 1, 0, 1))
    parts = [vp[z0 + dz:mc + dz, dy:dy + mc, dx:dx + mc]
             for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    st = torch.stack(parts, -1)  # (mc - z0, mc, mc, 8) complex
    if dtype == torch.bfloat16:
        pairs = torch.stack([st.real.to(torch.bfloat16),
                             st.imag.to(torch.bfloat16)], -1).contiguous()
        return pairs.view(torch.float32)[..., 0]
    return torch.cat([st.real.to(dtype), st.imag.to(dtype)], -1)


def pack_vol3(vol_ft, dtype=torch.float32):
    """Centered cropped complex spectrum (mc, mc, mc) -> gather table.

    float32: (mc, mc, mc, 16) rows [re(corner 0..7), im(corner 0..7)].
    bfloat16: (mc, mc, mc, 8) float32 rows whose lanes each hold one
    corner's (re, im) as a bf16 pair — bit-identical to the JAX package's
    ``bitcast_convert_type`` layout (re in the low half-word)."""
    return _pack(vol_ft, dtype)


def unpack_pair_rows(rows):
    """(..., C) packed bf16-pair rows -> (re, im), each (..., C) float32."""
    pairs = rows.contiguous().view(torch.bfloat16).reshape(
        rows.shape + (2,))
    return pairs[..., 0].float(), pairs[..., 1].float()


def pack_vol3_half(vol_ft, dtype=torch.float32):
    """Hermitian half-space gather table: the bricks at centered z >= 0,
    (mc//2 + 1, mc, mc, C). Samples with z < 0 fetch at -k and conjugate
    (``gather_vol3_half``); exact for the spectrum of a real volume."""
    return _pack(vol_ft, dtype, z0=vol_ft.shape[0] // 2)


def _trilinear_w8(frac):
    """(..., 3) fractional (z, y, x) -> (..., 8) corner weights, corner
    order (dz, dy, dx) binary, products formed as (wz * wy) * wx."""
    fz, fy, fx = frac[..., 0], frac[..., 1], frac[..., 2]
    wz = torch.stack([1 - fz, fz], -1)
    wy = torch.stack([1 - fy, fy], -1)
    wx = torch.stack([1 - fx, fx], -1)
    return (wz[..., :, None, None] * wy[..., None, :, None]
            * wx[..., None, None, :]).reshape(frac.shape[:-1] + (8,))


def half_rows(mc):
    """z-rows of a Hermitian half-space table (centered z in [0, mc//2])."""
    return mc // 2 + 1


def _corners3(coords, mc):
    """Full-space trilinear corners of centered (z, y, x) coords (..., 3):
    (idx (...) int64 into the flat (mc^3, C) table, w8 (..., 8), valid)."""
    base = torch.floor(coords)
    frac = (coords - base).float()
    bi = base.to(torch.int64) + mc // 2
    idx = (bi[..., 0] * mc + bi[..., 1]) * mc + bi[..., 2]
    valid = torch.all((bi >= 0) & (bi < mc - 1), dim=-1)
    return idx, _trilinear_w8(frac), valid


def gather_vol3(tab, coords):
    """Trilinear complex gather from a full-space ``pack_vol3`` table
    (mc, mc, mc, C): one row fetch per sample. coords (..., 3) centered
    (z, y, x) -> (...,) complex64."""
    mc = tab.shape[0]
    idx, w8, valid = _corners3(coords, mc)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    rows = tab.reshape(mc ** 3, tab.shape[-1])[idx.reshape(-1)]
    re, im = interp_rows(rows.reshape(idx.shape + (tab.shape[-1],)), w8)
    out = torch.complex(re, im)
    return torch.where(valid, out, torch.zeros_like(out))


def _corners3_half(coords, mc):
    """Mirror-to-upper-half trilinear corners: (idx, w8, valid, sgn) with
    idx into the flat half table and sgn = -1 where the sample was
    mirrored (imaginary part conjugated)."""
    sgn = torch.where(coords[..., 0] < 0, -1.0, 1.0).to(torch.float32)
    cm = coords * sgn[..., None]
    base = torch.floor(cm)
    frac = (cm - base).float()
    bi = base.to(torch.int64)
    bz = bi[..., 0]
    by = bi[..., 1] + mc // 2
    bx = bi[..., 2] + mc // 2
    idx = (bz * mc + by) * mc + bx
    valid = ((bz >= 0) & (bz < mc // 2) & (by >= 0) & (by < mc - 1)
             & (bx >= 0) & (bx < mc - 1))
    return idx, _trilinear_w8(frac), valid, sgn


def interp_rows(rows, w8, n_corner=8):
    """Trilinear dot of gathered rows: f32 (..., 16) or packed bf16-pair
    (..., 8) rows -> (re, im) (...,) float32."""
    if rows.shape[-1] == n_corner:
        rr, ri = unpack_pair_rows(rows)
    else:
        rows = rows.float()
        rr, ri = rows[..., :n_corner], rows[..., n_corner:]
    return torch.sum(rr * w8, -1), torch.sum(ri * w8, -1)


def gather_vol3_half(tab, coords):
    """Trilinear complex gather from a ``pack_vol3_half`` table.
    coords: (..., 3) centered (z, y, x) -> (...,) complex64."""
    hz, mc = tab.shape[0], tab.shape[1]
    idx, w8, valid, sgn = _corners3_half(coords, mc)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    rows = tab.reshape(hz * mc * mc, tab.shape[-1])[idx.reshape(-1)]
    rows = rows.reshape(idx.shape + (tab.shape[-1],))
    re, im = interp_rows(rows, w8)
    out = torch.complex(re, im * sgn)
    return torch.where(valid, out, torch.zeros_like(out))


def pack_real3(*vols):
    """C real cropped volumes (mc, mc, mc) -> a (mc, mc, mc, 8C) gather
    table: channel c's 8 corners in lanes 8c .. 8c + 7."""
    mc = vols[0].shape[0]
    out = torch.empty((mc, mc, mc, 8 * len(vols)), dtype=torch.float32,
                      device=vols[0].device)
    for c, v in enumerate(vols):
        vp = torch.nn.functional.pad(v.float(), (0, 1, 0, 1, 0, 1))
        for s, (dz, dy, dx) in enumerate(
                (dz, dy, dx) for dz in (0, 1) for dy in (0, 1)
                for dx in (0, 1)):
            out[..., 8 * c + s] = vp[dz:dz + mc, dy:dy + mc, dx:dx + mc]
    return out


def gather_real3(tab, coords):
    """Trilinear gather of the C channels of a ``pack_real3`` table at
    coords (..., 3) centered (z, y, x): returns (..., C) float32."""
    mc = tab.shape[0]
    c = tab.shape[-1] // 8
    idx, w8, valid = _corners3(coords, mc)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    rows = tab.reshape(mc ** 3, 8 * c)[idx.reshape(-1)]
    out = torch.sum(rows.reshape(idx.shape + (c, 8)) * w8[..., None, :], -1)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def empty_insert3(mc, device=None):
    """A zeroed row-major (mc^3 + 1, 24) insert accumulator; the last row
    is the drop row of out-of-band samples."""
    return torch.zeros((mc ** 3 + 1, 24), dtype=torch.float32, device=device)


def _table_mc(tab):
    return round((tab.shape[0] - 1) ** (1 / 3))


def insert_rows(w_c, fv, tv):
    """The (N, 3 w) insert rows [fv.re w_c, fv.im w_c, tv w_c] of N samples'
    corner weights w_c (..., w), values fv (...,) complex and tv (...,),
    written into one buffer with no temporaries of their width."""
    w = w_c.shape[-1]
    w_c = w_c.reshape(-1, w)
    rows = torch.empty((w_c.shape[0], 3 * w), dtype=torch.float32,
                       device=w_c.device)
    torch.mul(fv.real.reshape(-1, 1), w_c, out=rows[:, :w])
    torch.mul(fv.imag.reshape(-1, 1), w_c, out=rows[:, w:2 * w])
    torch.mul(tv.reshape(-1, 1), w_c, out=rows[:, 2 * w:])
    return rows


def insert3(tab, coords, fv, tv, w=None):
    """Add trilinear width-24 rows into a (mc^3 + 1, 24) accumulator in
    place (``index_add_``; the JAX package's XLA row scatter). coords
    (..., 3); fv complex (...,); tv (...,); optional w (...,) weights
    folded into both F and T."""
    mc = _table_mc(tab)
    idx, w8, valid = _corners3(coords, mc)
    idx = torch.where(valid, idx, torch.full_like(idx, mc ** 3))
    if w is not None:
        w8 = w8 * w[..., None]
    return tab.index_add_(0, idx.reshape(-1),
                          insert_rows(w8, fv, tv.expand(fv.shape)))


def mkb_base(coords, mc):
    """The MKB support's start voxel floor(u) - 1 (..., 3) int64 (voxel
    indices) and the fractional part (..., 3) float32 of centered coords."""
    base = torch.floor(coords)
    return base.to(torch.int64) + (mc // 2 - 1), (coords - base).float()


def mkb_row3(b0, frac, mc, off, a=1.9, alpha=15.0):
    """One of the 8 brick rows of the MKB support (``mkb_rows3``): the row
    at start voxel b0 + off, off in {0, 2}^3. Returns (idx (...) int64
    into the flat (mc^3, .) table, w8 (..., 8) = mkb_ft of each corner's
    distance to the sample, valid)."""
    dz, dy, dx = off
    bi = b0 + torch.tensor(off, dtype=torch.int64, device=b0.device)
    idx = (bi[..., 0] * mc + bi[..., 1]) * mc + bi[..., 2]
    valid = torch.all((bi >= 0) & (bi < mc - 1), dim=-1)
    w_c = []
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                d = torch.stack([dz + cz - 1.0 - frac[..., 0],
                                 dy + cy - 1.0 - frac[..., 1],
                                 dx + cx - 1.0 - frac[..., 2]], -1)
                r = torch.sqrt(torch.sum(d * d, -1))
                w_c.append(kernels.mkb_ft(r, a, alpha))
    return idx, torch.stack(w_c, -1), valid


def mkb_rows3(coords, mc, a=1.9, alpha=15.0):
    """The MKB gridding kernel's support decomposed into brick rows
    (RECONSTRUCTOR_MKB_KERNEL, src/Reconstructor.cpp:452-556): the 4^3
    voxels [floor(u) - 1, floor(u) + 2] cover the blob of radius ``a``
    (padded voxels) and tile exactly into 8 brick rows of 2^3 corners.
    Returns the 8 (idx, w8, valid) of ``mkb_row3`` in (dz, dy, dx)
    order; invalid rows go to the drop row (the caller's)."""
    b0, frac = mkb_base(coords, mc)
    return [mkb_row3(b0, frac, mc, off, a, alpha) for off in MKB_ROW_OFFSETS]


def insert3_mkb(tab, coords, fv, tv, w=None, a=1.9, alpha=15.0):
    """MKB-kernel gridding insert into a (mc^3 + 1, 24) accumulator in
    place: 8 width-24 row adds a sample, one row set at a time. Same
    arguments as ``insert3``."""
    mc = _table_mc(tab)
    b0, frac = mkb_base(coords, mc)
    for off in MKB_ROW_OFFSETS:
        idx, w8, valid = mkb_row3(b0, frac, mc, off, a, alpha)
        idx = torch.where(valid, idx, torch.full_like(idx, mc ** 3))
        if w is not None:
            w8 = w8 * w[..., None]
        tab.index_add_(0, idx.reshape(-1),
                       insert_rows(w8, fv, tv.expand(fv.shape)))
    return tab


def _fold3(chan, mc, dev, hermitian):
    """Fold the brick channels ``chan(s)`` (mc, mc, mc) of corner s
    (re, im, T at s, 8 + s, 16 + s) back to voxels, then the deferred
    Hermitian mirror."""
    fr = torch.zeros((mc, mc, mc), dtype=torch.float32, device=dev)
    fi = torch.zeros_like(fr)
    tt = torch.zeros_like(fr)
    s = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                blk = (slice(None, mc - dz), slice(None, mc - dy),
                       slice(None, mc - dx))
                tgt = (slice(dz, None), slice(dy, None), slice(dx, None))
                fr[tgt] += chan(s)[blk]
                fi[tgt] += chan(8 + s)[blk]
                tt[tgt] += chan(16 + s)[blk]
                s += 1
    f = torch.complex(fr, fi)
    if hermitian:
        f = f + torch.conj(torch.flip(f, dims=(0, 1, 2)))
        tt = tt + torch.flip(tt, dims=(0, 1, 2))
    return f, tt


def fold_insert3(tab, hermitian=True):
    """Fold a row-major (mc^3 + 1, 24) accumulator (the last row dropped)
    back to voxels with the deferred Hermitian mirror: (F (mc, mc, mc)
    complex64, T (mc, mc, mc) float32)."""
    mc = _table_mc(tab)
    bt = tab[:-1].reshape(mc, mc, mc, 24)
    return _fold3(lambda c: bt[..., c], mc, tab.device, hermitian)


def fold_insert3_lane(tab_lane, mc, hermitian=True):
    """Fold the (24, R_pad) brick accumulator (rows beyond mc^3 are
    drop/pad rows) back to voxels and apply the deferred Hermitian mirror.
    The table is channel-minor (``insert.new_table``): one transposing copy
    makes each channel contiguous before the 24 per-channel reads.
    Returns (F (mc, mc, mc) complex64, T (mc, mc, mc) float32)."""
    bt = tab_lane[:, :mc ** 3].contiguous().reshape(24, mc, mc, mc)
    return _fold3(lambda c: bt[c], mc, tab_lane.device, hermitian)


# --------------------------------------------------------------------- 2D

def _corners2(coords, mc):
    """Bilinear corners of centered (y, x) coordinates (..., 2): (idx into
    the flat (mc^2, C) table, w4 (..., 4), valid)."""
    base = torch.floor(coords)
    frac = (coords - base).float()
    bi = base.to(torch.int64) + mc // 2
    idx = bi[..., 0] * mc + bi[..., 1]
    valid = torch.all((bi >= 0) & (bi < mc - 1), dim=-1)
    fy, fx = frac[..., 0], frac[..., 1]
    wy = torch.stack([1 - fy, fy], -1)
    wx = torch.stack([1 - fx, fx], -1)
    w4 = (wy[..., :, None] * wx[..., None, :]).reshape(
        coords.shape[:-1] + (4,))
    return idx, w4, valid


def pack_vol2(img_ft, dtype=torch.float32):
    """Centered cropped spectra (..., mc, mc) -> (..., mc, mc, 8) f32 rows
    [re(corner 0..3), im(corner 0..3)], or (..., mc, mc, 4) packed bf16
    pairs for ``dtype=bfloat16``."""
    mc = img_ft.shape[-1]
    vp = torch.nn.functional.pad(img_ft, (0, 1, 0, 1))
    st = torch.stack([vp[..., dy:dy + mc, dx:dx + mc]
                      for dy in (0, 1) for dx in (0, 1)], -1)
    if dtype == torch.bfloat16:
        pairs = torch.stack([st.real.to(torch.bfloat16),
                             st.imag.to(torch.bfloat16)], -1).contiguous()
        return pairs.view(torch.float32)[..., 0]
    return torch.cat([st.real.to(dtype), st.imag.to(dtype)], -1)


def gather_vol2(tab, coords):
    """Bilinear complex gather from a ``pack_vol2`` table (mc, mc, C);
    coords (..., 2) centered (y, x) -> (...,) complex64."""
    mc = tab.shape[0]
    idx, w4, valid = _corners2(coords, mc)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    rows = tab.reshape(mc * mc, tab.shape[-1])[idx.reshape(-1)]
    re, im = interp_rows(rows.reshape(idx.shape + (tab.shape[-1],)), w4,
                         n_corner=4)
    out = torch.complex(re, im)
    return torch.where(valid, out, torch.zeros_like(out))


def empty_insert2(mc, device=None):
    """A zeroed (mc^2 + 1, 12) 2D insert accumulator; the last row is the
    drop row of out-of-band samples."""
    return torch.zeros((mc * mc + 1, 12), dtype=torch.float32, device=device)


def insert2(tab, coords, fv, tv, w=None):
    """Add bilinear width-12 rows into a (mc^2 + 1, 12) accumulator in
    place (``index_add_``; the JAX package's XLA row scatter). coords
    (..., 2); fv complex (...,); tv (...,); optional w (...,) weights."""
    mc = round((tab.shape[0] - 1) ** 0.5)
    idx, w4, valid = _corners2(coords, mc)
    idx = torch.where(valid, idx, torch.full_like(idx, mc * mc))
    if w is not None:
        w4 = w4 * w[..., None]
    return tab.index_add_(0, idx.reshape(-1),
                          insert_rows(w4, fv, tv.expand(fv.shape)))


def fold_insert2(tab, hermitian=True):
    """Fold a (mc^2 + 1, 12) accumulator (the last row dropped) back to
    pixels with the deferred Hermitian mirror: (F (mc, mc) complex64,
    T (mc, mc) float32)."""
    mc = round((tab.shape[0] - 1) ** 0.5)
    bt = tab[:-1].reshape(mc, mc, 12)
    fr = torch.zeros((mc, mc), dtype=torch.float32, device=tab.device)
    fi = torch.zeros_like(fr)
    tt = torch.zeros_like(fr)
    s = 0
    for dy in (0, 1):
        for dx in (0, 1):
            blk = bt[:mc - dy, :mc - dx]
            fr[dy:, dx:] += blk[..., s]
            fi[dy:, dx:] += blk[..., 4 + s]
            tt[dy:, dx:] += blk[..., 8 + s]
            s += 1
    f = torch.complex(fr, fi)
    if hermitian:
        f = f + torch.conj(torch.flip(f, dims=(0, 1)))
        tt = tt + torch.flip(tt, dims=(0, 1))
    return f, tt
