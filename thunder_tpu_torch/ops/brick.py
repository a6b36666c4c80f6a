"""Brick-packed spectral volumes (port of the 3D path of
``thunder_tpu.ops.brick``).

Every 2x2x2 trilinear neighbourhood ("brick") of a band-cropped centered
spectrum is packed into ONE row of a flat table, so a trilinear complex
gather is one row fetch plus an 8-wide dot, and a gridding insert adds one
width-24 row [F.re x 8, F.im x 8, T x 8]. The Hermitian mirror of the
insert is deferred to the fold (F <- F + conj(reflect(F)), exact by
linearity); crop sizes are odd so reflect() is an axis flip.

Coordinates are SIGNED centered units in array order (z, y, x); voxel index
= coord + mc//2. Corner order inside a row is (dz, dy, dx) binary.
"""

import torch


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


def half_rows(mc):
    """z-rows of a Hermitian half-space table (centered z in [0, mc//2])."""
    return mc // 2 + 1


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


def fold_insert3_lane(tab_lane, mc, hermitian=True):
    """Fold the (24, R_pad) brick accumulator (rows beyond mc^3 are
    drop/pad rows) back to voxels and apply the deferred Hermitian mirror.
    The table is channel-minor (``insert.new_table``): one transposing copy
    makes each channel contiguous before the 24 per-channel reads.
    Returns (F (mc, mc, mc) complex64, T (mc, mc, mc) float32)."""
    bt = tab_lane[:, :mc ** 3].contiguous().reshape(24, mc, mc, mc)
    dev = tab_lane.device
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
                fr[tgt] += bt[s][blk]
                fi[tgt] += bt[8 + s][blk]
                tt[tgt] += bt[16 + s][blk]
                s += 1
    f = torch.complex(fr, fi)
    if hermitian:
        f = f + torch.conj(torch.flip(f, dims=(0, 1, 2)))
        tt = tt + torch.flip(tt, dims=(0, 1, 2))
    return f, tt
