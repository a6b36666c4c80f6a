"""Bi/trilinear interpolation gathers and their adjoint scatter-adds on
centered grids (port of ``thunder_tpu.ops.interp``; Interpolation.h:
33-187, Volume::getByInterpolationFT / addFT).

Coordinates are signed centered units in array axis order: array index
= coord + n//2 per axis. Out-of-range corners are dropped: a gather reads
0 for them and a scatter discards them. The scatter is ``index_add_``, as
the JAX package's is an XLA scatter; these serve the tools (projection
and reconstruction on the full padded grid, ``alignz``, subtraction), not
the refinement rounds.
"""

import torch


def _corner_data(coords, n):
    """Flattened corner indices, bi/trilinear weights and in-range flags,
    each (..., 2**dims), of centered ``coords`` (..., dims)."""
    dims = coords.shape[-1]
    base = torch.floor(coords)
    frac = (coords - base).float()
    base = base.long() + n // 2
    lead = coords.shape[:-1]
    flat = torch.zeros(lead + (1,), dtype=torch.long, device=coords.device)
    weights = torch.ones(lead + (1,), dtype=torch.float32,
                         device=coords.device)
    valid = torch.ones(lead + (1,), dtype=torch.bool, device=coords.device)
    off = torch.tensor([0, 1], device=coords.device)
    for d in range(dims):
        b2 = base[..., d][..., None, None] + off        # (..., 1, 2)
        f = frac[..., d][..., None]
        w2 = weights[..., :, None] * torch.stack([1 - f, f], -1)
        v2 = valid[..., :, None] & (b2 >= 0) & (b2 < n)
        flat2 = flat[..., :, None] * n + torch.clamp(b2, 0, n - 1)
        weights = w2.reshape(lead + (-1,))
        valid = v2.reshape(lead + (-1,))
        flat = flat2.reshape(lead + (-1,))
    return flat, weights, valid


def linear_gather(grid, coords):
    """Interpolate ``grid`` (n,)*dims at ``coords`` (..., dims). Returns
    (...,) of the grid's dtype."""
    flat, w, valid = _corner_data(coords, grid.shape[-1])
    vals = grid.reshape(-1)[flat]
    w = torch.where(valid, w, torch.zeros_like(w))
    return torch.sum(vals * w.to(vals.real.dtype), dim=-1)


def linear_scatter_add(grid, coords, values):
    """Adjoint of ``linear_gather``: spread ``values`` (...,) onto a copy
    of ``grid`` with the same weights; returns the copy."""
    n = grid.shape[-1]
    flat, w, valid = _corner_data(coords, n)
    w = torch.where(valid, w, torch.zeros_like(w)).to(values.real.dtype)
    contrib = (values[..., None] * w).reshape(-1)
    idx = torch.where(valid, flat, torch.full_like(flat, n ** grid.dim()))
    out = torch.cat([grid.reshape(-1),
                     torch.zeros(1, dtype=grid.dtype, device=grid.device)])
    if out.is_complex():
        torch.view_as_real(out).index_add_(
            0, idx.reshape(-1), torch.view_as_real(contrib.to(out.dtype)))
    else:
        out.index_add_(0, idx.reshape(-1), contrib.to(out.dtype))
    return out[:-1].reshape(grid.shape)


def nearest_gather(grid, coords):
    """Value of the nearest grid point to each of ``coords`` (..., dims),
    0 out of range."""
    n = grid.shape[-1]
    idx = torch.round(coords).long() + n // 2
    valid = torch.all((idx >= 0) & (idx < n), dim=-1)
    flat = torch.zeros(coords.shape[:-1], dtype=torch.long,
                       device=coords.device)
    for d in range(coords.shape[-1]):
        flat = flat * n + torch.clamp(idx[..., d], 0, n - 1)
    vals = grid.reshape(-1)[flat]
    return torch.where(valid, vals, torch.zeros_like(vals))
