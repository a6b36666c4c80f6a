"""Ring-mask pixel index sets for the E-step (port of
``thunder_tpu.ops.pixels``; allocPreCalIdx, src/Optimiser.cpp:7991-8041).

The band [rL, rU) of half-plane pixels (col >= 0, skipping col == 0,
row < 0) with their signed frequencies and shells round(|f|), sorted by
|k| and padded to a bucket size (256/512/1024, then multiples of
``PIXEL_BUCKET``). Padding entries carry mask 0 and point at (0, 0).
Built with NumPy on the host, exactly as in the JAX package.
"""

from dataclasses import dataclass

import numpy as np

# the E-step cost is linear in the padded pixel count, so buckets stay
# tight: the demo band r=40 has 2440 ring pixels, 2560 padded at 512
PIXEL_BUCKET = 512


@dataclass
class PixelRing:
    """Static pixel working set for one (rL, rU) band.

    col/row: (P,) int32 signed integer frequencies (cycles/box)
    sig:     (P,) int32 shell index = round(|f|)
    mask:    (P,) float32, 1 for real pixels, 0 for padding
    n_real:  true number of pixels before padding
    """

    col: np.ndarray
    row: np.ndarray
    sig: np.ndarray
    mask: np.ndarray
    n_real: int
    r_low: float
    r_high: float

    @property
    def n(self):
        return len(self.col)

    def n_inner(self, r):
        """Count of real pixels with |k| <= r. Valid as a static split
        point because real pixels are sorted by |k| (pads at the end
        belong to the outer segment; they are masked out downstream)."""
        u2 = (self.col.astype(np.float64) ** 2
              + self.row.astype(np.float64) ** 2)
        return int(np.count_nonzero((u2 <= float(r) ** 2)
                                    & (self.mask > 0)))


def _bucket_size(n_real, bucket):
    """Smallest allowed padded size >= n_real: {256, 512, 1024} for small
    bands (the global-search / early-ladder rings are tiny — a flat 2048
    floor made round 1 of a 160 px run spend >90% of its E-step on pad
    pixels), then multiples of ``bucket``."""
    for small in (256, 512, 1024):
        if small < bucket and n_real <= small:
            return small
    return max(bucket, int(np.ceil(max(n_real, 1) / bucket)) * bucket)


def pixel_ring(size, r_low, r_high, bucket=PIXEL_BUCKET):
    """Build the padded pixel set for an size x size image band [r_low, r_high)."""
    i = np.arange(0, int(r_high) + 2)  # col freq >= 0
    j = np.arange(-int(r_high) - 1, int(r_high) + 2)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    keep = ~((ii == 0) & (jj < 0))
    u2 = ii.astype(np.float64) ** 2 + jj.astype(np.float64) ** 2
    v = np.rint(np.sqrt(u2))
    keep &= (u2 < r_high**2) & (u2 >= r_low**2)
    keep &= (v < r_high) & (v >= r_low)
    # also stay within the Nyquist square of the actual image
    keep &= (ii < size // 2) & (jj < size // 2) & (jj >= -size // 2)
    col = ii[keep].astype(np.int32)
    row = jj[keep].astype(np.int32)
    sig = v[keep].astype(np.int32)
    # sort real pixels by |k| so a radius-tiered gather can split the
    # pixel axis statically (inner pixels gather from a smaller — faster —
    # table crop; every consumer treats the list as an unordered set)
    order = np.argsort(u2[keep], kind="stable")
    col, row, sig = col[order], row[order], sig[order]
    n_real = len(col)
    n_pad = _bucket_size(n_real, bucket)
    pad = n_pad - n_real
    col = np.concatenate([col, np.zeros(pad, np.int32)])
    row = np.concatenate([row, np.zeros(pad, np.int32)])
    sig = np.concatenate([sig, np.zeros(pad, np.int32)])
    mask = np.concatenate(
        [np.ones(n_real, np.float32), np.zeros(pad, np.float32)]
    )
    return PixelRing(
        col=col, row=row, sig=sig, mask=mask, n_real=n_real,
        r_low=float(r_low), r_high=float(r_high),
    )


def scatter_pixels(values, ring, n, hermitian=True):
    """Ring pixel values (..., P) back into centred (..., n, n) spectra,
    each pixel also mirrored to its Hermitian conjugate when asked (the
    ring covers col >= 0 only); the DC pixel is written once, and a mirror
    that falls outside the box (row -n/2) is dropped."""
    import torch

    dev = values.device
    col = torch.as_tensor(ring.col, device=dev).long()
    row = torch.as_tensor(ring.row, device=dev).long()
    mask = torch.as_tensor(ring.mask, device=dev).to(values.real.dtype)
    values = values * mask
    out = torch.zeros(values.shape[:-1] + (n * n,), dtype=values.dtype,
                      device=dev)

    def add(r, c, v):
        keep = (r >= 0) & (r < n) & (c >= 0) & (c < n)
        out.index_add_(-1, (r * n + c)[keep], v[..., keep])

    add(row + n // 2, col + n // 2, values)
    if hermitian:
        self_conj = (col == 0) & (row == 0)
        add(n // 2 - row, n // 2 - col,
            torch.where(self_conj, 0.0, mask) * torch.conj(values))
    return out.reshape(values.shape[:-1] + (n, n))


def gather_pixels(ft_centered, ring):
    """Gather ring pixels from centered spectra (..., n, n) -> (..., P)."""
    import torch

    n = ft_centered.shape[-1]
    dev = ft_centered.device
    rows = torch.as_tensor(ring.row, device=dev).long() + n // 2
    cols = torch.as_tensor(ring.col, device=dev).long() + n // 2
    return ft_centered[..., rows, cols]
