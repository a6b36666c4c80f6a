"""Gridding insert into the brick accumulator — kernel K2 (port of
``thunder_tpu.ops.pallas_insert``).

The M-step back-projection adds, for every sample (voxel row, F.re, F.im,
T, fractional z/y/x), its 8 trilinear corner-weighted (re, im, T) values
into a (24, R_pad) f32 table: channel c of row r is [c, r], and
``brick.fold_insert3_lane`` folds it back to voxels. The logical shape is
the JAX package's lane-major one, but the table is stored CHANNEL-minor,
strides (1, 24): the 24 floats of a row are contiguous (``new_table``).
That is the only layout ``insert_update`` takes. The TPU kernel sorts and
bins samples because the TPU has no vector scatter; the Hopper kernel
(csrc/insert.cu) adds each sample's 96-byte row with six 16-byte atomics,
one per lane of six neighbouring lanes.

``insert_update`` is the wrapper: CUDA tensors launch the kernel, CPU
tensors run ``insert_update_plain`` (the port of
``reference_insert_update``). Both update ``tab_lane`` IN PLACE and return
it (the JAX function returns a new table; its caller donates the old one).
Rows outside [0, R_pad) are dropped.
"""

import torch

LAUNCHES = {"insert_update": 0}

ROW_ALIGN = 512  # accumulator rows are padded to this multiple


def rows_pad(n_rows):
    """Accumulator row count padded to ROW_ALIGN (the JAX window grid)."""
    return -(-n_rows // ROW_ALIGN) * ROW_ALIGN


def new_table(r_pad, device=None):
    """A zeroed (24, r_pad) f32 accumulator stored channel-minor: the
    transpose of a contiguous (r_pad, 24) tensor."""
    return torch.zeros((r_pad, 24), dtype=torch.float32, device=device).T


def is_channel_minor(tab):
    """Whether ``tab`` is a (24, R) table with strides (1, 24) and a
    16-byte aligned base, the layout of ``new_table``."""
    return (tab.ndim == 2 and tab.shape[0] == 24 and tab.stride() == (1, 24)
            and tab.data_ptr() % 16 == 0)


def corner_contrib(fr, fi, tv, frac):
    """(N,) values + (N, 3) fractions -> (N, 24) row contributions
    [F.re w8, F.im w8, T w8], w8 = (wz * wy) * wx, corners (dz, dy, dx)."""
    fz, fy, fx = frac[:, 0], frac[:, 1], frac[:, 2]
    wz = torch.stack([1 - fz, fz], -1)
    wy = torch.stack([1 - fy, fy], -1)
    wx = torch.stack([1 - fx, fx], -1)
    w8 = (wz[:, :, None, None] * wy[:, None, :, None]
          * wx[:, None, None, :]).reshape(-1, 8)
    return torch.cat([fr[:, None] * w8, fi[:, None] * w8, tv[:, None] * w8],
                     dim=-1)


def insert_update_plain(tab_lane, idx, fr, fi, tv, frac):
    """Plain PyTorch version of K2: one width-24 row add per sample."""
    keep = (idx >= 0) & (idx < tab_lane.shape[1])
    contrib = corner_contrib(fr, fi, tv, frac)
    tab_lane.T.index_add_(0, idx[keep].long(), contrib[keep])
    return tab_lane


def _check_insert_inputs(tab_lane, idx, fr, fi, tv, frac):
    n = idx.shape[0]
    dev = tab_lane.device
    spec = {"tab_lane": (tab_lane, torch.float32),
            "idx": (idx, torch.int32), "fr": (fr, torch.float32),
            "fi": (fi, torch.float32), "tv": (tv, torch.float32),
            "frac": (frac, torch.float32)}
    for name, (x, dt) in spec.items():
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"insert_update: {name} is {x.dtype} on "
                             f"{x.device}, expected {dt} on {dev}")
    if tab_lane.ndim != 2 or tab_lane.shape[0] != 24:
        raise ValueError(f"insert_update: table must be (24, R_pad), got "
                         f"{tuple(tab_lane.shape)}")
    if not is_channel_minor(tab_lane):
        raise ValueError(f"insert_update: table must be channel-minor "
                         f"(new_table: strides (1, 24), 16-byte aligned), "
                         f"got strides {tab_lane.stride()}")
    if (idx.shape != (n,) or fr.shape != (n,) or fi.shape != (n,)
            or tv.shape != (n,) or tuple(frac.shape) != (n, 3)):
        raise ValueError("insert_update: sample arrays must be (N,) and "
                         "frac (N, 3)")


def insert_update(tab_lane, idx, fr, fi, tv, frac):
    """K2: add the samples' trilinear corner rows into ``tab_lane``.

    tab_lane: (24, R_pad) f32 from ``new_table``; idx: (N,) int32 rows;
    fr/fi/tv: (N,) f32; frac: (N, 3) f32 fractional (z, y, x). Updates
    in place, returns it. The kernel's atomic adds land in a run-dependent
    order, so results match the plain version up to f32 reassociation."""
    _check_insert_inputs(tab_lane, idx, fr, fi, tv, frac)
    if tab_lane.device.type == "cpu":
        return insert_update_plain(tab_lane, idx, fr, fi, tv, frac)
    if tab_lane.device.type != "cuda":
        raise ValueError(f"insert_update: unsupported device "
                         f"{tab_lane.device}")
    from .. import cuda_build

    n = idx.shape[0]
    if n == 0:
        return tab_lane
    idx_c, fr_c, fi_c, tv_c, frac_c = (x.contiguous() for x in
                                       (idx, fr, fi, tv, frac))
    lib = cuda_build.library()
    LAUNCHES["insert_update"] += 1
    code = lib.thunder_insert_update(
        tab_lane.data_ptr(), tab_lane.shape[1], idx_c.data_ptr(),
        fr_c.data_ptr(), fi_c.data_ptr(), tv_c.data_ptr(), frac_c.data_ptr(),
        n, cuda_build.stream_ptr(tab_lane.device))
    cuda_build.check(code, "insert_update")
    return tab_lane
