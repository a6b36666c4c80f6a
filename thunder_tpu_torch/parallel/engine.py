"""The refinement programs on one GPU (port of ``thunder_tpu.parallel.
engine``).

The JAX engine runs each stage as a ``shard_map`` over a (half, data)
mesh. Here the half axis is a leading dimension of size 2 of every
per-image tensor — (2, S, ...), plane 0 = hemisphere A, plane 1 = B — on
one device, and the data-axis ``psum`` of a multi-process run is the
optimiser's all-reduce of what these functions return (each rank passes
its own slots). Brick tables arrive as one (2, K, hz,
mc, mc, C) stack of Hermitian half-space tables (3D) or (2, K, mc, mc, C)
bilinear tables (2D classification); an image's class and half select its
table inside one fused row gather.

Random draws are tensors passed in by the caller (the optimiser draws them
from a ``torch.Generator``; the parity tests replay ``jax.random``):

- ``scan_init``: Gumbel noise (2, S, K) and two resample uniforms (2, S),
- ``local_search``: a callable ``phase -> dict`` of per-phase draws,
- ``insert_fold_reduce``: support indices ri/ti (2, S, n_draw).

With K > 1 classes the insert is class-fused: every sample's row is offset
by ``cls * n_vox`` into one (K n_vox + 1)-row accumulator (the last row
drops out-of-band samples), and outputs carry a class axis. Each insert
adds an image's DC draws to its class's centre row once, as their sum
(``dc_draw_weights``): the same function as the JAX insert, in another add
order that keeps K2's f32 table at its exact sum. The 2D insert (width-12
rows) and the 3D MKB insert (8 width-24 rows a sample,
``insert_kernel="mkb"``) have no Pallas kernel in the JAX package either:
they add with ``index_add_`` (``add_rows``), as its XLA row scatter does.
"""

import functools

import torch

from ..dtypes import real_dtype
from ..geom import quat
from ..ops.brick import _corners2, fold_insert2
from ..ops import brick, likelihood
from ..ops import ctf as ctf_ops
from ..ops.insert import insert_update, new_table, rows_pad
from ..ops.translate import translation_phase
from ..core import particle, projector
from . import distributed

CTF_FIELDS = ("voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
              "amp_contrast", "phase_shift")

# samples (images x poses x pixels) per fused gather in the phase loop:
# bounds the (samples, 8)-row temporaries to ~1 GB
GATHER_BUDGET = 1 << 25


def _flat_tables(bricks):
    """(2, K, hz, mc, mc, C) half-space tables -> (flat (2 K n_vox, C),
    mc, n_vox), n_vox = hz mc mc the rows of one table: hz = mc // 2 + 1
    for the odd crop, mc // 2 where the band's crop is clipped to the even
    padded box (a band near Nyquist). 2D tables (2, K, mc, mc, C) have
    n_vox = mc mc."""
    mc = bricks.shape[-2]
    if bricks.ndim == 5:
        return bricks.reshape(-1, bricks.shape[-1]), mc, mc * mc
    if bricks.shape[-4] == mc:
        raise ValueError(
            "engine: 3D brick tables are gathered in the Hermitian half-space "
            "layout; build them with half=True")
    n_vox = bricks.shape[-4] * mc * mc
    return bricks.reshape(-1, bricks.shape[-1]), mc, n_vox


def fused_class_gather(flat, coords, table, mc, n_vox):
    """Gather each image's slices from ITS table (half and class folded
    into ``table`` (B,)): with the conjugate-mirror fetch of the 3D
    half-space layout for coords (B, ..., 3), bilinear for 2D coords
    (B, ..., 2). Returns (B, ...) complex64."""
    if coords.shape[-1] == 2:
        idx, w_c, valid = _corners2(coords, mc)
        sgn = 1.0
    else:
        idx, w_c, valid, sgn = brick._corners3_half(coords, mc)
    idx = torch.where(valid, idx, torch.zeros_like(idx)) + (
        table.long() * n_vox).reshape((-1,) + (1,) * (idx.ndim - 1))
    rows = flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))
    re, im = brick.interp_rows(rows, w_c, n_corner=w_c.shape[-1])
    out = torch.complex(re, im * sgn)
    return torch.where(valid, out, torch.zeros_like(out))


def _rot_mats(r_sup, mode):
    """Support rotations -> matrices; 2D keeps (cos phi, sin phi) of the
    in-plane angle in the first two slots."""
    return quat.rotate2d_vec(r_sup) if mode == "2d" else quat.rotate3d(r_sup)


def _slice_coords(rots, col, row, pf):
    if rots.shape[-1] == 2:
        return projector.slice_coords_2d(rots, col, row, pf=pf)
    return projector.slice_coords_3d(rots, col, row, pf=pf)


def _table_index(cls, k_classes):
    """(2, S) classes -> (2, S) table index h * K + c."""
    h = torch.arange(2, device=cls.device)[:, None]
    return h * k_classes + cls.long()


# ------------------------------------------------------------- global scan

def scan_init(bricks, rots, quats, tra, trans, col, row, pmask, dat, ctf,
              sig_rcp, gumbel, u0_r, u0_t, *, pf, m_l_r, m_l_t, m_l_d,
              chunk, mode="3d"):
    """Phase A: every image against every scan pose of its half's class
    references, then the particle-filter seeding (src/Optimiser.cpp:
    633-1136).

    bricks: (2, K, ...) tables; rots (R, 3, 3), or (R, 2, 2) in-plane
    rotations in 2D mode; quats (R, 4); tra (T, P);
    trans (T, 2); dat/ctf/sig_rcp (2, S, P); gumbel (2, S, K); u0_r/u0_t
    (2, S). The scan runs through kernel K1 (``likelihood.scan_fused``).
    Returns (state (2, S, ...), wC (2, S, K))."""
    k_cls = bricks.shape[1]
    s = dat.shape[1]
    project = (projector.project_brick_2d if mode == "2d"
               else projector.project_brick_3d)
    halves, wcs = [], []
    for h in range(2):
        proj = torch.stack([project(bricks[h, k], rots, col, row, pf=pf)
                            for k in range(k_cls)])  # (K, R, P)
        parts, wc_parts = [], []
        for s0 in range(0, s, chunk):
            sl = slice(s0, min(s, s0 + chunk))
            out = likelihood.global_search_weights_fused(
                dat[h, sl], ctf[h, sl], sig_rcp[h, sl], proj, tra,
                pixel_mask=pmask)
            parts.append(particle.init_from_scan(
                out["wC"], out["wR"], out["wT"], quats, trans, m_l_r, m_l_t,
                m_l_d, gumbel[h, sl], u0_r[h, sl], u0_t[h, sl], mode=mode))
            wc_parts.append(out["wC"])
        halves.append({key: torch.cat([p[key] for p in parts])
                       for key in parts[0]})
        wcs.append(torch.cat(wc_parts))
    st = {key: torch.stack([halves[0][key], halves[1][key]])
          for key in halves[0]}
    return st, torch.stack(wcs)


# ------------------------------------------------------------ local search

def pack_ctf(cp):
    """CTF parameter dict of (...,) tensors -> (..., 7) packed tensor."""
    return torch.stack([cp[f].to(real_dtype) for f in CTF_FIELDS], dim=-1)


def _phase_step(st, dat, ctf, sig_rcp, table, dr, flat, mc, n_vox, col, row,
                pmask, sym_quats, factor, pf, n, mode, phase, ctf_search):
    """One phase for a batch of ACTIVE images (flattened batch axis):
    perturb -> fused-class projection -> block log-sum-exp -> posterior
    update. ``ctf_search`` (cp (B, 7) packed CTF parameters, factor_d,
    pixel_size) adds the defocus axis: d perturbed from phase 1 on, the
    CTF at every defocus point, pfD set at phase 0. Returns (new state,
    shrank (B,) bool)."""
    if mode == "2d":
        r = particle.perturb_r_2d(st["r"], st["k1"], factor, dr)
    else:
        r = particle.perturb_r(st["r"], st["k1"], st["k2"], st["k3"], factor,
                               dr["normals_r"], sym_quats=sym_quats)
    t = particle.perturb_t(st["t"], st["s0"], st["s1"], factor,
                           dr["normals_t"])
    st = {**st, "r": r, "t": t}
    ctf_d = u0_d = None
    if ctf_search is not None:
        cp, factor_d, pixel_size = ctf_search
        if phase > 0:
            # the phase-0 support is the loaded one (src/Optimiser.cpp:
            # 1191-1209)
            st["d"] = particle.perturb_d(st["d"], st["sD"], factor_d,
                                         dr["normals_d"])
        ctf_d = ctf_ops.ctf_pixels(
            col, row, n, pixel_size, *(cp[:, i:i + 1] for i in range(7)),
            defocus_factor=st["d"])                          # (B, nD, P)
        u0_d = dr["u0_d"]
    coords = _slice_coords(_rot_mats(r, mode), col, row, pf)
    proj = fused_class_gather(flat, coords, table, mc, n_vox)
    tra = translation_phase(col, row, t[..., 0], t[..., 1], n)
    u_r, u_t, u_d = likelihood.local_search_weights(
        dat, ctf, sig_rcp, proj, tra, st["wR"], st["wT"],
        w_d=st["wD"] if ctf_d is not None else None, ctf_d=ctf_d,
        pixel_mask=pmask)
    if ctf_d is None:
        u_d = None
    elif phase == 0:
        # setPeakFactor of the defocus support (src/Optimiser.cpp:1430)
        st["pfD"] = particle.cal_peak_factor(
            u_d, particle.peak_idx_d(u_d.shape[-1]))
    new = particle.update_from_likelihood(
        st, u_r, u_t, dr["u0_r"], dr["u0_t"], dr.get("anchor"),
        sym_quats=sym_quats, mode=mode, u_d=u_d, u0_d=u0_d)
    return new, particle.vari_shrank(new, st, mode=mode)


def local_search(bricks, col, row, pmask, dat, ctf, sig_rcp, state,
                 phase_draws, sym_quats, factor_l, factor_s, *, pf, n,
                 min_phase, max_phase=particle.MAX_N_PHASE_PER_ITER,
                 mode="3d", cp=None, factor_d=0.0, pixel_size=None):
    """Phase B: the particle-filter phase loop with the reference's
    termination rule (src/Optimiser.cpp:1138-1660), all images of both
    halves batched; finished images drop out of later phases (their state
    is frozen, as in the JAX while_loop). In a multi-process run the loop
    ends when no rank has an active image, and every rank takes each
    phase's draws, so that the ranks stay in step with one another and
    with a single-process run.

    state: particle dict (2, S, ...); phase_draws(phase) -> dict with
    normals_r (2, S, nR, 4), normals_t (2, S, nT, 2), u0_r, u0_t (2, S),
    anchor (2, S); in 2D mode the von Mises uniforms u_z, u_2 (2, S,
    ROUNDS, nR), u_s, theta (2, S, nR) replace normals_r and anchor.
    ``cp`` (2, S, 7) packed CTF parameters (``pack_ctf``) make the round a
    CTF search: the defocus support d (2, S, nD) is perturbed by
    ``factor_d`` sD with the draws' normals_d (2, S, nD), the CTF is
    evaluated per defocus point at ``pixel_size``, and d is resampled
    with u0_d (2, S).
    Returns (state, phases run per image (2, S))."""
    flat, mc, n_vox = _flat_tables(bricks)
    k_cls = bricks.shape[1]
    two, s = dat.shape[:2]
    nb = two * s
    fl = lambda x: x.reshape((nb,) + x.shape[2:])
    st = {k: fl(v).clone() for k, v in state.items()}
    table = fl(_table_index(state["c"], k_cls))
    d_f, c_f, s_f = fl(dat), fl(ctf), fl(sig_rcp)
    cp_f = None if cp is None else fl(cp)
    n_r = st["r"].shape[1]
    per_img = n_r * col.shape[0]
    sub = max(1, GATHER_BUDGET // per_img)
    dev = dat.device
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    no_dec = torch.zeros(nb, dtype=torch.int32, device=dev)
    nph = torch.zeros(nb, dtype=torch.int32, device=dev)
    phase = 0
    while phase < max_phase:
        act = torch.nonzero(~done)[:, 0]
        if int(distributed.all_reduce_sum(torch.tensor(act.numel()))) == 0:
            break
        dr = {k: fl(v) for k, v in phase_draws(phase).items()}
        factor = factor_l if phase == 0 else factor_s
        shrank = torch.empty(act.shape[0], dtype=torch.bool, device=dev)
        for a0 in range(0, act.shape[0], sub):
            ix = act[a0:a0 + sub]
            new, shr = _phase_step(
                {k: v[ix] for k, v in st.items()}, d_f[ix], c_f[ix],
                s_f[ix], table[ix], {k: v[ix] for k, v in dr.items()},
                flat, mc, n_vox, col, row, pmask, sym_quats, factor, pf, n,
                mode, phase,
                None if cp_f is None else (cp_f[ix], factor_d, pixel_size))
            for k, v in new.items():
                st[k][ix] = v
            shrank[a0:a0 + sub] = shr
        if phase >= min_phase:
            nd = no_dec[act]
            no_dec[act] = torch.where(shrank, torch.zeros_like(nd), nd + 1)
            new_done = done | (no_dec >= particle.N_PHASE_WITH_NO_VARI_DECREASE)
            nph = torch.where(new_done & ~done,
                              torch.full_like(nph, phase + 1), nph)
            done = new_done
        phase += 1
    nph = torch.where(done, nph, torch.full_like(nph, min(phase, max_phase)))
    unfl = lambda x: x.reshape((two, s) + x.shape[1:])
    return {k: unfl(v) for k, v in st.items()}, unfl(nph)


# --------------------------------------------------------- gridding insert

def insert_fold_reduce(col, row, pmask, dat_ori, ctf, state, ri, ti, w_img,
                       tra_off, *, pf, n, mc, chunk, k_classes=1,
                       mode="3d", insert_kernel="trilinear", blob_a=1.9,
                       alpha=15.0):
    """M-step gridding insert (Optimiser::reconstructRef draws mReco
    support points per image, src/Optimiser.cpp:6711+): for each half,
    every image's ``n_draw`` support draws ri/ti (2, S, n_draw) are inserted
    into its class's block of one class-fused accumulator, which is then
    folded to voxels (pixels in 2D) class by class with the deferred
    Hermitian mirror. 3D trilinear inserts go through kernel K2 into a
    channel-minor table (``new_table``); ``insert_kernel="mkb"`` (3D only)
    adds the MKB blob's 8 rows a sample (radius ``blob_a`` padded voxels,
    shape ``alpha``) into a row-major (K mc^3 + 1, 24) table with
    ``index_add_`` (``_insert_chunk_mkb``), folded by
    ``brick.fold_insert3``. Symmetrisation is applied afterwards
    (``symmetrize_halves``). 2D adds width-12 rows with ``index_add_``.

    dat_ori (2, S, P) UNMASKED pixels; ctf (2, S, P); state r/t/c;
    w_img (2, S) insertion weights (0 on invalid slots); tra_off (2, S, 2)
    re-centring offsets. Returns (F (2, mc^d..) complex64, T (2, mc^d..),
    offsets (2, K, 4) = [sum dir, count] per class); F and T carry a class
    axis (2, K, mc^d..) when ``k_classes`` > 1."""
    dev = dat_ori.device
    dims = 2 if mode == "2d" else 3
    mkb = insert_kernel == "mkb" and dims == 3
    n_vox = mc ** dims
    s = dat_ori.shape[1]
    fs, ts, offs = [], [], []
    for h in range(2):
        if dims == 2 or mkb:
            tab = torch.zeros((k_classes * n_vox + 1, 12 if dims == 2 else 24),
                              dtype=torch.float32, device=dev)
        else:
            tab = new_table(rows_pad(k_classes * n_vox + 1), device=dev)
        off = torch.zeros((k_classes, 4), dtype=real_dtype, device=dev)
        if dims == 2:
            insert = _insert_chunk_2d
        elif mkb:
            insert = functools.partial(_insert_chunk_mkb, blob_a=blob_a,
                                       alpha=alpha)
        else:
            insert = _insert_chunk
        for s0 in range(0, s, chunk):
            sl = slice(s0, min(s, s0 + chunk))
            cls = state["c"][h, sl].long()
            o_img = insert(
                tab, col, row, pmask, dat_ori[h, sl], ctf[h, sl],
                w_img[h, sl], state["r"][h, sl], state["t"][h, sl],
                ri[h, sl], ti[h, sl], tra_off[h, sl], pf=pf, n=n, mc=mc,
                cls=cls, k_classes=k_classes)
            off.index_add_(0, cls, o_img)
        if dims == 2 or mkb:
            # each class block with the next row standing in for the drop
            # row, which the fold ignores
            fold = fold_insert2 if dims == 2 else brick.fold_insert3
            parts = [fold(tab[kc * n_vox:(kc + 1) * n_vox + 1])
                     for kc in range(k_classes)]
        else:
            parts = [brick.fold_insert3_lane(tab[:, kc * n_vox:], mc)
                     for kc in range(k_classes)]
        del tab
        fs.append(torch.stack([p[0] for p in parts]))
        ts.append(torch.stack([p[1] for p in parts]))
        offs.append(off)
    f, t = torch.stack(fs), torch.stack(ts)
    if k_classes == 1:
        f, t = f[:, 0], t[:, 0]
    return f, t, torch.stack(offs)


def dc_draw_weights(col, row, n_draw):
    """(D, P) per-draw sample weights that add each image's DC pixel once.

    A pixel at col = row = 0 lands on the centre voxel with frac 0 and a
    translation ramp of exactly 1 whatever the pose, so its D draws carry
    one identical value. Summed one at a time into an f32 row, that value
    rounds the same way on every add and the error grows with the count
    (12,800 at 256 particles and 100 draws). Weight D on draw 0 and 0 on
    the others gives the same sum, formed with one rounding; K2 skips the
    zero rows. Every other pixel keeps weight 1. All draws of an image go
    to its own class's block, so the merged sum lands on that class's
    centre row."""
    dc = (col == 0) & (row == 0)
    first = torch.arange(n_draw, device=col.device)[:, None] == 0
    w = torch.where(first, float(n_draw), 0.0)
    return torch.where(dc[None, :], w, torch.ones_like(w)).to(real_dtype)


def _draw_poses(r_sup, t_sup, ri, ti, t_off, w, mode):
    """The drawn support poses of a chunk: (rotation matrices (B, D, d, d),
    t_rel (B, D, 2) = translation - offset, per-image re-centring sums
    (B, 4) = [sum dir, count], dir = -rot (t_rel, 0))."""
    q_d = particle._take(r_sup, ri.long())                 # (B, D, 4)
    t_d = particle._take(t_sup, ti.long())                 # (B, D, 2)
    t_rel = t_d - t_off[:, None, :]
    rots = _rot_mats(q_d, mode)
    if mode == "2d":
        dirv = -torch.einsum("bnij,bnj->bni", rots, t_rel)
        dirv = torch.cat([dirv, torch.zeros_like(dirv[..., :1])], -1)
    else:
        t3 = torch.cat([t_rel, torch.zeros_like(t_rel[..., :1])], -1)
        dirv = -torch.einsum("bnij,bnj->bni", rots, t3)
    cnt = (w > 0)[:, None].expand(dirv.shape[:2]).to(real_dtype)
    o_add = torch.cat([dirv * cnt[..., None], cnt[..., None]], -1)
    return rots, t_rel, o_add.sum(dim=1)


def _sample_values(col, row, pmask, d, c, w, t_rel, n, draw_w):
    """Pose-weighted values of a chunk's samples: fv (B, D, P) complex,
    tv (B, D | 1, P)."""
    tra = translation_phase(col, row, -t_rel[..., 0], -t_rel[..., 1],
                            n)                             # (B, D, P)
    pw = pmask if draw_w is None else pmask * draw_w       # (P,) | (D, P)
    wv = (w[:, None, None] * pw).to(real_dtype)            # (B, 1 | D, P)
    fv = d[:, None, :] * tra * c[:, None, :] * wv
    tv = (c[:, None, :] ** 2) * wv
    return fv, tv


def chunk_samples(col, row, pmask, d, c, w, r_sup, t_sup, ri, ti, t_off, *,
                  pf, n, mc, draw_w=None, cls=None, k_classes=1):
    """One chunk of images' support draws as flat K2 samples.

    Returns (idx (N,) int32, fr, fi, tv (N,) f32, frac (N, 3) f32, o_img
    (B, 4) per-image [sum dir, count] re-centring sums), N = B D P in
    (image, draw, pixel) order. ``cls`` (B,) offsets each image's rows by
    ``cls * mc^3`` into a ``k_classes``-fold table whose drop row is
    ``k_classes * mc^3``. ``draw_w`` (D, P) multiplies every sample's
    values (``dc_draw_weights``); None inserts every draw as it is, as the
    JAX insert does."""
    n_vox = mc ** 3
    rots, t_rel, o_img = _draw_poses(r_sup, t_sup, ri, ti, t_off, w, "3d")
    coords = projector.slice_coords_3d(rots, col, row, pf=pf)
    fv, tv = _sample_values(col, row, pmask, d, c, w, t_rel, n, draw_w)
    tv = tv.expand(fv.shape)
    base = torch.floor(coords)
    bi = base.to(torch.int64) + mc // 2
    idx = (bi[..., 0] * mc + bi[..., 1]) * mc + bi[..., 2]
    if cls is not None:
        idx = idx + (cls.long() * n_vox)[:, None, None]
    valid = torch.all((bi >= 0) & (bi < mc - 1), dim=-1)
    idx = torch.where(valid, idx, torch.full_like(idx, k_classes * n_vox))
    frac = (coords - base).float()
    return (idx.reshape(-1).to(torch.int32), fv.real.reshape(-1).contiguous(),
            fv.imag.reshape(-1).contiguous(), tv.reshape(-1).contiguous(),
            frac.reshape(-1, 3), o_img)


def _insert_chunk(tab, col, row, pmask, d, c, w, r_sup, t_sup, ri, ti,
                  t_off, *, pf, n, mc, cls=None, k_classes=1):
    """Insert one chunk of images' support draws into ``tab`` with K2,
    each image's DC draws added once (``dc_draw_weights``); returns the
    chunk's (B, 4) per-image [sum dir, count] re-centring sums. Its sample
    temporaries are freed on return, before the fold."""
    *samples, o_img = chunk_samples(
        col, row, pmask, d, c, w, r_sup, t_sup, ri, ti, t_off, pf=pf, n=n,
        mc=mc, draw_w=dc_draw_weights(col, row, ri.shape[1]), cls=cls,
        k_classes=k_classes)
    insert_update(tab, *samples)
    return o_img


def add_rows(tab, idx, rows):
    """tab[idx[i]] += rows[i]: ``index_add_``, the JAX package's XLA row
    scatter, for the MKB insert."""
    tab.index_add_(0, idx, rows)


def _insert_chunk_mkb(tab, col, row, pmask, d, c, w, r_sup, t_sup, ri, ti,
                      t_off, *, pf, n, mc, cls, k_classes, blob_a, alpha):
    """Insert one chunk of images' support draws with the MKB blob kernel
    (RECONSTRUCTOR_MKB_KERNEL, src/Reconstructor.cpp:452-556): each sample
    adds the 8 brick rows of its 4^3 support (``brick.mkb_rows3``) into
    its class's block of the row-major (K mc^3 + 1, 24) table, out-of-band
    rows into the drop row; one ``add_rows`` a row set, the 8 sets built
    one at a time. Each image's DC draws are added once
    (``dc_draw_weights``). Returns the (B, 4) re-centring sums."""
    n_vox = mc ** 3
    rots, t_rel, o_img = _draw_poses(r_sup, t_sup, ri, ti, t_off, w, "3d")
    coords = projector.slice_coords_3d(rots, col, row, pf=pf)
    fv, tv = _sample_values(col, row, pmask, d, c, w, t_rel, n,
                            dc_draw_weights(col, row, ri.shape[1]))
    tv = tv.expand(fv.shape)
    b0, frac = brick.mkb_base(coords, mc)
    del coords
    cls_off = (cls.long() * n_vox)[:, None, None]
    drop = torch.full((), k_classes * n_vox, dtype=torch.int64,
                      device=tab.device)
    for off3 in brick.MKB_ROW_OFFSETS:
        idx, w8, valid = brick.mkb_row3(b0, frac, mc, off3, blob_a, alpha)
        idx = torch.where(valid, idx + cls_off, drop).reshape(-1)
        rows = brick.insert_rows(w8, fv, tv)
        del w8, valid
        add_rows(tab, idx, rows)
        del idx, rows
    return o_img


def _insert_chunk_2d(tab, col, row, pmask, d, c, w, r_sup, t_sup, ri, ti,
                     t_off, *, pf, n, mc, cls, k_classes):
    """The 2D counterpart of ``_insert_chunk``: bilinear width-12 rows
    added into the (K mc^2 + 1, 12) accumulator with ``index_add_`` (the
    JAX package's XLA row scatter), each image's DC draws added once.
    Returns the (B, 4) per-image re-centring sums."""
    n_vox = mc * mc
    rots, t_rel, o_img = _draw_poses(r_sup, t_sup, ri, ti, t_off, w, "2d")
    coords = projector.slice_coords_2d(rots, col, row, pf=pf)
    fv, tv = _sample_values(col, row, pmask, d, c, w, t_rel, n,
                            dc_draw_weights(col, row, ri.shape[1]))
    idx, w4, valid = _corners2(coords, mc)
    idx = idx + (cls.long() * n_vox)[:, None, None]
    idx = torch.where(valid, idx, torch.full_like(idx, k_classes * n_vox))
    tab.index_add_(0, idx.reshape(-1),
                   brick.insert_rows(w4, fv, tv.expand(fv.shape)))
    return o_img


def symmetrize_halves(f, t, exact_ops, general_rots, *, pf, r_u):
    """Point-group symmetrisation of per-half folded (F, T)
    (Reconstructor::symmetrizeF/T, src/Reconstructor.cpp:2676-2692):
    grid-exact rotations (``exact_ops``) as transposes and flips, the
    general ones (``general_rots`` (G, 3, 3)) by trilinear gathers from
    the ORIGINAL arrays, F <- exact(F) + (cropped(F) - F)."""
    from ..core import reconstructor

    fs, ts = [], []
    for h in range(2):
        f_c, t_c = reconstructor.symmetrize_exact(f[h], t[h], exact_ops, r_u,
                                                  pf=pf)
        if len(general_rots):
            f_g, t_g = reconstructor.symmetrize_cropped(
                f[h], t[h], general_rots, r_u, pf=pf)
            f_c = f_c + (f_g - f[h])
            t_c = t_c + (t_g - t[h])
        fs.append(f_c)
        ts.append(t_c)
    return torch.stack(fs), torch.stack(ts)


def reconstruct_halves(f, t, fsc, w0, r_u, *, pf, n, join_half=False,
                       warm=False, blob_a=1.9, blob_alpha=15.0, dims=3,
                       insert_kernel="trilinear"):
    """Per-half Wiener/C-balance reconstruction. f/t/w0: (2, mc^d..);
    returns (maps (2, n^d..), converged weights (2, mc^d..))."""
    from ..core import reconstructor

    vols, ws = [], []
    for h in range(2):
        v, w = reconstructor.reconstruct_cropped(
            f[h], t[h], fsc, n, pf=pf, max_radius=r_u, join_half=join_half,
            blob_a=blob_a, blob_alpha=blob_alpha,
            w_init=w0[h] if warm else None, return_w=True, dims=dims,
            insert_kernel=insert_kernel)
        vols.append(v)
        ws.append(w)
    return torch.stack(vols), torch.stack(ws)


# -------------------------------------------------------- M-step statistics

def residual_stats(bricks, col, row, sig_idx, pmask, dat, dat_ori, ctf,
                   state, groups, valid, tra_off, *, pf, n, n_groups,
                   n_shell):
    """Rank-1-pose residual statistics (allReduceSigma
    src/Optimiser.cpp:6397, refreshScale :5749, normCorrection :6201).

    Returns sig (G, n_shell) / cnt (G,) group sums of |datOri - ctf pri|^2,
    xa/aa (G, n_shell) scale-fit terms, norm (2, S, n_shell) per-image
    masked-stack residual shells, ori (2, S, n_shell, 3) per-image
    [|datOri|^2, Re(datOri conj(ctf pri)), |ctf pri|^2] shells."""
    flat, mc, n_vox = _flat_tables(bricks)
    k_cls = bricks.shape[1]
    mode = "2d" if bricks.ndim == 5 else "3d"
    two, s, p = dat.shape
    nb = two * s
    fl = lambda x: x.reshape((nb,) + x.shape[2:])
    table = fl(_table_index(state["c"], k_cls))
    coords = _slice_coords(_rot_mats(fl(state["topR"]), mode)[:, None], col,
                           row, pf)
    pri = fused_class_gather(flat, coords, table, mc, n_vox)[:, 0]
    topt = fl(state["topT"])
    t_o = topt - fl(tra_off)
    tra_o = translation_phase(col, row, t_o[:, 0], t_o[:, 1], n)
    tra_m = translation_phase(col, row, topt[:, 0], topt[:, 1], n)
    v = fl(valid)
    c = fl(ctf)
    d, d_o = fl(dat), fl(dat_ori)
    pm = pmask * v[:, None]
    res_o = torch.abs(d_o - c * pri * tra_o) ** 2 * pm
    res_m = torch.abs(d - c * pri * tra_m) ** 2 * pm
    cp_o = c * pri * tra_o
    dd_l = (d_o.real ** 2 + d_o.imag ** 2) * pm
    xa_l = (torch.conj(d_o) * cp_o).real * pm
    aa_l = (cp_o.real ** 2 + cp_o.imag ** 2) * pm
    sig_idx = sig_idx.long()

    def to_shell(x):
        z = torch.zeros(x.shape[:-1] + (n_shell,), dtype=torch.float32,
                        device=x.device)
        return z.index_add_(-1, sig_idx, x)

    sh_o, sh_m, sh_xa, sh_aa = map(to_shell, (res_o, res_m, xa_l, aa_l))
    g = fl(groups).long()

    def grp(x):
        z = torch.zeros((n_groups,) + x.shape[1:], dtype=torch.float32,
                        device=x.device)
        return z.index_add_(0, g, x)

    ori = torch.stack([to_shell(dd_l), sh_xa, sh_aa], -1)
    unfl = lambda x: x.reshape((two, s) + x.shape[1:])
    return (grp(sh_o), grp(v), grp(sh_xa), grp(sh_aa), unfl(sh_m),
            unfl(ori))


def sigma_rescaled(ori, fac, groups, valid, *, n_groups):
    """Per-group sigma shell sums AFTER a per-image rescale, from
    ``residual_stats``' per-image ori shells: sig_g = sum_{l in g} fac_l^2
    dd_l - 2 fac_l xa_l + aa_l, the same as re-measuring |fac datOri - ctf
    pri|^2 (allReduceSigma after normCorrection, src/Optimiser.cpp:
    3405-3419) without a second projection pass. Where the projection fits
    the data (high-SNR shells) the three terms cancel, so they are combined
    and summed in float64.

    ori: (2, S, n_shell, 3); fac/groups/valid: (2, S). Returns float64
    ((G, n_shell), (G,))."""
    f = fac.double()[..., None]
    o = ori.double()
    v = valid.double()
    sig_img = ((f * f * o[..., 0] - 2.0 * f * o[..., 1] + o[..., 2])
               * v[..., None])
    g = groups.reshape(-1).long()
    n_shell = o.shape[-2]
    sig = torch.zeros((n_groups, n_shell), dtype=torch.float64,
                      device=o.device).index_add_(
        0, g, sig_img.reshape(-1, n_shell))
    cnt = torch.zeros(n_groups, dtype=torch.float64,
                      device=o.device).index_add_(0, g, v.reshape(-1))
    return sig, cnt
