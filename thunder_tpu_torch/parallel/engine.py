"""The refinement programs on one GPU (port of ``thunder_tpu.parallel.
engine``).

The JAX engine runs each stage as a ``shard_map`` over a (half, data)
mesh. On one GPU the half axis is a leading dimension of size 2 of every
per-image tensor — (2, S, ...), plane 0 = hemisphere A, plane 1 = B — and
the data-axis ``psum`` disappears. Brick tables arrive as one (2, K, hz,
mc, mc, C) stack of Hermitian half-space tables; an image's class and
half select its table inside one fused row gather.

Random draws are tensors passed in by the caller (the optimiser draws them
from a ``torch.Generator``; the parity tests replay ``jax.random``):

- ``scan_init``: Gumbel noise (2, S, K) and two resample uniforms (2, S),
- ``local_search``: a callable ``phase -> dict`` of per-phase draws,
- ``insert_fold_reduce``: support indices ri/ti (2, S, n_draw).
"""

import torch

from ..dtypes import real_dtype
from ..geom import quat
from ..ops import brick, likelihood
from ..ops.insert import insert_update, new_table, rows_pad
from ..ops.translate import translation_phase
from ..core import particle, projector

# samples (images x poses x pixels) per fused gather in the phase loop:
# bounds the (samples, 8)-row temporaries to ~1 GB
GATHER_BUDGET = 1 << 25


def _flat_tables(bricks):
    """(2, K, hz, mc, mc, C) half-space tables -> (flat (2 K n_vox, C),
    mc, n_vox)."""
    mc = bricks.shape[-2]
    if bricks.shape[-4] == mc:
        raise NotImplementedError(
            "engine: full-space 3D brick tables are not ported (half=True)")
    n_vox = brick.half_rows(mc) * mc * mc
    return bricks.reshape(-1, bricks.shape[-1]), mc, n_vox


def fused_class_gather(flat, coords, table, mc, n_vox):
    """Gather each image's slices from ITS table (half and class folded
    into ``table`` (B,)) with the conjugate-mirror fetch of the half-space
    layout. coords: (B, ..., 3) -> (B, ...) complex64."""
    idx, w8, valid, sgn = brick._corners3_half(coords, mc)
    idx = torch.where(valid, idx, torch.zeros_like(idx)) + (
        table.long() * n_vox).reshape((-1,) + (1,) * (idx.ndim - 1))
    rows = flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))
    re, im = brick.interp_rows(rows, w8)
    out = torch.complex(re, im * sgn)
    return torch.where(valid, out, torch.zeros_like(out))


def _table_index(cls, k_classes):
    """(2, S) classes -> (2, S) table index h * K + c."""
    h = torch.arange(2, device=cls.device)[:, None]
    return h * k_classes + cls.long()


# ------------------------------------------------------------- global scan

def scan_init(bricks, rots, quats, tra, trans, col, row, pmask, dat, ctf,
              sig_rcp, gumbel, u0_r, u0_t, *, pf, m_l_r, m_l_t, m_l_d,
              chunk):
    """Phase A: every image against every scan pose of its half's class
    references, then the particle-filter seeding (src/Optimiser.cpp:
    633-1136).

    bricks: (2, K, ...) tables; rots (R, 3, 3); quats (R, 4); tra (T, P);
    trans (T, 2); dat/ctf/sig_rcp (2, S, P); gumbel (2, S, K); u0_r/u0_t
    (2, S). The scan runs through kernel K1 (``likelihood.scan_fused``).
    Returns (state (2, S, ...), wC (2, S, K))."""
    k_cls = bricks.shape[1]
    s = dat.shape[1]
    halves, wcs = [], []
    for h in range(2):
        proj = torch.stack([projector.project_brick_3d(bricks[h, k], rots,
                                                       col, row, pf=pf)
                            for k in range(k_cls)])  # (K, R, P)
        parts, wc_parts = [], []
        for s0 in range(0, s, chunk):
            sl = slice(s0, min(s, s0 + chunk))
            out = likelihood.global_search_weights_fused(
                dat[h, sl], ctf[h, sl], sig_rcp[h, sl], proj, tra,
                pixel_mask=pmask)
            parts.append(particle.init_from_scan(
                out["wC"], out["wR"], out["wT"], quats, trans, m_l_r, m_l_t,
                m_l_d, gumbel[h, sl], u0_r[h, sl], u0_t[h, sl]))
            wc_parts.append(out["wC"])
        halves.append({key: torch.cat([p[key] for p in parts])
                       for key in parts[0]})
        wcs.append(torch.cat(wc_parts))
    st = {key: torch.stack([halves[0][key], halves[1][key]])
          for key in halves[0]}
    return st, torch.stack(wcs)


# ------------------------------------------------------------ local search

def _phase_step(st, dat, ctf, sig_rcp, table, dr, flat, mc, n_vox, col, row,
                pmask, sym_quats, factor, pf, n):
    """One phase for a batch of ACTIVE images (flattened batch axis):
    perturb -> fused-class projection -> block log-sum-exp -> posterior
    update. Returns (new state, shrank (B,) bool)."""
    r = particle.perturb_r(st["r"], st["k1"], st["k2"], st["k3"], factor,
                           dr["normals_r"], sym_quats=sym_quats)
    t = particle.perturb_t(st["t"], st["s0"], st["s1"], factor,
                           dr["normals_t"])
    st = {**st, "r": r, "t": t}
    coords = projector.slice_coords_3d(quat.rotate3d(r), col, row, pf=pf)
    proj = fused_class_gather(flat, coords, table, mc, n_vox)
    tra = translation_phase(col, row, t[..., 0], t[..., 1], n)
    u_r, u_t = likelihood.local_search_weights(
        dat, ctf, sig_rcp, proj, tra, st["wR"], st["wT"], pixel_mask=pmask)
    new = particle.update_from_likelihood(
        st, u_r, u_t, dr["u0_r"], dr["u0_t"], dr["anchor"],
        sym_quats=sym_quats)
    return new, particle.vari_shrank(new, st)


def local_search(bricks, col, row, pmask, dat, ctf, sig_rcp, state,
                 phase_draws, sym_quats, factor_l, factor_s, *, pf, n,
                 min_phase, max_phase=particle.MAX_N_PHASE_PER_ITER):
    """Phase B: the particle-filter phase loop with the reference's
    termination rule (src/Optimiser.cpp:1138-1660), all images of both
    halves batched; finished images drop out of later phases (their state
    is frozen, as in the JAX while_loop).

    state: particle dict (2, S, ...); phase_draws(phase) -> dict with
    normals_r (2, S, nR, 4), normals_t (2, S, nT, 2), u0_r, u0_t (2, S),
    anchor (2, S). Returns (state, phases run per image (2, S))."""
    flat, mc, n_vox = _flat_tables(bricks)
    k_cls = bricks.shape[1]
    two, s = dat.shape[:2]
    nb = two * s
    fl = lambda x: x.reshape((nb,) + x.shape[2:])
    st = {k: fl(v).clone() for k, v in state.items()}
    table = fl(_table_index(state["c"], k_cls))
    d_f, c_f, s_f = fl(dat), fl(ctf), fl(sig_rcp)
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
        if act.numel() == 0:
            break
        dr = {k: fl(v) for k, v in phase_draws(phase).items()}
        factor = factor_l if phase == 0 else factor_s
        shrank = torch.empty(act.shape[0], dtype=torch.bool, device=dev)
        for a0 in range(0, act.shape[0], sub):
            ix = act[a0:a0 + sub]
            new, shr = _phase_step(
                {k: v[ix] for k, v in st.items()}, d_f[ix], c_f[ix],
                s_f[ix], table[ix], {k: v[ix] for k, v in dr.items()},
                flat, mc, n_vox, col, row, pmask, sym_quats, factor, pf, n)
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
                       tra_off, *, pf, n, mc, chunk):
    """M-step gridding insert (Optimiser::reconstructRef draws mReco
    support points per image, src/Optimiser.cpp:6711+): for each half,
    every image's ``n_draw`` support draws ri/ti (2, S, n_draw) are inserted
    with kernel K2 into a channel-minor brick accumulator, which is then
    folded to voxels with the deferred Hermitian mirror. One class (K = 1);
    symmetrisation is applied afterwards (``symmetrize_halves``).

    dat_ori (2, S, P) UNMASKED pixels; ctf (2, S, P); state r/t/c;
    w_img (2, S) insertion weights (0 on invalid slots); tra_off (2, S, 2)
    re-centring offsets. Returns (F (2, mc, mc, mc) complex64,
    T (2, mc, mc, mc), offsets (2, 1, 4) = [sum dir, count])."""
    if int(torch.max(state["c"])) > 0:
        raise NotImplementedError("engine.insert_fold_reduce: K > 1 "
                                  "(fused class insert) is not ported")
    dev = dat_ori.device
    n_vox = mc ** 3
    s = dat_ori.shape[1]
    fs, ts, offs = [], [], []
    for h in range(2):
        tab = new_table(rows_pad(n_vox + 1), device=dev)
        off = torch.zeros((1, 4), dtype=real_dtype, device=dev)
        for s0 in range(0, s, chunk):
            sl = slice(s0, min(s, s0 + chunk))
            off[0] += _insert_chunk(
                tab, col, row, pmask, dat_ori[h, sl], ctf[h, sl],
                w_img[h, sl], state["r"][h, sl], state["t"][h, sl],
                ri[h, sl], ti[h, sl], tra_off[h, sl], pf=pf, n=n, mc=mc)
        f_h, t_h = brick.fold_insert3_lane(tab, mc)
        fs.append(f_h)
        ts.append(t_h)
        offs.append(off)
    return torch.stack(fs), torch.stack(ts), torch.stack(offs)


def _insert_chunk(tab, col, row, pmask, d, c, w, r_sup, t_sup, ri, ti,
                  t_off, *, pf, n, mc):
    """Insert one chunk of images' support draws into ``tab`` with K2;
    returns the chunk's (4,) [sum dir, count] re-centring sums. Its sample
    temporaries are freed on return, before the fold."""
    n_vox = mc ** 3
    q_d = particle._take(r_sup, ri.long())                 # (B, D, 4)
    t_d = particle._take(t_sup, ti.long())                 # (B, D, 2)
    t_rel = t_d - t_off[:, None, :]
    rots = quat.rotate3d(q_d)                              # (B, D, 3, 3)
    t3 = torch.cat([t_rel, torch.zeros_like(t_rel[..., :1])], -1)
    dirv = -torch.einsum("bnij,bnj->bni", rots, t3)
    cnt = (w > 0)[:, None].expand(dirv.shape[:2]).to(real_dtype)
    o_add = torch.cat([dirv * cnt[..., None], cnt[..., None]], -1)
    coords = projector.slice_coords_3d(rots, col, row, pf=pf)
    tra = translation_phase(col, row, -t_rel[..., 0], -t_rel[..., 1],
                            n)                             # (B, D, P)
    wv = (w[:, None, None] * pmask).to(real_dtype)
    fv = d[:, None, :] * tra * c[:, None, :] * wv
    tv = ((c[:, None, :] ** 2) * wv).expand(fv.shape)
    base = torch.floor(coords)
    bi = base.to(torch.int64) + mc // 2
    idx = (bi[..., 0] * mc + bi[..., 1]) * mc + bi[..., 2]
    valid = torch.all((bi >= 0) & (bi < mc - 1), dim=-1)
    idx = torch.where(valid, idx, torch.full_like(idx, n_vox))
    frac = (coords - base).float()
    insert_update(tab, idx.reshape(-1).to(torch.int32),
                  fv.real.reshape(-1).contiguous(),
                  fv.imag.reshape(-1).contiguous(),
                  tv.reshape(-1).contiguous(), frac.reshape(-1, 3))
    return o_add.sum(dim=(0, 1))


def symmetrize_halves(f, t, exact_ops, general_rots, *, pf, r_u):
    """Point-group symmetrisation of per-half folded (F, T)
    (Reconstructor::symmetrizeF/T, src/Reconstructor.cpp:2676-2692). Only
    grid-exact rotations are ported (all of C2/C4/D2/D4)."""
    from ..core import reconstructor

    if len(general_rots):
        raise NotImplementedError(
            "engine.symmetrize_halves: general (non grid-exact) symmetry "
            "rotations (reconstructor.symmetrize_cropped) are not ported")
    out = [reconstructor.symmetrize_exact(f[h], t[h], exact_ops, r_u, pf=pf)
           for h in range(2)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def reconstruct_halves(f, t, fsc, w0, r_u, *, pf, n, join_half=False,
                       warm=False, blob_a=1.9, blob_alpha=15.0):
    """Per-half Wiener/C-balance reconstruction. f/t/w0: (2, mc, mc, mc);
    returns (volumes (2, n, n, n), converged weights (2, mc, mc, mc))."""
    from ..core import reconstructor

    vols, ws = [], []
    for h in range(2):
        v, w = reconstructor.reconstruct_cropped(
            f[h], t[h], fsc, n, pf=pf, max_radius=r_u, join_half=join_half,
            blob_a=blob_a, blob_alpha=blob_alpha,
            w_init=w0[h] if warm else None, return_w=True)
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
    two, s, p = dat.shape
    nb = two * s
    fl = lambda x: x.reshape((nb,) + x.shape[2:])
    table = fl(_table_index(state["c"], k_cls))
    coords = projector.slice_coords_3d(
        quat.rotate3d(fl(state["topR"]))[:, None], col, row, pf=pf)
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
