"""Pose-likelihood evaluation — the E-step hot loop (port of
``thunder_tpu.ops.likelihood`` and ``thunder_tpu.ops.pallas_likelihood``).

Because |T_t| = 1 for phase-ramp translations, the reference's residual
sum (src/Optimiser.cpp:622-1136) factors as

    logL[b,k,r,t] = cst_b + Re sum_p Q[b,p] T[t,p] P[k,r,p]
                          + sum_p E[b,p] |P[k,r,p]|^2,
    Q = -2 sr ctf conj(dat),  E = sr ctf^2,  sr = -0.5 / sigma,

and the per-image constant cancels in every posterior. The global scan
streams a log-sum-exp baseline over the T translations and accumulates the
marginals wC (B, K), wR (B, K, R), wT (B, K, T).

Kernel K1 is ``scan_fused``: for a CUDA tensor it makes one call of
``csrc/global_scan.cu``, which runs the hand-written tensor-core scan
(bf16 operands formed in the kernel, f32 accumulation) on the tensors as
given and merges its per-tile outputs; for a CPU tensor it runs
``scan_plain``, the f32 factored streaming log-sum-exp that is the port of
``likelihood.global_search_weights`` and the kernel's oracle.
``scan_tiles_plain`` and ``merge_tiles`` are the kernel's tile contract in
plain PyTorch: the same per-tile outputs, and their merge.
"""

import torch

from ..dtypes import real_dtype

# launches of the hand-written kernels, by wrapper (never reset here)
LAUNCHES = {"scan_fused": 0}

SCAN_NT = 64   # poses per kernel tile (csrc/global_scan.cu BN)
SCAN_NEG = -3.0e38  # logL of masked (pad) poses


def sigma_reciprocal(sig):
    """sigRcp = -0.5 / sigma (src/Optimiser.cpp:5242)."""
    return -0.5 / torch.clamp(sig, min=1e-30)


def log_likelihood_pose(dat, ctf, sig_rcp, pri, pixel_mask=None):
    """Direct (unfactored) logL of explicit poses: dat/ctf/sig_rcp (B, P);
    pri (B, P) or (B, M, P) predicted slices, already translated. Returns
    (B,) or (B, M)."""
    if pri.ndim == 3:
        dat, ctf, sig_rcp = dat[:, None], ctf[:, None], sig_rcp[:, None]
    resid = dat - ctf * pri
    val = (resid.real ** 2 + resid.imag ** 2) * sig_rcp
    if pixel_mask is not None:
        val = val * pixel_mask
    return torch.sum(val, dim=-1)


def _q_e(dat, ctf, sig_rcp, pixel_mask):
    pm = 1.0 if pixel_mask is None else pixel_mask
    q = (-2.0 * sig_rcp * ctf * pm) * torch.conj(dat)
    e = sig_rcp * ctf ** 2 * pm
    return q, e


def _uniform_priors(b, r, t, device):
    return (torch.full((b, r), 1.0 / r, dtype=real_dtype, device=device),
            torch.full((b, t), 1.0 / t, dtype=real_dtype, device=device))


def scan_plain(q, e, proj, tra, prior_r, prior_t):
    """Plain PyTorch version of K1: the f32 factored global scan with a
    streaming log-sum-exp baseline over translations.

    q: (B, P) complex64; e: (B, P) f32; proj: (K, R, P) complex64;
    tra: (T, P) complex64; prior_r (B, R); prior_t (B, T).
    Returns dict wC (B, K), wR (B, K, R), wT (B, K, T), baseline (B,)."""
    b, p = q.shape
    k, r, _ = proj.shape
    t_n = tra.shape[0]
    pk = proj.reshape(k * r, p)
    pk_re = pk.real.contiguous()
    pk_im = pk.imag.contiguous()
    term2 = e @ (torch.abs(pk) ** 2).T  # (B, K R)
    base = torch.full((b,), float("-inf"), dtype=real_dtype, device=q.device)
    acc_c = torch.zeros((b, k), dtype=real_dtype, device=q.device)
    acc_r = torch.zeros((b, k, r), dtype=real_dtype, device=q.device)
    cols, bases = [], []
    for t in range(t_n):
        qt = q * tra[t][None, :]
        term1 = qt.real @ pk_re.T - qt.imag @ pk_im.T
        log_l = (term1 + term2).reshape(b, k, r)
        cmax = torch.amax(log_l, dim=(1, 2))
        new_base = torch.maximum(base, cmax)
        scale = torch.exp(base - new_base)
        scale = torch.where(torch.isfinite(scale), scale,
                            torch.zeros_like(scale))
        w = torch.exp(log_l - new_base[:, None, None])
        wr = w * prior_t[:, t][:, None, None]
        acc_r = acc_r * scale[:, None, None] + wr
        acc_c = acc_c * scale[:, None] + torch.einsum("bkr,br->bk", wr,
                                                      prior_r)
        cols.append(torch.einsum("bkr,br->bk", w, prior_r))
        bases.append(new_base)
        base = new_base
    # each column carries its own step's baseline: bring all to the last
    rescale = torch.exp(torch.stack(bases) - base[None, :])  # (T, B)
    wt = torch.stack(cols) * rescale[:, :, None]               # (T, B, K)
    return {"wC": acc_c, "wR": acc_r, "wT": wt.permute(1, 2, 0),
            "baseline": base}


def _check_scan_inputs(q, e, proj, tra, prior_r, prior_t):
    dev = q.device
    b, p = q.shape
    k, r, p2 = proj.shape
    t = tra.shape[0]
    expect = {"q": (q, (b, p), torch.complex64), "e": (e, (b, p), real_dtype),
              "proj": (proj, (k, r, p), torch.complex64),
              "tra": (tra, (t, p), torch.complex64),
              "prior_r": (prior_r, (b, r), real_dtype),
              "prior_t": (prior_t, (b, t), real_dtype)}
    for name, (x, shape, dt) in expect.items():
        if x.device != dev:
            raise ValueError(f"scan_fused: {name} on {x.device}, q on {dev}")
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"scan_fused: {name} is {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} {dt}")
    if p2 != p or b == 0 or t == 0 or r == 0:
        raise ValueError("scan_fused: empty or mismatched pixel axes")


def pack_scan(q, e, proj, tra, prior_r, prior_t):
    """K1's operands as its tiles see them, in f32: each class's poses
    padded with zeros to whole SCAN_NT tiles (no tile straddles a class),
    as the kernel masks its pose tail. The kernel itself reads the caller's
    tensors unpacked; this is the plain tile contract's view of them.

    qa (3, B, P) = [Q.re, Q.im, E]; tra (2, T, P) = [T.re, T.im];
    poses (N, 3 P) = [P.re | P.im | |P|^2] per pose row; prior_r (B, N)
    zero on pad poses; valid (N,) 1 on real poses; prior_t (B, T)."""
    k, r, _ = proj.shape
    r_pad = -(-r // SCAN_NT) * SCAN_NT
    pk = torch.cat([proj.real, proj.imag, proj.real ** 2 + proj.imag ** 2],
                   -1)                                      # (K, R, 3P)
    pk = torch.nn.functional.pad(pk, (0, 0, 0, r_pad - r))
    valid = torch.zeros((k, r_pad), dtype=real_dtype, device=q.device)
    valid[:, :r] = 1.0
    return {"qa": torch.stack([q.real, q.imag, e]),
            "tra": torch.stack([tra.real, tra.imag]),
            "poses": pk.reshape(k * r_pad, -1),
            "prior_r": torch.nn.functional.pad(
                prior_r, (0, r_pad - r)).repeat(1, k),
            "valid": valid.reshape(-1), "prior_t": prior_t}


def scan_tiles_plain(packed):
    """Plain PyTorch version of K1's per-tile outputs, computed exactly
    (no streaming) in f32 from ``pack_scan``'s operands: for each image b
    and pose tile j, base[b, j] = max over (t, n in j) of logL (pad poses
    masked); with w = exp(logL - base): wr[b, n] = sum_t pt w,
    wt[b, j, t] = sum_{n in j} pr w, wc[b, j] = sum_t pt wt."""
    qa, tr, poses = packed["qa"], packed["tra"], packed["poses"]
    pr, pt = packed["prior_r"], packed["prior_t"]
    b = qa.shape[1]
    t = tr.shape[1]
    n_pose = poses.shape[0]
    n_tiles = n_pose // SCAN_NT
    qt_re = qa[0][:, None] * tr[0][None] - qa[1][:, None] * tr[1][None]
    qt_im = qa[0][:, None] * tr[1][None] + qa[1][:, None] * tr[0][None]
    a = torch.cat([qt_re, -qt_im, qa[2][:, None].expand_as(qt_re)], -1)
    log_l = a @ poses.T                                     # (B, T, N)
    log_l = torch.where(packed["valid"] > 0, log_l,
                        torch.full_like(log_l, SCAN_NEG))
    log_l = log_l.reshape(b, t, n_tiles, SCAN_NT)
    base = torch.amax(log_l, dim=(1, 3))                    # (B, tiles)
    w = torch.exp(log_l - base[:, None, :, None])
    wr = torch.einsum("btjn,bt->bjn", w, pt).reshape(b, n_pose)
    wt = torch.einsum("btjn,bjn->bjt", w, pr.reshape(b, n_tiles, SCAN_NT))
    wc = torch.einsum("bjt,bt->bj", wt, pt)
    return {"base": base, "wr": wr, "wc": wc, "wt": wt}


def merge_tiles(tiles, k, r):
    """The exact cross-tile merge of K1's per-tile outputs, in plain
    PyTorch (the kernel's own merge is the second kernel of
    csrc/global_scan.cu): every tile's sums move to the per-image max
    baseline. Returns the ``scan_plain`` dict wC (B, K), wR (B, K, R),
    wT (B, K, T), baseline (B,)."""
    base_p, wr_p, wc_p, wt_p = (tiles[x] for x in ("base", "wr", "wc", "wt"))
    b, n_tiles, t = wt_p.shape
    tiles_k = n_tiles // k
    base = torch.amax(base_p, dim=1, keepdim=True)       # (B, 1)
    scale = torch.exp(base_p - base)                     # (B, n_tiles)
    wr = (wr_p.reshape(b, n_tiles, SCAN_NT) * scale[..., None]).reshape(
        b, k, tiles_k * SCAN_NT)[:, :, :r]
    wc = (wc_p * scale).reshape(b, k, tiles_k).sum(2)
    wt = (wt_p * scale[..., None]).reshape(b, k, tiles_k, t).sum(2)
    return {"wC": wc, "wR": wr, "wT": wt, "baseline": base[:, 0]}


def _scan_call(q, e, proj, tra, prior_r, prior_t):
    """One call of csrc/global_scan.cu on CUDA tensors (already checked):
    the scan writes its per-tile outputs, the merge the ``scan_plain``
    outputs, into ONE new f32 buffer (at the round's shape the wrapper's
    time is host time, and each allocation costs microseconds). Returns
    (buffer, merged dict); the tiles are the buffer's head, as
    ``_tile_views`` reads it."""
    from .. import cuda_build

    b, p = q.shape
    k, r, _ = proj.shape
    t = tra.shape[0]
    dev = q.device
    o = _tiles_numel(b, k, r, t)[1]
    buf = torch.empty(o + b * (1 + k + k * r + k * t), dtype=real_dtype,
                      device=dev)
    out = {"baseline": buf.as_strided((b,), (1,), o),
           "wC": buf.as_strided((b, k), (k, 1), o + b),
           "wR": buf.as_strided((b, k, r), (k * r, r, 1), o + b + b * k),
           "wT": buf.as_strided((b, k, t), (k * t, t, 1),
                                o + b + b * k + b * k * r)}
    ops = [x.resolve_conj().contiguous()
           for x in (q, e, proj, tra, prior_r, prior_t)]
    lib = cuda_build.library()
    LAUNCHES["scan_fused"] += 1
    code = lib.thunder_global_scan(
        *(x.data_ptr() for x in ops), buf.data_ptr(),
        *(out[x].data_ptr() for x in ("baseline", "wC", "wR", "wT")),
        b, p, k, r, t, cuda_build.stream_ptr(dev))
    cuda_build.check(code, "global_scan")
    return buf, out


def _tiles_numel(b, k, r, t):
    n_tiles = k * -(-r // SCAN_NT)
    return n_tiles, b * n_tiles * (SCAN_NT + 2 + t)


def _tile_views(buf, b, k, r, t):
    """The scan's per-tile outputs at the head of ``_scan_call``'s buffer:
    [base (B, n_tiles) | wr (B, 64 n_tiles) | wc (B, n_tiles) |
    wt (B, n_tiles, T)], the order of csrc/global_scan.cu."""
    n_tiles = _tiles_numel(b, k, r, t)[0]
    n = b * n_tiles
    return {"base": buf.as_strided((b, n_tiles), (n_tiles, 1), 0),
            "wr": buf.as_strided((b, n_tiles * SCAN_NT),
                                 (n_tiles * SCAN_NT, 1), n),
            "wc": buf.as_strided((b, n_tiles), (n_tiles, 1),
                                 n + n * SCAN_NT),
            "wt": buf.as_strided((b, n_tiles, t), (n_tiles * t, t, 1),
                                 2 * n + n * SCAN_NT)}


def scan_tiles_kernel(q, e, proj, tra, prior_r, prior_t):
    """K1 on CUDA tensors, with its per-tile outputs kept: returns (tiles,
    merged), the dict of ``scan_tiles_plain`` as the scan wrote it and the
    merged ``scan_plain`` dict. Inputs as ``scan_fused``'s."""
    _check_scan_inputs(q, e, proj, tra, prior_r, prior_t)
    if q.device.type != "cuda":
        raise ValueError(f"scan_tiles_kernel: tensors on {q.device}")
    buf, merged = _scan_call(q, e, proj, tra, prior_r, prior_t)
    tiles = _tile_views(buf, q.shape[0], *proj.shape[:2], tra.shape[0])
    return tiles, merged


def scan_fused(q, e, proj, tra, prior_r, prior_t):
    """K1: the fused global scan. CUDA tensors make one call of the
    hand-written kernels (csrc/global_scan.cu: scan, then merge); CPU
    tensors run ``scan_plain``. Same inputs and outputs as ``scan_plain``
    (on CUDA, the outputs are views of one buffer).

    The kernel rounds its operands to bf16 (as the TPU kernel does), so it
    agrees with the f32 plain version to bf16 rounding of the
    log-likelihoods."""
    _check_scan_inputs(q, e, proj, tra, prior_r, prior_t)
    if q.device.type == "cpu":
        return scan_plain(q, e, proj, tra, prior_r, prior_t)
    if q.device.type != "cuda":
        raise ValueError(f"scan_fused: unsupported device {q.device}")
    return _scan_call(q, e, proj, tra, prior_r, prior_t)[1]


def global_search_weights_fused(dat, ctf, sig_rcp, proj, tra, prior_r=None,
                                prior_t=None, pixel_mask=None):
    """Factored global-search posterior accumulation through kernel K1
    (port of ``likelihood.global_search_weights``; its plain version on a
    CPU tensor).

    dat (B, P) complex ring pixels; ctf, sig_rcp (B, P); proj (K, R, P);
    tra (T, P); priors uniform when None."""
    q, e = _q_e(dat, ctf, sig_rcp, pixel_mask)
    b = dat.shape[0]
    pr0, pt0 = _uniform_priors(b, proj.shape[1], tra.shape[0], dat.device)
    return scan_fused(q.to(torch.complex64), e.to(real_dtype),
                      proj, tra,
                      pr0 if prior_r is None else prior_r,
                      pt0 if prior_t is None else prior_t)


def local_search_weights(dat, ctf, sig_rcp, proj, tra, w_r, w_t, w_d=None,
                         ctf_d=None, pixel_mask=None):
    """Per-image local-search marginals of one particle-filter phase
    (src/Optimiser.cpp:1294-1402), the exact block log-sum-exp over the
    (defocus, rotation, translation) support.

    dat/ctf/sig_rcp: (B, P); proj: (B, R, P); tra: (B, T, P);
    w_r (B, R), w_t (B, T), w_d (B, D) the support weights (uniform when
    None); ctf_d (B, D, P) the CTF at each defocus point (CTF search), or
    None for D = 1 with ``ctf``. Returns (u_r (B, R), u_t (B, T),
    u_d (B, D)). The static defocus axis is looped, so the largest
    temporary stays (B, T, P)."""
    pm = 1.0 if pixel_mask is None else pixel_mask
    if ctf_d is None:
        ctf_d = ctf[:, None, :]
    p2 = proj.real ** 2 + proj.imag ** 2
    dat_c = torch.conj(dat)
    log_l = []
    for d in range(ctf_d.shape[1]):
        c_d = ctf_d[:, d, :]
        q = (-2.0 * sig_rcp * c_d * pm) * dat_c
        e = sig_rcp * c_d ** 2 * pm
        term2 = torch.einsum("bp,brp->br", e, p2)
        qt = q[:, None, :] * tra                              # (B, T, P)
        term1 = (torch.einsum("btp,brp->brt", qt.real, proj.real)
                 - torch.einsum("btp,brp->brt", qt.imag, proj.imag))
        log_l.append(term1 + term2[..., None])                # (B, R, T)
    log_l = torch.stack(log_l, dim=1)                         # (B, D, R, T)
    base = torch.amax(log_l, dim=(1, 2, 3), keepdim=True)
    w = torch.exp(log_l - base)
    if w_d is None:
        w_d = torch.full(w.shape[:2], 1.0 / w.shape[1], dtype=w.dtype,
                         device=w.device)
    w_rt = torch.einsum("bdrt,bd->brt", w, w_d)
    u_r = torch.einsum("brt,bt->br", w_rt, w_t)
    u_t = torch.einsum("brt,br->bt", w_rt, w_r)
    u_d = torch.einsum("bdr,br->bd", torch.einsum("bdrt,bt->bdr", w, w_t), w_r)
    return u_r, u_t, u_d
