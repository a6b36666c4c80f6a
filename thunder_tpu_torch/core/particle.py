"""The particle filter over (class, rotation, translation, defocus) (port of
``thunder_tpu.core.particle``; include/Particle.h, src/Particle.cpp, the
phase rule of src/Optimiser.cpp:1510-1614).

Every operation is batched over leading image dims. Where the JAX function
draws from per-image keys, the port takes the draws as tensors:
standard normals for perturbations, one uniform u0 per image for each
systematic resample, an anchor index per image for the symmetrised
variance, Gumbel noise for the class draw, and in 2D mode the von Mises
sampler's uniforms.

2D mode (``mode="2d"``) keeps an in-plane angle phi as (cos phi, sin phi,
0, 0) in the quaternion slots: rotations are perturbed by von Mises angle
increments (Particle.cpp:1160-1178) and k1 = k2 = k3 = 1 - R of the
support's mean resultant (:1014).
"""

import torch

from ..dtypes import real_dtype
from ..geom import quat
from ..geom.directional import (infer_acg, infer_acg_mean, sample_acg_k123,
                                sample_vms)
from ..geom.symmetry import symmetry_counterpart

# include/Particle.h:52-64, include/Optimiser.h:56-63
PEAK_FACTOR_C = 1 - 1e-2
PEAK_FACTOR_MAX = 0.5
PEAK_FACTOR_MIN = 1e-3
PEAK_FACTOR_BASE = 2
PERTURB_K_MAX = 1.0
MIN_N_PHASE_PER_ITER_GLOBAL = 10
MIN_N_PHASE_PER_ITER_LOCAL = 3
MAX_N_PHASE_PER_ITER = 100
N_PHASE_WITH_NO_VARI_DECREASE = 1
PARTICLE_FILTER_DECREASE_FACTOR = 0.95

CHI2_P_1_DF2 = 0.3934693402873666  # gsl_cdf_chisq_P(1, 2)
CHI2_P_1_DF1 = 0.6826894921370859  # gsl_cdf_chisq_P(1, 1)


def make_state(shape, n_r, n_t, n_d=1, device=None):
    """Particle-filter state dict for images of batch ``shape`` (a tuple,
    e.g. (2, S)); identity rotations, zero translations."""
    shape = tuple(shape)
    kw = dict(dtype=real_dtype, device=device)
    e = torch.tensor([1.0, 0.0, 0.0, 0.0], **kw)

    def full(v, *tail):
        return torch.full(shape + tail, v, **kw)

    return {
        "r": e.expand(shape + (n_r, 4)).clone(),
        "t": torch.zeros(shape + (n_t, 2), **kw),
        "d": full(1.0, n_d),
        "c": torch.zeros(shape, dtype=torch.int32, device=device),
        "wR": full(1.0 / n_r, n_r),
        "wT": full(1.0 / n_t, n_t),
        "wD": full(1.0 / n_d, n_d),
        "topR": e.expand(shape + (4,)).clone(),
        "topT": torch.zeros(shape + (2,), **kw),
        "topD": full(1.0),
        "k1": full(1.0), "k2": full(1.0), "k3": full(1.0),
        "s0": full(1.0), "s1": full(1.0), "sD": full(0.0),
        "pfR": full(PEAK_FACTOR_MIN), "pfT": full(PEAK_FACTOR_MIN),
        "pfD": full(PEAK_FACTOR_MIN),
    }


def _take(points, idx):
    """points (..., n_in, *tail), idx (..., n_out) -> (..., n_out, *tail)."""
    tail = points.shape[idx.ndim:]
    ix = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(points, idx.ndim - 1, ix)


def systematic_resample(w, points, n_out, u0):
    """Systematic resampling (Particle.cpp:1291-1505).

    w: (..., n_in) weights; points: (..., n_in, *tail); u0: (...,)
    uniforms in [0, 1). Returns (..., n_out, *tail)."""
    n_in = w.shape[-1]
    w = torch.clamp(w, min=0.0)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-30)
    ar = torch.arange(n_out, dtype=w.dtype, device=w.device)
    pos = u0[..., None] / n_out + ar / n_out
    idx = torch.searchsorted(cdf.contiguous(), pos.contiguous())
    idx = torch.clamp(idx, 0, n_in - 1)
    return _take(points, idx)


def resample_rotations(w, r, n_out, u0):
    """Systematic resampling of rotation supports (the JAX package's
    ``resample_rotations``): w (B, n_in), r (B, n_in, 4), u0 (B,) the
    per-image uniforms the JAX function draws from its keys."""
    return systematic_resample(w, r, n_out, u0)


def keep_half_height_peak(u, peak_factor):
    """u <- max(0, u - pf * max(u)) along the last axis."""
    hh = torch.amax(u, dim=-1, keepdim=True) * peak_factor
    return torch.clamp(u - hh, min=0.0)


def cal_peak_factor(u, idx):
    """u's idx-th largest over its largest, clamped (setPeakFactor)."""
    u_desc = torch.sort(u, dim=-1, descending=True).values
    ratio = u_desc[..., idx] / torch.clamp(u_desc[..., 0], min=1e-30)
    return torch.clamp(ratio, PEAK_FACTOR_MIN, PEAK_FACTOR_MAX)


def peak_idx_r(n_r, mode="3d"):
    return n_r // 2 if mode == "2d" else n_r // PEAK_FACTOR_BASE ** 3


def peak_idx_t(n_t):
    return min(n_t - 1, int(n_t * CHI2_P_1_DF2))


def peak_idx_d(n_d):
    return min(n_d - 1, int(n_d * CHI2_P_1_DF1))


def symmetrise_r(r, sym_quats, anchor):
    """Map support rotations (..., nR, 4) to the group counterpart nearest
    ``anchor`` (..., 4) (Particle::symmetrise)."""
    if sym_quats is None or sym_quats.shape[0] == 0:
        return r
    return symmetry_counterpart(r, sym_quats, anchor=anchor[..., None, :])


def cal_vari_r(r, anchor_idx=None, sym_quats=None):
    """(k1, k2, k3, symmetrised support): symmetrise about the support
    point ``anchor_idx`` (..., ) when a group is given, recentre by the ACG
    mean, diagonal ratios of the scatter (calVari, Particle.cpp:1004-1100).
    """
    if sym_quats is not None and sym_quats.shape[0] > 0 \
            and anchor_idx is not None:
        anchor = _take(r, anchor_idx[..., None].long())[..., 0, :]
        r = symmetrise_r(r, sym_quats, anchor)
    mean = infer_acg_mean(r)
    r_c = quat.quat_mul(quat.quat_conj(mean)[..., None, :], r)
    a2 = infer_acg(r_c)
    d0 = torch.clamp(a2[..., 0, 0], min=1e-30)
    return a2[..., 1, 1] / d0, a2[..., 2, 2] / d0, a2[..., 3, 3] / d0, r


def cal_vari_r_2d(r):
    """2D rotation concentration: k1 = 1 - |resultant| of the (cos, sin)
    support vectors (..., nR, 4) (inferVMS, DirectionalStat.cpp:334-357)."""
    m = torch.mean(r[..., :2], dim=-2)
    return torch.clamp(1.0 - torch.linalg.vector_norm(m, dim=-1), 1e-6, 1.0)


def cal_vari_t(t):
    """(s0, s1): per-axis population stddev of the translation support."""
    s = torch.std(t, dim=-2, correction=0)
    return s[..., 0], s[..., 1]


def cal_vari_d(d):
    """sD: population stddev of the defocus support (..., nD)."""
    return torch.std(d, dim=-1, correction=0)


def perturb_r(r, k1, k2, k3, pf, normals, sym_quats=None):
    """Perturb support rotations in the tangent frame of their ACG mean by
    ACG(pf^2 min(1, k)) samples from ``normals`` (..., nR, 4), then
    re-symmetrise about the mean (Particle.cpp:1180-1240)."""
    mean = infer_acg_mean(r)
    kk = [(pf ** 2) * torch.clamp(k, max=PERTURB_K_MAX) for k in (k1, k2, k3)]
    d = sample_acg_k123(kk[0], kk[1], kk[2], normals)
    mean_e = mean[..., None, :]
    local = quat.quat_mul(quat.quat_conj(mean_e), r)
    out = quat.quat_mul(mean_e, quat.quat_mul(d, local))
    if sym_quats is not None and sym_quats.shape[0] > 0:
        out = symmetrise_r(out, sym_quats, mean)
    return out


def perturb_r_2d(r, k1, pf, vms):
    """2D: in-plane angle increments ~ VMS(min(1, k1 pf)) composed onto
    the (cos, sin) support vectors (..., nR, 4) by complex multiplication
    (Particle.cpp:1160-1178). ``vms`` holds ``sample_vms``'s uniforms for
    each image: u_z, u_2 (..., ROUNDS, nR), u_s, theta (..., nR)."""
    kk = torch.clamp(k1 * pf, max=PERTURB_K_MAX)
    mu = torch.tensor([1.0, 0.0], dtype=r.dtype, device=r.device)
    d = sample_vms(mu, kk, vms["u_z"], vms["u_2"], vms["u_s"], vms["theta"])
    c, s = r[..., 0], r[..., 1]
    dc, ds = d[..., 0], d[..., 1]
    out = torch.stack([c * dc - s * ds, c * ds + s * dc], dim=-1)
    return torch.cat([out, torch.zeros_like(out)], dim=-1)


def perturb_t(t, s0, s1, pf, normals):
    """t + normals * (s0, s1) * pf; normals (..., nT, 2)."""
    s = torch.stack([s0, s1], dim=-1)[..., None, :]
    return t + normals * s * pf


def perturb_d(d, s, pf, normals):
    """d + normals * sD * pf; d and normals (..., nD)."""
    return d + normals * s[..., None] * pf


def update_from_likelihood(state, u_r, u_t, u0_r, u0_t, anchor_idx,
                           sym_quats=None, mode="3d", u_d=None, u0_d=None):
    """One phase's posterior update (src/Optimiser.cpp:1404-1496):
    peak-clip with the per-image factors, rank-1st, symmetrised variance
    of the CURRENT support, systematic resample back to the support sizes.
    u0_r/u0_t: (...,) resample uniforms; anchor_idx: (...,) support index
    (unused in 2D mode). With the defocus marginal ``u_d`` (..., nD) (CTF
    search) the defocus support is updated the same way: topD, sD, the
    resample of d with the uniforms ``u0_d`` (...,) and uniform wD.
    """
    n_r = state["r"].shape[-2]
    n_t = state["t"].shape[-2]
    u_r = keep_half_height_peak(u_r, state["pfR"][..., None])
    u_t = keep_half_height_peak(u_t, state["pfT"][..., None])
    top_r = _take(state["r"], torch.argmax(u_r, dim=-1)[..., None])[..., 0, :]
    top_t = _take(state["t"], torch.argmax(u_t, dim=-1)[..., None])[..., 0, :]
    if mode == "2d":
        k1 = cal_vari_r_2d(state["r"])
        k2, k3, r_v = k1, k1, state["r"]
    else:
        k1, k2, k3, r_v = cal_vari_r(state["r"], anchor_idx, sym_quats)
    s0, s1 = cal_vari_t(state["t"])
    r_new = systematic_resample(state["wR"] * u_r, r_v, n_r, u0_r)
    t_new = systematic_resample(state["wT"] * u_t, state["t"], n_t, u0_t)
    out = {
        **state,
        "r": r_new, "t": t_new,
        "wR": torch.full_like(state["wR"], 1.0 / n_r),
        "wT": torch.full_like(state["wT"], 1.0 / n_t),
        "topR": top_r, "topT": top_t,
        "k1": k1, "k2": k2, "k3": k3, "s0": s0, "s1": s1,
    }
    if u_d is not None:
        d = state["d"]
        n_d = d.shape[-1]
        u_d = keep_half_height_peak(u_d, state["pfD"][..., None])
        out["topD"] = _take(d, torch.argmax(u_d, dim=-1)[..., None])[..., 0]
        out["sD"] = cal_vari_d(d)
        out["d"] = systematic_resample(state["wD"] * u_d, d[..., None], n_d,
                                       u0_d)[..., 0]
        out["wD"] = torch.full_like(state["wD"], 1.0 / n_d)
    return out


def vari_shrank(state, prev, mode="3d"):
    """Did any variance shrink below the decrease factor? 3D compares the
    rotation concentrations against the squared factor, 2D k1 linearly."""
    f = PARTICLE_FILTER_DECREASE_FACTOR
    trans = ((state["s0"] < prev["s0"] * f) | (state["s1"] < prev["s1"] * f)
             | (state["sD"] < prev["sD"] * f))
    if mode == "2d":
        return (state["k1"] < prev["k1"] * f) | trans
    f2 = f * f
    return ((state["k1"] < prev["k1"] * f2) | (state["k2"] < prev["k2"] * f2)
            | (state["k3"] < prev["k3"] * f2) | trans)


def compress_r(state):
    """Particle-grading score (k1 k2 k3)^(-1/6) (Particle.cpp:647-667)."""
    return torch.clamp(state["k1"] * state["k2"] * state["k3"],
                       min=1e-30) ** (-1.0 / 6)


def init_from_scan(w_c, w_r, w_t, scan_quats, scan_trans, n_r, n_t, n_d,
                   gumbel, u0_r, u0_t, mode="3d"):
    """Seed each image's filter from the global-scan marginals
    (src/Optimiser.cpp:925-1118): draw the class from the peak-clipped
    class posterior (Gumbel-max with ``gumbel`` (B, K)), set the adaptive
    peak factors, resample the scan points into the local support with
    uniforms ``u0_r``/``u0_t`` (B,), and floor the initial variances.

    w_c: (B, K); w_r: (B, K, R); w_t: (B, K, T)."""
    b = w_c.shape[0]
    dev = w_c.device
    u_c = keep_half_height_peak(w_c, PEAK_FACTOR_C)
    logits = torch.log(torch.clamp(u_c, min=1e-30))
    cls = torch.argmax(gumbel + logits, dim=-1)
    u_r = _take(w_r, cls[:, None])[:, 0]  # (B, R)
    u_t = _take(w_t, cls[:, None])[:, 0]  # (B, T)
    pf_r = cal_peak_factor(u_r, peak_idx_r(u_r.shape[-1], mode))
    pf_t = cal_peak_factor(u_t, peak_idx_t(u_t.shape[-1]))
    u_r = keep_half_height_peak(u_r, pf_r[:, None])
    u_t = keep_half_height_peak(u_t, pf_t[:, None])
    r_pts = scan_quats[None].expand((b,) + tuple(scan_quats.shape))
    t_pts = scan_trans[None].expand((b,) + tuple(scan_trans.shape))
    r_new = systematic_resample(u_r, r_pts, n_r, u0_r)
    t_new = systematic_resample(u_t, t_pts, n_t, u0_t)
    state = make_state((b,), n_r, n_t, n_d, device=dev)
    top_r = _take(r_pts, torch.argmax(u_r, dim=-1)[:, None])[:, 0]
    top_t = _take(t_pts, torch.argmax(u_t, dim=-1)[:, None])[:, 0]
    if mode == "2d":
        k1 = cal_vari_r_2d(r_new)
        k2 = k3 = k1
        min_k = 1.0 / scan_quats.shape[0]
    else:
        k1, k2, k3, _ = cal_vari_r(r_new)
        min_k = float(scan_quats.shape[0]) ** (-2.0 / 3)
    s0, s1 = cal_vari_t(t_new)
    return {
        **state,
        "r": r_new, "t": t_new, "c": cls.to(torch.int32),
        "topR": top_r, "topT": top_t,
        "k1": torch.clamp(k1, min=min_k), "k2": torch.clamp(k2, min=min_k),
        "k3": torch.clamp(k3, min=min_k),
        "s0": torch.clamp(s0, min=0.3), "s1": torch.clamp(s1, min=0.3),
        "pfR": pf_r, "pfT": pf_t,
    }
