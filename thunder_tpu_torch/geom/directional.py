"""Directional statistics of the particle filter (port of
``thunder_tpu.geom.directional``; src/Geometry/DirectionalStat.cpp),
batched over leading dims:

- Angular Central Gaussian (ACG) over unit quaternions (3D rotations):
  ``pdf_acg``; ``sample_acg`` (and ``sample_acg_k0k1`` / ``_k123`` for
  diagonal scatters) maps caller-drawn 4D normals through chol(Sigma);
  ``infer_acg`` is the weighted Tyler fixed-point iteration with a fixed
  iteration count, reduced by ``infer_acg_k0k1`` / ``infer_acg_k`` /
  ``infer_acg_k123`` / ``infer_acg_mean``;
- von Mises (VMS) on the circle (2D in-plane rotations): ``sample_vms`` is
  the Best-Fisher sampler as VMS_PROPOSAL_ROUNDS fixed proposal rounds on
  caller-drawn uniforms, ``infer_vms`` the mean-resultant inference.
"""

import math

import torch

ACG_FIXED_POINT_ITERS = 30
VMS_PROPOSAL_ROUNDS = 8


def pdf_acg(x, sig):
    """ACG density on S^3. x: (..., 4); sig: (..., 4, 4)."""
    u = torch.einsum("...i,...ij,...j->...", x, torch.linalg.inv(sig), x)
    area = 2 * math.pi ** 2  # surface area of S^3
    return 1.0 / (area * torch.sqrt(torch.linalg.det(sig))) * u ** -2.0


def sample_acg(sig, normals):
    """q = L v / |L v| with L = chol(sig). sig: (..., 4, 4); normals
    (..., n, 4) standard normals -> (..., n, 4)."""
    ell = torch.linalg.cholesky(sig)
    q = normals @ ell.transpose(-1, -2)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def sample_acg_k0k1(k0, k1, normals):
    """ACG(diag(k0, k1, k1, k1)) samples from normals (n, 4) -> (n, 4)."""
    sig = torch.diag(torch.stack([torch.as_tensor(k, dtype=normals.dtype)
                                  for k in (k0, k1, k1, k1)]))
    return sample_acg(sig, normals)


def sample_acg_k123(k1, k2, k3, normals):
    """ACG(diag(1, k1, k2, k3)) samples. k1..k3: (...,); normals
    (..., n, 4). The scatter is diagonal, so its Cholesky factor is the
    element-wise square root."""
    d = torch.stack([torch.ones_like(k1), k1, k2, k3], dim=-1)
    q = normals * torch.sqrt(d)[..., None, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def infer_acg(q, w=None, n_iter=ACG_FIXED_POINT_ITERS):
    """Weighted Tyler fixed-point estimate of the ACG scatter matrix.

    q: (..., n, 4) support quaternions; w: (..., n) non-negative weights
    (uniform when None). Returns A: (..., 4, 4)."""
    n = q.shape[-2]
    if w is None:
        w = torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    eye = torch.eye(4, dtype=q.dtype, device=q.device)
    a = eye.expand(q.shape[:-2] + (4, 4))
    qt = q.transpose(-1, -2)  # (..., 4, n)
    for _ in range(n_iter):
        # trace-relative ridge keeps the iteration well-conditioned in f32
        # when the support collapses toward a single point
        tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
        ridge = (1e-4 * tr / 4.0)[..., None, None] * eye
        sol = torch.linalg.solve_ex(a + ridge, qt)[0]  # (..., 4, n)
        u = torch.clamp(torch.sum(q * sol.transpose(-1, -2), dim=-1),
                        min=1e-8)
        wu = w / u
        b = torch.einsum("...n,...ni,...nj->...ij", wu, q, q)
        nf = torch.sum(wu, dim=-1)
        a = 4.0 * b / torch.clamp(nf, min=1e-30)[..., None, None]
    return a


def infer_acg_k0k1(q, w=None):
    """The scatter's two largest eigenvalues (k0, k1) (DirectionalStat.cpp:
    146-166). q: (..., n, 4) -> two (...,)."""
    ev = torch.linalg.eigvalsh(infer_acg(q, w))  # ascending
    return ev[..., -1], ev[..., -2]


def infer_acg_k(q, w=None):
    """k1 / k0 of ``infer_acg_k0k1``."""
    k0, k1 = infer_acg_k0k1(q, w)
    return k1 / torch.clamp(k0, min=1e-30)


def infer_acg_k123(q, w=None):
    """The scatter's diagonal ratios A11/A00, A22/A00, A33/A00
    (DirectionalStat.cpp:181-216)."""
    a = infer_acg(q, w)
    d = torch.clamp(a[..., 0, 0], min=1e-30)
    return a[..., 1, 1] / d, a[..., 2, 2] / d, a[..., 3, 3] / d


def infer_acg_mean(q, w=None):
    """Principal eigenvector of the ACG scatter (DirectionalStat.cpp:
    218-252), unit-normalised. q: (..., n, 4) -> (..., 4). The sign is
    arbitrary; every caller uses it as a rotation, where q and -q agree."""
    a = infer_acg(q, w)
    _, vecs = torch.linalg.eigh(a)
    mean = vecs[..., -1]
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)


def bessel_i0(x):
    """Modified Bessel I0 via Abramowitz & Stegun 9.8.1/9.8.2."""
    ax = torch.abs(x)
    t2 = (ax / 3.75) ** 2
    small = 1.0 + t2 * (3.5156229 + t2 * (3.0899424 + t2 * (
        1.2067492 + t2 * (0.2659732 + t2 * (0.0360768 + t2 * 0.0045813)))))
    it = 3.75 / torch.clamp(ax, min=1e-30)
    poly = 0.39894228 + it * (0.01328592 + it * (0.00225319 + it * (
        -0.00157565 + it * (0.00916281 + it * (-0.02057706 + it * (
            0.02635537 + it * (-0.01647633 + it * 0.00392377)))))))
    big = torch.exp(ax) / torch.sqrt(torch.clamp(ax, min=1e-30)) * poly
    return torch.where(ax < 3.75, small, big)


def _vms_kappa(k):
    """The reference's VMS concentration from its k in (0, 1]."""
    k = torch.clamp(k, 1e-6, 1.0)
    return (1 - k) * (1 + 2 * k - k ** 2) / (k * (2 - k))


def pdf_vms(x, mu, k):
    """VMS pdf on the circle, with the Gaussian tail approximation above
    kappa = 5 (DirectionalStat.cpp:252-262). x, mu: (..., 2); k: (...,)."""
    kappa = _vms_kappa(k)
    dot = torch.sum(x * mu, dim=-1)
    small = torch.exp(kappa * dot) / (2 * math.pi * bessel_i0(kappa))
    d = torch.linalg.vector_norm(x - mu, dim=-1)
    s = torch.sqrt(1.0 / kappa)
    big = torch.exp(-0.5 * (d / s) ** 2) / (s * math.sqrt(2 * math.pi))
    return torch.where(kappa < 5, small, big)


def sample_vms(mu, k, u_z, u_2, u_s, theta):
    """n unit 2-vectors from VMS(mu, k) with the reference's
    parameterisation (DirectionalStat.cpp:264-332).

    mu: (..., 2) or (2,); k: (...,). The uniforms come from the caller, as
    ``thunder_tpu.geom.directional.sample_vms`` draws them: u_z
    (..., ROUNDS, n) in [0, 1) for the proposals, u_2 (..., ROUNDS, n) in
    [1e-12, 1) for the acceptance tests, u_s (..., n) in [0, 1) for the
    sign, theta (..., n) in [0, 2 pi) for the uniform case kappa < 0.1.
    The first accepted proposal is kept, the last one where none is.
    Returns (..., n, 2)."""
    kappa = _vms_kappa(k)[..., None, None]                 # (..., 1, 1)
    a = 1 + torch.sqrt(1 + 4 * kappa ** 2)
    b = (a - torch.sqrt(2 * a)) / (2 * kappa)
    r = (1 + b ** 2) / (2 * b)
    z = torch.cos(math.pi * u_z)
    f = (1 + r * z) / (r + z)
    c = kappa * (r - f)
    accept = (c * (2 - c) > u_2) | (torch.log(c / u_2) + 1 - c >= 0)
    idx = torch.argmax(accept.to(torch.int32), dim=-2)     # first accepted
    idx = torch.where(accept.any(dim=-2), idx,
                      torch.full_like(idx, VMS_PROPOSAL_ROUNDS - 1))
    f = torch.gather(f, -2, idx[..., None, :])[..., 0, :]  # (..., n)
    delta = torch.sqrt(torch.clamp((1 - f) * (f + 1), min=0.0))
    sign = torch.where(u_s > 0.5, 1.0, -1.0)
    mu0, mu1 = mu[..., 0:1], mu[..., 1:2]
    vm = torch.stack([mu0 * f + sign * delta * mu1,
                      mu1 * f - sign * delta * mu0], dim=-1)
    uni = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(kappa[..., 0, :, None] < 1e-1, uni, vm)


def sample_vms_quat(mu4, k, u_z, u_2, u_s, theta):
    """2D-mode variant: the rotation lives in the first two quaternion
    slots (DirectionalStat.cpp:320-332). Returns (..., n, 4)."""
    v = sample_vms(mu4[..., :2], k, u_z, u_2, u_s, theta)
    return torch.cat([v, torch.zeros_like(v)], dim=-1)


def infer_vms(x, w=None):
    """Weighted mean-resultant inference: mu = normalised weighted mean,
    k = 1 - R (DirectionalStat.cpp:334-357). x: (..., n, 2); w (..., n).
    Returns (mu (..., 2), k (...,))."""
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    m = torch.einsum("...n,...ni->...i", w, x)
    big_r = torch.linalg.vector_norm(m, dim=-1)
    mu = m / torch.clamp(big_r, min=1e-30)[..., None]
    return mu, 1 - big_r
