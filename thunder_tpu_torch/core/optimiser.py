"""The refinement loop, global, local-search and CTF-search rounds and the
final round, for 3D refinement, 3D classification (K > 1) and 2D
classification (port of ``thunder_tpu.core.optimiser``; Optimiser::run
src/Optimiser.cpp:3561-4363).

Every per-image quantity lives as an (lh, S, ...) tensor on one device:
the global half-plane layout (2, S) — plane 0 = hemisphere A, plane 1 = B,
S slots per plane (invalid slots carry ``plane_valid`` 0) — cut to this
rank's block (``parallel.mesh``): lh = 2 when the rank holds both planes
(one process, or an odd rank count), lh = 1 when it holds one hemisphere.
One round of ``run_iteration``:

- E-step: ``global_scan`` (engine.scan_init with kernel K1; global rounds
  only) and ``local_search`` (the particle-filter phase loop; in CTF-search
  rounds over a per-image defocus support too),
- M-step: ``_residual_stats``, then on local rounds ``norm_correction``
  and ``engine.sigma_rescaled``, and ``maximization_sigma``; the group
  intensity-scale correction (``correct_scale``) on later global rounds,
- ``reconstruct``: engine.insert_fold_reduce (kernel K2 in 3D, or the
  MKB blob kernel's row adds with ``para.mkb_kernel``; the K classes fused
  into one accumulator, or inserted one at a time past
  FUSED_CLASS_BYTES), then per class point-group symmetrisation
  (grid-exact rotations as transposes, the others by trilinear gathers),
  per-half Wiener/C-balance, golden-standard FSC with the random-phase
  core correction, hemisphere averaging; after a global round
  ``balance_class``,
- on local 3D rounds ``re_centre_img`` and ``re_mask_img``; reference
  auto-recentring, solvent flattening (the spherical mask), the frequency
  ladder (on the best class's resolution) and the search-type switch.

``run`` does the init-time scale re-balance against a given model, then
rounds until ``iter_max`` or STOP (writing each round's files when a
``save_*_each_iter`` flag is set), then ``finalise``: the reconstruction
at the Nyquist band without hemisphere averaging, the joined map of each
class and the final file set (``save_outputs``).

2D mode (``para.mode == "2d"``) refines in-plane angles against K class
averages (2, K, n, n) with the bilinear 2D tables and the 2D insert.

Data come as arrays (``set_data``) or from a .thu table and its MRC
stacks (``set_data_from_dataset``); ``load_poses`` resumes from stored
poses. A provided mask volume (``set_mask``) replaces the spherical mask
in solvent flattening when ``use_mask`` asks for it and in the golden FSC
under ``mask_fsc``. With ``para.subtract`` the final round ends in the
signal-subtraction pipeline (``_subtract_pipeline``: the subtracted stack
Subtract_Rank_000000.mrcs and Meta_Subtract.thu).

A multi-process run (``parallel.distributed``) lays its W ranks out as
the JAX package's mesh does (``mesh.make_mesh``): (2, W/2) at an even W,
where rank r holds hemisphere r // (W/2) and slice r % (W/2) of its S
slots, and (1, W) at an odd W, where every rank holds both planes' slice r
(``planes``, ``rows``). Each rank reads and holds its own block's images
and state and builds, inserts, symmetrises and reconstructs only its
halves. The insert's folded F/T are summed over the hemisphere's data
ranks (the JAX package's psum over ``data``), the statistics over every
rank (its psum over (half, data)); the two half maps, the insert offsets
and the final round's F/T meet over the pair of ranks at one data index.
Per-image views for files are gathered (``_from_plane``), rank 0
broadcasts what steers the run (references, FSC, ladder) and alone writes
the files; each rank writes its own subtraction stack. The draws keep the
global (2, S) shape on every rank (``draws.RowDraws``), so a run does not
depend on the layout.
"""

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..config import Para
from ..dtypes import real_dtype, resolve_device
from ..geom import quat
from ..geom.symmetry import Symmetry
from ..io.mrc import read_mrc, write_mrc
from ..io.thu import ThuColumns, make_table, write_thu
from ..ops import brick as brick_ops
from ..ops import ctf as ctf_ops
from ..ops import fft as fft_ops
from ..ops import likelihood, pixels, spectrum
from ..ops.filters import low_pass_filter
from ..utils import check_memory_usage, get_logger
from ..ops.mask import soft_mask_shape
from ..ops.translate import translate_ft, translate_ft_3d, translation_phase
from ..parallel import distributed, engine
from ..parallel.mesh import make_mesh
from . import particle, projector, reconstructor, sampling
from .draws import Draws, RowDraws

SEARCH_TYPE_GLOBAL = 0
SEARCH_TYPE_LOCAL = 1
SEARCH_TYPE_CTF = 2
SEARCH_TYPE_STOP = 3

# ladder constants (include/Model.h:47-101)
MAX_ITER_R_CHANGE_NO_DECREASE_GLOBAL = 2
MAX_ITER_R_CHANGE_NO_DECREASE_LOCAL = 0
MAX_ITER_R_CHANGE_NO_DECREASE_CTF = 0
MAX_ITER_RES_NO_IMPROVE = 2
T_VARI_DECREASE = 0.02
R_CHANGE_DECREASE = 0.5
FSC_INCREASE = 0.005
CUTOFF_BEYOND_RES = 0

EDGE_WIDTH_RL = 6.0  # include/Macro.h

# a K-class round inserts into one K-fold accumulator while that holds at
# most this many bytes (K n_vox rows x 24 channels x 4 B in 3D, 12 in 2D),
# and otherwise one class at a time with the other classes' weights zeroed
# (the JAX package's rule, thunder_tpu/core/optimiser.py:1428-1429)
FUSED_CLASS_BYTES = 3e9


def _digest(x):
    """A checksum of float32 tensor ``x``'s bits, taken on its device: the
    exact integer sum of its 32-bit words, the same on every card."""
    return int(x.detach().contiguous().view(torch.int32).sum(
        dtype=torch.int64))


def _centroid(vol):
    """Density centroid of a (n, n, n) map in centred (x, y, z) voxel
    coordinates, negative density clipped (the subtraction region's
    centre, src/Optimiser.cpp:4195)."""
    v = np.maximum(np.asarray(vol, np.float64), 0.0)
    n = vol.shape[-1]
    g = np.mgrid[:n, :n, :n].astype(np.float64) - n // 2  # (z, y, x)
    tot = max(v.sum(), 1e-30)
    return np.array([(g[2] * v).sum(), (g[1] * v).sum(),
                     (g[0] * v).sum()]) / tot


def stat_mas(x):
    """Median + scaled MAD (stat_MAS, src/Functions/Functions.cpp:254-275)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.0, 0.0
    med = float(np.median(x))
    return med, float(np.median(np.abs(x - med))) * 1.4826


@dataclasses.dataclass
class LadderState:
    """Frequency ladder + search-type state machine (Model.cpp:1147-1727);
    host-side, identical to the JAX package's."""

    r: int
    r_global: int
    r_init: int
    max_r: int
    search_type: int = SEARCH_TYPE_GLOBAL
    criterion: str = "t_vari"
    t_vari_s0: float = np.inf
    t_vari_s1: float = np.inf
    r_change: float = np.inf
    fsc_area: float = 0.0
    n_no_decrease: int = 0
    increase_r: bool = False
    res: int = 1
    res_top: int = 1
    n_top_res_no_improve: int = 0

    def _record_stall(self, stalled):
        self.n_no_decrease = self.n_no_decrease + 1 if stalled else 0
        limit = {
            SEARCH_TYPE_GLOBAL: MAX_ITER_R_CHANGE_NO_DECREASE_GLOBAL,
            SEARCH_TYPE_LOCAL: MAX_ITER_R_CHANGE_NO_DECREASE_LOCAL,
            SEARCH_TYPE_CTF: MAX_ITER_R_CHANGE_NO_DECREASE_CTF,
        }.get(self.search_type, 10 ** 9)
        self.increase_r = (self.search_type != SEARCH_TYPE_STOP
                           and self.n_no_decrease >= limit)

    def record_t_vari(self, s0, s1):
        """MODEL_DETERMINE_INCREASE_R_T_VARI (src/Model.cpp:1627-1677)."""
        prev0, prev1 = self.t_vari_s0, self.t_vari_s1
        self.t_vari_s0, self.t_vari_s1 = s0, s1
        self._record_stall((s0 > (1 - T_VARI_DECREASE) * prev0)
                           and (s1 > (1 - T_VARI_DECREASE) * prev1))

    def record_r_change(self, rc):
        prev = self.r_change
        self.r_change = rc
        self._record_stall(rc > (1 - R_CHANGE_DECREASE) * prev)

    def record_fsc_area(self, area):
        prev = self.fsc_area
        self.fsc_area = area
        self._record_stall(area < (1 + FSC_INCREASE) * prev)

    def elevate(self, res_shell):
        """Model::elevateR (Model.cpp:1233-1253)."""
        self.res = res_shell
        self.res_top = max(self.res_top, res_shell)
        if not self.increase_r:
            return
        if self.search_type == SEARCH_TYPE_GLOBAL:
            step = int(np.ceil((self.r_global - self.r_init) / 2))
            self.r = max(self.r, min(res_shell + 1 + CUTOFF_BEYOND_RES,
                                     self.r + step))
            self.r = min(self.r, self.r_global, self.max_r)
        else:
            cap = int(np.ceil(min(self.r * np.sqrt(1.5),
                                  self.r + (self.max_r - self.r_global) / 8)))
            self.r = max(self.r, min(res_shell + 1 + CUTOFF_BEYOND_RES, cap))
            self.r = min(self.r, self.max_r)

    def transition(self, l_search, c_search):
        """Model::searchType (Model.cpp:1417-1516)."""
        if self.search_type == SEARCH_TYPE_STOP:
            return self.search_type
        if self.search_type in (SEARCH_TYPE_LOCAL, SEARCH_TYPE_CTF):
            if self.increase_r:
                if self.res > self.res_top:
                    self.n_top_res_no_improve = 0
                else:
                    self.n_top_res_no_improve += 1
                if self.n_top_res_no_improve >= MAX_ITER_RES_NO_IMPROVE:
                    if self.search_type == SEARCH_TYPE_LOCAL and c_search:
                        self.search_type = SEARCH_TYPE_CTF
                        self._reset_counters()
                    else:
                        self.search_type = SEARCH_TYPE_STOP
        elif self.increase_r and self.r >= self.r_global:
            if l_search:
                self.search_type = SEARCH_TYPE_LOCAL
                self._reset_counters()
            else:
                self.search_type = SEARCH_TYPE_STOP
        return self.search_type

    def _reset_counters(self):
        self.t_vari_s0 = self.t_vari_s1 = np.inf
        self.n_no_decrease = 0
        self.n_top_res_no_improve = 0
        self.increase_r = False

    @property
    def r_u(self):
        """Reconstruction band = r + maxR/3 (Model::updateRU)."""
        return min(self.r + int(round(self.max_r / 3)), self.max_r)


class Optimiser:
    """One rank's optimiser on one device. ``device`` defaults to CUDA;
    ``draws`` defaults to a ``Draws`` generator seeded with ``para.seed``;
    ``mesh`` (``parallel.mesh.Mesh``) defaults to ``make_mesh()``, the
    (half, data) layout of the process group this process joined (one rank
    without one)."""

    DEFAULT_IMAGE_BATCH = 64

    def __init__(self, para: Para, device=None, draws=None, mesh=None):
        # the kernels are picked by the tensors' device; no other choice
        # of the JAX package's backends exists here
        if para.fused_kernels != "auto":
            raise ValueError(f"fused_kernels={para.fused_kernels!r}: the "
                             "port only takes 'auto' (kernel K1 on CUDA)")
        if para.insert_impl != "auto":
            raise ValueError(f"insert_impl={para.insert_impl!r}: the port "
                             "only takes 'auto' (kernel K2 on CUDA)")
        self.para = para
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else Draws(para.seed,
                                                           self.device)
        self.mesh = make_mesh() if mesh is None else mesh
        self.sym = Symmetry(para.sym)
        self.dims = 2 if para.mode == "2d" else 3
        self.n = para.size
        self.iteration = 0
        self.history = []
        self._rank_gaps = {}
        self.log = get_logger("ROUND")
        n, ps = para.size, para.pixel_size
        a2p = lambda res_a: max(1, int(round(n * ps / res_a)))
        self.max_r = n // 2 - int(np.ceil(para.a))
        self.ladder = LadderState(
            r=min(a2p(para.init_res), self.max_r),
            r_global=min(a2p(para.global_search_res), self.max_r),
            r_init=min(a2p(para.init_res), self.max_r),
            max_r=self.max_r,
            search_type=(SEARCH_TYPE_GLOBAL if para.g_search
                         else SEARCH_TYPE_LOCAL),
            criterion=para.increase_r_criterion,
        )
        self.r_low = max(1, int(round(n * ps / para.ignore_res))
                         if para.ignore_res > 0 else 1)

    def _t(self, x, dtype=None):
        """Host array -> a tensor copy on this optimiser's device."""
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def planes(self):
        """This rank's planes of the (2, S) half-plane layout, a slice of
        the half axis: its hemisphere on (2, W/2), both on (1, W)."""
        return self.mesh.planes

    @property
    def rows(self):
        """This rank's slots of the (2, S) half-plane layout, a slice of S;
        every per-image tensor holds these rows of ``planes`` only."""
        return self.mesh.block(self.s_slots)[1]

    def _local(self, a):
        """A global host (2, S, ...) layout array -> this rank's block."""
        return a[self.planes, self.rows]

    @property
    def _draws(self):
        """``draws`` cut to this rank's block (every rank draws the global
        batch)."""
        return RowDraws(self.draws, self.rows, self.planes)

    # ------------------------------------------------------------------ data

    def set_data(self, imgs, ctf_params, group_ids=None, halves=None):
        """imgs: (N, n, n) real-space particle images (object at centre);
        ctf_params: dict of (N,) arrays (voltage, defocus_u, defocus_v,
        defocus_theta, cs, amp_contrast[, phase_shift]). Builds the
        half-plane layout with the JAX package's seeded shuffle split and
        keeps this rank's rows."""
        imgs = np.asarray(imgs, dtype=np.float32)
        self._set_layout(imgs.shape[0], ctf_params, group_ids, halves)
        self._set_images(imgs[self._local(self.plane_index)])

    def _set_layout(self, n_imgs, ctf_params, group_ids, halves):
        """The global half-plane layout of ``n_imgs`` images, and this
        rank's block's CTF parameters and fresh per-image state."""
        self.n_imgs = n_imgs
        if halves is None:
            perm = np.random.default_rng(self.para.seed).permutation(
                self.n_imgs)
            halves = np.zeros(self.n_imgs, np.int32)
            halves[perm[self.n_imgs // 2:]] = 1
        self.halves = np.asarray(halves, np.int32)
        idx_h = [np.nonzero(self.halves == h)[0] for h in (0, 1)]
        s = max(max(len(i) for i in idx_h), 1)
        self.s_slots = s
        self.plane_index = np.zeros((2, s), np.int64)
        self.plane_valid = np.zeros((2, s), np.float32)
        for h in (0, 1):
            self.plane_index[h, :len(idx_h[h])] = idx_h[h]
            self.plane_valid[h, :len(idx_h[h])] = 1.0
        if self.mesh.n_data > s:
            raise ValueError(f"{self.mesh.n_data} data ranks for {s} "
                             "slots a half: run at most one rank a slot")
        gid = (np.zeros(self.n_imgs, np.int32) if group_ids is None
               else np.asarray(group_ids, np.int32))
        self.group_ids = gid
        self.n_groups = int(gid.max()) + 1
        self.groups_plane = gid[self.plane_index]
        loc = self._local(self.plane_index)
        self.ctf_params = {k: self._t(np.asarray(v, np.float32)[loc])
                           for k, v in ctf_params.items()}
        if "phase_shift" not in self.ctf_params:
            self.ctf_params["phase_shift"] = torch.zeros(
                loc.shape, dtype=real_dtype, device=self.device)
        self.offsets = torch.zeros(loc.shape + (2,), dtype=real_dtype,
                                   device=self.device)
        self.scale = np.ones(self.n_groups, np.float32)
        self.par = particle.make_state(loc.shape, self.para.m_l_r,
                                       self.para.m_l_t, self.para.m_l_d,
                                       device=self.device)
        self.scores = torch.ones(loc.shape, dtype=real_dtype,
                                 device=self.device)

    def _set_images(self, imgs_plane):
        """This rank's (lh, s_loc, n, n) images -> the preprocessed
        unmasked and masked spectra."""
        imgs_norm, alpha = self._preprocess(self._t(imgs_plane))
        self.imgs_ft_ori = fft_ops.fft2_center(imgs_norm)
        self.imgs_ft = (fft_ops.fft2_center(imgs_norm * alpha)
                        if self.para.zero_mask else self.imgs_ft_ori)

    def set_data_from_dataset(self, ds):
        """Data from a ``data.ParticleDataset``: the dataset's seeded
        halves, 0-based groups and CTF columns as in ``set_data``, and the
        images of this rank's block read from their stacks (each rank reads
        its own: on (2, W/2) only its hemisphere's; an empty slot holds
        zeros, as in the JAX package); the
        particle and micrograph paths and the micrograph coordinates carried
        into the .thu output."""
        self._set_layout(ds.n, ds.ctf_params(), ds.group_ids, ds.halves)
        loc = self._local(self.plane_index)
        valid = self._local(self.plane_valid) > 0
        ids = np.unique(loc[valid])
        imgs = np.zeros(loc.shape + (self.n, self.n), np.float32)
        if ids.size:
            imgs[valid] = ds.load_images(ids)[np.searchsorted(ids,
                                                              loc[valid])]
        self._set_images(imgs)
        self.particle_paths = ds.table.particle_paths
        self.micrograph_paths = ds.table.micrograph_paths
        self.coords_xy = np.asarray(ds.table.values[
            :, (ThuColumns.COORDINATE_X, ThuColumns.COORDINATE_Y)],
            np.float64)
        get_logger("INIT").info(
            "dataset: %d particles, %d groups, %d slots/half; this host "
            "loaded %d local slices", self.n_imgs, self.n_groups,
            self.s_slots, ids.size)

    def load_poses(self, quats, trans, defocus=None, classes=None,
                   k123=None, std_t=None):
        """Resume from stored poses (Particle::load via loadParticles,
        src/Optimiser.cpp:5312-5385): every support point at the stored
        pose, concentrations k1..k3 (default 0.01) clamped to >= 1e-5 and
        translation stddevs (default 1) to >= 0.1. Image-order arrays; in
        2D a stored rotation about z, (cos(phi/2), 0, 0, sin(phi/2)),
        becomes the support convention (cos phi, sin phi, 0, 0). Each rank
        keeps its own rows."""
        loc = self._local(self.plane_index)
        plane = lambda a, dt=np.float32: np.asarray(a, dt)[loc]
        q = plane(quats)
        if self.dims == 2:
            phi = 2.0 * np.arctan2(q[..., 3], q[..., 0])
            z = np.zeros_like(phi)
            q = np.stack([np.cos(phi), np.sin(phi), z, z], axis=-1)
        par = dict(self.par)
        n_r, n_t = par["r"].shape[2], par["t"].shape[2]
        q, t = self._t(q, real_dtype), self._t(plane(trans), real_dtype)
        par["r"] = q[:, :, None, :].expand(-1, -1, n_r, -1).clone()
        par["t"] = t[:, :, None, :].expand(-1, -1, n_t, -1).clone()
        par["topR"], par["topT"] = q, t
        if classes is not None:
            par["c"] = self._t(plane(classes, np.int32))
        shape = loc.shape
        for i, name in enumerate(("k1", "k2", "k3")):
            v = (plane(k123[i]) if k123 is not None
                 else np.full(shape, 0.01, np.float32))
            par[name] = self._t(np.maximum(v, 1e-5))
        for i, name in enumerate(("s0", "s1")):
            v = (plane(std_t[i]) if std_t is not None
                 else np.ones(shape, np.float32))
            par[name] = self._t(np.maximum(v, 0.1))
        if defocus is not None:
            d = self._t(plane(defocus))
            par["d"] = d[:, :, None].expand(-1, -1, par["d"].shape[2]).clone()
            par["topD"] = d
        self.par = par

    def _from_plane(self, plane_arr):
        """This rank's (lh, s_loc, ...) block -> (N, ...) NumPy of every
        image in image order: a collective, which every rank must reach."""
        a = distributed.gather_plane(
            torch.as_tensor(plane_arr),
            self.mesh.blocks(self.s_slots)).detach().cpu().numpy()
        a = a.reshape((-1,) + a.shape[2:])
        sel = self.plane_valid.ravel() > 0
        out = np.zeros((self.n_imgs,) + a.shape[1:], a.dtype)
        out[self.plane_index.ravel()[sel]] = a[sel]
        return out

    @property
    def best_quat(self):
        return self._from_plane(self.par["topR"])

    @property
    def best_trans(self):
        return self._from_plane(self.par["topT"])

    @property
    def best_defocus(self):
        return self._from_plane(self.par["topD"])

    @property
    def best_class(self):
        return self._from_plane(self.par["c"])

    @property
    def best_phi(self):
        """2D in-plane angle from the (cos, sin) support convention."""
        top = self.par["topR"]
        return self._from_plane(torch.atan2(top[..., 1], top[..., 0]))

    def _preprocess(self, imgs):
        """Background ring statistics -> zero-mean, unit-std background
        (src/Optimiser.cpp:4608-4720). Returns (images, soft mask)."""
        n = self.n
        alpha = soft_mask_shape((n, n), self.para.mask_radius_px,
                                EDGE_WIDTH_RL, device=self.device)
        bg_w = 1.0 - alpha
        denom = torch.clamp(torch.sum(bg_w), min=1.0)
        mean = torch.sum(imgs * bg_w, dim=(-2, -1), keepdim=True) / denom
        var = torch.sum(((imgs - mean) ** 2) * bg_w, dim=(-2, -1),
                        keepdim=True) / denom
        return (imgs - mean) / torch.sqrt(torch.clamp(var, min=1e-12)), alpha

    def _ffts(self):
        """(centered FFT, inverse) of this mode's maps."""
        if self.dims == 2:
            return fft_ops.fft2_center, fft_ops.ifft2_center
        return fft_ops.fft3_center, fft_ops.ifft3_center

    def init_reference(self, vol=None):
        """Provided volume (image in 2D mode, or a soft sphere / disk),
        low-passed to the initial resolution, replicated to both halves and
        all classes: refs (2, K, n, n[, n])."""
        n, dims = self.n, self.dims
        # the reference re-balances the intensity scale at init only when
        # a model was given (src/Optimiser.cpp:531-539)
        self._init_model_given = vol is not None
        if vol is None:
            vol = soft_mask_shape((n,) * dims, n / 8, n / 8,
                                  device=self.device)
        vol = (vol.to(self.device, real_dtype) if torch.is_tensor(vol)
               else self._t(vol, real_dtype))
        fftc, ifftc = self._ffts()
        ft = low_pass_filter(fftc(vol), self.ladder.r / n, 3.0 / n, dims)
        vol = ifftc(ft).real
        # 2D classes start identical and are told apart by the stochastic
        # class draw of the global scan
        self.refs = vol[None, None].repeat(2, self.para.k, *(1,) * dims)

    def init_sigma(self):
        """Initial per-group noise spectra: shell power / 2."""
        n = self.n
        ps = spectrum.power_spectrum(self.imgs_ft, n // 2, 2)  # (2, S, sh)
        w = self._t(self._local(self.plane_valid))
        g = self._t(self._local(self.groups_plane)).long().reshape(-1)
        sums = torch.zeros((self.n_groups, n // 2), dtype=torch.float32,
                           device=self.device).index_add_(
            0, g, (ps * w[..., None]).reshape(-1, n // 2))
        cnt = torch.zeros(self.n_groups, dtype=torch.float32,
                          device=self.device).index_add_(0, g, w.reshape(-1))
        sums = distributed.all_reduce_sum(sums).cpu().numpy()
        cnt = distributed.all_reduce_sum(cnt).cpu().numpy()
        sig = sums / np.maximum(cnt[:, None], 1.0)
        sig = np.where(cnt[:, None] > 0, sig, 1.0)
        self.sig = self._t(np.maximum(sig / 2, 1e-10).astype(np.float32))

    # ----------------------------------------------------------- device prep

    def _check_nan(self, stage, arrays):
        """Per-stage finite checks under ``para.debug_nan`` (the
        reference's CHECK_NAN macros, include/Config.h). Costs one host
        sync per array; nothing when the flag is off."""
        if not self.para.debug_nan:
            return
        for name, v in arrays.items():
            a = torch.as_tensor(v)
            if a.is_complex():
                a = a.abs()
            if not bool(torch.isfinite(a).all()):
                self.log.error("NaN/Inf in %s after %s (round %d)",
                               name, stage, self.iteration)
                raise FloatingPointError(
                    f"non-finite values in '{name}' after {stage} "
                    f"(round {self.iteration})")

    def _ring(self):
        return pixels.pixel_ring(self.n, self.r_low, self.ladder.r)

    def _ring_tensors(self, ring):
        return (self._t(ring.col).long(), self._t(ring.row).long(),
                self._t(ring.mask))

    def _chunk(self):
        b = self.para.image_batch or self.DEFAULT_IMAGE_BATCH
        return max(1, min(b, self.rows.stop - self.rows.start))

    def _bricks(self, r_band=None):
        """(lh, K, ...) Hermitian half-space brick tables of this rank's
        halves, cached per (refs identity, band bucketed to multiples of 8
        shells)."""
        r_band = self.ladder.r if r_band is None else r_band
        r_band = min(-(-int(r_band) // 8) * 8, self.n // 2 - 1)
        c = getattr(self, "_brick_cache", None)
        if c is not None and c[0] is self.refs and c[1] == r_band:
            return c[2]
        dt = torch.bfloat16 if self.para.table_bf16 else torch.float32
        refs = self.refs[self.planes]
        if self.dims == 2:
            tabs = projector.build_brick_projectee_2d(
                refs, r_band, pf=self.para.pf, dtype=dt)
            self._brick_cache = (self.refs, r_band, tabs)
            return tabs
        tabs = torch.stack([torch.stack([
            projector.build_brick_projectee_3d(
                ref[k], r_band, pf=self.para.pf, dtype=dt, half=True)
            for k in range(self.para.k)]) for ref in refs])
        self._brick_cache = (self.refs, r_band, tabs)
        return tabs

    def _plane_ring_data(self, ring, ori=False, refined_defocus=False):
        """Observed pixels, CTF and sigma reciprocal on the ring,
        (lh, S, P) each. ``ori`` reads the unmasked stack; the masked one,
        dropped before the final round, is rebuilt when asked for."""
        if not ori and self.imgs_ft is None:
            self._rebuild_masked_stack()
        stack = self.imgs_ft_ori if ori else self.imgs_ft
        col, row, _ = self._ring_tensors(ring)
        nn = stack.shape[-1]
        dat = stack[..., row + nn // 2, col + nn // 2]
        cp = self.ctf_params
        dfac = self.par["topD"] if refined_defocus else 1.0
        c = ctf_ops.ctf_pixels(
            col.float(), row.float(), self.n, self.para.pixel_size,
            cp["voltage"], cp["defocus_u"], cp["defocus_v"],
            cp["defocus_theta"], cp["cs"], cp["amp_contrast"],
            cp["phase_shift"], defocus_factor=dfac)
        g = self._t(self._local(self.groups_plane)).long()
        sig_px = self.sig[g[..., None], self._t(ring.sig).long()[None, None]]
        return dat, c, likelihood.sigma_reciprocal(sig_px)

    def _sym_quats(self):
        if self.dims == 2:
            return torch.zeros((0, 4), dtype=real_dtype, device=self.device)
        return self._t(self.sym.quat.astype(np.float32)).reshape(-1, 4)

    # ------------------------------------------------------------ expectation

    def global_scan(self):
        """Phase A: dense pose scan + filter seeding (engine.scan_init)."""
        para = self.para
        ring = self._ring()
        col, row, pmask = self._ring_tensors(ring)
        n_r = sampling.n_scan_rotations(para.m_s, self.sym.n_elements,
                                        para.mode)
        n_t = sampling.n_scan_translations(para.trans_s,
                                           para.trans_search_factor)
        if self.dims == 2:
            un, tn = self.draws.scan_grid_2d(n_r, n_t)
            phis = sampling.sample_rotations_2d(un)
            rots = quat.rotate2d(phis)
            # support convention: (cos phi, sin phi) in the first two slots
            z = torch.zeros_like(phis)
            quats = torch.stack([torch.cos(phis), torch.sin(phis), z, z], -1)
        else:
            rn, tn = self.draws.scan_grid(n_r, n_t)
            quats = sampling.sample_rotations_3d(
                rn, self._sym_quats() if self.sym.n_elements else None)
            rots = quat.rotate3d(quats)
        trans = sampling.sample_translations(tn, para.trans_s)
        tra = translation_phase(col, row, trans[:, 0], trans[:, 1], self.n)
        bricks = self._bricks()
        dat, c, sig_rcp = self._plane_ring_data(ring)
        gumbel, u0_r, u0_t = self._draws.scan_seed(
            self.iteration, (2, self.s_slots), para.k)
        st, _ = engine.scan_init(
            bricks, rots, quats, tra, trans, col, row, pmask, dat, c,
            sig_rcp, gumbel, u0_r, u0_t, pf=para.pf, m_l_r=para.m_l_r,
            m_l_t=para.m_l_t, m_l_d=para.m_l_d, chunk=self._chunk(),
            mode=para.mode)
        for k in ("d", "topD", "sD"):
            st[k] = self.par[k]
        self.par = st

    def local_search(self):
        """Phase B for every image (engine.local_search). Returns the mean
        translation stddevs (tVari)."""
        para = self.para
        ring = self._ring()
        col, row, pmask = self._ring_tensors(ring)
        if self.ladder.search_type == SEARCH_TYPE_GLOBAL:
            min_phase = particle.MIN_N_PHASE_PER_ITER_GLOBAL
            perturb_s = para.perturb_factor_s_global
        else:
            min_phase = particle.MIN_N_PHASE_PER_ITER_LOCAL
            perturb_s = para.perturb_factor_s_local
        ctf_search = self.ladder.search_type == SEARCH_TYPE_CTF
        bricks = self._bricks()
        dat, c, sig_rcp = self._plane_ring_data(ring)
        draw = self._draws.phase_draws(
            self.iteration, (2, self.s_slots), para.m_l_r, para.m_l_t,
            mode=para.mode, n_d=self.par["d"].shape[2] if ctf_search else 0)
        st, nph = engine.local_search(
            bricks, col, row, pmask, dat, c, sig_rcp, self.par, draw,
            self._sym_quats(), para.perturb_factor_l, perturb_s,
            pf=para.pf, n=self.n, min_phase=min_phase, mode=para.mode,
            cp=engine.pack_ctf(self.ctf_params) if ctf_search else None,
            factor_d=para.perturb_factor_s_ctf, pixel_size=para.pixel_size)
        self.phase_counts = nph
        self.par = st
        self.scores = particle.compress_r(st)
        w = self._t(self._local(self.plane_valid))
        denom = max(float(self.plane_valid.sum()), 1.0)
        tv = distributed.all_reduce_sum(torch.stack([
            torch.sum(st["s0"] * w), torch.sum(st["s1"] * w)])).tolist()
        return tv[0] / denom, tv[1] / denom

    # ---------------------------------------------------------- maximization

    def _residual_stats(self):
        """Rank-1 residual statistics (engine.residual_stats): group sigma
        sums, scale-fit terms, per-image norm and ori shells."""
        ring = self._ring()
        bricks = self._bricks(r_band=int(np.ceil(ring.r_high)))
        col, row, pmask = self._ring_tensors(ring)
        dat, c, _ = self._plane_ring_data(ring, refined_defocus=True)
        dat_ori, _, _ = self._plane_ring_data(ring, ori=True)
        state = {k: self.par[k] for k in ("topR", "topT", "c")}
        sig, cnt, xa, aa, norms, oris = engine.residual_stats(
            bricks, col, row, self._t(ring.sig), pmask, dat, dat_ori, c,
            state, self._t(self._local(self.groups_plane)),
            self._t(self._local(self.plane_valid)), self.offsets,
            pf=self.para.pf, n=self.n, n_groups=self.n_groups,
            n_shell=self.n // 2)
        shell_n = np.zeros(self.n // 2, np.float64)
        np.add.at(shell_n, np.asarray(ring.sig)[np.asarray(ring.mask) > 0], 1)
        f64 = lambda x: distributed.all_reduce_sum(x).cpu().numpy().astype(
            np.float64)
        return (f64(sig), f64(cnt), f64(xa), f64(aa), norms, shell_n, oris)

    def maximization_sigma(self, stats=None, sig_override=None):
        """allReduceSigma (src/Optimiser.cpp:6397-6710): sig(group, shell)
        = mean power of the residual at the rank-1 pose / 2 below r.

        sig_override: (sig_sums, cnt) replacing the stats pass's group
        sums (engine.sigma_rescaled after norm correction)."""
        if sig_override is not None:
            sig_sums, cnt = (x.cpu().numpy() for x in sig_override)
            shell_n = (stats or self._residual_stats())[5]
        else:
            sig_sums, cnt, _, _, _, shell_n, _ = (
                stats or self._residual_stats())
        sig = (sig_sums / np.maximum(shell_n, 1.0)[None, :]
               / np.maximum(cnt, 1.0)[:, None] / 2)
        r = self.ladder.r
        new_sig = self.sig.cpu().numpy().copy()
        new_sig[:, :r] = np.maximum(sig[:, :r], 1e-10)
        new_sig[:, r:] = new_sig[:, r - 1:r]
        self.sig = self._t(new_sig.astype(np.float32))

    # ------------------------------------------- scale and norm corrections

    def _r_s(self):
        """Scale-correction band (Optimiser::refreshScale,
        src/Optimiser.cpp:5749-5766): the FSC crossing at thresSclCorFSC
        after the first round, the sclCorRes band before, clamped to r."""
        para = self.para
        fsc = getattr(self, "fsc", None)
        if self.iteration > 0 and fsc is not None:
            r_s = spectrum.res_p(torch.as_tensor(fsc[0]),
                                 para.thres_scl_cor_fsc, r_low=1)
        else:
            r_s = max(1, int(round(self.n * para.pixel_size
                                   / para.scl_cor_res)))
        return min(r_s, self.ladder.r)

    def refresh_scale(self, group=True, stats=None):
        """Per-group intensity scale from a data-vs-projection fit
        (Optimiser::refreshScale src/Optimiser.cpp:5749-6063): scale_g =
        sum XA / sum AA over shells [rL, rS), clamped to [median / 5,
        median * 5]. Host NumPy on the stats pass's group sums."""
        _, _, xa_sh, aa_sh, _, _, _ = stats or self._residual_stats()
        lo, hi = self.r_low, max(self._r_s(), self.r_low + 1)
        xa = xa_sh[:, lo:hi].sum(axis=1)
        aa = aa_sh[:, lo:hi].sum(axis=1)
        if not group:
            xa[:] = xa.sum()
            aa[:] = aa.sum()
        scale = np.abs(xa / np.maximum(aa, 1e-30))
        med = np.median(scale)
        return np.clip(scale, med / 5, med * 5).astype(np.float32)

    def correct_scale(self, init=False, group=True):
        """Apply the refreshed scale (Optimiser::correctScale,
        src/Optimiser.cpp:5103-5144). At init, one global scale fitted at
        RANDOM projections (refreshScale coord=false, :5791-5822; the
        filter's initial poses are all identity) multiplies the
        references; afterwards the image stacks are divided by their group
        scale and sigma by its square."""
        if init:
            s2 = self.s_slots
            if self.dims == 2:
                phis = self._draws.scale_angles((2, s2))
                z = torch.zeros_like(phis)
                rand_q = torch.stack([torch.cos(phis), torch.sin(phis), z, z],
                                     -1)
            else:
                rand_q = quat.normalize(self._draws.scale_quats((2, s2)))
            saved = {k: self.par[k] for k in ("topR", "topT")}
            self.par = {**self.par, "topR": rand_q,
                        "topT": torch.zeros_like(saved["topT"])}
            stats = self._residual_stats()
            self.par = {**self.par, **saved}
            scale = self.refresh_scale(group=False, stats=stats)
            s = float(scale[self.group_ids[0]])
            self.refs = self.refs * s
            self.log.info("init scale correction: refs *= %.4f", s)
        else:
            scale = self.refresh_scale(group=group)
            s_img = self._t(scale)[self._t(self._local(
                self.groups_plane)).long()][..., None, None]
            self.imgs_ft = self.imgs_ft / s_img
            self.imgs_ft_ori = self.imgs_ft_ori / s_img
            self.sig = self.sig / self._t(scale[:, None] ** 2)
        self.scale = scale

    def norm_correction(self, stats=None):
        """Optimiser::normCorrection (src/Optimiser.cpp:6201-6394): per-
        image residual power over [rL, rNorm) on the masked stack at the
        rank-1 pose; both stacks are rescaled by sqrt(median / norm_l).
        Returns the (lh, S) factors (1 on invalid slots) for
        engine.sigma_rescaled. The median is over every rank's valid
        slots."""
        _, _, _, _, norms, _, _ = stats or self._residual_stats()
        fsc = getattr(self, "fsc", None)
        r_norm = self.ladder.r if fsc is None else min(
            self.ladder.r,
            spectrum.res_p(torch.as_tensor(fsc[0]), 0.75, r_low=1))
        hi = max(r_norm, self.r_low + 1)
        norm = torch.sum(norms[..., self.r_low:hi], dim=-1)
        valid = self._t(self._local(self.plane_valid)) > 0
        # the median of the valid slots, the mean of the two middle values
        # for an even count as in NumPy (torch.nanmedian takes the lower)
        m = torch.nanquantile(torch.where(
            self._t(self.plane_valid) > 0,
            distributed.gather_plane(norm, self.mesh.blocks(self.s_slots)),
            float("nan")), 0.5)
        fac = torch.sqrt(m / torch.clamp(norm, min=1e-30))
        fac = torch.where(valid, fac, torch.ones_like(fac))
        self.imgs_ft = self.imgs_ft * fac[..., None, None]
        self.imgs_ft_ori = self.imgs_ft_ori * fac[..., None, None]
        return fac

    # ------------------------------------------------ re-centre and re-mask

    def _zero_mask_2d(self):
        n = self.n
        return soft_mask_shape((n, n), self.para.mask_radius_px,
                               EDGE_WIDTH_RL, device=self.device)

    def re_centre_img(self):
        """Optimiser::reCentreImg (src/Optimiser.cpp:6065-6093): fold each
        image's rank-1 translation into its offset, shift the filter's
        translation support by it, and rebuild the masked stack from the
        never-moved original stack."""
        tran = self.par["topT"]                             # (lh, S, 2)
        self.offsets = self.offsets - tran
        self.par["t"] = self.par["t"] - tran[:, :, None, :]
        self.par["topT"] = torch.zeros_like(tran)
        self._rebuild_masked_stack()

    def _rebuild_masked_stack(self):
        """_img = mask(translate(_imgOri, offset)) (reCentreImg +
        reMaskImg, src/Optimiser.cpp:6065-6153)."""
        off = self.offsets
        shifted = translate_ft(self.imgs_ft_ori, off[..., 0], off[..., 1])
        if self.para.zero_mask:
            rl = fft_ops.ifft2_center(shifted).real * self._zero_mask_2d()
            self.imgs_ft = fft_ops.fft2_center(rl)
        else:
            self.imgs_ft = shifted

    def re_mask_img(self):
        """Optimiser::reMaskImg (src/Optimiser.cpp:6093-6153): re-apply the
        zero-noise soft mask to the working stack."""
        if not self.para.zero_mask:
            return
        rl = fft_ops.ifft2_center(self.imgs_ft).real * self._zero_mask_2d()
        self.imgs_ft = fft_ops.fft2_center(rl)

    def _auto_recentre_refs(self):
        """solventFlatten's refAutoRecentre branch (src/Optimiser.cpp:
        7390-7425): translate each reference by -O, the symmetrised
        insert offset, so its density centre returns to the box centre;
        3D maps only, and not when a mask volume was provided (its frame
        is fixed)."""
        if self.dims == 2 or getattr(self, "mask_vol", None) is not None:
            return
        o = self.insert_offsets                              # (2, K, 3)
        self.refs = torch.stack([torch.stack([
            fft_ops.ifft3_center(translate_ft_3d(
                fft_ops.fft3_center(self.refs[h, k]), -float(o[h, k, 0]),
                -float(o[h, k, 1]), -float(o[h, k, 2]))).real
            for k in range(self.para.k)]) for h in range(2)])

    def set_mask(self, vol):
        """A provided reference mask volume (n, n, n) in [0, 1]."""
        self.mask_vol = self._t(np.asarray(vol, np.float32))

    def solvent_flatten(self, use_mask=False):
        """Soft-mask every reference with zero background
        (src/Optimiser.cpp:7768-7990): with ``use_mask`` in 3D and a mask
        volume set, that volume low-passed to the current band (clamped to
        [0, 1]); otherwise the spherical mask."""
        n = self.n
        if (use_mask and self.dims == 3
                and getattr(self, "mask_vol", None) is not None):
            m_ft = low_pass_filter(fft_ops.fft3_center(self.mask_vol),
                                   self.ladder.r / n, 4.0 / n, 3)
            alpha = torch.clamp(fft_ops.ifft3_center(m_ft).real, 0.0, 1.0)
        else:
            alpha = soft_mask_shape((n,) * self.dims,
                                    self.para.mask_radius_px, EDGE_WIDTH_RL,
                                    device=self.device)
        self.refs = self.refs * alpha

    def refresh_class_distr(self):
        """Class fractions over the valid images (Optimiser::
        refreshClassDistr, src/Optimiser.cpp:5484-5517), as NumPy (K,)."""
        counts = distributed.all_reduce_sum(torch.zeros(
            self.para.k, dtype=torch.float32, device=self.device).index_add_(
            0, self.par["c"].long().reshape(-1),
            self._t(self._local(self.plane_valid)).reshape(-1))).cpu().numpy()
        self.c_distr = counts / max(counts.sum(), 1)
        return self.c_distr

    def balance_class(self, thres=0.05):
        """OPTIMISER_BALANCE_CLASS after a global round (determineBalance
        Class/balanceClass, src/Optimiser.cpp:5519-5593): a class holding
        fewer than thres/K of the images takes the reference of a class
        drawn in proportion to the excess distribution, its phases
        randomised past the current band, as the JAX package does (the
        reference copies it exactly; the random phases let the two classes
        separate again). The source class is drawn with NumPy from
        ``seed + iteration``, the phase fields from ``draws``."""
        para = self.para
        if para.k == 1:
            return
        distr = self.refresh_class_distr()
        rng = np.random.default_rng(para.seed + self.iteration)
        excess = np.where(distr < thres / para.k, 0.0,
                          distr - thres / para.k)
        if excess.sum() <= 0:
            return
        p_src = excess / excess.sum()
        fftc, ifftc = self._ffts()
        refs = self.refs
        for t in range(para.k):
            if distr[t] < thres / para.k:
                j = int(rng.choice(para.k, p=p_src))
                self.log.info("Round %d: class %d empty, resigned from class "
                              "%d (random-phased past shell %d)",
                              self.iteration, t, j, self.ladder.r)
                refs = refs.clone()  # a new tensor: the brick cache keys on it
                for h in (0, 1):
                    phi = self.draws.phase_field(tuple(refs.shape[2:]))
                    refs[h, t] = ifftc(spectrum.random_phase(
                        fftc(refs[h, j]), self.ladder.r, self.dims, phi)).real
        self.refs = refs

    def _golden_fsc(self, ft_a, ft_b):
        """Golden-standard FSC with the random-phase mask correction
        (Model::compareTwoHemispheres src/Model.cpp:407-546): the provided
        mask volume under ``mask_fsc``, else the spherical core under
        ``core_fsc``; the plain FRC in 2D mode."""
        para = self.para
        n = self.n
        fsc_u = spectrum.frc_fsc(ft_a, ft_b, n // 2, self.dims)
        use_mask = (para.mask_fsc
                    and getattr(self, "mask_vol", None) is not None)
        if not (use_mask or para.core_fsc) or self.dims == 2:
            return fsc_u
        alpha = (self.mask_vol if use_mask else soft_mask_shape(
            (n, n, n), para.mask_radius_px, EDGE_WIDTH_RL,
            device=self.device))
        r_rand = spectrum.res_p(fsc_u, 0.8, r_low=1)
        phi_a, phi_b = self.draws.fsc_phases(n)
        fft3, ifft3 = fft_ops.fft3_center, fft_ops.ifft3_center
        ra = ifft3(spectrum.random_phase(ft_a, r_rand, 3, phi_a)).real * alpha
        rb = ifft3(spectrum.random_phase(ft_b, r_rand, 3, phi_b)).real * alpha
        fsc_r = spectrum.frc_fsc(fft3(ra), fft3(rb), n // 2, 3)
        ma = ifft3(ft_a).real * alpha
        mb = ifft3(ft_b).real * alpha
        fsc_m = spectrum.frc_fsc(fft3(ma), fft3(mb), n // 2, 3)
        shells = torch.arange(n // 2, device=self.device)
        corrected = (fsc_m - fsc_r) / torch.clamp(1 - fsc_r, min=1e-6)
        return torch.where(shells < r_rand + 2, fsc_m, corrected)

    def _avg_hemi(self, ft_a, ft_b, band):
        """Average A/B below the FSC >= 0.95 band (Model::avgHemi)."""
        radius = (fft_ops.radius_grid_2d if self.dims == 2
                  else fft_ops.radius_grid_3d)
        u = torch.round(radius(ft_a.shape[-1], self.device)).long()
        mean_ft = (ft_a + ft_b) / 2
        low = u <= band
        ifftc = self._ffts()[1]
        return torch.stack([
            ifftc(torch.where(low, mean_ft, ft_a)).real,
            ifftc(torch.where(low, mean_ft, ft_b)).real])

    def _insert_kernel(self):
        """The gridding insert's kernel: trilinear (the reference's
        shipped choice, include/Config.h:97) or, with ``para.mkb_kernel``,
        the MKB blob (RECONSTRUCTOR_MKB_KERNEL, include/Config.h:95); the
        MKB branch is a 3D insert path only."""
        return ("mkb" if self.para.mkb_kernel and self.dims == 3
                else "trilinear")

    def insert_mc(self, r_u=None):
        """Crop size of the insert accumulator for band ``r_u`` (default the
        ladder's r_u): the table band is r_u bucketed to multiples of 8
        shells, capped at n // 2 - 2, as in the JAX package."""
        r_u = self.ladder.r_u if r_u is None else r_u
        r_tab = min(-(-int(np.ceil(r_u)) // 8) * 8, self.n // 2 - 2)
        return brick_ops.crop_size(r_tab, self.para.pf)

    def reconstruct(self, r_u=None, avg=True, final=False):
        """Gridding insert + fold, then per class point-group
        symmetrisation, per-half Wiener/C-balance, golden-standard FSC and
        hemisphere averaging (Model::compareTwoHemispheres,
        src/Model.cpp:307-850). With K > 1 classes one insert pass fills a
        K-fold accumulator while it holds at most FUSED_CLASS_BYTES; past
        that each class is inserted on its own with the other classes'
        weights zeroed (``insert_fused`` records which).

        ``avg=False`` keeps the halves independent (the final round,
        src/Optimiser.cpp:4124-4130); ``final`` also reconstructs each
        class's joined map from the two halves' summed accumulators with
        this round's FSC (saveMapJoin, :8832) into ``joined_maps``.

        Each rank inserts, symmetrises and reconstructs its own halves
        (``mesh``). The folded F/T and re-centring sums are summed over the
        hemisphere's data ranks after the insert (the JAX package's psum
        over the data axis). On (2, W/2) the two half maps and offsets are
        then gathered over the pair of ranks at this data index (each map
        held to its owner's digest, ``_gather_pair``) and the final
        round's F/T summed over it (the JAX package replicates
        them), so that the FSC and the averaging see both halves on every
        rank; rank 0's references and FSC then replace the others' (float
        atomics can part ranks in the last bit, and these steer the
        run)."""
        para = self.para
        dims, k_cls = self.dims, para.k
        r_u = self.ladder.r_u if r_u is None else r_u
        ring = pixels.pixel_ring(self.n, 0, r_u)
        col, row, pmask = self._ring_tensors(ring)
        mc = self.insert_mc(r_u)
        dat, c, _ = self._plane_ring_data(ring, ori=True,
                                          refined_defocus=True)
        n_draw = min(para.m_reco, para.m_l_r)
        scores = self.scores if para.par_gra else torch.ones_like(self.scores)
        w_img = scores * self._t(self._local(self.plane_valid)) / n_draw
        state = {k: self.par[k] for k in ("r", "t", "c")}
        ri, ti = self._draws.insert(self.iteration, (2, self.s_slots), n_draw,
                                    state["r"].shape[2], state["t"].shape[2])
        if dims == 3 and self.sym.n_elements:
            if not hasattr(self, "_sym_split_cache"):
                self._sym_split_cache = reconstructor.split_grid_exact(
                    self.sym.rot)
            exact_ops, gen_rots = self._sym_split_cache
        else:
            exact_ops, gen_rots = (), np.zeros((0, 3, 3), np.float32)

        reco_t = {"insert": 0.0, "wiener_fsc": 0.0, "avg": 0.0}
        t_last = time.perf_counter()

        def _mark(name):
            nonlocal t_last
            self._sync()
            now = time.perf_counter()
            reco_t[name] += now - t_last
            t_last = now

        kernel = self._insert_kernel()

        def insert(k_classes, st, w):
            out = engine.insert_fold_reduce(
                col, row, pmask, dat, c, st, ri, ti, w, self.offsets,
                pf=para.pf, n=self.n, mc=mc, chunk=self._chunk(),
                k_classes=k_classes, mode=para.mode, insert_kernel=kernel,
                blob_a=para.a, alpha=para.alpha)
            return self._sum_over_data(out)

        width = 12 if dims == 2 else 24
        self.insert_fused = (k_cls > 1 and k_cls * mc ** dims * width * 4
                             <= FUSED_CLASS_BYTES)
        if self.insert_fused:
            f_all, t_all, offs_all = insert(k_cls, state, w_img)
        prev_fsc = getattr(self, "fsc", None)
        warm_w = getattr(self, "_w_warm", None) or {}
        fftc = self._ffts()[0]
        self._w_warm, offs, fscs, new_refs, self.half_maps = {}, [], [], [], []
        joined = []
        pair = self.mesh.pair_group()
        if pair is None:  # every rank holds both halves
            both = lambda x: x
            pair_sum = lambda *xs: xs
        else:
            both = lambda x: distributed.all_gather_cat(x, pair)
            pair_sum = lambda *xs: self._checked_sum(xs, pair)
        for k in range(k_cls):
            if self.insert_fused:
                f_ht, t_ht, offs_k = f_all[:, k], t_all[:, k], offs_all[:, k]
            else:
                w_k = w_img * (state["c"] == k) if k_cls > 1 else w_img
                f_ht, t_ht, offs_k = insert(
                    1, {**state, "c": torch.zeros_like(state["c"])}, w_k)
                offs_k = offs_k[:, 0]
            if exact_ops or len(gen_rots):
                f_ht, t_ht = engine.symmetrize_halves(
                    f_ht, t_ht, exact_ops, gen_rots, pf=para.pf,
                    r_u=(mc // 2 - 2) / para.pf)
            offs.append(both(offs_k).cpu().numpy())          # (2, 4)
            _mark("insert")
            fsc_k = (torch.ones(self.n // 2, device=self.device)
                     if prev_fsc is None else self._t(prev_fsc[k]))
            wc = warm_w.get(k)
            warm = wc is not None and wc.shape == t_ht.shape
            vols, self._w_warm[k] = engine.reconstruct_halves(
                f_ht, t_ht, fsc_k, wc if warm else torch.zeros_like(t_ht),
                float(r_u), pf=para.pf, n=self.n, warm=warm, blob_a=para.a,
                blob_alpha=para.alpha, dims=dims, insert_kernel=kernel)
            vols2 = vols if pair is None else self._gather_pair(vols, pair)
            ft_a, ft_b = fftc(vols2[0]), fftc(vols2[1])
            fsc_new = self._golden_fsc(ft_a, ft_b)
            fscs.append(fsc_new.cpu().numpy())
            self.half_maps.append([vols2[0], vols2[1]])
            if final:
                joined.append(reconstructor.reconstruct_cropped(
                    *pair_sum(f_ht.sum(0), t_ht.sum(0)),
                    fsc_new, self.n, pf=para.pf,
                    max_radius=r_u, join_half=True, blob_a=para.a,
                    blob_alpha=para.alpha, dims=dims, insert_kernel=kernel))
            _mark("wiener_fsc")
            if avg:
                band = spectrum.res_p(fsc_new, 0.95, r_low=1)
                new_refs.append(self._avg_hemi(ft_a, ft_b, band))
            else:
                new_refs.append(vols2)
            _mark("avg")
        if final:
            self.joined_maps = joined
        self.reco_timing = reco_t
        self._update_insert_offsets(np.stack(offs, axis=1))  # (2, K, 4)
        self.fsc = self._from_rank0(
            "fsc", torch.as_tensor(np.stack(fscs))).numpy()  # (K, shells)
        self.refs = self._from_rank0("refs", torch.stack(new_refs, dim=1))

    def _sum_over_data(self, tables):
        """The insert's folded (F, T, offsets) of this rank's halves summed
        over the hemisphere's data ranks (``mesh.data_group``: the world
        on one half; ``_checked_sum``)."""
        return self._checked_sum(tables, self.mesh.data_group())

    def _checked_sum(self, tables, group):
        """Tables (F, T, ...) summed over ``group``. The summed T's total
        is held to the sum of the group's own totals, gathered as numbers
        apart from the tables: a rank whose tables dropped out of the sum
        reads as a gap of its share, and raises. Each entry of T is
        rounded at most once per rank it adds, so the gap of a right sum
        stays under (group size) x 2^-22 of the total of |T|."""
        size = len(group.ranks)
        if size == 1:
            return tables
        own = float(tables[1].double().sum())
        tables = tuple(distributed.all_reduce_sum(x, group) for x in tables)
        want = sum(distributed.all_gather_object(own, group))
        got = float(tables[1].double().sum())
        gap = abs(got - want) / max(float(tables[1].abs().double().sum()),
                                    1e-30)
        if gap > size * 2.0 ** -22:
            raise RuntimeError(
                f"the summed insert table's weight total {got!r} is not the "
                f"sum of the {size} ranks' own totals {want!r}")
        self._rank_gaps["T"] = max(self._rank_gaps.get("T", 0.0), gap)
        return tables

    def _gather_pair(self, vols, pair):
        """Both half maps (2, ...) from this rank's own (1, ...) and the
        other half's rank at this data index (``pair``). Each rank's
        checksum of its map (``_digest``), taken before the gather, is gathered apart
        from the maps, and each gathered half must carry its owner's
        digest: a gather that hands back the wrong rank's half raises.
        The maps checked are counted for the round's record."""
        own = _digest(vols[0])
        want = distributed.all_gather_object(own, pair)
        vols2 = distributed.all_gather_cat(vols, pair)
        got = [_digest(v) for v in vols2]
        if got != want:
            raise RuntimeError(f"the half maps gathered over ranks "
                               f"{pair.ranks} carry the digests {got}, not "
                               f"their owners' {want}")
        self._rank_gaps["pair"] = self._rank_gaps.get("pair", 0) + len(got)
        return vols2

    def _from_rank0(self, name, x):
        """Rank 0's ``x`` on every rank, so that what steers the run agrees
        bit for bit; this rank's largest gap to it, over rank 0's largest
        magnitude, is kept for the round's line in the log. The maps reach
        it from the pair gather, so each half is held to the map of the
        rank that holds the same hemisphere's data at data index 0."""
        if distributed.world_size() == 1:
            return x
        x0 = distributed.broadcast(x)
        gap = float((x - x0).abs().max()) / max(float(x0.abs().max()), 1e-30)
        self._rank_gaps[name] = max(self._rank_gaps.get(name, 0.0), gap)
        return x0

    def _update_insert_offsets(self, offs):
        """prepareO (src/Reconstructor.cpp:1106-1128): symmetrise the
        re-centring accumulator and divide by its counter. offs (2, K, 4)."""
        o = offs[..., :3].astype(np.float64)
        cnt = offs[..., 3:4].astype(np.float64)
        if self.dims == 3 and self.sym.n_elements:
            acc = o.copy()
            for g in range(self.sym.n_elements):
                acc = acc + o @ np.asarray(self.sym.rot[g], np.float64).T
            o = acc
            cnt = cnt * (1 + self.sym.n_elements)
        self.insert_offsets = (o / np.maximum(cnt, 1.0)).astype(np.float32)

    # ------------------------------------------------------------------ run

    def run_iteration(self):
        """One refinement round, global or local, in the reference's order
        (Optimiser::run src/Optimiser.cpp:3561-4075). Per-stage wall clock
        (seconds, synchronised with the device) lands in
        ``history[-1]['timing']``."""
        para = self.para
        search_type_in = self.ladder.search_type
        is_global = search_type_in == SEARCH_TYPE_GLOBAL
        timing = {}
        t_last = time.perf_counter()

        def mark(name):
            nonlocal t_last
            self._sync()
            now = time.perf_counter()
            timing[name] = timing.get(name, 0.0) + (now - t_last)
            t_last = now

        if not para.skip_e:
            if is_global:
                self.global_scan()
                mark("expectation_scan")
            tv0, tv1 = self.local_search()
            mark("expectation_search")
            self._check_nan("expectation", self.par)
        else:
            tv0, tv1 = self.ladder.t_vari_s0, self.ladder.t_vari_s1
        rc_mean, rc_std = self._refresh_rotation_change()
        crit = para.increase_r_criterion
        if crit == "r_change":
            self.ladder.record_r_change(rc_mean)
        elif crit != "fsc_area":
            self.ladder.record_t_vari(tv0, tv1)
        if not para.skip_m:
            stats = self._residual_stats()
            if self.iteration != 0 and not is_global:
                # stacks rescale per image; sigma is re-derived from the
                # same pass's per-image ori shells
                self.norm_fac = self.norm_correction(stats=stats)
                sig_sums = engine.sigma_rescaled(
                    stats[6], self.norm_fac,
                    self._t(self._local(self.groups_plane)),
                    self._t(self._local(self.plane_valid)),
                    n_groups=self.n_groups)
                self.maximization_sigma(stats=stats, sig_override=tuple(
                    map(distributed.all_reduce_sum, sig_sums)))
            else:
                self.maximization_sigma(stats=stats)
            if is_global and para.group_scl and self.iteration != 0:
                self.correct_scale(init=False, group=True)
            mark("maximization_stats")
        if not para.skip_r:
            self.reconstruct()
            mark("reconstruction")
            for kk, vv in self.reco_timing.items():
                timing[f"reco_{kk}"] = round(vv, 3)
            self._check_nan("reconstruction", {"refs": self.refs,
                                               "fsc": self.fsc})
            if is_global:
                self.balance_class()
        if not is_global and self.dims == 3:
            self.re_centre_img()
            self.re_mask_img()
        if not para.skip_r:
            if para.ref_auto_recentre:
                self._auto_recentre_refs()
            if is_global and not para.global_mask:
                self.solvent_flatten(False)
            else:
                self.solvent_flatten(para.perform_mask)
        has_fsc = hasattr(self, "fsc")
        # the ladder follows the best class's FSC crossing
        res = (max(spectrum.res_p(torch.as_tensor(f), para.thres_cutoff_fsc,
                                  r_low=1) for f in self.fsc)
               if has_fsc else self.ladder.res)
        if has_fsc:
            self.refresh_snr()
        if crit == "fsc_area" and has_fsc:
            self.ladder.record_fsc_area(float(self.fsc[:, :max(res, 1)].sum()))
        self.ladder.elevate(res)
        self.ladder.transition(para.l_search, para.c_search)
        self.ladder = distributed.broadcast_object(self.ladder)
        st = self.ladder.search_type
        if st == SEARCH_TYPE_CTF and search_type_in != SEARCH_TYPE_CTF:
            self._seed_defocus_search()
        self.iteration += 1
        rank_gaps = self._check_ranks_agree()
        mark("post")
        nph = getattr(self, "phase_counts", None)
        if nph is not None:
            w = self._t(self._local(self.plane_valid))
            nph_sum = distributed.all_reduce_sum(torch.sum(nph * w))
            nph_max = distributed.all_reduce_max(torch.amax(torch.where(
                w > 0, nph, torch.zeros_like(nph))))
            nph_stats = (float(nph_sum) / max(float(self.plane_valid.sum()),
                                               1.0), int(nph_max))
        rec = {
            "iter": self.iteration, "r": self.ladder.r, "res_shell": res,
            "res_a": float(self.n * para.pixel_size / max(res, 1)),
            "search_type": st, "t_vari": (tv0, tv1),
            "r_change": (rc_mean, rc_std),
            "class_distr": getattr(self, "c_distr", None),
            "scale": self.scale.tolist() if self.n_groups > 1 else None,
            "timing": timing,
            "n_phase": None if nph is None else nph_stats,
            "rank_gaps": rank_gaps,
        }
        self.history.append(rec)
        self.log.info("Round %d done: r=%d res=%.2f A type=%d timing=%s",
                      rec["iter"], rec["r"], rec["res_a"], st,
                      {k: round(v, 3) for k, v in timing.items()})
        check_memory_usage(f"round {rec['iter']}", self.device)
        return rec

    def _seed_defocus_search(self):
        """Entering CTF search: spread each image's defocus support around
        its current factor with stddev ``ctf_refine_s`` (Particle::initD),
        drawn with NumPy from ``seed + 77`` as the JAX package draws it (the
        global (2, S, nD) batch on every rank, cut to its rows)."""
        s = self.para.ctf_refine_s
        rng = np.random.default_rng(self.para.seed + 77)
        d = self.par["d"]
        d0 = self.par["topD"].cpu().numpy()[..., None]
        eps = self._local(rng.normal(0, s, (2, self.s_slots, d.shape[2])))
        self.par["d"] = self._t((d0 + eps).astype(np.float32))
        self.par["sD"] = torch.full_like(self.par["sD"], s)

    def _check_ranks_agree(self):
        """After a round: the state each rank derives on its own from the
        all-reduced sums (sigma, scales, insert offsets) must be rank 0's.
        A digest of it is gathered and a mismatch raises (a rank that went
        its own way would otherwise hang the others at their next
        collective). The line in the log also gives each rank's largest
        gap to rank 0 in the references and FSC before rank 0's broadcast
        (``_from_rank0``) and in the summed insert table's total
        (``_checked_sum``), and the number of half maps it gathered from
        its pair and held to their owners' digests (``_gather_pair``);
        they are returned for the round's record (None for one rank)."""
        world = distributed.world_size()
        if world == 1:
            return None
        h = hashlib.sha256(repr(self.iteration).encode())
        for x in (self.sig, self.scale, getattr(self, "insert_offsets", None)):
            if x is not None:
                h.update(np.ascontiguousarray(
                    x.detach().cpu().numpy() if torch.is_tensor(x)
                    else x).tobytes())
        got = distributed.all_gather_object((h.hexdigest(), self._rank_gaps))
        self._rank_gaps = {}
        digests = [d for d, _ in got]
        if len(set(digests)) != 1:
            raise RuntimeError(f"round {self.iteration}: the ranks' states "
                               f"differ (digests {digests})")
        gaps = {k: [g.get(k, 0.0) for _, g in got]
                for k in ("refs", "fsc", "T")}
        gaps["pair"] = [g.get("pair", 0) for _, g in got]
        self.log.info("round %d: the %d ranks agree (state digest %s); "
                      "largest relative gap of each rank (and the half "
                      "maps it checked against their owners'): %s",
                      self.iteration, world, digests[0][:16],
                      json.dumps(gaps))
        return gaps

    def run(self, max_iter=None, finalise=True):
        """Rounds until ``max_iter`` (default ``para.iter_max``) or STOP,
        after the init-time scale re-balance against a given model
        (correctScale(true, ...), src/Optimiser.cpp:531-560), each round's
        files written when a ``save_*_each_iter`` flag is set; then, with
        ``finalise``, the final round (``finalise``). Returns the
        history."""
        para = self.para
        max_iter = max_iter or para.iter_max
        if (self.iteration == 0 and getattr(self, "_init_model_given", False)
                and not para.skip_m and getattr(self, "sig", None)
                is not None):
            self.correct_scale(init=True, group=False)
        for _ in range(max_iter):
            rec = self.run_iteration()
            if para.save_ref_each_iter or para.save_thu_each_iter:
                self.save_outputs()
            if rec["search_type"] == SEARCH_TYPE_STOP:
                break
        if finalise:
            self.finalise()
        return self.history

    def finalise(self):
        """The post-loop pipeline (src/Optimiser.cpp:4075-4363): the masked
        working stack and the brick tables are dropped, the reconstruction
        runs at the Nyquist band (r_u = max_r) without hemisphere
        averaging and with each class's joined map, then solvent flattening
        (or, with ``para.subtract`` in 3D, the subtraction pipeline) and
        the final file set."""
        para = self.para
        if para.skip_r or not hasattr(self, "par"):
            return
        self.imgs_ft = None
        self._brick_cache = None
        t0 = time.perf_counter()
        self.reconstruct(r_u=self.max_r, avg=False, final=True)
        self._sync()
        self.final_timing = {"reconstruction": time.perf_counter() - t0,
                             **{f"reco_{k}": v
                                for k, v in self.reco_timing.items()}}
        if para.subtract and self.dims == 3:
            t0 = time.perf_counter()
            self._subtract_pipeline()
            self._sync()
            self.final_timing["subtract"] = time.perf_counter() - t0
        else:
            self.solvent_flatten(para.perform_mask)
        self.save_outputs(final=True)

    def avg_hemi(self):
        """Model::avgHemi (src/Model.cpp:1732): both halves' references
        become their mean."""
        mean = (self.refs[0] + self.refs[1]) / 2
        self.refs = torch.stack([mean, mean])

    def _subtract_pipeline(self):
        """Signal subtraction (src/Optimiser.cpp:4190-4363): the masked
        stack rebuilt, the region centre read from ``region_centre``'s map
        (its density centroid; the box centre without one), then two
        passes of hemisphere averaging and solvent flattening, pass 0 with
        the spherical mask followed by norm correction and the Nyquist
        reconstruction again, pass 1 with the provided mask; then
        ``save_subtract``."""
        para = self.para
        self._rebuild_masked_stack()
        self.region_centre = (_centroid(read_mrc(para.region_centre))
                              if para.region_centre else np.zeros(3))
        for pass_ in (0, 1):
            self.avg_hemi()
            self.solvent_flatten(pass_ == 1)
            if pass_ == 0:
                self.norm_correction()
                self.reconstruct(r_u=self.max_r, avg=False, final=True)
        self.save_subtract()

    SUBTRACT_BATCH = 64  # images projected at a time by save_subtract

    def _rank_images(self, index):
        """Rank ``index``'s images in ascending global index, and their
        (local half, slot) positions within that rank's block."""
        planes, rows = self.mesh.block(self.s_slots, index)
        pi = self.plane_index[planes, rows]
        h, sl = np.nonzero(self.plane_valid[planes, rows] > 0)
        order = np.argsort(pi[h, sl], kind="stable")
        return pi[h, sl][order], (h[order], sl[order])

    def save_subtract(self):
        """Write Subtract_Rank_{rank:06d}.mrcs and Meta_Subtract.thu
        (saveSubtract, src/Optimiser.cpp:8418-8530): for the identity and
        then every symmetry element g, image by image, imgOri - CTF *
        proj(class reference at g^T R), translated by -(tran - offset) -
        (g^T R)^T c, c the region centre, so that the region lands at the
        box centre. Each rank writes its own block's images (on the
        (2, W/2) layout, of its own hemisphere), in ascending global
        index j = 0 .. n_rank - 1, g-major: slice gi n_rank + j + 1 (one
        rank: slice gi N + l + 1 holds image l). Rank 0 writes
        Meta_Subtract.thu: one row per (image, g), image-major, pointing
        into its rank's file, with the g-rotated pose and the translations
        moved into the subtracted frame (saveDatabase(subtract=true),
        :8296-8361)."""
        para, n, dev = self.para, self.n, self.device
        out = para.output_directory or "./"
        os.makedirs(out, exist_ok=True)
        prefix = os.path.join(out, para.dst_prefix + para.output_file_prefix)
        vol_fts = [projector.build_projectee_3d(self.refs[0, k], pf=para.pf)
                   for k in range(para.k)]
        sym_rots = ([np.eye(3, dtype=np.float32)]
                    + [np.asarray(r, np.float32) for r in self.sym.rot])
        f = torch.arange(n, dtype=torch.float32, device=dev) - n // 2
        colf = f[None, :].expand(n, n).reshape(-1)
        rowf = f[:, None].expand(n, n).reshape(-1)
        cp = self.ctf_params
        c2d = ctf_ops.ctf_pixels(
            colf, rowf, n, para.pixel_size, cp["voltage"], cp["defocus_u"],
            cp["defocus_v"], cp["defocus_theta"], cp["cs"],
            cp["amp_contrast"], cp["phase_shift"],
            defocus_factor=self.par["topD"]).reshape(
                self.par["topD"].shape + (n, n))
        t_rel = self.par["topT"] - self.offsets               # (lh, S, 2)
        cls = self.par["c"]
        rot_b = quat.rotate3d(self.par["topR"])            # (lh, S, 3, 3)
        rc = self._t(self.region_centre.astype(np.float32))
        h_loc, s_loc = (torch.as_tensor(x, device=dev)
                        for x in self._rank_images(self.mesh.rank)[1])
        stacks, q_rows = [], []
        for r_g in sym_rots:
            rot_c = torch.einsum("ij,hsjk->hsik", self._t(r_g.T), rot_b)
            q_rows.append(self._from_plane(quat.quat_from_matrix(rot_c)))
            pri = torch.zeros_like(self.imgs_ft_ori)
            for k in range(para.k):
                idx = torch.nonzero(cls == k)
                for s0 in range(0, idx.shape[0], self.SUBTRACT_BATCH):
                    h, sl = idx[s0:s0 + self.SUBTRACT_BATCH].unbind(1)
                    pri[h, sl] = projector.project_pixels_3d(
                        vol_fts[k], rot_c[h, sl], colf, rowf,
                        pf=para.pf).reshape(-1, n, n)
            diff = self.imgs_ft_ori - c2d * translate_ft(
                pri, t_rel[..., 0], t_rel[..., 1])
            reg = torch.einsum("hsji,j->hsi", rot_c, rc)
            diff = translate_ft(diff, -t_rel[..., 0] - reg[..., 0],
                                -t_rel[..., 1] - reg[..., 1])
            stacks.append(fft_ops.ifft2_center(diff).real.float()[
                h_loc, s_loc].cpu().numpy())
            del pri, diff
        write_mrc(f"{prefix}Subtract_Rank_{self.mesh.rank:06d}.mrcs",
                  np.concatenate(stacks, axis=0), voxel_size=para.pixel_size)

        # the particle translations move into the subtracted frame
        self.par = {**self.par, "t": self.par["t"] - t_rel[:, :, None, :],
                    "topT": self.par["topT"] - t_rel}
        flat = {k: self._from_plane(v) for k, v in self.par.items()}
        n_imgs, g_all = self.n_imgs, len(sym_rots)
        rep = lambda a: np.repeat(np.asarray(a), g_all, axis=0)
        q_all = np.stack(q_rows, axis=1).reshape(n_imgs * g_all, 4)
        cpf = {k: rep(self._from_plane(v)) for k, v in cp.items()}
        scores = rep(self._from_plane(self.scores))
        if not distributed.is_main():
            return
        # image -> (its rank, its place j in that rank's file)
        owner = np.zeros((n_imgs, 2), np.int64)
        count = []
        for r in range(self.mesh.world):
            ids = self._rank_images(r)[0]
            owner[ids] = np.stack([np.full(ids.size, r),
                                   np.arange(ids.size)], axis=1)
            count.append(ids.size)
        micros = getattr(self, "micrograph_paths", ["none"] * n_imgs)
        table = make_table(
            n_imgs * g_all,
            particle_paths=[
                f"{gi * count[r] + j + 1}@Subtract_Rank_{r:06d}.mrcs"
                for r, j in owner for gi in range(g_all)],
            micrograph_paths=[m for m in micros for _ in range(g_all)],
            voltage=cpf["voltage"], defocus_u=cpf["defocus_u"],
            defocus_v=cpf["defocus_v"], defocus_theta=cpf["defocus_theta"],
            cs=cpf["cs"], amplitude_contrast=cpf["amp_contrast"],
            phase_shift=cpf["phase_shift"],
            group_id=rep(self.group_ids + 1), class_id=rep(flat["c"]),
            quat_0=q_all[:, 0], quat_1=q_all[:, 1], quat_2=q_all[:, 2],
            quat_3=q_all[:, 3], k1=rep(flat["k1"]), k2=rep(flat["k2"]),
            k3=rep(flat["k3"]), translation_x=rep(flat["topT"][:, 0]),
            translation_y=rep(flat["topT"][:, 1]),
            std_translation_x=rep(flat["s0"]),
            std_translation_y=rep(flat["s1"]),
            defocus_factor=rep(flat["topD"]),
            std_defocus_factor=rep(flat["sD"]), score=scores)
        write_thu(f"{prefix}Meta_Subtract.thu", table)

    # -------------------------------------------------------------- output

    def _thu_quats(self):
        """Image-order pose quaternions for .thu output; 2D (cos, sin)
        support vectors become rotations about z (the reference's 2D
        quaternion convention)."""
        q = self.best_quat
        if self.dims == 2:
            phi = np.arctan2(q[:, 1], q[:, 0])
            z = np.zeros_like(phi)
            q = np.stack([np.cos(phi / 2), z, z, np.sin(phi / 2)], axis=-1)
        return q

    def _build_thu_table(self):
        """The 27-column .thu table of every image's state."""
        flat = {k: self._from_plane(v) for k, v in self.par.items()}
        q = self._thu_quats()
        cp = {k: self._from_plane(v) for k, v in self.ctf_params.items()}
        xy = getattr(self, "coords_xy", np.zeros((self.n_imgs, 2)))
        return make_table(
            self.n_imgs,
            particle_paths=getattr(
                self, "particle_paths",
                [f"{i + 1}@unknown.mrcs" for i in range(self.n_imgs)]),
            micrograph_paths=getattr(
                self, "micrograph_paths", ["none"] * self.n_imgs),
            coordinate_x=xy[:, 0], coordinate_y=xy[:, 1],
            voltage=cp["voltage"], defocus_u=cp["defocus_u"],
            defocus_v=cp["defocus_v"], defocus_theta=cp["defocus_theta"],
            cs=cp["cs"], amplitude_contrast=cp["amp_contrast"],
            phase_shift=cp["phase_shift"],
            group_id=self.group_ids + 1, class_id=flat["c"],
            quat_0=q[:, 0], quat_1=q[:, 1], quat_2=q[:, 2], quat_3=q[:, 3],
            k1=flat["k1"], k2=flat["k2"], k3=flat["k3"],
            translation_x=flat["topT"][:, 0],
            translation_y=flat["topT"][:, 1],
            std_translation_x=flat["s0"], std_translation_y=flat["s1"],
            defocus_factor=flat["topD"], std_defocus_factor=flat["sD"],
            score=self._from_plane(self.scores))

    def save_outputs(self, final=False):
        """Per-round and final files with the reference's exact naming
        (src/Optimiser.cpp:8250-9149), into ``para.output_directory``:
        Reference_{k}_{A,B}_{tag}.mrc (2D: the class-average stack
        Reference_{tag}.mrcs) and, when final, each class's joined map
        Reference_{k}_Final.mrc; FSC_, Class_Info_ and, per round, Sig_,
        Tau_ and Timing_{tag}.txt; Meta_{tag}.thu. ``tag`` is Final or
        Round_{iteration:03d}. Rank 0 writes; every rank joins the
        collectives the files need."""
        para = self.para
        out = para.output_directory or "./"
        prefix = os.path.join(out, para.dst_prefix + para.output_file_prefix)
        tag = "Final" if final else f"Round_{self.iteration:03d}"
        has_fsc = hasattr(self, "fsc")
        distr = self.refresh_class_distr() if has_fsc else None
        table = (self._build_thu_table()
                 if para.save_thu_each_iter or final else None)
        if not distributed.is_main():
            return
        os.makedirs(out, exist_ok=True)
        host = lambda x: x.detach().cpu().numpy()
        if para.save_ref_each_iter or final:
            if self.dims == 2:
                write_mrc(f"{prefix}Reference_{tag}.mrcs",
                          host((self.refs[0] + self.refs[1]) / 2),
                          voxel_size=para.pixel_size)
            else:
                joined = getattr(self, "joined_maps", None)
                for k in range(para.k):
                    if final:
                        fin = (joined[k] if joined is not None
                               else (self.refs[0, k] + self.refs[1, k]) / 2)
                        write_mrc(f"{prefix}Reference_{k:03d}_Final.mrc",
                                  host(fin), voxel_size=para.pixel_size)
                    for h, hn in ((0, "A"), (1, "B")):
                        write_mrc(f"{prefix}Reference_{k:03d}_{hn}_{tag}.mrc",
                                  host(self.refs[h, k]),
                                  voxel_size=para.pixel_size)
        inv_res = lambda i, size: i / (size * para.pixel_size)
        if has_fsc:
            # saveFSC (src/Optimiser.cpp:9018-9056): shell, 1/A, one FSC
            # column per class
            with open(f"{prefix}FSC_{tag}.txt", "w") as f:
                for i in range(1, min(self.ladder.r_u, self.fsc.shape[1])):
                    cols = "".join(f"   {self.fsc[k][i]:10.6f}"
                                   for k in range(para.k))
                    f.write(f"{i:05d}   {inv_res(i, self.n):10.6f}{cols}\n")
            # saveClassInfo (:9058-9090): class, 1/A at the report
            # threshold, class fraction
            with open(f"{prefix}Class_Info_{tag}.txt", "w") as f:
                for k in range(para.k):
                    res = spectrum.res_p(torch.as_tensor(self.fsc[k]),
                                         para.thres_report_fsc, r_low=1)
                    f.write(f"{k:05d}   {inv_res(res, self.n):10.6f}"
                            f"   {distr[k]:10.6f}\n")
        if getattr(self, "sig", None) is not None and not final:
            # saveSig (:9091-9120): the lead image's group, per hemisphere
            sig = host(self.sig)
            g0 = [int(self.groups_plane[h, 0]) for h in (0, 1)]
            for h, hn in ((0, "A"), (1, "B")):
                with open(f"{prefix}Sig_{hn}_{tag}.txt", "w") as f:
                    for i in range(self.max_r):
                        f.write(f"{i:05d}   {inv_res(i, self.n):10.6f}"
                                f"   {sig[g0[h], i]:10.6f}\n")
        if getattr(self, "tau", None) is not None and not final:
            # saveTau (:9149-9180): shells in padded units
            for hn in ("A", "B"):
                with open(f"{prefix}Tau_{hn}_{tag}.txt", "w") as f:
                    for i in range(1, self.max_r * para.pf - 1):
                        f.write(f"{i:05d}   "
                                f"{inv_res(i, self.n * para.pf):10.6f}"
                                f"   {self.tau[0][i]:10.6f}\n")
        if self.history and self.history[-1].get("timing") and not final:
            rec = self.history[-1]
            with open(f"{prefix}Timing_{tag}.txt", "w") as f:
                for name, sec in rec["timing"].items():
                    f.write(f"{name:24s} {sec:10.3f} s\n")
                if rec.get("n_phase"):
                    f.write(f"{'n_phase_mean':24s} {rec['n_phase'][0]:10.2f}"
                            "\n")
                    f.write(f"{'n_phase_max':24s} {rec['n_phase'][1]:10d}\n")
        if table is not None:
            write_thu(f"{prefix}Meta_{tag}.thu", table)

    def _refresh_rotation_change(self):
        """refreshRotationChange (src/Optimiser.cpp:5386-5482):
        rc = 1 - |<topR_prev, topR>|, robust mean/std over particles."""
        top_r = self.best_quat
        prev = getattr(self, "_top_r_prev", None)
        if prev is None or prev.shape != top_r.shape:
            rc = np.ones(top_r.shape[0])
        else:
            rc = 1.0 - np.abs(np.sum(prev * top_r, axis=1))
        self._top_r_prev = top_r
        self.r_change_stats = stat_mas(rc)
        return self.r_change_stats

    def refresh_snr(self):
        """Model::refreshSNR / refreshTau: per-class SNR = FSC / (1 - FSC);
        tau = reference shell power / 2 on the pf-padded frequency axis."""
        para = self.para
        fsc = np.asarray(self.fsc, np.float64)
        self.snr = fsc / np.maximum(1.0 - fsc, 1e-6)
        n_sh = (self.n // 2) * para.pf
        radius = (fft_ops.radius_grid_2d if self.dims == 2
                  else fft_ops.radius_grid_3d)
        idx = torch.clamp(torch.round(radius(self.n, self.device)
                                      * para.pf).long(), max=n_sh).reshape(-1)
        fftc = self._ffts()[0]
        taus = []
        for k in range(para.k):
            ft = fftc((self.refs[0, k] + self.refs[1, k]) / 2)
            p2 = (ft.real ** 2 + ft.imag ** 2).reshape(-1)
            s = torch.zeros(n_sh + 1, device=self.device).index_add_(
                0, idx, p2)
            c = torch.zeros(n_sh + 1, device=self.device).index_add_(
                0, idx, torch.ones_like(p2))
            taus.append((s / torch.clamp(c, min=1.0) / 2.0)[:n_sh].cpu()
                        .numpy())
        self.tau = np.stack(taus)
