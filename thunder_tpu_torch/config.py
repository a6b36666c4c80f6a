"""Run configuration: the ``Para`` dataclass of ``thunder_tpu.config``.

Field names, defaults and meanings are identical, so a configuration moves
between the packages as ``Para(**dataclasses.asdict(para))``. Where a field
names a TPU backend choice, the port reads it by device: ``fused_kernels``
and ``insert_impl`` = "auto" mean the hand-written CUDA kernel on a CUDA
device and the plain PyTorch version on the CPU; ``Optimiser`` refuses any
other value.

``load_para`` reads the reference-schema JSON parameter files
(``configs/demo*.json``) with the port's own copy of the key tables.
"""

import json
from dataclasses import dataclass


@dataclass
class Para:
    # Basic (include/Optimiser.h:80-190)
    n_threads: int = 1
    mode: str = "3d"  # "2d" | "3d"
    g_search: bool = True
    l_search: bool = True
    c_search: bool = False
    k: int = 1  # number of classes
    size: int = 160
    pixel_size: float = 1.32
    mask_radius: float = 80.0  # angstrom
    trans_s: float = 10.0  # estimated translation, pixels
    init_res: float = 60.0  # angstrom
    global_search_res: float = 15.0
    sym: str = "C1"
    init_model: str = ""
    db: str = ""  # .thu path
    par_prefix: str = ""
    # output filename prefix prepended to every written file (the
    # reference's dstPrefix, include/Optimiser.h:189-191: filenames are
    # sprintf'd as dstPrefix + name); may contain a directory part
    dst_prefix: str = ""
    output_directory: str = "./"
    output_file_prefix: str = ""
    core_fsc: bool = True
    mask_fsc: bool = False
    par_gra: bool = True  # particle grading
    ref_auto_recentre: bool = False

    # Reference Mask
    perform_mask: bool = False
    global_mask: bool = False
    mask: str = ""

    # Subtract
    subtract: bool = False
    region_centre: str = ""

    # Advanced (include/Optimiser.h:200-400)
    save_ref_each_iter: bool = True
    save_thu_each_iter: bool = True
    iter_max: int = 100
    golden_standard: bool = True
    pf: int = 2
    a: float = 1.9  # MKB kernel radius
    alpha: float = 15.0  # MKB smooth factor
    m_s: int = 10000  # global scanning points (mode-dependent key)
    m_l_r: int = 125  # local rotation points
    m_l_t: int = 9  # local translation points
    m_l_d: int = 9  # local defocus points
    m_reco: int = 100  # sampling points used in reconstruction
    ignore_res: float = 200.0
    scl_cor_res: float = 40.0
    thres_cutoff_fsc: float = 0.143
    thres_report_fsc: float = 0.143
    thres_scl_cor_fsc: float = 0.75
    group_sig: bool = True
    group_scl: bool = False
    zero_mask: bool = True
    ctf_refine_s: float = 0.01

    # Professional
    trans_search_factor: float = 0.25
    perturb_factor_l: float = 2.0
    perturb_factor_s_global: float = 0.5
    perturb_factor_s_local: float = 0.5
    perturb_factor_s_ctf: float = 0.5
    skip_e: bool = False
    skip_m: bool = False
    skip_r: bool = False

    # additions of the JAX package (no reference equivalent)
    n_halves: int = 2  # golden-standard hemisphere replicas
    seed: int = 0
    image_batch: int = 0  # images per scan/insert chunk; 0 = 64
    # MKB gridding-kernel insertion (the reference's compile-time
    # RECONSTRUCTOR_MKB_KERNEL, include/Config.h:95; its shipped default is
    # trilinear, Config.h:97). 3D only; the insert costs ~8x the trilinear
    # one (8 brick-row scatters over the blob support)
    mkb_kernel: bool = False
    # particle-filter phases per device dispatch in the JAX package; the
    # port drives one phase per host step and keeps the field for parity
    phase_block: int = 0
    # global-scan likelihood: "auto" = the fused kernel K1 (CUDA on a CUDA
    # device, its plain version on the CPU), the only value the port takes
    fused_kernels: str = "auto"
    # frequency-ladder stall criterion (the reference's compile-time
    # MODEL_DETERMINE_INCREASE_R_* flags, include/Config.h:139-143;
    # shipped default = t_vari): "t_vari" | "r_change" | "fsc_area"
    increase_r_criterion: str = "t_vari"
    # M-step gridding insert: "auto" = kernel K2 (ops.insert: CUDA on a
    # CUDA device, its plain version on the CPU), the only value the port
    # takes
    insert_impl: str = "auto"
    # bfloat16 projection brick tables: halves the bytes of the E-step's
    # dominant gather (interp dots still accumulate f32); reconstruction
    # accumulators are unaffected. CAVEAT: bf16 quantization
    # of the reference table can flip BORDERLINE pose draws / class
    # assignments (a resampling tie breaking the other way), so individual
    # particle draws are not bitwise-reproducible against f32-table runs;
    # posterior distributions agree statistically.
    # Classification jobs (k > 1) at fine margins may prefer f32 tables.
    table_bf16: bool = True
    # per-stage finite checks (the reference's CHECK_NAN macros,
    # include/Config.h — compiled out by default there too); costs a host
    # sync per stage, debug only
    debug_nan: bool = False

    @property
    def mask_radius_px(self):
        return self.mask_radius / self.pixel_size


# JSON key table — byte-identical to the reference's #define KEY_* strings
_JSON_KEYS = {
    "Basic": {
        "Number of Threads Per Process": ("n_threads", int),
        "2D or 3D Mode": ("mode", lambda s: s.lower()),
        "Global Search": ("g_search", bool),
        "Local Search": ("l_search", bool),
        "CTF Search": ("c_search", bool),
        "Number of Classes": ("k", int),
        "Size of Image": ("size", int),
        "Pixel Size (Angstrom)": ("pixel_size", float),
        "Radius of Mask on Images (Angstrom)": ("mask_radius", float),
        "Estimated Translation (Pixel)": ("trans_s", float),
        "Initial Resolution (Angstrom)": ("init_res", float),
        "Perform Global Search Under (Angstrom)": ("global_search_res", float),
        "Symmetry": ("sym", str),
        "Initial Model": ("init_model", str),
        ".thu File Storing Paths and CTFs of Images": ("db", str),
        "Path of Particles": ("par_prefix", str),
        "Prefix of Destination": ("dst_prefix", str),
        "Path of Output": ("output_directory", str),
        "Prefix of Output": ("output_file_prefix", str),
        "Calculate FSC Using Core Region": ("core_fsc", bool),
        "Calculate FSC Using Masked Region": ("mask_fsc", bool),
        "Particle Grading": ("par_gra", bool),
        "Auto-Recentre Reference": ("ref_auto_recentre", bool),
    },
    "Reference Mask": {
        "Perform Reference Mask": ("perform_mask", bool),
        "Perform Reference Mask During Global Search": ("global_mask", bool),
        "Provided Mask": ("mask", str),
    },
    "Subtract": {
        "Subtract Masked Region Reference From Images": ("subtract", bool),
        "Region Need to Be Centred": ("region_centre", str),
    },
    "Advanced": {
        "Save Reference(s) Each Iteration": ("save_ref_each_iter", bool),
        "Save .thu File Each Iteration": ("save_thu_each_iter", bool),
        "Max Number of Iteration": ("iter_max", int),
        "Using Golden Standard FSC": ("golden_standard", bool),
        "Padding Factor": ("pf", int),
        "MKB Kernel Radius": ("a", float),
        "MKB Kernel Smooth Factor": ("alpha", float),
        "Number of Sampling Points of Translation in Local Search":
            ("m_l_t", int),
        "Number of Sampling Points of Defocus in Local Search": ("m_l_d", int),
        "Number of Sampling Points Used in Reconstruction": ("m_reco", int),
        "Ignore Signal Under (Angstrom)": ("ignore_res", float),
        "Correct Intensity Scale Using Signal Under (Angstrom)":
            ("scl_cor_res", float),
        "FSC Threshold for Cutoff Frequency": ("thres_cutoff_fsc", float),
        "FSC Threshold for Reporting Resolution": ("thres_report_fsc", float),
        "FSC Threshold for Scale Correction": ("thres_scl_cor_fsc", float),
        "Grouping when Calculating Sigma": ("group_sig", bool),
        "Grouping when Correcting Intensity Scale": ("group_scl", bool),
        "Mask Images with Zero Noise": ("zero_mask", bool),
        "CTF Refine Standard Deviation": ("ctf_refine_s", float),
    },
    "Professional": {
        "Translation Search Factor": ("trans_search_factor", float),
        "Perturbation Factor (Large)": ("perturb_factor_l", float),
        "Perturbation Factor (Small, Global)":
            ("perturb_factor_s_global", float),
        "Perturbation Factor (Small, Local)":
            ("perturb_factor_s_local", float),
        "Perturbation Factor (Small, CTF)": ("perturb_factor_s_ctf", float),
        "Skip Expectation": ("skip_e", bool),
        "Skip Maximization": ("skip_m", bool),
        "Skip Reconstruction": ("skip_r", bool),
    },
}


# mode-dependent sampling keys handled outside the flat table
_MODE_KEYS = frozenset({
    "Number of Sampling Points for Scanning in Global Search (2D)",
    "Number of Sampling Points for Scanning in Global Search (3D)",
    "Number of Sampling Points of Rotation in Local Search (2D)",
    "Number of Sampling Points of Rotation in Local Search (3D)",
})


def check_keys(src, strict=False):
    """Reject (strict) or warn about unrecognised parameter keys — the
    reference aborts naming the exact missing/typo'd key
    (appsrc/thunder.cpp:41-77); silently running with defaults hides
    typos."""
    unknown = []
    for section, sec in src.items():
        known = _JSON_KEYS.get(section)
        if known is None:
            unknown.append(f"section '{section}'")
            continue
        for key in sec:
            if key not in known and key not in _MODE_KEYS:
                unknown.append(f"{section}: '{key}'")
    if unknown:
        msg = "unrecognised parameter key(s): " + "; ".join(unknown)
        if strict:
            raise KeyError(msg)
        import warnings

        warnings.warn(msg, stacklevel=3)
    return unknown


def load_para(path_or_dict, strict=False):
    """Parse a reference-schema JSON parameter file into a Para.

    Missing keys keep defaults (the reference aborts — we are permissive so
    minimal configs work); unrecognised keys warn, or raise with the exact
    key name under ``strict`` (appsrc/thunder.cpp:41-77); mode-dependent
    keys (sampling points 2D/3D) are resolved after the mode is known."""
    if isinstance(path_or_dict, dict):
        src = path_or_dict
    else:
        with open(path_or_dict) as f:
            src = json.load(f)

    check_keys(src, strict=strict)
    para = Para()
    for section, keys in _JSON_KEYS.items():
        sec = src.get(section, {})
        for key, (attr, conv) in keys.items():
            if key in sec:
                setattr(para, attr, conv(sec[key]))

    adv = src.get("Advanced", {})
    tag = "(2D)" if para.mode == "2d" else "(3D)"
    scan = f"Number of Sampling Points for Scanning in Global Search {tag}"
    local = f"Number of Sampling Points of Rotation in Local Search {tag}"
    if scan in adv:
        para.m_s = int(adv[scan])
    if local in adv:
        para.m_l_r = int(adv[local])
    return para
