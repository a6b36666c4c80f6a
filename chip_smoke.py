"""On-card smoke test of the PyTorch/CUDA port (thunder_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py            # everything, on one card
    python3 chip_smoke.py --kernels  # build + kernel checks only
    python3 chip_smoke.py --data-study  # + the round on bench.py's data

Phases, each printing a flushed progress line with elapsed seconds:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of csrc/*.cu with one nvcc call (cuda_build), and the count of
   tensor-core instructions (HGMMA / HMMA) in the global-scan kernel's
   SASS (cuobjdump), as proof of tensor-core use;
3. kernel K1 (fused global scan, wgmma) against its plain version at the
   slice's shape (B=64, R=256, T=30, P=256), a ragged one (37, 200, 7)
   and one with T over two translation chunks (16, 256, 70): merged
   outputs against ``scan_plain``, raw per-tile outputs against
   ``scan_tiles_plain``, the merge kernel against ``merge_tiles``; the
   wrapper as the round calls it timed in turns with a batched-matmul
   yardstick, and the kernels' own time on the card from a profiler
   trace, at the slice shape and at B = 1024;
4. kernel K2 (gridding insert, channel-minor table, vector atomics)
   against its plain version at the slice's sample count on random rows,
   plus the empty and all-dropped cases; kernel and ``index_add_`` timed in
   turns on the same table;
5. one global refinement round at full width (160 px, pf 2, C4, 256 x 30
   scan, 125 x 9 local support, 100 insert draws) on 128 synthetic
   particles (cut from the 256 of bench.py; C4-symmetric phantom, noise 0.3
   of the signal std instead of 1.0), through Optimiser.run_iteration,
   with the kernels' launch counts read around that run only; then K2
   held against its plain version and timed in turns with ``index_add_``
   on the round's own first insert call;
6. a JSON line of per-kernel numbers, the card line again, and the final
   status line {"ok": true, "device": {...}}.

``--data-study`` adds, after phase 5, the same round on bench.py's own data
(asymmetric phantom, noise 1.0) and on the two data sets that change one of
those two settings, and prints their pose error and resolution without
bounds: it shows what the smoke's easier data changes.

Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package: the synthetic data are
made with NumPy and the port's own projector, CTF and translation code.
"""

import json
import subprocess
import sys
import time

T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor
# FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# K1 bars, set from the H100 readings (PERF.md): normalised wR/wT within
# 1.4e-4 and raw marginals and per-tile outputs within 5.3e-3 relative
# (bf16 operands, Q T and |P|^2 included, vs the f32 plain version). wC is
# checked raw only: with K = 1 its normalised value is 1 by construction
K1_TOL = 1e-3        # max |kernel - plain| of normalised wR, wT
K1_RAW_TOL = 1e-2    # max |kernel - plain| / max |plain| of wC, wR, wT
K1_ARGMAX_MIN = 0.95  # top-pose agreement (bf16 can flip near-ties)
K1_MERGE_TOL = 1e-5  # merge kernel vs merge_tiles on the same tiles (f32)
K2_TOL = 1e-5       # max |kernel - plain| / max |plain|: atomics reorder f32
# bounds on the global round, set from the first full run on an H100
# (median top-pose error 0.92 deg, FSC-0.143 shell 15): see PERF.md
ROUND_ANG_MAX = 5.0   # median top-pose error (deg), C4 mates allowed
ROUND_RES_MIN = 12    # FSC-0.143 shell after the round
N_PARTICLES = 128
# noise std relative to the clean stack's: bench.py uses 1.0, at which one
# global round at band r = 8 does not pin the poses down; 0.3 makes the
# pose check below meaningful
NOISE = 0.3


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def cuda_ms(fn, reps=10, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def normalised(x):
    x = x.double()
    return x / x.sum(dim=tuple(range(1, x.ndim)), keepdim=True).clamp_min(
        1e-300)


# --------------------------------------------------------------------- K1

def k1_problem(gen, dev, b, r, t, p, scale=0.05):
    """Random scan inputs shaped like the JAX package's fused-kernel test:
    projections correlated with one image so the posteriors have a peak."""
    import torch

    from thunder_tpu_torch.ops import likelihood

    c64 = torch.complex64
    dat = torch.complex(torch.randn(b, p, generator=gen, device=dev),
                        torch.randn(b, p, generator=gen, device=dev))
    ctf = torch.rand(b, p, generator=gen, device=dev) * 2 - 1
    sig = 0.5 + 1.5 * torch.rand(b, p, generator=gen, device=dev)
    sig_rcp = likelihood.sigma_reciprocal(sig)
    proj = torch.complex(torch.randn(1, r, p, generator=gen, device=dev),
                         torch.randn(1, r, p, generator=gen, device=dev))
    proj = (proj * scale).to(c64)
    proj[0, 3] = dat[0] / ctf[0].clamp(min=0.05)
    phase = 2 * torch.pi * torch.rand(t, p, generator=gen, device=dev)
    tra = torch.complex(torch.cos(phase), torch.sin(phase))
    pm = (torch.rand(p, generator=gen, device=dev) > 0.1).float()
    q, e = likelihood._q_e(dat, ctf, sig_rcp, pm)
    pr = torch.full((b, r), 1.0 / r, device=dev)
    pt = torch.full((b, t), 1.0 / t, device=dev)
    return q.to(c64), e.float(), proj, tra.to(c64), pr, pt


def k1_bound_ms(b, k, r, t, p):
    """Least time for the scan FUNCTION, whatever implements it: its
    operations (4 B K R T P for term 1, 2 B K R P for term 2) over the
    bf16 tensor-core peak, or its bytes (q, e, proj, tra and the priors
    read once as passed, wR, wT, wC written once) over HBM."""
    flops = 4.0 * b * k * r * t * p + 2.0 * b * k * r * p
    nbytes = (b * p * 8 + b * p * 4 + k * r * p * 8 + t * p * 8
              + b * r * 4 + b * t * 4                          # inputs
              + b * k * r * 4 + b * k * t * 4 + b * k * 4)     # outputs
    by_ops, by_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def sass_counts(lib_path):
    """Tensor-core instructions (HGMMA / HMMA) in the global-scan kernel's
    SASS and the atomic opcodes of the insert kernel, from cuobjdump; None
    where cuobjdump is absent."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, atomics, fn = {}, set(), ""
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        ins = line.split("*/")[1].strip() if "*/" in line else ""
        op = ins.split()[0] if ins else ""
        if op.startswith("@"):
            op = ins.split()[1]
        if "global_scan" in fn and op.startswith(("HGMMA", "HMMA")):
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
        if "insert" in fn and op.startswith(("RED", "ATOM")):
            atomics.add(op)
    return {"global_scan": counts, "insert_atomics": sorted(atomics)}


def device_ms(fn, names, reps=20):
    """Mean time on the card per call of ``fn`` of the kernels whose names
    hold one of ``names``, from a torch.profiler trace of ``reps`` calls
    (CUPTI kernel intervals; host time excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(n in e.name for n in names)]
    if not kern:
        raise AssertionError(f"profiler saw no kernel named {names}")
    busy_us = sum(e.time_range.end - e.time_range.start for e in kern)
    return busy_us / 1e3 / reps


K1_KERNELS = ("global_scan_kernel", "merge_kernel")


def k1_tile_errs(q, e, proj, tra, pr, pt):
    """K1's raw per-tile outputs against ``scan_tiles_plain`` (f32), and
    its merge kernel against ``merge_tiles`` of those same tiles: max
    |kernel - plain| / max |plain| each."""
    from thunder_tpu_torch.ops import likelihood

    tiles, merged = likelihood.scan_tiles_kernel(q, e, proj, tra, pr, pt)
    ref = likelihood.scan_tiles_plain(likelihood.pack_scan(q, e, proj, tra,
                                                           pr, pt))
    rel = lambda a, b: float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30))
    merge_ref = likelihood.merge_tiles(tiles, proj.shape[0], proj.shape[1])
    return ({name: rel(tiles[name], ref[name])
             for name in ("base", "wr", "wc", "wt")},
            max(rel(merged[name], merge_ref[name])
                for name in ("wC", "wR", "wT", "baseline")))


def check_k1(dev):
    import torch

    from thunder_tpu_torch.ops import likelihood

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    launches0 = likelihood.LAUNCHES["scan_fused"]
    for (b, r, t, p) in ((64, 256, 30, 256), (37, 200, 7, 256),
                         (16, 256, 70, 256)):
        q, e, proj, tra, pr, pt = k1_problem(gen, dev, b, r, t, p)
        ref = likelihood.scan_plain(q, e, proj, tra, pr, pt)
        got = likelihood.scan_fused(q, e, proj, tra, pr, pt)
        tile_rels, merge_rel = k1_tile_errs(q, e, proj, tra, pr, pt)
        torch.cuda.synchronize()
        errs, rels = {}, {}
        for name in ("wC", "wR", "wT"):
            if not torch.isfinite(got[name]).all():
                raise AssertionError(f"K1 {name} not finite at {(b, r, t, p)}")
            rels[name] = float((ref[name] - got[name]).abs().max()
                               / ref[name].abs().max())
            if name != "wC":
                errs[name] = float((normalised(ref[name])
                                    - normalised(got[name])).abs().max())
        top_ref = ref["wR"].reshape(b, -1).argmax(1)
        top_got = got["wR"].reshape(b, -1).argmax(1)
        agree = float((top_ref == top_got).float().mean())
        log(f"K1 B={b} R={r} T={t} P={p}: max |norm err| "
            f"wR={errs['wR']:.3e} wT={errs['wT']:.3e}; raw rel wC="
            f"{rels['wC']:.3e} wR={rels['wR']:.3e} wT={rels['wT']:.3e}; "
            f"argmax agreement {agree:.3f}; raw tile outputs rel "
            + " ".join(f"{k}={v:.3e}" for k, v in tile_rels.items())
            + f"; merge kernel rel {merge_rel:.3e}")
        if (max(errs.values()) > K1_TOL or max(rels.values()) > K1_RAW_TOL
                or max(tile_rels.values()) > K1_RAW_TOL
                or merge_rel > K1_MERGE_TOL or agree < K1_ARGMAX_MIN):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{(b, r, t, p)}: normalised {errs}, raw "
                                 f"{rels}, tiles {tile_rels}, merge "
                                 f"{merge_rel}, argmax {agree}")
        if top_ref[0] != top_got[0]:
            raise AssertionError("K1 misses the planted top pose")
        rows.append(dict(shape=(b, r, t, p), errs=errs, agree=agree,
                         inputs=(q, e, proj, tra, pr, pt)))
    # timing at the slice shape: the wrapper as the round calls it (checks,
    # two allocations, one library call: scan + merge) and the batched-
    # matmul yardstick in turns, the plain version, and the kernels' own
    # time on the card from a profiler trace
    q, e, proj, tra, pr, pt = rows[0]["inputs"]
    b, r, t, p = rows[0]["shape"]
    wrapper = lambda: likelihood.scan_fused(q, e, proj, tra, pr, pt)
    lib = batched_matmul(q, tra, proj)
    ms_a = cuda_ms(wrapper, reps=50)
    lib_a = cuda_ms(lib, reps=50)
    plain_ms = cuda_ms(lambda: likelihood.scan_plain(q, e, proj, tra, pr,
                                                     pt))
    lib_b = cuda_ms(lib, reps=50)
    ms_b = cuda_ms(wrapper, reps=50)
    ms, lib_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
    dev_ms = device_ms(wrapper, K1_KERNELS)
    bound, by = k1_bound_ms(b, 1, r, t, p)
    log(f"K1 time at slice shape: wrapper {ms_a:.4f} / {ms_b:.4f} ms "
        f"(first / last in turn), batched matmul {lib_a:.4f} / {lib_b:.4f} "
        f"ms, plain {plain_ms:.4f} ms; on the card (profiler, scan + "
        f"merge) {dev_ms:.4f} ms; bound {bound:.6f} ms ({by}), share of "
        f"the wrapper {bound / ms:.4f}, of the card time {bound / dev_ms:.4f}")
    # throughput shape: B = 1024 images in one call
    bt = 1024
    q2, e2, proj2, tra2, pr2, pt2 = k1_problem(gen, dev, bt, r, t, p)
    wrapper2 = lambda: likelihood.scan_fused(q2, e2, proj2, tra2, pr2, pt2)
    ms_big = cuda_ms(wrapper2, reps=20)
    lib_big = cuda_ms(batched_matmul(q2, tra2, proj2), reps=20)
    dev_big = device_ms(wrapper2, K1_KERNELS)
    bound_big, by_big = k1_bound_ms(bt, 1, r, t, p)
    log(f"K1 time at B={bt} R={r} T={t} P={p}: wrapper {ms_big:.4f} ms, "
        f"on the card {dev_big:.4f} ms, batched matmul {lib_big:.4f} ms, "
        f"bound {bound_big:.6f} ms ({by_big}), share of bound "
        f"{bound_big / ms_big:.4f}, {4.0 * bt * r * t * p / ms_big / 1e9:.1f}"
        f" TFLOP/s of term 1")
    likelihood.LAUNCHES["scan_fused"] = launches0  # check/timing launches
    return dict(max_abs_err=max(max(x["errs"].values()) for x in rows),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, device_ms=dev_ms, ms_b1024=ms_big,
                device_ms_b1024=dev_big, library_ms_b1024=lib_big,
                bound_ms_b1024=bound_big)


def batched_matmul(q, tra, proj):
    """The yardstick: term 1 of every (image, translation, pose) as two
    batched torch.matmul calls (no term 2, no marginals)."""
    import torch

    p = q.shape[1]
    pk = proj.reshape(-1, p)
    pk_re, pk_im = pk.real.contiguous(), pk.imag.contiguous()

    def run():
        qt = q[None] * tra[:, None, :]                  # (T, B, P)
        return (torch.matmul(qt.real, pk_re.T)
                - torch.matmul(qt.imag, pk_im.T))

    return run


# --------------------------------------------------------------------- K2

def k2_bound(idx, r_pad):
    """What this call's data needs: every sample read once (28 B), and each
    table row that some sample hits read and written once (2 x 96 B);
    rows no sample hits need no traffic."""
    import torch

    keep = (idx >= 0) & (idx < r_pad)
    hit = int(torch.unique(idx[keep]).numel())
    n_samples = idx.shape[0]
    nbytes = n_samples * 28 + 2 * 96 * hit
    flops = n_samples * (16 + 48)
    by_b, by_o = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return ((by_b, "bytes") if by_b >= by_o else (by_o, "operations")), hit


def time_k2(tab, idx, fr, fi, tv, frac, reps=10):
    """Kernel and index_add_ in turns on the same channel-minor table:
    kernel, index_add_, index_add_, kernel; returns the means."""
    from thunder_tpu_torch.ops import insert

    contrib = insert.corner_contrib(fr, fi, tv, frac)
    keep = (idx >= 0) & (idx < tab.shape[1])
    idx_l = idx[keep].long()
    contrib = contrib[keep]
    kern = lambda: insert.insert_update(tab, idx, fr, fi, tv, frac)
    lib = lambda: tab.T.index_add_(0, idx_l, contrib)
    ka = cuda_ms(kern, reps=reps)
    la = cuda_ms(lib, reps=reps)
    lb = cuda_ms(lib, reps=reps)
    kb = cuda_ms(kern, reps=reps)
    return (ka + kb) / 2, (la + lb) / 2, (ka, la, lb, kb)


def check_k2(dev, n_samples, mc):
    import torch

    from thunder_tpu_torch.ops import insert

    gen = torch.Generator(device=dev).manual_seed(12)
    n_rows = mc ** 3 + 1
    r_pad = insert.rows_pad(n_rows)
    idx = torch.randint(0, n_rows, (n_samples,), generator=gen, device=dev,
                        dtype=torch.int32)
    fr, fi, tv = (torch.randn(n_samples, generator=gen, device=dev)
                  for _ in range(3))
    frac = torch.rand(n_samples, 3, generator=gen, device=dev)
    tab0 = insert.new_table(r_pad, device=dev)
    tab0.copy_(torch.randn(24, r_pad, generator=gen, device=dev))
    fresh = lambda: tab0.T.clone().T  # channel-minor copy
    ref = insert.insert_update_plain(fresh(), idx, fr, fi, tv, frac)
    out = insert.insert_update(fresh(), idx, fr, fi, tv, frac)
    torch.cuda.synchronize()
    abs_err = float((out - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    log(f"K2 N={n_samples} mc={mc}: max abs err {abs_err:.3e}, "
        f"rel {rel:.3e}")
    if not rel < K2_TOL:
        raise AssertionError(f"K2 disagrees with its plain version: {rel}")
    # empty insert and every sample on the drop row
    z = torch.zeros(0, device=dev)
    same = insert.insert_update(fresh(), idx[:0], z, z, z, frac[:0])
    if not torch.equal(same, tab0):
        raise AssertionError("K2 empty insert changed the table")
    drop = torch.full((1000,), mc ** 3, dtype=torch.int32, device=dev)
    ones = torch.ones(1000, device=dev)
    out_d = insert.insert_update(fresh(), drop, ones, 2 * ones,
                                 3 * ones, torch.zeros(1000, 3, device=dev))
    torch.cuda.synchronize()
    if not torch.equal(out_d[:, :mc ** 3], tab0[:, :mc ** 3]):
        raise AssertionError("K2 all-dropped insert touched voxel rows")
    log("K2 empty and all-dropped cases hold")
    del ref, out, same, out_d

    launches0 = insert.LAUNCHES["insert_update"]
    tab = fresh()
    ms, lib_ms, turns = time_k2(tab, idx, fr, fi, tv, frac)
    plain_ms = cuda_ms(lambda: insert.insert_update_plain(tab, idx, fr, fi,
                                                          tv, frac))
    insert.LAUNCHES["insert_update"] = launches0
    (bound, by), hit = k2_bound(idx, r_pad)
    log(f"K2 time at random rows: kernel {ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms (turns kernel/index_add_/index_add_/kernel "
        + "/".join(f"{x:.4f}" for x in turns) + f"), plain {plain_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({by}; {hit} of {r_pad} rows hit)")
    return dict(max_abs_err=abs_err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def k2_main_path(dev, call):
    """K2 on the round's own first insert call (captured arguments): on a
    fresh table, held at K2_TOL against the f64 sum of its plain version's
    f32 corner rows (the plain version itself is logged beside it), then
    timed in turns with index_add_ on a fresh channel-minor table."""
    import torch

    from thunder_tpu_torch.ops import insert

    tab, idx, fr, fi, tv, frac = call
    launches0 = insert.LAUNCHES["insert_update"]
    r_pad = tab.shape[1]
    got = insert.insert_update(insert.new_table(r_pad, device=dev),
                               idx, fr, fi, tv, frac)
    plain = insert.insert_update_plain(insert.new_table(r_pad, device=dev),
                                       idx, fr, fi, tv, frac)
    # the same f32 corner rows summed in f64: the centre row takes ~1e4
    # large terms, so two f32 atomic orders differ by twice the error of
    # either; the f64 sum isolates the kernel's own
    keep = (idx >= 0) & (idx < r_pad)
    exact = torch.zeros((r_pad, 24), dtype=torch.float64, device=dev)
    exact.index_add_(0, idx[keep].long(),
                     insert.corner_contrib(fr, fi, tv, frac)[keep].double())
    exact = exact.T
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    rel = float((got.double() - exact).abs().max()) / scale
    rel_plain = float((plain.double() - exact).abs().max()) / scale
    rel_pair = float((got - plain).abs().max()) / float(plain.abs().max())
    log(f"K2 on the round's first insert: max |err| / max |exact| "
        f"{rel:.3e} (kernel), {rel_plain:.3e} (plain version, index_add_ "
        f"in f32); kernel against plain {rel_pair:.3e}")
    if not rel < K2_TOL:
        raise AssertionError(f"K2 disagrees with the exact sum of its plain "
                             f"version's rows on the round's samples: {rel}")
    del got, plain, exact
    work = insert.new_table(r_pad, device=dev)
    ms, lib_ms, turns = time_k2(work, idx, fr, fi, tv, frac)
    insert.LAUNCHES["insert_update"] = launches0
    (bound, by), hit = k2_bound(idx, r_pad)
    log(f"K2 on the round's first insert ({idx.shape[0]} samples, "
        f"R_pad {r_pad}, {hit} rows hit): kernel {ms:.4f} ms, "
        f"index_add_ {lib_ms:.4f} ms (turns "
        + "/".join(f"{x:.4f}" for x in turns)
        + f"), bound {bound:.4f} ms ({by}), share {bound / ms:.4f}")
    return dict(main_path_ms=ms, main_path_library_ms=lib_ms,
                main_path_bound_ms=bound, main_path_samples=idx.shape[0],
                main_path_rows_hit=hit, main_path_rel_err=rel,
                main_path_rel_err_plain=rel_plain)


# ------------------------------------------------------------ the round

def synthetic_dataset(dev, n, b, seed=0, noise=1.0, symmetric=True):
    """bench.py's workload made with NumPy + the port: a 6-blob phantom
    (made C4-symmetric unless ``symmetric`` is False, as bench.py's is)
    projected at random poses, CTF-modulated, shifted, plus Gaussian noise
    of ``noise`` x the clean stack's std."""
    import numpy as np
    import torch

    from thunder_tpu_torch.core import projector
    from thunder_tpu_torch.geom import quat
    from thunder_tpu_torch.ops import ctf as ctf_ops
    from thunder_tpu_torch.ops import fft as fft_ops
    from thunder_tpu_torch.ops.translate import translate_ft

    rng = np.random.default_rng(seed)
    g = np.mgrid[:n, :n, :n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(-n / 5, n / 5, 3)
        s = rng.uniform(n / 30, n / 12)
        # each blob with its 3 images under C4 about z, so the phantom has
        # the symmetry the refinement imposes (bench.py's has none)
        mates = ((c[0], c[1]), (-c[1], c[0]), (-c[0], -c[1]), (c[1], -c[0]))
        for cx, cy in mates[:4 if symmetric else 1]:
            vol += np.exp(-((g[0] - c[2]) ** 2 + (g[1] - cy) ** 2
                            + (g[2] - cx) ** 2) / (2 * s * s))
    del g
    q = rng.normal(size=(b, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, 2.0, (b, 2)).astype(np.float32)
    cp = dict(voltage=np.full(b, 300e3), defocus_u=rng.uniform(1e4, 2e4, b),
              defocus_v=rng.uniform(1e4, 2e4, b), defocus_theta=np.zeros(b),
              cs=np.zeros(b), amp_contrast=np.full(b, 0.1),
              phase_shift=np.zeros(b))
    cp = {k: v.astype(np.float32) for k, v in cp.items()}
    vf = projector.build_projectee_3d(torch.as_tensor(vol, device=dev), pf=2)
    f = torch.arange(n, device=dev) - n // 2
    colf = f[None, :].expand(n, n).reshape(-1).float()
    rowf = f[:, None].expand(n, n).reshape(-1).float()
    chunks = []
    for s0 in range(0, b, 32):
        sl = slice(s0, s0 + 32)
        rots = quat.rotate3d(torch.as_tensor(q[sl], device=dev))
        proj = projector.project_full_3d(vf, rots, n, n // 2 - 1, pf=2)
        c2d = ctf_ops.ctf_pixels(colf, rowf, n, 1.32, *[
            torch.as_tensor(cp[k][sl], device=dev)[:, None] for k in
            ("voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
             "amp_contrast", "phase_shift")]).reshape(-1, n, n)
        sl_ft = translate_ft(proj * c2d, torch.as_tensor(tr[sl, 0], device=dev),
                             torch.as_tensor(tr[sl, 1], device=dev))
        chunks.append(fft_ops.ifft2_center(sl_ft).real.cpu().numpy())
    del vf
    stack = np.concatenate(chunks).astype(np.float32)
    stack += rng.normal(0, noise * stack.std(), stack.shape).astype(
        np.float32)
    return vol, stack, q, cp


def run_round(dev, n=160, b=N_PARTICLES, noise=NOISE, symmetric=True,
              bounds=True):
    """One global round on synthetic data; with ``bounds`` its pose error
    and resolution are held to ROUND_ANG_MAX / ROUND_RES_MIN."""
    import numpy as np
    import torch

    from thunder_tpu_torch.config import Para
    from thunder_tpu_torch.core.optimiser import Optimiser
    from thunder_tpu_torch.ops import insert, likelihood
    from thunder_tpu_torch.parallel import engine

    vol, stack, q_true, cp = synthetic_dataset(dev, n, b, noise=noise,
                                               symmetric=symmetric)
    log(f"synthetic stack built: {stack.shape}, cut: {b} particles "
        f"instead of bench.py's 256, noise {noise} x signal std, "
        f"{'C4-symmetric' if symmetric else 'asymmetric'} phantom")
    para = Para(
        mode="3d", k=1, size=n, pixel_size=1.32, mask_radius=75.0,
        trans_s=2.0, init_res=25.0, global_search_res=15.0, sym="C4",
        m_s=1024, m_l_r=125, m_l_t=9, m_l_d=9, m_reco=100,
        c_search=False, l_search=True, pf=2, seed=7, image_batch=64,
        save_ref_each_iter=False, save_thu_each_iter=False)
    opt = Optimiser(para, device=dev)
    opt.set_data(stack, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    opt._sync()
    log("optimiser ready; running one global round")
    # the round's first K2 call, kept (by reference) for k2_main_path
    calls = []

    def capture(*args):
        if not calls:
            calls.append(args)
        return insert.insert_update(*args)

    engine.insert_update = capture
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    likelihood.LAUNCHES["scan_fused"] = 0
    insert.LAUNCHES["insert_update"] = 0
    t0 = time.perf_counter()
    try:
        rec = opt.run_iteration()
        opt._sync()
    finally:
        engine.insert_update = insert.insert_update
    wall = time.perf_counter() - t0
    launches = {"global_scan": likelihood.LAUNCHES["scan_fused"],
                "insert_update": insert.LAUNCHES["insert_update"]}
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    held = sum(x.numel() * x.element_size() for x in calls[0][1:]) / 2 ** 30
    log(f"round done in {wall:.2f} s; launches {launches}; peak device "
        f"memory {peak:.2f} GiB (includes the captured first insert call's "
        f"samples, {held:.2f} GiB, held past their use; profile_torch.py "
        f"reads the peak without them)")
    log("stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in rec["timing"].items()}))
    log(f"n_phase (mean, max) = {rec['n_phase']}, res shell "
        f"{rec['res_shell']} ({rec['res_a']:.2f} A), ladder r "
        f"{rec['r']}, search type {rec['search_type']}")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched in the "
                                 "round")
    refs = opt.refs
    if tuple(refs.shape) != (2, 1, n, n, n) or not torch.isfinite(refs).all():
        raise AssertionError("non-finite or mis-shaped reference maps")
    if not np.isfinite(opt.fsc).all():
        raise AssertionError("non-finite FSC")
    q_est = opt.best_quat
    # the scan reduces rotations into the C4 fundamental domain by LEFT
    # multiplication (symmetry_counterpart: conj(g) q), and a C4-symmetric
    # reference projects alike at q and g q: compare with every g q_true
    from thunder_tpu_torch.geom.symmetry import Symmetry

    mates = np.concatenate([[[1.0, 0, 0, 0]], Symmetry("C4").quat])
    best = np.zeros(len(q_est))
    w2, x2, y2, z2 = q_true.T
    for w1, x1, y1, z1 in mates:
        gq = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                       w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                       w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)
        best = np.maximum(best, np.abs(np.sum(gq * q_est, 1)))
    ang = 2 * np.degrees(np.arccos(np.clip(best, -1, 1)))
    med = float(np.median(ang))
    log(f"pose recovery: median top-pose error {med:.2f} deg "
        f"(p25 {np.percentile(ang, 25):.2f}, p75 {np.percentile(ang, 75):.2f}"
        f"), share under {ROUND_ANG_MAX} deg "
        f"{float(np.mean(ang < ROUND_ANG_MAX)):.3f}")
    if not bounds:
        return rec, wall, launches, med, calls[0]
    if not med < ROUND_ANG_MAX:
        raise AssertionError(f"median pose error {med} >= {ROUND_ANG_MAX}")
    if rec["res_shell"] < ROUND_RES_MIN:
        raise AssertionError(f"resolution shell {rec['res_shell']} < "
                             f"{ROUND_RES_MIN}")
    return rec, wall, launches, med, calls[0]


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import thunder_tpu_torch  # noqa: F401  (fails outside the repository)
    from thunder_tpu_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s ({lib.name}, "
        f"nvcc {cuda_build.build_seconds})")
    sass = sass_counts(lib)
    if sass is None:
        log("SASS of the global-scan kernel: not available (no cuobjdump)")
    else:
        log(f"SASS: global-scan tensor-core instructions "
            f"{sass['global_scan']} (HGMMA = wgmma, HMMA = mma.sync); "
            f"insert atomics {sass['insert_atomics']}")
    k1 = check_k1(dev)
    # the slice's insert call: 64 images x 100 draws x 2048 ring pixels
    # into the mc = 165 accumulator (r_u 34 -> table band 40)
    k2 = check_k2(dev, 64 * 100 * 2048, 165)
    launches = {"global_scan": None, "insert_update": None}
    if "--kernels" not in argv:
        _, _, launches, _, call = run_round(dev)
        k2.update(k2_main_path(dev, call))
        del call
    if "--data-study" in argv:
        for noise, symmetric in ((1.0, False), (1.0, True), (NOISE, False)):
            log(f"data study: noise {noise}, symmetric phantom {symmetric}")
            run_round(dev, noise=noise, symmetric=symmetric, bounds=False)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="global_scan", route="cuda",
             source="thunder_tpu_torch/csrc/global_scan.cu",
             replaces="thunder_tpu/ops/pallas_likelihood.py:42",
             launches=launches["global_scan"],
             **{k: k1[k] for k in keys + (
                 "device_ms", "ms_b1024", "device_ms_b1024",
                 "library_ms_b1024", "bound_ms_b1024")},
             tensor_core_sass=None if sass is None else sass["global_scan"]),
        dict(name="insert_update", route="cuda",
             source="thunder_tpu_torch/csrc/insert.cu",
             replaces="thunder_tpu/ops/pallas_insert.py:59",
             launches=launches["insert_update"],
             **{k: k2[k] for k in keys + tuple(
                 x for x in ("main_path_ms", "main_path_library_ms",
                             "main_path_bound_ms", "main_path_samples",
                             "main_path_rows_hit", "main_path_rel_err",
                             "main_path_rel_err_plain")
                 if x in k2)}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)  # as nvidia-smi gives it, own line
    if "--kernels" in argv:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
