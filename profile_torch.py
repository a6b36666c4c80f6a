"""Where the time of the port's rounds goes on the card.

    python3 profile_torch.py [TRACE.json.gz]   # repository root, one GPU

Runs ``chip_smoke.py``'s round sequence (160 px, C4, bench.py's 256
particles): a global round once to warm up (kernel build, cuFFT plans,
allocator), then on a fresh optimiser a global round under
``torch.profiler``, a pinned local round (bench.py's ``pin_local``, r = 40)
to warm up the local band, and one more pinned local round under the
profiler. For each profiled round it prints:

- the warm-up round's peak device memory (no profiler, no capture),
- the round's wall time and the union of device-kernel intervals over it
  (device busy share; the rest is the GPU waiting on the host),
- device time and launch count by kernel name (top 15), and of the
  port's own kernels (K1's scan and merge, K2's insert),
- the number of device kernels launched in the round;

and, on one insert chunk of the local round's state, the sample build
and K2 with each image's DC draws added once (the port's insert) and draw
by draw (the JAX insert's order).

With a path argument the Chrome traces of the profiled rounds are written
there (global) and beside it with ``_local`` before the suffix. Every
number is printed with the card's name and power limit.

    python3 profile_torch.py --classes [TRACE.json.gz]

does the same for ``chip_smoke.py``'s 3D classification path (path A:
configs/demo_3D.json, K = 4, 512 particles, seeded references): a K = 4
global round (the fused class insert) and a local round pinned at r = 40
(the insert staged class by class), and on one local insert chunk the
sample build and K2 of the four staged passes against one fused pass into
the K-fold table at the same band.

    python3 profile_torch.py --ctf [TRACE.json.gz]

profiles ``chip_smoke.py``'s path C (CTF search and the final round): a
global and a pinned local round unprofiled, a CTF round pinned at r = 40
(``pin_ctf``) unprofiled to warm up, a second pinned CTF round under the
profiler, then the final round (``finalise``: the Nyquist band, mc = 317)
once unprofiled and once under the profiler, cold (no C-balance warm
start, as in a run). Its files go to a temporary directory that is
removed at the end.

    python3 profile_torch.py --sym I [TRACE.json.gz]

profiles ``chip_smoke.py``'s path E (bench.py's Para under the point
group given, I in the smoke, on 256 images of a phantom with that group):
a global round and a local round pinned at r = 40 unprofiled, then a
second pinned local round under the profiler, with the seconds of its
symmetrisation (``engine.symmetrize_halves``: 2 halves x the group's
general rotations at mc = 293) beside the round's reconstruction stages.
"""

import json
import os
import sys
import time


def busy_union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def timed_round(opt):
    """An unprofiled round: (wall s, peak device GiB)."""
    import torch

    torch.cuda.reset_peak_memory_stats(opt.device)
    t0 = time.perf_counter()
    opt.run_iteration()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(opt.device) / 2 ** 30)


def profiled_round(opt, trace=None, final=False):
    """One round (``final``: the final round, ``opt.finalise``) under
    torch.profiler: its wall time, device busy share, launches and device
    time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if final:
            opt.finalise()
            rec = {"timing": opt.final_timing, "n_phase": None}
        else:
            rec = opt.run_iteration()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_union_us([(e.time_range.start, e.time_range.end)
                          for e in kern]) / 1e6
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # the port's own kernels (K1: scan + merge; K2: insert) in the round
    ours = {k: {"ms": v[0], "count": v[1]} for k, v in by_name.items()
            if any(n in k for n in ("global_scan_kernel", "merge_kernel",
                                    "insert_kernel"))}
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    return {"round_wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall, "kernel_launches": len(kern),
            "stage_s": rec["timing"], "n_phase": rec["n_phase"],
            "top_kernels_ms": [{"name": k[:90], "ms": v[0], "count": v[1]}
                               for k, v in top],
            "port_kernels_ms": ours}


def dc_merge_cost(opt, reps=5):
    """What adding each image's DC draws once costs and saves on one
    insert chunk of the optimiser's current state (half 0, first chunk,
    the reconstruction's own inputs): the sample build and K2 with the DC
    merge (``engine.dc_draw_weights``, the port's path) and draw by draw
    (the JAX insert's order), CUDA-event ms each."""
    import chip_smoke as cs
    from thunder_tpu_torch.ops import insert, pixels
    from thunder_tpu_torch.parallel import engine

    para, n, s = opt.para, opt.n, opt._chunk()
    r_u = opt.ladder.r_u
    ring = pixels.pixel_ring(n, 0, r_u)
    col, row, pmask = opt._ring_tensors(ring)
    mc = opt.insert_mc(r_u)
    dat, c, _ = opt._plane_ring_data(ring, ori=True, refined_defocus=True)
    n_draw = min(para.m_reco, para.m_l_r)
    par = opt.par
    ri, ti = opt.draws.insert(opt.iteration, (2, opt.s_slots), n_draw,
                              par["r"].shape[2], par["t"].shape[2])
    w = opt.scores * opt._t(opt.plane_valid) / n_draw
    args = (col, row, pmask, dat[0, :s], c[0, :s], w[0, :s], par["r"][0, :s],
            par["t"][0, :s], ri[0, :s], ti[0, :s], opt.offsets[0, :s])
    out = {}
    for name, dw in (("merged", engine.dc_draw_weights(col, row, n_draw)),
                     ("draw_by_draw", None)):
        build = lambda: engine.chunk_samples(*args, pf=para.pf, n=n, mc=mc,
                                             draw_w=dw)
        samples = build()[:-1]
        tab = insert.new_table(insert.rows_pad(mc ** 3 + 1),
                               device=opt.device)
        out[name] = {
            "build_ms": cs.cuda_ms(build, reps=reps),
            "k2_ms": cs.cuda_ms(lambda: insert.insert_update(tab, *samples),
                                reps=reps),
            "nonzero_dc_samples": int((samples[1].reshape(s, n_draw, -1)[
                :, :, 0] != 0).sum())}
        del samples, tab
    insert.LAUNCHES["insert_update"] = 0
    return out


def class_insert_cost(opt, reps=3):
    """One insert chunk of a K-class local round (half 0, first chunk): the
    staged insert builds the chunk's samples once per class (weights of
    the other classes zeroed) and adds them into a one-class table; the
    fused one builds them once, rows offset by class, into the K-fold
    table. CUDA-event ms of each build and K2 call, and the tables'
    sizes."""
    import torch

    import chip_smoke as cs
    from thunder_tpu_torch.ops import insert, pixels
    from thunder_tpu_torch.parallel import engine

    para, n, s, k = opt.para, opt.n, opt._chunk(), opt.para.k
    r_u = opt.ladder.r_u
    ring = pixels.pixel_ring(n, 0, r_u)
    col, row, pmask = opt._ring_tensors(ring)
    mc = opt.insert_mc(r_u)
    dat, c, _ = opt._plane_ring_data(ring, ori=True, refined_defocus=True)
    n_draw = min(para.m_reco, para.m_l_r)
    par = opt.par
    ri, ti = opt.draws.insert(opt.iteration, (2, opt.s_slots), n_draw,
                              par["r"].shape[2], par["t"].shape[2])
    scores = opt.scores if para.par_gra else torch.ones_like(opt.scores)
    w = (scores * opt._t(opt.plane_valid) / n_draw)[0, :s]
    cls = par["c"][0, :s].long()
    dw = engine.dc_draw_weights(col, row, n_draw)
    args = (col, row, pmask, dat[0, :s], c[0, :s])
    rest = (par["r"][0, :s], par["t"][0, :s], ri[0, :s], ti[0, :s],
            opt.offsets[0, :s])
    out = {"mc": mc, "k": k, "chunk_images": s}
    one = insert.new_table(insert.rows_pad(mc ** 3 + 1), device=opt.device)
    build = lambda kk: engine.chunk_samples(
        *args, w * (cls == kk), *rest, pf=para.pf, n=n, mc=mc, draw_w=dw)
    k2_ms = []
    for kk in range(k):
        samples = build(kk)[:-1]
        k2_ms.append(cs.cuda_ms(lambda: insert.insert_update(one, *samples),
                                reps=reps))
        del samples
    out["staged"] = {
        "build_ms_per_class": cs.cuda_ms(lambda: build(0), reps=reps),
        "k2_ms_per_class": k2_ms, "table_gib": one.numel() * 4 / 2 ** 30}
    del one
    fused = insert.new_table(insert.rows_pad(k * mc ** 3 + 1),
                             device=opt.device)
    build_f = lambda: engine.chunk_samples(
        *args, w, *rest, pf=para.pf, n=n, mc=mc, draw_w=dw, cls=cls,
        k_classes=k)
    samples = build_f()[:-1]
    out["fused"] = {
        "build_ms": cs.cuda_ms(build_f, reps=reps),
        "k2_ms": cs.cuda_ms(lambda: insert.insert_update(fused, *samples),
                            reps=reps),
        "table_gib": fused.numel() * 4 / 2 ** 30}
    del samples, fused
    insert.LAUNCHES["insert_update"] = 0
    return out


def main_classes(argv):
    """--classes: chip_smoke's path A, profiled."""
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    opt = cs.class3d_optimiser(dev)[0]
    wall, peak = timed_round(opt)
    print(f"warm-up K = 4 global round: {wall:.3f} s, peak device memory "
          f"{peak:.3f} GiB", flush=True)
    del opt
    opt = cs.class3d_optimiser(dev)[0]
    trace = argv[0] if argv else None
    out = {"card": card, "warm_up_global_peak_gib": peak,
           "global": profiled_round(opt, trace),
           "global_insert_fused": opt.insert_fused}
    cs.pin_local(opt)
    wall, peak = timed_round(opt)
    print(f"warm-up pinned K = 4 local round: {wall:.3f} s, peak device "
          f"memory {peak:.3f} GiB", flush=True)
    out["warm_up_local_peak_gib"] = peak
    cs.pin_local(opt)
    out["local"] = profiled_round(
        opt, trace and trace.replace(".json", "_local.json"))
    out["local_insert_fused"] = opt.insert_fused
    out["insert_chunk_staged_vs_fused"] = class_insert_cost(opt)
    print(json.dumps(out, indent=1), flush=True)
    print(f"card: {card}", flush=True)
    return 0


def main_ctf(argv):
    """--ctf: chip_smoke's path C, profiled."""
    import shutil
    import tempfile

    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="thunder_profile_")
    try:
        opt = cs.ctf_optimiser(dev, out_dir)[0]
        walls = {"global": timed_round(opt)}
        cs.pin_local(opt)
        walls["local"] = timed_round(opt)
        cs.pin_ctf(opt)
        walls["ctf_warm_up"] = timed_round(opt)
        for name, (wall, peak) in walls.items():
            print(f"{name} round: {wall:.3f} s, peak device memory "
                  f"{peak:.3f} GiB", flush=True)
        trace = argv[0] if argv else None
        out = {"card": card, "unprofiled_s_peak_gib": walls}
        cs.pin_ctf(opt)
        out["ctf"] = profiled_round(opt, trace)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        opt.finalise()
        torch.cuda.synchronize()
        out["final_unprofiled"] = {
            "wall_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "stage_s": opt.final_timing, "mc": opt.insert_mc(opt.max_r)}
        print(f"final round: {out['final_unprofiled']}", flush=True)
        opt._w_warm = {}
        out["final"] = profiled_round(
            opt, trace and trace.replace(".json", "_final.json"), final=True)
        print(json.dumps(out, indent=1), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"card: {card}", flush=True)
    return 0


def main_sym(argv):
    """--sym GROUP: chip_smoke's path E, its local round profiled."""
    import shutil
    import tempfile

    import torch

    import chip_smoke as cs

    sym = argv[0] if argv else cs.SYM_GROUP
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="thunder_profile_")
    try:
        opt = cs.sym_optimiser(dev, out_dir, sym=sym)[0]
        walls = {"global": timed_round(opt)}
        cs.pin_local(opt)
        walls["local_warm_up"] = timed_round(opt)
        for name, (wall, peak) in walls.items():
            print(f"{name} round: {wall:.3f} s, peak device memory "
                  f"{peak:.3f} GiB", flush=True)
        trace = argv[1] if len(argv) > 1 else None
        out = {"card": card, "sym": sym, "unprofiled_s_peak_gib": walls,
               "mc": opt.insert_mc(cs.R_LOCAL + round(opt.max_r / 3))}
        cs.pin_local(opt)
        with cs.SymTimer(opt) as sym_t:
            out["local"] = profiled_round(opt, trace)
        secs = sum(sum(v) for v in sym_t.seconds.values())
        stages = out["local"]["stage_s"]
        out["symmetrize_halves_s"] = secs
        out["symmetrize_share_of"] = {
            k: secs / stages[k] for k in ("reco_insert", "reconstruction")}
        print(json.dumps(out, indent=1), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"card: {card}", flush=True)
    return 0


def main(argv):
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    if "--classes" in argv:
        return main_classes([a for a in argv if a != "--classes"])
    if "--ctf" in argv:
        return main_ctf([a for a in argv if a != "--ctf"])
    if "--sym" in argv:
        return main_sym([a for a in argv if a != "--sym"])
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    opt, _ = cs.make_optimiser(dev)
    wall, peak = timed_round(opt)
    print(f"warm-up global round: {wall:.3f} s, peak device memory "
          f"{peak:.3f} GiB", flush=True)
    del opt
    opt, _ = cs.make_optimiser(dev)
    trace = argv[0] if argv else None
    out = {"card": card, "warm_up_global_peak_gib": peak,
           "global": profiled_round(opt, trace)}
    cs.pin_local(opt)
    wall, peak = timed_round(opt)
    print(f"warm-up pinned local round: {wall:.3f} s, peak device memory "
          f"{peak:.3f} GiB", flush=True)
    out["warm_up_local_peak_gib"] = peak
    cs.pin_local(opt)
    out["local"] = profiled_round(
        opt, trace and trace.replace(".json", "_local.json"))
    out["dc_merge_on_a_local_chunk"] = dc_merge_cost(opt)
    print(json.dumps(out, indent=1), flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
