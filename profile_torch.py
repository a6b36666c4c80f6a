"""Where the time of one global round of the port goes on the card.

    python3 profile_torch.py [TRACE.json.gz]   # repository root, one GPU

Runs the round of ``chip_smoke.py`` (160 px, C4, 128 particles) once to
warm up (kernel build, cuFFT plans, allocator), then again under
``torch.profiler`` and prints:

- the warm-up round's peak device memory (no profiler, no capture),
- the round's wall time and the union of device-kernel intervals over it
  (device busy share; the rest is the GPU waiting on the host),
- device time and launch count by kernel name (top 15), and of the
  port's own kernels (K1's scan and merge, K2's insert),
- the number of device kernels launched in the round.

With a path argument the Chrome trace of the profiled round is written
there. Every number is printed with the card's name and power limit.
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


def main(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from thunder_tpu_torch.config import Para
    from thunder_tpu_torch.core.optimiser import Optimiser

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    n = 160
    vol, stack, _, cp = cs.synthetic_dataset(dev, n, cs.N_PARTICLES,
                                             noise=cs.NOISE)
    para = Para(
        mode="3d", k=1, size=n, pixel_size=1.32, mask_radius=75.0,
        trans_s=2.0, init_res=25.0, global_search_res=15.0, sym="C4",
        m_s=1024, m_l_r=125, m_l_t=9, m_l_d=9, m_reco=100,
        c_search=False, l_search=True, pf=2, seed=7, image_batch=64)

    def fresh():
        opt = Optimiser(para, device=dev)
        opt.set_data(stack, cp)
        opt.init_reference(vol=vol)
        opt.init_sigma()
        torch.cuda.synchronize()
        return opt

    opt = fresh()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    opt.run_iteration()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"warm-up round: {time.perf_counter() - t0:.3f} s, peak device "
          f"memory {peak:.3f} GiB", flush=True)
    del opt
    opt = fresh()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
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
    out = {"card": card, "round_wall_s": wall, "warm_up_peak_gib": peak,
           "device_busy_s": busy, "device_busy_share": busy / wall,
           "kernel_launches": len(kern),
           "stage_s": rec["timing"], "n_phase": rec["n_phase"],
           "top_kernels_ms": [{"name": k[:90], "ms": v[0], "count": v[1]}
                              for k, v in top],
           "port_kernels_ms": ours}
    print(json.dumps(out, indent=1), flush=True)
    if argv:
        os.makedirs(os.path.dirname(os.path.abspath(argv[0])), exist_ok=True)
        prof.export_chrome_trace(argv[0])
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
