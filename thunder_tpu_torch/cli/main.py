"""Command-line interface of the port (``thunder_tpu.cli`` for PyTorch):
one program, the same 17 subcommands with the same flags and printed
lines, run on the CUDA device unless ``--cpu`` is given:

    run          refinement driven by a THUNDER-schema JSON (thunder.cpp)
    project      volume + .thu poses -> particle stack
    reconstruct  .thu poses + stack -> volume
    postprocess  two half maps + mask -> sharpened map + FSC
    genmask      auto mask from a volume
    genmask_shell  shell mask between two radii
    lowpass      low-pass filter a volume
    bfactor      apply a B-factor
    mask         multiply a volume by a mask
    average      average two volumes
    minus        subtract two volumes
    resize       Fourier crop/pad to a new box
    alignz       align a direction to +z
    view         print volume stats / dump central slices
    select       class-average gallery + .thu class selection
    star2thu     RELION STAR -> .thu
    thu2star     .thu -> RELION STAR

    python -m thunder_tpu_torch.cli run config.json [-o DIR] [--profile DIR]
    torchrun --nproc-per-node N -m thunder_tpu_torch.cli run config.json

``run`` joins a multi-process run under torchrun's variables or the JAX
package's (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID).
"""

import argparse
import json
import os

import numpy as np


def _device(args):
    import torch

    return torch.device("cpu" if getattr(args, "cpu", False) else "cuda")


def _tensor(x, dev):
    import torch

    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _host(x):
    return x.detach().cpu().numpy()


def cmd_run(args):
    """Refinement; under torchrun's variables or the JAX package's
    (``parallel.distributed.maybe_initialize``) one rank of a
    multi-process run, which leaves its process group at the end."""
    from ..parallel import distributed

    dev = distributed.maybe_initialize(cpu=getattr(args, "cpu", False))
    try:
        _run(args, dev)
    finally:
        distributed.shutdown()


def _run(args, dev):
    from ..config import load_para
    from ..core.optimiser import Optimiser
    from ..data import ParticleDataset
    from ..io import ThuColumns, read_mrc
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh
    from ..utils import get_logger, init_logger

    mesh = make_mesh()
    rank, world = mesh.rank, mesh.world
    para = load_para(args.config, strict=getattr(args, "strict", False))
    if args.output:
        para.output_directory = args.output
    init_logger(para.output_directory, process_index=rank)
    get_logger("SYS").info("parameters loaded from %s", args.config)
    if world > 1:
        joined = (f"rank {rank} of {world}: backend "
                  f"{distributed.backend()}, device {dev}, mesh {mesh.shape}")
        if distributed.backend() == "gloo" and dev.type == "cuda":
            joined += ("; warning: more ranks on this host than cards, so "
                       "the collectives are staged through host memory "
                       "(set LOCAL_WORLD_SIZE to the ranks a host)")
        get_logger("SYS").info(joined)
        print(joined, flush=True)
    prof = None
    if getattr(args, "profile", None):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    ds = ParticleDataset(para.db, para.par_prefix, seed=para.seed)
    opt = Optimiser(para, device=dev)
    opt.set_data_from_dataset(ds)
    if not para.g_search:
        # resume from the stored poses (Global Search: false)
        q, tr, d, cls = ds.poses()
        t = ds.table
        opt.load_poses(
            q, tr, d, cls,
            k123=(t.col(ThuColumns.K1), t.col(ThuColumns.K2),
                  t.col(ThuColumns.K3)),
            std_t=(t.col(ThuColumns.STD_TRANSLATION_X),
                   t.col(ThuColumns.STD_TRANSLATION_Y)))
    init_vol = read_mrc(para.init_model) if para.init_model else None
    opt.init_reference(vol=init_vol)
    opt.init_sigma()
    history = opt.run()
    opt.save_outputs(final=True)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.profile, f"trace_rank_{rank:06d}.json" if rank
            else "trace.json"))
    if not distributed.is_main():
        return
    for rec in history:
        print(json.dumps(
            rec, default=lambda o: o.tolist() if hasattr(o, "tolist")
            else str(o)))


def cmd_project(args):
    from ..core import projector
    from ..data import ParticleDataset
    from ..geom import quat
    from ..io import read_mrc, write_mrc
    from ..ops import fft as fft_ops
    from ..ops.translate import translate_ft

    dev = _device(args)
    vol = _tensor(read_mrc(args.volume), dev)
    n = vol.shape[-1]
    ds = ParticleDataset(args.thu)
    q, tr, _, _ = ds.poses()
    vf = projector.build_projectee_3d(vol, pf=args.pf)
    out = []
    for s in range(0, ds.n, 64):
        sl = slice(s, s + 64)
        proj = projector.project_full_3d(vf, quat.rotate3d(_tensor(q[sl], dev)),
                                         n, n // 2 - 1, pf=args.pf)
        proj = translate_ft(proj, _tensor(tr[sl, 0], dev),
                            _tensor(tr[sl, 1], dev))
        out.append(_host(fft_ops.ifft2_center(proj).real))
    stack = np.concatenate(out)
    if args.noise > 0:
        # additive Gaussian noise relative to the projections' std
        rng = np.random.default_rng(args.seed)
        stack = stack + rng.normal(
            0, args.noise * stack.std(), stack.shape).astype(np.float32)
    write_mrc(args.output, stack, voxel_size=args.pixel_size)
    print(f"wrote {ds.n} projections to {args.output}")


def cmd_reconstruct(args):
    import torch

    from ..core import reconstructor
    from ..data import ParticleDataset
    from ..geom import quat
    from ..io import write_mrc
    from ..ops import fft as fft_ops, pixels
    from ..ops.translate import translation_phase

    dev = _device(args)
    ds = ParticleDataset(args.thu)
    imgs = ds.load_images()
    n = imgs.shape[-1]
    q, tr, _, _ = ds.poses()
    ring = pixels.pixel_ring(n, 0, n // 2 - 2)
    col = torch.as_tensor(ring.col, device=dev).long()
    row = torch.as_tensor(ring.row, device=dev).long()
    pmask = _tensor(ring.mask, dev)
    dat = pixels.gather_pixels(fft_ops.fft2_center(_tensor(imgs, dev)), ring)
    state = reconstructor.empty_state(n, pf=args.pf, device=dev)
    for s in range(0, ds.n, 256):
        sl = slice(s, min(s + 256, ds.n))
        tra = translation_phase(col, row, _tensor(-tr[sl, 0], dev),
                                _tensor(-tr[sl, 1], dev), n)
        state = reconstructor.insert_pixels_3d(
            state, dat[sl] * tra, torch.ones_like(dat[sl].real),
            quat.rotate3d(_tensor(q[sl], dev)), col, row,
            torch.ones(sl.stop - sl.start, device=dev), pf=args.pf,
            pixel_mask=pmask)
    vol = reconstructor.reconstruct(
        state["F"], state["T"], torch.ones(n // 2, device=dev), n,
        pf=args.pf, max_radius=n // 2 - 2)
    write_mrc(args.output, _host(vol), voxel_size=args.pixel_size)
    print(f"reconstructed {args.output} from {ds.n} particles")


def cmd_postprocess(args):
    from ..core.postprocess import postprocess
    from ..io import read_mrc, write_mrc
    from ..ops.mask import soft_mask_shape

    a, hdr = read_mrc(args.half_a, return_header=True)
    b = read_mrc(args.half_b)
    ps = args.pixel_size or hdr.voxel_size or 1.0
    if args.mask:
        m = read_mrc(args.mask)
    else:
        n = a.shape[-1]
        m = _host(soft_mask_shape((n, n, n), n * 0.45, 3.0))
    res = postprocess(a, b, m, ps, thres=args.thres, device=_device(args))
    write_mrc(args.output, res.map, voxel_size=ps)
    print(f"resolution: {res.res_a:.2f} A (shell {res.res_shell}), "
          f"B-factor: {res.b_factor:.1f}")
    if args.fsc:
        with open(args.fsc, "w") as f:
            for i in range(len(res.fsc_true)):
                f.write(f"{i} {res.fsc_unmasked[i]:.6f} "
                        f"{res.fsc_masked[i]:.6f} {res.fsc_true[i]:.6f}\n")


def cmd_genmask(args):
    """thunder_genmask: explicit --threshold, or the partial-sum auto
    threshold when omitted (src/Functions/Mask.cpp:733-790)."""
    from ..io import read_mrc, write_mrc
    from ..ops.mask import auto_mask_threshold, gen_mask

    vol, hdr = read_mrc(args.input, return_header=True)
    thres = args.threshold
    if thres is None:
        r = args.radius if args.radius else vol.shape[-1] / 2
        thres = auto_mask_threshold(vol, r)
        print(f"auto threshold: {thres:.6g}")
    m = gen_mask(vol, thres, args.extend, args.edge)
    write_mrc(args.output, m, voxel_size=hdr.voxel_size)
    print(f"wrote mask {args.output}")


def cmd_genmask_shell(args):
    """thunder_genmask_shell: a shell mask between two radii (angstrom)
    with cosine edges."""
    from ..io import write_mrc
    from ..ops.mask import shell_mask

    n = args.boxsize
    m = shell_mask((n, n, n), args.inner_radius / args.pixelsize,
                   args.outer_radius / args.pixelsize, args.edgewidth,
                   device=_device(args))
    write_mrc(args.output, _host(m), voxel_size=args.pixelsize)
    print(f"wrote shell mask {args.output}")


def _ffts(dims):
    from ..ops import fft as fft_ops

    if dims == 3:
        return fft_ops.fft3_center, fft_ops.ifft3_center
    return fft_ops.fft2_center, fft_ops.ifft2_center


def _filter_tool(args, fn):
    from ..io import read_mrc, write_mrc

    vol, hdr = read_mrc(args.input, return_header=True)
    dims = vol.ndim
    fftc, ifftc = _ffts(dims)
    ft = fn(fftc(_tensor(vol, _device(args))), hdr, dims)
    write_mrc(args.output, _host(ifftc(ft).real), voxel_size=hdr.voxel_size)
    print(f"wrote {args.output}")


def cmd_lowpass(args):
    from ..ops import filters

    def fn(ft, hdr, dims):
        p = args.pixel_size or hdr.voxel_size or 1.0
        return filters.low_pass_filter(ft, p / args.resolution, args.edge,
                                       dims)

    _filter_tool(args, fn)


def cmd_bfactor(args):
    from ..ops import filters

    _filter_tool(args, lambda ft, hdr, dims: filters.b_factor_filter(
        ft, args.bfactor, dims))


def _volume_tool(path_a, path_b, output, fn):
    """Element-wise tools on two maps: write fn(a, b) with a's voxel
    size."""
    from ..io import read_mrc, write_mrc

    a, hdr = read_mrc(path_a, return_header=True)
    write_mrc(output, fn(a, read_mrc(path_b)), voxel_size=hdr.voxel_size)
    print(f"wrote {output}")


def cmd_mask(args):
    _volume_tool(args.input, args.mask, args.output, lambda v, m: v * m)


def cmd_average(args):
    _volume_tool(args.a, args.b, args.output, lambda a, b: (a + b) / 2)


def cmd_minus(args):
    _volume_tool(args.a, args.b, args.output, lambda a, b: a - b)


def cmd_resize(args):
    from ..io import read_mrc, write_mrc
    from ..ops import fft as fft_ops

    vol, hdr = read_mrc(args.input, return_header=True)
    dims = vol.ndim
    n_old = vol.shape[-1]
    fftc, ifftc = _ffts(dims)
    ft = fftc(_tensor(vol, _device(args)))
    if args.size > n_old:
        pad = args.size - n_old
        lo = args.size // 2 - n_old // 2
        import torch

        ft = torch.nn.functional.pad(ft, (lo, pad - lo) * dims)
    else:
        ft = fft_ops.crop_ft_center(ft, args.size, dims)
    out = ifftc(ft).real * (args.size ** dims / n_old ** dims)
    new_ps = hdr.voxel_size * n_old / args.size
    write_mrc(args.output, _host(out), voxel_size=new_ps)
    print(f"wrote {args.output} at {args.size} px, {new_ps:.4f} A/px")


def cmd_alignz(args):
    import torch

    from ..geom.quat import align_z
    from ..io import read_mrc, write_mrc
    from ..ops.interp import linear_gather

    dev = _device(args)
    vol, hdr = read_mrc(args.input, return_header=True)
    v = np.asarray([float(x) for x in args.axis.split(",")])
    v = v / np.linalg.norm(v)
    rot = _host(align_z(torch.as_tensor(v, dtype=torch.float32)))
    n = vol.shape[-1]
    idx = np.arange(n, dtype=np.float32) - n // 2
    zz, yy, xx = np.meshgrid(idx, idx, idx, indexing="ij")
    coords = np.stack([xx, yy, zz], axis=-1) @ rot  # sample at R^T x
    out = linear_gather(_tensor(vol, dev),
                        _tensor(np.ascontiguousarray(coords[..., ::-1]), dev))
    write_mrc(args.output, _host(out), voxel_size=hdr.voxel_size)
    print(f"wrote {args.output}")


def cmd_view(args):
    from ..io import read_mrc
    from ..io.bmp import write_bmp

    vol, hdr = read_mrc(args.input, return_header=True)
    print(f"shape: {vol.shape}  mode 2  voxel {hdr.voxel_size:.4f} A")
    print(f"min {vol.min():.4g}  max {vol.max():.4g}  "
          f"mean {vol.mean():.4g}  std {vol.std():.4g}")
    if vol.ndim == 3 and args.slices:
        n = vol.shape[0]
        for name, sl in (("xy", vol[n // 2]), ("xz", vol[:, n // 2]),
                         ("yz", vol[:, :, n // 2])):
            path = f"{args.slices}_{name}.bmp"
            write_bmp(path, sl)
            print(f"wrote {path}")


def _parse_keep(spec):
    """'0,2,5-8' -> {0, 2, 5, 6, 7, 8}."""
    keep = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            keep.update(range(int(lo), int(hi) + 1))
        else:
            keep.add(int(part))
    return keep


def cmd_select(args):
    """Class-average inspection + selection — the thunder_stackview GUI's
    workflow (gui/thunder_stackview/, README.md:37-47): view the 2D class
    averages of Reference_Round_XXX.mrcs, pick classes, write the
    filtered .thu. Here: an HTML gallery with embedded images + per-class
    stats, and --keep to write the subset table."""
    import base64
    import os

    from ..io import read_mrc
    from ..io.bmp import write_bmp
    from ..io.thu import ThuColumns, read_thu, write_thu

    stack = read_mrc(args.stack)
    if stack.ndim == 2:
        stack = stack[None]
    k = stack.shape[0]
    table = read_thu(args.thu) if args.thu else None
    counts = np.zeros(k, np.int64)
    if table is not None:
        cls = table.col(ThuColumns.CLASS_ID).astype(np.int64)
        counts = np.bincount(np.clip(cls, 0, k - 1), minlength=k)
    frac = counts / max(counts.sum(), 1)

    rows = []
    for t in range(k):
        img = stack[t]
        lo, hi = np.percentile(img, [1, 99])
        norm = np.clip((img - lo) / max(hi - lo, 1e-12), 0, 1)
        # write via the BMP writer to a temp path, then inline base64
        tmp_path = f"{args.output}.cls{t:03d}.bmp"
        write_bmp(tmp_path, norm)
        with open(tmp_path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        os.remove(tmp_path)
        rows.append((t, frac[t], int(counts[t]), b64))

    if args.sort:
        rows.sort(key=lambda r: -r[1])
    # interactive selection in the browser (the thunder_stackview
    # check-classes-and-save workflow): click tiles to toggle, export the
    # keep list, feed it back with --keep-file to write the filtered .thu
    with open(args.output, "w") as f:
        f.write(
            "<!doctype html><html><head><meta charset='utf-8'><style>\n"
            "body{font-family:monospace;margin:16px}\n"
            ".tile{margin:4px;text-align:center;cursor:pointer;"
            "border:3px solid transparent;border-radius:4px;padding:2px}\n"
            ".tile.sel{border-color:#2a7;background:#e8f8f0}\n"
            "#bar{position:sticky;top:0;background:#fff;padding:8px 0;"
            "border-bottom:1px solid #ccc;margin-bottom:8px}\n"
            "button{font-family:monospace;margin-right:8px}\n"
            "</style></head><body>\n"
            f"<h2>Class averages: {os.path.basename(args.stack)}</h2>\n"
            "<div id='bar'><button onclick='all(true)'>Select all"
            "</button><button onclick='all(false)'>Clear</button>"
            "<button onclick='inv()'>Invert</button>"
            "<button onclick='exp()'>Export keep list</button> "
            "<span id='stat'></span></div>\n"
            "<div style='display:flex;flex-wrap:wrap'>\n")
        for t, fr, cnt, b64 in rows:
            f.write(
                f"<div class='tile' data-c='{t}' data-n='{cnt}' "
                "onclick='tog(this)'>"
                f"<img src='data:image/bmp;base64,{b64}' width='128'><br>"
                f"class {t}<br>{fr*100:.1f}% ({cnt})</div>\n")
        total = int(counts.sum())
        f.write(
            "</div><script>\n"
            f"const TOTAL={max(total, 1)};\n"
            "function tiles(){return [...document."
            "querySelectorAll('.tile')]}\n"
            "function upd(){const s=tiles().filter(t=>t.classList."
            "contains('sel'));const n=s.reduce((a,t)=>a+ +t.dataset.n,0);"
            "document.getElementById('stat').textContent="
            "`${s.length} classes, ${n} particles "
            "(${(100*n/TOTAL).toFixed(1)}%) selected`;}\n"
            "function tog(t){t.classList.toggle('sel');upd();}\n"
            "function all(v){tiles().forEach(t=>t.classList."
            "toggle('sel',v));upd();}\n"
            "function inv(){tiles().forEach(t=>t.classList."
            "toggle('sel'));upd();}\n"
            "function exp(){const ks=tiles().filter(t=>t.classList."
            "contains('sel')).map(t=>t.dataset.c).join(',');"
            "const a=document.createElement('a');"
            "a.href='data:text/plain,'+encodeURIComponent(ks+'\\n');"
            "a.download='keep.txt';a.click();}\n"
            "upd();</script></body></html>\n")
    print(f"wrote interactive gallery with {k} classes to {args.output}")
    keep_spec = args.keep
    if getattr(args, "keep_file", ""):
        with open(args.keep_file) as kf:
            keep_spec = ",".join(kf.read().replace("\n", ",").split())

    if keep_spec:
        if table is None:
            raise SystemExit("--keep requires --thu")
        keep = _parse_keep(keep_spec)
        sel = np.isin(cls, sorted(keep))
        out_thu = args.keep_output or (
            os.path.splitext(args.thu)[0] + "_selected.thu")
        write_thu(out_thu, _subset_thu(table, sel))
        print(f"kept {int(sel.sum())}/{len(sel)} particles "
              f"(classes {sorted(keep)}) -> {out_thu}")


def _subset_thu(table, sel):
    from ..io.thu import ThuTable

    idx = np.nonzero(sel)[0]
    return ThuTable(
        values=table.values[idx],
        particle_paths=[table.particle_paths[i] for i in idx],
        micrograph_paths=[table.micrograph_paths[i] for i in idx],
    )


def cmd_star2thu(args):
    from ..io.star import star_to_thu

    out = star_to_thu(args.input, args.output)
    print(f"converted {len(out)} rows -> {args.output}")


def cmd_thu2star(args):
    from ..io.star import thu_to_star

    thu_to_star(args.input, args.output)
    print(f"converted -> {args.output}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="thunder_tpu_torch",
        description="cryo-EM refinement on PyTorch/CUDA"
    )
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("run");             s.add_argument("config")
    s.add_argument("-o", "--output", default="")
    s.add_argument("--strict", action="store_true",
                   help="reject unrecognised config keys (reference parity)")
    s.add_argument("--profile", default="",
                   help="write a torch.profiler trace to this directory")
    s.set_defaults(fn=cmd_run)

    s = sub.add_parser("project")
    s.add_argument("volume"); s.add_argument("thu"); s.add_argument("output")
    s.add_argument("--pf", type=int, default=2)
    s.add_argument("--pixel-size", type=float, default=1.0)
    s.add_argument("--noise", type=float, default=0.0,
                   help="additive Gaussian noise, relative to stack std")
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_project)

    s = sub.add_parser("reconstruct")
    s.add_argument("thu"); s.add_argument("output")
    s.add_argument("--pf", type=int, default=2)
    s.add_argument("--pixel-size", type=float, default=1.0)
    s.set_defaults(fn=cmd_reconstruct)

    s = sub.add_parser("postprocess")
    s.add_argument("half_a"); s.add_argument("half_b"); s.add_argument("output")
    s.add_argument("--mask", default="")
    s.add_argument("--pixel-size", type=float, default=0.0)
    s.add_argument("--thres", type=float, default=0.143)
    s.add_argument("--fsc", default="")
    s.set_defaults(fn=cmd_postprocess)

    s = sub.add_parser("genmask")
    s.add_argument("input"); s.add_argument("output")
    s.add_argument("--threshold", type=float, default=None,
                   help="density threshold (auto partial-sum search if omitted)")
    s.add_argument("--radius", type=float, default=0,
                   help="search radius in pixels for the auto threshold")
    s.add_argument("--extend", type=float, default=3)
    s.add_argument("--edge", type=float, default=6)
    s.set_defaults(fn=cmd_genmask)

    s = sub.add_parser("genmask_shell")
    s.add_argument("output")
    s.add_argument("--boxsize", type=int, required=True)
    s.add_argument("--inner-radius", type=float, required=True)
    s.add_argument("--outer-radius", type=float, required=True)
    s.add_argument("--edgewidth", type=float, default=6)
    s.add_argument("--pixelsize", type=float, default=1.0)
    s.set_defaults(fn=cmd_genmask_shell)

    s = sub.add_parser("lowpass")
    s.add_argument("input"); s.add_argument("output")
    s.add_argument("--resolution", type=float, required=True,
                   help="cutoff in angstrom")
    s.add_argument("--edge", type=float, default=0.02,
                   help="edge width in cycles/pixel")
    s.add_argument("--pixel-size", type=float, default=0.0)
    s.set_defaults(fn=cmd_lowpass)

    s = sub.add_parser("bfactor")
    s.add_argument("input"); s.add_argument("output")
    s.add_argument("--bfactor", type=float, required=True)
    s.set_defaults(fn=cmd_bfactor)

    s = sub.add_parser("mask")
    s.add_argument("input"); s.add_argument("mask"); s.add_argument("output")
    s.set_defaults(fn=cmd_mask)

    s = sub.add_parser("average")
    s.add_argument("a"); s.add_argument("b"); s.add_argument("output")
    s.set_defaults(fn=cmd_average)

    s = sub.add_parser("minus")
    s.add_argument("a"); s.add_argument("b"); s.add_argument("output")
    s.set_defaults(fn=cmd_minus)

    s = sub.add_parser("resize")
    s.add_argument("input"); s.add_argument("output")
    s.add_argument("--size", type=int, required=True)
    s.set_defaults(fn=cmd_resize)

    s = sub.add_parser("alignz")
    s.add_argument("input"); s.add_argument("output")
    s.add_argument("--axis", required=True, help="x,y,z direction")
    s.set_defaults(fn=cmd_alignz)

    s = sub.add_parser("view")
    s.add_argument("input")
    s.add_argument("--slices", default="", help="prefix for BMP slice dumps")
    s.set_defaults(fn=cmd_view)

    s = sub.add_parser("select",
                       help="class-average gallery + .thu class selection "
                       "(thunder_stackview replacement)")
    s.add_argument("stack", help="class-average stack (.mrcs)")
    s.add_argument("output", help="HTML gallery output path")
    s.add_argument("--thu", default="", help=".thu with class assignments")
    s.add_argument("--keep", default="",
                   help="classes to keep, e.g. '0,2,5-8'; writes the "
                   "filtered .thu")
    s.add_argument("--keep-output", default="")
    s.add_argument("--keep-file", default="",
                   help="read the keep list from a file (the gallery's "
                   "'Export keep list' download)")
    s.add_argument("--sort", action="store_true",
                   help="order gallery by class population")
    s.set_defaults(fn=cmd_select)

    s = sub.add_parser("star2thu")
    s.add_argument("input"); s.add_argument("output")
    s.set_defaults(fn=cmd_star2thu)

    s = sub.add_parser("thu2star")
    s.add_argument("input"); s.add_argument("output")
    s.set_defaults(fn=cmd_thu2star)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
