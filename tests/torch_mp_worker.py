"""One rank of the port's multi-process tests (tests/test_torch_multiprocess.py),
run as a script so that it imports neither jax nor thunder_tpu. Ranks meet
through a ``file://`` rendezvous on the gloo backend, on the CPU.

    python torch_mp_worker.py run WORKDIR RANK WORLD INIT_FILE ROUNDS OUT
        [--draws NPZ] [--subtract] [--para NAME]
    python torch_mp_worker.py lockstep RANK WORLD INIT_FILE RESULT_NPZ

``run``: the refinement of WORKDIR's dataset (particles.thu, stack.mrcs,
init.mrc, NAME, default para.json): ``set_data_from_dataset`` (each rank reads its own
images), ROUNDS rounds each followed by ``save_outputs`` into WORKDIR/OUT
for rank 0 and WORKDIR/OUT_rank{r} for the others, which must stay empty;
then, with ``--subtract``, the subtraction pipeline into WORKDIR/OUT from
every rank. ``--draws`` replays recorded draws (``NpzDraws``) instead of
the port's own. Rank 0 saves each round's poses, classes, FSC, sigma,
references and shell to WORKDIR/OUT.npz.

``lockstep``: ``engine.local_search`` on this rank's rows of a seeded
problem, with ``particle.vari_shrank`` forced so that rank 0's images never
finish and the other ranks' finish at the first phase that may end them;
saves the state, phase counts and the number of phases drawn.
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from thunder_tpu_torch.parallel import distributed  # noqa: E402

torch.set_num_threads(1)


class NpzDraws:
    """Draws recorded in order into an .npz (key ``{method}_{i}[_{name}]``
    for the i-th call): each call returns the next recording of its method
    and raises when there is none. ``phase_draws`` returns a callable of the
    phase, whose recordings are keyed ``phase_draws_{i}_{phase}_{name}``."""

    def __init__(self, path):
        self.z = dict(np.load(path))
        self.calls = {}

    def _next(self, method):
        i = self.calls.get(method, 0)
        self.calls[method] = i + 1
        return f"{method}_{i}"

    def _get(self, key):
        if key not in self.z:
            raise KeyError(f"no recorded draw {key}")
        return torch.as_tensor(self.z[key])

    def _many(self, method, names):
        key = self._next(method)
        return tuple(self._get(f"{key}_{n}") for n in names)

    def scan_grid(self, n_r, n_t):
        return self._many("scan_grid", ("r", "t"))

    def scan_seed(self, iteration, shape, k):
        return self._many("scan_seed", ("g", "u_r", "u_t"))

    def phase_draws(self, iteration, shape, n_r, n_t, mode="3d", n_d=0):
        key = self._next("phase_draws")
        names = ("normals_r", "normals_t", "u0_r", "u0_t", "anchor")
        return lambda phase: {n: self._get(f"{key}_{phase}_{n}")
                              for n in names}

    def insert(self, iteration, shape, n_draw, n_r, n_t):
        return self._many("insert", ("ri", "ti"))

    def fsc_phases(self, n):
        return self._many("fsc_phases", ("a", "b"))


def run(args):
    from thunder_tpu_torch.config import Para
    from thunder_tpu_torch.core.optimiser import Optimiser
    from thunder_tpu_torch.data import ParticleDataset
    from thunder_tpu_torch.io import read_mrc

    w = args.workdir
    distributed.maybe_initialize(f"file://{args.init_file}", args.world,
                                 args.rank, cpu=True)
    with open(os.path.join(w, args.para)) as f:
        para = Para(**json.load(f))
    out = os.path.join(w, args.out)
    own = out if args.rank == 0 else f"{out}_rank{args.rank}"
    para = dataclasses.replace(para, output_directory=own)
    draws = NpzDraws(args.draws) if args.draws else None
    opt = Optimiser(para, device="cpu", draws=draws)
    opt.set_data_from_dataset(ParticleDataset(
        os.path.join(w, "particles.thu"), particle_prefix=w, seed=para.seed))
    opt.init_reference(read_mrc(os.path.join(w, "init.mrc")))
    opt.init_sigma()
    res = {}
    for r in range(1, args.rounds + 1):
        rec = opt.run_iteration()
        opt.save_outputs()
        res.update({f"top_r_{r}": opt.best_quat, f"top_t_{r}": opt.best_trans,
                    f"class_{r}": opt.best_class,
                    f"fsc_{r}": opt.fsc, f"sig_{r}": opt.sig.numpy(),
                    f"refs_{r}": opt.refs.numpy(),
                    f"res_shell_{r}": rec["res_shell"]})
        if rec["rank_gaps"] is not None:
            res[f"rank_gaps_{r}"] = np.array(
                [rec["rank_gaps"][k] for k in ("refs", "fsc", "T")])
    if args.rank:
        leaked = os.listdir(own) if os.path.isdir(own) else []
        if leaked:
            raise AssertionError(f"rank {args.rank} wrote {leaked}")
    if args.subtract:
        opt.para = dataclasses.replace(opt.para, output_directory=out,
                                       subtract=True, region_centre="")
        opt._subtract_pipeline()
    if distributed.is_main():
        np.savez(f"{out}.npz", **res)
    distributed.shutdown()


def lockstep(args):
    distributed.maybe_initialize(f"file://{args.init_file}", args.world,
                                 args.rank, cpu=True)
    st, nph, drawn = lockstep_run(args.rank, args.world)
    np.savez(args.result, nph=nph.numpy(), drawn=np.asarray(drawn),
             **{k: v.numpy() for k, v in st.items()})
    distributed.shutdown()


LOCK_S, LOCK_NR, LOCK_NT, LOCK_SEED = 5, 6, 4, 11
LOCK_KW = dict(pf=2, n=16, min_phase=2, max_phase=6)


def lockstep_run(rank, world):
    """``engine.local_search`` on rank ``rank``'s rows (of ``world``) of
    ``lockstep_problem``, with ``particle.vari_shrank`` forced to "shrank"
    on rank 0 (its images never finish) and "did not shrink" elsewhere
    (they finish at phase ``min_phase``). Returns (state, phase counts,
    the phases drawn)."""
    from thunder_tpu_torch.core import particle
    from thunder_tpu_torch.core.draws import Draws, RowDraws
    from thunder_tpu_torch.parallel import engine

    rows = distributed.local_plane_rows(LOCK_S, world, rank)
    draws = RowDraws(Draws(LOCK_SEED, "cpu"), rows).phase_draws(
        0, (2, LOCK_S), LOCK_NR, LOCK_NT)
    drawn = []

    def phase_draws(phase):
        drawn.append(phase)
        return draws(phase)

    orig = particle.vari_shrank
    particle.vari_shrank = lambda new, st, mode="3d": torch.full(
        (new["r"].shape[0],), rank == 0, dtype=torch.bool)
    try:
        st, nph = engine.local_search(
            *lockstep_problem(rows), phase_draws, torch.zeros((0, 4)), 0.5,
            0.2, **LOCK_KW)
    finally:
        particle.vari_shrank = orig
    return st, nph, drawn


def lockstep_problem(rows):
    """A seeded local-search problem at n = 16 (a random map's half-space
    tables, ring data, a fresh filter state with spread supports), the
    global (2, LOCK_S) batch cut to ``rows``: the arguments of
    ``engine.local_search`` before ``phase_draws``."""
    from thunder_tpu_torch.core import particle, projector
    from thunder_tpu_torch.ops import pixels

    rng = np.random.default_rng(LOCK_SEED)
    n = LOCK_KW["n"]
    vol = torch.as_tensor(rng.normal(size=(n, n, n)).astype(np.float32))
    tab = projector.build_brick_projectee_3d(vol, 6, pf=2, half=True)
    bricks = tab[None, None].expand(2, 1, *tab.shape).contiguous()
    ring = pixels.pixel_ring(n, 1, 6)
    col = torch.as_tensor(ring.col).long()
    row = torch.as_tensor(ring.row).long()
    pmask = torch.as_tensor(ring.mask)
    p = col.shape[0]
    cut = lambda a: torch.as_tensor(a[:, rows]).contiguous()
    dat = cut((rng.normal(size=(2, LOCK_S, p))
               + 1j * rng.normal(size=(2, LOCK_S, p))).astype(np.complex64))
    ctf = cut(np.ones((2, LOCK_S, p), np.float32))
    sig_rcp = cut(np.full((2, LOCK_S, p), -0.5, np.float32))
    st = particle.make_state((2, LOCK_S), LOCK_NR, LOCK_NT, 1)
    q = rng.normal(size=(2, LOCK_S, LOCK_NR, 4)).astype(np.float32)
    st["r"] = torch.as_tensor(q / np.linalg.norm(q, axis=-1, keepdims=True))
    st["t"] = torch.as_tensor(rng.normal(
        size=(2, LOCK_S, LOCK_NT, 2)).astype(np.float32))
    st = {k: v[:, rows].contiguous() for k, v in st.items()}
    return bricks, col, row, pmask, dat, ctf, sig_rcp, st


def main(argv):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("run")
    r.add_argument("workdir")
    r.add_argument("rank", type=int)
    r.add_argument("world", type=int)
    r.add_argument("init_file")
    r.add_argument("rounds", type=int)
    r.add_argument("out")
    r.add_argument("--draws", default="")
    r.add_argument("--subtract", action="store_true")
    r.add_argument("--para", default="para.json")
    r.set_defaults(fn=run)
    lk = sub.add_parser("lockstep")
    lk.add_argument("rank", type=int)
    lk.add_argument("world", type=int)
    lk.add_argument("init_file")
    lk.add_argument("result")
    lk.set_defaults(fn=lockstep)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
