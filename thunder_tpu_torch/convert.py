"""Carry an optimiser's state between the JAX package and the port.

The state travels as a plain dict of NumPy arrays, so this module imports
neither package's optimiser internals beyond the port's own:

- ``refs`` (2, K, n, n[, n]) references, ``sig`` (G, n//2) noise spectra,
- ``par``: the particle-filter dict (r, t, d, c, wR, wT, wD, topR, topT,
  topD, k1, k2, k3, s0, s1, sD, pfR, pfT, pfD), each (2, S, ...),
- ``ladder``: the LadderState fields as a dict,
- ``plane_index``/``plane_valid``/``groups_plane`` (2, S) layout,
- ``offsets`` (2, S, 2), ``scores`` (2, S), ``iteration`` and optionally
  ``fsc`` (K, n//2), ``c_distr`` (K,) the class fractions of the last
  global round and ``w_warm``, a dict class -> (2, mc^d..) converged
  C-balance weights of the last reconstruction,
- optionally the state a local round changes: ``imgs_ft`` and
  ``imgs_ft_ori`` (2, S, n, n) complex64 stacks, ``scale`` (G,) group
  scales, ``top_r_prev`` (N, 4) the previous round's top rotations in image
  order (the rotation-change statistics) and ``insert_offsets`` (2, K, 3).

A JAX optimiser ``o`` exports it as
``{"refs": np.asarray(o.refs), "sig": np.asarray(o.sig), "par": {k:
np.asarray(v) for k, v in o.par.items()}, "ladder":
dataclasses.asdict(o.ladder), ...}``; ``state_dict`` builds the same dict
from the port's optimiser.
"""

import dataclasses

import numpy as np
import torch

from .core.optimiser import LadderState

_PLANE = ("plane_index", "plane_valid", "groups_plane")


def load_state(opt, state):
    """Load ``state`` (see module docstring) into the port's optimiser
    ``opt`` (which must have had ``set_data`` called with the same images),
    on ``opt.device``."""
    dev = opt.device

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    for name in _PLANE:
        if name in state:
            setattr(opt, name, np.array(state[name]))
    opt.s_slots = opt.plane_index.shape[1]
    opt.refs = t(state["refs"], torch.float32)
    opt.sig = t(state["sig"], torch.float32)
    par = {}
    for k, v in state["par"].items():
        par[k] = t(v, torch.int32 if k == "c" else torch.float32)
    opt.par = par
    opt.ladder = LadderState(**state["ladder"])
    if "offsets" in state:
        opt.offsets = t(state["offsets"], torch.float32)
    if "scores" in state:
        opt.scores = t(state["scores"], torch.float32)
    opt.iteration = int(state.get("iteration", opt.iteration))
    if state.get("fsc") is not None:
        opt.fsc = np.array(state["fsc"])
    for name in ("imgs_ft", "imgs_ft_ori"):
        if name in state:
            setattr(opt, name, t(state[name], torch.complex64))
    if "scale" in state:
        opt.scale = np.array(state["scale"], np.float32)
    if state.get("top_r_prev") is not None:
        opt._top_r_prev = np.array(state["top_r_prev"])
    if state.get("insert_offsets") is not None:
        opt.insert_offsets = np.array(state["insert_offsets"], np.float32)
    if state.get("c_distr") is not None:
        opt.c_distr = np.array(state["c_distr"])
    if state.get("w_warm") is not None:
        opt._w_warm = {int(k): t(v, torch.float32)
                       for k, v in state["w_warm"].items()}
    opt._brick_cache = None
    return opt


def state_dict(opt):
    """The port optimiser's state in the same NumPy dict layout."""
    n = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x)
    out = {"refs": n(opt.refs), "sig": n(opt.sig),
           "par": {k: n(v) for k, v in opt.par.items()},
           "ladder": dataclasses.asdict(opt.ladder),
           "offsets": n(opt.offsets), "scores": n(opt.scores),
           "iteration": opt.iteration, "imgs_ft": n(opt.imgs_ft),
           "imgs_ft_ori": n(opt.imgs_ft_ori), "scale": n(opt.scale)}
    for name in _PLANE:
        out[name] = np.array(getattr(opt, name))
    for key, attr in (("fsc", "fsc"), ("top_r_prev", "_top_r_prev"),
                      ("insert_offsets", "insert_offsets"),
                      ("c_distr", "c_distr")):
        if getattr(opt, attr, None) is not None:
            out[key] = np.array(getattr(opt, attr))
    if getattr(opt, "_w_warm", None):
        out["w_warm"] = {k: n(v) for k, v in opt._w_warm.items()}
    return out
