"""Port parity: the golden FSC of an icosahedral reconstruction past its
insert band.

Under I symmetry, with the halves' FSC near 1 out to the insert band r_u,
the golden-standard FSC reads on past r_u. Both packages compute the same
out-of-band values from the same state: they are not noise but a leakage of
the in-band maps that both halves share (the plain FSC of the unmasked half
maps reads high there too). So a round's FSC-0.143 shell can lie past its
band, and chip_smoke.py's path E also holds each round's half map against
the phantom.

``python tests/test_torch_sym_fsc.py`` prints both packages' curves.
"""

import dataclasses

import numpy as np
import torch

import chip_smoke as cs
from thunder_tpu.config import Para as JPara
from thunder_tpu.core.optimiser import Optimiser as JOptimiser
from thunder_tpu.parallel.mesh import make_mesh
from thunder_tpu_torch import convert
from thunder_tpu_torch.config import Para
from thunder_tpu_torch.core.optimiser import Optimiser
from thunder_tpu_torch.ops import fft as fft_ops
from thunder_tpu_torch.ops import spectrum

from test_torch_support import JaxDraws, jax_state

torch.set_num_threads(1)

N, B, NOISE = 48, 128, 0.02


def _i_reconstructions():
    """One I-symmetric phantom (``chip_smoke.sym_phantom``), B images at
    known poses, and one reconstruction in each package from the same
    state and draws. Returns (JAX golden FSC, the port's, the port's plain
    FSC of the unmasked half maps, r_u)."""
    dev = torch.device("cpu")
    rng = np.random.default_rng(3)
    vol = cs.sym_phantom(dev, N, rng, "I")
    stack, q, cp = cs.project_stack(dev, vol, B, rng, NOISE)
    para = Para(mode="3d", k=1, size=N, pixel_size=1.32,
                mask_radius=N * 1.32 / 2.2, trans_s=2.0, init_res=6.5,
                global_search_res=3.4, sym="I", m_s=400, m_l_r=64, m_l_t=9,
                m_reco=8, l_search=True, pf=2, seed=5,
                save_ref_each_iter=False, save_thu_each_iter=False)
    jo = JOptimiser(JPara(**dataclasses.asdict(para)),
                    mesh=make_mesh(n_devices=1))
    jo.set_data(stack, cp)
    jo.init_reference(vol=vol)
    jo.init_sigma()
    jo.load_poses(q, np.zeros((B, 2), np.float32))
    state, key = jax_state(jo), jo.key
    jo.reconstruct()
    opt = Optimiser(para, device="cpu")
    opt.set_data(stack, cp)
    opt.init_reference(vol=vol)
    opt.init_sigma()
    opt = convert.load_state(opt, state)
    opt.draws = JaxDraws(para.seed, state["plane_index"])
    opt.draws.key = key
    r_u = opt.ladder.r_u
    opt.reconstruct()
    half_a, half_b = (fft_ops.fft3_center(v) for v in opt.half_maps[0])
    plain = spectrum.frc_fsc(half_a, half_b, N // 2, 3).numpy()
    return np.asarray(jo.fsc)[0], np.asarray(opt.fsc)[0], plain, r_u


def test_golden_fsc_past_the_band_matches():
    """The same golden FSC at every shell, out-of-band included, and in
    both packages values past r_u above 0.143 that the unmasked halves
    share as well."""
    f_j, f_t, plain, r_u = _i_reconstructions()
    assert f_j.shape == f_t.shape == (N // 2,)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=1e-3)
    past = int(np.ceil(r_u)) + 1
    assert past < N // 2
    assert f_j[past:].max() > 0.143 and f_t[past:].max() > 0.143
    assert plain[past:].max() > 0.143


if __name__ == "__main__":
    f_j, f_t, plain, r_u = _i_reconstructions()
    np.set_printoptions(precision=4, linewidth=120, suppress=True)
    print(f"r_u {r_u}")
    print("JAX golden FSC ", f_j)
    print("port golden FSC", f_t)
    print("port unmasked  ", plain)
    print("max |port - JAX|", float(np.abs(f_t - f_j).max()))
