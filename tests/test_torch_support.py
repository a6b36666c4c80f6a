"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py)
and tests of the helpers themselves.

- ``JaxDraws`` replays, for the port's optimiser, exactly the
  ``jax.random`` draws that ``thunder_tpu.core.optimiser`` makes, in the
  order it makes them (per-image keys folded from the global image index,
  ``plane_keys``), so a port round can follow the JAX round draw for draw.
- ``jax_state`` exports a JAX optimiser's state as the NumPy dict that
  ``thunder_tpu_torch.convert.load_state`` takes.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from thunder_tpu.parallel import engine as jengine

torch.set_num_threads(1)


def tt(x, dtype=None):
    """NumPy/JAX array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def nn(x):
    """torch tensor / JAX array -> NumPy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@partial(jax.jit, static_argnums=(1, 2, 3))
def per_image_draws(keys, n_r, n_t, n_d=0):
    """The draws of one particle-filter phase from (N, 2) phase keys, as
    ``engine.local_search`` consumes them (split into 7 sub-keys); with
    ``n_d`` > 0 (CTF search) also ``particle.perturb_d``'s normals (sub-key
    2) and the defocus resample uniform (sub-key 5)."""
    subs = jax.vmap(lambda k: jax.random.split(k, 7))(keys)
    f32 = jnp.float32
    out = {
        "normals_r": jax.vmap(lambda k: jax.random.normal(k, (n_r, 4), f32))(
            subs[:, 0]),
        "normals_t": jax.vmap(lambda k: jax.random.normal(k, (n_t, 2), f32))(
            subs[:, 1]),
        "u0_r": jax.vmap(lambda k: jax.random.uniform(k, (), f32))(subs[:, 3]),
        "u0_t": jax.vmap(lambda k: jax.random.uniform(k, (), f32))(subs[:, 4]),
        "anchor": jax.vmap(lambda k: jax.random.randint(k, (), 0, n_r))(
            subs[:, 6]),
    }
    if n_d:
        out["normals_d"] = jax.vmap(
            lambda k: jax.random.normal(k, (n_d,), f32))(subs[:, 2])
        out["u0_d"] = jax.vmap(lambda k: jax.random.uniform(k, (), f32))(
            subs[:, 5])
    return out


@partial(jax.jit, static_argnums=(1, 2))
def per_image_draws_2d(keys, n_r, n_t):
    """The 2D-mode draws of one phase from (N, 2) phase keys: the von
    Mises uniforms ``particle.perturb_r_2d`` draws from sub-key 0
    (``directional.sample_vms``: split into ku, kz, ks), then as in 3D."""
    from thunder_tpu.geom.directional import VMS_PROPOSAL_ROUNDS as rounds

    subs = jax.vmap(lambda k: jax.random.split(k, 7))(keys)
    kv = jax.vmap(lambda k: jax.random.split(k, 3))(subs[:, 0])
    f32 = jnp.float32
    uni = lambda shape, **kw: jax.vmap(
        lambda k: jax.random.uniform(k, shape, f32, **kw))
    return {
        "u_z": uni((rounds, n_r))(kv[:, 1]),
        "u_2": uni((rounds, n_r), minval=1e-12)(kv[:, 0]),
        "u_s": uni((n_r,))(kv[:, 2]),
        "theta": uni((n_r,), maxval=2 * jnp.pi)(kv[:, 1]),
        "normals_t": jax.vmap(lambda k: jax.random.normal(k, (n_t, 2), f32))(
            subs[:, 1]),
        "u0_r": uni(())(subs[:, 3]),
        "u0_t": uni(())(subs[:, 4]),
    }


@partial(jax.jit, static_argnums=(1, 2, 3))
def insert_draws(keys, n_draw, n_r, n_t):
    """Support indices of the insert draws from (N, 2) per-image keys."""
    k1 = jax.vmap(lambda k: jax.random.fold_in(k, 101))(keys)
    k2 = jax.vmap(lambda k: jax.random.fold_in(k, 102))(keys)
    ri = jax.vmap(lambda k: jax.random.randint(k, (n_draw,), 0, n_r))(k1)
    ti = jax.vmap(lambda k: jax.random.randint(k, (n_draw,), 0, n_t))(k2)
    return ri, ti


@partial(jax.jit, static_argnums=(1,))
def seed_draws(keys, k_cls):
    """Filter-seeding draws (Gumbel, u0_r, u0_t) from (N, 2) keys."""
    ky3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    f32 = jnp.float32
    g = jax.vmap(lambda k: jax.random.gumbel(k, (k_cls,), f32))(ky3[:, 0])
    u_r = jax.vmap(lambda k: jax.random.uniform(k, (), f32))(ky3[:, 1])
    u_t = jax.vmap(lambda k: jax.random.uniform(k, (), f32))(ky3[:, 2])
    return g, u_r, u_t


@jax.jit
def _phase_keys(keys, phase):
    return jax.vmap(jax.random.fold_in)(
        keys, jnp.full((keys.shape[0],), phase, jnp.uint32))


class JaxDraws:
    """Drop-in for ``thunder_tpu_torch.core.draws.Draws`` that replays the
    JAX optimiser's keys (seeded like ``Optimiser(para)`` with
    ``para.seed``)."""

    def __init__(self, seed, plane_index):
        self.key = jax.random.PRNGKey(seed)
        self.plane_index = np.asarray(plane_index)

    def _keys(self, iteration, salt):
        base = jax.random.fold_in(jax.random.fold_in(self.key, iteration),
                                  salt)
        return jengine.plane_keys(base, self.plane_index).reshape(-1, 2)

    def _plane(self, x, shape):
        return tt(x).reshape(tuple(shape) + tuple(np.shape(x)[1:]))

    def scale_quats(self, shape):
        # correct_scale(init=True) splits the optimiser key (quat.random_quat
        # of 2 S normals), which moves every later round's keys
        self.key, sub = jax.random.split(self.key)
        n = int(np.prod(shape))
        return tt(jax.random.normal(sub, (n, 4))).reshape(tuple(shape) + (4,))

    def scale_angles(self, shape):
        self.key, sub = jax.random.split(self.key)
        return tt(jax.random.uniform(sub, tuple(shape), minval=0.0,
                                     maxval=2 * np.pi))

    def scan_grid(self, n_r, n_t):
        self.key, kr, kt = jax.random.split(self.key, 3)
        return (tt(jax.random.normal(kr, (n_r, 4))),
                tt(jax.random.normal(kt, (n_t, 2))))

    def scan_grid_2d(self, n_r, n_t):
        self.key, kr, kt = jax.random.split(self.key, 3)
        return (tt(jax.random.uniform(kr, (n_r,))),
                tt(jax.random.normal(kt, (n_t, 2))))

    def scan_seed(self, iteration, shape, k):
        g, u_r, u_t = seed_draws(self._keys(iteration, 1), k)
        return (self._plane(g, shape), self._plane(u_r, shape),
                self._plane(u_t, shape))

    def phase_draws(self, iteration, shape, n_r, n_t, mode="3d", n_d=0):
        keys = self._keys(iteration, 2)

        def draw(phase):
            kph = _phase_keys(keys, phase)
            got = (per_image_draws_2d(kph, n_r, n_t) if mode == "2d"
                   else per_image_draws(kph, n_r, n_t, n_d))
            return {k: self._plane(v, shape) for k, v in got.items()}
        return draw

    def insert(self, iteration, shape, n_draw, n_r, n_t):
        ri, ti = insert_draws(self._keys(iteration, 3), n_draw, n_r, n_t)
        return self._plane(ri, shape), self._plane(ti, shape)

    def fsc_phases(self, n):
        self.key, ka, kb = jax.random.split(self.key, 3)
        u = lambda k: tt(jax.random.uniform(k, (n, n, n), minval=0.0,
                                            maxval=2 * jnp.pi,
                                            dtype=jnp.float32))
        return u(ka), u(kb)

    def phase_field(self, shape):
        # balance_class: one split per resigned class and half, then
        # spectrum.random_phase's uniform field
        self.key, sub = jax.random.split(self.key)
        return tt(jax.random.uniform(sub, tuple(shape), minval=0.0,
                                     maxval=2 * jnp.pi, dtype=jnp.float32))


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def run_ranks_on_a_port(argvs, make_envs, logdir, timeout, tries=2):
    """``run_ranks`` with the environments ``make_envs(port)`` of a port
    that was free a moment ago. Another process can take the port before
    rank 0 listens on it; rank 0 then fails at once ("Address already in
    use") and the launch is made again on a new port, ``tries`` times in
    all."""
    for attempt in range(tries):
        try:
            return run_ranks(argvs, make_envs(free_port()), logdir, timeout)
        except AssertionError as e:
            if ("address already in use" not in str(e).lower()
                    or attempt == tries - 1):
                raise


def run_ranks(argvs, envs, logdir, timeout):
    """Start one process per argv (with its env), wait for all of them
    under ``timeout`` seconds, and kill the others as soon as one exits
    non-zero or the time is up. Each process's output goes to a file in
    ``logdir``. Returns the outputs; raises with them on a failure."""
    import os
    import subprocess
    import time

    logs = [os.path.join(logdir, f"rank_{i}.log") for i in range(len(argvs))]
    procs = []
    for argv, env, log in zip(argvs, envs, logs):
        with open(log, "wb") as f:
            procs.append(subprocess.Popen(argv, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > end:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        with open(log, errors="replace") as f:
            outs.append(f.read())
    codes = [p.returncode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
            f"--- rank {i}:\n{o[-3000:]}" for i, o in enumerate(outs)))
    return outs


def rank_env(**extra):
    """This process's environment without any launch variables, one
    thread a process, the repository on the path, plus ``extra``."""
    import os

    drop = {"RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
            "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"}
    env = {k: v for k, v in os.environ.items() if k not in drop}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def jax_state(opt):
    """A JAX optimiser's state as the dict ``convert.load_state`` takes."""
    out = {"refs": np.asarray(opt.refs), "sig": np.asarray(opt.sig),
           "par": {k: np.asarray(v) for k, v in opt.par.items()},
           "ladder": dataclasses.asdict(opt.ladder),
           "plane_index": np.asarray(opt.plane_index),
           "plane_valid": np.asarray(opt.plane_valid),
           "groups_plane": np.asarray(opt.groups_plane),
           "offsets": np.asarray(opt.offsets),
           "scores": np.asarray(opt.scores), "iteration": opt.iteration,
           "imgs_ft": np.asarray(opt.imgs_ft),
           "imgs_ft_ori": np.asarray(opt.imgs_ft_ori),
           "scale": np.asarray(opt.scale)}
    for key, attr in (("fsc", "fsc"), ("top_r_prev", "_top_r_prev"),
                      ("insert_offsets", "insert_offsets"),
                      ("c_distr", "c_distr")):
        if getattr(opt, attr, None) is not None:
            out[key] = np.asarray(getattr(opt, attr))
    if getattr(opt, "_w_warm", None):
        out["w_warm"] = {k: np.asarray(v) for k, v in opt._w_warm.items()}
    return out


def test_jax_draws_match_the_optimiser_keys():
    """The replayed scan grid equals the JAX optimiser's own draw."""
    from thunder_tpu.core import sampling
    from thunder_tpu.geom import quat

    d = JaxDraws(3, np.arange(8).reshape(2, 4))
    rn, tn = d.scan_grid(16, 30)
    _, kr, kt = jax.random.split(jax.random.PRNGKey(3), 3)
    # equal draws; the normalisation may round 1 ulp apart
    np.testing.assert_allclose(
        nn(rn / torch.linalg.vector_norm(rn, dim=-1, keepdim=True)),
        np.asarray(quat.random_quat(kr, 16)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        nn(2.0 * tn)[1:], np.asarray(sampling.sample_translations(
            kt, 30, 2.0))[1:], rtol=1e-6)


def test_jax_draws_shapes():
    d = JaxDraws(0, np.arange(6).reshape(2, 3))
    g, u_r, u_t = d.scan_seed(0, (2, 3), 2)
    assert g.shape == (2, 3, 2) and u_r.shape == (2, 3)
    dr = d.phase_draws(0, (2, 3), 5, 4)(1)
    assert dr["normals_r"].shape == (2, 3, 5, 4)
    assert dr["anchor"].shape == (2, 3) and int(dr["anchor"].max()) < 5
    ri, ti = d.insert(0, (2, 3), 7, 5, 4)
    assert ri.shape == (2, 3, 7) and int(ti.max()) < 4
