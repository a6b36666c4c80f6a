"""Random draws of a refinement round, from one ``torch.Generator``.

The JAX package draws with ``jax.random`` inside every stage. The port's
stages take their draws as tensors instead, and the optimiser asks this
object for them, in the order the JAX optimiser consumes its keys. A
replacement with the same methods can replay any other stream (the parity
tests replay the JAX package's own keys through one).

Shapes: ``shape`` is the half-plane batch (2, S).
"""

import math

import torch

from ..geom.directional import VMS_PROPOSAL_ROUNDS


class Draws:
    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _randn(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _randint(self, high, *shape):
        return torch.randint(0, high, shape, generator=self.gen,
                             device=self.device)

    def scale_quats(self, shape):
        """Normals (2, S, 4) of the random rotations that the init-time
        intensity-scale re-balance projects at
        (``Optimiser.correct_scale(init=True)``)."""
        return self._randn(*shape, 4)

    def scale_angles(self, shape):
        """2D mode: the random in-plane angles (2, S) in [0, 2 pi) of the
        init-time scale re-balance."""
        return self._rand(*shape) * (2 * math.pi)

    def scan_grid(self, n_r, n_t):
        """Normals for the scan rotations (n_r, 4) and translations
        (n_t, 2)."""
        return self._randn(n_r, 4), self._randn(n_t, 2)

    def scan_grid_2d(self, n_r, n_t):
        """2D mode: uniforms (n_r,) in [0, 1) for the scan's in-plane
        angles and normals (n_t, 2) for its translations."""
        return self._rand(n_r), self._randn(n_t, 2)

    def scan_seed(self, iteration, shape, k):
        """Filter seeding: Gumbel noise (2, S, K) for the class draw and
        resample uniforms u0_r, u0_t (2, S)."""
        u = self._rand(*shape, k).clamp(min=1e-20)
        return -torch.log(-torch.log(u)), self._rand(*shape), \
            self._rand(*shape)

    def phase_draws(self, iteration, shape, n_r, n_t, mode="3d", n_d=0):
        """Callable phase -> dict of that phase's draws (see
        ``engine.local_search``); in 2D mode the von Mises sampler's
        uniforms replace the rotation normals and the anchor. A CTF-search
        round (``n_d`` > 0) also draws the defocus normals normals_d
        (2, S, nD) and resample uniforms u0_d (2, S), after the others."""
        def draw(phase):
            if mode == "2d":
                rounds = (*shape, VMS_PROPOSAL_ROUNDS, n_r)
                out = {"u_z": self._rand(*rounds),
                       "u_2": self._rand(*rounds).clamp(min=1e-12),
                       "u_s": self._rand(*shape, n_r),
                       "theta": self._rand(*shape, n_r) * (2 * math.pi),
                       "normals_t": self._randn(*shape, n_t, 2),
                       "u0_r": self._rand(*shape),
                       "u0_t": self._rand(*shape)}
            else:
                out = {"normals_r": self._randn(*shape, n_r, 4),
                       "normals_t": self._randn(*shape, n_t, 2),
                       "u0_r": self._rand(*shape), "u0_t": self._rand(*shape),
                       "anchor": self._randint(n_r, *shape)}
            if n_d:
                out["normals_d"] = self._randn(*shape, n_d)
                out["u0_d"] = self._rand(*shape)
            return out
        return draw

    def insert(self, iteration, shape, n_draw, n_r, n_t):
        """Support indices of the insert's pose draws, (2, S, n_draw)."""
        return (self._randint(n_r, *shape, n_draw),
                self._randint(n_t, *shape, n_draw))

    def fsc_phases(self, n):
        """Two uniform [0, 2 pi) phase fields (n, n, n) for the
        random-phase FSC correction (asked once per class)."""
        return (self._rand(n, n, n) * (2 * math.pi),
                self._rand(n, n, n) * (2 * math.pi))

    def phase_field(self, shape):
        """One uniform [0, 2 pi) phase field of a map's shape, for the
        random phases of a class that ``balance_class`` resigns (asked
        once per resigned class and half)."""
        return self._rand(*shape) * (2 * math.pi)


class RowDraws:
    """The per-image draws of ``draws`` cut to one rank's block: every
    rank of a multi-process run draws the global (2, S) batch from the same
    stream and keeps the planes ``planes`` (a slice of the half axis: its
    hemisphere on the (2, W/2) layout, both on (1, W)) and the rows
    ``rows`` (a slice of S), so each image takes the same draws whatever
    the layout. Draws that are not per image (the scan grid, the FSC phase
    fields, a resigned class's phases) pass through unchanged. ``draws``
    is any object with ``Draws``' methods."""

    def __init__(self, draws, rows, planes=slice(0, 2)):
        self.draws = draws
        self.rows = rows
        self.planes = planes

    def __getattr__(self, name):
        return getattr(self.draws, name)

    def _cut(self, x):
        return x[self.planes, self.rows]

    def scale_quats(self, shape):
        return self._cut(self.draws.scale_quats(shape))

    def scale_angles(self, shape):
        return self._cut(self.draws.scale_angles(shape))

    def scan_seed(self, iteration, shape, k):
        return tuple(map(self._cut, self.draws.scan_seed(iteration, shape,
                                                         k)))

    def phase_draws(self, iteration, shape, n_r, n_t, mode="3d", n_d=0):
        draw = self.draws.phase_draws(iteration, shape, n_r, n_t, mode=mode,
                                      n_d=n_d)
        return lambda phase: {k: self._cut(v)
                              for k, v in draw(phase).items()}

    def insert(self, iteration, shape, n_draw, n_r, n_t):
        return tuple(map(self._cut, self.draws.insert(iteration, shape,
                                                      n_draw, n_r, n_t)))
