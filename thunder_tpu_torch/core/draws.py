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

    def scan_grid(self, n_r, n_t):
        """Normals for the scan rotations (n_r, 4) and translations
        (n_t, 2)."""
        return self._randn(n_r, 4), self._randn(n_t, 2)

    def scan_seed(self, iteration, shape, k):
        """Filter seeding: Gumbel noise (2, S, K) for the class draw and
        resample uniforms u0_r, u0_t (2, S)."""
        u = self._rand(*shape, k).clamp(min=1e-20)
        return -torch.log(-torch.log(u)), self._rand(*shape), \
            self._rand(*shape)

    def phase_draws(self, iteration, shape, n_r, n_t):
        """Callable phase -> dict of that phase's draws (see
        ``engine.local_search``)."""
        def draw(phase):
            return {"normals_r": self._randn(*shape, n_r, 4),
                    "normals_t": self._randn(*shape, n_t, 2),
                    "u0_r": self._rand(*shape), "u0_t": self._rand(*shape),
                    "anchor": self._randint(n_r, *shape)}
        return draw

    def insert(self, iteration, shape, n_draw, n_r, n_t):
        """Support indices of the insert's pose draws, (2, S, n_draw)."""
        return (self._randint(n_r, *shape, n_draw),
                self._randint(n_t, *shape, n_draw))

    def fsc_phases(self, n):
        """Two uniform [0, 2 pi) phase fields (n, n, n) for the
        random-phase FSC correction."""
        return (self._rand(n, n, n) * (2 * math.pi),
                self._rand(n, n, n) * (2 * math.pi))
