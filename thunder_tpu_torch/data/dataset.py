"""Particle dataset: a .thu table + its MRC stacks (port of
``thunder_tpu.data.dataset``; the reference's Database + per-rank image
loading, src/Database.cpp:207-645, src/Optimiser.cpp:4608-4660).

The golden-standard split is the JAX package's seeded permutation: its
second half (``permutation[n // 2:]``) is hemisphere B. Stack slices are
read per file, a slice at a time, with ``Path of Particles`` joined in
front of each stack name.
"""

import os
from collections import defaultdict

import numpy as np

from ..io import mrc
from ..io.thu import ThuColumns, read_thu


class ParticleDataset:
    def __init__(self, thu_path, particle_prefix="", seed=0):
        self.table = read_thu(thu_path)
        self.prefix = particle_prefix
        self.n = len(self.table)
        self.permutation = np.random.default_rng(seed).permutation(self.n)
        self.halves = np.zeros(self.n, np.int32)
        self.halves[self.permutation[self.n // 2:]] = 1

    @property
    def group_ids(self):
        """0-based group ids (the .thu column is 1-based)."""
        g = self.table.col(ThuColumns.GROUP_ID).astype(np.int32)
        return np.maximum(g - 1, 0)

    def ctf_params(self):
        """The CTF columns as the (N,) float32 arrays ``set_data`` takes."""
        t = self.table
        cols = {"voltage": ThuColumns.VOLTAGE,
                "defocus_u": ThuColumns.DEFOCUS_U,
                "defocus_v": ThuColumns.DEFOCUS_V,
                "defocus_theta": ThuColumns.DEFOCUS_THETA,
                "cs": ThuColumns.CS,
                "amp_contrast": ThuColumns.AMPLITUDE_CONTRAST,
                "phase_shift": ThuColumns.PHASE_SHIFT}
        return {k: t.col(c).astype(np.float32) for k, c in cols.items()}

    def poses(self):
        """(quat (N, 4), trans (N, 2), defocus factor (N,), class (N,))."""
        v = self.table.values
        q = v[:, ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1]
        tr = v[:, ThuColumns.TRANSLATION_X:ThuColumns.TRANSLATION_Y + 1]
        return (q.astype(np.float32), tr.astype(np.float32),
                self.table.col(ThuColumns.DEFOCUS_FACTOR).astype(np.float32),
                self.table.col(ThuColumns.CLASS_ID).astype(np.int32))

    def load_images(self, indices=None):
        """The images of ``indices`` (default all), (len, n, n) float32,
        read per stack file."""
        if indices is None:
            indices = np.arange(self.n)
        by_file = defaultdict(list)
        for pos, i in enumerate(indices):
            slice_idx, fname = mrc.parse_particle_path(
                self.table.particle_paths[i])
            by_file[fname].append((pos, slice_idx))
        out = None
        for fname, items in by_file.items():
            path = os.path.join(self.prefix, fname) if self.prefix else fname
            slices = mrc.read_stack_slices(path, [s for _, s in items])
            if out is None:
                out = np.empty((len(indices),) + slices.shape[1:], np.float32)
            for (pos, _), img in zip(items, slices):
                out[pos] = img
        return out
