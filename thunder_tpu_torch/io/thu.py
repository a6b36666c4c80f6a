""".thu metadata table I/O (the port's own copy of ``thunder_tpu.io.thu``,
NumPy only).

The .thu file is a whitespace-separated text table, one row per particle,
27 columns (column indices: include/Database.h:22-282; manual:
docs/README.md:150-176). Column order:

 0 voltage            (V)
 1 defocusU           (Angstrom)
 2 defocusV           (Angstrom)
 3 defocusTheta       (rad)
 4 Cs                 (Angstrom)
 5 amplitudeContrast
 6 phaseShift         (rad)
 7 particlePath       (``i@stack.mrcs``, 1-based)
 8 micrographPath
 9 coordX
10 coordY
11 groupID            (int, 1-based)
12 classID            (int)
13-16 quaternion      (w, x, y, z)
17-19 k1, k2, k3      (rotation concentration / stddev params)
20-21 translationX/Y  (pixels)
22-23 stdTranslationX/Y
24 defocusFactor
25 stdDefocusFactor
26 score

Stored as a NumPy structured view: float matrix for numeric columns + object
arrays for the two path columns, preserving write format ``%18.9f``/``%6d``
(include/Database.h *_FORMAT macros) for byte-compatible interop with the
reference's GUI/scripts.
"""

from dataclasses import dataclass

import numpy as np

N_COLUMNS = 27

_INT_COLS = (11, 12)
_PATH_COLS = (7, 8)


class ThuColumns:
    VOLTAGE = 0
    DEFOCUS_U = 1
    DEFOCUS_V = 2
    DEFOCUS_THETA = 3
    CS = 4
    AMPLITUDE_CONTRAST = 5
    PHASE_SHIFT = 6
    PARTICLE_PATH = 7
    MICROGRAPH_PATH = 8
    COORDINATE_X = 9
    COORDINATE_Y = 10
    GROUP_ID = 11
    CLASS_ID = 12
    QUAT_0 = 13
    QUAT_1 = 14
    QUAT_2 = 15
    QUAT_3 = 16
    K1 = 17
    K2 = 18
    K3 = 19
    TRANSLATION_X = 20
    TRANSLATION_Y = 21
    STD_TRANSLATION_X = 22
    STD_TRANSLATION_Y = 23
    DEFOCUS_FACTOR = 24
    STD_DEFOCUS_FACTOR = 25
    SCORE = 26


@dataclass
class ThuTable:
    """Parsed .thu: ``values`` is (n, 27) float64 with NaN in path columns;
    ``particle_paths`` / ``micrograph_paths`` are lists of str."""

    values: np.ndarray
    particle_paths: list
    micrograph_paths: list

    def __len__(self):
        return self.values.shape[0]

    def col(self, idx):
        return self.values[:, idx]


def read_thu(path):
    values = []
    ppaths = []
    mpaths = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            if len(toks) < N_COLUMNS:
                raise ValueError(
                    f"bad .thu row: expected {N_COLUMNS} columns, got {len(toks)}"
                )
            row = np.full(N_COLUMNS, np.nan)
            for i in range(N_COLUMNS):
                if i in _PATH_COLS:
                    continue
                row[i] = float(toks[i])
            values.append(row)
            ppaths.append(toks[ThuColumns.PARTICLE_PATH])
            mpaths.append(toks[ThuColumns.MICROGRAPH_PATH])
    return ThuTable(
        values=np.asarray(values).reshape(-1, N_COLUMNS),
        particle_paths=ppaths,
        micrograph_paths=mpaths,
    )


def write_thu(path, table):
    with open(path, "w") as f:
        for r in range(len(table)):
            parts = []
            for i in range(N_COLUMNS):
                if i == ThuColumns.PARTICLE_PATH:
                    parts.append(table.particle_paths[r])
                elif i == ThuColumns.MICROGRAPH_PATH:
                    parts.append(table.micrograph_paths[r])
                elif i in _INT_COLS:
                    parts.append("%6d" % int(table.values[r, i]))
                else:
                    parts.append("%18.9f" % table.values[r, i])
            f.write(" ".join(parts) + "\n")


def make_table(n, particle_paths=None, micrograph_paths=None, **columns):
    """Build a ThuTable with sensible defaults (identity pose, zero
    translation, unit concentration params), overriding via keyword column
    names from ThuColumns (lowercase)."""
    values = np.zeros((n, N_COLUMNS))
    values[:, ThuColumns.VOLTAGE] = 300000.0
    values[:, ThuColumns.AMPLITUDE_CONTRAST] = 0.1
    values[:, ThuColumns.GROUP_ID] = 1
    values[:, ThuColumns.QUAT_0] = 1.0
    values[:, ThuColumns.K1] = 1.0
    values[:, ThuColumns.K2] = 1.0
    values[:, ThuColumns.K3] = 1.0
    values[:, ThuColumns.STD_TRANSLATION_X] = 1.0
    values[:, ThuColumns.STD_TRANSLATION_Y] = 1.0
    values[:, ThuColumns.DEFOCUS_FACTOR] = 1.0
    values[:, ThuColumns.SCORE] = 1.0
    for name, vals in columns.items():
        idx = getattr(ThuColumns, name.upper())
        values[:, idx] = vals
    return ThuTable(
        values=values,
        particle_paths=list(particle_paths) if particle_paths else ["0@none.mrcs"] * n,
        micrograph_paths=list(micrograph_paths) if micrograph_paths else ["none"] * n,
    )
