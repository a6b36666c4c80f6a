"""RELION STAR <-> .thu interop (the port's own copy of
``thunder_tpu.io.star``, NumPy only; script/STAR_2_THU.py and
script/THU_2_STAR.py).

STAR -> THU maps the CTF columns (voltage kV -> V, defocus angle deg ->
rad, Cs mm -> angstrom, phase shift deg -> rad), group, coordinates and
paths; pose columns start at zero. THU -> STAR writes the CTF columns and
RELION-convention Euler angles of the pose quaternion.
"""

import math
import re

import numpy as np

from .thu import ThuColumns, ThuTable, make_table, read_thu, write_thu


def read_star(path):
    """Parse a RELION data STAR file: returns (columns: {name: index},
    rows: list of token lists). Names are lowercased without the _rln
    prefix."""
    header = {}
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#") or s == "loop_" \
                    or s.startswith("data_"):
                continue
            m = re.match(r"_rln(\w+)\s+#(\d+)", s)
            if m:
                header[m.group(1).lower()] = int(m.group(2)) - 1
                continue
            if s.startswith("_"):
                continue
            toks = s.split()
            if header and len(toks) >= len(header):
                rows.append(toks)
    return header, rows


def star_to_thu(star_path, thu_path):
    """Convert a STAR file to a .thu table, write it to ``thu_path`` and
    return it. Rows missing a CTF column or the image name are skipped."""
    header, rows = read_star(star_path)

    def get(toks, name, default=None, conv=float):
        if name in header:
            try:
                return conv(toks[header[name]])
            except (ValueError, IndexError):
                return default
        return default

    v = make_table(len(rows)).values
    ppaths, mpaths, keep = [], [], []
    for i, toks in enumerate(rows):
        volt = get(toks, "voltage")
        du = get(toks, "defocusu")
        dv = get(toks, "defocusv")
        dt = get(toks, "defocusangle")
        cs = get(toks, "sphericalaberration")
        ac = get(toks, "amplitudecontrast")
        img = get(toks, "imagename", conv=str)
        if None in (volt, du, dv, dt, cs, ac, img):
            continue
        keep.append(i)
        v[i, ThuColumns.VOLTAGE] = volt * 1000.0
        v[i, ThuColumns.DEFOCUS_U] = du
        v[i, ThuColumns.DEFOCUS_V] = dv
        v[i, ThuColumns.DEFOCUS_THETA] = math.radians(dt)
        v[i, ThuColumns.CS] = cs * 1e7
        v[i, ThuColumns.AMPLITUDE_CONTRAST] = ac
        v[i, ThuColumns.PHASE_SHIFT] = math.radians(
            get(toks, "phaseshift", 0.0) or 0.0)
        v[i, ThuColumns.GROUP_ID] = get(toks, "groupnumber", 1, int) or 1
        v[i, ThuColumns.COORDINATE_X] = get(toks, "coordinatex", 0.0) or 0.0
        v[i, ThuColumns.COORDINATE_Y] = get(toks, "coordinatey", 0.0) or 0.0
        ppaths.append(img)
        mpaths.append(get(toks, "micrographname", "none", str) or "none")
    out = ThuTable(values=v[keep], particle_paths=ppaths,
                   micrograph_paths=mpaths)
    write_thu(thu_path, out)
    return out


_STAR_HEADER = """
data_

loop_
_rlnVoltage #1
_rlnDefocusU #2
_rlnDefocusV #3
_rlnDefocusAngle #4
_rlnSphericalAberration #5
_rlnAmplitudeContrast #6
_rlnPhaseShift #7
_rlnImageName #8
_rlnMicrographName #9
_rlnCoordinateX #10
_rlnCoordinateY #11
_rlnGroupNumber #12
_rlnClassNumber #13
_rlnAngleRot #14
_rlnAngleTilt #15
_rlnAnglePsi #16
_rlnOriginX #17
_rlnOriginY #18
""".lstrip()


def _quat_to_relion_euler(q):
    """Quaternion -> RELION (rot, tilt, psi) degrees: ZYZ Euler angles of
    the TRANSPOSED rotation matrix (script/THU_2_STAR.py:50-92)."""
    w, x, y, z = q
    a = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0.0]])
    mat = (np.eye(3) + 2 * w * a + 2 * a @ a).T
    eps = 1.19209e-7
    sb = math.sqrt(max(0.0, 1 - mat[2, 2] ** 2))
    if sb > eps:
        beta = math.atan2(sb, mat[2, 2])
        alpha = math.atan2(mat[2, 1] / sb, mat[2, 0] / sb)
        gamma = math.atan2(mat[1, 2] / sb, -mat[0, 2] / sb)
    else:
        alpha = 0.0
        beta = 0.0
        gamma = math.atan2(mat[1, 0], mat[0, 0])
    return math.degrees(alpha), math.degrees(beta), math.degrees(gamma)


def thu_to_star(thu_path, star_path):
    """Write the .thu table at ``thu_path`` as a RELION STAR file."""
    table = read_thu(thu_path)
    with open(star_path, "w") as f:
        f.write(_STAR_HEADER)
        for i in range(len(table)):
            v = table.values[i]
            rot, tilt, psi = _quat_to_relion_euler(
                v[ThuColumns.QUAT_0:ThuColumns.QUAT_3 + 1])
            f.write(" ".join([
                "%.6f" % (v[ThuColumns.VOLTAGE] / 1000.0),
                "%.6f" % v[ThuColumns.DEFOCUS_U],
                "%.6f" % v[ThuColumns.DEFOCUS_V],
                "%.6f" % math.degrees(v[ThuColumns.DEFOCUS_THETA]),
                "%.6f" % (v[ThuColumns.CS] / 1e7),
                "%.6f" % v[ThuColumns.AMPLITUDE_CONTRAST],
                "%.6f" % math.degrees(v[ThuColumns.PHASE_SHIFT]),
                table.particle_paths[i],
                table.micrograph_paths[i],
                "%.6f" % v[ThuColumns.COORDINATE_X],
                "%.6f" % v[ThuColumns.COORDINATE_Y],
                "%d" % int(v[ThuColumns.GROUP_ID]),
                "%d" % int(v[ThuColumns.CLASS_ID]),
                "%.6f" % rot, "%.6f" % tilt, "%.6f" % psi,
                "%.6f" % -v[ThuColumns.TRANSLATION_X],
                "%.6f" % -v[ThuColumns.TRANSLATION_Y],
            ]) + "\n")
