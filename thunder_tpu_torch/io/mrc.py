"""MRC image/volume/stack I/O (the port's own copy of
``thunder_tpu.io.mrc``, NumPy only).

Replaces the reference's ImageFile (include/Image/ImageFile.h:111-260,
include/Image/MRCHeader.h): reads modes 0 (int8), 1 (int16), 2 (float32),
6 (uint16); writes mode 2; supports the ``index@stack.mrcs`` addressing used
throughout .thu files (src/Optimiser.cpp:4646-4660) with per-slice reads so a
host only touches the bytes of its own shard.

Data layout: MRC stores column-fastest (x fastest); we return arrays indexed
``[z, y, x]`` (or ``[y, x]`` for 2D), C-order, float32.
"""

import struct
from dataclasses import dataclass

import numpy as np

_HEADER_SIZE = 1024

_MODE_DTYPES = {
    0: np.int8,
    1: np.int16,
    2: np.float32,
    6: np.uint16,
}


@dataclass
class MrcHeader:
    nx: int
    ny: int
    nz: int
    mode: int
    cella: tuple  # cell dimensions in angstroms (x, y, z)
    nsymbt: int = 0

    @property
    def voxel_size(self):
        if self.nx == 0:
            return 0.0
        return self.cella[0] / self.nx


def _parse_header(buf):
    if len(buf) < _HEADER_SIZE:
        raise ValueError(
            f"not an MRC file: header is {len(buf)} bytes, need {_HEADER_SIZE}"
        )
    nx, ny, nz, mode = struct.unpack_from("<4i", buf, 0)
    cella = struct.unpack_from("<3f", buf, 40)
    (nsymbt,) = struct.unpack_from("<i", buf, 92)
    if mode not in _MODE_DTYPES:
        raise ValueError(f"unsupported MRC mode {mode} (supported: 0, 1, 2, 6)")
    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError(f"invalid MRC dimensions ({nx}, {ny}, {nz})")
    return MrcHeader(nx=nx, ny=ny, nz=nz, mode=mode, cella=cella, nsymbt=nsymbt)


def read_header(path):
    with open(path, "rb") as f:
        return _parse_header(f.read(_HEADER_SIZE))


def read_mrc(path, return_header=False):
    """Read a whole MRC file. Returns float32 array [nz, ny, nx] (or [ny, nx]
    when nz == 1)."""
    with open(path, "rb") as f:
        hdr = _parse_header(f.read(_HEADER_SIZE))
        f.seek(_HEADER_SIZE + hdr.nsymbt)
        dtype = _MODE_DTYPES[hdr.mode]
        data = np.fromfile(f, dtype=dtype, count=hdr.nx * hdr.ny * hdr.nz)
    data = data.reshape(hdr.nz, hdr.ny, hdr.nx).astype(np.float32)
    if hdr.nz == 1:
        data = data[0]
    return (data, hdr) if return_header else data


def read_stack_slices(path, indices):
    """Read selected z-slices from an MRC stack without loading the rest.

    ``indices`` are 0-based slice numbers (the reference's ``i@stack`` syntax
    is 1-based in .thu files; callers convert). Returns [n, ny, nx] float32.
    """
    indices = np.asarray(indices, dtype=np.int64)
    with open(path, "rb") as f:
        hdr = _parse_header(f.read(_HEADER_SIZE))
        dtype = np.dtype(_MODE_DTYPES[hdr.mode])
        slice_bytes = hdr.nx * hdr.ny * dtype.itemsize
        base = _HEADER_SIZE + hdr.nsymbt
        out = np.empty((len(indices), hdr.ny, hdr.nx), dtype=np.float32)
        for k, idx in enumerate(indices):
            if not 0 <= idx < hdr.nz:
                raise IndexError(
                    f"slice {int(idx)} out of range for stack with {hdr.nz} slices"
                )
            f.seek(base + int(idx) * slice_bytes)
            raw = np.fromfile(f, dtype=dtype, count=hdr.nx * hdr.ny)
            out[k] = raw.reshape(hdr.ny, hdr.nx).astype(np.float32)
    return out


def parse_particle_path(path):
    """Split ``i@stack.mrcs`` into (slice_index_0based, filename); a bare path
    means slice 0. Reference syntax: src/Optimiser.cpp:4646-4660 (1-based)."""
    if "@" in path:
        idx, fn = path.split("@", 1)
        return int(idx) - 1, fn
    return 0, path


def write_mrc(path, data, voxel_size=1.0):
    """Write a float32 MRC (mode 2). data: [ny, nx], [nz, ny, nx] or a stack."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
    if data.ndim == 2:
        data = data[None]
    nz, ny, nx = data.shape
    hdr = bytearray(_HEADER_SIZE)
    struct.pack_into("<4i", hdr, 0, nx, ny, nz, 2)
    # mx, my, mz = sampling grid
    struct.pack_into("<3i", hdr, 28, nx, ny, nz)
    struct.pack_into(
        "<3f", hdr, 40, nx * voxel_size, ny * voxel_size, nz * voxel_size
    )
    struct.pack_into("<3f", hdr, 52, 90.0, 90.0, 90.0)  # cell angles
    struct.pack_into("<3i", hdr, 64, 1, 2, 3)  # axis order
    struct.pack_into(
        "<3f", hdr, 76, float(data.min()), float(data.max()), float(data.mean())
    )
    struct.pack_into("<i", hdr, 92, 0)  # nsymbt
    hdr[208:212] = b"MAP "
    hdr[212:216] = bytes([0x44, 0x41, 0x00, 0x00])  # little-endian machine stamp
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        data.tofile(f)
