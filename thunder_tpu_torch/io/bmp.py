"""Grayscale BMP writer (the port's own copy of ``thunder_tpu.io.bmp``,
NumPy only; replaces include/Image/BMP.h): 2D class averages and
central slices for quick inspection."""

import struct

import numpy as np


def write_bmp(path, img):
    """img: 2D float array -> 8-bit grayscale BMP (min..max scaled)."""
    img = np.asarray(img, dtype=np.float64)
    lo, hi = img.min(), img.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    data = ((img - lo) * scale).astype(np.uint8)
    h, w = data.shape
    row_size = (w + 3) & ~3
    pixel_bytes = row_size * h
    # BITMAPFILEHEADER + BITMAPINFOHEADER + 256-entry grayscale palette
    palette = b"".join(struct.pack("<4B", i, i, i, 0) for i in range(256))
    offset = 14 + 40 + len(palette)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", offset + pixel_bytes, 0, 0,
                            offset))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, pixel_bytes,
                            2835, 2835, 256, 0))
        f.write(palette)
        pad = b"\x00" * (row_size - w)
        for y in range(h - 1, -1, -1):  # BMP rows are bottom-up
            f.write(data[y].tobytes() + pad)
