"""Precision policy and device defaults.

Same policy as ``thunder_tpu.dtypes``: float32/complex64 for all image and
volume math. Entry points run on the GPU unless the caller
asks for another device (the tests pass ``device="cpu"``).
"""

import torch

real_dtype = torch.float32
complex_dtype = torch.complex64

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None):
    """``None`` -> the CUDA device; anything else -> ``torch.device``."""
    return torch.device(DEFAULT_DEVICE if device is None else device)

FSC_CUTOFF = 0.143  # the FSC threshold resolutions are reported at
