"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files compile in ONE plain ``nvcc`` call into a shared
library with a C interface, loaded with ``ctypes`` (no PyTorch headers, no
``torch.utils.cpp_extension``, no ninja: a build takes seconds). The
library lands in ``build/torch_kernels/`` at the repository root, named by
a hash of the sources and flags, so a stale library is never loaded. The
build happens on first use, inside the call that first launches a kernel.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` as an int; ``check`` raises on
a non-zero code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argument types (all return int = cudaError_t)
SIGNATURES = {
    "thunder_global_scan": [_P] * 11 + [_I] * 5 + [_P],
    "thunder_insert_update": [_P, _I, _P, _P, _P, _P, _P, ctypes.c_longlong,
                              _P],
}

_LIB = None
build_seconds = None  # wall time of the last build in this process


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libthunder_kernels_{h.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile the kernels if the hashed library is missing; returns its
    path. One nvcc call over every .cu source."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", str(tmp)]
           + [str(s) for s in sorted(CSRC.glob("*.cu"))])
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr, flush=True)
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(code, what):
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream_ptr(device):
    """The raw handle of ``device``'s current stream (the call PyTorch's
    own Triton launcher makes: far cheaper than a Stream object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())
