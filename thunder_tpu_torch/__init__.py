"""thunder_tpu_torch — the PyTorch/CUDA port of thunder_tpu.

The layout mirrors ``thunder_tpu`` module for module (``config``,
``dtypes``, ``geom``, ``ops``, ``core``, ``parallel.engine``, ``io``,
``data``, ``utils``, ``cli``) so each function's counterpart is easy to
find; ``python -m thunder_tpu_torch.cli run config.json`` is the command
line (``--cpu`` runs it on the CPU). Inside, the code is PyTorch: plain
functions on tensors with an explicit ``device``; the two golden-standard
half-maps are a leading dimension of size 2 instead of a ``shard_map``
mesh axis, and every random draw is an explicit tensor argument.

The two Pallas kernels of the JAX package are hand-written CUDA C++ for
Hopper here (``csrc/``, built with nvcc on first use by ``cuda_build``):

- K1, the fused global-scan likelihood: ``ops.likelihood.scan_fused``,
- K2, the trilinear gridding insert: ``ops.insert.insert_update``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version only for CPU tensors. This package never imports ``jax``
or ``thunder_tpu``; only the parity tests import both.
"""

__version__ = "0.1.0"
