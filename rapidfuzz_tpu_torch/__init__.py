"""rapidfuzz_tpu_torch — the PyTorch + CUDA port of ``rapidfuzz_tpu``.

The JAX package ``rapidfuzz_tpu`` stays the reference; this package
carries the same scans on PyTorch, with every TPU kernel on its path
rewritten by hand for Hopper (``csrc/*.cu``, built with ``nvcc`` at first
use, see :mod:`rapidfuzz_tpu_torch.ops.cuda`).  Module names follow the
JAX package so each counterpart is easy to find.

Submodules load lazily: importing the package pulls in neither torch's
CUDA state nor jax.
"""

from __future__ import annotations

import importlib
import os

__version__ = "0.1.0"

#: where the CUDA kernels and the C++ oracle are built at first use
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")

_LAZY = ("common", "distance", "fuzz", "parallel", "serve")


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
