"""Batch result container and the aligned-pair batch runner
(``rapidfuzz_tpu.ops.dispatch`` counterpart).

JAX compiles a kernel per input shape, so its ``run_pairs`` goes through a
cache of jitted functions; PyTorch runs eagerly and needs none."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda import default_device


class BatchResult(NamedTuple):
    """Batch score result: ``values`` plus a ``valid`` mask.

    The mask is the batch equivalent of the reference's ``Option<T>``
    results under ``WithScoreCutoff`` (``src/common.rs:33-46``).
    """
    values: np.ndarray
    valid: np.ndarray

    def tolist(self):
        return [v if ok else None
                for v, ok in zip(self.values.tolist(), self.valid.tolist())]


def run_pairs(kernel, c1, l1, c2, l2, *, device=None, **static) -> np.ndarray:
    """Run a batched pair kernel (``ops.levenshtein``, ``ops.lcs``) on
    ``device`` (default: ``cuda``) over padded numpy batches; return
    numpy."""
    dev = torch.device(device) if device is not None else default_device()

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = kernel(put(c1), put(l1), put(c2), put(l2), **static)
    return out.cpu().numpy()
