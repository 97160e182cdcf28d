"""Unrestricted Damerau-Levenshtein distance (the reference crate's
``src/distance/damerau_levenshtein.rs``): Levenshtein plus transpositions
of adjacent chars, with edits between them allowed.

Counterpart of ``rapidfuzz_tpu/distance/damerau_levenshtein.py``:
``maximum = max(len1, len2)`` (``damerau_levenshtein.rs:193-195``).
Scalar scores run on the host oracle; batch scores on ``device``
(default ``cuda``): one query against at least
:data:`~._int_metric.SCAN_MIN` strings through the port's
``CorpusScanner`` and its Damerau kernel (K9), other batches through the
aligned-pair ``ops/damerau.damerau_distance``.
"""

from __future__ import annotations

import numpy as np

from .. import oracle as _oracle
from ..ops import damerau as _ops
from ..ops import dispatch as _dispatch
from . import _int_metric


def _maximum(l1, l2):
    return np.maximum(l1, l2) if isinstance(l1, np.ndarray) else max(l1, l2)


def _raw_distance(u1, u2):
    return _oracle.damerau(u1, u2)


def _batch_distance(c1, l1, c2, l2, device=None):
    return _dispatch.run_pairs(_ops.damerau_distance, c1, l1, c2, l2,
                               device=device)


METRIC = _int_metric.IntMetric("damerau_levenshtein", _maximum,
                               _raw_distance, _batch_distance)
_int_metric.build_module(METRIC, globals())
