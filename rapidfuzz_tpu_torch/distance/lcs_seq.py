"""Longest common subsequence (the reference crate's
``src/distance/lcs_seq.rs``).

Counterpart of ``rapidfuzz_tpu/distance/lcs_seq.py``:
``maximum = max(len1, len2)`` (``lcs_seq.rs:549-551``); the primitive is
the similarity (LCS length) and the distance is ``maximum - similarity``.
Scalar scores run on the host oracle; batch scores on ``device`` (default
``cuda``): one query against at least :data:`~._int_metric.SCAN_MIN`
strings through the port's ``CorpusScanner`` and its LCS kernels, other
batches through the aligned-pair ``ops/lcs.lcs_similarity``.

Not ported yet: ``editops``/``opcodes``/``editops_many``, which raise
``NotImplementedError`` (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import numpy as np

from .. import oracle as _oracle
from ..ops import dispatch as _dispatch
from ..ops import lcs as _ops
from . import _int_metric


def _maximum(l1, l2):
    return np.maximum(l1, l2) if isinstance(l1, np.ndarray) else max(l1, l2)


def _raw_distance(u1, u2):
    return max(u1.size, u2.size) - _oracle.lcs_seq(u1, u2)


def similarity_batch_raw(c1, l1, c2, l2, device=None):
    """Raw LCS lengths of pre-encoded aligned-pair batches on ``device``
    (used by indel and fuzz)."""
    return _dispatch.run_pairs(_ops.lcs_similarity, c1, l1, c2, l2,
                               device=device)


def _batch_distance(c1, l1, c2, l2, device=None):
    sim = similarity_batch_raw(c1, l1, c2, l2, device)
    B = max(len(l1), len(l2))
    mx = np.maximum(np.broadcast_to(l1, (B,)), np.broadcast_to(l2, (B,)))
    return mx.astype(np.int64) - sim.astype(np.int64)


METRIC = _int_metric.IntMetric("lcs_seq", _maximum, _raw_distance,
                               _batch_distance)
_int_metric.build_module(METRIC, globals())


def editops(s1, s2):
    """Insert/delete-only edit script from the LCS alignment: not ported
    yet."""
    raise _int_metric.editops_not_ported()


def editops_many(s1, choices):
    """LCS edit scripts from ``s1`` to every choice: not ported yet."""
    raise _int_metric.editops_not_ported()


def opcodes(s1, s2):
    """difflib-style grouped edit operations: not ported yet."""
    raise _int_metric.editops_not_ported()


__all__ += ["editops", "opcodes", "editops_many"]
