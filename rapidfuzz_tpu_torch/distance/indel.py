"""Indel distance (the reference crate's ``src/distance/indel.rs``).

Counterpart of ``rapidfuzz_tpu/distance/indel.py``: a reduction over LCS,
``maximum = len1 + len2`` and ``distance = maximum - 2 * lcs``
(``indel.rs:62-104``).  Scalar scores run on the host oracle; batch
scores on ``device`` (default ``cuda``): one query against at least
:data:`~._int_metric.SCAN_MIN` strings through the port's
``CorpusScanner`` and its LCS kernels, other batches through the
aligned-pair ``ops/lcs.lcs_similarity``.

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
    return l1 + l2


def _raw_distance(u1, u2):
    return _oracle.indel(u1, u2)


def _batch_distance(c1, l1, c2, l2, device=None):
    sim = _dispatch.run_pairs(_ops.lcs_similarity, c1, l1, c2, l2,
                              device=device)
    B = max(len(l1), len(l2))
    tot = (np.broadcast_to(l1, (B,)).astype(np.int64)
           + np.broadcast_to(l2, (B,)).astype(np.int64))
    return tot - 2 * sim.astype(np.int64)


METRIC = _int_metric.IntMetric("indel", _maximum, _raw_distance,
                               _batch_distance)
_int_metric.build_module(METRIC, globals())


def editops(s1, s2):
    """Insert/delete-only edit script from the LCS alignment: not ported
    yet."""
    raise _int_metric.editops_not_ported()


def editops_many(s1, choices):
    """Indel edit scripts from ``s1`` to every choice: not ported yet."""
    raise _int_metric.editops_not_ported()


def opcodes(s1, s2):
    """difflib-style grouped edit operations: not ported yet."""
    raise _int_metric.editops_not_ported()


__all__ += ["editops", "opcodes", "editops_many"]
