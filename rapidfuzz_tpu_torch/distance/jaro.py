"""Jaro similarity (the reference crate's ``src/distance/jaro.rs``).

Counterpart of ``rapidfuzz_tpu/distance/jaro.py``: an f64 metric with
``maximum = 1.0`` (``jaro.rs:602-605``), distance ``1.0 - similarity``,
normalized scores equal to the raw ones.  Scalar scores run on the host
oracle (the JAX package's in-process C route is ROADMAP.md queue 1, item
3).  Batch scores run on ``device`` (default ``cuda``): one query against
at least :data:`~._int_metric.SCAN_MIN` strings through the port's
``CorpusScanner`` and its Jaro kernel (K8), other batches through the
aligned-pair ``ops/jaro.jaro_components``.  Both return integer
(common, transposition) components, finished on the host in f64 by
:func:`sim_from_components`, so the results equal the scalar oracle's.
"""

from __future__ import annotations

import numpy as np

from .. import common as _c
from .. import oracle as _oracle
from ..ops import dispatch as _dispatch
from ..ops import jaro as _ops
from ..utils import codec as _codec
from . import _int_metric

__all__ = [
    "Args", "distance", "similarity", "normalized_distance",
    "normalized_similarity", "distance_with_args", "similarity_with_args",
    "normalized_distance_with_args", "normalized_similarity_with_args",
    "BatchComparator", "distance_many", "similarity_many",
    "normalized_distance_many", "normalized_similarity_many", "maximum",
    "sim_from_components",
]


class Args(_c.ArgsBase):
    __slots__ = ()


def maximum(len1=None, len2=None) -> float:
    return 1.0


def _sim_scalar(s1, s2) -> float:
    return _oracle.jaro(_codec.encode_one(s1), _codec.encode_one(s2))


def similarity(s1, s2, *, score_cutoff=None, score_hint=None):
    """Jaro similarity in [0, 1].

    >>> from rapidfuzz_tpu_torch.distance import jaro
    >>> round(jaro.similarity("martha", "marhta"), 4)
    0.9444
    """
    return _c.apply_similarity_cutoff(_sim_scalar(s1, s2), score_cutoff)


def distance(s1, s2, *, score_cutoff=None, score_hint=None):
    """Jaro distance, ``1.0 - similarity``."""
    return _c.apply_distance_cutoff(1.0 - _sim_scalar(s1, s2), score_cutoff)


def normalized_similarity(s1, s2, *, score_cutoff=None, score_hint=None):
    return similarity(s1, s2, score_cutoff=score_cutoff)


def normalized_distance(s1, s2, *, score_cutoff=None, score_hint=None):
    return distance(s1, s2, score_cutoff=score_cutoff)


def similarity_with_args(s1, s2, args: Args):
    return similarity(s1, s2, score_cutoff=args.cutoff)


def distance_with_args(s1, s2, args: Args):
    return distance(s1, s2, score_cutoff=args.cutoff)


normalized_similarity_with_args = similarity_with_args
normalized_distance_with_args = distance_with_args


def sim_from_components(common, trans, l1, l2) -> np.ndarray:
    """Exact f64 Jaro similarity from integer components (``jaro.rs:106-119``
    and the empty cases of ``jaro.rs:442-444``): the expression and its
    order of the JAX package's ``sim_from_components``, so the values
    agree to the bit."""
    common = np.asarray(common).astype(np.float64)
    t = (np.asarray(trans) // 2).astype(np.float64)
    l1 = np.asarray(l1).astype(np.float64)
    l2 = np.asarray(l2).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = (common / l1 + common / l2 + (common - t) / common) / 3.0
    sim = np.where(common == 0, 0.0, sim)
    sim = np.where((l1 == 0) & (l2 == 0), 1.0, sim)
    return sim


def pair_components(s1s, s2s, device=None):
    """Aligned-pair batch -> (codec output ``c1, l1, c2, l2``, common,
    transpositions), the components on ``device``."""
    c1, l1, c2, l2 = _codec.encode_pair_batch(s1s, s2s)
    common, trans = _dispatch.run_pairs(_ops.jaro_components, c1, l1, c2, l2,
                                        device=device)
    return (c1, l1, c2, l2), common, trans


def _sim_batch(s1s, s2s, device=None) -> np.ndarray:
    if len(s1s) == 1 and len(s2s) >= _int_metric.SCAN_MIN:
        # the corpus scan yields f64 distances 1 - sim, as the JAX
        # package's does (a sim below 0.5 may round one ulp differently
        # from the aligned-pair route there too)
        return 1.0 - _int_metric.scan_one_vs_many("jaro", s1s[0], s2s,
                                                  device=device)
    (_, l1, _, l2), common, trans = pair_components(s1s, s2s, device)
    B = common.shape[0]
    return sim_from_components(common, trans, np.broadcast_to(l1, (B,)),
                               np.broadcast_to(l2, (B,)))


def similarity_many(s1s, s2s, *, score_cutoff=None, device=None):
    return _dispatch.BatchResult(
        *_c.mask_similarity(_sim_batch(s1s, s2s, device), score_cutoff))


def distance_many(s1s, s2s, *, score_cutoff=None, device=None):
    return _dispatch.BatchResult(
        *_c.mask_distance(1.0 - _sim_batch(s1s, s2s, device), score_cutoff))


normalized_similarity_many = similarity_many
normalized_distance_many = distance_many


class BatchComparator:
    """One-vs-many comparator: the scalar scores against a fixed query,
    and batch scores over a corpus on ``device``."""

    def __init__(self, s1):
        self._u1 = _codec.encode_one(s1)

    def similarity(self, s2, **kw):
        return similarity(self._u1, s2, **kw)

    def distance(self, s2, **kw):
        return distance(self._u1, s2, **kw)

    normalized_similarity = similarity
    normalized_distance = distance

    def similarity_with_args(self, s2, args: Args):
        return similarity(self._u1, s2, score_cutoff=args.cutoff)

    def distance_with_args(self, s2, args: Args):
        return distance(self._u1, s2, score_cutoff=args.cutoff)

    normalized_similarity_with_args = similarity_with_args
    normalized_distance_with_args = distance_with_args

    def similarities(self, corpus, *, score_cutoff=None, device=None):
        return similarity_many([self._u1], corpus, score_cutoff=score_cutoff,
                               device=device)

    def distances(self, corpus, *, score_cutoff=None, device=None):
        return distance_many([self._u1], corpus, score_cutoff=score_cutoff,
                             device=device)

    # f64 metric: normalized == raw (maximum is 1.0)
    normalized_similarities = similarities
    normalized_distances = distances
