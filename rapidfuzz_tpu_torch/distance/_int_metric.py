"""Factory for integer-valued metric modules.

Counterpart of ``rapidfuzz_tpu/distance/_int_metric.py``.  Every reference
metric module exposes the same 10-function surface (SURVEY.md §2.2); this
builds it from three ingredients: ``maximum``, a scalar raw-distance
function (host oracle) and a batched raw-distance function (aligned-pair
PyTorch ops), with the cutoff algebra of ``common.py``.  One-vs-many
batches of at least :data:`SCAN_MIN` strings go through the port's
:class:`~rapidfuzz_tpu_torch.parallel.CorpusScanner` and its kernels.

Not ported: the JAX package's in-process C scalar route
(``native/rf_scalar.cpp``), a latency item; scalar calls take the host
oracle and return the same values.  Batch entry points take a ``device``
keyword (default ``cuda``), as PyTorch functions do.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .. import common as _c
from ..ops import dispatch as _dispatch
from ..utils import codec as _codec

#: one-vs-many batches at least this large route through a corpus scan
#: (the JAX package's threshold); smaller ones run the aligned-pair ops
SCAN_MIN = 4096
#: metrics the port's CorpusScanner serves with identical semantics
_SCANNABLE = frozenset({"levenshtein", "indel", "lcs_seq", "osa", "jaro",
                        "jaro_winkler", "damerau_levenshtein"})


def scan_one_vs_many(name: str, q, corpus, weights=None, device=None,
                     score_cutoff=None, prefix_weight: float = 0.1):
    """One-vs-many distances via a one-off CorpusScanner on ``device``, or
    None for a metric the scanner does not serve: int64, or f64 for the
    Jaro family (``1.0 - similarity``, ``prefix_weight`` for
    Jaro-Winkler).

    ``score_cutoff`` (a distance bound) routes the scanner's banded
    kernels; entries above it come back with some value above the cutoff
    (callers re-apply the same mask)."""
    if name not in _SCANNABLE:
        return None
    from ..parallel.scan import F64_METRICS, CorpusScanner
    sc = CorpusScanner(list(corpus), metric=name, weights=weights,
                       device=device, prefix_weight=prefix_weight)
    res = sc.distances(q, score_cutoff=score_cutoff)
    if score_cutoff is not None:
        res = res.values                       # masks re-applied upstream
    return np.asarray(res, np.float64 if name in F64_METRICS else np.int64)


def editops_not_ported() -> NotImplementedError:
    """The error every ``editops``/``opcodes``/``editops_many`` of the
    port raises until the recording scans are ported."""
    return NotImplementedError(
        "editops/opcodes are not ported yet (ROADMAP.md queue 1, item 13)")


class IntMetric:
    """Bundle of the derived API functions for one integer metric.

    ``batch_distance(c1, l1, c2, l2, device)`` runs padded aligned-pair
    batches on ``device``.
    """

    def __init__(self, name: str,
                 maximum: Callable[[int, int], int],
                 raw_distance: Callable[[np.ndarray, np.ndarray], int],
                 batch_distance: Callable[..., np.ndarray]):
        self.name = name
        self.maximum = maximum
        self.raw_distance = raw_distance
        self.batch_distance = batch_distance

    # ------------------------------------------------------------- scalar
    def _scalar(self, s1, s2):
        u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
        mx = self.maximum(u1.size, u2.size)
        if _c.scalar_backend() == "device":
            c1, l1, c2, l2 = _codec.encode_pair_batch([u1], [u2])
            return int(np.asarray(self.batch_distance(c1, l1, c2, l2,
                                                      None))[0]), mx
        return self.raw_distance(u1, u2), mx

    def distance(self, s1, s2, *, score_cutoff=None, score_hint=None):
        dist, _ = self._scalar(s1, s2)
        return _c.apply_distance_cutoff(dist, score_cutoff)

    def similarity(self, s1, s2, *, score_cutoff=None, score_hint=None):
        dist, mx = self._scalar(s1, s2)
        return _c.apply_similarity_cutoff(mx - dist, score_cutoff)

    def normalized_distance(self, s1, s2, *, score_cutoff=None,
                            score_hint=None):
        dist, mx = self._scalar(s1, s2)
        return _c.apply_distance_cutoff(_c.norm_dist_from_dist(dist, mx),
                                        score_cutoff)

    def normalized_similarity(self, s1, s2, *, score_cutoff=None,
                              score_hint=None):
        dist, mx = self._scalar(s1, s2)
        return _c.apply_similarity_cutoff(
            1.0 - _c.norm_dist_from_dist(dist, mx), score_cutoff)

    # -------------------------------------------------------------- batch
    def _batch_raw(self, s1s, s2s, device=None):
        if len(s1s) == 1 and len(s2s) >= SCAN_MIN:
            d = scan_one_vs_many(self.name, s1s[0], s2s, device=device)
            if d is not None:
                l2 = np.array([_codec.encode_one(s).size for s in s2s],
                              np.int64)
                l1 = np.full_like(l2, _codec.encode_one(s1s[0]).size)
                return d, self.maximum(l1, l2)
        c1, l1, c2, l2 = _codec.encode_pair_batch(s1s, s2s)
        dist = self.batch_distance(c1, l1, c2, l2, device)
        B = max(len(l1), len(l2))
        l1b = np.broadcast_to(l1, (B,)).astype(np.int64)
        l2b = np.broadcast_to(l2, (B,)).astype(np.int64)
        return np.asarray(dist, np.int64), self.maximum(l1b, l2b)

    def distance_many(self, s1s, s2s, *, score_cutoff=None, device=None):
        dist, _ = self._batch_raw(s1s, s2s, device)
        return _dispatch.BatchResult(*_c.mask_distance(dist, score_cutoff))

    def similarity_many(self, s1s, s2s, *, score_cutoff=None, device=None):
        dist, mx = self._batch_raw(s1s, s2s, device)
        return _dispatch.BatchResult(*_c.mask_similarity(mx - dist,
                                                         score_cutoff))

    def normalized_distance_many(self, s1s, s2s, *, score_cutoff=None,
                                 device=None):
        dist, mx = self._batch_raw(s1s, s2s, device)
        nd = np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
        return _dispatch.BatchResult(*_c.mask_distance(nd, score_cutoff))

    def normalized_similarity_many(self, s1s, s2s, *, score_cutoff=None,
                                   device=None):
        dist, mx = self._batch_raw(s1s, s2s, device)
        ns = 1.0 - np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
        return _dispatch.BatchResult(*_c.mask_similarity(ns, score_cutoff))


def build_module(metric: IntMetric, ns: dict):
    """Install the standard public surface of ``metric`` into a module
    namespace ``ns``: ``Args``, the four scores and their ``_with_args``
    forms, the four ``*_many``, ``BatchComparator`` and ``maximum``."""

    class Args(_c.ArgsBase):
        __slots__ = ()

    Args.__qualname__ = f"{metric.name}.Args"

    def distance_with_args(s1, s2, args):
        return metric.distance(s1, s2, score_cutoff=args.cutoff)

    def similarity_with_args(s1, s2, args):
        return metric.similarity(s1, s2, score_cutoff=args.cutoff)

    def normalized_distance_with_args(s1, s2, args):
        return metric.normalized_distance(s1, s2, score_cutoff=args.cutoff)

    def normalized_similarity_with_args(s1, s2, args):
        return metric.normalized_similarity(s1, s2, score_cutoff=args.cutoff)

    class BatchComparator:
        """One-vs-many comparator: the scalar scores against a fixed
        query, and batch scores over a corpus on ``device``."""

        def __init__(self, s1):
            self._u1 = _codec.encode_one(s1)

        def distance(self, s2, **kw):
            return metric.distance(self._u1, s2, **kw)

        def similarity(self, s2, **kw):
            return metric.similarity(self._u1, s2, **kw)

        def normalized_distance(self, s2, **kw):
            return metric.normalized_distance(self._u1, s2, **kw)

        def normalized_similarity(self, s2, **kw):
            return metric.normalized_similarity(self._u1, s2, **kw)

        def distance_with_args(self, s2, args):
            return distance_with_args(self._u1, s2, args)

        def similarity_with_args(self, s2, args):
            return similarity_with_args(self._u1, s2, args)

        def normalized_distance_with_args(self, s2, args):
            return normalized_distance_with_args(self._u1, s2, args)

        def normalized_similarity_with_args(self, s2, args):
            return normalized_similarity_with_args(self._u1, s2, args)

        def distances(self, corpus, *, score_cutoff=None, device=None):
            return metric.distance_many([self._u1], corpus,
                                        score_cutoff=score_cutoff,
                                        device=device)

        def similarities(self, corpus, *, score_cutoff=None, device=None):
            return metric.similarity_many([self._u1], corpus,
                                          score_cutoff=score_cutoff,
                                          device=device)

        def normalized_distances(self, corpus, *, score_cutoff=None,
                                 device=None):
            return metric.normalized_distance_many(
                [self._u1], corpus, score_cutoff=score_cutoff, device=device)

        def normalized_similarities(self, corpus, *, score_cutoff=None,
                                    device=None):
            return metric.normalized_similarity_many(
                [self._u1], corpus, score_cutoff=score_cutoff, device=device)

    BatchComparator.__qualname__ = f"{metric.name}.BatchComparator"

    ns.update(
        Args=Args,
        distance=metric.distance,
        similarity=metric.similarity,
        normalized_distance=metric.normalized_distance,
        normalized_similarity=metric.normalized_similarity,
        distance_with_args=distance_with_args,
        similarity_with_args=similarity_with_args,
        normalized_distance_with_args=normalized_distance_with_args,
        normalized_similarity_with_args=normalized_similarity_with_args,
        BatchComparator=BatchComparator,
        distance_many=metric.distance_many,
        similarity_many=metric.similarity_many,
        normalized_distance_many=metric.normalized_distance_many,
        normalized_similarity_many=metric.normalized_similarity_many,
        maximum=metric.maximum,
    )
    ns.setdefault("__all__", [
        "Args", "distance", "similarity", "normalized_distance",
        "normalized_similarity", "distance_with_args", "similarity_with_args",
        "normalized_distance_with_args", "normalized_similarity_with_args",
        "BatchComparator", "distance_many", "similarity_many",
        "normalized_distance_many", "normalized_similarity_many", "maximum",
    ])
