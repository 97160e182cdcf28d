"""Jaro-Winkler similarity (the reference crate's
``src/distance/jaro_winkler.rs``).

Counterpart of ``rapidfuzz_tpu/distance/jaro_winkler.py``: Jaro with the
common prefix, capped at 4 chars of the original strings, boosting
``sim += prefix * prefix_weight * (1 - sim)`` only where the Jaro
similarity exceeds 0.7 (``jaro_winkler.rs:64-101``); ``prefix_weight``
defaults to 0.1.  Routes as :mod:`.jaro`: scalars on the host oracle,
one query against at least :data:`~._int_metric.SCAN_MIN` strings through
the port's ``CorpusScanner`` (which finishes the boost on the host),
other batches through the aligned-pair components, finished here.
"""

from __future__ import annotations

import numpy as np

from .. import common as _c
from .. import oracle as _oracle
from ..ops import dispatch as _dispatch
from ..utils import codec as _codec
from . import _int_metric
from . import jaro as _jaro

__all__ = [
    "Args", "distance", "similarity", "normalized_distance",
    "normalized_similarity", "distance_with_args", "similarity_with_args",
    "normalized_distance_with_args", "normalized_similarity_with_args",
    "BatchComparator", "distance_many", "similarity_many",
    "normalized_distance_many", "normalized_similarity_many", "maximum",
]


class Args(_c.ArgsBase):
    __slots__ = ("prefix_weight_",)

    def __init__(self):
        super().__init__()
        self.prefix_weight_ = 0.1

    def prefix_weight(self, w: float):
        new = self._copy()
        new.prefix_weight_ = w
        return new


def maximum(len1=None, len2=None) -> float:
    return 1.0


def _sim_scalar(s1, s2, prefix_weight) -> float:
    return _oracle.jaro_winkler(_codec.encode_one(s1), _codec.encode_one(s2),
                                prefix_weight)


def similarity(s1, s2, *, prefix_weight=0.1, score_cutoff=None,
               score_hint=None):
    """Jaro-Winkler similarity (prefix-boosted Jaro).

    >>> from rapidfuzz_tpu_torch.distance import jaro_winkler
    >>> round(jaro_winkler.similarity("martha", "marhta"), 4)
    0.9611
    >>> round(jaro_winkler.similarity("martha", "marhta",
    ...                               prefix_weight=0.2), 4)
    0.9778
    """
    return _c.apply_similarity_cutoff(_sim_scalar(s1, s2, prefix_weight),
                                      score_cutoff)


def distance(s1, s2, *, prefix_weight=0.1, score_cutoff=None,
             score_hint=None):
    return _c.apply_distance_cutoff(1.0 - _sim_scalar(s1, s2, prefix_weight),
                                    score_cutoff)


def normalized_similarity(s1, s2, **kw):
    return similarity(s1, s2, **kw)


def normalized_distance(s1, s2, **kw):
    return distance(s1, s2, **kw)


def similarity_with_args(s1, s2, args: Args):
    return similarity(s1, s2, prefix_weight=args.prefix_weight_,
                      score_cutoff=args.cutoff)


def distance_with_args(s1, s2, args: Args):
    return distance(s1, s2, prefix_weight=args.prefix_weight_,
                    score_cutoff=args.cutoff)


normalized_similarity_with_args = similarity_with_args
normalized_distance_with_args = distance_with_args


def prefix_len(c1, c2, l1, l2) -> np.ndarray:
    """Common prefix of padded rows ``c1``, ``c2`` (broadcast), capped at
    4 chars and at the shorter length ``min(l1, l2)``
    (``jaro_winkler.rs:78-83``): int64."""
    n = np.minimum(l1, l2)
    alive = np.ones(np.broadcast_shapes(c1.shape[:-1], c2.shape[:-1],
                                        np.shape(n)), bool)
    out = np.zeros(alive.shape, np.int64)
    # one column at a time: a quarter of the time of a cumprod over
    # [B, 4] at a million rows (the scanner's finish, once per query)
    for i in range(min(4, c1.shape[-1], c2.shape[-1])):
        alive &= (c1[..., i] == c2[..., i]) & (i < n)
        out += alive
    return out


def winkler(sim, prefix, prefix_weight) -> np.ndarray:
    """The Winkler boost ``sim + prefix * prefix_weight * (1 - sim)``, only
    where ``sim > 0.7`` (``jaro_winkler.rs:64-101``), in f64."""
    boosted = sim + prefix * prefix_weight * (1.0 - sim)
    return np.where(sim > 0.7, boosted, sim)


def _sim_batch(s1s, s2s, prefix_weight, device=None) -> np.ndarray:
    if len(s1s) == 1 and len(s2s) >= _int_metric.SCAN_MIN:
        return 1.0 - _int_metric.scan_one_vs_many(
            "jaro_winkler", s1s[0], s2s, device=device,
            prefix_weight=prefix_weight)
    (c1, l1, c2, l2), common, trans = _jaro.pair_components(s1s, s2s, device)
    B = common.shape[0]
    l1b = np.broadcast_to(l1, (B,))
    l2b = np.broadcast_to(l2, (B,))
    sim = _jaro.sim_from_components(common, trans, l1b, l2b)
    # the prefix on the original strings
    return winkler(sim, prefix_len(c1, c2, l1b, l2b), prefix_weight)


def similarity_many(s1s, s2s, *, prefix_weight=0.1, score_cutoff=None,
                    device=None):
    return _dispatch.BatchResult(*_c.mask_similarity(
        _sim_batch(s1s, s2s, prefix_weight, device), score_cutoff))


def distance_many(s1s, s2s, *, prefix_weight=0.1, score_cutoff=None,
                  device=None):
    return _dispatch.BatchResult(*_c.mask_distance(
        1.0 - _sim_batch(s1s, s2s, prefix_weight, device), score_cutoff))


normalized_similarity_many = similarity_many
normalized_distance_many = distance_many


class BatchComparator:
    """One-vs-many comparator with a fixed ``prefix_weight``: the scalar
    scores against a fixed query, and batch scores over a corpus on
    ``device``."""

    def __init__(self, s1, prefix_weight: float = 0.1):
        self._u1 = _codec.encode_one(s1)
        self._pw = prefix_weight

    def similarity(self, s2, **kw):
        kw.setdefault("prefix_weight", self._pw)
        return similarity(self._u1, s2, **kw)

    def distance(self, s2, **kw):
        kw.setdefault("prefix_weight", self._pw)
        return distance(self._u1, s2, **kw)

    normalized_similarity = similarity
    normalized_distance = distance

    def similarity_with_args(self, s2, args: Args):
        return similarity(self._u1, s2, prefix_weight=args.prefix_weight_,
                          score_cutoff=args.cutoff)

    def distance_with_args(self, s2, args: Args):
        return distance(self._u1, s2, prefix_weight=args.prefix_weight_,
                        score_cutoff=args.cutoff)

    normalized_similarity_with_args = similarity_with_args
    normalized_distance_with_args = distance_with_args

    def similarities(self, corpus, *, score_cutoff=None, device=None):
        return similarity_many([self._u1], corpus, prefix_weight=self._pw,
                               score_cutoff=score_cutoff, device=device)

    def distances(self, corpus, *, score_cutoff=None, device=None):
        return distance_many([self._u1], corpus, prefix_weight=self._pw,
                             score_cutoff=score_cutoff, device=device)

    # f64 metric: normalized == raw (maximum is 1.0)
    normalized_similarities = similarities
    normalized_distances = distances
