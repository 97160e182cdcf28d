"""Levenshtein distance (uniform + weighted).

Counterpart of ``rapidfuzz_tpu/distance/levenshtein.py``; the public
surface mirrors the reference module ``src/distance/levenshtein.rs``: the
8 score functions, ``Args`` + ``WeightTable`` builders, ``maximum``, the
batch APIs ``*_many`` and a ``BatchComparator``.

* Scalar scores run on the host oracle (``native/oracle.cpp``).  The JAX
  package's in-process C route for str/bytes (``native/rf_scalar.cpp``)
  is a latency item still to port (ROADMAP.md queue 1, item 3); it
  returns the same values.  Under ``RAPIDFUZZ_TPU_SCALAR_BACKEND=device``
  they run on the card: one long pair of uniform weights
  (``len1 * len2 > 10**6``) through the banded pair kernel
  (``ops/cuda/pair_kernel.lev_pair``, K11: one block on one SM, four
  warps from the second rung) and its hint ladder, with the
  host oracle past its band (a distance over 16,383 edits); other pairs
  as a one-pair batch of the aligned-pair ops.
* Batch scores run on ``device`` (default ``cuda``; ``device="cpu"`` runs
  the kernels' plain versions): one query against at least
  :data:`~._int_metric.SCAN_MIN` strings through the port's
  ``CorpusScanner`` and its CUDA kernels (weights that reduce to indel
  through its LCS kernels, general weights through the weighted
  Wagner-Fischer kernel), other batches, and general weights whose int32
  cells could overflow, through the aligned-pair ops
  (``ops/levenshtein.py``, ``ops/lcs.py``), which run in int64.
* ``maximum`` follows ``levenshtein.rs:263-277``; weight special cases
  (``levenshtein.rs:1244-1279``): ins == del == 0 -> 0, uniform * factor,
  sub >= ins + del -> indel * factor.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP.md
queue 1 item: ``editops``/``opcodes`` (item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import common as _c
from .. import oracle as _oracle
from ..ops import dispatch as _dispatch
from ..ops import lcs as _lcs_ops
from ..ops import levenshtein as _ops
from ..ops.cuda import default_device
from ..ops.cuda import pair_kernel as _pair
from ..ops.cuda import wlev_kernel as _wk
from ..utils import codec as _codec
from . import _int_metric

__all__ = [
    "WeightTable", "as_weight_table", "Args", "distance", "similarity",
    "normalized_distance",
    "normalized_similarity", "distance_with_args", "similarity_with_args",
    "normalized_distance_with_args", "normalized_similarity_with_args",
    "BatchComparator", "distance_many", "similarity_many",
    "normalized_distance_many", "normalized_similarity_many", "maximum",
    "editops", "opcodes", "editops_many",
]


def editops(s1, s2):
    """Minimal uniform-Levenshtein edit script: not ported yet."""
    raise _int_metric.editops_not_ported()


def editops_many(s1, choices):
    """Edit scripts from ``s1`` to every choice: not ported yet."""
    raise _int_metric.editops_not_ported()


def opcodes(s1, s2):
    """difflib-style grouped edit operations: not ported yet."""
    raise _int_metric.editops_not_ported()


@dataclass(frozen=True)
class WeightTable:
    """Edit-operation costs (``levenshtein.rs:129-148``)."""
    insertion_cost: int = 1
    deletion_cost: int = 1
    substitution_cost: int = 1

    @property
    def uniform(self) -> bool:
        return (self.insertion_cost == self.deletion_cost ==
                self.substitution_cost == 1)

    def costs(self) -> tuple[int, int, int]:
        return (self.insertion_cost, self.deletion_cost,
                self.substitution_cost)


_UNIFORM = WeightTable()


def as_weight_table(w) -> WeightTable:
    """Coerce ``weights`` (a :class:`WeightTable` or an ``(insertion,
    deletion, substitution)`` sequence) to a :class:`WeightTable`."""
    if w is None:
        return _UNIFORM
    if isinstance(w, WeightTable):
        return w
    ins, dele, sub = w
    return WeightTable(int(ins), int(dele), int(sub))


class Args(_c.ArgsBase):
    __slots__ = ("weights_",)

    def __init__(self):
        super().__init__()
        self.weights_ = _UNIFORM

    def weights(self, w: WeightTable):
        new = self._copy()
        new.weights_ = as_weight_table(w)
        return new


def maximum(len1, len2, weights: WeightTable = _UNIFORM):
    """Maximum possible distance (``levenshtein.rs:263-277``); vectorises
    over numpy length arrays."""
    ins, dele, sub = as_weight_table(weights).costs()
    if type(len1) is int and type(len2) is int:
        alt = (len2 * sub + (len1 - len2) * dele if len1 >= len2
               else len1 * sub + (len2 - len1) * ins)
        return min(len1 * dele + len2 * ins, alt)
    l1 = np.asarray(len1, np.int64)
    l2 = np.asarray(len2, np.int64)
    max_dist = l1 * dele + l2 * ins
    alt = np.where(l1 >= l2, l2 * sub + (l1 - l2) * dele,
                   l1 * sub + (l2 - l1) * ins)
    out = np.minimum(max_dist, alt)
    return int(out) if out.ndim == 0 else out


# ------------------------------------------------------------- scalar core

def _raw_distance(u1: np.ndarray, u2: np.ndarray, weights: WeightTable,
                  cutoff: Optional[int] = None,
                  hint: Optional[int] = None) -> int:
    """True weighted distance of two encoded arrays (host oracle).

    ``cutoff``/``hint`` are in DISTANCE units: the result is exact when it
    is <= cutoff, else any value > cutoff (``levenshtein.rs:1104-1222``);
    a hint seeds the band ladder without affecting exactness.
    """
    ins, dele, sub = weights.costs()
    if ins == dele:
        if ins == 0:
            return 0
        if ins == sub:
            # every edit costs `ins`: distance = ins * uniform distance
            cut_u = None if cutoff is None else cutoff // ins
            hint_u = None if hint is None else max(hint // ins, 1)
            return ins * _oracle.levenshtein_uniform_auto(
                u1, u2, cutoff=cut_u, hint=hint_u)
        if sub >= ins + dele:
            return ins * _oracle.indel(u1, u2)
    return _oracle.levenshtein_weighted(u1, u2, ins, dele, sub)


def _scalar(s1, s2, weights: WeightTable,
            cutoff: Optional[int] = None,
            hint: Optional[int] = None) -> tuple[int, int]:
    """(raw_distance, maximum) for a scalar pair; the raw distance is
    exact when <= ``cutoff`` (distance units), else any value above it."""
    weights = as_weight_table(weights)
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    mx = maximum(u1.size, u2.size, weights)
    if _c.scalar_backend() == "device":
        ins, dele, sub = weights.costs()
        if ins == dele == sub and ins > 0 and u1.size * u2.size > 1_000_000:
            # long uniform pairs: the banded pair kernel K11 on the card
            # (ops/cuda/pair_kernel; the levenshtein.rs:769-1019 route)
            # instead of a padded one-pair batch scan
            dev = default_device()
            cut_u = None if cutoff is None else cutoff // ins
            hint_u = None if hint is None else max(hint // ins, 1)
            try:
                d = _pair.lev_pair(u1, u2, score_cutoff=cut_u,
                                   score_hint=hint_u, device=dev)
                dist = (ins * d if d is not None
                        else cutoff + 1)        # certified above the cutoff
            except _pair.BandLimit:   # distance past the device band
                dist = _raw_distance(u1, u2, weights, cutoff, hint)
            return dist, mx
        c1, l1, c2, l2 = _codec.encode_pair_batch([u1], [u2])
        return int(_raw_distance_batch(c1, l1, c2, l2, weights)[0]), mx
    return _raw_distance(u1, u2, weights, cutoff, hint), mx


# ------------------------------------------------------------- public scalar

def distance(s1, s2, *, weights: WeightTable = _UNIFORM,
             score_cutoff: Optional[int] = None,
             score_hint: Optional[int] = None) -> Optional[int]:
    """Levenshtein distance (uniform or weighted).

    >>> from rapidfuzz_tpu_torch.distance import levenshtein
    >>> levenshtein.distance("kitten", "sitting")
    3
    >>> levenshtein.distance("kitten", "sitting", score_cutoff=2) is None
    True
    """
    dist, _ = _scalar(s1, s2, weights, score_cutoff, score_hint)
    return _c.apply_distance_cutoff(dist, score_cutoff)


def similarity(s1, s2, *, weights: WeightTable = _UNIFORM,
               score_cutoff: Optional[int] = None,
               score_hint: Optional[int] = None) -> Optional[int]:
    """Levenshtein similarity (``maximum - distance``)."""
    mx0 = maximum(_codec.encode_one(s1).size, _codec.encode_one(s2).size,
                  weights)
    dcut = None if score_cutoff is None else max(mx0 - score_cutoff, 0)
    dhint = None if score_hint is None else max(mx0 - score_hint, 0)
    dist, mx = _scalar(s1, s2, weights, dcut, dhint)
    return _c.apply_similarity_cutoff(mx - dist, score_cutoff)


def normalized_distance(s1, s2, *, weights: WeightTable = _UNIFORM,
                        score_cutoff: Optional[float] = None,
                        score_hint: Optional[float] = None
                        ) -> Optional[float]:
    """Levenshtein distance normalized to [0, 1]."""
    mx0 = maximum(_codec.encode_one(s1).size, _codec.encode_one(s2).size,
                  weights)
    dcut = (None if score_cutoff is None
            else int(score_cutoff * mx0) + 1)      # over-covering band
    dhint = None if score_hint is None else int(score_hint * mx0) + 1
    dist, mx = _scalar(s1, s2, weights, dcut, dhint)
    return _c.apply_distance_cutoff(_c.norm_dist_from_dist(dist, mx),
                                    score_cutoff)


def normalized_similarity(s1, s2, *, weights: WeightTable = _UNIFORM,
                          score_cutoff: Optional[float] = None,
                          score_hint: Optional[float] = None
                          ) -> Optional[float]:
    """Levenshtein similarity normalized to [0, 1]."""
    mx0 = maximum(_codec.encode_one(s1).size, _codec.encode_one(s2).size,
                  weights)
    dcut = (None if score_cutoff is None
            else int((1.0 - score_cutoff) * mx0) + 1)
    dhint = (None if score_hint is None
             else int((1.0 - score_hint) * mx0) + 1)
    dist, mx = _scalar(s1, s2, weights, dcut, dhint)
    return _c.apply_similarity_cutoff(1.0 - _c.norm_dist_from_dist(dist, mx),
                                      score_cutoff)


def distance_with_args(s1, s2, args: Args):
    return distance(s1, s2, weights=args.weights_, score_cutoff=args.cutoff,
                    score_hint=args.hint)


def similarity_with_args(s1, s2, args: Args):
    return similarity(s1, s2, weights=args.weights_, score_cutoff=args.cutoff,
                      score_hint=args.hint)


def normalized_distance_with_args(s1, s2, args: Args):
    return normalized_distance(s1, s2, weights=args.weights_,
                               score_cutoff=args.cutoff, score_hint=args.hint)


def normalized_similarity_with_args(s1, s2, args: Args):
    return normalized_similarity(s1, s2, weights=args.weights_,
                                 score_cutoff=args.cutoff,
                                 score_hint=args.hint)


# ------------------------------------------------------------------- batch

def _raw_distance_batch(c1, l1, c2, l2, weights: WeightTable,
                        device=None) -> np.ndarray:
    """Raw distances of padded aligned-pair batches on ``device``.  The
    weighted row runs in int64, so no weight table overflows it (the JAX
    package's int32 cells needed a host fallback for that)."""
    ins, dele, sub = weights.costs()
    if ins == dele:
        if ins == 0:
            return np.zeros(np.broadcast_shapes(l1.shape, l2.shape), np.int64)
        if ins == sub:
            d = _dispatch.run_pairs(_ops.uniform_distance, c1, l1, c2, l2,
                                    device=device)
            return d.astype(np.int64) * ins
        if sub >= ins + dele:
            sim = _dispatch.run_pairs(_lcs_ops.lcs_similarity, c1, l1, c2,
                                      l2, device=device)
            return (l1.astype(np.int64) + l2.astype(np.int64)
                    - 2 * sim.astype(np.int64)) * ins
    d = _dispatch.run_pairs(_ops.weighted_distance, c1, l1, c2, l2,
                            device=device, ins=ins, dele=dele, sub=sub)
    return d.astype(np.int64)


def _scan_fits(la: int, l2: np.ndarray, weights: WeightTable) -> bool:
    """Whether a query of ``la`` chars against strings of lengths ``l2``
    under ``weights`` fits the weighted kernel's int32 cells at the bucket
    the scanner pads them to."""
    LB = _codec.bucket_len(max(int(l2.max(initial=0)), 1))
    return _wk.fits_int32(la, -(-LB // 4) * 4, *weights.costs())


def _batch_raw(s1s, s2s, weights: WeightTable, device=None):
    weights = as_weight_table(weights)
    # one query against a corpus: the scanner and its kernels (weights
    # with sub >= ins + del reduce to indel there, general weights run the
    # weighted kernel), unless the table could overflow that kernel's
    # int32 cells: the int64 aligned pairs then, where the JAX library
    # takes its host oracle (its levenshtein.py:377-392)
    if len(s1s) == 1 and len(s2s) >= _int_metric.SCAN_MIN:
        l2 = np.array([_codec.encode_one(s).size for s in s2s], np.int64)
        l1 = np.full_like(l2, _codec.encode_one(s1s[0]).size)
        if _scan_fits(int(l1[0]), l2, weights):
            d = _int_metric.scan_one_vs_many("levenshtein", s1s[0], s2s,
                                             weights=weights.costs(),
                                             device=device)
            return d, maximum(l1, l2, weights)
    c1, l1, c2, l2 = _codec.encode_pair_batch(s1s, s2s)
    dist = _raw_distance_batch(c1, l1, c2, l2, weights, device)
    B = max(len(l1), len(l2))
    l1b = np.broadcast_to(l1, (B,)).astype(np.int64)
    l2b = np.broadcast_to(l2, (B,)).astype(np.int64)
    return dist, maximum(l1b, l2b, weights)


def distance_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                  score_cutoff: Optional[int] = None,
                  device=None) -> _dispatch.BatchResult:
    """Elementwise distances for two aligned batches (``s1s`` of one
    query broadcasts against ``s2s``) on ``device``."""
    dist, _ = _batch_raw(s1s, s2s, weights, device)
    return _dispatch.BatchResult(*_c.mask_distance(dist, score_cutoff))


def similarity_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                    score_cutoff=None, device=None) -> _dispatch.BatchResult:
    dist, mx = _batch_raw(s1s, s2s, weights, device)
    return _dispatch.BatchResult(*_c.mask_similarity(mx - dist, score_cutoff))


def normalized_distance_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                             score_cutoff=None,
                             device=None) -> _dispatch.BatchResult:
    dist, mx = _batch_raw(s1s, s2s, weights, device)
    nd = np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
    return _dispatch.BatchResult(*_c.mask_distance(nd, score_cutoff))


def normalized_similarity_many(s1s, s2s, *, weights: WeightTable = _UNIFORM,
                               score_cutoff=None,
                               device=None) -> _dispatch.BatchResult:
    dist, mx = _batch_raw(s1s, s2s, weights, device)
    ns = 1.0 - np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))
    return _dispatch.BatchResult(*_c.mask_similarity(ns, score_cutoff))


# ---------------------------------------------------------- BatchComparator

class BatchComparator:
    """One-vs-many comparator (``levenshtein.rs:1625-1818``).

    Scalar scores against the fixed query run as the module's scalar
    functions do.  The batch scores take the route of
    :func:`distance_many` with the query as its one ``s1``: a corpus of
    at least ``SCAN_MIN`` strings goes through the scanner's kernels on
    ``device``, where the JAX package keeps its comparator on the
    aligned-pair kernels; both give the same values.
    """

    def __init__(self, s1, weights: WeightTable = _UNIFORM):
        self._u1 = _codec.encode_one(s1)
        self._weights = as_weight_table(weights)

    def distance(self, s2, **kw):
        return distance(self._u1, s2, weights=self._weights, **kw)

    def similarity(self, s2, **kw):
        return similarity(self._u1, s2, weights=self._weights, **kw)

    def normalized_distance(self, s2, **kw):
        return normalized_distance(self._u1, s2, weights=self._weights, **kw)

    def normalized_similarity(self, s2, **kw):
        return normalized_similarity(self._u1, s2, weights=self._weights,
                                     **kw)

    def distance_with_args(self, s2, args: Args):
        return distance_with_args(self._u1, s2, args)

    def similarity_with_args(self, s2, args: Args):
        return similarity_with_args(self._u1, s2, args)

    def normalized_distance_with_args(self, s2, args: Args):
        return normalized_distance_with_args(self._u1, s2, args)

    def normalized_similarity_with_args(self, s2, args: Args):
        return normalized_similarity_with_args(self._u1, s2, args)

    def distances(self, corpus, *, score_cutoff=None,
                  device=None) -> _dispatch.BatchResult:
        return distance_many([self._u1], corpus, weights=self._weights,
                             score_cutoff=score_cutoff, device=device)

    def similarities(self, corpus, *, score_cutoff=None,
                     device=None) -> _dispatch.BatchResult:
        return similarity_many([self._u1], corpus, weights=self._weights,
                               score_cutoff=score_cutoff, device=device)

    def normalized_distances(self, corpus, *, score_cutoff=None,
                             device=None) -> _dispatch.BatchResult:
        return normalized_distance_many([self._u1], corpus,
                                        weights=self._weights,
                                        score_cutoff=score_cutoff,
                                        device=device)

    def normalized_similarities(self, corpus, *, score_cutoff=None,
                                device=None) -> _dispatch.BatchResult:
        return normalized_similarity_many([self._u1], corpus,
                                          weights=self._weights,
                                          score_cutoff=score_cutoff,
                                          device=device)
