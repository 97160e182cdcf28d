"""``fuzz.ratio``: the indel normalized similarity in ``[0.0, 1.0]``.

Counterpart of the ``ratio`` part of ``rapidfuzz_tpu/fuzz.py``
(``fuzz.rs:48-150``): ``ratio``, ``ratio_with_args``,
``RatioBatchComparator``, ``ratio_many`` and ``default_process``.  Scalar
scores run on the host oracle; the one-vs-many forms on ``device``
(default ``cuda``): one query against at least
:data:`~.distance._int_metric.SCAN_MIN` strings through the port's
``CorpusScanner`` and its LCS kernels (a ratio cutoff routes the banded
kernel), other batches through the aligned-pair ``ops/lcs``.  Every f64
score is finished on the host by the JAX package's expressions, so the
two packages agree to the bit.

The other scorers of the JAX module (``partial_ratio``, the ``token_*``
scorers, ``WRatio``, ``QRatio``) are not ported yet (ROADMAP.md queue 1,
item 12).
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np

from . import common as _c
from . import oracle as _oracle
from .ops import dispatch as _dispatch
from .utils import codec as _codec


class Args(_c.ArgsBase):
    pass


def ratio(s1, s2, *, processor: Optional[Callable] = None,
          score_cutoff: Optional[float] = None,
          score_hint: Optional[float] = None) -> Optional[float]:
    """Indel-based normalized similarity in [0, 1] (``fuzz.rs:48-85``).

    >>> from rapidfuzz_tpu_torch import fuzz
    >>> round(fuzz.ratio("this is a test", "this is a test!"), 4)
    0.9655
    """
    if processor is not None:
        s1, s2 = processor(s1), processor(s2)
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    mx = u1.size + u2.size
    sim = 1.0 - _c.norm_dist_from_dist(_oracle.indel(u1, u2), mx)
    return _c.apply_similarity_cutoff(sim, score_cutoff)


def ratio_with_args(s1, s2, args: Args):
    return ratio(s1, s2, score_cutoff=args.cutoff, score_hint=args.hint)


def default_process(s: str) -> str:
    """Standard preprocessor: non-alphanumeric runs -> space, lowercase,
    trim (the ecosystem's ``utils.default_process``)."""
    return re.sub(r"\W", " ", s, flags=re.UNICODE).lower().strip()


def _aligned_ratio(arrs1, arrs2, score_cutoff=None,
                   device=None) -> np.ndarray:
    """Elementwise indel normalized similarity of two aligned encoded
    groups on ``device``.  One query against at least ``SCAN_MIN`` strings
    rides the corpus scan (same f64 finish, bit-identical).

    A ratio ``score_cutoff`` converts to the bucket-wide indel bound
    ``(1 - c) * (len1 + max len2)`` and routes the banded LCS kernel
    (``indel.rs:80-104``); entries the band rejects have a true ratio
    below the cutoff, so the final similarity mask is unchanged.
    """
    from .distance import _int_metric
    from .ops import lcs as _lcs_ops
    if len(arrs1) == 1 and len(arrs2) >= _int_metric.SCAN_MIN:
        l1 = np.int64(_codec.encode_one(arrs1[0]).size)
        l2 = np.array([_codec.encode_one(a).size for a in arrs2], np.int64)
        dcut = None
        if score_cutoff is not None and score_cutoff > 0:
            dcut = int((1.0 - score_cutoff) * (l1 + l2.max(initial=0))) + 1
        d = _int_metric.scan_one_vs_many("indel", arrs1[0], arrs2,
                                         device=device, score_cutoff=dcut)
        mx = l1 + l2
        return 1.0 - np.where(mx == 0, 0.0, d / np.maximum(mx, 1))
    c1, l1, c2, l2 = _codec.encode_pair_batch(arrs1, arrs2)
    sim = _dispatch.run_pairs(_lcs_ops.lcs_similarity, c1, l1, c2, l2,
                              device=device)
    mx = l1.astype(np.int64) + l2.astype(np.int64)
    dist = mx - 2 * sim.astype(np.int64)
    return 1.0 - np.where(mx == 0, 0.0, dist / np.maximum(mx, 1))


def ratio_many(s1, choices, *, processor: Optional[Callable] = None,
               score_cutoff: Optional[float] = None,
               device=None) -> _dispatch.BatchResult:
    """One-vs-many ``ratio`` on ``device``.

    >>> from rapidfuzz_tpu_torch import fuzz
    >>> [round(float(v), 4) for v in fuzz.ratio_many(
    ...     "abc", ["abc", "abd", ""], device="cpu").values]
    [1.0, 0.6667, 0.0]
    """
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    vals = _aligned_ratio([_codec.encode_one(s1)],
                          [_codec.encode_one(c) for c in choices],
                          score_cutoff=score_cutoff, device=device)
    return _dispatch.BatchResult(*_c.mask_similarity(vals, score_cutoff))


class RatioBatchComparator:
    """One-vs-many ``ratio`` (``fuzz.rs:98-150``): the scalar scores
    against a fixed query, and batch scores over a corpus on ``device``."""

    def __init__(self, s1):
        self._u1 = _codec.encode_one(s1)

    def similarity(self, s2, *, score_cutoff=None, score_hint=None):
        return ratio(self._u1, s2, score_cutoff=score_cutoff,
                     score_hint=score_hint)

    def similarity_with_args(self, s2, args: Args):
        return ratio(self._u1, s2, score_cutoff=args.cutoff,
                     score_hint=args.hint)

    def similarities(self, corpus, *, score_cutoff=None,
                     device=None) -> _dispatch.BatchResult:
        nsim = _aligned_ratio([self._u1],
                              [_codec.encode_one(c) for c in corpus],
                              device=device)
        return _dispatch.BatchResult(*_c.mask_similarity(nsim, score_cutoff))
