"""``fuzz.ratio`` and ``fuzz.partial_ratio``.

Counterpart of the ``ratio`` and ``partial_ratio`` parts of
``rapidfuzz_tpu/fuzz.py``.  ``ratio`` (``fuzz.rs:48-150``) is the indel
normalized similarity in ``[0.0, 1.0]``: ``ratio``, ``ratio_with_args``,
``RatioBatchComparator``, ``ratio_many`` and ``default_process``.  Scalar
scores run on the host oracle; the one-vs-many forms on ``device``
(default ``cuda``): one query against at least
:data:`~.distance._int_metric.SCAN_MIN` strings through the port's
``CorpusScanner`` and its LCS kernels (a ratio cutoff routes the banded
kernel), other batches through the aligned-pair ``ops/lcs``.

``partial_ratio`` (the ecosystem's scorer; absent from the crate,
``fuzz.rs:207-213``) is the best ``ratio`` of the shorter string against
every clipped window of the longer, ``longer[max(0, i-m) : min(n, i)]``
for ``i`` in ``1..n+m-1``; the first best window in that order is the
one reported.  ``partial_ratio`` scores on the host oracle,
``partial_ratio_alignment`` finds its window through the aligned-pair
``ops/lcs`` on ``device``, and the ``_many`` forms score every choice in
one launch of the window-sweep kernel (K10, ``ops/cuda/partial_kernel``),
choices shorter than the query and queries of any length included.

Every f64 score is finished on the host by the JAX package's expressions,
so the two packages agree to the bit.  The other scorers of the JAX
module (the ``token_*`` scorers, ``WRatio``, ``QRatio``) are not ported
yet (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
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


# ------------------------------------------------------------ partial_ratio

def _processed(s1, s2, processor: Optional[Callable]):
    if processor is None:
        return s1, s2
    return processor(s1), processor(s2)


@dataclass(frozen=True)
class ScoreAlignment:
    """Where the best ``partial_ratio`` window sits:
    ``ratio(s1[src_start:src_end], s2[dest_start:dest_end]) == score``."""
    score: float
    src_start: int
    src_end: int
    dest_start: int
    dest_end: int


def _best_window(us: np.ndarray, ul: np.ndarray, device=None):
    """(best ratio, (start, end)) of the shorter ``us`` against every
    clipped window of the longer ``ul``, through the aligned-pair LCS on
    ``device`` (``fuzz.py:135-162``), in batches of windows whose
    equality matrices stay near 2**24 elements."""
    from .ops import lcs as _lcs_ops

    m, n = int(us.size), int(ul.size)
    if m == 0:
        return (1.0 if n == 0 else 0.0), (0, 0)
    starts = np.maximum(0, np.arange(1, n + m) - m)
    ends = np.minimum(n, np.arange(1, n + m))
    best = -1.0
    best_se = (0, 0)
    chunk = max(64, (1 << 24) // (m * m))
    for lo in range(0, len(starts), chunk):
        ss, ee = starts[lo:lo + chunk], ends[lo:lo + chunk]
        wins = [ul[s:e] for s, e in zip(ss, ee)]
        c1, l1, c2, l2 = _codec.encode_pair_batch([us], wins, bucket2=None)
        sim = _dispatch.run_pairs(_lcs_ops.lcs_similarity, c1, l1, c2, l2,
                                  device=device)
        tot = m + l2.astype(np.int64)
        r = 1.0 - (tot - 2 * sim.astype(np.int64)) / np.maximum(tot, 1)
        k = int(np.argmax(r))
        if float(r[k]) > best:
            best = float(r[k])
            best_se = (int(ss[k]), int(ee[k]))
        if best >= 1.0:
            break
    return best, best_se


def partial_ratio(s1, s2, *, processor: Optional[Callable] = None,
                  score_cutoff: Optional[float] = None) -> Optional[float]:
    """Best ``ratio`` of the shorter string over the clipped windows of
    the longer, on the host oracle.

    >>> from rapidfuzz_tpu_torch import fuzz
    >>> fuzz.partial_ratio("this is a test", "this is a test!")
    1.0
    """
    s1, s2 = _processed(s1, s2, processor)
    score = _oracle.partial_ratio(_codec.encode_one(s1),
                                  _codec.encode_one(s2))
    return _c.apply_similarity_cutoff(score, score_cutoff)


def partial_ratio_alignment(s1, s2, *, processor: Optional[Callable] = None,
                            score_cutoff: Optional[float] = None,
                            device=None) -> Optional[ScoreAlignment]:
    """Best-window ``ratio`` plus where that window sits, its windows
    scored on ``device``.

    >>> from rapidfuzz_tpu_torch import fuzz
    >>> a = fuzz.partial_ratio_alignment("needle", "say needle here",
    ...                                  device="cpu")
    >>> (a.score, a.dest_start, a.dest_end)
    (1.0, 4, 10)
    """
    s1, s2 = _processed(s1, s2, processor)
    u1, u2 = _codec.encode_one(s1), _codec.encode_one(s2)
    if u1.size <= u2.size:
        score, (ws, we) = _best_window(u1, u2, device)
        align = ScoreAlignment(score, 0, int(u1.size), ws, we)
    else:
        score, (ws, we) = _best_window(u2, u1, device)
        align = ScoreAlignment(score, ws, we, 0, int(u2.size))
    if score_cutoff is not None and score < score_cutoff:
        return None
    return align


def _window_scan(uq: np.ndarray, ucs, device):
    """Every choice's best window in one K10 launch on ``device``:
    (scores f64, starts, ends, lengths).  Starts and ends are in the
    choice's coordinates where it is at least as long as the query, in
    the query's where it is shorter.  Choices with chars past 255 take
    the scanner's wide route (K2 remaps them to the query's local ids),
    which serves queries of at most 127 distinct symbols."""
    import torch

    from .ops.cuda import default_device
    from .ops.cuda import lev_kernel as _lk
    from .ops.cuda import partial_kernel as _pk

    m = int(uq.size)
    lens = np.array([u.size for u in ucs], np.int64)
    zero = np.zeros(lens.size, np.int64)
    if m == 0 or not lens.size:
        return (lens == 0).astype(np.float64), zero, zero, lens
    dev = torch.device(device) if device is not None else default_device()
    LB = max(4, -(-max(m, int(lens.max())) // 4) * 4)
    # int32 chars (values outside int32 remapped, equality kept); the
    # query is row 0, so it shares the choices' remap
    chars, _ = _codec.pad_batch([uq, *ucs], LB)
    qk, chars = chars[0, :m], chars[1:]
    cmax = int(chars.max(initial=0))
    if cmax < 256:
        mode = _lk.pick_mode(qk, cmax)
        cand, lb = _lk.prepare_corpus(torch.from_numpy(chars).to(dev),
                                      torch.from_numpy(lens))
    else:
        # the scanner's wide route (its _query_view): the query's vocab,
        # then K2 remaps the choices to query-local ids
        qv = _lk.query_vocab(qk)
        if qv is None:
            raise NotImplementedError(
                "wide-alphabet queries with more than 127 distinct symbols "
                "are not ported yet (ROADMAP.md queue 1, item 18)")
        qvocab128, qk = qv
        mode = "local"
        cand = _lk.remap_pack(
            _lk.transpose_corpus(torch.from_numpy(chars).to(dev)),
            torch.from_numpy(qvocab128).to(dev))
        lb = torch.from_numpy(lens).to(device=dev, dtype=torch.int32)
    num, den, st, en = (x.cpu().numpy() for x in _pk.partial_ratio_1v_many(
        qk, cand, lb, mode=mode))
    num, den = num.astype(np.float64), den.astype(np.float64)
    # the JAX package's f64 finish (fuzz.py:502-504), bit for bit
    return 1.0 - (den - num) / den, st, en, lens


def partial_ratio_many(s1, choices, *, processor: Optional[Callable] = None,
                       score_cutoff: Optional[float] = None,
                       device=None) -> _dispatch.BatchResult:
    """One-vs-many ``partial_ratio`` on ``device``: one K10 launch scores
    every choice.

    >>> from rapidfuzz_tpu_torch import fuzz
    >>> fuzz.partial_ratio_many("abc", ["xxabcxx", "abd", ""],
    ...                         device="cpu").values.tolist()
    [1.0, 0.8, 0.0]
    """
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    out = _window_scan(_codec.encode_one(s1),
                       [_codec.encode_one(c) for c in choices], device)[0]
    return _dispatch.BatchResult(*_c.mask_similarity(out, score_cutoff))


def partial_ratio_alignment_many(s1, choices, *,
                                 processor: Optional[Callable] = None,
                                 score_cutoff: Optional[float] = None,
                                 device=None) -> list:
    """One-vs-many best-window alignments (``list[ScoreAlignment]``, None
    under ``score_cutoff``) from the same K10 launch: the kernel keeps
    each choice's best window, with the pairwise sweep's tie-breaks.

    >>> from rapidfuzz_tpu_torch import fuzz
    >>> a = fuzz.partial_ratio_alignment_many("needle", ["say needle here"],
    ...                                       device="cpu")
    >>> (a[0].score, a[0].dest_start, a[0].dest_end)
    (1.0, 4, 10)
    """
    if processor is not None:
        s1 = processor(s1)
        choices = [processor(c) for c in choices]
    uq = _codec.encode_one(s1)
    out, st, en, lens = _window_scan(
        uq, [_codec.encode_one(c) for c in choices], device)
    m = int(uq.size)
    res = []
    for score, a, e, n in zip(out.tolist(), st.tolist(), en.tolist(),
                              lens.tolist()):
        if score_cutoff is not None and score < score_cutoff:
            res.append(None)
        elif m == 0:
            res.append(ScoreAlignment(score, 0, 0, 0, 0))
        elif n >= m:
            res.append(ScoreAlignment(score, 0, m, a, e))
        else:            # the choice slid over the query
            res.append(ScoreAlignment(score, a, e, 0, n))
    return res
