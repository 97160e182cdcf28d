"""One-vs-many and many-vs-many corpus scans on one device.

Counterpart of ``rapidfuzz_tpu/parallel/scan.py`` for Levenshtein (uniform
and weighted), the LCS family (indel, lcs_seq), OSA, the Jaro family
(jaro, jaro_winkler), Damerau-Levenshtein and ``fuzz.partial_ratio``:
the corpus is
encoded once, length-sorted, packed and kept on the device, and every
query scan reuses it — the reference's ``BatchComparator`` pattern
(``levenshtein.rs:1625-1657``) over a corpus.  Routing follows the JAX
scanner's Pallas rules (they were tuned on a TPU and are kept for
parity), with one exception: a bucket over 1024 chars that is not whole
512-char chunks leaves the JAX scanner's Pallas kernels for its XLA scan,
and there the port picks its own routes (Levenshtein: the run-time band
or the full scan; LCS, OSA and weighted Levenshtein: the streamed
routes); a weighted scan takes its kernel at every query length, where
the JAX scanner leaves queries over 256 chars on streamed buckets to
XLA, and a Jaro scan takes its kernel at every bucket and query length,
where the JAX scanner leaves buckets over 16,384 chars and queries over
its VMEM budget to XLA, and a Damerau scan takes its kernels at every
bucket, where the JAX scanner leaves buckets over 8,192 chars to XLA
(``damerau_kernel.py:1694``), and a partial_ratio scan takes its kernel at
every bucket and query length, candidates shorter than the query
included, where the JAX scanner leaves queries over 64 chars and buckets
over 1024 to its host sweep and re-scores the shorter candidates on the
host.  Only the ops wrappers choose between a kernel
(CUDA tensors) and its plain version (CPU tensors), so the host logic is
the same on both.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..ops.cuda import band_kernel as _bk
from ..ops.cuda import damerau_kernel as _dk
from ..ops.cuda import default_device
from ..ops.cuda import jaro_kernel as _jk
from ..ops.cuda import lcs_band_kernel as _cbk
from ..ops.cuda import lcs_kernel as _ck
from ..ops.cuda import lev_kernel as _lk
from ..ops.cuda import osa_kernel as _ok
from ..ops.cuda import partial_kernel as _pk
from ..ops.cuda import wlev_kernel as _wk
from ..utils import codec as _codec

#: candidates per CUDA block: the corpus pads to a whole block
BLOCK = 256
#: the JAX scanner streams buckets over 1024 chars that are whole 512-char
#: chunks (scan.py:212-216) and scans other long buckets with XLA
#: (:227-231); the port keeps the split so that stream buckets route as
#: there, though its kernels need no chunks
STREAM_CHUNK = 512
#: metrics the scanner serves
METRICS = ("levenshtein", "indel", "lcs_seq", "osa", "jaro", "jaro_winkler",
           "damerau_levenshtein", "partial_ratio")
#: the Jaro family, finished on the host from K8's components
JARO_METRICS = ("jaro", "jaro_winkler")
#: the f64 metrics: distance ``1.0 - similarity``
F64_METRICS = JARO_METRICS + ("partial_ratio",)
#: narrowest query (in u32 words) the LCS band serves: the TPU rule
#: (``scan.py:866-872``), kept for parity
LCS_BAND_MIN_W = 8


class CorpusScanner:
    """One-vs-many scan over a device-resident corpus: Levenshtein
    (uniform or weighted), indel, lcs_seq, OSA or Damerau-Levenshtein
    distances, or Jaro, Jaro-Winkler and ``partial_ratio`` distances
    ``1.0 - similarity`` (f64).

    The corpus is encoded once (length-sorted, byte-packed) on ``device``
    (default: ``cuda``; pass ``"cpu"`` for the kernels' plain versions).
    Corpora with chars >= 256 are kept unpacked and remapped per query to
    query-local ids (K2).  Levenshtein ``weights`` = ``(insertion,
    deletion, substitution)`` costs reduce as in the JAX scanner: a
    multiple of uniform scales the distances, zero insert/delete costs
    give all-zero distances, and ``sub >= ins + del`` with ``ins == del``
    is ``ins`` times indel, which the scanner then serves as metric
    ``indel`` (other metrics ignore ``weights``, as there); any other
    table runs the weighted Wagner-Fischer kernel (K7) with the query as
    the pattern (deletion charged on its chars), a full scan at every
    bucket and query length: a cutoff masks it and a hint is ignored, as
    in the JAX scanner (``scan.py:678-738``).  Every bucket
    length is served; buckets over 1024 chars that are whole 512-char
    chunks take the JAX scanner's long routes (the streamed bands and the
    full scans), other long buckets, which the JAX scanner leaves to XLA,
    the port's own (Levenshtein: the run-time band and the full scan;
    LCS and OSA: the streamed routes).  OSA has no band and no hint
    route, as in the JAX scanner: a cutoff masks the full scan.
    ``weights`` may be a ``(insertion, deletion, substitution)`` tuple or
    a :class:`~rapidfuzz_tpu_torch.distance.levenshtein.WeightTable`.
    The Jaro family scans with K8 at every bucket and query length (no
    band, no hint route, a cutoff masks the f64 distances) and finishes
    each scan on the host in f64, the Winkler boost
    (``prefix_weight``) from a host copy of each candidate's first 4
    chars (``scan.py:436-458``).  Damerau-Levenshtein scans with K9
    (:meth:`_dam_distances`): under an integer cutoff its banded form
    where the JAX scanner's rules pick the band, otherwise its full form,
    at every bucket and query length; a hint is ignored and ``scan_many``
    runs one query per launch, as in the JAX scanner.  ``partial_ratio``
    scans with K10 (:meth:`_partial_distances`) at every bucket and query
    length, candidates shorter than the query included: no band, no hint
    route, a cutoff masks the f64 distances, ``scan_many`` one query per
    launch.

    Device memory is planned here, once: ``LB`` bytes per candidate for
    the packed corpus (wide corpora: ``4*LB`` unpacked, plus ``LB`` packed
    per query), 4 for its length.  Per query a scan adds an int32 output,
    for queries over 4,096 chars the edge buffer of K1's, K4's or K6's
    tile form between strips (``lev_kernel.edge_chunk``: K1 2 bits per
    text row and candidate, K4 1, K6 4, launched over chunks of candidates
    within ``lev_kernel.SCRATCH_BYTES``), and
    for a hint scan its stragglers, compacted in chunks of at most an
    eighth of the corpus, so no scan stages a second corpus-sized copy;
    the Levenshtein, LCS and OSA kernels keep their state in registers at
    every query length, and a
    weighted scan keeps its rows in registers (the tile form past 128
    query chars) and, for queries over 1,024 chars, adds an edge buffer
    of one int32 per text row and candidate (``[chunk, LB]``, ``4*LB``
    bytes per candidate), launched over chunks of candidates so that it
    stays within ``wlev_kernel.SCRATCH_BYTES`` (1 GiB): a 300-char query
    over 1M strings needs none, a 4,001-char query over 131,072 texts of
    bucket 8192 is 4 GiB of edges, 4 launches.  A Jaro scan adds two
    int32 outputs (queries over 160 chars keep their cursors and flags in
    shared memory, and a few KB of staged tables per query), and the
    host keeps 4 chars and the length of each candidate.  A Damerau scan reads the same
    packed corpus (no second copy, where the JAX scanner stages its band's
    own layout) and keeps its DP state in registers; queries over 1,024
    chars add an edge buffer of 12 bytes per text row and candidate
    (``[3, LB, chunk]`` int32) within ``damerau_kernel.SCRATCH_BYTES``: a
    4,001-char query over 131,072 texts of bucket 8192 is 12.9 GB of
    edges, 13 launches.  A partial_ratio scan adds K10's four int32 outputs
    (num, den, start, end: 16 bytes per candidate) and, for queries over
    512 chars, one window's state in a ``[W, chunk]`` u32 scratch (``4*W``
    bytes per candidate) within ``partial_kernel.SCRATCH_BYTES``.
    """

    NQ_GROUP = 16  # queries per multi-query launch

    def __init__(self, corpus, metric: str = "levenshtein",
                 bucket: int | None = None, weights=None, device=None,
                 prefix_weight: float = 0.1):
        if metric not in METRICS:
            raise NotImplementedError(
                f"metric {metric!r} is not ported yet (ROADMAP.md queue 1, "
                "item 8)")
        self.metric = metric
        self.prefix_weight = prefix_weight
        self.device = torch.device(device) if device is not None \
            else default_device()
        # weighted Levenshtein reduces algebraically where possible
        # (levenshtein.rs:1244-1279; scan.py:146-156)
        self._wscale = 1
        self._zero = False
        #: a general (ins, del, sub) table: the weighted scan
        self._weights = None
        if weights is not None and metric == "levenshtein":
            # a WeightTable or a tuple, as the JAX scanner takes
            # (scan.py:142-144); imported here, as the JAX scanner does,
            # so that importing the scanner imports no library module
            from ..distance.levenshtein import as_weight_table
            ins, dele, sub = as_weight_table(weights).costs()
            if not ins == dele == sub == 1:
                if ins == dele == 0:
                    self._zero = True
                elif ins == dele == sub:
                    self._wscale = ins
                elif ins == dele and sub >= ins + dele:
                    self.metric = "indel"
                    self._wscale = ins
                else:
                    self._weights = (ins, dele, sub)
        # corpora whose elements exceed int32 (or contain int32.max) are
        # remapped through a dense vocabulary that queries share
        # (pattern_match_vector.rs:104-154 overflow-hashmap equivalent)
        self._vocab = None
        chars = srt = None
        if corpus and all(type(s) is str for s in corpus):
            # str corpora are encoded once sorted (below)
            lens = np.fromiter((len(s) for s in corpus), np.int32,
                               count=len(corpus))
        else:
            arrs = [_codec.encode_one(s) for s in corpus]
            if _codec._needs_remap(arrs) or any(
                    a.size and a.max() == np.iinfo(np.int32).max
                    for a in arrs):
                flat = (np.concatenate(arrs) if arrs
                        else np.empty(0, np.int64))
                self._vocab = np.unique(flat)
                arrs = [np.searchsorted(self._vocab, a).astype(np.int32)
                        for a in arrs]
            chars, lens = _codec.pad_batch(arrs, bucket)
        n = len(lens)
        self.n = n
        self.lengths = lens.copy()         # host lengths, corpus order
        padded = -(-max(n, 1) // BLOCK) * BLOCK
        # padding rows have length 0 and are masked out by _valid
        lens = np.concatenate([lens, np.zeros(padded - n, np.int32)])
        # length sort: a warp's candidates then run similar step counts;
        # padding rows (length 0) sort to the front
        self._order = np.argsort(lens, kind="stable")
        self._valid = self._order < n
        real = self._order[self._valid]
        srt_lens = lens[self._order]
        self.lb = torch.from_numpy(srt_lens).to(self.device)
        if chars is None:
            # the codec's byte matrix in sorted order (padding rows
            # empty) where every char is < 256, else its codepoints
            # (< 0x110000: no remap case can occur)
            srt = _codec.encode_latin1(
                [corpus[i] if i < n else "" for i in self._order], bucket)
            if srt is None:
                chars, _ = _codec.encode_batch(corpus, bucket)
            else:
                srt = srt[0]
        self._width = width = (chars if chars is not None else srt).shape[1]
        # checkpoints refuse to resume against a different corpus of the
        # same shape: chars+lens+vocab determine the original elements.
        # The byte matrix is hashed at first use (_fingerprint)
        self._fp = None
        if chars is not None:
            self._fp = _codec.fingerprint([chars], self.lengths, self._vocab)
            self._cmax = int(chars.max()) if chars.size else 0
        else:
            self._cmax = (int(srt.max()) if self.lengths.any()
                          else int(_codec.PAD))
        # a packed word holds 4 chars: a bucket that is not a multiple of
        # 4 gains PAD columns, which change no distance
        self._LB = -(-width // 4) * 4
        self._long = self._LB > _lk.LONG_LB
        self._stream = self._long and self._LB % STREAM_CHUNK == 0
        self._wide = self._cmax >= 256
        if self._wide:
            # kept unpacked and pre-transposed: each query remaps it to
            # query-local byte ids (K2)
            srt = np.full((padded, self._LB), _codec.PAD, np.int32)
            srt[self._valid, :width] = chars[real]
            self._chars_dev = _lk.transpose_corpus(
                torch.from_numpy(srt).to(self.device))
            self.cand = None
        else:
            # chars < 256: sorted bytes, so neither the host nor the
            # device holds a copy wider than a byte per char
            if chars is not None:
                np.maximum(chars, 0, out=chars)
                srt = np.zeros((padded, self._LB), np.uint8)
                srt[self._valid, :width] = chars[real].astype(np.uint8)
            elif width != self._LB:
                srt = np.pad(srt, ((0, 0), (0, self._LB - width)))
            self.cand, _ = _lk.prepare_corpus(
                torch.from_numpy(srt).to(self.device), self.lb)
            self._chars_dev = None
        if metric in JARO_METRICS:
            # the Jaro finish runs on the host in sorted order: lengths,
            # and the first 4 chars for the Winkler prefix, taken before
            # any per-query remap (it compares the original chars)
            k = min(4, width)
            self._lens_host = srt_lens
            self._chars4 = srt[:, :k].astype(np.int32)
            self._chars4[np.arange(k)[None, :] >= srt_lens[:, None]] = \
                _codec.PAD

    @property
    def _fingerprint(self) -> str:
        """Content hash of the corpus, the JAX scanner's (``scan.py:175``,
        ``codec.fingerprint``).  Where the build kept no host matrix (the
        byte route), its rows come back here, once, from the packed
        corpus on the device, in corpus order and chunks of rows."""
        if self._fp is None:
            inv = np.empty_like(self._order)
            inv[self._order] = np.arange(self._order.size)

            def rows():
                for s in range(0, self.n, 4096):
                    r = torch.from_numpy(inv[s: min(s + 4096, self.n)])
                    c = self.cand.index_select(1, r.to(self.device))
                    c = c.t().contiguous().view(torch.uint8)
                    yield c[:, : self._width].cpu().numpy()

            self._fp = _codec.fingerprint(rows(), self.lengths)
        return self._fp

    def _encode_query(self, query):
        q = _codec.encode_one(query)
        if self._vocab is not None:
            idx = np.searchsorted(self._vocab, q).clip(0,
                                                       len(self._vocab) - 1)
            # chars absent from the corpus vocab map to an id no corpus
            # element uses, so they can never match
            miss = self._vocab[idx] != q
            q = np.where(miss, np.int64(len(self._vocab)), idx)
        elif q.size:
            # query chars outside the int32 corpus domain can never match
            # a corpus char: map them to one never-matching sentinel
            bad = (q < 0) | (q > np.iinfo(np.int32).max)
            if bad.any():
                q = np.where(bad, np.int64(min(self._cmax + 1,
                                               np.iinfo(np.int32).max)), q)
        return q

    def _query_view(self, q):
        """(query as the kernels see it, PM mode, packed corpus): on a
        wide-alphabet corpus the query-local ids and the corpus remapped
        to them."""
        if not self._wide:
            return q, _lk.pick_mode(q, self._cmax), self.cand
        qv = _lk.query_vocab(q)
        if qv is None:
            raise NotImplementedError(
                "wide-alphabet queries with more than 127 distinct symbols "
                "are not ported yet (ROADMAP.md queue 1, item 18)")
        qvocab128, q_local = qv
        cand = _lk.remap_pack(self._chars_dev,
                              torch.from_numpy(qvocab128).to(self.device))
        return q_local, "local", cand

    def _distances_dev(self, query, score_cutoff=None, score_hint=None):
        """Distances in sorted (padded) corpus order, as host integers,
        routed as the JAX scanner routes (``scan.py:678-915``)."""
        q = self._encode_query(query)
        if self._zero:
            return np.zeros(self.lb.shape[0], np.int64)
        if self.metric == "partial_ratio" and q.size == 0:
            # an empty query: 1.0 against every non-empty candidate
            # (scan.py:488-489)
            return (self.lb > 0).cpu().numpy().astype(np.float64)
        qk, mode, cand = self._query_view(q)
        if self.metric == "partial_ratio":
            return self._partial_distances(qk, mode, cand)
        if self.metric in JARO_METRICS:
            # K8 at every bucket and query length; no band, no hint route
            # (scan.py:809-826); a cutoff masks the distances in distances()
            common, trans = _jk.jaro_1v_many(qk, cand, self.lb, mode=mode)
            return self._jaro_finish(common.cpu().numpy(),
                                     trans.cpu().numpy(), q)
        if self.metric == "damerau_levenshtein":
            return self._dam_distances(qk, mode, cand, score_cutoff)
        if self.metric == "osa":
            # the full scan at every bucket; no band, no hint route
            # (scan.py:798-808); a cutoff masks it in distances()
            return _ok.osa_1v_many(qk, cand, self.lb, mode=mode).cpu().numpy()
        if self.metric != "levenshtein":
            return self._lcs_distances(q, qk, mode, cand, score_cutoff)
        if self._weights is not None:
            # the full weighted scan at every bucket and query length,
            # before the hint and band routes (scan.py:718-738): a cutoff
            # masks it in distances(), a hint is ignored
            ins, dele, sub = self._weights
            return _wk.wlev_1v_many(qk, cand, self.lb, ins=ins, dele=dele,
                                    sub_cost=sub, mode=mode).cpu().numpy()
        cut = (None if score_cutoff is None or self._wscale != 1
               else score_cutoff)
        if cut is not None and self._stream:
            cut = int(cut)   # the streamed rules test the int (scan.py:685)
        if cut is None and score_hint is not None and self._wscale == 1:
            out = self._lev_hint_scan(qk, mode, cand, int(score_hint))
            if out is not None:
                return out
        if cut is not None and 0 <= cut <= _bk.MAX_CUTOFF_FAST \
                and cut < q.size:
            band = self._band_route(int(cut), q.size)
            if band is not None:
                # banded: exact when <= cutoff, BIG above it
                out = band(qk.astype(np.int32), cand, self.lb,
                           cutoff=int(cut), mode=mode)
                return out.cpu().numpy()
        out = _lk.lev_1v_many(qk, cand, self.lb, mode=mode)
        if self._wscale != 1:
            out = out * self._wscale
        return out.cpu().numpy()

    def _jaro_finish(self, common, trans, q):
        """Sorted-order (common, transpositions) -> f64 distances
        ``1.0 - sim``, exact on the host (``scan.py:436-458``)."""
        from ..distance import jaro as _jaro_mod
        from ..distance import jaro_winkler as _jw

        lens = self._lens_host
        l1 = np.full_like(lens, q.size)
        sim = _jaro_mod.sim_from_components(common, trans, l1, lens)
        if self.metric == "jaro_winkler":
            sim = _jw.winkler(sim, _jw.prefix_len(self._chars4, q[None, :],
                                                  q.size, lens),
                              self.prefix_weight)
        return 1.0 - sim

    def _partial_distances(self, qk, mode, cand):
        """partial_ratio distances ``1.0 - score`` (f64), sorted order: K10
        scores every candidate, the shorter-than-query ones in the swapped
        role (``scan.py:478-586``, where they are re-scored on the host);
        the score's f64 finish is the JAX package's (``fuzz.py:502-504``).
        No band, no hint route; a cutoff masks the distances in
        :meth:`distances`."""
        num, den, _, _ = _pk.partial_ratio_1v_many(qk, cand, self.lb,
                                                   mode=mode)
        num = num.cpu().numpy().astype(np.float64)
        den = den.cpu().numpy().astype(np.float64)
        score = 1.0 - (den - num) / den
        return 1.0 - score

    def _dam_distances(self, qk, mode, cand, score_cutoff):
        """Damerau-Levenshtein distances, sorted order, routed as the JAX
        scanner's Pallas route (``scan.py:593-651``): over buckets of at
        most ``damerau_kernel.MAX_TEXT`` chars the band for an integer
        cutoff ``>= 0`` whose :func:`~.damerau_kernel.pick_dam_band` radius
        (against the bucket rounded up to 16) exists, over longer buckets
        for an integer cutoff in 0-15; otherwise the full scan.  Banded
        values above the cutoff are some value above it, masked in
        :meth:`distances`."""
        kb, cut = None, score_cutoff
        if cut is not None and cut >= 0 and int(cut) == cut:
            if self._width <= _dk.MAX_TEXT:
                kb = _dk.pick_dam_band(int(cut), -(-max(self._width, 16)
                                                   // 16) * 16)
            elif cut <= 15:
                kb = _dk.pick_dam_band(int(cut), 1 << 30)
        if kb is not None:
            out = _dk.dam_band_1v_many(qk, cand, self.lb, kband=kb,
                                       mode=mode)
        else:
            out = _dk.dam_1v_many(qk, cand, self.lb, mode=mode)
        return out.cpu().numpy()

    def _lcs_distances(self, q, qk, mode, cand, score_cutoff):
        """Indel or lcs_seq distances, sorted order (``scan.py:855-915``):
        an indel cutoff ``k`` bounds the LCS to a band of ``k`` (an
        lcs_seq cutoff ``k`` to indel ``2k``), which serves queries of at
        least :data:`LCS_BAND_MIN_W` words, up to 2 band words over long
        buckets; not under a weight scale, and in byte mode not for a
        query holding NUL (the pad byte, which the TPU band reads).
        Otherwise the full LCS scan.  The LCS lengths are finished here
        into ``la + lb - 2*lcs`` (indel, times the weight scale) or
        ``max(la, lb) - lcs``."""
        eff = (None if score_cutoff is None or self._wscale != 1
               else int(score_cutoff))
        band_cut = (eff if self.metric == "indel"
                    else None if eff is None else 2 * eff)
        band = None
        if (band_cut is not None and 0 <= band_cut <= _cbk.MAX_CUTOFF
                and _lk.words(q.size) >= LCS_BAND_MIN_W
                and (mode == "local" or not np.any(np.asarray(qk) == 0))):
            if not self._long:
                band = _cbk.lcs_banded_1v_many
            elif _bk.band_words(band_cut) <= 2:
                band = _cbk.lcs_banded_stream_1v_many
        if band is not None:
            sim = band(np.asarray(qk, np.int32), cand, self.lb,
                       cutoff=band_cut, mode=mode)
        else:
            sim = _ck.lcs_1v_many(qk, cand, self.lb, mode=mode)
        la, lb = int(q.size), self.lb.to(torch.int64)
        if self.metric == "indel":
            d = (la + lb - 2 * sim) * self._wscale
        else:
            d = torch.clamp(lb, min=la) - sim
        return d.cpu().numpy()

    def _band_route(self, cut: int, qsize: int):
        """The band wrapper the JAX scanner's rules pick for a cutoff
        ``cut < qsize``, or None for the full scan.  The crossovers were
        measured on a TPU v5e and are kept for parity:

        * streamed buckets (``scan.py:693-697``): the pinned band once the
          query's word count clears ``2*bw + 1``;
        * other buckets (``scan.py:766-784``): the pinned band for a query
          longer than it over a bucket of at most ``FAST_MAX_LB``, paying
          once ``Wq >= 2*bw`` (flat form, ``LB*bw <= FLAT_MAX_STEPS``) or
          ``2*bw + 1``; otherwise the run-time band for queries over 160
          chars and cutoffs up to ``MAX_CUTOFF``.  Only buckets over 1024
          that are not whole stream chunks reach that branch, and the JAX
          scanner scans those with XLA, so there the rule is the port's
          own choice."""
        bw = _bk.band_words(cut)
        Wq = _lk.words(qsize)
        if self._stream:
            if qsize > 16 * bw - 1 and Wq >= 2 * bw + 1:
                return _bk.lev_banded_stream_1v_many
            return None
        if qsize > 16 * bw - 1 and self._LB <= _bk.FAST_MAX_LB:
            if self._LB * bw <= _bk.FLAT_MAX_STEPS:
                ok = Wq >= 2 * bw
            else:
                ok = Wq >= 2 * bw + 1
        else:
            ok = qsize > 160 and cut <= _bk.MAX_CUTOFF
        return _bk.lev_banded_1v_many if ok else None

    def _lev_hint_scan(self, qk, mode, cand, hint):
        """Two-pass hint scan (the reference's score-hint ladder,
        ``levenshtein.rs:1069-1088``; ``scan.py:904-957``): pass 1 runs
        the banded kernel at the hint; the candidates it rejected are
        gathered into dense sub-corpora for full-kernel passes, so every
        distance stays exact.  Returns None when the hint isn't
        band-eligible."""
        if self.metric != "levenshtein":
            return None
        q = np.asarray(qk)
        cut = max(1, min(int(hint), _bk.MAX_CUTOFF_FAST))
        bw = _bk.band_words(cut)
        Wq = _lk.words(q.size)
        if not (cut < q.size and q.size > 16 * bw - 1):
            return None
        if self._stream:
            if Wq < 2 * bw + 1:
                return None
            band_fn = _bk.lev_banded_stream_1v_many
        else:
            if not (self._LB <= _bk.FAST_MAX_LB and Wq >= 2 * bw):
                return None
            band_fn = _bk.lev_banded_1v_many
        staged = _lk.stage_query(q, mode, self.device)
        band = band_fn(q.astype(np.int32), cand, self.lb, cutoff=cut,
                       mode=mode, staged=staged)
        idx = torch.nonzero(band >= int(_bk.BIG)).reshape(-1)
        # the stragglers, compacted into whole CUDA blocks, at most an
        # eighth of the corpus at a time
        B = self.lb.shape[0]
        chunk = max(BLOCK, B // 8 // BLOCK * BLOCK)
        for s in range(0, int(idx.numel()), chunk):
            part = idx[s: s + chunk]
            m = int(part.numel())
            npad = -(-m // BLOCK) * BLOCK
            part_pad = torch.cat([part, part[:1].expand(npad - m)])
            sub_c = cand.index_select(1, part_pad)
            sub_lb = self.lb.index_select(0, part_pad)
            full = _lk.lev_1v_many(q, sub_c, sub_lb, mode=mode,
                                   staged=staged)
            band[part] = full[:m]
        return band.cpu().numpy()

    def _band_auto_cut(self, query):
        """Cheapest band cutoff the routing would actually accelerate for
        this query, or None (``scan.py:959-986``: the pinned band over
        buckets of at most ``FAST_MAX_LB`` only)."""
        if (self.metric != "levenshtein" or self._wscale != 1
                or self._weights is not None
                or self._LB > _bk.FAST_MAX_LB):
            return None
        qsize = int(_codec.encode_one(query).size)
        if self._wide and qsize > 127:
            # the query may exceed the 128-entry local-remap vocab
            return None
        for cut in (_bk.MAX_CUTOFF, 31, _bk.MAX_CUTOFF_FAST):
            if cut < qsize and self._band_route(cut, qsize) is not None:
                return cut
        return None

    def _unsort(self, d: np.ndarray) -> np.ndarray:
        """Sorted padded order -> original corpus order, length ``n``."""
        out = np.empty(d.shape, d.dtype)
        out[self._order] = d
        return out[: self.n]

    def distances(self, query, *, score_cutoff=None, score_hint=None):
        """Distances to every corpus string.

        Without ``score_cutoff``: a plain array.  With it: a
        ``(values, valid)`` :class:`BatchResult` (the batch rendering of
        the reference's ``Option`` results, ``common.rs:33-46``); a small
        integer cutoff runs the banded kernel.  ``score_hint`` never
        changes results but routes the two-pass banded-then-compact scan.
        """
        from ..ops import dispatch as _dispatch
        from .. import common as _c

        d = self._unsort(self._distances_dev(query, score_cutoff,
                                             score_hint))
        if score_cutoff is None:
            return d
        return _dispatch.BatchResult(*_c.mask_distance(d, score_cutoff))

    @staticmethod
    def _topk_host(d: np.ndarray, orig: np.ndarray, k: int):
        """Deterministic host top-k: smallest k by (distance, original
        corpus index).  Widening to the tie boundary before ordering makes
        every caller (sorted or original space) return the same ids."""
        if k >= d.size:
            cand = np.arange(d.size)
        else:
            part = np.argpartition(d, k - 1)[:k]
            cand = np.nonzero(d <= d[part].max())[0]
        cand = cand[np.lexsort((orig[cand], d[cand]))][:k]
        return cand

    def _nq_eligible(self) -> bool:
        """scan_many batches queries into one multi-query launch when the
        packed corpus is query-independent (not on the wide-alphabet
        route, which remaps the corpus per query) and, as in the JAX
        scanner, the bucket is at most 1024 chars and the scan is not
        weighted, Damerau or partial_ratio (K7, K9 and K10 have no
        multi-query form, ``scan.py:1260-1262``)."""
        return (not self._wide and not self._zero and not self._long
                and self._weights is None
                and self.metric not in ("damerau_levenshtein",
                                        "partial_ratio"))

    def _distances_many(self, queries):
        """``[len(queries), n]`` distances via grouped multi-query launches.

        Queries are encoded, grouped by (word bucket, PM mode), padded to
        :data:`NQ_GROUP` by repeating the group's last query (padded rows
        are dropped), and run through ``lev_kernel.lev_nq_many``,
        ``osa_kernel.osa_nq_many``, ``lcs_kernel.lcs_nq_many`` or
        ``jaro_kernel.jaro_nq_many`` (``scan.py:1295-1310``); LCS lengths
        are finished per metric on the corpus-order host lengths
        (``scan.py:1316-1333``), Jaro components in sorted order, as
        :meth:`_jaro_finish` keeps its host arrays (``scan.py:1302``).
        """
        enc = [self._encode_query(q) for q in queries]
        jaro = self.metric in JARO_METRICS
        out = np.zeros((len(enc), self.n), np.float64 if jaro else np.int64)
        groups: dict = {}
        for i, q in enumerate(enc):
            groups.setdefault((_lk.words(q.size),
                               _lk.pick_mode(q, self._cmax)), []).append(i)
        nq_fn = {"levenshtein": _lk.lev_nq_many,
                 "osa": _ok.osa_nq_many}.get(self.metric, _ck.lcs_nq_many)
        lens = self.lengths.astype(np.int64)
        for (_, mode), idxs in groups.items():
            for s in range(0, len(idxs), self.NQ_GROUP):
                part = idxs[s: s + self.NQ_GROUP]
                qs = [enc[i] for i in part]
                qs = qs + [qs[-1]] * (self.NQ_GROUP - len(qs))
                if jaro:
                    cm, tr = _jk.jaro_nq_many(qs, self.cand, self.lb,
                                              mode=mode)
                    cm, tr = cm.cpu().numpy(), tr.cpu().numpy()
                    for row, i in enumerate(part):
                        out[i] = self._unsort(self._jaro_finish(
                            cm[row], tr[row], enc[i]))
                    continue
                d = nq_fn(qs, self.cand, self.lb, mode=mode).cpu().numpy()
                for row, i in enumerate(part):
                    r = self._unsort(d[row]).astype(np.int64)
                    la = enc[i].size
                    if self.metric == "indel":
                        r = la + lens - 2 * r
                    elif self.metric == "lcs_seq":
                        r = np.maximum(la, lens) - r
                    out[i] = r * self._wscale
        return out

    def _ckpt_fingerprint(self, queries) -> str:
        """Corpus+queries+metric content hash stored in checkpoints."""
        qh = hashlib.sha1()
        for s in queries:
            qh.update(_codec.encode_one(s).tobytes())
            qh.update(b";")
        return f"{self._fingerprint}:{qh.hexdigest()}:{self.metric}"

    def scan_many(self, queries, *, k: int | None = None,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 256):
        """Scan a stream of queries; optionally checkpoint + resume.

        Returns ``[nq, n]`` distances (or, with ``k``, a pair of
        ``[nq, k]`` value/index arrays).  With ``checkpoint_path``,
        partial results are written every ``checkpoint_every`` queries and
        an interrupted run resumes from the last checkpoint; a checkpoint
        of another corpus, query list, ``k`` or metric is ignored.
        """
        queries = list(queries)
        nq = len(queries)
        done = 0
        if k is None:
            vals = np.zeros((nq, self.n), np.float64)
            ids = None
        else:
            vals = np.full((nq, k), np.inf)
            ids = np.full((nq, k), -1, np.int64)
        fp = self._ckpt_fingerprint(queries)
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if int(ck["n"]) == self.n and int(ck["nq"]) == nq \
                    and (k or 0) == int(ck["k"]) \
                    and str(ck.get("fp", "")) == fp:
                done = int(ck["done"])
                vals[:done] = ck["vals"][:done]
                if ids is not None:
                    ids[:done] = ck["ids"][:done]

        def _save(done):
            if checkpoint_path is None:
                return
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(tmp, n=self.n, nq=nq, k=k or 0, done=done, vals=vals,
                     ids=ids if ids is not None else np.empty(0), fp=fp)
            os.replace(tmp, checkpoint_path)

        if self._nq_eligible() and nq - done > 1:
            # grouped multi-query launches between checkpoint boundaries
            qi = done
            while qi < nq:
                stop = min(nq, (qi // checkpoint_every + 1)
                           * checkpoint_every)
                d = self._distances_many(queries[qi:stop])
                if k is None:
                    vals[qi:stop] = d
                else:
                    kk = min(k, self.n)
                    for r, row in enumerate(d):
                        rd = row.astype(np.float64)
                        sel = self._topk_host(rd, np.arange(rd.size), kk)
                        vals[qi + r, : len(sel)] = row[sel]
                        ids[qi + r, : len(sel)] = sel
                qi = stop
                if checkpoint_path is not None and qi < nq:
                    _save(qi)
        else:
            for qi in range(done, nq):
                if k is None:
                    vals[qi] = self.distances(queries[qi])
                else:
                    v, i = self.topk(queries[qi], k)
                    vals[qi, : len(v)] = v
                    ids[qi, : len(i)] = i
                if checkpoint_path is not None \
                        and (qi + 1) % checkpoint_every == 0:
                    _save(qi + 1)
        _save(nq)
        return vals if k is None else (vals, ids)

    def topk(self, query, k: int, *, score_cutoff=None):
        """(distances[k], corpus_indices[k]) of the k nearest strings,
        ties broken by the smaller corpus index.

        With ``score_cutoff``, entries above the cutoff are excluded
        (fewer than ``k`` results may return).
        """
        if k <= 0:
            return np.empty(0), np.empty(0, np.int32)
        if score_cutoff is not None:
            res = self.distances(query, score_cutoff=score_cutoff)
            vals, valid = res.values, res.valid
            d = np.where(valid, vals.astype(np.float64), np.inf)
            k = min(k, int(valid.sum()))
            if k == 0:
                return np.empty(0, vals.dtype), np.empty(0, np.int32)
            ids = self._topk_host(d, np.arange(d.size), k)
            return vals[ids], ids.astype(np.int32)
        # auto-band: top-k only needs the nearest candidates, so try the
        # banded kernel first; if >= k candidates land under the band,
        # nothing outside it can displace them (exact), otherwise fall
        # through to the full scan
        cut = self._band_auto_cut(query)
        if cut is not None:
            res = self.distances(query, score_cutoff=cut)
            nv = int(res.valid.sum())
            if nv >= min(k, self.n):
                d = np.where(res.valid, res.values.astype(np.float64),
                             np.inf)
                ids = self._topk_host(d, np.arange(d.size), min(k, nv))
                return res.values[ids], ids.astype(np.int32)
        k = min(k, self.n)
        f64 = self.metric in F64_METRICS
        if k == 0:
            return (np.empty(0, np.float64 if f64 else np.int64),
                    np.empty(0, np.int32))
        # sorted space: mask padding rows, host top-k, map ids back (ties
        # break on the ORIGINAL corpus index, as the scan_many path does)
        dist = self._distances_dev(query)
        d = np.where(self._valid, dist.astype(np.float64), np.inf)
        ids = self._topk_host(d, self._order, k)
        vals = d[ids] if f64 else d[ids].astype(np.int64)
        return vals, self._order[ids].astype(np.int32)
