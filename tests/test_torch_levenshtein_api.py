"""The port's Levenshtein library API against the JAX package's, on the CPU.

The same inputs go through ``rapidfuzz_tpu.distance.levenshtein`` and
``rapidfuzz_tpu_torch.distance.levenshtein`` (batch entry points with
``device="cpu"``): the golden values of the verify recipe, the four score
kinds, cutoffs and hints, ``Args``, the weight reductions and general
weights, ``BatchComparator``, the one-vs-many scanner route (with
``SCAN_MIN`` lowered so it runs at a small size) and the parts that raise
``NotImplementedError``.  Scores must be equal; normalized scores are f64
computed by the same host expressions, so they are compared exactly too.
"""

import numpy as np
import pytest

from rapidfuzz_tpu.distance import levenshtein as jlev
from rapidfuzz_tpu_torch.distance import _int_metric
from rapidfuzz_tpu_torch.distance import levenshtein as lev
from rapidfuzz_tpu_torch.parallel import scan as scan_mod

PAIRS = [("kitten", "sitting"), ("CA", "ABC"), ("", "abc"), ("abc", ""),
         ("", ""), ("Иванко", "Петрунко"), ("flaw", "lawn"),
         ("a" * 40 + "b", "a" * 41), (b"bytes", b"bites"),
         ([1, 2, 3, 2 ** 40], [2 ** 40, 1, 2, 3])]
WEIGHTS = [(1, 1, 1), (2, 2, 2), (0, 0, 5), (1, 1, 2), (2, 2, 5),
           (1, 2, 3), (3, 2, 1)]
CORPUS = ["sitting", "mitten", "kitten", "", "kittenkitten", "sitt",
          "a" * 70, "kitchen", "Иванко", "k"]
SCORES = ("distance", "similarity", "normalized_distance",
          "normalized_similarity")


def test_golden_values():
    """The verify recipe's spot checks."""
    assert lev.distance("kitten", "sitting") == 3
    assert lev.BatchComparator("CA").distances(
        ["ABC"], device="cpu").values.tolist() == [3]
    assert lev.distance("kitten", "sitting",
                        weights=lev.WeightTable(1, 1, 2)) == 5
    assert lev.distance("Иванко", "Петрунко") == 5
    assert lev.distance_many(["kitten"], ["sitting"],
                             device="cpu").values.tolist() == [3]


def _same(res, jres):
    np.testing.assert_array_equal(res.values, jres.values)
    np.testing.assert_array_equal(res.valid, jres.valid)


@pytest.mark.parametrize("w", WEIGHTS)
def test_scores_match_jax(w):
    """Under each weight table: the four score kinds and their
    ``_with_args`` forms, with and without cutoffs and hints; ``*_many``
    over aligned pairs and one-vs-many; ``BatchComparator``'s batch and
    scalar methods."""
    for s1, s2 in PAIRS:
        for kind in SCORES:
            f, jf = getattr(lev, kind), getattr(jlev, kind)
            assert f(s1, s2, weights=w) == jf(s1, s2, weights=w), \
                (kind, s1, s2, w)
            cuts = ((0, 1, 3, 7) if "normalized" not in kind
                    else (0.0, 0.3, 0.5, 0.9))
            for c in cuts:
                assert (f(s1, s2, weights=w, score_cutoff=c, score_hint=c)
                        == jf(s1, s2, weights=w, score_cutoff=c,
                              score_hint=c)), (kind, s1, s2, w, c)
            args = lev.Args().weights(w).score_cutoff(cuts[2])
            jargs = jlev.Args().weights(w).score_cutoff(cuts[2])
            assert (getattr(lev, kind + "_with_args")(s1, s2, args)
                    == getattr(jlev, kind + "_with_args")(s1, s2, jargs))
    assert lev.maximum(6, 7, w) == jlev.maximum(6, 7, w)
    s1s = [p[0] for p in PAIRS[:8]]
    s2s = [p[1] for p in PAIRS[:8]]
    for kind in SCORES:
        f = getattr(lev, kind + "_many")
        jf = getattr(jlev, kind + "_many")
        cut = 0.5 if "normalized" in kind else 3
        _same(f(s1s, s2s, weights=w, device="cpu"), jf(s1s, s2s, weights=w))
        _same(f(["kitten"], CORPUS, weights=w, score_cutoff=cut,
                device="cpu"),
              jf(["kitten"], CORPUS, weights=w, score_cutoff=cut))
    bc, jbc = lev.BatchComparator("kitten", w), jlev.BatchComparator(
        "kitten", w)
    for meth in ("distances", "similarities", "normalized_distances",
                 "normalized_similarities"):
        _same(getattr(bc, meth)(CORPUS, device="cpu"),
              getattr(jbc, meth)(CORPUS))
    for kind in SCORES:
        assert getattr(bc, kind)("sitting") == getattr(jbc, kind)("sitting")
    args = lev.Args().score_cutoff(2)
    assert bc.distance_with_args("sitting", args) \
        == jbc.distance_with_args("sitting", jlev.Args().score_cutoff(2))


def test_one_vs_many_scan_route(monkeypatch):
    """With ``SCAN_MIN`` lowered, one query against a corpus goes through
    the port's ``CorpusScanner`` for the weight reductions it serves and
    returns what the JAX package returns; the weights that reduce to indel
    go through its LCS kernels."""
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    _same(lev.distance_many(["kitten"], CORPUS, weights=(1, 1, 2),
                            device="cpu"),
          jlev.distance_many(["kitten"], CORPUS, weights=(1, 1, 2)))
    _same(lev.BatchComparator("kittens", (2, 2, 5)).distances(CORPUS,
                                                             device="cpu"),
          jlev.BatchComparator("kittens", (2, 2, 5)).distances(CORPUS))
    _same(lev.distance_many(["kitten"], CORPUS[:3], weights=(1, 1, 2),
                            device="cpu"),
          jlev.distance_many(["kitten"], CORPUS[:3], weights=(1, 1, 2)))
    real = scan_mod.CorpusScanner
    for w in ((1, 1, 1), (3, 3, 3), (0, 0, 1)):
        built = []

        def spy(*a, **kw):
            built.append(kw)
            return real(*a, **kw)

        monkeypatch.setattr(scan_mod, "CorpusScanner", spy)
        _same(lev.distance_many(["kitten"], CORPUS, weights=w,
                                score_cutoff=4, device="cpu"),
              jlev.distance_many(["kitten"], CORPUS, weights=w,
                                 score_cutoff=4))
        _same(lev.BatchComparator("kittens", w).normalized_similarities(
            CORPUS, device="cpu"),
            jlev.BatchComparator("kittens", w).normalized_similarities(
                CORPUS))
        assert len(built) == 2, w
        assert all(kw["device"] == "cpu" for kw in built)


def test_unported_parts_raise(monkeypatch):
    """editops (item 13) raise; the device scalar route for one long pair
    (item 17, the pair kernel) wants the card and, with none, raises
    rather than run the plain version; general weights on a one-vs-many
    scan, once unported, return what the JAX module returns; with no
    ``device`` the batch entry points want the card."""
    for fn in (lev.editops, lev.opcodes):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn("kitten", "sitting")
    with pytest.raises(NotImplementedError, match="item 13"):
        lev.editops_many("kitten", ["sitting"])
    monkeypatch.setenv("RAPIDFUZZ_TPU_SCALAR_BACKEND", "device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lev.distance("a" * 1001, "b" * 1001)
    monkeypatch.delenv("RAPIDFUZZ_TPU_SCALAR_BACKEND")
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    _same(lev.distance_many(["kitten"], CORPUS, weights=(1, 2, 3),
                            device="cpu"),
          jlev.distance_many(["kitten"], CORPUS, weights=(1, 2, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lev.distance_many(["kitten"], ["sitting"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lev.BatchComparator("kitten").distances(CORPUS)


def test_int_metric_factory():
    """``build_module`` installs the standard surface of an
    ``IntMetric``; built here for uniform Levenshtein from the port's
    oracle and aligned-pair ops, it returns what the JAX module does."""
    from rapidfuzz_tpu_torch import oracle
    from rapidfuzz_tpu_torch.ops import dispatch
    from rapidfuzz_tpu_torch.ops import levenshtein as ops

    metric = _int_metric.IntMetric(
        "levenshtein", np.maximum, oracle.levenshtein_uniform,
        lambda c1, l1, c2, l2, device: dispatch.run_pairs(
            ops.uniform_distance, c1, l1, c2, l2, device=device))
    ns = {}
    _int_metric.build_module(metric, ns)
    for s1, s2 in PAIRS[:6]:
        for kind in SCORES:
            assert ns[kind](s1, s2) == getattr(jlev, kind)(s1, s2)
    args = ns["Args"]().score_cutoff(2)
    assert ns["distance_with_args"]("kitten", "sitting", args) is None
    bc = ns["BatchComparator"]("kitten")
    _same(bc.distances(CORPUS, score_cutoff=3, device="cpu"),
          jlev.BatchComparator("kitten").distances(CORPUS, score_cutoff=3))
    _same(ns["normalized_similarity_many"](["kitten"], CORPUS,
                                           device="cpu"),
          jlev.normalized_similarity_many(["kitten"], CORPUS))
