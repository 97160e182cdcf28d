"""The port's Damerau-Levenshtein library API, on the CPU.

Against the JAX package's ``rapidfuzz_tpu.distance.damerau_levenshtein``:
the four scores with cutoffs, their ``_with_args`` forms, ``maximum``,
the four ``*_many`` over aligned pairs and one query against a corpus,
``BatchComparator``, and the corpus-scan route at a lowered ``SCAN_MIN``
(the port's scanner and K9's wrapper; aligned pairs in the JAX package).
The golden ``CA``/``ABC`` = 2 (a transposition with an edit between,
which OSA prices at 3).  K9's launch names follow the JAX package's
Damerau split at 128 chars.  Integers must be equal and f64 scores
bit-equal.  The kernels themselves are held to their plain versions on
the card by the ``cuda``-marked test below and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu.distance import damerau_levenshtein as jdl
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.distance import _int_metric
from rapidfuzz_tpu_torch.distance import damerau_levenshtein as dl
from rapidfuzz_tpu_torch.distance import osa
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops.cuda import damerau_kernel as dk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.parallel import scan as scan_mod
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

PAIRS = [("CA", "ABC"), ("CA", "AC"), ("kitten", "sitting"), ("", "abc"),
         ("abc", ""), ("", ""), ("Иванко", "Петрунко"),
         ("ab" * 16 + "cd", "ab" * 15 + "ba" + "dc"), (b"bytes", b"btyes"),
         ([1, 2, 3, 2 ** 40], [2, 1, 3, 2 ** 40])]
CORPUS = ["sitting", "mitten", "kitten", "", "iktten", "kittne", "a" * 70,
          "kitchen", "Иванко", "k", "kitten", "iktnet", "ktitne"]
SCORES = ("distance", "similarity", "normalized_distance",
          "normalized_similarity")


def _same(res, jres):
    np.testing.assert_array_equal(res.values, jres.values)
    np.testing.assert_array_equal(res.valid, jres.valid)


def test_golden_values():
    """CA/ABC costs 2 (CA -> AC -> ABC: the transposition keeps its
    pair apart for the insertion), which OSA cannot do; the oracle's two
    forms agree."""
    assert dl.distance("CA", "ABC") == 2
    assert osa.distance("CA", "ABC") == 3
    assert dl.distance("CA", "AC") == 1
    assert dl.BatchComparator("CA").distances(
        ["ABC", "AC", ""], device="cpu").values.tolist() == [2, 1, 2]
    e = codec.encode_one
    for s1, s2 in PAIRS[:8]:
        assert oracle.damerau(e(s1), e(s2)) == \
            oracle.damerau_rows(e(s1), e(s2))


def test_surface_matches_jax():
    """The four scores and their ``_with_args`` forms with and without
    cutoffs, ``maximum``, the four ``*_many`` over aligned pairs and one
    query against a corpus, and ``BatchComparator``."""
    for s1, s2 in PAIRS:
        for kind in SCORES:
            f, jf = getattr(dl, kind), getattr(jdl, kind)
            assert f(s1, s2) == jf(s1, s2), (kind, s1, s2)
            cuts = ((0, 1, 3) if "normalized" not in kind
                    else (0.0, 0.3, 0.9))
            for c in cuts:
                assert (f(s1, s2, score_cutoff=c)
                        == jf(s1, s2, score_cutoff=c)), (kind, s1, s2, c)
            args = dl.Args().score_cutoff(cuts[1])
            jargs = jdl.Args().score_cutoff(cuts[1])
            assert (getattr(dl, kind + "_with_args")(s1, s2, args)
                    == getattr(jdl, kind + "_with_args")(s1, s2, jargs))
    assert dl.maximum(6, 7) == jdl.maximum(6, 7)
    s1s = [p[0] for p in PAIRS[:8]]
    s2s = [p[1] for p in PAIRS[:8]]
    for kind in SCORES:
        f = getattr(dl, kind + "_many")
        jf = getattr(jdl, kind + "_many")
        cut = 0.5 if "normalized" in kind else 2
        _same(f(s1s, s2s, device="cpu"), jf(s1s, s2s))
        _same(f(["kitten"], CORPUS, score_cutoff=cut, device="cpu"),
              jf(["kitten"], CORPUS, score_cutoff=cut))
    bc, jbc = dl.BatchComparator("kitten"), jdl.BatchComparator("kitten")
    for meth in ("distances", "similarities", "normalized_distances",
                 "normalized_similarities"):
        _same(getattr(bc, meth)(CORPUS, device="cpu"),
              getattr(jbc, meth)(CORPUS))
    for kind in SCORES:
        assert getattr(bc, kind)("ktitne") == getattr(jbc, kind)("ktitne")
    assert bc.distance_with_args("iktten", dl.Args().score_cutoff(0)) \
        == jbc.distance_with_args("iktten", jdl.Args().score_cutoff(0))


def test_scan_route_at_scan_min(monkeypatch):
    """With ``SCAN_MIN`` lowered, one query against a corpus goes through
    the port's scanner and K9's full form and returns what the JAX
    package returns (aligned pairs there); with no ``device`` the batch
    entry points want the card."""
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    real = scan_mod.CorpusScanner
    built = []

    def spy(*a, **kw):
        built.append(kw["metric"])
        return real(*a, **kw)

    monkeypatch.setattr(scan_mod, "CorpusScanner", spy)
    full = Spy(monkeypatch, dk, "dam_1v_many")
    band = Spy(monkeypatch, dk, "dam_band_1v_many")
    _same(dl.distance_many(["kitten"], CORPUS, score_cutoff=2, device="cpu"),
          jdl.distance_many(["kitten"], CORPUS, score_cutoff=2))
    _same(dl.BatchComparator("kittens").normalized_similarities(
        CORPUS, device="cpu"),
        jdl.BatchComparator("kittens").normalized_similarities(CORPUS))
    assert built == ["damerau_levenshtein"] * 2
    assert full.calls == 2 and band.calls == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dl.distance_many(["kitten"], CORPUS)


@pytest.mark.parametrize("bucket,long", [(128, False), (132, True)])
def test_launch_names_follow_the_damerau_split(bucket, long, monkeypatch):
    """The full and banded forms count as ``dam_scan``/``dam_band`` up to
    a 128-char bucket and as ``dam_scan_long``/``dam_band_long`` past it
    (the JAX package's ``MAX_TEXT``), whatever the length of the query."""
    names = []
    for fn in ("_dam_scan", "_dam_band"):
        real = getattr(dk, fn)
        monkeypatch.setattr(dk, fn, lambda *a, _r=real: names.append(a[-1])
                            or _r(*a))
    corpus = ["kitten", "sitting", "a" * (bucket - 2)]
    sc = CorpusScanner(corpus, metric="damerau_levenshtein", bucket=bucket,
                       device="cpu")
    d = sc.distances("kitten")
    res = sc.distances("kitten", score_cutoff=3)
    assert d.tolist() == [0, 3, bucket - 2]
    assert res.valid.tolist() == [True, True, False]
    suffix = "_long" if long else ""
    assert names == ["dam_scan" + suffix, "dam_band" + suffix]


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,la,kband", [("dam_scan", 20, None),
                                             ("dam_scan", 70, None),
                                             ("dam_scan_long", 300, None),
                                             ("dam_band", 60, 7),
                                             ("dam_band_long", 300, 15)])
def test_damerau_kernel_matches_plain_on_card(cuda_device, kernel, la,
                                              kband):
    """Each K9 launch route, the full form in register and scratch form
    and the band, equals its plain PyTorch version on the card (the band
    within its radius, above it elsewhere) and moves its counter."""
    rng = np.random.default_rng(13)
    a = np.r_[0, 97, 98, 99, 200, 255]
    q = rng.choice(a, la)
    lb_max = 1536 if kernel.endswith("_long") else 128
    lens = rng.integers(max(0, la - 20), min(lb_max, la + 20) + 1,
                        4096).astype(np.int32)
    chars = rng.choice(a, (4096, lb_max)).astype(np.int32)
    for r in range(0, 4096, 2):
        s = np.resize(q, lb_max)
        p = int(rng.integers(0, la - 1))
        s[p], s[p + 1] = s[p + 1], s[p]
        chars[r] = s
    chars[np.arange(lb_max)[None, :] >= lens[:, None]] = -1
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    _, tabs = lk.stage_query(q, "byte", cuda_device)
    before = kc.LAUNCHES[kernel]
    ref = dk.dam_scan_plain(la, tabs, cand, lb)
    if kband is None:
        got = dk.dam_1v_many(q, cand, lb)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    else:
        got = dk.dam_band_1v_many(q, cand, lb, kband=kband)
        torch.cuda.synchronize()
        ok = ref <= kband
        assert torch.equal(got[ok], ref[ok]) and bool((got[~ok] > kband)
                                                      .all())
        assert bool(ok.any())
    assert kc.LAUNCHES[kernel] == before + 1
