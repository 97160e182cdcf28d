"""The port's LCS-family library API and server against the JAX package's,
on the CPU.

The same inputs go through ``rapidfuzz_tpu`` and ``rapidfuzz_tpu_torch``
(batch entry points with ``device="cpu"``): the ``indel`` and ``lcs_seq``
10-function surface with cutoffs and ``Args``, ``BatchComparator``, the
``*_many`` batches under ``SCAN_MIN`` (aligned pairs) and at it (the
corpus scan, ``SCAN_MIN`` lowered so it runs at a small size),
``fuzz.ratio``, ``ratio_many`` and ``RatioBatchComparator``, the
Levenshtein weights that reduce to indel, and a ``ScanService`` under
``--metric indel`` (its answers against the JAX package's indel
distances).  Integers must be equal and f64 scores bit-equal,
finished on the host by the same expressions.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from rapidfuzz_tpu import fuzz as jfuzz
from rapidfuzz_tpu.distance import indel as jindel
from rapidfuzz_tpu.distance import lcs_seq as jlcs
from rapidfuzz_tpu.distance import levenshtein as jlev
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import fuzz
from rapidfuzz_tpu_torch.distance import _int_metric
from rapidfuzz_tpu_torch.distance import indel, lcs_seq
from rapidfuzz_tpu_torch.distance import levenshtein as lev
from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.parallel import scan as scan_mod
from rapidfuzz_tpu_torch.serve import ScanService, make_server

from test_torch_long import Spy

PAIRS = [("lewenstein", "levenshtein"), ("kitten", "sitting"), ("", "abc"),
         ("abc", ""), ("", ""), ("Иванко", "Петрунко"),
         ("a" * 40 + "b", "a" * 41), (b"bytes", b"bites"),
         ([1, 2, 3, 2 ** 40], [2 ** 40, 1, 2, 3])]
CORPUS = ["sitting", "mitten", "kitten", "", "kittenkitten", "sitt",
          "a" * 70, "kitchen", "Иванко", "k", "kitten"]
SCORES = ("distance", "similarity", "normalized_distance",
          "normalized_similarity")
MODULES = {"indel": (indel, jindel), "lcs_seq": (lcs_seq, jlcs)}


def _same(res, jres):
    np.testing.assert_array_equal(res.values, jres.values)
    np.testing.assert_array_equal(res.valid, jres.valid)


def test_golden_values():
    """The verify recipe's spot checks."""
    assert indel.distance("lewenstein", "levenshtein") == 3
    assert lcs_seq.distance("lewenstein", "levenshtein") == 2
    assert round(fuzz.ratio("this is a test", "this is a test!"), 4) \
        == 0.9655
    assert indel.BatchComparator("lewenstein").distances(
        ["levenshtein"], device="cpu").values.tolist() == [3]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_surface_matches_jax(name):
    """The four scores and their ``_with_args`` forms with and without
    cutoffs, ``maximum``, the four ``*_many`` over aligned pairs and one
    query against a corpus, ``BatchComparator``, and ``editops`` not
    ported (ROADMAP item 13)."""
    mod, jmod = MODULES[name]
    for s1, s2 in PAIRS:
        for kind in SCORES:
            f, jf = getattr(mod, kind), getattr(jmod, kind)
            assert f(s1, s2) == jf(s1, s2), (kind, s1, s2)
            cuts = ((0, 1, 3, 7) if "normalized" not in kind
                    else (0.0, 0.3, 0.5, 0.9))
            for c in cuts:
                assert (f(s1, s2, score_cutoff=c)
                        == jf(s1, s2, score_cutoff=c)), (kind, s1, s2, c)
            args = mod.Args().score_cutoff(cuts[2])
            jargs = jmod.Args().score_cutoff(cuts[2])
            assert (getattr(mod, kind + "_with_args")(s1, s2, args)
                    == getattr(jmod, kind + "_with_args")(s1, s2, jargs))
    assert mod.maximum(6, 7) == jmod.maximum(6, 7)
    s1s = [p[0] for p in PAIRS[:7]]
    s2s = [p[1] for p in PAIRS[:7]]
    for kind in SCORES:
        f = getattr(mod, kind + "_many")
        jf = getattr(jmod, kind + "_many")
        cut = 0.5 if "normalized" in kind else 3
        _same(f(s1s, s2s, device="cpu"), jf(s1s, s2s))
        _same(f(["kitten"], CORPUS, score_cutoff=cut, device="cpu"),
              jf(["kitten"], CORPUS, score_cutoff=cut))
    bc, jbc = mod.BatchComparator("kitten"), jmod.BatchComparator("kitten")
    for meth in ("distances", "similarities", "normalized_distances",
                 "normalized_similarities"):
        _same(getattr(bc, meth)(CORPUS, score_cutoff=None, device="cpu"),
              getattr(jbc, meth)(CORPUS))
    for kind in SCORES:
        assert getattr(bc, kind)("sitting") == getattr(jbc, kind)("sitting")
    assert bc.distance_with_args("sitting", mod.Args().score_cutoff(2)) \
        == jbc.distance_with_args("sitting", jmod.Args().score_cutoff(2))
    for fn in (mod.editops, mod.opcodes):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn("kitten", "sitting")
    with pytest.raises(NotImplementedError, match="item 13"):
        mod.editops_many("kitten", ["sitting"])


def test_scan_route_at_scan_min(monkeypatch):
    """With ``SCAN_MIN`` lowered, one query against a corpus goes through
    the port's scanner and its LCS kernels for indel, lcs_seq, fuzz and
    the Levenshtein weights that reduce to indel, and returns what the
    JAX package returns; with no ``device`` the batch entry points want
    the card."""
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    real = scan_mod.CorpusScanner
    built = []

    def spy(*a, **kw):
        built.append(kw["metric"])
        return real(*a, **kw)

    monkeypatch.setattr(scan_mod, "CorpusScanner", spy)
    full = Spy(monkeypatch, ck, "lcs_1v_many")
    for name, (mod, jmod) in MODULES.items():
        _same(mod.distance_many(["kitten"], CORPUS, score_cutoff=4,
                                device="cpu"),
              jmod.distance_many(["kitten"], CORPUS, score_cutoff=4))
        _same(mod.BatchComparator("kittens").normalized_similarities(
            CORPUS, device="cpu"),
            jmod.BatchComparator("kittens").normalized_similarities(CORPUS))
    for w in ((1, 1, 2), (2, 2, 5)):
        _same(lev.distance_many(["kitten"], CORPUS, weights=w,
                                device="cpu"),
              jlev.distance_many(["kitten"], CORPUS, weights=w))
        _same(lev.BatchComparator("kittens", w).similarities(CORPUS,
                                                             device="cpu"),
              jlev.BatchComparator("kittens", w).similarities(CORPUS))
    _same(fuzz.ratio_many("kitten", CORPUS, score_cutoff=0.5, device="cpu"),
          jfuzz.ratio_many("kitten", CORPUS, score_cutoff=0.5))
    _same(fuzz.RatioBatchComparator("kitten").similarities(
        CORPUS, score_cutoff=0.7, device="cpu"),
        jfuzz.RatioBatchComparator("kitten").similarities(
            CORPUS, score_cutoff=0.7))
    assert built == ["indel"] * 2 + ["lcs_seq"] * 2 + ["levenshtein"] * 4 \
        + ["indel"] * 2
    assert full.calls == len(built)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        indel.distance_many(["kitten"], CORPUS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.ratio_many("kitten", CORPUS)


def test_fuzz_ratio_matches_jax():
    """``ratio`` with cutoffs, ``Args`` and ``default_process``;
    ``ratio_many`` and ``RatioBatchComparator`` over aligned pairs."""
    for s1, s2 in PAIRS + [("this is a test", "THIS is a TEST!")]:
        assert fuzz.ratio(s1, s2) == jfuzz.ratio(s1, s2)
        for c in (0.0, 0.5, 0.9655, 1.0):
            assert (fuzz.ratio(s1, s2, score_cutoff=c)
                    == jfuzz.ratio(s1, s2, score_cutoff=c))
        args, jargs = fuzz.Args().score_cutoff(0.5), \
            jfuzz.Args().score_cutoff(0.5)
        assert fuzz.ratio_with_args(s1, s2, args) \
            == jfuzz.ratio_with_args(s1, s2, jargs)
    assert fuzz.ratio("this is a test", "THIS is a TEST!",
                      processor=fuzz.default_process) == 1.0
    assert fuzz.default_process("  The QUICK-brown fox! ") \
        == jfuzz.default_process("  The QUICK-brown fox! ")
    for c in (None, 0.6):
        _same(fuzz.ratio_many("Kitten", CORPUS, score_cutoff=c,
                              processor=fuzz.default_process, device="cpu"),
              jfuzz.ratio_many("Kitten", CORPUS, score_cutoff=c,
                               processor=jfuzz.default_process))
    bc, jbc = fuzz.RatioBatchComparator("kitten"), \
        jfuzz.RatioBatchComparator("kitten")
    _same(bc.similarities(CORPUS, device="cpu"), jbc.similarities(CORPUS))
    for s2 in CORPUS:
        assert bc.similarity(s2, score_cutoff=0.5) \
            == jbc.similarity(s2, score_cutoff=0.5)
        assert bc.similarity_with_args(s2, fuzz.Args()) \
            == jbc.similarity_with_args(s2, jfuzz.Args())


def test_ratio_many_banded_scan(monkeypatch):
    """``ratio_many`` under a cutoff over a corpus at ``SCAN_MIN``: the
    ratio cutoff becomes an indel band, which the port's scanner serves
    with the LCS band kernel.  Valid rows and their scores equal the JAX
    package's; every score, those of rejected rows included, equals the
    same f64 finish of the JAX scanner's band on one device (interpret
    mode; the JAX package's own ``ratio_many`` scans on every device of
    its mesh, where the LCS routes have no band)."""
    rng = np.random.default_rng(5)
    q = "".join(rng.choice(list("abcdef"), 240))
    choices = [q[: int(n)] + "".join(rng.choice(list("abcdef"), int(e)))
               for n, e in zip(rng.integers(200, 241, 40),
                               rng.integers(0, 20, 40))]
    choices += ["".join(rng.choice(list("abcdef"), int(n)))
                for n in rng.integers(0, 250, 20)]
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    band = Spy(monkeypatch, cbk, "lcs_banded_1v_many")
    res = fuzz.ratio_many(q, choices, score_cutoff=0.95, device="cpu")
    assert band.calls == 1
    assert res.valid.any() and not res.valid.all()
    jres = jfuzz.ratio_many(q, choices, score_cutoff=0.95)
    np.testing.assert_array_equal(res.valid, jres.valid)
    np.testing.assert_array_equal(res.values[res.valid],
                                  jres.values[jres.valid])
    lens = np.array([len(c) for c in choices], np.int64)
    dcut = int((1.0 - 0.95) * (len(q) + lens.max())) + 1
    monkeypatch.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
    js = JaxScanner(choices, metric="indel", mesh=Mesh(
        np.array(jax.devices("cpu")[:1]), ("data",)))
    d = np.asarray(js.distances(q, score_cutoff=dcut).values, np.int64)
    mx = np.int64(len(q)) + lens
    np.testing.assert_array_equal(
        res.values, 1.0 - np.where(mx == 0, 0.0, d / np.maximum(mx, 1)))


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_metric_indel():
    """``ScanService(metric="indel")``: the full warmup runs every LCS
    route (no hint route, as the JAX server), and the HTTP answers of
    ``/topk``, ``/distances`` (plain and under a cutoff) and ``/batch``
    equal the JAX package's indel distances, top-k by (distance, index)."""
    service = ScanService(CORPUS, metric="indel", bucket=96, device="cpu")
    table = service.warmup(full=True)
    assert "distances_hint" not in table
    assert all(isinstance(v, float) for v in table.values()), table

    def jrow(q):
        return np.array([jindel.distance(q, s) for s in CORPUS])

    def jtop(q, k):
        d = jrow(q)
        ids = np.lexsort((np.arange(d.size), d))[:k]
        return {"values": d[ids].tolist(), "indices": ids.tolist(),
                "strings": [CORPUS[i] for i in ids]}

    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert _post(port, "/topk", {"query": "kitten", "k": 3}) \
            == jtop("kitten", 3)
        d = jrow("sitten")
        assert _post(port, "/distances", {"query": "sitten"}) \
            == {"values": d.tolist()}
        assert _post(port, "/distances", {"query": "sitten",
                                          "score_cutoff": 3}) \
            == {"values": d.tolist(), "valid": (d <= 3).tolist()}
        out = _post(port, "/batch", {"queries": ["kitten", "mitt"],
                                     "k": 2})
        want = [jtop("kitten", 2), jtop("mitt", 2)]
        assert out == {key: [w[key] for w in want]
                       for key in ("values", "indices", "strings")}
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
