"""The port's ``CorpusScanner(metric="partial_ratio")`` and its server, on
the CPU.

Against the JAX scanner on its windowed Pallas route
(``RAPIDFUZZ_TPU_FORCE_PALLAS=interpret``: the kernel for candidates at
least as long as the query, the host re-score of the shorter ones) and on
its host route: the distances ``1.0 - score`` bit for bit (the Pallas
route returns ``(den - num) / den``, which can differ from ``1.0 -
score`` in the last bit, so there ``1.0 - d`` is compared, as the JAX
tests do), cutoff masks, top-k ids in (distance, index) order of the JAX
distances, the empty query, a query past the JAX kernel's 64-char cap, a
Cyrillic corpus (K2's remap, then K10 in local mode), a bucket over 1,024
chars and ``scan_many``.  Then ``ScanService(metric="partial_ratio")``
over HTTP against the C++ oracle, ``/reload`` included.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.serve import ScanService, make_server
from rapidfuzz_tpu_torch.utils import codec

PR = "partial_ratio"


def _corpus(seed=21):
    rng = np.random.default_rng(seed)
    letters = list("abcdefg")
    return ["".join(rng.choice(letters, int(n)))
            for n in rng.integers(0, 40, 120)] + ["", "needle here"]


def _topk_ids(d, k):
    return np.lexsort((np.arange(d.size), d))[:k]


def test_scanner_matches_jax_pallas_route(monkeypatch):
    """Queries of 6, 12 and 40 chars, every candidate shorter or longer:
    ``1.0 - d`` equal to the JAX Pallas route's; cutoff masks equal its
    ``d <= cutoff``; top-k by (distance, index); ``scan_many`` equal to
    its rows; launches counted on the one name."""
    corpus = _corpus()
    monkeypatch.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
    jsc = JaxScanner(corpus, metric=PR)
    sc = CorpusScanner(corpus, metric=PR, device="cpu")
    queries = ["needle", "abcdefgabcde", "gfedcba" * 5 + "abcde"]
    before = kc.LAUNCHES["partial_scan"]
    for q in queries:
        jd = np.asarray(jsc.distances(q))
        d = sc.distances(q)
        np.testing.assert_array_equal(1.0 - d, 1.0 - jd)
        np.testing.assert_array_equal(d, [1.0 - oracle.partial_ratio(
            codec.encode_one(q), codec.encode_one(s)) for s in corpus])
        for cut in (0.0, 0.25, 0.5):
            r = sc.distances(q, score_cutoff=cut)
            np.testing.assert_array_equal(r.values, d)
            np.testing.assert_array_equal(r.valid, d <= cut)
            np.testing.assert_array_equal(
                r.valid, np.asarray(jsc.distances(q, score_cutoff=cut).valid))
        vals, ids = sc.topk(q, 7)
        want = _topk_ids(d, 7)
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(vals, d[want])
        np.testing.assert_array_equal(1.0 - vals, 1.0 - jd[want])
    # the CPU plain calls are no launches
    assert kc.LAUNCHES["partial_scan"] == before
    np.testing.assert_array_equal(
        sc.scan_many(queries), [sc.distances(q) for q in queries])
    vals, ids = sc.scan_many(queries, k=3)
    np.testing.assert_array_equal(
        ids, [_topk_ids(sc.distances(q), 3) for q in queries])
    np.testing.assert_array_equal(
        sc.distances(""), [1.0 if s else 0.0 for s in corpus])
    np.testing.assert_array_equal(
        1.0 - sc.distances(""), 1.0 - np.asarray(jsc.distances("")))


def test_scanner_matches_jax_host_route():
    """The JAX scanner's host route, bit for bit on the distances: an
    80-char query (past its kernel's cap), a Cyrillic corpus and a
    bucket over 1,024 chars."""
    corpus = _corpus()
    rng = np.random.default_rng(3)
    lq = "".join(rng.choice(list("abcdefg"), 80))
    np.testing.assert_array_equal(
        CorpusScanner(corpus, metric=PR, device="cpu").distances(lq),
        np.asarray(JaxScanner(corpus, metric=PR).distances(lq)))
    wide = ["".join(chr(c) for c in rng.integers(0x410, 0x44F,
                                                 rng.integers(1, 25)))
            for _ in range(40)] + ["Иванко", "", "xПетрункоy"]
    for wq in ("Петрунко", "ab"):
        np.testing.assert_array_equal(
            CorpusScanner(wide, metric=PR, device="cpu").distances(wq),
            np.asarray(JaxScanner(wide, metric=PR).distances(wq)))
    texts = ["".join(rng.choice(list("abc"), int(n)))
             for n in (1030, 1100, 1500, 7, 0)]
    texts.append(texts[2][500:512])
    q = texts[1][200:212]
    sc = CorpusScanner(texts, metric=PR, device="cpu")
    assert sc._long
    d = sc.distances(q)
    np.testing.assert_array_equal(
        d, np.asarray(JaxScanner(texts, metric=PR).distances(q)))
    assert d[1] == 0.0 and d[5] < 1.0
    with pytest.raises(NotImplementedError, match="item 18"):
        CorpusScanner(wide, metric=PR, device="cpu").distances(
            "".join(chr(0x400 + i) for i in range(128)))


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_metric_partial_ratio():
    """``ScanService(metric="partial_ratio")``: the full warmup runs every
    route (no hint route), and ``/topk``, ``/distances`` (plain and under
    a cutoff) and ``/batch`` answer the oracle's f64 ``1.0 - score``,
    top-k by (distance, index), before and after a ``/reload``;
    ``/extract`` stays unported."""
    corpus = _corpus(5)[:60] + ["", "needle here"]
    service = ScanService(corpus, metric=PR, device="cpu")
    table = service.warmup(full=True)
    assert "distances_hint" not in table
    assert all(isinstance(v, float) for v in table.values()), table

    def row(q, corpus):
        e = codec.encode_one(q)
        return np.array([1.0 - oracle.partial_ratio(e, codec.encode_one(s))
                         for s in corpus])

    def top(q, k, corpus):
        d = row(q, corpus)
        ids = _topk_ids(d, k)
        return {"values": d[ids].tolist(), "indices": ids.tolist(),
                "strings": [corpus[i] for i in ids]}

    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert _post(port, "/topk", {"query": "needle", "k": 4}) \
            == top("needle", 4, corpus)
        d = row("abcdefg", corpus)
        assert _post(port, "/distances", {"query": "abcdefg"}) \
            == {"values": d.tolist()}
        assert _post(port, "/distances", {"query": "abcdefg",
                                          "score_cutoff": 0.3}) \
            == {"values": d.tolist(), "valid": (d <= 0.3).tolist()}
        out = _post(port, "/batch", {"queries": ["needle", "gfe"], "k": 2})
        want = [top("needle", 2, corpus), top("gfe", 2, corpus)]
        assert out == {key: [w[key] for w in want]
                       for key in ("values", "indices", "strings")}
        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/extract", {"query": "needle"})
        new = ["haystack", "a needle", "needles", "", "eel"]
        assert _post(port, "/reload", {"corpus": new}) == {"ok": True,
                                                            "n": 5}
        assert set(service.reload_warmup) == set(table)
        assert _post(port, "/topk", {"query": "needle", "k": 3}) \
            == top("needle", 3, new)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
