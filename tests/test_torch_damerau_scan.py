"""The port's CorpusScanner(metric="damerau_levenshtein") and its server
against the JAX scanner, on the CPU.

The port's scanner runs K9's plain versions on CPU tensors; the JAX
scanner runs its XLA route (``ops/damerau.damerau_distance``) on a
one-device CPU mesh, over the same strings.  Held equal: distances, the
``(values, valid)`` answers under cutoffs None, 0, 3, 7, 15, 20 and 2.5
(the band's routes and the full scan's; values equal where valid, above
the cutoff elsewhere), top-k ids in the (distance, index) order of the
JAX distances (its XLA top-k breaks ties arbitrarily) with the JAX
values, a Cyrillic corpus (K2's remap, then K9), a bucket over 1,024
chars (the long routes) with an empty query and empty candidates, and
``scan_many`` with its checkpoint and the JAX scanner's fingerprint.
Spies show each scan runs the Damerau wrapper the JAX scanner's rules
pick and no other scan wrapper.  ``ScanService(metric=
"damerau_levenshtein")`` answers over HTTP what the oracle says, before
and after a ``/reload``.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import damerau_kernel as dk
from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel as jk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok
from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel as wk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.serve import ScanService, make_server
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

METRIC = "damerau_levenshtein"
N, LB = 256, 64


def _jax(corpus, bucket):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return JaxScanner(corpus, metric=METRIC, mesh=mesh, bucket=bucket)


def _near(rng, q, alph, n, lmax):
    """Near copies of ``q`` (adjacent swaps, swaps with a char between,
    substitutions, cut or grown ends) and random strings."""
    out = []
    for r in range(n):
        if r % 3 == 2:
            out.append("".join(rng.choice(alph, int(rng.integers(0, lmax)))))
            continue
        s = list(q)
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(s) - 1))
            s[p], s[p + 1] = s[p + 1], s[p]
        if r % 4 == 0:
            p = int(rng.integers(0, len(s) - 2))
            s[p], s[p + 2] = s[p + 2], s[p]
        if r % 5 == 0:
            s[int(rng.integers(0, len(s)))] = str(rng.choice(alph))
        s = s[: int(rng.integers(len(s) - 3, len(s) + 1))]
        if r % 7 == 0:
            s += list(rng.choice(alph, int(rng.integers(1, 6))))
        out.append("".join(s)[:lmax])
    return out


@pytest.fixture(scope="module")
def corpus():
    """N strings of bucket 64 over 5 letters: near copies of a 30-char
    query, random rows, an empty row and duplicate rows (top-k ties)."""
    rng = np.random.default_rng(64)
    alph = list("abcde")
    q = "".join(rng.choice(alph, 30))
    strings = _near(rng, q, alph, N, LB)
    strings[5] = ""
    strings[3] = "edcba" * 5
    strings[-6:] = [strings[3]] * 3 + [strings[4]] * 3
    return strings, q, _jax(strings, LB)


def _spies(mp):
    dam = {"full": Spy(mp, dk, "dam_1v_many"),
           "band": Spy(mp, dk, "dam_band_1v_many")}
    other = [Spy(mp, lk, "lev_1v_many"), Spy(mp, bk, "lev_banded_1v_many"),
             Spy(mp, ck, "lcs_1v_many"), Spy(mp, ok, "osa_1v_many"),
             Spy(mp, wk, "wlev_1v_many"), Spy(mp, jk, "jaro_1v_many")]
    return dam, other


def _same_cut(res, jres, cut):
    np.testing.assert_array_equal(res.valid, jres.valid)
    np.testing.assert_array_equal(res.values[res.valid],
                                  np.asarray(jres.values)[jres.valid])
    assert (res.values[~res.valid] > cut).all()


def test_scanner_matches_jax(corpus, monkeypatch):
    """Distances, every cutoff's (values, valid) and top-k (with ties)
    equal the JAX scanner's; integer cutoffs 0-15 run the band (radius 3,
    3, 7, 15 over bucket 64), 20 and 2.5 the full scan, a hint nothing
    else."""
    strings, q, js = corpus
    sc = CorpusScanner(strings, metric=METRIC, bucket=LB, device="cpu")
    dam, other = _spies(monkeypatch)
    jd = np.asarray(js.distances(q))
    d = sc.distances(q)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(d[:40], [oracle.damerau(
        codec.encode_one(q), codec.encode_one(s)) for s in strings[:40]])
    assert dam["full"].calls == 1
    for cut, band in ((0, 1), (3, 1), (7, 1), (15, 1), (20, 0), (2.5, 0)):
        before = dict((k, s.calls) for k, s in dam.items())
        res = sc.distances(q, score_cutoff=cut)
        _same_cut(res, js.distances(q, score_cutoff=cut), cut)
        assert dam["band"].calls - before["band"] == band
        assert dam["full"].calls - before["full"] == 1 - band
        assert res.valid.any() and not res.valid.all()
    np.testing.assert_array_equal(sc.distances(q, score_hint=2), jd)
    for k, cut in ((10, None), (4, 3)):
        vals, ids = sc.topk(q, k, score_cutoff=cut)
        jvals, _ = js.topk(q, k, score_cutoff=cut)
        dd = jd if cut is None else np.where(jd <= cut, jd, np.inf)
        np.testing.assert_array_equal(ids, np.lexsort(
            (np.arange(dd.size), dd))[:k])
        np.testing.assert_array_equal(vals, np.asarray(jvals))
    # the duplicate rows tie at 0: by corpus index
    vals, ids = sc.topk(strings[3], 4)
    assert ids.tolist() == [3, N - 6, N - 5, N - 4] and not vals.any()
    assert all(s.calls == 0 for s in other)


def test_wide_corpus_remap(monkeypatch):
    """A Cyrillic corpus: K2's per-query remap, then K9's full and banded
    forms on the query-local ids, equal to the JAX scanner on the
    codepoints (the bucket-64 corpus's shapes: the same XLA compile)."""
    rng = np.random.default_rng(3)
    alph = [chr(c) for c in range(0x430, 0x436)] + ["я", " "]
    q = "".join(rng.choice(alph, 24))
    strings = _near(rng, q, alph, N, LB)
    strings[7] = q[::-1]
    sc = CorpusScanner(strings, metric=METRIC, bucket=LB, device="cpu")
    js = _jax(strings, LB)
    assert sc._wide
    remap = Spy(monkeypatch, lk, "remap_pack")
    dam, other = _spies(monkeypatch)
    np.testing.assert_array_equal(sc.distances(q), np.asarray(js.distances(q)))
    _same_cut(sc.distances(q, score_cutoff=3),
              js.distances(q, score_cutoff=3), 3)
    assert remap.calls == 2 and dam["full"].calls == dam["band"].calls == 1
    assert all(s.calls == 0 for s in other)


def test_long_bucket_and_empty_strings(monkeypatch):
    """A bucket of 1,100 chars (over 1,024, not whole 512-char chunks):
    the full form for no cutoff and cutoff 16, the band for cutoff 15
    (the JAX scanner's long rule: integer cutoffs 0-15), an empty query
    (every length) and empty candidates (the query's length)."""
    rng = np.random.default_rng(1100)
    alph = list("abc")
    q = "".join(rng.choice(alph, 30))
    strings = _near(rng, q, alph, 18, 60)
    strings += ["", "z" * 1100, "".join(rng.choice(alph, 700)), q * 36]
    sc = CorpusScanner(strings, metric=METRIC, bucket=1100, device="cpu")
    js = _jax(strings, 1100)
    assert sc._long and not sc._stream
    dam, other = _spies(monkeypatch)
    jd = np.asarray(js.distances(q))
    np.testing.assert_array_equal(sc.distances(q), jd)
    assert jd[18] == len(q) and jd[19] == 1100
    for cut, band in ((15, 1), (16, 0)):
        _same_cut(sc.distances(q, score_cutoff=cut),
                  js.distances(q, score_cutoff=cut), cut)
    assert dam["band"].calls == 1 and dam["full"].calls == 2
    lens = np.array([len(s) for s in strings])
    np.testing.assert_array_equal(sc.distances(""), lens)
    np.testing.assert_array_equal(np.asarray(js.distances("")), lens)
    assert all(s.calls == 0 for s in other)


def test_scan_many_and_checkpoint(corpus, tmp_path, monkeypatch):
    """``scan_many`` runs one query per launch (Damerau has no grouped
    launch, as in the JAX scanner), equal to the JAX scanner's scans;
    top-k by (distance, index); a run resumed from a checkpoint equals a
    fresh one; the checkpoint key is the JAX scanner's."""
    strings, q, js = corpus
    queries = [q, q[:20], "", q[::-1], "abcde" * 6]
    sc = CorpusScanner(strings, metric=METRIC, bucket=LB, device="cpu")
    assert not sc._nq_eligible()
    dam, other = _spies(monkeypatch)
    full = sc.scan_many(queries)
    assert dam["full"].calls == len(queries)
    want = np.stack([np.asarray(js.distances(x)) for x in queries])
    np.testing.assert_array_equal(full, want)
    vals, ids = sc.scan_many(queries, k=3)
    top = np.stack([np.lexsort((np.arange(N), w))[:3] for w in want])
    np.testing.assert_array_equal(ids, top)
    np.testing.assert_array_equal(vals, np.take_along_axis(want, top, 1))
    path = str(tmp_path / "ck.npz")
    part = sc.scan_many(queries, checkpoint_path=path, checkpoint_every=2)
    np.testing.assert_array_equal(part, full)
    before = dam["full"].calls
    again = sc.scan_many(queries, checkpoint_path=path, checkpoint_every=2)
    np.testing.assert_array_equal(again, full)
    assert dam["full"].calls == before
    assert sc._ckpt_fingerprint(queries) == js._ckpt_fingerprint(queries)
    assert all(s.calls == 0 for s in other)


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_metric_damerau():
    """``ScanService(metric="damerau_levenshtein")``: the full warmup runs
    every route but the hint's, and ``/topk``, ``/distances`` (plain and
    under a cutoff), ``/batch`` and ``/reload`` answer what the oracle
    says."""
    corpus = ["ca", "abc", "acb", "bca", "", "abcd", "badc", "cab", "abc",
              "xyz"]
    service = ScanService(corpus, metric=METRIC, bucket=32, device="cpu")
    table = service.warmup(full=True)
    assert "distances_hint" not in table
    assert all(isinstance(v, float) for v in table.values()), table

    def row(q, strings):
        return np.array([oracle.damerau(codec.encode_one(q),
                                        codec.encode_one(s))
                         for s in strings])

    def top(q, k, strings):
        d = row(q, strings)
        ids = np.lexsort((np.arange(d.size), d))[:k]
        return {"values": d[ids].tolist(), "indices": ids.tolist(),
                "strings": [strings[i] for i in ids]}

    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert _post(port, "/topk", {"query": "abc", "k": 4}) \
            == top("abc", 4, corpus)
        d = row("CA", ["ABC"])
        assert d.tolist() == [2]
        d = row("bac", corpus)
        assert _post(port, "/distances", {"query": "bac"}) \
            == {"values": d.tolist()}
        out = _post(port, "/distances", {"query": "bac", "score_cutoff": 1})
        assert out["valid"] == (d <= 1).tolist()
        assert [v for v, ok_ in zip(out["values"], out["valid"]) if ok_] \
            == d[d <= 1].tolist()
        out = _post(port, "/batch", {"queries": ["abc", "ca"], "k": 2})
        want = [top("abc", 2, corpus), top("ca", 2, corpus)]
        assert out == {key: [w[key] for w in want]
                       for key in ("values", "indices", "strings")}
        new = ["martha", "marhta", "amrtha", ""]
        assert _post(port, "/reload", {"corpus": new}) == {"ok": True,
                                                            "n": 4}
        assert set(service.reload_warmup) == set(table)
        assert _post(port, "/topk", {"query": "martha", "k": 3}) \
            == top("martha", 3, new)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
