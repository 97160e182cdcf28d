"""The port's OSA library API, aligned-pair op, long and wide scanner
routes and server, on the CPU.

Against the JAX package: the ``osa`` 10-function surface with cutoffs and
``Args``, ``BatchComparator``, the ``*_many`` batches under ``SCAN_MIN``
(aligned pairs) and at it (the corpus scan, ``SCAN_MIN`` lowered so it
runs at a small size), and ``ops/osa.osa_distance`` against the XLA
``rapidfuzz_tpu.ops.osa.osa_distance``.  Against the C++ oracle only,
where the JAX route would be a fresh stream compile already held to the
oracle by ``tests/test_pallas.py``: the scanner over a 2048-char bucket
(the streamed route) with swaps planted at text chars 511/512 and
1023/1024, over a long bucket that is not whole 512-char chunks (the
port's own route), and over a wide Cyrillic corpus (K2's remap, then K6
in local mode); and ``ScanService(metric="osa")`` over HTTP.  Integers
must be equal and f64 scores bit-equal.  The kernel itself is held to
its plain version on the card by the ``cuda``-marked test below and by
``chip_smoke.py``.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from rapidfuzz_tpu.distance import osa as josa
from rapidfuzz_tpu.ops import dispatch as jdispatch
from rapidfuzz_tpu.ops import osa as jops
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.distance import _int_metric, osa
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops import dispatch
from rapidfuzz_tpu_torch.ops import osa as ops
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.parallel import scan as scan_mod
from rapidfuzz_tpu_torch.serve import ScanService, make_server
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

PAIRS = [("CA", "ABC"), ("CA", "AC"), ("kitten", "sitting"), ("", "abc"),
         ("abc", ""), ("", ""), ("Иванко", "Петрунко"),
         ("ab" * 16 + "cd", "ab" * 15 + "ba" + "dc"), (b"bytes", b"btyes"),
         ([1, 2, 3, 2 ** 40], [2, 1, 3, 2 ** 40])]
CORPUS = ["sitting", "mitten", "kitten", "", "iktten", "kittne", "a" * 70,
          "kitchen", "Иванко", "k", "kitten", "iktnet"]
SCORES = ("distance", "similarity", "normalized_distance",
          "normalized_similarity")


def _same(res, jres):
    np.testing.assert_array_equal(res.values, jres.values)
    np.testing.assert_array_equal(res.valid, jres.valid)


def _truth(q, corpus):
    e = codec.encode_one(q)
    return np.array([oracle.osa(e, codec.encode_one(s)) for s in corpus])


def test_golden_values():
    """The verify recipe's spot checks: a transposition costs 1, and the
    OSA restriction (no substring edited twice) keeps CA/ABC at 3."""
    assert osa.distance("CA", "ABC") == 3
    assert osa.distance("CA", "AC") == 1
    assert osa.BatchComparator("CA").distances(
        ["ABC", "AC"], device="cpu").values.tolist() == [3, 1]
    e = codec.encode_one
    assert oracle.osa_dp(e("CA"), e("ABC")) == oracle.osa_bp(
        e("CA"), e("ABC")) == 3


def test_surface_matches_jax():
    """The four scores and their ``_with_args`` forms with and without
    cutoffs, ``maximum``, the four ``*_many`` over aligned pairs and one
    query against a corpus, and ``BatchComparator``."""
    for s1, s2 in PAIRS:
        for kind in SCORES:
            f, jf = getattr(osa, kind), getattr(josa, kind)
            assert f(s1, s2) == jf(s1, s2), (kind, s1, s2)
            cuts = ((0, 1, 3) if "normalized" not in kind
                    else (0.0, 0.3, 0.9))
            for c in cuts:
                assert (f(s1, s2, score_cutoff=c)
                        == jf(s1, s2, score_cutoff=c)), (kind, s1, s2, c)
            args = osa.Args().score_cutoff(cuts[1])
            jargs = josa.Args().score_cutoff(cuts[1])
            assert (getattr(osa, kind + "_with_args")(s1, s2, args)
                    == getattr(josa, kind + "_with_args")(s1, s2, jargs))
    assert osa.maximum(6, 7) == josa.maximum(6, 7)
    s1s = [p[0] for p in PAIRS[:8]]
    s2s = [p[1] for p in PAIRS[:8]]
    for kind in SCORES:
        f = getattr(osa, kind + "_many")
        jf = getattr(josa, kind + "_many")
        cut = 0.5 if "normalized" in kind else 2
        _same(f(s1s, s2s, device="cpu"), jf(s1s, s2s))
        _same(f(["kitten"], CORPUS, score_cutoff=cut, device="cpu"),
              jf(["kitten"], CORPUS, score_cutoff=cut))
    bc, jbc = osa.BatchComparator("kitten"), josa.BatchComparator("kitten")
    for meth in ("distances", "similarities", "normalized_distances",
                 "normalized_similarities"):
        _same(getattr(bc, meth)(CORPUS, device="cpu"),
              getattr(jbc, meth)(CORPUS))
    for kind in SCORES:
        assert getattr(bc, kind)("iktten") == getattr(jbc, kind)("iktten")
    assert bc.distance_with_args("iktten", osa.Args().score_cutoff(0)) \
        == jbc.distance_with_args("iktten", josa.Args().score_cutoff(0))


def test_aligned_pairs_match_xla():
    """``ops/osa.osa_distance`` against the XLA ``osa_distance`` over
    padded pairs of one- and two-word patterns: swaps across pattern bits
    31/32 and at position 0, NUL chars, empty patterns and texts, texts
    longer than their patterns; the values also equal the oracle's."""
    rng = np.random.default_rng(4)
    alpha = [0, 97, 98, 99]
    s1s, s2s = [], []
    for la in (0, 5, 31, 32, 33, 40, 64):
        for _ in range(6):
            a = rng.choice(alpha, la)
            b = a.copy()
            for p in rng.integers(0, max(1, la - 1), 2):
                if la >= 2:
                    b[p], b[p + 1] = b[p + 1], b[p]
            if la >= 33:
                b[31], b[32] = a[32], a[31]
            if rng.random() < 0.5:
                b = np.r_[b, rng.choice(alpha, int(rng.integers(0, 30)))]
            s1s.append(a.tolist())
            s2s.append(b.tolist())
    s1s.append([])
    s2s.append(rng.choice(alpha, 9).tolist())
    c1, l1, c2, l2 = codec.encode_pair_batch(s1s, s2s)
    got = dispatch.run_pairs(ops.osa_distance, c1, l1, c2, l2, device="cpu")
    ref = jdispatch.run_pairs(jops.osa_distance, c1, l1, c2, l2)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, [oracle.osa(a, b) for a, b in zip(s1s, s2s)])
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.osa_distance(torch.zeros((1, 40), dtype=torch.int32),
                         torch.tensor([3]), torch.zeros((1, 8),
                                                        dtype=torch.int32),
                         torch.tensor([3]))


def test_scan_route_at_scan_min(monkeypatch):
    """With ``SCAN_MIN`` lowered, one query against a corpus goes through
    the port's scanner and its OSA wrapper and returns what the JAX
    package returns (aligned pairs there); with no ``device`` the batch
    entry points want the card."""
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    real = scan_mod.CorpusScanner
    built = []

    def spy(*a, **kw):
        built.append(kw["metric"])
        return real(*a, **kw)

    monkeypatch.setattr(scan_mod, "CorpusScanner", spy)
    full = Spy(monkeypatch, ok, "osa_1v_many")
    _same(osa.distance_many(["kitten"], CORPUS, score_cutoff=2,
                            device="cpu"),
          josa.distance_many(["kitten"], CORPUS, score_cutoff=2))
    _same(osa.BatchComparator("kittens").normalized_similarities(
        CORPUS, device="cpu"),
        josa.BatchComparator("kittens").normalized_similarities(CORPUS))
    assert built == ["osa", "osa"] and full.calls == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        osa.distance_many(["kitten"], CORPUS)


def _planted(rng, q, at, swap, n_text):
    """A text of ``n_text`` chars none of which is in ``q``, holding ``q``
    at ``at`` with the query chars ``swap``, ``swap + 1`` exchanged."""
    t = list(rng.choice(list("!#$%&*"), n_text))
    s = list(q)
    s[swap], s[swap + 1] = s[swap + 1], s[swap]
    t[at: at + len(s)] = s
    return "".join(t)


def _spy_names(mp):
    """Launch names K6's wrapper passes on (counted on the card)."""
    real, names = ok._osa_scan, []

    def spy(las, tabs, cand, lb, name):
        names.append(name)
        return real(las, tabs, cand, lb, name)

    mp.setattr(ok, "_osa_scan", spy)
    return names


def test_long_buckets_against_oracle(monkeypatch):
    """A 2048-char bucket (whole 512-char chunks: the JAX scanner's
    streamed route) holding the query with swaps planted at text chars
    511/512 and 1023/1024, and a 1100-char bucket (not whole chunks: the
    port's own route) holding a two-word query with swaps at 1023/1024
    and across its bits 31/32; distances, a cutoff and top-k equal the
    oracle, the planted rows beat Levenshtein, and every scan is one
    ``osa_scan_long`` launch."""
    rng = np.random.default_rng(9)
    names = _spy_names(monkeypatch)
    # distinct chars, so that every swap changes the text
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789ABCD")
    q = "".join(rng.permutation(letters)[:24])
    texts = ["".join(rng.choice(list("abcdefgh"), int(n)))
             for n in rng.integers(0, 2049, 24)]
    texts += [_planted(rng, q, 500, 11, 2048),
              _planted(rng, q, 1012, 11, 1700), q, "", q[::-1]]
    sc = CorpusScanner(texts, metric="osa", bucket=2048, device="cpu")
    assert sc._stream and not sc._nq_eligible()
    truth = _truth(q, texts)
    np.testing.assert_array_equal(sc.distances(q), truth)
    lev = [oracle.levenshtein_uniform(codec.encode_one(q),
                                      codec.encode_one(t))
           for t in texts[24:26]]
    assert (truth[24:26] == np.array([2048, 1700]) - 23).all()
    assert (truth[24:26] < lev).all()
    assert names == ["osa_scan_long"]
    q2 = "".join(rng.permutation(letters))
    odd = [t[:1100] for t in texts[:20]] + [_planted(rng, q2, 1000, 23, 1100),
                        _planted(rng, q2[:31] + q2[32] + q2[31] + q2[33:],
                                 1050, 0, 1100), q2]
    so = CorpusScanner(odd, metric="osa", bucket=1100, device="cpu")
    assert so._long and not so._stream
    t2 = _truth(q2, odd)
    res = so.distances(q2, score_cutoff=1100 - 39)
    np.testing.assert_array_equal(res.values, t2)
    np.testing.assert_array_equal(res.valid, t2 <= 1100 - 39)
    assert t2[20] == 1100 - 39 and t2[21] == 1100 - 38
    vals, ids = so.topk(q2, 3)
    want = np.lexsort((np.arange(t2.size), t2))[:3]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(vals, t2[want])
    assert names[1:] == ["osa_scan_long"] * 2


def test_wide_corpus_remap():
    """A Cyrillic corpus (chars >= 256): each query remaps the corpus to
    query-local ids (K2's plain version here) and scans it in local mode;
    distances, a cutoff and top-k equal the oracle."""
    rng = np.random.default_rng(11)
    letters = [chr(c) for c in range(0x430, 0x450)]
    q = "".join(rng.permutation(letters)[:30])      # distinct chars
    corpus = ["".join(rng.choice(letters, int(n)))
              for n in rng.integers(0, 48, 40)]
    for p in (0, 14, 28):
        corpus.append(q[:p] + q[p + 1] + q[p] + q[p + 2:])
    corpus += [q, "", "кошка"]
    sc = CorpusScanner(corpus, metric="osa", bucket=48, device="cpu")
    assert sc._wide
    with pytest.MonkeyPatch.context() as mp:
        remap = Spy(mp, lk, "remap_pack")
        full = Spy(mp, ok, "osa_1v_many")
        d = sc.distances(q)
        vals, ids = sc.topk(q, 4)
        assert remap.calls == full.calls == 2
    truth = _truth(q, corpus)
    np.testing.assert_array_equal(d, truth)
    assert (truth[40:43] == 1).all()
    want = np.lexsort((np.arange(truth.size), truth))[:4]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(vals, truth[want])
    res = sc.distances(q, score_cutoff=1)
    np.testing.assert_array_equal(res.valid, truth <= 1)


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_metric_osa():
    """``ScanService(metric="osa")``: the full warmup runs every OSA route
    (no hint route, as the JAX server), and the HTTP answers of
    ``/topk``, ``/distances`` (plain and under a cutoff) and ``/batch``
    equal the JAX package's OSA distances, top-k by (distance, index)."""
    service = ScanService(CORPUS, metric="osa", bucket=96, device="cpu")
    table = service.warmup(full=True)
    assert "distances_hint" not in table
    assert all(isinstance(v, float) for v in table.values()), table

    def jrow(q):
        return np.array([josa.distance(q, s) for s in CORPUS])

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
        assert _post(port, "/topk", {"query": "kitten", "k": 4}) \
            == jtop("kitten", 4)
        d = jrow("iktten")
        assert _post(port, "/distances", {"query": "iktten"}) \
            == {"values": d.tolist()}
        assert _post(port, "/distances", {"query": "iktten",
                                          "score_cutoff": 1}) \
            == {"values": d.tolist(), "valid": (d <= 1).tolist()}
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


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["osa_scan", "osa_scan_nq",
                                    "osa_scan_long"])
def test_osa_kernel_matches_plain_on_card(cuda_device, kernel):
    """Each K6 launch route equals its plain PyTorch version on the card
    and moves its launch counter."""
    rng = np.random.default_rng(11)
    a = np.r_[0, 97, 98, 99, 200, 255]
    q = rng.choice(a, 56)
    lb_max = 1536 if kernel.endswith("_long") else 260
    lens = rng.integers(0, lb_max + 1, 4096).astype(np.int32)
    chars = rng.choice(a, (4096, lb_max)).astype(np.int32)
    chars[:64, :56] = q
    chars[:64, 31], chars[:64, 32] = q[32], q[31]
    chars[np.arange(lb_max)[None, :] >= lens[:, None]] = -1
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    qs = [q] * 15 + [q[:40]] if kernel == "osa_scan_nq" else [q]
    las, tabs = lk.stage_queries(qs, "byte", cuda_device)
    before = kc.LAUNCHES[kernel]
    got = (ok.osa_nq_many(qs, cand, lb) if kernel == "osa_scan_nq"
           else ok.osa_1v_many(q, cand, lb)[None])
    ref = ok.osa_scan_plain(las, tabs, cand, lb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kc.LAUNCHES[kernel] == before + 1
