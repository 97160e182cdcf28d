"""The port's Jaro and Jaro-Winkler library API, aligned-pair op, long and
wide scanner routes and server, on the CPU.

Against the JAX package: the reference's 20x20 golden matrix, the
``jaro`` and ``jaro_winkler`` surfaces (scalars with cutoffs, ``Args``
with ``prefix_weight``, ``BatchComparator``, the ``*_many`` batches over
aligned pairs), ``ops/jaro.jaro_components`` against the XLA
``rapidfuzz_tpu.ops.jaro.jaro_components``, and the batches at
``SCAN_MIN`` (the corpus scan, ``SCAN_MIN`` lowered so it runs at a small
size) against the JAX scanner's ``1.0 - d``.  Against the C++ oracle
only: the scanner over a 2048-char bucket (the JAX scanner's streamed
route) and over a bucket of more than 16,384 chars (which the JAX scanner
leaves to XLA), with one- and ten-word queries; a wide Cyrillic corpus
(K2's remap, then K8 in local mode, the Winkler prefix on the original
chars); and ``ScanService(metric="jaro_winkler")`` over HTTP, ``/reload``
included.  Every f64 value must be bit-equal.  The kernel itself is held
to its plain version on the card by the ``cuda``-marked test below and
by ``chip_smoke.py``.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from data_jaro_golden import NAMES, SCORES
from rapidfuzz_tpu.distance import jaro as jjaro
from rapidfuzz_tpu.distance import jaro_winkler as jjw
from rapidfuzz_tpu.ops import dispatch as jdispatch
from rapidfuzz_tpu.ops import jaro as jops
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.distance import _int_metric, jaro, jaro_winkler
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops import dispatch
from rapidfuzz_tpu_torch.ops import jaro as ops
from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel as jk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.parallel import scan as scan_mod
from rapidfuzz_tpu_torch.serve import ScanService, make_server
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

PAIRS = [("martha", "marhta"), ("dwayne", "duane"), ("dixon", "dicksonx"),
         ("", "abc"), ("abc", ""), ("", ""), ("a", "a"), ("a", "b"),
         ("Иванко", "Иванов"), ("ab" * 20, "ba" * 20),
         (b"bytes", b"btyes"), ([1, 2, 3, 2 ** 40], [2, 1, 3, 2 ** 40])]
CORPUS = ["marhta", "martha", "", "mart", "m", "amrtha", "martha",
          "marthaxyzw", "Марта", "hatram", "ma", "matrha"]
SCORES4 = ("distance", "similarity", "normalized_distance",
           "normalized_similarity")
MODULES = ((jaro, jjaro, {}), (jaro_winkler, jjw, {"prefix_weight": 0.25}))


def _same(res, jres):
    np.testing.assert_array_equal(res.values, jres.values)
    np.testing.assert_array_equal(res.valid, jres.valid)


def _truth(q, corpus, pw=None):
    """Oracle similarities (Jaro-Winkler at ``pw`` when given)."""
    e = codec.encode_one(q)
    if pw is None:
        return np.array([oracle.jaro(e, codec.encode_one(s)) for s in corpus])
    return np.array([oracle.jaro_winkler(e, codec.encode_one(s), pw)
                     for s in corpus])


def test_golden_values():
    """The reference's golden matrix through the scalars and one aligned
    batch (within the matrix's six decimals), the verify recipe's spot
    checks, and the aligned batch equal to the scalar oracle bit for
    bit."""
    n = len(NAMES)
    qs = [a for a in NAMES for _ in NAMES]
    cs = [b for _ in NAMES for b in NAMES]
    got = jaro.similarity_many(qs, cs, device="cpu").values
    scal = np.array([jaro.similarity(a, b) for a, b in zip(qs, cs)])
    np.testing.assert_allclose(got, SCORES, atol=1e-6)
    np.testing.assert_array_equal(got, scal)
    assert got.reshape(n, n)[19, 19] == 1.0
    assert round(jaro.similarity("martha", "marhta"), 4) == 0.9444
    assert round(jaro_winkler.similarity("martha", "marhta"), 4) == 0.9611
    assert round(jaro_winkler.similarity("martha", "marhta",
                                         prefix_weight=0.2), 4) == 0.9778


def test_surface_matches_jax():
    """The four scores and their ``_with_args`` forms with and without
    cutoffs (``None`` where the cutoff rejects), ``Args.prefix_weight``,
    ``maximum``, the four ``*_many`` over aligned pairs and one query
    against a short corpus, and ``BatchComparator``, for both modules."""
    for mod, jmod, kw in MODULES:
        for s1, s2 in PAIRS:
            for kind in SCORES4:
                f, jf = getattr(mod, kind), getattr(jmod, kind)
                assert f(s1, s2, **kw) == jf(s1, s2, **kw), (kind, s1, s2)
                for c in (0.0, 0.1, 0.5, 0.9, 1.0):
                    assert (f(s1, s2, score_cutoff=c, **kw)
                            == jf(s1, s2, score_cutoff=c, **kw))
        args, jargs = mod.Args().score_cutoff(0.9), jmod.Args().score_cutoff(
            0.9)
        if kw:
            args, jargs = args.prefix_weight(0.25), jargs.prefix_weight(0.25)
            assert args.prefix_weight_ == 0.25 and \
                mod.Args().prefix_weight_ == 0.1
        for kind in SCORES4:
            for s1, s2 in PAIRS[:3]:
                assert (getattr(mod, kind + "_with_args")(s1, s2, args)
                        == getattr(jmod, kind + "_with_args")(s1, s2, jargs))
        assert mod.maximum(6, 7) == jmod.maximum(6, 7) == 1.0
        s1s = [p[0] for p in PAIRS[:10]]
        s2s = [p[1] for p in PAIRS[:10]]
        for kind in SCORES4:
            f, jf = getattr(mod, kind + "_many"), getattr(jmod, kind + "_many")
            _same(f(s1s, s2s, device="cpu", **kw), jf(s1s, s2s, **kw))
            _same(f(["martha"], CORPUS, score_cutoff=0.2, device="cpu", **kw),
                  jf(["martha"], CORPUS, score_cutoff=0.2, **kw))
        bc = mod.BatchComparator("martha", **kw)
        jbc = jmod.BatchComparator("martha", **kw)
        for meth in ("distances", "similarities", "normalized_distances",
                     "normalized_similarities"):
            _same(getattr(bc, meth)(CORPUS, device="cpu"),
                  getattr(jbc, meth)(CORPUS))
        for kind in SCORES4:
            assert getattr(bc, kind)("amrtha") == getattr(jbc, kind)("amrtha")
        assert bc.similarity_with_args("amrtha", args) \
            == jbc.similarity_with_args("amrtha", jargs)
        assert bc.similarity("amrtha", score_cutoff=0.99) is None


def test_aligned_pairs_match_xla():
    """``ops/jaro.jaro_components`` against the XLA ``jaro_components``
    over padded pairs: common prefixes, both truncations, one- and
    two-word patterns with chars 31/32 swapped, NUL chars, repeated
    chars, empty patterns and texts; the similarities equal the oracle."""
    rng = np.random.default_rng(4)
    alpha = [0, 97, 98, 99]
    s1s, s2s = [], []
    for la in (0, 1, 5, 31, 33, 40, 64):
        for _ in range(5):
            a = rng.choice(alpha, la)
            b = a.copy()
            if la >= 33:
                b[31], b[32] = a[32], a[31]
            b[rng.random(la) < 0.2] = 98
            cut = int(rng.integers(0, 3))
            b = [b, b[: max(1, la // 4)],
                 np.r_[b, rng.choice(alpha, 3 * la + 2)]][cut]
            s1s.append(a.tolist())
            s2s.append(np.asarray(b).tolist())
    s1s += [[], [97] * 6]
    s2s += [rng.choice(alpha, 9).tolist(), [98, 97, 97]]
    c1, l1, c2, l2 = codec.encode_pair_batch(s1s, s2s)
    got = dispatch.run_pairs(ops.jaro_components, c1, l1, c2, l2,
                             device="cpu")
    fn = jdispatch.jit_kernel(jops.jaro_components)
    ref = np.stack([np.asarray(x) for x in fn(c1, l1, c2, l2)])
    np.testing.assert_array_equal(got, ref)
    sim = jaro.sim_from_components(got[0], got[1], l1, l2)
    np.testing.assert_array_equal(
        sim, [oracle.jaro(a, b) for a, b in zip(s1s, s2s)])


def test_scan_route_at_scan_min(monkeypatch):
    """At ``SCAN_MIN`` (lowered) one query against a corpus goes through
    the port's scanner and K8's wrapper and returns ``1.0 - d`` bit for
    bit with the JAX scanner's distances (as the JAX package's scan route
    does); one string fewer takes the aligned pairs; with no ``device``
    the batch entry points want the card."""
    from jax.sharding import Mesh
    import jax

    from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner

    monkeypatch.setattr(_int_metric, "SCAN_MIN", 64)
    rng = np.random.default_rng(7)
    corpus = ["".join(rng.choice(list("martha "), int(n)))
              for n in rng.integers(0, 12, 62)] + CORPUS[:2]
    real = scan_mod.CorpusScanner
    built = []

    def spy(*a, **kw):
        built.append((kw["metric"], kw["prefix_weight"]))
        return real(*a, **kw)

    monkeypatch.setattr(scan_mod, "CorpusScanner", spy)
    full = Spy(monkeypatch, jk, "jaro_1v_many")
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    for mod, metric, kw in ((jaro, "jaro", {}),
                            (jaro_winkler, "jaro_winkler",
                             {"prefix_weight": 0.25})):
        js = JaxScanner(corpus, metric=metric, mesh=mesh,
                        prefix_weight=kw.get("prefix_weight", 0.1))
        jd = np.asarray(js.distances("martha"))
        res = mod.similarity_many(["martha"], corpus, score_cutoff=0.7,
                                  device="cpu", **kw)
        np.testing.assert_array_equal(res.values, 1.0 - jd)
        np.testing.assert_array_equal(res.valid, 1.0 - jd >= 0.7)
        bc = mod.BatchComparator("martha", **kw)
        np.testing.assert_array_equal(
            bc.distances(corpus, device="cpu").values, 1.0 - (1.0 - jd))
        np.testing.assert_array_equal(
            bc.similarities(corpus[:-1], device="cpu").values,
            _truth("martha", corpus[:-1], kw.get("prefix_weight")))
    assert built == [("jaro", 0.1), ("jaro", 0.1), ("jaro_winkler", 0.25),
                     ("jaro_winkler", 0.25)] and full.calls == 4
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jaro.distance_many(["martha"], corpus)


def _spy_names(mp):
    """Launch names K8's wrapper passes on (counted on the card)."""
    real, names = jk._jaro_scan, []

    def spy(las, tabs, cand, lb, name):
        names.append(name)
        return real(las, tabs, cand, lb, name)

    mp.setattr(jk, "_jaro_scan", spy)
    return names


def test_long_buckets_against_oracle(monkeypatch):
    """A 2048-char bucket (whole 512-char chunks: the JAX scanner's
    streamed route) with a 40-char query and a 300-char one (K8's scratch
    form) planted in long texts, and a 16,400-char bucket (past the JAX
    stream cap of 16,384: its XLA route) with the 40-char query:
    distances, a cutoff and top-k
    equal the oracle's Jaro-Winkler, each scan one ``jaro_scan_long``
    launch."""
    rng = np.random.default_rng(9)
    names = _spy_names(monkeypatch)
    letters = list("abcdefgh")
    q40 = "".join(rng.choice(letters, 40))
    q300 = "".join(rng.choice(letters, 300))
    for LB, nt, qs in ((2048, 20, (q40, q300)), (16400, 8, (q40,))):
        texts = ["".join(rng.choice(letters, int(n)))
                 for n in rng.integers(0, LB + 1, nt)]
        texts += [q40 + texts[0][40:], q300[:150] + "x" + q300[151:],
                  q300 + "".join(rng.choice(letters, LB - 300)), q40, ""]
        sc = CorpusScanner(texts, metric="jaro_winkler", bucket=LB,
                           device="cpu")
        assert sc._long and sc._stream == (LB == 2048)
        for q in qs:
            truth = 1.0 - _truth(q, texts, 0.1)
            np.testing.assert_array_equal(sc.distances(q), truth)
            res = sc.distances(q, score_cutoff=0.2)
            np.testing.assert_array_equal(res.valid, truth <= 0.2)
            assert res.valid.any()
        vals, ids = sc.topk(qs[-1], 3)
        want = np.lexsort((np.arange(truth.size), truth))[:3]
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(vals, truth[want])
    assert names == ["jaro_scan_long"] * 8


def test_wide_corpus_winkler_prefix():
    """A Cyrillic corpus (chars >= 256): each query remaps the corpus to
    query-local ids (K2's plain version here) and scans it in local mode;
    the Winkler prefix compares the original chars, so rows sharing the
    query's first 4 chars are boosted, and every distance equals the
    oracle."""
    rng = np.random.default_rng(11)
    letters = [chr(c) for c in range(0x430, 0x450)]
    q = "".join(rng.permutation(letters)[:12])
    corpus = ["".join(rng.choice(letters, int(n)))
              for n in rng.integers(0, 20, 30)]
    corpus += [q[:4] + q[5:], q[1:], q, "", q[:2] + q[3] + q[2] + q[4:]]
    sc = CorpusScanner(corpus, metric="jaro_winkler", bucket=20,
                       device="cpu", prefix_weight=0.2)
    assert sc._wide
    with pytest.MonkeyPatch.context() as mp:
        remap = Spy(mp, lk, "remap_pack")
        full = Spy(mp, jk, "jaro_1v_many")
        d = sc.distances(q)
        vals, ids = sc.topk(q, 3)
        assert remap.calls == full.calls == 2
    truth = 1.0 - _truth(q, corpus, 0.2)
    np.testing.assert_array_equal(d, truth)
    jaro_d = 1.0 - _truth(q, corpus)
    assert d[30] < jaro_d[30] and d[31] == jaro_d[31]
    want = np.lexsort((np.arange(truth.size), truth))[:3]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(vals, truth[want])


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_metric_jaro_winkler():
    """``ScanService(metric="jaro_winkler", prefix_weight=0.25)``: the
    full warmup runs every route (no hint route), and the HTTP answers of
    ``/topk``, ``/distances`` (plain and under a cutoff) and ``/batch``
    equal the JAX package's f64 distances, top-k by (distance, index),
    before and after a ``/reload`` to another corpus."""
    service = ScanService(CORPUS, metric="jaro_winkler", bucket=32,
                          device="cpu", prefix_weight=0.25)
    table = service.warmup(full=True)
    assert "distances_hint" not in table
    assert all(isinstance(v, float) for v in table.values()), table

    def jrow(q, corpus):
        return np.array([jjw.distance(q, s, prefix_weight=0.25)
                         for s in corpus])

    def jtop(q, k, corpus):
        d = jrow(q, corpus)
        ids = np.lexsort((np.arange(d.size), d))[:k]
        return {"values": d[ids].tolist(), "indices": ids.tolist(),
                "strings": [corpus[i] for i in ids]}

    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert _post(port, "/topk", {"query": "martha", "k": 4}) \
            == jtop("martha", 4, CORPUS)
        d = jrow("amrtha", CORPUS)
        assert _post(port, "/distances", {"query": "amrtha"}) \
            == {"values": d.tolist()}
        assert _post(port, "/distances", {"query": "amrtha",
                                          "score_cutoff": 0.1}) \
            == {"values": d.tolist(), "valid": (d <= 0.1).tolist()}
        out = _post(port, "/batch", {"queries": ["martha", "mart"], "k": 2})
        want = [jtop("martha", 2, CORPUS), jtop("mart", 2, CORPUS)]
        assert out == {key: [w[key] for w in want]
                       for key in ("values", "indices", "strings")}
        new = ["dwayne", "duane", "dixon", "dicksonx", "martha"]
        assert _post(port, "/reload", {"corpus": new}) == {"ok": True,
                                                            "n": 5}
        assert set(service.reload_warmup) == set(table)
        assert _post(port, "/topk", {"query": "dwayne", "k": 3}) \
            == jtop("dwayne", 3, new)
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
@pytest.mark.parametrize("kernel,la", [("jaro_scan", 56),
                                       ("jaro_scan", 300),
                                       ("jaro_scan_nq", 56),
                                       ("jaro_scan_long", 56)])
def test_jaro_kernel_matches_plain_on_card(cuda_device, kernel, la):
    """Each K8 launch route, in register and scratch form, equals its
    plain PyTorch version on the card and moves its launch counter."""
    rng = np.random.default_rng(11)
    a = np.r_[0, 97, 98, 99, 200, 255]
    q = rng.choice(a, la)
    lb_max = 1536 if kernel.endswith("_long") else 320
    lens = rng.integers(0, lb_max + 1, 4096).astype(np.int32)
    chars = rng.choice(a, (4096, lb_max)).astype(np.int32)
    chars[:64, :la] = q
    chars[:64, 31], chars[:64, 32] = q[32], q[31]
    chars[np.arange(lb_max)[None, :] >= lens[:, None]] = -1
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    qs = [q] * 15 + [q[:40]] if kernel == "jaro_scan_nq" else [q]
    las, tabs = lk.stage_queries(qs, "byte", cuda_device)
    before = kc.LAUNCHES[kernel]
    got = (jk.jaro_nq_many(qs, cand, lb) if kernel == "jaro_scan_nq"
           else [x[None] for x in jk.jaro_1v_many(q, cand, lb)])
    ref = jk.jaro_scan_plain(las, tabs, cand, lb)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kc.LAUNCHES[kernel] == before + 1
