"""The port's weighted Levenshtein library batches, long and wide scanner
routes and server, on the CPU.

Against the JAX package: the library's one-vs-many batches under a
general table (``distance_many`` with a cutoff, the other ``*_many``,
``BatchComparator``) with ``SCAN_MIN`` lowered so that the port's scanner
serves them at a small size, and a table whose int32 cells could
overflow, which the port's library answers through its int64 aligned
pairs (the JAX library through its host oracle) while both scanners
raise the JAX wrapper's ``ValueError``.  Against the C++ oracle only,
where the JAX route would be a fresh streamed or XLA compile (its
streamed route takes about 7 s on an 8-core CPU; ``tests/test_pallas.py``
holds it to the oracle): the scanner over a 1536-char bucket (the JAX scanner's
streamed route for a 40-char query, its XLA route past 256 chars), over
a 1100-char bucket (not whole 512-char chunks: XLA there, the port's own
route), with a 300-char query past the kernel's register form, and over a
wide Cyrillic corpus (K2's remap, then K7 in local mode); and a weighted
``ScanService`` over HTTP with ``/reload``.  Integers must be equal and
f64 scores bit-equal.  The kernel itself is held to its plain version on
the card by the ``cuda``-marked test below and by ``chip_smoke.py``.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from rapidfuzz_tpu.distance import levenshtein as jlev
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.distance import _int_metric
from rapidfuzz_tpu_torch.distance import levenshtein as lev
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel as wk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.parallel import scan as scan_mod
from rapidfuzz_tpu_torch.serve import ScanService, make_server
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

W = (1, 2, 3)
CORPUS = ["sitting", "mitten", "kitten", "", "kittenkitten", "sitt",
          "a" * 70, "kitchen", "Иванко", "k", "nettik"]


def _same(res, jres):
    np.testing.assert_array_equal(res.values, jres.values)
    np.testing.assert_array_equal(res.valid, jres.valid)


def _truth(q, corpus, w=W):
    e = codec.encode_one(q)
    return np.array([oracle.levenshtein_weighted(e, codec.encode_one(s), *w)
                     for s in corpus])


def test_golden_values():
    """The verify recipe's weighted spot checks, from the oracle:
    kitten -> sitting costs 7 under (1, 2, 3) (two substitutions and an
    insertion) and 5 under (3, 2, 1); the other way round 8 under
    (1, 2, 3)."""
    e = codec.encode_one
    assert oracle.levenshtein_weighted(e("kitten"), e("sitting"), 1, 2, 3) \
        == lev.distance("kitten", "sitting", weights=(1, 2, 3)) == 7
    assert lev.distance("kitten", "sitting", weights=(3, 2, 1)) == 5
    assert lev.distance("sitting", "kitten", weights=(1, 2, 3)) == 8


def test_library_batches_take_the_scanner(monkeypatch):
    """With ``SCAN_MIN`` lowered, one query against a corpus under a
    general table builds the port's scanner and runs the weighted kernel's
    wrapper, and every batch entry point returns what the JAX module
    returns."""
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    built = []
    real = scan_mod.CorpusScanner

    def spy(*a, **kw):
        built.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(scan_mod, "CorpusScanner", spy)
    wlev = Spy(monkeypatch, wk, "wlev_1v_many")
    _same(lev.distance_many(["kitten"], CORPUS, weights=W, score_cutoff=5,
                            device="cpu"),
          jlev.distance_many(["kitten"], CORPUS, weights=W, score_cutoff=5))
    for kind, cut in (("similarity", 20), ("normalized_distance", 0.4),
                      ("normalized_similarity", 0.6)):
        _same(getattr(lev, kind + "_many")(["kitten"], CORPUS, weights=W,
                                           score_cutoff=cut, device="cpu"),
              getattr(jlev, kind + "_many")(["kitten"], CORPUS, weights=W,
                                            score_cutoff=cut))
    bc = lev.BatchComparator("kitten", lev.WeightTable(*W))
    jbc = jlev.BatchComparator("kitten", jlev.WeightTable(*W))
    _same(bc.distances(CORPUS, device="cpu"), jbc.distances(CORPUS))
    _same(bc.normalized_similarities(CORPUS, device="cpu"),
          jbc.normalized_similarities(CORPUS))
    assert len(built) == wlev.calls == 6
    assert all(kw["weights"] == W for kw in built)
    np.testing.assert_array_equal(
        bc.distances(CORPUS, device="cpu").values, _truth("kitten", CORPUS))


def test_overflow_table(monkeypatch):
    """A table whose int32 cells could overflow at the corpus's bucket
    (``2**26 * 96 >= 2**31``): the library answers from its int64 aligned
    pairs, equal to the JAX library and the oracle, without building a
    scanner; both scanners raise the JAX wrapper's ``ValueError``."""
    big = (2 ** 26, 1, 3)
    monkeypatch.setattr(_int_metric, "SCAN_MIN", 4)
    monkeypatch.setattr(scan_mod, "CorpusScanner", None)
    res = lev.distance_many(["kitten"], CORPUS, weights=big, device="cpu")
    _same(res, jlev.distance_many(["kitten"], CORPUS, weights=big))
    np.testing.assert_array_equal(res.values, _truth("kitten", CORPUS, big))
    assert res.values.max() >= 2 ** 32
    monkeypatch.undo()
    # (no wide chars, so that the JAX scanner compiles no remap kernel)
    narrow = [s for s in CORPUS if s != "Иванко"]
    with pytest.raises(ValueError, match="weight table too large"):
        CorpusScanner(narrow, weights=big, device="cpu").distances("kitten")
    monkeypatch.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
    js = JaxScanner(narrow, weights=big,
                    mesh=Mesh(np.array(jax.devices("cpu")[:1]), ("data",)))
    with pytest.raises(ValueError, match="weight table too large"):
        js.distances("kitten")


def _doc_corpus(rng, doc, n, lb_max):
    """Near copies of ``doc`` cut to random lengths up to ``lb_max``, with
    a few substitutions, plus the edge lengths."""
    out = []
    for length in rng.integers(0, lb_max + 1, n):
        s = list(doc[:length])
        for p in rng.integers(0, max(1, len(s)), 4):
            if s:
                s[int(p) % len(s)] = str(rng.choice(list("abcdef")))
        out.append("".join(s))
    return out + ["", doc[:lb_max], doc[:40], doc[:300]]


@pytest.mark.parametrize("bucket", [1536, 1100])
def test_long_buckets_match_oracle(bucket):
    """A 40- and a 300-char query (past the register form) over a
    1536-char bucket (whole 512-char chunks) and a 1100-char one:
    distances and top-k under (1, 2, 3), a cutoff mask under (3, 2, 1),
    each one weighted scan."""
    rng = np.random.default_rng(bucket)
    doc = "".join(rng.choice(list("abcdef"), bucket))
    corpus = _doc_corpus(rng, doc, 24, bucket)
    with pytest.MonkeyPatch.context() as mp:
        wlev = Spy(mp, wk, "wlev_1v_many")
        for w in (W, (3, 2, 1)):
            sc = CorpusScanner(corpus, bucket=bucket, weights=w,
                               device="cpu")
            assert sc._long and sc._stream == (bucket % 512 == 0)
            for q in (doc[:40], doc[:300]):
                truth = _truth(q, corpus, w)
                if w == W:
                    np.testing.assert_array_equal(sc.distances(q), truth)
                    v, i = sc.topk(q, 3)
                    order = np.lexsort((np.arange(truth.size), truth))[:3]
                    np.testing.assert_array_equal(i, order)
                    np.testing.assert_array_equal(v, truth[order])
                else:
                    r = sc.distances(q, score_cutoff=int(truth.min()) + 40)
                    np.testing.assert_array_equal(
                        r.valid, truth <= int(truth.min()) + 40)
                    np.testing.assert_array_equal(r.values[r.valid],
                                                  truth[r.valid])
        assert wlev.calls == 6


def test_wide_corpus_remaps_then_scans():
    """A Cyrillic corpus: the query-local remap (K2), then K7 in local
    mode, equal to the oracle under (1, 2, 3), a query char absent from
    the corpus included; a query of more than 127 distinct symbols still
    raises (item 18)."""
    rng = np.random.default_rng(9)
    letters = [chr(c) for c in range(0x430, 0x450)]
    corpus = ["".join(rng.choice(letters, int(n)))
              for n in rng.integers(0, 60, 40)] + ["Иванко", "Петрунко", ""]
    sc = CorpusScanner(corpus, weights=W, device="cpu")
    assert sc._wide
    with pytest.MonkeyPatch.context() as mp:
        remap = Spy(mp, lk, "remap_pack")
        wlev = Spy(mp, wk, "wlev_1v_many")
        for q in ("Иванко", "петрунко" + "Ж", corpus[0]):
            np.testing.assert_array_equal(sc.distances(q), _truth(q, corpus))
        assert remap.calls == wlev.calls == 3
    with pytest.raises(NotImplementedError, match="item 18"):
        sc.distances("".join(chr(0x400 + i) for i in range(128)))


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_weighted_service_http_and_reload():
    """``ScanService(..., weights=(1, 2, 3))``: a full warmup runs every
    route, ``/topk``, ``/distances`` under a cutoff and ``/batch`` over
    HTTP equal the oracle, and after ``/reload`` the service answers as a
    fresh one over the new corpus."""
    service = ScanService(CORPUS, device="cpu", weights=W)
    table = service.warmup(full=True)
    assert all(isinstance(v, float) for v in table.values()), table
    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        truth = _truth("kitten", CORPUS)
        out = _post(port, "/topk", {"query": "kitten", "k": 3})
        order = np.lexsort((np.arange(truth.size), truth))[:3]
        assert out["indices"] == order.tolist()
        assert out["values"] == truth[order].tolist()
        out = _post(port, "/distances", {"query": "kitten",
                                         "score_cutoff": 4})
        assert out["valid"] == (truth <= 4).tolist()
        out = _post(port, "/batch", {"queries": ["kitten", "", "sit"]})
        assert out["values"] == [_truth(q, CORPUS).tolist()
                                 for q in ("kitten", "", "sit")]
        new = ["zebra", "zebu", "", "arbez", "zebras"]
        assert _post(port, "/reload", {"corpus": new}) == {"ok": True,
                                                           "n": len(new)}
        # the full warmup's routes (no short-query route: the new corpus
        # has no string over 64 chars)
        assert set(service.reload_warmup) == set(table) - {"distances_short"}
        assert all(isinstance(v, float)
                   for v in service.reload_warmup.values())
        fresh = ScanService(new, device="cpu", weights=W)
        for q in ("zebra", "bre", ""):
            assert _post(port, "/topk", {"query": q, "k": 2}) \
                == fresh.topk(q, 2)
            assert _post(port, "/distances", {"query": q}) \
                == {"values": _truth(q, new).tolist()}
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
@pytest.mark.parametrize("kernel,la,lb_max", [
    ("wlev_scan", 27, 260), ("wlev_scan", 60, 260), ("wlev_scan", 100, 260),
    ("wlev_scan", 0, 260), ("wlev_scan", 140, 260),
    ("wlev_scan_long", 50, 1536), ("wlev_scan_long", 1100, 1536)])
def test_wlev_kernel_matches_plain_on_card(cuda_device, monkeypatch, kernel,
                                           la, lb_max):
    """Each K7 form (registers at one, two and four words, the empty
    query, the tile form at five lanes a candidate and past one strip,
    the latter launched over several chunks of its edge buffer, a long
    bucket) equals its plain PyTorch version on the card under (1, 2, 3)
    and moves its launch counter."""
    rng = np.random.default_rng(la)
    a = np.r_[0, 97, 98, 99, 200, 255]
    q = rng.choice(a, la)
    lens = rng.integers(0, lb_max + 1, 4096).astype(np.int32)
    chars = rng.choice(a, (4096, lb_max)).astype(np.int32)
    chars[:64, :la] = q
    chars[np.arange(lb_max)[None, :] >= lens[:, None]] = -1
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    _, tabs = lk.stage_query(q, "byte", cuda_device)
    before = kc.LAUNCHES[kernel]
    # edge buffers for a quarter of the candidates: four launches past a
    # strip
    monkeypatch.setattr(wk, "SCRATCH_BYTES", 4 * lb_max * 1024)
    got = wk.wlev_1v_many(q, cand, lb, ins=1, dele=2, sub_cost=3)
    ref = wk.wlev_scan_plain(la, tabs, cand, lb, 1, 2, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    chunks = 4 if la > wk.STRIP else 1
    assert wk.edge_chunk(lb_max, 4096) == 1024
    assert kc.LAUNCHES[kernel] == before + chunks
