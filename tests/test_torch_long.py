"""The port at every bucket length: its long routes against the JAX kernels
they replace, the JAX scanner and the C++ oracle.

Kernel level: the same numpy-seeded inputs go through the JAX Pallas
launchers in interpret mode (as the JAX package's tests run them on the
CPU) and through the port's wrappers on CPU tensors, which run the
kernels' plain versions.  Distances must be equal (tolerance 0); band
results equal where the JAX result is within the cutoff and lie above
the cutoff elsewhere.

Scanner and server level: the port's ``CorpusScanner`` and
``ScanService`` over buckets 2048 and 4096 (and a bucket that is not a
whole 512-char stream chunk) against the C++ oracle and the JAX
``CorpusScanner`` on its XLA route, with every long route shown to be
the one taken by a spy on the wrapper it calls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rapidfuzz_tpu.ops.pallas import band_kernel as jbk
from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu.ops.pallas import stream_kernel as jsk
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.serve import ScanService
from rapidfuzz_tpu_torch.utils import codec

ALPHA = np.arange(97, 103)          # 'a'..'f': near copies stay near


def _corpus(rng, query, n, lb_max, spread=30):
    """Near copies of ``query`` (substitutions and length changes), random
    rows, empty rows and full-bucket rows, PAD past each length."""
    lens = np.clip(query.size + rng.integers(-spread, spread + 1, n), 0,
                   lb_max)
    lens[:3] = 0
    lens[3:6] = lb_max
    chars = rng.choice(ALPHA, (n, lb_max))
    base = np.resize(query, lb_max)
    near = rng.random(n) < 0.6
    keep = rng.random((n, lb_max)) > rng.random((n, 1)) * 0.2
    chars = np.where(near[:, None] & keep, base[None, :], chars)
    chars[np.arange(lb_max)[None, :] >= lens[:, None]] = -1
    return chars.astype(np.int32), lens.astype(np.int32)


def _both(chars, lens):
    c3, l2 = jlk.prepare_corpus(jnp.asarray(chars), jnp.asarray(lens),
                                LB=chars.shape[1])
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars),
                                 torch.from_numpy(lens))
    return (c3, l2), (cand, lb)


def _band_equal(got, ref, cut):
    """Band contract: equal values within the cutoff, above it elsewhere."""
    ok = ref <= cut
    assert ok.any() and (~ok).any()
    np.testing.assert_array_equal(got[ok], ref[ok])
    assert (got[~ok] > cut).all()


# ------------------------------------------------------------ kernel level

def test_stream_scan_matches_jax():
    """K1 at a 1536-char bucket against ``stream_kernel.lev_stream_1v_many``
    (3 chunks of 512) at the shape of ``test_pallas.py``, with a one-word
    query (the JAX interpreter's cost grows with the word count)."""
    rng = np.random.default_rng(3)
    q = rng.choice(ALPHA, 24)
    chars, lens = _corpus(rng, q, 4096, 1536, spread=1500)
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jsk.lev_stream_1v_many(q, c3, l2, mode="local",
                                            interpret=True)).reshape(-1)
    got = lk.lev_1v_many(q, cand, lb, mode="local").numpy()
    np.testing.assert_array_equal(got, ref)
    for i in (0, 3, 100, 2000):
        assert got[i] == oracle.levenshtein_uniform(
            q, chars[i, : lens[i]])


@pytest.mark.parametrize("la,cut,LB", [(12, 5, 64), (40, 9, 1536)])
def test_runtime_band_matches_jax(la, cut, LB):
    """K3 with the cutoff as its semiwidth against ``band_kernel._kernel``
    (``_run``): a query no longer than the pinned band, and a bucket over
    1024 chars."""
    rng = np.random.default_rng(la)
    q = rng.choice(ALPHA, la).astype(np.int32)
    chars, lens = _corpus(rng, q, 1024, LB, spread=cut + 4)
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jbk.lev_banded_1v_many(
        q, c3, l2, cutoff=cut, mode="local", sub=8,
        interpret=True)).reshape(-1)
    got = bk.lev_banded_1v_many(q, cand, lb, cutoff=cut, mode="local")
    _band_equal(got.numpy(), ref, cut)
    assert (got.numpy()[ref > cut] == bk.BIG).all()


def test_streamed_band_matches_jax():
    """K3's pinned band at a 1536-char bucket against
    ``band_kernel.lev_banded_stream_1v_many`` (bw = 1)."""
    rng = np.random.default_rng(11)
    q = rng.choice(ALPHA, 100).astype(np.int32)
    chars, lens = _corpus(rng, q, 4096, 1536)
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jbk.lev_banded_stream_1v_many(
        q, c3, l2, cutoff=12, mode="local", interpret=True)).reshape(-1)
    got = bk.lev_banded_stream_1v_many(q, cand, lb, cutoff=12, mode="local")
    _band_equal(got.numpy(), ref, 12)


def test_long_band_refusals():
    """The JAX wrappers' refusals stay ``ValueError``."""
    rng = np.random.default_rng(0)
    q = rng.choice(ALPHA, 20)
    chars, lens = _corpus(rng, q, 256, 1100)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars),
                                 torch.from_numpy(lens))
    with pytest.raises(ValueError, match="needs the pinned band"):
        bk.lev_banded_1v_many(q, cand, lb, cutoff=16)   # > 15, bucket 1100
    with pytest.raises(ValueError, match="narrower than the pattern"):
        bk.lev_banded_stream_1v_many(q, cand, lb, cutoff=16)
    with pytest.raises(ValueError, match="requires cutoff < len"):
        bk.lev_banded_stream_1v_many(q[:3], cand, lb, cutoff=3)
    with pytest.raises(ValueError, match="outside"):
        bk.lev_banded_stream_1v_many(q, cand, lb, cutoff=48)


# ------------------------------------------------------ scanner and server

def _mesh1():
    return Mesh(np.array(jax.devices("cpu")[:1]), ("data",))


def _text(rng, n):
    return "".join(chr(c) for c in rng.choice(ALPHA, n))


def _mutate(rng, s, edits):
    s = list(s)
    for _ in range(edits):
        i = int(rng.integers(0, len(s)))
        op = int(rng.integers(0, 3))
        if op == 0:
            s[i] = chr(int(rng.choice(ALPHA)))
        elif op == 1:
            del s[i]
        else:
            s.insert(i, chr(int(rng.choice(ALPHA))))
    return "".join(s)


@pytest.fixture(scope="module")
def long_corpus():
    """~100 strings of up to ~1100 chars, served at buckets 2048 and 4096:
    near copies of three documents (the queries' neighbours), random
    texts, and the edge lengths 0 and 1."""
    rng = np.random.default_rng(4)
    docs = [_text(rng, 1100) for _ in range(3)]
    corpus = []
    for d in docs:
        for e in (0, 2, 5, 9, 14, 30):
            corpus.append(_mutate(rng, d[:300], e))   # neighbours of q300
            corpus.append(_mutate(rng, d[:100], e))   # neighbours of q100
        corpus += [d[: int(rng.integers(400, 1100))] for _ in range(8)]
    corpus += [_text(rng, int(rng.integers(1, 1100))) for _ in range(30)]
    corpus += ["", "a", docs[0]]
    rng.shuffle(corpus)
    return corpus, docs


class Spy:
    """Wraps a wrapper function and counts its calls."""

    def __init__(self, mp, module, name):
        self.fn = getattr(module, name)
        self.calls = 0
        mp.setattr(module, name, self)

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _spies(mp):
    """Spies on the three wrappers the scanner routes to, and the launch
    names K3's calls carry (``lev_band``, ``lev_band_rt``,
    ``lev_band_long``)."""
    spies = {"full": Spy(mp, lk, "lev_1v_many"),
             "stream_band": Spy(mp, bk, "lev_banded_stream_1v_many"),
             "band": Spy(mp, bk, "lev_banded_1v_many")}
    band, names = bk._band, []
    mp.setattr(bk, "_band", lambda *a: names.append(a[-1]) or band(*a))
    return spies, names


def _route(spies, **want):
    got = {k: s.calls for k, s in spies.items()}
    assert got == {**{k: 0 for k in spies}, **want}, got
    for s in spies.values():
        s.calls = 0


def _oracle_row(q, corpus):
    e = codec.encode_one(q)
    return np.array([oracle.levenshtein_uniform(e, codec.encode_one(s))
                     for s in corpus])


#: (query length, cutoff, route) cases: the streamed band at bw 1 and 3,
#: and one-word queries the band does not pay for (Wq = 1 < 2*bw + 1)
CUTOFF_CASES = {2048: ((300, 5, "stream_band"), (300, 47, "stream_band"),
                       (100, 15, "stream_band"), (20, 3, "full"),
                       (8, 1, "full")),
                4096: ((300, 5, "stream_band"),)}


@pytest.mark.parametrize("bucket", [2048, 4096])
def test_long_scanner_routes_match_jax_and_oracle(long_corpus, bucket):
    """At a streamed bucket: the full long scan, the streamed band, the
    cutoff that stays on the full scan, the stream hint ladder with
    stragglers, and top-k; values against the JAX XLA scanner and the
    oracle."""
    corpus, docs = long_corpus
    js = JaxScanner(corpus, metric="levenshtein", mesh=_mesh1(),
                    bucket=bucket)
    ps = CorpusScanner(corpus, bucket=bucket, device="cpu")
    assert ps._stream and ps._LB == bucket and not ps._nq_eligible()
    qs = {n: docs[n % 3][:n] for n in (300, 100, 20, 8)}
    truth = {n: _oracle_row(q, corpus) for n, q in qs.items()}
    with pytest.MonkeyPatch.context() as mp:
        spies, names = _spies(mp)
        d = ps.distances(qs[100])
        _route(spies, full=1)
        np.testing.assert_array_equal(d, truth[100])
        np.testing.assert_array_equal(d, js.distances(qs[100]))
        for n, cut, route in CUTOFF_CASES[bucket]:
            r = ps.distances(qs[n], score_cutoff=cut)
            _route(spies, **{route: 1})
            jr = js.distances(qs[n], score_cutoff=cut)
            np.testing.assert_array_equal(r.valid, jr.valid)
            np.testing.assert_array_equal(r.values[r.valid],
                                          jr.values[jr.valid])
            np.testing.assert_array_equal(r.valid, truth[n] <= cut)
            assert (r.values[~r.valid] > cut).all()
            assert r.valid.any() or n < 32
        h = ps.distances(qs[100], score_hint=9)
        _route(spies, stream_band=1, full=1)            # stragglers exist
        np.testing.assert_array_equal(h, truth[100])
        assert set(names) == {"lev_band_long"}
    pv, pi = ps.topk(qs[100], 5)
    jv, ji = js.topk(qs[100], 5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)


def test_stream_hint_ladder_without_stragglers():
    """The hint band accepts every candidate of a corpus that fills whole
    blocks: no second pass runs.  A hint the band cannot serve (query of
    one word) leaves the scan to the full kernel."""
    rng = np.random.default_rng(8)
    doc = _text(rng, 1030)
    corpus = [_mutate(rng, doc, int(e)) for e in rng.integers(0, 9, 256)]
    ps = CorpusScanner(corpus, device="cpu")
    assert ps._stream and ps._LB == 2048 and ps.lb.shape[0] == 256
    with pytest.MonkeyPatch.context() as mp:
        spies, _ = _spies(mp)
        h = ps.distances(doc, score_hint=47)
        _route(spies, stream_band=1)
        np.testing.assert_array_equal(h, _oracle_row(doc, corpus))
        ps.distances(doc[:30], score_hint=47)
        _route(spies, full=1)


def test_runtime_band_route_and_odd_bucket(long_corpus):
    """A bucket over 1024 that is not a whole 512-char chunk (1102, padded
    to 1104 for the packed words): a query over 160 chars under a cutoff
    <= 15 takes the run-time band, a larger cutoff the full long scan,
    and the hint the full scan (the JAX scanner's XLA route gives the
    same values)."""
    corpus, docs = long_corpus
    ps = CorpusScanner(corpus, bucket=1102, device="cpu")
    js = JaxScanner(corpus, metric="levenshtein", mesh=_mesh1(),
                    bucket=1102)
    assert ps._long and not ps._stream and ps._LB == 1104
    q = docs[0][:200]
    truth = _oracle_row(q, corpus)
    with pytest.MonkeyPatch.context() as mp:
        spies, names = _spies(mp)
        for cut, route in ((9, "band"), (31, "full")):
            r = ps.distances(q, score_cutoff=cut)
            _route(spies, **{route: 1})
            np.testing.assert_array_equal(r.valid, truth <= cut)
            np.testing.assert_array_equal(r.values[r.valid],
                                          truth[truth <= cut])
        assert names == ["lev_band_rt"]
        h = ps.distances(q, score_hint=9)
        _route(spies, full=1)
    np.testing.assert_array_equal(h, truth)
    np.testing.assert_array_equal(h, js.distances(q))


def test_long_service_warmup_and_answers():
    """``ScanService`` over an explicit 2048 bucket: the full warmup runs
    the long routes, and /topk-, /distances- and /batch-shaped answers
    equal the oracle's."""
    rng = np.random.default_rng(6)
    doc = _text(rng, 200)
    corpus = ([_mutate(rng, doc, int(e)) for e in rng.integers(0, 12, 40)]
              + [_text(rng, int(n)) for n in rng.integers(0, 200, 40)])
    service = ScanService(corpus, bucket=2048, device="cpu")
    assert service.scanner._stream
    with pytest.MonkeyPatch.context() as mp:
        spies, _ = _spies(mp)
        table = service.warmup(full=True)
        assert all(isinstance(v, float) for v in table.values()), table
        assert spies["full"].calls and spies["stream_band"].calls
    q = _mutate(rng, doc, 3)
    truth = _oracle_row(q, corpus)
    out = service.topk(q, 4)
    ids = np.lexsort((np.arange(truth.size), truth))[:4]
    assert out["indices"] == ids.tolist()
    assert out["values"] == truth[ids].tolist()
    out = service.distances(q, score_cutoff=15)
    assert out["valid"] == (truth <= 15).tolist()
    assert any(out["valid"])
    out = service.batch([q, doc[:40]], k=2)
    assert out["indices"][0] == ids[:2].tolist()
