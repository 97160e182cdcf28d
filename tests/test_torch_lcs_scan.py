"""The port's CorpusScanner on the LCS family (indel, lcs_seq) against the
JAX CorpusScanner and the C++ oracle.

The JAX scanner runs its Pallas routes in interpret mode on a one-device
CPU mesh; the port's scanner runs on CPU tensors, where the ops wrappers
take the kernels' plain versions and every routing decision is the one
the card makes.  Results must be equal: distances, the full
``(values, valid)`` cutoff answers (the band's values for rejected rows
included), top-k ids and values with their tie order, ``scan_many`` and
its checkpoint, and the ``(2, 2, 5)`` weights that reduce Levenshtein to
indel.  Spies on the wrappers show each route is the one the JAX rules
take, and that an LCS scanner never runs a Levenshtein kernel.  Over a
2048-char bucket (the streamed routes) the port is held against the
oracle.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

ALPHA = list("abcdef")
#: the corpora's bucket: long enough for queries of 8 words (the LCS
#: band's threshold) and their near copies; not a multiple of 8, so the
#: JAX kernels in interpret mode unroll by 4 and compile faster
BUCKET = 260


def _text(rng, n, alphabet=ALPHA):
    return "".join(rng.choice(alphabet, n))


def _mutate(rng, s, edits):
    s = list(s)
    for _ in range(edits):
        i = int(rng.integers(0, max(1, len(s))))
        op = int(rng.integers(0, 3))
        if op == 0 and s:
            s[i % len(s)] = str(rng.choice(ALPHA))
        elif op == 1 and s:
            del s[i % len(s)]
        else:
            s.insert(i, str(rng.choice(ALPHA)))
    return "".join(s)


def _mesh1():
    return Mesh(np.array(jax.devices("cpu")[:1]), ("data",))


def _oracle_indel(q, corpus):
    e = codec.encode_one(q)
    return np.array([oracle.indel(e, codec.encode_one(s)) for s in corpus])


def _truth(metric, q, corpus):
    d = _oracle_indel(q, corpus)
    if metric == "indel":
        return d
    la = len(q)
    lens = np.array([len(s) for s in corpus])
    return np.maximum(la, lens) - (la + lens - d) // 2


@pytest.fixture(scope="module")
def corpus():
    """Near copies (0-40 edits) of a 240-char document and of its first
    30 chars, exact duplicates (top-k ties), random texts, strings holding
    a Latin-1 char (so every query scans in byte mode) and the edge
    lengths.  The tests' queries are of 8 words (240 chars) and of one, so
    the JAX kernels in interpret mode compile for two widths."""
    rng = np.random.default_rng(21)
    doc = _text(rng, 240)
    out = [_mutate(rng, doc, int(e))[:BUCKET]
           for e in rng.integers(0, 41, 90)]
    out += [_mutate(rng, doc[:30], int(e)) for e in rng.integers(0, 8, 30)]
    out += [doc, doc, doc[:30], doc[:30]]
    out += [_text(rng, int(n)) for n in rng.integers(0, BUCKET + 1, 60)]
    out += [_text(rng, int(n), ALPHA + ["\xe9"]) for n in (10, 240, 250)]
    out += ["", "a", _text(rng, BUCKET)]
    rng.shuffle(out)
    return out, doc


@pytest.fixture(scope="module")
def scanners(corpus):
    """JAX (interpret mode) and port scanners per metric, and the
    ``(2, 2, 5)`` reduction of each package."""
    strings, _ = corpus
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
        for metric in ("indel", "lcs_seq"):
            out[metric] = (JaxScanner(strings, metric=metric, mesh=_mesh1(),
                                      bucket=BUCKET),
                           CorpusScanner(strings, metric=metric,
                                         bucket=BUCKET, device="cpu"))
        out["w225"] = (JaxScanner(strings, weights=(2, 2, 5),
                                  mesh=_mesh1(), bucket=BUCKET),
                       CorpusScanner(strings, weights=(2, 2, 5),
                                     bucket=BUCKET, device="cpu"))
    return out


def _spies(mp):
    """Spies on every wrapper a scanner routes to."""
    return {"full": Spy(mp, ck, "lcs_1v_many"),
            "nq": Spy(mp, ck, "lcs_nq_many"),
            "band": Spy(mp, cbk, "lcs_banded_1v_many"),
            "stream_band": Spy(mp, cbk, "lcs_banded_stream_1v_many"),
            "lev": Spy(mp, lk, "lev_1v_many"),
            "lev_nq": Spy(mp, lk, "lev_nq_many"),
            "lev_band": Spy(mp, bk, "lev_banded_1v_many"),
            "lev_stream_band": Spy(mp, bk, "lev_banded_stream_1v_many")}


def _route(spies, **want):
    got = {k: s.calls for k, s in spies.items()}
    assert got == {**{k: 0 for k in spies}, **want}, got
    for s in spies.values():
        s.calls = 0


#: (query, cutoff, route) per metric: indel cutoffs band at the cutoff,
#: lcs_seq cutoffs at twice it; queries under 8 words, cutoffs past 47 and
#: a NUL-holding query in byte mode take the full scan
CUTOFF_CASES = {
    "indel": (("q240", 3, "band"), ("q240", 15, "band"),
              ("q240", 31, "band"), ("q240", 47, "band"),
              ("q240", 48, "full"), ("q30", 7, "full"),
              ("nul240", 15, "full")),
    "lcs_seq": (("q240", 7, "band"), ("q240", 20, "band"),
                ("q240", 24, "full"), ("q30", 3, "full")),
}


@pytest.mark.parametrize("metric", ["indel", "lcs_seq"])
def test_distances_and_cutoffs_match_jax(corpus, scanners, metric):
    """Plain distances equal the oracle's (and the JAX scanner's for the
    one-word query: the full scan is exact, so the oracle stands in for
    the JAX kernel's 8-word compilation), and full ``(values, valid)``
    cutoff answers equal the JAX scanner's and, where valid, the
    oracle's; each cutoff takes the JAX rules' route."""
    strings, doc = corpus
    js, ps = scanners[metric]
    assert ps._nq_eligible() and not ps._long
    qs = {"q240": _mutate(np.random.default_rng(1), doc, 1), "q30": doc[:30],
          "nul240": doc[:100] + "\x00" + doc[101:], "empty": ""}
    with pytest.MonkeyPatch.context() as mp:
        spies = _spies(mp)
        for name, q in qs.items():
            d = ps.distances(q)
            _route(spies, full=1)
            np.testing.assert_array_equal(d, _truth(metric, q, strings))
        np.testing.assert_array_equal(ps.distances(qs["q30"]),
                                      js.distances(qs["q30"]))
        spies["full"].calls = 0
        for name, cut, route in CUTOFF_CASES[metric]:
            q = qs[name]
            r = ps.distances(q, score_cutoff=cut)
            _route(spies, **{route: 1})
            truth = _truth(metric, q, strings)
            if route == "band":
                jr = js.distances(q, score_cutoff=cut)
                np.testing.assert_array_equal(r.values, jr.values)
                np.testing.assert_array_equal(r.valid, jr.valid)
            else:                        # exact values on every row
                np.testing.assert_array_equal(r.values, truth)
            np.testing.assert_array_equal(r.valid, truth <= cut)
            np.testing.assert_array_equal(r.values[r.valid],
                                          truth[r.valid])
            assert r.valid.any() and not r.valid.all()
        # a hint never routes an LCS scan through a band
        h = ps.distances(qs["q240"], score_hint=8)
        _route(spies, full=1)
    np.testing.assert_array_equal(h, _truth(metric, qs["q240"], strings))


def test_topk_ids_values_and_ties(corpus, scanners):
    """Top-k (no auto-band for the LCS family), with and without a
    cutoff; the document's duplicates tie at 0, smaller index first."""
    strings, doc = corpus
    for metric in ("indel", "lcs_seq"):
        js, ps = scanners[metric]
        for q, k, cut in ((doc[:30], 5, None), (doc[:30], 3, 2),
                          (doc, 6, 20), ("", 4, None)):
            pv, pi = ps.topk(q, k, score_cutoff=cut)
            jv, ji = js.topk(q, k, score_cutoff=cut)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pv, jv)
        pv, pi = ps.topk(doc[:30], 2)
        assert pv[0] == pv[1] == 0 and pi[0] < pi[1]


def test_scan_many_and_checkpoint(corpus, scanners, tmp_path):
    """``scan_many`` in groups of 16 (``lcs_scan_nq``), per metric, with
    top-k rows; a checkpoint of an indel run resumes an indel run and is
    refused by a Levenshtein scan of the same corpus and queries."""
    strings, doc = corpus
    rng = np.random.default_rng(3)
    queries = ([doc[:30], doc[:40], "", "\x00" + doc[1:30]]
               + [_mutate(rng, doc[:28], 3) for _ in range(14)])
    for metric in ("lcs_seq", "indel"):
        js, ps = scanners[metric]
        with pytest.MonkeyPatch.context() as mp:
            spies = _spies(mp)
            full = ps.scan_many(queries)
            # 17 queries of one word (two launches), one of two words
            _route(spies, nq=3)
        np.testing.assert_array_equal(full, js.scan_many(queries))
    pv, pi = ps.scan_many(queries, k=4)
    jv, ji = js.scan_many(queries, k=4)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pi, ji)
    ck_path = str(tmp_path / "scan.ck.npz")
    poisoned = full.copy()
    poisoned[:3] = 123.0
    np.savez(ck_path, n=js.n, nq=len(queries), k=0, done=3, vals=poisoned,
             ids=np.empty(0), fp=js._ckpt_fingerprint(queries))
    resumed = ps.scan_many(queries, checkpoint_path=ck_path,
                           checkpoint_every=8)
    np.testing.assert_array_equal(resumed[:3], poisoned[:3])
    np.testing.assert_array_equal(resumed[3:], full[3:])
    lev = CorpusScanner(strings, bucket=BUCKET, device="cpu")
    got = lev.scan_many(queries, checkpoint_path=ck_path)
    e = codec.encode_one(queries[0])
    np.testing.assert_array_equal(got[0], [
        oracle.levenshtein_uniform(e, codec.encode_one(s)) for s in strings])


def test_weights_reduce_to_indel(corpus, scanners):
    """``weights=(2, 2, 5)``: twice indel, as the JAX scanner; the cutoff
    runs the full scan (no band under a weight scale) and ``scan_many``
    the 16-query LCS kernel."""
    strings, doc = corpus
    js, ps = scanners["w225"]
    assert ps.metric == js.metric == "indel" and ps._wscale == 2
    q = _mutate(np.random.default_rng(2), doc[:30], 2)
    with pytest.MonkeyPatch.context() as mp:
        spies = _spies(mp)
        d = ps.distances(q)
        r = ps.distances(q, score_cutoff=30)
        _route(spies, full=2)
    np.testing.assert_array_equal(d, 2 * _oracle_indel(q, strings))
    np.testing.assert_array_equal(d, js.distances(q))
    jr = js.distances(q, score_cutoff=30)
    np.testing.assert_array_equal(r.values, jr.values)
    np.testing.assert_array_equal(r.valid, jr.valid)
    qs = [doc[:30], doc[:40], ""]
    np.testing.assert_array_equal(ps.scan_many(qs), js.scan_many(qs))
    pv, pi = ps.topk(q, 3)
    jv, ji = js.topk(q, 3)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pi, ji)
    # other metrics ignore weights, as the JAX scanner does
    assert CorpusScanner(strings[:10], metric="lcs_seq", weights=(2, 2, 5),
                         device="cpu")._wscale == 1


def test_streamed_bucket_routes(corpus):
    """Over a 2048-char bucket: the full scan (``lcs_scan_long`` on the
    card), the streamed band for bands of up to 2 words and the full scan
    for 3 (an lcs_seq cutoff bands at twice it), top-k with its tie order;
    values against the oracle (the JAX scanner serves such buckets with
    its XLA kernels, whose values are the oracle's; the streamed kernels
    themselves are held to the JAX Pallas kernels in
    ``test_torch_lcs_kernel.py``).  Rejected rows carry the band's
    underestimate, so they are held to exceed the cutoff."""
    strings, doc = corpus
    rng = np.random.default_rng(8)
    q = doc
    longs = (strings[:60] + [_mutate(rng, q, int(e))
                             for e in rng.integers(0, 12, 30)]
             + [(doc * 6)[:int(n)] for n in (1025, 1300)])
    cases = {"indel": ((7, "stream_band"), (31, "stream_band"),
                       (40, "full")),
             "lcs_seq": ((3, "stream_band"), (15, "stream_band"),
                         (20, "full"))}
    for metric, cuts in cases.items():
        ps = CorpusScanner(longs, metric=metric, bucket=2048, device="cpu")
        assert ps._stream and not ps._nq_eligible()
        truth = _truth(metric, q, longs)
        pv, pi = ps.topk(q, 4)
        ids = np.lexsort((np.arange(truth.size), truth))[:4]
        np.testing.assert_array_equal(pi, ids)
        np.testing.assert_array_equal(pv, truth[ids])
        with pytest.MonkeyPatch.context() as mp:
            spies = _spies(mp)
            np.testing.assert_array_equal(ps.distances(q), truth)
            _route(spies, full=1)
            for cut, route in cuts:
                r = ps.distances(q, score_cutoff=cut)
                _route(spies, **{route: 1})
                np.testing.assert_array_equal(r.valid, truth <= cut)
                np.testing.assert_array_equal(r.values[r.valid],
                                              truth[r.valid])
                assert (r.values[~r.valid] > cut).all() and r.valid.any()
            # no 16-query launch over a long bucket
            np.testing.assert_array_equal(
                ps.scan_many([doc[:30], ""]),
                [_truth(metric, doc[:30], longs), _truth(metric, "", longs)])
            _route(spies, full=2)
