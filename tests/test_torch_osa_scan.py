"""The port's OSA kernel module and CorpusScanner(metric="osa") against the
JAX package, on the CPU.

Kernel level: the same numpy-seeded inputs go through the JAX Pallas
launchers ``osa_kernel.osa_1v_many`` and ``osa_nq_many``
(``interpret=True``, as the JAX package's own tests run them on the CPU)
and through the port's wrappers on CPU tensors, which run the kernel's
plain version ``osa_scan_plain``: byte mode, bucket 260, queries of one
and two words.  Adjacent swaps are planted at text position 0 and across
query bits 31/32 (the transposition term's cross-word carry), beside an
empty query, empty candidates and NUL chars.

Scanner level: the port's scanner on CPU tensors against the JAX scanner
in interpret mode on a one-device CPU mesh, over a corpus of the same
bucket that pads to the same 4096 rows, so the JAX kernels compile once
per process for both levels: distances, the full ``(values, valid)``
answers under cutoffs, top-k ids and values with their tie order, and
``scan_many`` with its checkpoint.  Spies show every OSA route runs the
OSA wrapper and nothing else.  Integers must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu.ops.pallas import osa_kernel as jok
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

B = 4096   # one JAX grid cell (32 x 128); the scanner's corpus pads to it
LB = 260   # not a multiple of 8, so the JAX kernels unroll by 4
#: candidates the 16-query comparison runs the port on (the first ones:
#: the planted rows, the edge lengths and near copies): candidates are
#: independent, and a [16, NQ_CAND] plain step stays under PyTorch's
#: grain size, so it runs on one thread instead of contending with the
#: other test workers
NQ_CAND = 1024
ALPHA = np.r_[0, 97, 98, 99, 200, 255]     # NUL and two Latin-1 bytes


def _swap(s, i):
    s = np.array(s)
    s[i], s[i + 1] = s[i + 1], s[i]
    return s


def _corpus(rng, q):
    """Empty rows, full-bucket rows, the query with swaps planted at chars
    0/1, 31/32 (across query words) and its last two chars, near copies
    with random adjacent swaps and substitutions, random rows; PAD past
    each length.  Returns chars, lengths and the planted rows."""
    lens = np.clip(q.size + rng.integers(-12, 13, B), 0, LB)
    chars = rng.choice(ALPHA, (B, LB))
    base = np.resize(q, LB) if q.size else chars[0]
    for i in range(200, B):
        if rng.random() < 0.6:
            s = base.copy()
            for p in rng.integers(0, max(1, min(lens[i], LB) - 1), 3):
                s = _swap(s, int(p))
            sub = rng.random(LB) < 0.05
            chars[i] = np.where(sub, chars[i], s)
    lens[:5] = 0
    lens[5:10] = LB
    planted = []
    if q.size >= 2:
        for r, cuts in ((10, (0,)), (11, (31,)), (12, (0, 31, q.size - 2))):
            cuts = [c for c in cuts if c + 1 < q.size]
            if cuts:
                s = q.copy()
                for c in cuts:
                    s = _swap(s, c)
                chars[r, : q.size] = s
                lens[r] = q.size
                planted.append(r)
    chars[np.arange(LB)[None, :] >= lens[:, None]] = -1
    return chars.astype(np.int32), lens.astype(np.int32), planted


def _both(chars, lens):
    c3, l2 = jlk.prepare_corpus(jnp.asarray(chars), jnp.asarray(lens), LB=LB)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars),
                                 torch.from_numpy(lens))
    return (c3, l2), (cand, lb)


def _oracle_rows(q, chars, lens, rows, fn=oracle.osa):
    return np.array([fn(q, chars[i, : lens[i]]) for i in rows])


@pytest.mark.parametrize("la", [27, 50, 0])
def test_osa_1v_many_matches_jax(la):
    """One word, two words (swaps across bits 31/32) and the empty query,
    every candidate bit for bit with the JAX kernel; the planted rows
    equal the oracle and beat Levenshtein, so the transposition term,
    its cross-word carry included, is what makes them equal."""
    rng = np.random.default_rng(la)
    q = rng.choice(ALPHA, max(la, 2))
    q[:2] = (97, 98)              # a swap at position 0 changes the text
    if la > 32:
        q[31:33] = (99, 200)
    q = q[:la]
    chars, lens, planted = _corpus(rng, q)
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jok.osa_1v_many(q, c3, l2, mode="byte",
                                     interpret=True)).reshape(-1)
    got = ok.osa_1v_many(q, cand, lb, mode="byte")
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    rows = [0, 5, 200, 201] + planted
    truth = _oracle_rows(q, chars, lens, rows)
    np.testing.assert_array_equal(got.numpy()[rows], truth)
    if la:
        assert len(planted) == (3 if la > 32 else 2)
        lev = _oracle_rows(q, chars, lens, planted,
                           oracle.levenshtein_uniform)
        # rows 10 and 11 are one transposition from the query
        assert (truth[4:] < lev).all() and truth[4] == 1
        assert la <= 32 or truth[5] == 1
    else:
        np.testing.assert_array_equal(got.numpy(), lens)


def test_osa_nq_many_matches_jax():
    """16 queries of two words in one launch (one of them the query with
    a swap across bits 31/32) and a one-word group holding an empty query
    (the JAX wrapper patches its row after the launch, K6 writes ``lb``
    itself), on the first :data:`NQ_CAND` candidates."""
    rng = np.random.default_rng(7)
    qs = [rng.choice(ALPHA, int(rng.integers(33, 65))) for _ in range(16)]
    qs[0][31:33] = (99, 200)
    qs[5] = _swap(qs[0], 31)
    chars, lens, planted = _corpus(rng, qs[0])
    (c3, l2), (cand, lb) = _both(chars, lens)
    cand = cand[:, :NQ_CAND].contiguous()
    lb = lb[:NQ_CAND].contiguous()
    ref = np.asarray(jok.osa_nq_many(qs, c3, l2, mode="byte",
                                     interpret=True)).reshape(16, -1)
    got = ok.osa_nq_many(qs, cand, lb, mode="byte")
    np.testing.assert_array_equal(got.numpy(), ref[:, :NQ_CAND])
    assert got[5, 11] == 0 and got[0, 11] == 1
    ones = [qs[0][:20], np.empty(0, np.int64)] + [qs[1][:30]] * 14
    ref = np.asarray(jok.osa_nq_many(ones, c3, l2, mode="byte",
                                     interpret=True)).reshape(16, -1)
    got = ok.osa_nq_many(ones, cand, lb, mode="byte")
    np.testing.assert_array_equal(got.numpy(), ref[:, :NQ_CAND])
    np.testing.assert_array_equal(got[1].numpy(), lens[:NQ_CAND])
    with pytest.raises(ValueError, match="word buckets"):
        ok.osa_nq_many([qs[0], np.zeros(70, np.int64)], cand, lb)
    with pytest.raises(ValueError, match="shape"):
        ok.osa_1v_many(qs[0], cand, lb[:128].contiguous())
    with pytest.raises(TypeError):
        ok.osa_1v_many(qs[0], cand.to(torch.int64), lb)


# ------------------------------------------------------------ the scanner

ALPHA_S = list("abcdef")


def _text(rng, n, alphabet=ALPHA_S):
    return "".join(rng.choice(alphabet, n))


def _mutate(rng, s, edits):
    """``s`` with ``edits`` random adjacent swaps, substitutions,
    deletions and insertions."""
    s = list(s)
    for _ in range(edits):
        i = int(rng.integers(0, max(1, len(s))))
        op = int(rng.integers(0, 4))
        if op == 0 and len(s) > i + 1:
            s[i], s[i + 1] = s[i + 1], s[i]
        elif op == 1 and s:
            s[i % len(s)] = str(rng.choice(ALPHA_S))
        elif op == 2 and s:
            del s[i % len(s)]
        else:
            s.insert(i, str(rng.choice(ALPHA_S)))
    return "".join(s)


def _truth(q, corpus):
    e = codec.encode_one(q)
    return np.array([oracle.osa(e, codec.encode_one(s)) for s in corpus])


@pytest.fixture(scope="module")
def scanners():
    """A corpus of bucket 260 in byte mode (strings holding a Latin-1
    char): near copies (0-6 edits, adjacent swaps among them) of a 50-char
    document and of its first 20 chars, exact duplicates (top-k ties),
    random texts and the edge lengths; the JAX scanner in interpret mode
    on one CPU device and the port's on CPU tensors."""
    rng = np.random.default_rng(21)
    doc = _text(rng, 50)
    out = [_mutate(rng, doc, int(e)) for e in rng.integers(0, 7, 70)]
    out += [_mutate(rng, doc[:20], int(e)) for e in rng.integers(0, 5, 30)]
    out += [doc, doc, doc[:20], doc[:20], doc[1] + doc[0] + doc[2:]]
    out += [_text(rng, int(n)) for n in rng.integers(0, LB + 1, 40)]
    out += [_text(rng, int(n), ALPHA_S + ["\xe9"]) for n in (10, 50, 250)]
    out += ["", "a", _text(rng, LB), "\x00" + doc[1:]]
    rng.shuffle(out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
        js = JaxScanner(out, metric="osa", bucket=LB,
                        mesh=Mesh(np.array(jax.devices("cpu")[:1]),
                                  ("data",)))
    ps = CorpusScanner(out, metric="osa", bucket=LB, device="cpu")
    return out, doc, js, ps


def _spies(mp):
    """Spies on every wrapper a scanner routes to."""
    return {"osa": Spy(mp, ok, "osa_1v_many"),
            "osa_nq": Spy(mp, ok, "osa_nq_many"),
            "lev": Spy(mp, lk, "lev_1v_many"),
            "lev_nq": Spy(mp, lk, "lev_nq_many"),
            "lev_band": Spy(mp, bk, "lev_banded_1v_many"),
            "lev_stream_band": Spy(mp, bk, "lev_banded_stream_1v_many"),
            "lcs": Spy(mp, ck, "lcs_1v_many"),
            "lcs_nq": Spy(mp, ck, "lcs_nq_many"),
            "lcs_band": Spy(mp, cbk, "lcs_banded_1v_many"),
            "lcs_stream_band": Spy(mp, cbk, "lcs_banded_stream_1v_many")}


def _route(spies, **want):
    got = {k: s.calls for k, s in spies.items()}
    assert got == {**{k: 0 for k in spies}, **want}, got
    for s in spies.values():
        s.calls = 0


def test_distances_and_cutoffs_match_jax(scanners):
    """Plain distances and ``(values, valid)`` under cutoffs equal the JAX
    scanner's and the oracle's, for queries of one and two words, a
    NUL-holding one and the empty query; a hint changes nothing.  Each is
    one full OSA scan (no band, no hint route)."""
    strings, doc, js, ps = scanners
    assert ps._nq_eligible() and not ps._long and not ps._wide
    qs = {"q50": _mutate(np.random.default_rng(1), doc, 2), "q20": doc[:20],
          "nul50": "\x00" + doc[1:], "empty": ""}
    cuts = {"q50": (2, 4), "q20": (0, 3)}
    with pytest.MonkeyPatch.context() as mp:
        spies = _spies(mp)
        truths = {}
        for name, q in qs.items():
            truth = truths[name] = _truth(q, strings)
            d = ps.distances(q)
            _route(spies, osa=1)
            np.testing.assert_array_equal(d, truth)
            np.testing.assert_array_equal(d, js.distances(q))
            for cut in cuts.get(name, ()):
                r = ps.distances(q, score_cutoff=cut)
                _route(spies, osa=1)
                jr = js.distances(q, score_cutoff=cut)
                np.testing.assert_array_equal(r.values, jr.values)
                np.testing.assert_array_equal(r.valid, jr.valid)
                np.testing.assert_array_equal(r.valid, truth <= cut)
                assert r.valid.any() and not r.valid.all()
        np.testing.assert_array_equal(
            ps.distances(qs["q50"], score_hint=3), truths["q50"])
        _route(spies, osa=1)
    # the swapped copy of the document is one transposition away
    assert ps.distances(doc)[strings.index(doc[1] + doc[0] + doc[2:])] == 1


def test_topk_ids_values_and_ties(scanners):
    """Top-k with and without a cutoff; the document's duplicates tie at
    0, the smaller index first."""
    strings, doc, js, ps = scanners
    for q, k, cut in ((doc[:20], 5, None), (doc, 4, 2), (doc, 6, None),
                      ("", 3, None), (doc[:20], 3, 0)):
        pv, pi = ps.topk(q, k, score_cutoff=cut)
        jv, ji = js.topk(q, k, score_cutoff=cut)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pv, jv)
    pv, pi = ps.topk(doc, 2)
    assert pv[0] == pv[1] == 0 and pi[0] < pi[1]


def test_scan_many_and_checkpoint(scanners, tmp_path):
    """``scan_many`` in groups of 16 (``osa_scan_nq``) equal to the JAX
    scanner's, and with top-k rows equal to the smallest (distance,
    index) pairs of those rows (the JAX scanner's tie rule); a checkpoint
    of an OSA run resumes it and is refused by a Levenshtein scan of the
    same corpus and queries."""
    strings, doc, js, ps = scanners
    rng = np.random.default_rng(3)
    queries = ([doc[:20], doc[:40], "", "\x00" + doc[1:20]]
               + [_mutate(rng, doc[:18], 3) for _ in range(14)])
    with pytest.MonkeyPatch.context() as mp:
        spies = _spies(mp)
        full = ps.scan_many(queries)
        # 17 queries of one word (two launches), one of two words
        _route(spies, osa_nq=3)
    np.testing.assert_array_equal(full, js.scan_many(queries))
    pv, pi = ps.scan_many(queries, k=4)
    ji = np.stack([np.lexsort((np.arange(r.size), r))[:4] for r in full])
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, np.take_along_axis(full, ji, 1))
    ck_path = str(tmp_path / "scan.ck.npz")
    poisoned = full.copy()
    poisoned[:3] = 123.0
    np.savez(ck_path, n=js.n, nq=len(queries), k=0, done=3, vals=poisoned,
             ids=np.empty(0), fp=js._ckpt_fingerprint(queries))
    resumed = ps.scan_many(queries, checkpoint_path=ck_path,
                           checkpoint_every=8)
    np.testing.assert_array_equal(resumed[:3], poisoned[:3])
    np.testing.assert_array_equal(resumed[3:], full[3:])
    lev = CorpusScanner(strings, bucket=LB, device="cpu")
    got = lev.scan_many(queries[:2], checkpoint_path=ck_path)
    e = codec.encode_one(queries[0])
    np.testing.assert_array_equal(got[0], [
        oracle.levenshtein_uniform(e, codec.encode_one(s)) for s in strings])
