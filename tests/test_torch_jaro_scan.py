"""The port's Jaro kernel module and CorpusScanner(metric="jaro" and
"jaro_winkler") against the JAX package, on the CPU.

Kernel level: the same numpy-seeded inputs go through the JAX Pallas
launchers ``jaro_kernel.jaro_1v_many`` (``sub=8``, 1,024 candidates) and
``jaro_nq_many`` (4,096 candidates) in interpret mode, as the JAX
package's own tests run them on the CPU, at bucket 32 and one query word
only (their interpret-mode compile grows fast with the bucket and the
query), and through the port's wrappers on CPU tensors, which run the
kernel's plain version ``jaro_scan_plain``.  At bucket 260 the port is
held against the XLA ``rapidfuzz_tpu.ops.jaro.jaro_components`` (as the
JAX scanner runs it on the CPU) for queries of one, two and ten words.
Planted rows: common prefixes of 0-5 chars, texts much shorter and much
longer than the query (both truncations), a one-char text, a repeated
char that greedy flagging must give to the lowest position, the query
with chars 31/32 swapped or shifted (claims across query words), empty
queries and candidates, and NUL chars.  The integer components must be
equal (tolerance 0).

Scanner level: the port's scanner on CPU tensors against the JAX scanner
on a one-device CPU mesh (its XLA route), over the same corpus, for
``jaro`` and for ``jaro_winkler`` at prefix weights 0.1 and 0.25:
distances, ``(values, valid)`` under f64 cutoffs, top-k ids and values
with the tie order, and ``scan_many`` with its checkpoint, every f64
value bit-equal.  Spies show every Jaro route runs the Jaro wrappers and
nothing else.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rapidfuzz_tpu.ops.pallas import jaro_kernel as jjk
from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel as jk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok
from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel as wk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ALPHA = np.r_[0, 97, 98, 99, 200, 255]     # NUL and two Latin-1 bytes
#: the scanner-level corpus (and the XLA kernel-level one): bucket 260
N_SCAN, LB_SCAN = 512, 260


def _plant(rng, q, B, LB):
    """Random rows of lengths 0..LB, then planted rows: empty ones, full
    ones, the query with a common prefix of exactly 0-5 chars, a text
    of 3 chars and one of LB chars (both truncations), a one-char text,
    the query's first char repeated, the query with chars 31/32 swapped
    and shifted by one, near copies (adjacent swaps and substitutions);
    PAD past each length."""
    lens = rng.integers(0, LB + 1, B)
    chars = rng.choice(ALPHA, (B, LB))
    la = q.size
    r = 0

    def put(row, n):
        nonlocal r
        n = min(n, LB)
        chars[r, :n] = row[:n]
        lens[r] = n
        r += 1

    put(q, 0)
    put(chars[1], LB)
    if la:
        for p in range(6):
            s = np.resize(q, max(la, p + 1)).copy()
            s[p] = 255 if s[p] != 255 else 97     # the prefix stops at p
            put(s, la)
        put(q[:3], 3)
        put(np.r_[q, rng.choice(ALPHA, LB)], LB)
        put(q[:1], 1)
        put(np.full(LB, q[0]), max(1, la // 2))
        if la > 32:
            s = q.copy()
            s[31], s[32] = q[32], q[31]
            put(s, la)
            put(np.r_[ALPHA[1], q], la + 1)
        while r < B // 2:
            s = np.resize(q, LB).copy()
            for p in rng.integers(0, max(1, la - 1), 2):
                if la >= 2:
                    s[p], s[p + 1] = s[p + 1], s[p]
            sub = rng.random(LB) < 0.08
            s[sub] = rng.choice(ALPHA, int(sub.sum()))
            put(s, max(0, la + int(rng.integers(-4, 5))))
    chars[np.arange(LB)[None, :] >= lens[:, None]] = -1
    return chars.astype(np.int32), lens.astype(np.int32)


def _port_corpus(chars, lens):
    return lk.prepare_corpus(torch.from_numpy(chars), torch.from_numpy(lens))


def _jax_corpus(chars, lens):
    return jlk.prepare_corpus(jnp.asarray(chars), jnp.asarray(lens),
                              LB=chars.shape[1])


@pytest.mark.parametrize("la", [1, 9, 27])
def test_jaro_1v_many_matches_pallas(la):
    """One query word at bucket 32: every candidate's (common,
    transpositions) equal to the JAX Pallas kernel's (one interpret-mode
    compile serves all three queries); a one-char query and text give
    bound 0."""
    rng = np.random.default_rng(la)
    q = rng.choice(ALPHA, la)
    chars, lens = _plant(rng, q, 1024, 32)
    c3, l2 = _jax_corpus(chars, lens)
    rc, rt = jjk.jaro_1v_many(q.astype(np.int32), c3, l2, mode="byte", sub=8,
                              interpret=True)
    cand, lb = _port_corpus(chars, lens)
    common, trans = jk.jaro_1v_many(q, cand, lb, mode="byte")
    np.testing.assert_array_equal(common.numpy(), np.asarray(rc).reshape(-1))
    np.testing.assert_array_equal(trans.numpy(), np.asarray(rt).reshape(-1))
    assert int(common[0]) == 0 and (common[7:].numpy() > 0).any()
    if la == 1:
        one = lens == 1
        assert (common.numpy()[one] == (chars[one, 0] == q[0])).all()


def test_jaro_nq_many_matches_pallas():
    """16 one-word queries, an empty one and a one-char one among them,
    over 4,096 candidates at bucket 32 in one launch: equal to the JAX
    Pallas multi-query kernel; the empty query's rows are zeros."""
    rng = np.random.default_rng(16)
    qs = [rng.choice(ALPHA, int(n)) for n in rng.integers(2, 33, 16)]
    qs[3] = np.empty(0, np.int64)
    qs[7] = qs[0][:1]
    chars, lens = _plant(rng, qs[0], 4096, 32)
    c3, l2 = _jax_corpus(chars, lens)
    rc, rt = jjk.jaro_nq_many([q.astype(np.int32) for q in qs], c3, l2,
                              mode="byte", interpret=True)
    cand, lb = _port_corpus(chars, lens)
    common, trans = jk.jaro_nq_many(qs, cand, lb, mode="byte")
    np.testing.assert_array_equal(common.numpy(),
                                  np.asarray(rc).reshape(16, -1))
    np.testing.assert_array_equal(trans.numpy(),
                                  np.asarray(rt).reshape(16, -1))
    assert not common[3].any() and not trans[3].any()
    with pytest.raises(ValueError, match="word buckets"):
        jk.jaro_nq_many([qs[0], rng.choice(ALPHA, 40)], cand, lb)


_SCANNERS = {}


def _strings(chars, lens):
    return ["".join(map(chr, chars[i, : lens[i]])) for i in range(len(lens))]


def _jax_scanner(corpus, metric="jaro", pw=0.1):
    """The JAX scanner over ``corpus`` on a one-device CPU mesh (its XLA
    route), one per (metric, prefix weight); the jitted components
    compile once per query bucket for all of them."""
    key = (id(corpus), metric, pw)
    if key not in _SCANNERS:
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        _SCANNERS[key] = JaxScanner(corpus, metric=metric, mesh=mesh,
                                    bucket=LB_SCAN, prefix_weight=pw)
    return _SCANNERS[key]


@pytest.fixture(scope="module")
def scan_corpus():
    """Bucket-260 strings: the planted rows of a two-word query, its
    near copies, duplicate rows (top-k ties) and random rows."""
    rng = np.random.default_rng(260)
    q = rng.choice(ALPHA, 50)
    chars, lens = _plant(rng, q, N_SCAN, LB_SCAN)
    strings = _strings(chars, lens)
    strings[-8:] = [strings[20]] * 4 + [strings[21]] * 4
    return strings, "".join(map(chr, q))


@pytest.mark.parametrize("la", [27, 50, 300])
def test_jaro_components_match_xla(scan_corpus, la):
    """One, two and ten query words (the last in K8's scratch form) at
    bucket 260: every candidate's components equal to the XLA
    ``jaro_components``."""
    strings, q50 = scan_corpus
    rng = np.random.default_rng(la)
    q = codec.encode_one(q50) if la == 50 else rng.choice(ALPHA, la)
    if la == 300:
        q[:50] = codec.encode_one(q50)
    chars, lens = codec.encode_batch(strings, LB_SCAN)
    cand, lb = _port_corpus(chars, lens)
    common, trans = jk.jaro_1v_many(q, cand, lb, mode="byte")
    js = _jax_scanner(strings)
    qc, ql = codec.pad_batch([q])
    rc, rt = js._fn(qc, ql, js.chars, js.lens)
    np.testing.assert_array_equal(common.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(trans.numpy(), np.asarray(rt))
    assert (trans.numpy() > 0).any()
    assert jk.words(la) > jk.MAX_REG_W or la < 300


def _route_spies(mp):
    """Spies on the Jaro wrappers and on every other scan wrapper."""
    jaro = {"1v": Spy(mp, jk, "jaro_1v_many"),
            "nq": Spy(mp, jk, "jaro_nq_many")}
    other = [Spy(mp, lk, "lev_1v_many"), Spy(mp, lk, "lev_nq_many"),
             Spy(mp, bk, "lev_banded_1v_many"), Spy(mp, ck, "lcs_1v_many"),
             Spy(mp, ok, "osa_1v_many"), Spy(mp, wk, "wlev_1v_many")]
    return jaro, other


@pytest.mark.parametrize("metric,pw", [("jaro", 0.1),
                                       ("jaro_winkler", 0.1),
                                       ("jaro_winkler", 0.25)])
def test_scanner_matches_jax(scan_corpus, metric, pw, monkeypatch):
    """Distances, (values, valid) under f64 cutoffs and top-k with its
    tie order equal the JAX scanner's bit for bit; each scan is one
    ``jaro_1v_many`` call and nothing else."""
    strings, q = scan_corpus
    js = _jax_scanner(strings, metric, pw)
    sc = CorpusScanner(strings, metric=metric, bucket=LB_SCAN, device="cpu",
                       prefix_weight=pw)
    jaro, other = _route_spies(monkeypatch)
    d = sc.distances(q)
    jd = np.asarray(js.distances(q))
    assert d.dtype == np.float64
    np.testing.assert_array_equal(d, jd)
    for cut in (0.05, 0.3):
        res, jres = sc.distances(q, score_cutoff=cut), \
            js.distances(q, score_cutoff=cut)
        np.testing.assert_array_equal(res.values, jres.values)
        np.testing.assert_array_equal(res.valid, jres.valid)
        assert res.valid.any() and not res.valid.all()
    for k, cut in ((10, None), (6, 0.3)):
        vals, ids = sc.topk(q, k, score_cutoff=cut)
        jvals, jids = js.topk(q, k, score_cutoff=cut)
        # the JAX XLA route's top-k takes an arbitrary member of a tie
        # set that straddles k (argpartition, scan.py:1463-1469), where
        # its Pallas route orders by (distance, index) (_topk_host): the
        # ids are held to that order of the JAX distances, the values to
        # the JAX top-k
        dd = jd if cut is None else np.where(jd <= cut, jd, np.inf)
        want = np.lexsort((np.arange(dd.size), dd))[:k]
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(vals, np.asarray(jvals))
        assert vals.dtype == np.float64
    # the duplicate rows tie at 0 (under prefix weight 0.25 with every
    # row whose 4-char prefix boosts it to 1.0): by corpus index
    vals, ids = sc.topk(strings[20], 4)
    jd20 = np.asarray(js.distances(strings[20]))
    np.testing.assert_array_equal(ids, np.lexsort((np.arange(jd20.size),
                                                   jd20))[:4])
    assert (vals == 0).all()
    if pw == 0.1:
        assert ids.tolist() == [20, N_SCAN - 8, N_SCAN - 7, N_SCAN - 6]
    assert jaro["1v"].calls == 6 and jaro["nq"].calls == 0
    assert all(s.calls == 0 for s in other)
    if metric == "jaro_winkler":
        assert (d <= np.asarray(_jax_scanner(strings).distances(q))).all()


def test_scan_many_and_checkpoint(scan_corpus, tmp_path, monkeypatch):
    """``scan_many`` (grouped 16-query launches, a group of one and two
    words) with top-k and without, equal to the JAX scanner's one scan
    per query (its XLA route has no grouped launch), and a run resumed
    from a checkpoint equal to a fresh one; the checkpoint key mirrors the
    JAX scanner's, which leaves ``prefix_weight`` out."""
    strings, q = scan_corpus
    rng = np.random.default_rng(5)
    queries = [q, q[:20], ""] + ["".join(map(chr, rng.choice(ALPHA, n)))
                                 for n in (5, 33, 64, 12)]
    sc = CorpusScanner(strings, metric="jaro_winkler", bucket=LB_SCAN,
                       device="cpu", prefix_weight=0.25)
    js = _jax_scanner(strings, "jaro_winkler", 0.25)
    assert sc._nq_eligible()
    jaro, other = _route_spies(monkeypatch)
    full = sc.scan_many(queries)
    assert jaro["nq"].calls == 2 and jaro["1v"].calls == 0
    assert all(s.calls == 0 for s in other)
    want = np.stack([np.asarray(js.distances(x)) for x in queries])
    np.testing.assert_array_equal(full, want)
    # top-k by (distance, index) of the JAX distances, as in
    # test_scanner_matches_jax
    vals, ids = sc.scan_many(queries, k=5)
    top = np.stack([np.lexsort((np.arange(N_SCAN), w))[:5] for w in want])
    np.testing.assert_array_equal(ids, top)
    np.testing.assert_array_equal(vals, np.take_along_axis(want, top, 1))
    ck_path = str(tmp_path / "ck.npz")
    part = sc.scan_many(queries[:4], checkpoint_path=ck_path,
                        checkpoint_every=2)
    np.testing.assert_array_equal(part, full[:4])
    again = sc.scan_many(queries[:4], checkpoint_path=ck_path,
                         checkpoint_every=2)
    np.testing.assert_array_equal(again, full[:4])
    other_pw = CorpusScanner(strings, metric="jaro_winkler", bucket=LB_SCAN,
                             device="cpu", prefix_weight=0.1)
    assert sc._ckpt_fingerprint(queries) == js._ckpt_fingerprint(queries) \
        == other_pw._ckpt_fingerprint(queries)
