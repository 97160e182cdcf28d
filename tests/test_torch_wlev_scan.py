"""The port's weighted Levenshtein kernel module (K7) and the weighted
CorpusScanner against the JAX package, on the CPU.

Kernel level: the same numpy-seeded inputs go through the JAX Pallas
launcher ``wlev_kernel.wlev_1v_many`` (``interpret=True``, as
``tests/test_pallas.py`` runs it on the CPU) and through the port's
wrapper on CPU tensors, which runs the kernel's plain version
``wlev_scan_plain``: byte mode, bucket 260, queries of one and two words
and the empty query, under the tables (1, 2, 3) and (3, 2, 1), whose
asymmetry shows an insertion/deletion slip; empty, full-bucket and
NUL-holding candidates.  The port runs on the first :data:`PORT_CAND` of
the JAX grid cell's 4096 candidates (candidates are independent).

Scanner level: the port's weighted scanner on CPU tensors against the JAX
scanner in interpret mode on a one-device CPU mesh, over a corpus of the
same bucket that pads to the same 4096 rows, so the JAX kernel compiles
once per query width for both levels: distances, the ``(values, valid)``
answers under cutoffs, a hint that changes nothing, top-k ids and values
with their tie order, and ``scan_many`` with its checkpoint.  Spies show
every weighted route runs the weighted wrapper alone: no band, no hint
route, no multi-query launch.  Integers must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu.ops.pallas import wlev_kernel as jwk
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok
from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel as wk
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.utils import codec

from test_torch_long import Spy

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

B = 4096   # one JAX grid cell (32 x 128); the scanner's corpus pads to it
LB = 260   # the bucket of the port's other kernel tests
#: candidates the port's plain version runs on, the first of the cell's
PORT_CAND = 1024
ALPHA = np.r_[0, 97, 98, 99, 200, 255]     # NUL and two Latin-1 bytes
TABLES = [(1, 2, 3), (3, 2, 1)]


def _corpus(rng, q):
    """Empty rows, full-bucket rows, the query itself, near copies of it
    (substitutions, deletions and insertions), random rows; PAD past each
    length."""
    chars = rng.choice(ALPHA, (B, LB))
    lens = np.clip(q.size + rng.integers(-20, 21, B), 0, LB)
    base = np.resize(q, LB) if q.size else chars[0]
    for i in range(20, B):
        if rng.random() < 0.6:
            s = list(base[: lens[i] + 5])
            for _ in range(int(rng.integers(0, 6))):
                p = int(rng.integers(0, max(1, len(s))))
                op = int(rng.integers(0, 3))
                if op == 0 and s:
                    s[p % len(s)] = int(rng.choice(ALPHA))
                elif op == 1 and s:
                    del s[p % len(s)]
                else:
                    s.insert(p, int(rng.choice(ALPHA)))
            s = np.array(s[:LB], np.int64)
            chars[i, : s.size] = s
            lens[i] = s.size
    lens[:5] = 0
    lens[5:10] = LB
    chars[10, : q.size] = q
    lens[10] = q.size
    chars[np.arange(LB)[None, :] >= lens[:, None]] = -1
    return chars.astype(np.int32), lens.astype(np.int32)


def _oracle_rows(q, chars, lens, rows, w):
    return np.array([oracle.levenshtein_weighted(q, chars[i, : lens[i]], *w)
                     for i in rows])


@pytest.mark.parametrize("la", [27, 50, 0])
def test_wlev_plain_matches_jax(la):
    """One word, two words and the empty query under both tables: every
    candidate bit for bit with the JAX kernel, sampled rows with the
    oracle; an empty query gives ``lb * ins``, and swapping the insertion
    and deletion costs changes some distance (the orientation)."""
    rng = np.random.default_rng(la)
    q = rng.choice(ALPHA, la)
    chars, lens = _corpus(rng, q)
    c3, l2 = jlk.prepare_corpus(jnp.asarray(chars), jnp.asarray(lens), LB=LB)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars[:PORT_CAND]),
                                 torch.from_numpy(lens[:PORT_CAND]))
    got = {}
    for w in TABLES:
        ins, dele, sub = w
        ref = np.asarray(jwk.wlev_1v_many(
            q, c3, l2, ins=ins, dele=dele, sub_cost=sub, mode="byte",
            interpret=True)).reshape(-1)
        d = wk.wlev_1v_many(q, cand, lb, ins=ins, dele=dele, sub_cost=sub,
                            mode="byte")
        assert d.dtype == torch.int32 and d.shape == (PORT_CAND,)
        np.testing.assert_array_equal(d.numpy(), ref[:PORT_CAND])
        rows = [0, 5, 10, 11, 20, 21, PORT_CAND - 1]
        np.testing.assert_array_equal(
            d.numpy()[rows], _oracle_rows(q, chars, lens, rows, w))
        got[w] = d.numpy()
        if la == 0:
            np.testing.assert_array_equal(d.numpy(),
                                          lens[:PORT_CAND] * ins)
        else:
            assert d[10] == 0
    assert (got[TABLES[0]] != got[TABLES[1]]).any()


def test_wlev_wrapper_refuses_bad_inputs():
    """Shape, dtype and the int32 bound: a table whose cells could
    overflow raises the JAX wrapper's ``ValueError``."""
    rng = np.random.default_rng(5)
    chars, lens = _corpus(rng, rng.choice(ALPHA, 30))
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars[:256]),
                                 torch.from_numpy(lens[:256]))
    q = rng.choice(ALPHA, 30)
    with pytest.raises(ValueError, match="weight table too large"):
        wk.wlev_1v_many(q, cand, lb, ins=2 ** 23, dele=1, sub_cost=1)
    with pytest.raises(ValueError, match="weight table too large"):
        wk.wlev_1v_many(q, cand, lb, ins=1, dele=2 ** 27, sub_cost=1)
    with pytest.raises(ValueError, match="shape"):
        wk.wlev_1v_many(q, cand, lb[:128].contiguous(), ins=1, dele=2,
                        sub_cost=3)
    with pytest.raises(ValueError, match="shape"):
        wk._wlev_scan(70, lk.stage_query(q, "byte")[1], cand, lb, 1, 2, 3,
                      "wlev_scan")
    with pytest.raises(TypeError):
        wk.wlev_1v_many(q, cand.to(torch.int64), lb, ins=1, dele=2,
                        sub_cost=3)
    assert wk.fits_int32(30, LB, 2 ** 21, 1, 1)
    assert not wk.fits_int32(30, LB + 4, 2 ** 23, 1, 1)


# ------------------------------------------------------------ the scanner

ALPHA_S = list("abcdef")


def _text(rng, n, alphabet=ALPHA_S):
    return "".join(rng.choice(alphabet, n))


def _mutate(rng, s, edits):
    s = list(s)
    for _ in range(edits):
        i = int(rng.integers(0, max(1, len(s))))
        op = int(rng.integers(0, 3))
        if op == 0 and s:
            s[i % len(s)] = str(rng.choice(ALPHA_S))
        elif op == 1 and s:
            del s[i % len(s)]
        else:
            s.insert(i, str(rng.choice(ALPHA_S)))
    return "".join(s)


def _truth(q, corpus, w):
    e = codec.encode_one(q)
    return np.array([oracle.levenshtein_weighted(e, codec.encode_one(s), *w)
                     for s in corpus])


@pytest.fixture(scope="module")
def scanners():
    """A corpus of bucket 260 in byte mode (strings holding a Latin-1
    char): near copies (0-6 edits) of a 50-char document and of its first
    20 chars, exact duplicates (top-k ties), random texts and the edge
    lengths; for each table the JAX scanner in interpret mode on one CPU
    device and the port's on CPU tensors."""
    rng = np.random.default_rng(31)
    doc = _text(rng, 50)
    out = [_mutate(rng, doc, int(e)) for e in rng.integers(0, 7, 60)]
    out += [_mutate(rng, doc[:20], int(e)) for e in rng.integers(0, 5, 30)]
    out += [doc, doc, doc[:20], doc[:20]]
    out += [_text(rng, int(n)) for n in rng.integers(0, LB + 1, 30)]
    out += [_text(rng, int(n), ALPHA_S + ["\xe9"]) for n in (10, 50, 250)]
    out += ["", "a", _text(rng, LB), "\x00" + doc[1:]]
    rng.shuffle(out)
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    pairs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
        for w in TABLES:
            js = JaxScanner(out, bucket=LB, weights=w, mesh=mesh)
            assert js._weights == w and js._pallas
            pairs[w] = (js, CorpusScanner(out, bucket=LB, weights=w,
                                          device="cpu"))
    return out, doc, pairs


def _spies(mp):
    """Spies on every wrapper a scanner routes to."""
    return {"wlev": Spy(mp, wk, "wlev_1v_many"),
            "lev": Spy(mp, lk, "lev_1v_many"),
            "lev_nq": Spy(mp, lk, "lev_nq_many"),
            "lev_band": Spy(mp, bk, "lev_banded_1v_many"),
            "lev_stream_band": Spy(mp, bk, "lev_banded_stream_1v_many"),
            "lcs": Spy(mp, ck, "lcs_1v_many"),
            "lcs_nq": Spy(mp, ck, "lcs_nq_many"),
            "osa": Spy(mp, ok, "osa_1v_many"),
            "osa_nq": Spy(mp, ok, "osa_nq_many")}


def _route(spies, **want):
    got = {k: s.calls for k, s in spies.items()}
    assert got == {**{k: 0 for k in spies}, **want}, got
    for s in spies.values():
        s.calls = 0


@pytest.mark.parametrize("w", TABLES)
def test_distances_cutoffs_and_hint_match_jax(scanners, w):
    """Plain distances and ``(values, valid)`` under cutoffs equal the JAX
    scanner's and the oracle's, for queries of one and two words, a
    NUL-holding one and the empty query; a hint changes nothing.  Each is
    one weighted scan: the cutoff does not take the band and the hint
    does not take the hint route, as in the JAX scanner."""
    strings, doc, pairs = scanners
    js, ps = pairs[w]
    assert not ps._nq_eligible() and not ps._long and not ps._wide
    qs = {"q50": _mutate(np.random.default_rng(1), doc, 2), "q20": doc[:20],
          "nul50": "\x00" + doc[1:], "empty": ""}
    cuts = {"q50": (5, 9), "q20": (0, 6)}
    with pytest.MonkeyPatch.context() as mp:
        spies = _spies(mp)
        for name, q in qs.items():
            truth = _truth(q, strings, w)
            d = ps.distances(q)
            _route(spies, wlev=1)
            np.testing.assert_array_equal(d, truth)
            np.testing.assert_array_equal(d, js.distances(q))
            for cut in cuts.get(name, ()):
                r = ps.distances(q, score_cutoff=cut)
                _route(spies, wlev=1)
                jr = js.distances(q, score_cutoff=cut)
                np.testing.assert_array_equal(r.values, jr.values)
                np.testing.assert_array_equal(r.valid, jr.valid)
                np.testing.assert_array_equal(r.valid, truth <= cut)
                assert r.valid.any() and not r.valid.all()
            if name == "q50":
                np.testing.assert_array_equal(
                    ps.distances(q, score_hint=4), truth)
                _route(spies, wlev=1)


def test_topk_ids_values_and_ties(scanners):
    """Top-k with and without a cutoff, under both tables; the document's
    duplicates tie at 0, the smaller index first.  No auto-band pass runs
    before the full scan."""
    strings, doc, pairs = scanners
    for w in TABLES:
        js, ps = pairs[w]
        for q, k, cut in ((doc[:20], 5, None), (doc, 4, 6), (doc, 6, None),
                          ("", 3, None), (doc[:20], 3, 0)):
            with pytest.MonkeyPatch.context() as mp:
                spies = _spies(mp)
                pv, pi = ps.topk(q, k, score_cutoff=cut)
                _route(spies, wlev=1)
            jv, ji = js.topk(q, k, score_cutoff=cut)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pv, jv)
        pv, pi = ps.topk(doc, 2)
        assert pv[0] == pv[1] == 0 and pi[0] < pi[1]


def test_scan_many_and_checkpoint(scanners, tmp_path):
    """``scan_many`` runs one weighted scan per query (no multi-query
    launch, as the JAX scanner leaves weighted scans out of its grouped
    path) and equals the JAX scanner's, top-k rows included; a checkpoint
    with the JAX scanner's fingerprint resumes it.  The fingerprint keys
    the corpus, the queries and the metric but not the weight table, on
    both sides."""
    strings, doc, pairs = scanners
    js, ps = pairs[TABLES[0]]
    rng = np.random.default_rng(3)
    queries = ([doc[:20], doc[:40], "", "\x00" + doc[1:20]]
               + [_mutate(rng, doc[:18], 3) for _ in range(4)])
    with pytest.MonkeyPatch.context() as mp:
        spies = _spies(mp)
        full = ps.scan_many(queries)
        _route(spies, wlev=len(queries))
    np.testing.assert_array_equal(full, js.scan_many(queries))
    pv, pi = ps.scan_many(queries, k=4)
    jv, ji = js.scan_many(queries, k=4)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    fp = js._ckpt_fingerprint(queries)
    assert ps._ckpt_fingerprint(queries) == fp \
        == pairs[TABLES[1]][1]._ckpt_fingerprint(queries)
    ck_path = str(tmp_path / "scan.ck.npz")
    poisoned = full.copy()
    poisoned[:3] = 123.0
    np.savez(ck_path, n=js.n, nq=len(queries), k=0, done=3, vals=poisoned,
             ids=np.empty(0), fp=fp)
    resumed = ps.scan_many(queries, checkpoint_path=ck_path,
                           checkpoint_every=2)
    np.testing.assert_array_equal(resumed[:3], poisoned[:3])
    np.testing.assert_array_equal(resumed[3:], full[3:])
