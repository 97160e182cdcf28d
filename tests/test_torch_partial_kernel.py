"""K10's plain version and the port's ``partial_ratio`` library, on the CPU.

``partial_scan_plain`` against the JAX Pallas window kernel in interpret
mode (``partial_kernel.partial_ratio_1v_many``, its fori body) on the
cases of ``tests/test_pallas.py``'s window-kernel test: buckets 32, 64
and 96, one and two query words, byte and local tables, inputs carried
across by ``corpus_from_jax`` / ``pm_tables_from_jax``; num, den, start
and end equal on every candidate at least as long as the query (the JAX
kernel's contract).  The roles the JAX kernel leaves to the host
(candidates shorter than the query) and queries of 65-300 chars, past its
64-char cap: the scores against the JAX host sweep
(``fuzz._host_window_scores``) and the C++ oracle bit for bit, the
windows against the port's scalar ``partial_ratio_alignment`` and, on a
few pairs, the JAX one.  The library's scalar, ``_many`` and alignment
forms against the JAX package's, with ``processor`` and
``score_cutoff``.  The kernel itself is held to its plain version on the
card by the ``cuda``-marked test below and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidfuzz_tpu import fuzz as jfuzz
from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu.ops.pallas import partial_kernel as jpk
from rapidfuzz_tpu_torch import fuzz, oracle
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import partial_kernel as pk
from rapidfuzz_tpu_torch.utils import codec

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

JAX_B = 4096    # one grid cell of the JAX kernel
PORT_B = 1024   # the port's plain version on the first PORT_B of them


def _corpus(chars, lens):
    """Chars past each length set to the pad, -1."""
    chars = chars.astype(np.int32)
    chars[np.arange(chars.shape[1])[None, :] >= lens[:, None]] = -1
    return chars, lens.astype(np.int32)


def _check_windows(q, chars, lens, out):
    """Each reported window scores the reported fraction (the oracle's
    indel of the window against the other side), and the score equals
    the oracle's brute-force ``partial_ratio``."""
    num, den, st, en = out
    for i, n in enumerate(lens.tolist()):
        c = chars[i, :n].astype(np.int64)
        score = 1.0 - (den[i] - num[i]) / den[i]
        assert score == oracle.partial_ratio(q, c), i
        if n:
            a, w = (q, c[st[i]:en[i]]) if n >= q.size else (c, q[st[i]:en[i]])
            tot = a.size + w.size
            assert (den[i], num[i]) == (tot, tot - oracle.indel(a, w)), i


@pytest.mark.parametrize("LB,qlen,lo,hi", [(32, 7, 97, 105),
                                           (32, 30, 60, 200),
                                           (96, 50, 97, 105),
                                           (64, 64, 97, 123)])
def test_plain_matches_jax_kernel(LB, qlen, lo, hi):
    """num, den, start and end of every candidate with ``n >= m`` equal
    the JAX kernel's (interpret mode) bit for bit; empty candidates give
    (0, 1, 0, 0) as its invalid lanes do; and every candidate, the
    shorter ones included, scores the oracle's ``partial_ratio`` in the
    window it reports."""
    rng = np.random.default_rng(11)
    q = rng.integers(lo, hi, qlen).astype(np.int32)
    lens = rng.integers(0, LB + 1, JAX_B)
    lens[:3] = (0, LB, min(qlen, LB))
    chars, lens = _corpus(rng.integers(lo, hi, (JAX_B, LB)), lens)
    cand3, lb2 = jlk.prepare_corpus(jnp.asarray(chars), jnp.asarray(lens),
                                    LB=LB)
    mode = jlk.pick_mode(q, int(chars.max()))
    jout = [np.asarray(x).reshape(-1)[:PORT_B] for x in
            jpk.partial_ratio_1v_many(q, cand3, lb2, mode=mode,
                                      interpret=True, flat=False)]
    c, lb = lk.corpus_from_jax(np.asarray(cand3), np.asarray(lb2))
    tabs = lk.pm_tables_from_jax(np.asarray(jlk.build_pm_tables(q, mode)),
                                 mode)
    out = pk._partial_scan(qlen, torch.from_numpy(tabs.view(np.int32)),
                           torch.from_numpy(np.ascontiguousarray(
                               c[:, :PORT_B])),
                           torch.from_numpy(lb[:PORT_B].copy())).numpy()
    n = lens[:PORT_B]
    keep = n >= qlen
    assert keep.sum() > 0
    for k in range(4):
        np.testing.assert_array_equal(out[k][keep], jout[k][keep])
    assert (out[:, n == 0] == np.array([[0], [1], [0], [0]])).all()
    sample = np.r_[0:3, np.flatnonzero(n < qlen)[:20], 3:40]
    _check_windows(q.astype(np.int64), chars[sample], n[sample],
                   out[:, sample])


def test_swapped_role_and_long_queries():
    """Queries of 65 and 300 chars (past the JAX kernel's cap) over
    choices shorter and longer than them: the ``_many`` scores equal the
    JAX host sweep and the oracle bit for bit, the alignments the port's
    scalar sweep (at 300 chars on three choices, where its aligned-pair
    steps take ~0.5 s a choice here) and the JAX one on those three, each
    window scoring its score; a wide alphabet takes query-local ids."""
    rng = np.random.default_rng(5)
    for m, nmax, nrand, alpha in ((65, 140, 12, "abcd"),
                                  (300, 420, 4, "abcde")):
        q = "".join(rng.choice(list(alpha), m))
        ch = ["".join(rng.choice(list(alpha), int(n)))
              for n in rng.integers(0, nmax, nrand)]
        ch += ["", q[:m - 1], q[7: 7 + m // 3], "x" + q + "y", q]
        uq = codec.encode_one(q)
        ucs = [codec.encode_one(s) for s in ch]
        got = fuzz.partial_ratio_many(q, ch, device="cpu")
        assert got.valid.all()
        np.testing.assert_array_equal(got.values,
                                      jfuzz._host_window_scores(uq, ucs))
        np.testing.assert_array_equal(
            got.values, [oracle.partial_ratio(uq, u) for u in ucs])
        al = fuzz.partial_ratio_alignment_many(q, ch, device="cpu")
        pick = range(len(ch)) if m < 300 else (0, len(ch) - 4, len(ch) - 2)
        for i in pick:
            assert al[i] == fuzz.partial_ratio_alignment(q, ch[i],
                                                         device="cpu")
        for a, s in zip(al, ch):
            win, src = s[a.dest_start:a.dest_end], q[a.src_start:a.src_end]
            assert a.score == fuzz.ratio(src, win) or not s
    # the JAX alignment on a shorter and a longer choice, and an exact
    # copy inside a longer one
    for i in pick:
        assert al[i] == fuzz.ScoreAlignment(**vars(
            jfuzz.partial_ratio_alignment(q, ch[i])))
    wq = "Петрунко"
    wide = ["Иванко", "", "Петру", "xПетрункоy", "Петрунко Иванков", "ab"]
    got = fuzz.partial_ratio_many(wq, wide, device="cpu").values
    ew = codec.encode_one(wq)
    np.testing.assert_array_equal(got, [oracle.partial_ratio(
        ew, codec.encode_one(s)) for s in wide])
    assert fuzz.partial_ratio_alignment_many(wq, wide, device="cpu") == [
        fuzz.partial_ratio_alignment(wq, s, device="cpu") for s in wide]
    with pytest.raises(NotImplementedError, match="item 18"):
        fuzz.partial_ratio_many("".join(chr(0x400 + i) for i in range(128)),
                                ["Иванко"], device="cpu")


PAIRS = [("this is a test", "this is a test!"), ("abc", "xxabcxx"),
         ("ab", "bx"), ("", ""), ("", "x"), ("x", ""),
         ("needle", "say needle here"), ("say needle here", "needle"),
         ("kitten inside", "a sitting kitten"), ("Иванко", "Петрунко Иван"),
         (b"bytes", b"some bytes"), ([1, 2, 3, 2 ** 40], [9, 2, 3, 2 ** 40])]


def test_library_matches_jax():
    """The scalar, ``_many`` and alignment forms against the JAX
    package's, with ``processor`` and ``score_cutoff``; the golden
    values of ``tests/test_fuzz_family.py``."""
    assert fuzz.partial_ratio("this is a test", "this is a test!") == 1.0
    a = fuzz.partial_ratio_alignment("needle", "say needle here",
                                     device="cpu")
    assert (a.score, a.src_start, a.src_end, a.dest_start, a.dest_end) == \
        (1.0, 0, 6, 4, 10)
    for s1, s2 in PAIRS:
        assert fuzz.partial_ratio(s1, s2) == jfuzz.partial_ratio(s1, s2)
        for c in (0.5, 0.9):
            assert fuzz.partial_ratio(s1, s2, score_cutoff=c) == \
                jfuzz.partial_ratio(s1, s2, score_cutoff=c)
    for s1, s2 in PAIRS[6:10]:
        got = fuzz.partial_ratio_alignment(s1, s2, device="cpu")
        assert got == fuzz.ScoreAlignment(**vars(
            jfuzz.partial_ratio_alignment(s1, s2)))
        assert fuzz.partial_ratio_alignment(s1, s2, score_cutoff=1.01,
                                            device="cpu") is None
    assert fuzz.partial_ratio("THIS is", "this IS a test",
                              processor=fuzz.default_process) == 1.0
    q = "Needle!"
    choices = ["say NEEDLE here", "needl", "", "haystack", "ee dl",
               "needle", "n", "xneedlex" * 3, "Иглы needle"]
    for proc in (None, fuzz.default_process):
        for cut in (None, 0.0, 0.6, 1.0):
            got = fuzz.partial_ratio_many(q, choices, processor=proc,
                                          score_cutoff=cut, device="cpu")
            exp = jfuzz.partial_ratio_many(q, choices, processor=proc,
                                           score_cutoff=cut)
            np.testing.assert_array_equal(got.values, exp.values)
            np.testing.assert_array_equal(got.valid, exp.valid)
        got = fuzz.partial_ratio_alignment_many(
            q, choices, processor=proc, score_cutoff=0.6, device="cpu")
        exp = jfuzz.partial_ratio_alignment_many(
            q, choices, processor=proc, score_cutoff=0.6)
        assert got == [None if e is None else fuzz.ScoreAlignment(**vars(e))
                       for e in exp]
    # integers past int32 and negative ones, some choices past 255 (the
    # wide route's query vocab)
    q = [2 ** 40, 5, 7, -3]
    choices = [[1, 2 ** 40, 5, 7, -3, 9], [5, 7], [2 ** 40], [],
               [300, 2 ** 40, 5], [7, 7, 5, 2 ** 40, 1, 1]]
    np.testing.assert_array_equal(
        fuzz.partial_ratio_many(q, choices, device="cpu").values,
        jfuzz.partial_ratio_many(q, choices).values)
    assert fuzz.partial_ratio_alignment_many(q, choices, device="cpu") == [
        fuzz.ScoreAlignment(**vars(e))
        for e in jfuzz.partial_ratio_alignment_many(q, choices)]
    empty = fuzz.partial_ratio_alignment_many("", ["", "ab"], device="cpu")
    assert empty == [fuzz.ScoreAlignment(1.0, 0, 0, 0, 0),
                     fuzz.ScoreAlignment(0.0, 0, 0, 0, 0)]
    assert fuzz.partial_ratio_many("ab", [], device="cpu").values.size == 0
    with pytest.raises(ValueError, match="empty query"):
        pk.partial_ratio_1v_many(np.empty(0, np.int64),
                                 torch.zeros((1, 4), dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("la,lb_max", [(12, 64), (64, 128), (300, 1024),
                                       (545, 700)])
def test_partial_kernel_matches_plain_on_card(cuda_device, la, lb_max):
    """K10 in its register form (12-300 chars) and its scratch form (545
    chars) equals its plain version on the card, on candidates shorter
    and longer than the query, and moves its counter."""
    rng = np.random.default_rng(17)
    a = np.r_[0, 97, 98, 99, 200, 255]
    q = rng.choice(a, la)
    chars = rng.choice(a, (2048, lb_max))
    chars[::3, : min(la, lb_max)] = q[:lb_max]       # exact copies
    chars, lens = _corpus(chars, rng.integers(0, lb_max + 1, 2048))
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    _, tabs = lk.stage_query(q, "byte", cuda_device)
    before = kc.LAUNCHES["partial_scan"]
    got = torch.stack(pk.partial_ratio_1v_many(q, cand, lb))
    torch.cuda.synchronize()
    assert torch.equal(got, pk.partial_scan_plain(la, tabs, cand, lb))
    assert kc.LAUNCHES["partial_scan"] == before + 1
