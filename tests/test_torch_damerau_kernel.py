"""The port's Damerau-Levenshtein kernel module (K9's plain versions) and
aligned-pair op against the JAX package, on the CPU.

``dam_scan_plain`` and ``dam_band_plain`` (what the wrappers run for CPU
tensors) take the same numpy-seeded corpora as the XLA
``rapidfuzz_tpu.ops.damerau.damerau_distance``, the function the JAX
scanner runs on the CPU, and the C++ oracle: buckets 32, 64, 128 and 160,
queries of 0-70 chars, alphabets of 4 and 26 symbols, transposition-dense
near copies (adjacent swaps, also across query words and packed 4-char
rows, and swaps with edits between).  Every XLA call has one shape
(``[256, 72]`` against ``[256, 160]``, candidates padded), so one compile
serves the file.  The full form must equal both bit for bit; the band of
radius 3, 7 and 15 must equal them where the distance is at most the
radius and exceed the radius elsewhere.  One case runs the JAX Pallas
band ``damerau_seqband_1v_many`` in interpret mode, as the JAX package's
tests run it on the CPU (bucket 32: its compile takes seconds).
``ops/damerau.damerau_distance`` is held against the XLA function on
aligned pairs, empty strings included.
"""

import numpy as np
import pytest
import torch

import jax

from rapidfuzz_tpu.ops import damerau as jdam
from rapidfuzz_tpu.ops.pallas import damerau_kernel as jdk
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops import damerau as dops
from rapidfuzz_tpu_torch.ops.cuda import damerau_kernel as dk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk

#: the XLA reference's one shape: rows, query pad, candidate pad
ROWS, QPAD, CPAD = 256, 72, 160
_XLA = jax.jit(jdam.damerau_distance)


def _xla(qs, chars, lens):
    """XLA distances of row ``r``'s query ``qs[r]`` to candidate row
    ``r`` (``chars [ROWS, <= CPAD]``, PAD -1)."""
    a = np.full((ROWS, QPAD), -1, np.int32)
    la = np.zeros(ROWS, np.int32)
    for r, q in enumerate(qs):
        a[r, : q.size] = q
        la[r] = q.size
    b = np.full((ROWS, CPAD), -1, np.int32)
    b[:, : chars.shape[1]] = chars
    return np.asarray(_XLA(a, la, b, lens.astype(np.int32)))


def _near(rng, q, LB, alph, n):
    """``n`` rows of bucket ``LB``: near copies of ``q`` (1-4 adjacent
    swaps, at query chars 31/32 and packed-row chars 3/4 among them, a
    swap with a char between, a substitution or an insertion), random
    rows, an empty row and a full one; PAD past each length."""
    chars = rng.choice(alph, (n, LB))
    lens = rng.integers(0, LB + 1, n)
    lens[0], lens[1] = 0, LB
    for r in range(2, n if q.size >= 2 else 2):
        if r % 4 == 3:
            continue                            # a random row
        s = list(q)
        for _ in range(int(rng.integers(1, 5))):
            p = int(rng.choice([31, 3, int(rng.integers(0, len(s) - 1))]))
            p = min(p, len(s) - 2)
            s[p], s[p + 1] = s[p + 1], s[p]
        if r % 5 == 0 and len(s) >= 3:          # ab.c -> cb.a style
            p = int(rng.integers(0, len(s) - 2))
            s[p], s[p + 2] = s[p + 2], s[p]
        if r % 3 == 0:
            s[int(rng.integers(0, len(s)))] = int(rng.choice(alph))
        if r % 7 == 0:
            s.insert(int(rng.integers(0, len(s))), int(rng.choice(alph)))
        s = s[:LB]
        chars[r, : len(s)] = s
        lens[r] = len(s)
    chars[np.arange(LB)[None, :] >= lens[:, None]] = -1
    return chars.astype(np.int32), lens.astype(np.int32)


def _port(chars, lens):
    return lk.prepare_corpus(torch.from_numpy(chars), torch.from_numpy(lens))


def _oracle(q, chars, lens):
    return np.array([oracle.damerau(q, chars[i, : lens[i]])
                     for i in range(len(lens))], np.int64)


@pytest.mark.parametrize("LB,nsym,las", [(32, 4, (0, 31)), (64, 26, (1, 33)),
                                         (128, 4, (64, 7)),
                                         (160, 26, (70, 20))])
def test_plain_matches_xla_and_oracle(LB, nsym, las):
    """Two queries over 128 candidates each: the full form equal to the
    XLA reference and the oracle, the bands under their contract."""
    rng = np.random.default_rng(LB)
    alph = np.arange(97, 97 + nsym)
    n = ROWS // 2
    qs, corpora = [], []
    for la in las:
        q = rng.choice(alph, la)
        qs.append(q)
        corpora.append(_near(rng, q, LB, alph, n))
    want = _xla([qs[0]] * n + [qs[1]] * n,
                np.concatenate([c for c, _ in corpora]),
                np.concatenate([lens for _, lens in corpora]))
    for h, (q, (chars, lens)) in enumerate(zip(qs, corpora)):
        truth = _oracle(q, chars, lens)
        np.testing.assert_array_equal(want[h * n: (h + 1) * n], truth)
        cand, lb = _port(chars, lens)
        # the wrapper runs dam_scan_plain for CPU tensors
        got = dk.dam_1v_many(q, cand, lb, mode="byte")
        np.testing.assert_array_equal(got.numpy(), truth)
        for kb in dk.DAM_BAND_BUCKETS:
            band = dk.dam_band_1v_many(q, cand, lb, kband=kb).numpy()
            ok = truth <= kb
            np.testing.assert_array_equal(band[ok], truth[ok])
            assert (band[~ok] > kb).all()
            if q.size:
                assert ok.sum() > 2
        if q.size >= 8:
            # the near copies beat Levenshtein: transpositions are counted
            lev = np.array([oracle.levenshtein_uniform(q, chars[i, : lens[i]])
                            for i in range(n)])
            assert (truth < lev).sum() > n // 4


def test_band_matches_pallas_interpret():
    """The JAX Pallas band (interpret mode, bucket 32, radius 3) and the
    port's banded form: equal where either is within the radius, both
    above it elsewhere, and exact against the oracle there."""
    rng = np.random.default_rng(7)
    alph = np.arange(97, 101)
    q = rng.choice(alph, 20)
    chars, lens = _near(rng, q, 32, alph, 2048)
    bc, lt, lbmax = jdk.prepare_corpus_seq(chars, lens)
    assert lbmax == 32 and jdk.pick_dam_band(2, lbmax) == 3
    want = np.asarray(jdk.damerau_seqband_1v_many(
        q.astype(np.int32), bc, lt, lbmax=lbmax, kband=3, interpret=True))
    cand, lb = _port(chars, lens)
    got = dk.dam_band_1v_many(q, cand, lb, kband=3).numpy()
    ok = want <= 3
    np.testing.assert_array_equal(got <= 3, ok)
    np.testing.assert_array_equal(got[ok], want[ok])
    truth = _oracle(q, chars, lens)
    np.testing.assert_array_equal(ok, truth <= 3)
    np.testing.assert_array_equal(got[ok], truth[ok])
    assert 100 < ok.sum() < 2048


def test_aligned_pairs_match_xla():
    """``ops/damerau.damerau_distance`` on aligned pairs (a query per
    row, empty strings, both longer) equal to the XLA function."""
    rng = np.random.default_rng(11)
    alph = np.arange(97, 101)
    qs = [rng.choice(alph, int(n)) for n in rng.integers(0, QPAD + 1, ROWS)]
    qs[0] = qs[1][:0]
    chars, lens = _near(rng, qs[5], CPAD, alph, ROWS)
    want = _xla(qs, chars, lens)
    a = np.full((ROWS, QPAD), -1, np.int32)
    la = np.array([q.size for q in qs], np.int32)
    for r, q in enumerate(qs):
        a[r, : q.size] = q
    # two halves: a step's [pairs, CPAD + 1] tensors stay under PyTorch's
    # CPU grain size (32,768 elements), so they run on one thread
    got = torch.cat([dops.damerau_distance(
        torch.from_numpy(a[h]), torch.from_numpy(la[h]),
        torch.from_numpy(chars[h]), torch.from_numpy(lens[h]))
        for h in (slice(0, ROWS // 2), slice(ROWS // 2, ROWS))])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    empty = lens == 0
    assert want[0] == 0 and empty.sum() > 1
    np.testing.assert_array_equal(want[empty], la[empty])
    for r in rng.choice(ROWS, 16, replace=False):
        assert want[r] == oracle.damerau(qs[r], chars[r, : lens[r]])


def test_band_radius_rule_and_wrapper_checks():
    """``pick_dam_band`` is the JAX package's rule; the wrappers refuse
    an unknown radius and a table of the wrong width, and the scratch
    plan keeps whole blocks within ``SCRATCH_BYTES``."""
    for cut in range(0, 20):
        for lbmax in (16, 32, 48, 64, 128, 1 << 30):
            assert dk.pick_dam_band(cut, lbmax) == \
                jdk.pick_dam_band(cut, lbmax)
    assert dk.DAM_BAND_BUCKETS == jdk.DAM_BAND_BUCKETS
    assert dk.MAX_TEXT == jdk.MAX_TEXT
    chars, lens = _near(np.random.default_rng(1), np.arange(97, 107), 32,
                        np.arange(97, 101), 8)
    cand, lb = _port(chars, lens)
    with pytest.raises(ValueError, match="radius"):
        dk.dam_band_1v_many(np.arange(97, 107), cand, lb, kband=5)
    _, tabs = lk.stage_query(np.arange(97, 107), "byte")
    with pytest.raises(ValueError, match="shape mismatch"):
        dk._dam_scan(40, tabs, cand, lb, "dam_scan")
    assert dk.scratch_chunk(4001, 1 << 20) % dk.BLOCK == 0
    assert 16 * 4001 * dk.scratch_chunk(4001, 1 << 20) <= dk.SCRATCH_BYTES
    assert dk.scratch_chunk(65, 1000) == 1000
