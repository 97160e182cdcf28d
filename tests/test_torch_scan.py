"""The port's CorpusScanner against the JAX CorpusScanner.

The JAX scanner runs its Pallas routes in interpret mode on a one-device
CPU mesh (the recipe of ``tests/test_parallel.py``); the port's scanner
runs on CPU tensors, where the ops wrappers take the kernels' plain
versions and every routing decision is the one the card makes.  Results
must be equal: distances, the ``(values, valid)`` cutoff contract, hint
scans, top-k ids and values with their tie order, and ``scan_many``
across a checkpoint resume.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from rapidfuzz_tpu.distance import levenshtein as jlev
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.utils import codec


@pytest.fixture(autouse=True)
def _inference_mode():
    """Each test under ``torch.inference_mode()``: no autograd records on
    the plain versions' per-step tensors."""
    with torch.inference_mode():
        yield


def _rand(rng, alphabet, lo, hi):
    return "".join(rng.choice(alphabet, int(rng.integers(lo, hi + 1))))


def _mutant(rng, s, alphabet, edits):
    s = list(s)
    for _ in range(edits):
        i = int(rng.integers(0, max(1, len(s))))
        op = int(rng.integers(0, 3))
        if op == 0 and s:
            s[i % len(s)] = str(rng.choice(alphabet))
        elif op == 1 and s:
            del s[i % len(s)]
        else:
            s.insert(i, str(rng.choice(alphabet)))
    return "".join(s)


ASCII = list("abcdefghijklmnopqrstuvwxyz")
SMALL = list("abcde")
UNI = [chr(c) for c in (0x100, 0x3B1, 0x430, 0x431, 0x4E00, 0x1F600)]
LATIN1 = [chr(c) for c in (0, 97, 98, 99, 0xE9, 0xFF)]


#: the corpora's bucket.  100 is not a multiple of 16, so the JAX kernels
#: in interpret mode unroll their text loops by 4 rather than 16 and
#: compile in about a third of the time; every route is the one the
#: codec's 128 bucket takes (pinned bands in their flat form, W up to 4)
BUCKET = 100


def _mixed_corpus(rng, anchors, alphabet_extra):
    """Built like ``tools/hw_conformance.py:_mixed_corpus`` at a small
    size: ASCII, a transposition-rich small alphabet, boundary lengths,
    multi-word candidates (none longer than :data:`BUCKET`), plus mutants
    and exact duplicates of the anchor queries (top-k ties)."""
    out = [_rand(rng, ASCII, 0, 96) for _ in range(150)]
    out += [_rand(rng, SMALL, 2, 64) for _ in range(60)]
    out += [_rand(rng, alphabet_extra, 1, 48) for _ in range(40)]
    out += [_rand(rng, ASCII, L, L)
            for L in (0, 1, 2, 31, 32, 33, 63, 64, 65, 95, 96, 97)]
    out += [_rand(rng, ASCII, 97, BUCKET) for _ in range(12)]
    for a in anchors:
        out += [a, a, a[: len(a) // 2]]
        out += [_mutant(rng, a, ASCII, int(rng.integers(1, 6)))[:BUCKET]
                for _ in range(14)]
    rng.shuffle(out)
    return out


def _mesh1():
    return Mesh(np.array(jax.devices("cpu")[:1]), ("data",))


def _pair(corpus):
    """The JAX scanner (Pallas routes in interpret mode) and the port's,
    over one corpus at :data:`BUCKET`; built once per test module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAPIDFUZZ_TPU_FORCE_PALLAS", "interpret")
        js = JaxScanner(corpus, metric="levenshtein", mesh=_mesh1(),
                        bucket=BUCKET)
    ps = CorpusScanner(corpus, device="cpu", bucket=BUCKET)
    return js, ps


@pytest.fixture(scope="module")
def wide():
    """A corpus with chars >= 256: every query takes the remap route."""
    rng = np.random.default_rng(5)
    anchors = [_rand(rng, ASCII, 40, 40), _rand(rng, ASCII, 100, 100)]
    js, ps = _pair(_mixed_corpus(rng, anchors, UNI))
    assert js._wide and ps._wide
    return js, ps, anchors


def _same_result(a, b):
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.valid, b.valid)


def check_distances_plain_cutoff_and_hint(js, ps, anchors):
    qs = anchors + ["", "kitten", chr(0x430) * 3 + "ab"]
    for q in qs:
        np.testing.assert_array_equal(ps.distances(q), js.distances(q))
    # cutoffs: the pinned band at bw = 1 and 2, and the full-scan mask
    for q, cut in ((anchors[0], 5), (anchors[0], 0), (anchors[1], 31),
                   ("kitten", 3)):
        _same_result(ps.distances(q, score_cutoff=cut),
                     js.distances(q, score_cutoff=cut))
    np.testing.assert_array_equal(ps.distances(anchors[0], score_hint=8),
                                  js.distances(anchors[0], score_hint=8))


def check_topk_ids_values_and_ties(js, ps, anchors):
    for q, k in ((anchors[0], 5), (anchors[0], 2), (anchors[1], 7),
                 ("kitten", 4), ("zzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzz", 3)):
        pv, pi = ps.topk(q, k)
        jv, ji = js.topk(q, k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pv, jv)
    pv, pi = ps.topk(anchors[0], 6, score_cutoff=4)
    jv, ji = js.topk(anchors[0], 6, score_cutoff=4)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    # the anchor's exact duplicates tie at 0: smaller index first
    assert pv[0] == pv[1] == 0 and pi[0] < pi[1]


def test_distances_plain_cutoff_and_hint(wide):
    check_distances_plain_cutoff_and_hint(*wide)


def test_topk_ids_values_and_ties(wide):
    check_topk_ids_values_and_ties(*wide)


def test_scan_many_wide_route(wide):
    """Wide corpora scan one query at a time (the remap is per query)."""
    js, ps, anchors = wide
    queries = anchors + ["kitten", ""]
    np.testing.assert_array_equal(ps.scan_many(queries),
                                  js.scan_many(queries))
    pv, pi = ps.scan_many(queries, k=3)
    jv, ji = js.scan_many(queries, k=3)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pi, ji)


def test_weights_vocab_remap_and_unported_cases():
    rng = np.random.default_rng(2)
    corpus = [_rand(rng, ASCII, 0, 30) for _ in range(50)] + ["kitten"]
    base = CorpusScanner(corpus, device="cpu")
    d = base.distances("sitting")
    np.testing.assert_array_equal(
        CorpusScanner(corpus, weights=(3, 3, 3),
                      device="cpu").distances("sitting"), 3 * d)
    z = CorpusScanner(corpus, weights=(0, 0, 5), device="cpu")
    assert not z.distances("sitting").any()
    # elements beyond int32 go through the shared vocabulary
    big = [[2 ** 40, 5, 7], [5, 7], [2 ** 40]]
    vs = CorpusScanner(big, device="cpu")
    np.testing.assert_array_equal(vs.distances([2 ** 40, 7]), [1, 1, 1])
    np.testing.assert_array_equal(
        CorpusScanner(corpus, weights=(1, 1, 2),
                      device="cpu").distances("sitting"),
        [jlev.distance("sitting", s, weights=(1, 1, 2)) for s in corpus])
    # a general table: the weighted scan, as the JAX module scores it
    np.testing.assert_array_equal(
        CorpusScanner(corpus, weights=(1, 2, 3),
                      device="cpu").distances("sitting"),
        [jlev.distance("sitting", s, weights=(1, 2, 3)) for s in corpus])
    # buckets over 1024 chars are served (the long routes)
    np.testing.assert_array_equal(
        CorpusScanner(["a" * 1500, "ab"], device="cpu").distances("aa"),
        [1498, 1])
    with pytest.raises(NotImplementedError, match="item 8"):
        CorpusScanner(corpus, metric="prefix", device="cpu")
    wide = CorpusScanner(corpus + ["а"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        wide.distances("".join(chr(0x400 + i) for i in range(128)))
    assert codec.bucket_len(30) == 32


@pytest.mark.parametrize("batch,bucket", [
    (["kitten", "", "sitting\x00", "\xff\xe9abc"], None),
    (["kitten", "", "sitting\x00", "\xff\xe9abc"], 30),
    (["kitten", "Иванко", ""], None),
])
def test_byte_route_matches_the_codec_matrix(batch, bucket):
    """The codec's byte route gives ``encode_batch``'s rows and width (None
    past latin-1), the fingerprint of its bytes is that of the int32
    matrix, and a scanner built on it (at a bucket that is not whole
    packed words too) matches one built on the int32 route."""
    chars, lens = codec.encode_batch(batch, bucket)
    byts = codec.encode_latin1(batch, bucket)
    fp = codec.fingerprint([chars], lens)
    if max(map(ord, "".join(batch))) >= 256:
        assert byts is None
        return
    c8, l8 = byts
    assert c8.dtype == np.uint8 and c8.shape == chars.shape
    np.testing.assert_array_equal(l8, lens)
    np.testing.assert_array_equal(np.where(chars < 0, 0, chars), c8)
    assert codec.fingerprint([c8[:1], c8[1:]], lens) == fp
    sc = CorpusScanner(batch, bucket=bucket, device="cpu")
    ref = CorpusScanner([s.encode("latin-1") for s in batch],
                        bucket=bucket, device="cpu")
    assert sc._fingerprint == fp
    for q in ("kitten", "\xe9ab", ""):
        np.testing.assert_array_equal(sc.distances(q), ref.distances(q))
