"""The port's LCS kernel modules against the JAX kernels they replace.

The same numpy-seeded inputs go through the JAX Pallas launchers
(``interpret=True``, as the JAX package's own tests run them on the CPU)
and through the port's wrappers on CPU tensors, which run the kernels'
plain PyTorch versions: ``lcs_scan`` in its one- and 16-query forms and
over a streamed bucket, and the LCS band flat and streamed.  Integer
outputs must be equal (tolerance 0), the band's underestimates for
candidates far outside it included.  The CUDA kernels are held against
the same plain versions on the card by the ``cuda``-marked test below
and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapidfuzz_tpu.ops.pallas import lcs_band_kernel as jcbk
from rapidfuzz_tpu.ops.pallas import lcs_kernel as jck
from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu.ops.pallas import stream_kernel as jsk
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk

B = 4096   # one JAX grid cell (32 x 128)
#: the bucket of ``test_torch_lcs_scan.py``'s corpus, which pads to the
#: same 4096 rows, so that in one process the two files share the JAX
#: kernels' interpret-mode compilations (byte mode, W = 1 and 8, 16
#: queries of 2 words, bands of 1-3 words); not a multiple of 8, so those
#: kernels unroll by 4
LB = 260
#: candidates the 16-query comparison runs the port on (the first ones:
#: the edge lengths and near copies): candidates are independent, and a
#: [16, NQ_CAND] plain step stays under PyTorch's grain size, so it runs
#: on one thread instead of contending with the other test workers
NQ_CAND = 1024
ALPHA = {"local": np.r_[1, 97, 98, 99, 100, 101],
         "byte": np.r_[1, 97, 98, 99, 200, 255]}


def _corpus(rng, query, alphabet, n=B, lb_max=LB, spread=20):
    """Near copies of ``query`` (kept chars, random substitutions, length
    changes), random strings, empty rows and full-bucket rows; PAD past
    each length."""
    lens = np.clip(query.size + rng.integers(-spread, spread + 1, n), 0,
                   lb_max)
    lens[:5] = 0
    lens[5:10] = lb_max
    chars = rng.choice(alphabet, (n, lb_max))
    base = np.resize(query, lb_max) if query.size else chars[0]
    near = rng.random(n) < 0.6
    keep = rng.random((n, lb_max)) > rng.random((n, 1)) * 0.4
    chars = np.where(near[:, None] & keep, base[None, :], chars)
    chars[np.arange(lb_max)[None, :] >= lens[:, None]] = -1
    return chars.astype(np.int32), lens.astype(np.int32)


def _both(chars, lens):
    """(JAX cand3, lb2) and the port's (cand, lb) of one corpus."""
    c3, l2 = jlk.prepare_corpus(jnp.asarray(chars), jnp.asarray(lens),
                                LB=chars.shape[1])
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars),
                                 torch.from_numpy(lens))
    return (c3, l2), (cand, lb)


def _lcs_truth(q, chars, lens, rows):
    return np.array([oracle.lcs_seq(q, chars[i, : lens[i]]) for i in rows])


@pytest.mark.parametrize("mode,la", [("byte", 27), ("local", 50),
                                     ("byte", 0), ("byte", 270)])
def test_lcs_1v_many_matches_jax(mode, la):
    """W = 1, 2, an empty query and W = 9 (K4 keeps up to 16 words in
    registers; ``chip_smoke.py`` holds its scratch form, W = 17, against
    the plain version on the card)."""
    rng = np.random.default_rng(la)
    q = rng.choice(ALPHA[mode], la)
    chars, lens = _corpus(rng, q, ALPHA[mode])
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jck.lcs_1v_many(q, c3, l2, mode=mode,
                                     interpret=True)).reshape(-1)
    got = ck.lcs_1v_many(q, cand, lb, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    rows = [0, 5, 10, 11, 12]
    np.testing.assert_array_equal(got.numpy()[rows],
                                  _lcs_truth(q, chars, lens, rows))


def test_lcs_nq_many_matches_jax():
    """16 queries of one word bucket (2 words) in one launch; an empty
    query in a one-word group; the port on the first :data:`NQ_CAND`
    candidates."""
    rng = np.random.default_rng(7)
    a = ALPHA["byte"]
    qs = [rng.choice(a, int(rng.integers(33, 65))) for _ in range(16)]
    chars, lens = _corpus(rng, qs[0], a)
    (c3, l2), (cand, lb) = _both(chars, lens)
    cand = cand[:, :NQ_CAND].contiguous()
    lb = lb[:NQ_CAND].contiguous()
    ref = np.asarray(jck.lcs_nq_many(qs, c3, l2, mode="byte",
                                     interpret=True)).reshape(16, -1)
    got = ck.lcs_nq_many(qs, cand, lb, mode="byte")
    np.testing.assert_array_equal(got.numpy(), ref[:, :NQ_CAND])
    empty = ck.lcs_nq_many([np.empty(0, np.int64), qs[0][:20]], cand, lb)
    assert not empty[0].any()
    np.testing.assert_array_equal(empty[1],
                                  ck.lcs_1v_many(qs[0][:20], cand, lb))
    with pytest.raises(ValueError, match="word buckets"):
        ck.lcs_nq_many([qs[0], np.zeros(70, np.int64)], cand, lb)


def _far_out(rng, chars, lens, q, alphabet, n=64):
    """Make the last ``n`` rows far out of any band: the query's second
    half followed by its first, at any length, so that most matches lie
    off the diagonal."""
    rows = np.arange(B - n, B)
    L = chars.shape[1]
    rolled = np.resize(np.roll(q, q.size // 2), L)
    for i in rows:
        m = int(rng.integers(0, L + 1))
        chars[i] = np.where(np.arange(L) < m, rolled, -1)
        lens[i] = m
    return rows


@pytest.mark.parametrize("mode,cutoffs", [("byte", (3, 15)),
                                          ("byte", (31, 47)),
                                          ("local", (10,))])
def test_lcs_banded_matches_jax(mode, cutoffs):
    """The flat band at bw = 1, 2, 3 in both modes, bit for bit with the
    JAX kernel on every candidate: exact LCS where the indel distance is
    within the cutoff, the same underestimate far outside it."""
    rng = np.random.default_rng(sum(cutoffs))
    q = rng.choice(ALPHA[mode], 56)
    chars, lens = _corpus(rng, q, ALPHA[mode])
    far = _far_out(rng, chars, lens, q, ALPHA[mode])
    (c3, l2), (cand, lb) = _both(chars, lens)
    full = ck.lcs_1v_many(q, cand, lb, mode=mode).numpy()
    indel = q.size + lens - 2 * full
    for cut in cutoffs:
        ref = np.asarray(jcbk.lcs_banded_1v_many(
            q, c3, l2, cutoff=cut, mode=mode, interpret=True)).reshape(-1)
        got = cbk.lcs_banded_1v_many(q, cand, lb, cutoff=cut, mode=mode)
        np.testing.assert_array_equal(got.numpy(), ref)
        ok = indel <= cut
        assert ok.any() and (~ok).any()
        np.testing.assert_array_equal(got.numpy()[ok], full[ok])
        assert (got.numpy() <= full).all()
        if cut <= 15:                   # the band misses far matches
            assert (got.numpy()[far] < full[far]).any()


@pytest.mark.parametrize("mode", ["byte", "local"])
def test_lcs_banded_nul_query(mode):
    """A query holding NUL (the pad byte): the JAX band reads every pad as
    a match, which is why the scanners refuse the band for such a query
    in byte mode (in local mode the JAX scanner keeps it, and its band
    then overcounts: ROADMAP queue 3); the port's threads stop at each
    candidate's length, so its band equals the JAX band over pads that
    cannot match (the same corpus padded with a char outside the
    query)."""
    rng = np.random.default_rng(12)
    a = np.r_[0, 97, 98, 99, 200 if mode == "byte" else 100]
    q = rng.choice(a, 50)
    q[[3, 20]] = 0
    chars, lens = _corpus(rng, q, a)
    (c3, l2), (cand, lb) = _both(chars, lens)
    pad = 255 if mode == "byte" else 127
    padded = np.where(np.arange(LB)[None, :] >= lens[:, None], pad, chars)
    c3x, _ = jlk.prepare_corpus(jnp.asarray(padded.astype(np.int32)),
                                jnp.asarray(lens), LB=LB)
    ref = np.asarray(jcbk.lcs_banded_1v_many(
        q, c3x, l2, cutoff=15, mode=mode, interpret=True)).reshape(-1)
    got = cbk.lcs_banded_1v_many(q, cand, lb, cutoff=15, mode=mode)
    np.testing.assert_array_equal(got.numpy(), ref)
    full = ck.lcs_1v_many(q, cand, lb, mode=mode).numpy()
    ok = q.size + lens - 2 * full <= 15
    assert ok.any()
    np.testing.assert_array_equal(got.numpy()[ok], full[ok])
    over_pads = np.asarray(jcbk.lcs_banded_1v_many(
        q, c3, l2, cutoff=15, mode=mode, interpret=True)).reshape(-1)
    assert (over_pads > full).any()     # the JAX band over 0-byte pads


def test_streamed_routes_match_jax():
    """At a 1536-char bucket (3 chunks of 512): the full LCS scan against
    ``stream_kernel.lcs_stream_1v_many`` (its launch counts as
    ``lcs_scan_long`` on the card) and the streamed band at bw 2 against
    ``lcs_banded_stream_1v_many``, with candidates far out of band (the
    flat band's test covers bw 1-3; ``chip_smoke.py`` holds the streamed
    band at bw 1 and 2 on the card)."""
    rng = np.random.default_rng(3)
    a = ALPHA["local"]
    q = rng.choice(a, 60)
    chars, lens = _corpus(rng, q, a, lb_max=1536, spread=40)
    lens[10:20] = rng.integers(1000, 1537, 10)
    chars[10:20] = rng.choice(a, (10, 1536))
    chars[np.arange(1536)[None, :] >= lens[:, None]] = -1
    far = _far_out(rng, chars, lens, q, a)
    (c3, l2), (cand, lb) = _both(chars, lens)
    q30 = q[:30]
    ref = np.asarray(jsk.lcs_stream_1v_many(q30, c3, l2, mode="local",
                                            interpret=True)).reshape(-1)
    full = ck.lcs_1v_many(q30, cand, lb, mode="local").numpy()
    np.testing.assert_array_equal(full, ref)
    rows = [0, 5, 10, int(far[0])]
    np.testing.assert_array_equal(full[rows],
                                  _lcs_truth(q30, chars, lens, rows))
    ref = np.asarray(jcbk.lcs_banded_stream_1v_many(
        q, c3, l2, cutoff=20, mode="local", interpret=True)).reshape(-1)
    got = cbk.lcs_banded_stream_1v_many(q, cand, lb, cutoff=20,
                                        mode="local").numpy()
    np.testing.assert_array_equal(got, ref)
    assert (q.size + lens - 2 * got <= 20).any()


def test_band_refusals_and_argument_checks():
    """The JAX wrappers' ValueErrors, and the shape checks before any
    launch."""
    rng = np.random.default_rng(0)
    q = rng.choice(ALPHA["local"], 20)
    chars, lens = _corpus(rng, q, ALPHA["local"], n=256, lb_max=1100)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars),
                                 torch.from_numpy(lens))
    with pytest.raises(ValueError, match="outside"):
        cbk.lcs_banded_1v_many(q, cand, lb, cutoff=48)
    with pytest.raises(ValueError, match="bucket 1100"):
        cbk.lcs_banded_1v_many(q, cand, lb, cutoff=5)
    with pytest.raises(ValueError, match="outside"):
        cbk.lcs_banded_stream_1v_many(q, cand, lb, cutoff=-1)
    with pytest.raises(ValueError, match="shape"):
        ck.lcs_1v_many(q, cand, lb[:128].contiguous())
    with pytest.raises(TypeError):
        ck.lcs_1v_many(q, cand.to(torch.int64), lb)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


LCS_KERNELS = ("lcs_scan", "lcs_scan_nq", "lcs_scan_long", "lcs_band",
               "lcs_band_long")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", LCS_KERNELS)
def test_lcs_kernel_matches_plain_on_card(cuda_device, kernel):
    """Each LCS launch route equals its plain PyTorch version on the card
    and moves its launch counter."""
    rng = np.random.default_rng(11)
    a = ALPHA["byte"]
    q = rng.choice(a, 56)
    lb_max = 1536 if kernel.endswith("_long") else LB
    chars, lens = _corpus(rng, q, a, lb_max=lb_max)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    _, tabs = lk.stage_query(q, "byte", cuda_device)
    ws = cbk.table_words(q.size, lb_max)
    before = kc.LAUNCHES[kernel]
    if kernel in ("lcs_scan", "lcs_scan_long"):
        got = ck.lcs_1v_many(q, cand, lb)
        ref = ck.lcs_scan_plain(tabs[None], cand, lb)[0]
    elif kernel == "lcs_scan_nq":
        qs = [q] * 15 + [q[:40]]
        got = ck.lcs_nq_many(qs, cand, lb)
        ref = ck.lcs_scan_plain(lk.stage_queries(qs, "byte", cuda_device)[1],
                                cand, lb)
    elif kernel == "lcs_band":
        got = cbk.lcs_banded_1v_many(q, cand, lb, cutoff=31)
        ref = cbk.lcs_band_plain(2, tabs[:ws], cand, lb)
    else:
        got = cbk.lcs_banded_stream_1v_many(q, cand, lb, cutoff=15)
        ref = cbk.lcs_band_plain(1, tabs[:ws], cand, lb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kc.LAUNCHES[kernel] == before + 1
