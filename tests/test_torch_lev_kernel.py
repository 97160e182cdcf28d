"""The port's kernel modules against the JAX kernels they replace.

The same numpy-seeded inputs go through the JAX Pallas kernels
(``interpret=True``, as the JAX package's own tests run them on the CPU)
and through the port's wrappers on CPU tensors, which run each kernel's
plain PyTorch version.  Integer outputs must be equal (tolerance 0).
The CUDA kernels themselves are held against the same plain versions on
the card by the ``cuda``-marked tests below and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapidfuzz_tpu.ops.pallas import band_kernel as jbk
from rapidfuzz_tpu.ops.pallas import lev_kernel as jlk
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

B = 4096   # one JAX grid cell (32 x 128)
#: candidate bucket: not a multiple of 16, so the JAX kernels in interpret
#: mode unroll their text loops by 4 rather than 16 and compile in about a
#: third of the time; the routes are those of the 64 bucket
LB = 60


def _corpus(rng, query, alphabet, n=B, lb_max=LB):
    """Near copies of ``query`` (substitutions, length changes), random
    strings, empty rows and full-length rows, PAD past each length."""
    lens = np.clip(query.size + rng.integers(-20, 21, n), 0, lb_max)
    lens[:7] = 0
    lens[7:14] = lb_max
    chars = rng.choice(alphabet, (n, lb_max))
    base = np.resize(query, lb_max) if query.size else chars[0]
    near = rng.random(n) < 0.5
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


ALPHABETS = {"byte": np.r_[0, 7, 97, 98, 99, 128, 200, 255],
             "local": np.r_[0, 1, 97, 98, 99, 100, 126, 127]}


@pytest.mark.parametrize("mode,la", [("byte", 20), ("local", 20),
                                     ("byte", 50), ("local", 64)])
def test_corpus_and_pm_tables_carried_across(mode, la):
    """The port's packed corpus and PM tables are the JAX arrays bit for
    bit, reshaped into the port's layout by the mapping functions."""
    rng = np.random.default_rng(la)
    q = rng.choice(ALPHABETS[mode], la)
    chars, lens = _corpus(rng, q, ALPHABETS[mode])
    (c3, l2), (cand, lb) = _both(chars, lens)
    jc, jl = lk.corpus_from_jax(np.asarray(c3), np.asarray(l2))
    np.testing.assert_array_equal(cand.numpy(), jc)
    np.testing.assert_array_equal(lb.numpy(), jl)
    tabs = lk.build_pm_tables(q, mode)
    np.testing.assert_array_equal(
        tabs, lk.pm_tables_from_jax(jlk.build_pm_tables(q, mode), mode))
    _, st = lk.stage_query(q, mode)
    np.testing.assert_array_equal(st.numpy(), tabs.view(np.int32))


@pytest.mark.parametrize("mode,la", [("byte", 29), ("local", 29),
                                     ("byte", 61), ("local", 0)])
def test_lev_1v_many_matches_jax(mode, la):
    """W = 1 and 2, byte and local mode, an empty query; the corpus has
    lb = 0 rows and chars 0 inside candidates."""
    rng = np.random.default_rng(100 + la)
    q = rng.choice(ALPHABETS[mode], la)
    chars, lens = _corpus(rng, q, ALPHABETS[mode])
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jlk.lev_1v_many(q, c3, l2, mode=mode,
                                     interpret=True)).reshape(-1)
    got = lk.lev_1v_many(q, cand, lb, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[lens == 0] == la).all()


def test_lev_nq_many_matches_jax():
    """16 queries of one word bucket in one launch, one of them empty."""
    rng = np.random.default_rng(7)
    a = ALPHABETS["local"]
    qs = [rng.choice(a, int(rng.integers(1, 33))) for _ in range(16)]
    qs[5] = np.empty(0, np.int64)
    chars, lens = _corpus(rng, qs[0], a)
    (c3, l2), (cand, lb) = _both(chars, lens)
    ref = np.asarray(jlk.lev_nq_many(qs, c3, l2, mode="local",
                                     interpret=True)).reshape(16, -1)
    got = lk.lev_nq_many(qs, cand, lb, mode="local")
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="word buckets"):
        lk.lev_nq_many([qs[0], np.zeros(40, np.int64)], cand, lb)


def test_remap_pack_matches_jax():
    """Wide-alphabet remap: hits, vocab misses, chars above the whole
    vocab (must miss on entry 127) and PAD, against a 127-symbol vocab."""
    rng = np.random.default_rng(3)
    pool = np.r_[np.arange(0x410, 0x450), np.arange(0x4E00, 0x4E40)]
    q = rng.permutation(pool[1:])                      # 127 distinct
    vocab, q_local = lk.query_vocab(q)
    jv, jq = jlk.query_vocab(q)
    np.testing.assert_array_equal(vocab, jv)
    np.testing.assert_array_equal(q_local, jq)
    assert lk.query_vocab(pool) is None                # 128 distinct
    chars, lens = _corpus(rng, q[:40], np.r_[pool, 0x9FFF, 5])
    ref = jlk.remap_pack(jlk.transpose_corpus(jnp.asarray(chars), LB=LB),
                         jnp.asarray(vocab), LB=LB, interpret=True)
    ct = lk.transpose_corpus(torch.from_numpy(chars))
    got = lk.remap_pack(ct, torch.from_numpy(vocab))
    ref_p, _ = lk.corpus_from_jax(np.asarray(ref), np.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), ref_p)
    ids = got.numpy().view(np.uint32)
    assert ((ids & 0xFF) == lk.MISS_ID).any()          # misses happened


@pytest.mark.parametrize("mode,cutoffs", [("local", (0, 7, 15)),
                                          ("local", (31,)),
                                          ("local", (47,)),
                                          ("byte", (2, 15))])
def test_lev_banded_matches_jax(mode, cutoffs):
    """Pinned bands bw = 1, 2, 3 (cutoffs up to 47) in both modes: exact
    values under the cutoff, BIG above it."""
    rng = np.random.default_rng(sum(cutoffs))
    q = rng.choice(ALPHABETS[mode], 56).astype(np.int32)
    chars, lens = _corpus(rng, q, ALPHABETS[mode])
    (c3, l2), (cand, lb) = _both(chars, lens)
    full = lk.lev_1v_many(q, cand, lb, mode=mode).numpy()
    for cut in cutoffs:
        ref = np.asarray(jbk.lev_banded_1v_many(
            q, c3, l2, cutoff=cut, mode=mode, interpret=True)).reshape(-1)
        got = bk.lev_banded_1v_many(q, cand, lb, cutoff=cut, mode=mode)
        np.testing.assert_array_equal(got.numpy(), ref)
        ok = full <= cut
        assert ok.any() and (~ok).any()
        np.testing.assert_array_equal(got.numpy()[ok], full[ok])
        assert (got.numpy()[~ok] == bk.BIG).all()


def test_banded_preconditions():
    """The JAX wrapper's ValueErrors, and the run-time band the port now
    serves for a query no longer than the pinned band."""
    rng = np.random.default_rng(0)
    q = rng.choice(ALPHABETS["local"], 20)
    chars, lens = _corpus(rng, q, ALPHABETS["local"], n=256)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars),
                                 torch.from_numpy(lens))
    with pytest.raises(ValueError):
        bk.lev_banded_1v_many(q, cand, lb, cutoff=48)
    with pytest.raises(ValueError):
        bk.lev_banded_1v_many(q, cand, lb, cutoff=20)
    with pytest.raises(ValueError, match="needs the pinned band"):
        bk.lev_banded_1v_many(q, cand, lb, cutoff=16)   # la <= 16*2 - 1
    full = lk.lev_1v_many(q[:12], cand, lb).numpy()
    got = bk.lev_banded_1v_many(q[:12], cand, lb, cutoff=9).numpy()
    ok = full <= 9
    assert ok.any() and (~ok).any()
    np.testing.assert_array_equal(got[ok], full[ok])
    assert (got[~ok] == bk.BIG).all()
    assert bk.band_words(15) == 1 and bk.band_words(16) == 2
    assert bk.band_words(47) == 3


def test_wrapper_argument_checks():
    """Wrong dtype, rank or contiguity is refused before any launch."""
    cand = torch.zeros((16, 256), dtype=torch.int32)
    lb = torch.zeros(256, dtype=torch.int32)
    q = np.arange(5)
    with pytest.raises(TypeError):
        lk.lev_1v_many(q, cand.to(torch.int64), lb)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lev_1v_many(q, torch.zeros((256, 16), dtype=torch.int32).t(),
                       lb)
    with pytest.raises(ValueError, match="shape"):
        lk.lev_1v_many(q, cand, lb[:128].contiguous())
    with pytest.raises(ValueError, match="expected 128"):
        lk.remap_pack(torch.zeros((64, 8), dtype=torch.int32),
                      torch.zeros(64, dtype=torch.int32))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(
    k for k in kc.LAUNCHES if not k.startswith(("lcs_", "osa_"))))
def test_kernel_matches_plain_on_card(cuda_device, kernel):
    """Each CUDA kernel equals its plain PyTorch version on the card and
    moves its launch counter."""
    rng = np.random.default_rng(11)
    a = ALPHABETS["byte"]
    q = rng.choice(a, 56)
    chars, lens = _corpus(rng, q, a)
    cand, lb = lk.prepare_corpus(torch.from_numpy(chars).to(cuda_device),
                                 torch.from_numpy(lens).to(cuda_device))
    las, tabs = lk.stage_query(q, "byte", cuda_device)
    before = kc.LAUNCHES[kernel]
    if kernel == "lev_scan":
        got = lk.lev_1v_many(q, cand, lb)
        ref = lk.lev_scan_plain(las, tabs[None], cand, lb)[0]
    elif kernel == "lev_scan_nq":
        qs = [q] * 15 + [q[:40]]
        got = lk.lev_nq_many(qs, cand, lb)
        ref = lk.lev_scan_plain(*lk.stage_queries(qs, "byte", cuda_device),
                                cand, lb)
    elif kernel == "lev_band":
        got = bk.lev_banded_1v_many(q, cand, lb, cutoff=31)
        ref = bk.lev_band_plain(56, 31, 2, tabs[: bk.table_words(56, LB)],
                                cand, lb)
    elif kernel == "lev_band_rt":
        got = bk.lev_banded_1v_many(q[:12], cand, lb, cutoff=9)
        _, t12 = lk.stage_query(q[:12], "byte", cuda_device)
        ref = bk.lev_band_plain(12, 9, 1, t12[: bk.table_words(12, LB)],
                                cand, lb, semi=9)
    elif kernel in ("lev_scan_long", "lev_band_long"):
        lchars, llens = _corpus(rng, q, a, lb_max=1536)
        cand, lb = lk.prepare_corpus(
            torch.from_numpy(lchars).to(cuda_device),
            torch.from_numpy(llens).to(cuda_device))
        if kernel == "lev_scan_long":
            got = lk.lev_1v_many(q, cand, lb)
            ref = lk.lev_scan_plain(las, tabs[None], cand, lb)[0]
        else:
            got = bk.lev_banded_stream_1v_many(q, cand, lb, cutoff=31)
            ref = bk.lev_band_plain(56, 31, 2,
                                    tabs[: bk.table_words(56, 1536)],
                                    cand, lb)
    else:
        vocab, _ = lk.query_vocab(q)
        ct = lk.transpose_corpus(torch.from_numpy(chars).to(cuda_device))
        v = torch.from_numpy(vocab).to(cuda_device)
        got = lk.remap_pack(ct, v)
        ref = lk.remap_pack_plain(ct, v)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kc.LAUNCHES[kernel] == before + 1
