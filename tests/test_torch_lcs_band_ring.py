"""K5's exact stop and PM ring, on the CPU: the LCS band walked in chunks
of ``CHUNK`` steps, each chunk reading PM only from the rows the plan
stages for it (zero rows outside ``[0, ws)``), corpus words through a
queue of ``AHEAD`` words, candidates in the kernel's launch order and
every walk stopped at ``min(lb, la + 16*bw)``, gives ``lcs_band_plain``'s
values, a walk over each text's whole length, and the oracle's LCS where
the indel distance is within the band.

K5 (``csrc/lcs_band.cu``) stops a text's walk at step ``la + 16*bw``,
where every row of its window is past the query (so a step changes
nothing), stages the table rows a chunk reads (``ring_rows`` of
``csrc/band_ring.cuh``) into a shared-memory slot while the block computes
the chunk before, reads a packed word's four steps from the row and shift
of its first, holds the next ``kAhead`` packed words of its text in
registers and starts the last (longest) blocks first.  This file's model
of that walk (:func:`ring_plan`, :func:`chunk_rows`, :func:`block_map`,
:func:`_ring_lcs`) mirrors the kernel's plan and runs it in plain
PyTorch, every candidate at once, and asserts on the way that every
step's rows lie in its chunk's slot, that the word's row and shift are
the step's and that every word the queue hands out is the text's.  No
JAX: ``test_torch_lcs_kernel.py`` holds ``lcs_band_plain`` against the
JAX band kernels.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.bitpack import popcount
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda.lev_kernel import M32, PM_ROWS, u32

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
ALPHA = {"byte": np.array([32, 97, 98, 99, 100, 101, 200, 255]),
         "local": np.array([1, 2, 3, 4, 5, 6, 7])}
CHUNK = bk.CHUNK    # the kernel's kChunk
AHEAD = 8           # the kernel's kAhead


def ring_plan(bw, walk):
    """The launch's ``ring_rows`` and slots -> ``(rows, slots)``: step
    ``j`` reads rows ``widx0(j) .. widx0(j) + bw``, ``widx0(j) = (j -
    16*bw) // 32``; a chunk of ``L = min(CHUNK, walk)`` steps starts ``m =
    -16*bw % 32`` into its first row, so it spans ``(m + L - 1) // 32 + bw
    + 1`` rows; two slots when the launch's longest walk, ``min(LB, la +
    16*bw)``, takes more than one chunk."""
    m = (-16 * bw) % 32
    rows = (m + max(1, min(CHUNK, walk)) - 1) // 32 + bw + 1
    return rows, 2 if CHUNK < walk else 1


def chunk_rows(c, bw):
    """First table row chunk ``c`` stages: ``widx0(c * CHUNK)``."""
    return (c * CHUNK - 16 * bw) >> 5


def block_map(B, threads):
    """The candidate each thread takes, in launch order: block ``i`` takes
    the candidates of block ``nblocks - 1 - i``; ``-1`` past ``B``."""
    nb = -(-B // threads)
    idx = (torch.arange(nb - 1, -1, -1)[:, None] * threads
           + torch.arange(threads)[None, :]).reshape(-1)
    return torch.where(idx < B, idx, -1)


@torch.inference_mode()
def _ring_lcs(bw, tabs, cand, lb, la, threads):
    """K5's chunked, stopped walk in plain PyTorch -> ``[B]`` int32."""
    S = CHUNK
    WS = tabs.shape[0]
    LB = cand.shape[0] * 4
    B = lb.numel()
    walk = min(LB, la + 16 * bw)
    rows, slots = ring_plan(bw, walk)
    order = block_map(B, threads)
    tab = u32(tabs)
    c64 = u32(cand).index_select(1, order.clamp(min=0))
    lbl = torch.where(order >= 0, lb.to(torch.int64).index_select(
        0, order.clamp(min=0)), 0)
    n = lbl.clamp(max=walk)                 # the walk: the exact stop
    # a block runs chunks until its longest walk ends
    chunks = (n.view(-1, threads).max(1).values + S - 1) // S
    assert slots == 2 or int(chunks.max()) <= 1
    nw = (n + 3) // 4
    zero = torch.zeros_like(n)
    nxt = [torch.where(4 * d < n, c64[d], 0) if d < c64.shape[0] else zero
           for d in range(AHEAD)]
    s = [torch.full_like(n, M32) for _ in range(bw)]
    acc = zero
    word = zero
    for c in range(int(chunks.max())):
        j0 = c * S
        assert bool((chunks.repeat_interleave(threads) > c)[n > j0].all())
        wb = chunk_rows(c, bw)
        slot = torch.zeros((rows, PM_ROWS), dtype=torch.int64)
        for r in range(rows):
            if 0 <= wb + r < WS:
                slot[r] = tab[wb + r]
        for j in range(j0, min(j0 + S, int(n.max()))):
            if j % 4 == 0:
                r = j // 4
                word = nxt[r % AHEAD]
                assert bool((word == c64[r])[r < nw].all())
                if r + AHEAD < c64.shape[0]:
                    nxt[r % AHEAD] = torch.where(
                        r + AHEAD < nw, c64[r + AHEAD], word)
                # the word's row and shift base, for its four steps
                start_w = j - 16 * bw
                loc_w, sh_w = (start_w >> 5) - wb, start_w & 31
            ch = (word >> (8 * (j % 4))) & 0xFF
            loc, sh = ((j - 16 * bw) >> 5) - wb, (j - 16 * bw) & 31
            assert (loc, sh) == (loc_w, sh_w + j % 4)
            assert 0 <= loc and loc + bw < rows
            pw = [slot[loc + i].index_select(0, ch) for i in range(bw + 1)]
            ns = []
            carry = 0
            for k in range(bw):
                x = pw[k] if sh == 0 else \
                    (pw[k] >> sh) | ((pw[k + 1] << (32 - sh)) & M32)
                u = s[k] & x
                t = s[k] + u + carry
                carry = t >> 32
                ns.append((t & M32) | (s[k] ^ u))
            on = j < n
            acc = torch.where(on, acc + ((M32 ^ ns[0]) & 1), acc)
            for k in range(bw):
                hi = ((ns[k + 1] << 31) & M32) if k + 1 < bw else 1 << 31
                s[k] = torch.where(on, (ns[k] >> 1) | hi, s[k])
    for k in range(bw):
        acc = acc + popcount(M32 ^ s[k])
    out = torch.full((B,), -1, dtype=torch.int64)
    out[order[order >= 0]] = acc[order >= 0]
    return out.to(torch.int32)


def _texts(rng, q, lens, a, exact=2):
    """Copies of windows of ``q`` (run on cyclically past its end) with
    ~5 % of their chars substituted, the first ``exact`` whole copies of
    ``q``."""
    out = [q.astype(np.int64) for _ in range(exact)]
    lens = np.asarray(lens, dtype=np.int64)
    s0 = rng.integers(0, np.maximum(q.size - lens, 0) + 1)
    k = np.arange(max(int(lens.max()), 1))
    period = np.maximum(q.size - s0, 1)
    t = q[np.minimum(s0[:, None] + k[None, :] % period[:, None], q.size - 1)]
    t = np.where(rng.random(t.shape) < 0.05, rng.choice(a, t.shape),
                 t).astype(np.int64)
    return out + [t[i, :n] for i, n in enumerate(lens)]


def _to_bucket(tabs, LB):
    """``tabs`` with zero words up to an ``LB`` bucket's rows."""
    pad = -(-LB // 32) - tabs.shape[0]
    return torch.cat([tabs, tabs.new_zeros((max(pad, 0), PM_ROWS))])


def _corpus(texts, LB):
    lens = np.array([t.size for t in texts])
    chars = np.full((len(texts), LB), -1, dtype=np.int32)
    chars[np.arange(LB)[None, :] < lens[:, None]] = np.concatenate(texts)
    return lk.prepare_corpus(torch.from_numpy(chars),
                             torch.from_numpy(lens.astype(np.int32)))


# (bucket, query length, band words, PM mode): the stop la + 16*bw lies
# inside the 128 bucket at 76-108 steps, at the chunk edge 256 (la 240,
# bw 1), one before and one past it (239, 241), across it at bw 2 and 3
# (stops 262 and 278), past the 260 bucket (walks end at 260), and past
# the 512 edge over a 1,056 bucket (516, 513), where texts of 255-257 and
# 511-513 chars end their walks at chunk edges.
CASES = {
    "lb128_inside": (128, 60, (1, 2, 3), "byte"),
    "lb512_at_edge": (512, 240, (1,), "local"),
    "lb512_before_edge": (512, 239, (1,), "byte"),
    "lb512_past_edge": (512, 241, (1,), "byte"),
    "lb600_across_edge": (600, 230, (2, 3), "local"),
    "lb260_past_bucket": (260, 250, (1, 3), "byte"),
    "lb1056_two_edges": (1056, 500, (1,), "byte"),
    "lb1056_stop_513": (1056, 497, (1,), "local"),
}


@pytest.mark.parametrize("case", list(CASES))
@torch.inference_mode()
def test_ring_walk_stops_exactly(case):
    LB, la, bws, mode = CASES[case]
    a = ALPHA[mode]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.choice(a, la)
    stops = [la + 16 * bw for bw in bws]
    lens = [0, 0, 1, LB, LB - 1, la, la - 1, la + 1]
    lens += [e + d for e in stops for d in (-1, 0, 1)]
    lens += [e + d for e in (CHUNK, 2 * CHUNK) for d in (-1, 0, 1)]
    lens += list(la + rng.integers(-20, 21, 40))
    lens = sorted(min(max(int(n), 0), LB) for n in lens)
    texts = sorted(_texts(rng, q, lens, a), key=len)
    # the query behind 16*bw chars: it matches along the band's lower
    # edge, the last match at the last step before the stop
    texts += [np.r_[rng.choice(a, 16 * bw), q][:LB].astype(np.int64)
              for bw in bws]
    # rows far out of band: the query behind 64 chars of the alphabet
    far = np.r_[rng.choice(a, 64), q][:LB].astype(np.int64)
    texts += [far] * 4
    cand, lb = _corpus(texts, LB)
    _, tabs = lk.stage_query(q, mode, CPU)
    tabs = tabs[: cbk.table_words(la, LB)]
    truth = np.array([oracle.lcs_seq(q, t) for t in texts])
    indel = la + lb.numpy() - 2 * truth
    threads = bk.fill_threads(lb.numel())
    for bw in bws:
        ref = cbk.lcs_band_plain(bw, tabs, cand, lb, la)
        got = _ring_lcs(bw, tabs, cand, lb, la, threads)
        # the walk to each text's whole length: a table of zero words up
        # to the bucket and no stop before it
        whole = cbk.lcs_band_plain(bw, _to_bucket(tabs, LB), cand, lb, LB)
        assert torch.equal(got, ref), bw
        assert torch.equal(ref, whole), bw
        # exact within the band (indel <= 16*bw - 1), under it elsewhere
        ok = indel <= 16 * bw - 1
        assert ok.any() and (~ok).any(), bw
        np.testing.assert_array_equal(ref.numpy()[ok], truth[ok])
        assert (ref.numpy() <= truth).all(), bw
        if bw == 1:      # the far rows' matches lie 48+ rows off the band
            assert (ref.numpy()[-4:] < truth[-4:]).all()
        assert (ref.numpy()[lb.numpy() == 0] == 0).all()


def test_wrapper_stops_at_the_query():
    """The wrapper's plain route passes the query's length: its values
    are the stopped walk's, and equal the walk over every text's length
    (a query of 40 chars over a 1,056 bucket: 56 steps of up to 1,056)."""
    rng = np.random.default_rng(5)
    a = ALPHA["byte"]
    q = rng.choice(a, 40)
    lens = [0, 55, 56, 57, 300, 1056] + list(rng.integers(20, 61, 30))
    texts = _texts(rng, q, sorted(lens), a)
    cand, lb = _corpus(texts, 1056)
    got = cbk.lcs_banded_stream_1v_many(q, cand, lb, cutoff=15)
    _, tabs = lk.stage_query(q, "byte", CPU)
    tabs = tabs[: cbk.table_words(40, 1056)]
    assert torch.equal(got, cbk.lcs_band_plain(1, tabs, cand, lb, 40))
    assert torch.equal(got, cbk.lcs_band_plain(1, tabs, cand, lb))
    assert torch.equal(got, cbk.lcs_band_plain(
        1, _to_bucket(tabs, 1056), cand, lb, 1056))


@pytest.mark.parametrize("B,threads", [(1, 64), (2048, 64), (16384, 64),
                                       (50000, 128), (1 << 17, 256),
                                       (1 << 18, 256)])
def test_block_size_fills_the_card(B, threads):
    """K5's block: the largest that keeps two blocks an SM, at any bucket
    (the timed shapes, 131,072 and 262,144 texts, take 256 threads); the
    launch order takes every candidate once, the last block first."""
    assert bk.fill_threads(B) == threads
    order = block_map(B, threads)
    got = order[order >= 0]
    assert torch.equal(got.sort().values, torch.arange(B))
    assert int(order[0]) == (-(-B // threads) - 1) * threads


@pytest.mark.parametrize("bw", [1, 2, 3])
def test_ring_plan_covers_every_step(bw):
    """Every row a step of chunk ``c`` reads lies in the ``rows`` rows from
    ``chunk_rows(c)``, the last chunk's too, some chunk reads the last of
    them, and two slots fit the 48 KB the kernel takes without opting
    in."""
    for walk in (1, 64, 100, 255, 256, 257, 316, 1056, 4017, 8192):
        rows, slots = ring_plan(bw, walk)
        assert slots == (2 if walk > CHUNK else 1)
        assert 2 * rows * PM_ROWS * 4 <= 48 * 1024
        top = 0
        for c in range(-(-walk // CHUNK)):
            wb = chunk_rows(c, bw)
            for j in range(c * CHUNK, min(c * CHUNK + CHUNK, walk)):
                w = (j - 16 * bw) >> 5
                assert wb <= w and w + bw < wb + rows
                top = max(top, w + bw - wb)
        assert top == rows - 1
