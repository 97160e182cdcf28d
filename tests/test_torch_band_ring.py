"""K3's length gate, PM ring and block plan, on the CPU: the band walked in
chunks of ``CHUNK`` steps, each chunk reading PM only from the rows the
plan stages for it (zero rows outside ``[0, ws)``), corpus words through a
queue of ``AHEAD`` words, candidates in the kernel's launch order and
texts whose answer the final masks fix not walked, gives
``lev_band_plain``'s values and the oracle's (exact when within the
cutoff, BIG above it).

K3 (``csrc/lev_band.cu``) walks a text only when it is not empty and its
length is within the cutoff of the query's, stages the table rows a chunk
reads (``ring_rows``) into a shared-memory slot while the block computes
the chunk before, runs chunks that miss the horizontal phase with no
phase test (counting d0's top bits, and adding the chunk's steps to the
distance after it), holds the next ``kAhead`` packed words of its text in
registers and starts the last (longest) blocks first.  This file's model
of that walk (:func:`ring_plan`, :func:`chunk_rows`, :func:`block_map`,
:func:`_ring_band`) mirrors the kernel's plan and runs it in plain
PyTorch, every candidate at once, at the block sizes
``band_kernel.block_threads`` picks, and asserts on the way that every
step's rows lie in its chunk's slot and every word the queue hands out is
the text's.  No JAX: ``test_torch_lev_kernel.py`` holds
``lev_band_plain`` against the JAX band kernels.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda.lev_kernel import M32, PM_ROWS, u32

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
ALPHABET = np.array([32, 97, 98, 99, 100, 101, 200, 255])
CHUNK = bk.CHUNK    # the kernel's kChunk
AHEAD = 4           # the kernel's kAhead


def ring_plan(bw, semi, LB):
    """The kernel's ``ring_rows`` and slots -> ``(rows, slots)``: step ``j``
    reads rows ``widx0(j) .. widx0(j) + bw``, ``widx0(j) = (j + semi + 1 -
    32*bw) // 32``; a chunk of ``L = min(CHUNK, LB)`` steps starts ``m =
    (semi + 1 - 32*bw) % 32`` into its first row (every chunk alike,
    ``CHUNK`` being a multiple of 32), so it spans ``(m + L - 1) // 32 + bw
    + 1`` rows; two slots when the bucket takes more than one chunk."""
    m = (semi + 1 - 32 * bw) % 32
    rows = (m + max(1, min(CHUNK, LB)) - 1) // 32 + bw + 1
    return rows, 2 if CHUNK < LB else 1


def chunk_rows(c, bw, semi):
    """First table row chunk ``c`` stages: ``widx0(c * CHUNK)``."""
    return (c * CHUNK + semi + 1 - 32 * bw) >> 5


def block_map(B, threads):
    """The candidate each thread takes, in launch order (block ``i``,
    thread ``t`` at ``i * threads + t``): block ``i`` takes the candidates
    of block ``nblocks - 1 - i``; ``-1`` past ``B``."""
    nb = -(-B // threads)
    idx = (torch.arange(nb - 1, -1, -1)[:, None] * threads
           + torch.arange(threads)[None, :]).reshape(-1)
    return torch.where(idx < B, idx, -1)


@torch.inference_mode()
def _ring_band(la, cut, bw, tabs, cand, lb, semi, threads):
    """K3's gated, chunked walk in plain PyTorch -> ``[B]`` int32."""
    S = CHUNK
    WS = tabs.shape[0]
    LB = cand.shape[0] * 4
    B = lb.numel()
    rows, slots = ring_plan(bw, semi, LB)
    order = block_map(B, threads)
    tab = u32(tabs)
    c64 = u32(cand).index_select(1, order.clamp(min=0))
    lbl = torch.where(order >= 0, lb.to(torch.int64).index_select(
        0, order.clamp(min=0)), 0)
    # the walk: none where the final masks fix the answer
    n = torch.where((lbl == 0) | ((la - lbl).abs() > cut), 0,
                    lbl.clamp(max=LB))
    # a block runs chunks until its longest walk ends
    chunks = (n.view(-1, threads).max(1).values + S - 1) // S
    assert slots == 2 or int(chunks.max()) <= 1
    nw = (n + 3) // 4
    zero = torch.zeros_like(n)
    nxt = [torch.where(4 * d < n, c64[d], 0) if d < c64.shape[0] else zero
           for d in range(AHEAD)]
    off = semi + 1 - 32 * bw
    lo = 32 * bw - 1 - semi
    vp = [torch.full_like(n, (M32 << max(lo - 32 * k, 0)) & M32
                          if 32 * k + 31 >= lo else 0) for k in range(bw)]
    vn = [zero] * bw
    dist = torch.full_like(n, semi)
    top = zero          # d0's top bits over diagonal-only chunks' steps
    pstart = max(la - semi, 0)
    pend = pstart + 32 * bw - 2
    word = zero
    for c in range(int(chunks.max())):
        j0 = c * S
        assert bool((chunks.repeat_interleave(threads) > c)[n > j0].all())
        wb = chunk_rows(c, bw, semi)
        slot = torch.zeros((rows, PM_ROWS), dtype=torch.int64)
        for r in range(rows):
            if 0 <= wb + r < WS:
                slot[r] = tab[wb + r]
        hz = j0 <= pend and pstart < j0 + S
        for j in range(j0, min(j0 + S, int(n.max()))):
            if j % 4 == 0:
                r = j // 4
                word = nxt[r % AHEAD]
                assert bool((word == c64[r])[r < nw].all())
                if r + AHEAD < c64.shape[0]:
                    nxt[r % AHEAD] = torch.where(
                        r + AHEAD < nw, c64[r + AHEAD], word)
            ch = (word >> (8 * (j % 4))) & 0xFF
            loc = ((j + off) >> 5) - wb
            assert 0 <= loc and loc + bw < rows
            pw = [slot[loc + i].index_select(0, ch) for i in range(bw + 1)]
            s = (j + off) & 31
            d0, hp, hn = [], [], []
            carry = 0
            for k in range(bw):
                x = pw[k] if s == 0 else \
                    (pw[k] >> s) | ((pw[k + 1] << (32 - s)) & M32)
                t = (x & vp[k]) + vp[k] + carry
                carry = t >> 32
                d0k = ((t & M32) ^ vp[k]) | x | vn[k]
                d0.append(d0k)
                hp.append(vn[k] | (M32 ^ (d0k | vp[k])))
                hn.append(d0k & vp[k])
            kk = j - pstart
            if not hz:
                top = torch.where(j < n, top + (d0[bw - 1] >> 31), top)
            else:
                if 0 <= kk <= 32 * bw - 2:
                    rb = 32 * bw - 2 - kk
                    w, b = rb >> 5, rb & 31
                    delta = ((hp[w] >> b) & 1) - ((hn[w] >> b) & 1)
                else:
                    delta = 1 - ((d0[bw - 1] >> 31) & 1)
                dist = torch.where(j < n, dist + delta, dist)
            for k in range(bw):
                hi = ((d0[k + 1] << 31) & M32) if k + 1 < bw else 0
                d0s = (d0[k] >> 1) | hi
                vp[k] = hn[k] | (M32 ^ (d0s | hp[k]))
                vn[k] = d0s & hp[k]
        if not hz:     # a diagonal-only chunk adds its steps after it
            dist = dist + (n.clamp(max=j0 + S) - j0).clamp(min=0)
    dist = dist - top
    dist = torch.where(lbl == 0, la, dist)
    dist = torch.where((la - lbl).abs() > cut, int(bk.BIG), dist)
    dist = torch.where(dist > cut, int(bk.BIG), dist)
    out = torch.full((B,), -1, dtype=torch.int64)
    out[order[order >= 0]] = dist[order >= 0]
    return out.to(torch.int32)


def _texts(rng, q, lens, exact=2):
    """Copies of windows of ``q`` (run on cyclically past its end) with
    ~5 % of their chars substituted, the first ``exact`` whole copies of
    ``q``."""
    out = [q.astype(np.int64) for _ in range(exact)]
    lens = np.asarray(lens, dtype=np.int64)
    s0 = rng.integers(0, np.maximum(q.size - lens, 0) + 1)
    k = np.arange(max(int(lens.max()), 1))
    period = np.maximum(q.size - s0, 1)
    t = q[np.minimum(s0[:, None] + k[None, :] % period[:, None], q.size - 1)]
    t = np.where(rng.random(t.shape) < 0.05, rng.choice(ALPHABET, t.shape),
                 t).astype(np.int64)
    return out + [t[i, :n] for i, n in enumerate(lens)]


def _corpus(texts, LB):
    lens = np.array([t.size for t in texts])
    chars = np.full((len(texts), LB), -1, dtype=np.int32)
    chars[np.arange(LB)[None, :] < lens[:, None]] = np.concatenate(texts)
    return lk.prepare_corpus(torch.from_numpy(chars),
                             torch.from_numpy(lens.astype(np.int32)))


def _truth(q, texts, cut):
    """The oracle's distance where it is within ``cut``, BIG elsewhere
    (a text whose length is more than ``cut`` from the query's is over
    it)."""
    d = np.array([oracle.levenshtein_uniform(q, t)
                  if abs(t.size - q.size) <= cut else int(bk.BIG)
                  for t in texts])
    return np.where(d > cut, int(bk.BIG), d)


# (bucket, query length, bands, longest text, texts, block size): a band
# is (cutoff, bw, semi), pinned bands at semiwidth 16 * bw - 1, the
# run-time band at semi = cutoff.  The lengths hold 0, the chunk edges up
# to the longest text (one before, at, one past), lengths near the
# query's and, past those, lengths drawn up to the longest, sorted as the
# scanner sorts them, so that whole blocks lie outside the cutoff.  The
# walked texts (within the cutoff of the query's length) cross the chunk
# edges at 256 (the 257-char query), 512 (513) and 768 (770) and 1,024
# (1,030), where the horizontal phase crosses them too, and reach the end
# of the 1,056 bucket's part chunk (1,050); the 20-char query reads rows
# of ws and above as zero.  The block size is the one block_threads picks
# on an H100.
CASES = {
    "lb64_pinned": (64, 64, ((15, 1, 15), (31, 2, 31), (47, 3, 47)), 64,
                    300, 64),
    "lb64_rt": (64, 20, ((0, 1, 0), (7, 1, 7), (15, 1, 15)), 64, 300, 64),
    "lb64_pinned_t128": (64, 64, ((15, 1, 15),), 64, 40000, 128),
    "lb64_rt_t256": (64, 50, ((7, 1, 7),), 64, 70000, 256),
    "lb1056_pinned": (1056, 1030, ((15, 1, 15),), 1056, 150, 64),
    "lb1056_rt": (1056, 1050, ((7, 1, 7),), 1056, 150, 64),
    "lb2048_pinned": (2048, 513, ((47, 3, 47),), 769, 150, 64),
    "lb2048_rt": (2048, 770, ((7, 1, 7),), 769, 150, 64),
    "lb2048_edge": (2048, 257, ((15, 1, 15), (7, 1, 7)), 769, 150, 64),
}


@pytest.mark.parametrize("case", list(CASES))
@torch.inference_mode()
def test_ring_walk_matches_plain_and_oracle(case):
    LB, la, bands, top, B, threads = CASES[case]
    assert bk.block_threads(B, LB) == threads
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.choice(ALPHABET, la)
    edges = [e + d for e in range(CHUNK, top + 1, CHUNK)
             for d in (-1, 0, 1)]
    lens = [0, 1, top, top - 1, max(la - 40, 0), la + 40] + edges
    lens += list(la + rng.integers(-12, 13, 40 - len(lens)))
    lens += list(rng.integers(0, top + 1, B - 2 - len(lens)))
    lens = sorted(min(max(int(n), 0), top) for n in lens)
    texts = sorted(_texts(rng, q, lens), key=len)
    cand, lb = _corpus(texts, LB)
    _, tabs = lk.stage_query(q, "byte", CPU)
    tabs = tabs[: bk.table_words(la, LB)]
    for cut, bw, semi in bands:
        ref = bk.lev_band_plain(la, cut, bw, tabs, cand, lb, semi)
        got = _ring_band(la, cut, bw, tabs, cand, lb, semi, threads)
        assert torch.equal(got, ref), (cut, bw, semi)
        np.testing.assert_array_equal(ref.numpy(), _truth(q, texts, cut))
        assert bool((ref <= cut).any()), (cut, bw, semi)


@pytest.mark.parametrize("bw,semi", [(1, 0), (1, 7), (1, 15), (2, 31),
                                     (3, 47)])
def test_ring_plan_covers_every_step(bw, semi):
    """Every row a step of chunk ``c`` reads lies in the ``rows`` rows
    from ``chunk_rows(c)``, the last chunk's too, some chunk reads the
    last of them, and two slots fit the 48 KB the kernel takes without
    opting in."""
    off = semi + 1 - 32 * bw
    for LB in (1, 64, 100, 256, 257, 1056, 2048, 6000, 8192):
        rows, slots = ring_plan(bw, semi, LB)
        assert slots == (2 if LB > CHUNK else 1)
        assert 2 * rows * PM_ROWS * 4 <= 48 * 1024
        top = 0
        for c in range(-(-LB // CHUNK)):
            wb = chunk_rows(c, bw, semi)
            for j in range(c * CHUNK, min(c * CHUNK + CHUNK, LB)):
                w = (j + off) >> 5
                assert wb <= w and w + bw < wb + rows
                top = max(top, w + bw - wb)
        assert top == rows - 1


@pytest.mark.parametrize("B,LB,threads", [(1, 64, 64), (1000, 64, 64),
                                          (16384, 64, 64), (50000, 64, 128),
                                          (1 << 18, 64, 256),
                                          (1 << 18, 257, 64)])
def test_block_map_is_longest_first_bijection(B, LB, threads):
    """``block_threads`` reaches two blocks an SM where ``B`` allows, and
    takes 64 threads over buckets of more than one chunk; the launch
    order takes every candidate once, the last block first, and results
    written through it unsort to corpus order."""
    assert bk.block_threads(B, LB) == threads
    order = block_map(B, threads)
    assert order.numel() == -(-B // threads) * threads
    got = order[order >= 0]
    assert torch.equal(got.sort().values, torch.arange(B))
    assert int(order[0]) == (-(-B // threads) - 1) * threads
    vals = torch.arange(B) * 7 + 3
    out = torch.empty(B, dtype=torch.int64)
    out[got] = vals.index_select(0, got)
    assert torch.equal(out, vals)
