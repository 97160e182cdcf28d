"""The hand-off of K1's tile form, on the CPU: a query split into tiles of
``L`` words, one lane each, and into strips of ``S`` words, with only the
horizontal carries crossing between them, gives the unsplit distance.

K1's tile form (``csrc/lev_scan.cu``) gives each CUDA lane ``L``
consecutive words of VP/VN: lane ``t`` of a candidate's group runs text
char ``s - t`` at step ``s`` and hands lane ``t + 1``, by one shuffle,
that char and the carries ``(hp_c, hn_c)`` out of its top word; the
group's lane 0 reads the text and starts the carries at ``(1, 0)``.  Past
a strip of ``S`` words, the strip's top lane packs its carries, 2 bits a
text row, 16 rows a u32, into an edge buffer that lane 0 of the next strip
reads back a word at a time, the buffer reused in place.  The distance is
the text's length plus the final column's vertical deltas over the
query's bits, summed over the lanes.  Here that wavefront runs in plain
PyTorch, every lane of every candidate at once, with the kernel's
packing, and is held against the unsplit ``lev_scan_plain`` and the C++
oracle over near copies of 257- to 4,097-char queries with edits planted
at word, tile and strip edges.  No JAX: the other K1 files hold
``lev_scan_plain`` against the JAX package.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

M32 = lk.M32
ROWS = lk.EDGE_ROWS
WIN = 32     # query chars a text copies on either side of an edge


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in ``[0, 2**32)``."""
    return sum((x >> i) & 1 for i in range(32))


def _tiled(q, texts, L, S, mode="byte"):
    """K1's tile form in plain PyTorch: ``G`` lanes of ``L`` words a
    candidate, strips of ``S`` words through a packed edge buffer."""
    la, B = q.size, len(texts)
    W = lk.words(la)
    tab = lk.u32(lk.stage_query(q, mode)[1])             # [W, 256]
    G = min(-(-W // L), S // L)
    n = torch.tensor([t.size for t in texts])
    LB = max(int(n.max()), 1)
    chars = torch.zeros((B, LB), dtype=torch.int64)
    for b, t in enumerate(texts):
        chars[b, : t.size] = torch.from_numpy(t)
    t = torch.arange(G)
    nb = n[:, None]
    # the edge buffer: u32 word r // 16 of a candidate holds row r's
    # (hp_c, hn_c) at bits 2 * (r % 16), 2 * (r % 16) + 1
    edge = torch.zeros((B, -(-LB // ROWS)), dtype=torch.int64)
    part = torch.zeros(B, dtype=torch.int64)
    nstrip = -(-W // S)
    for st in range(nstrip):
        w0, ws = st * S, min(S, W - st * S)
        # char-major, as the kernel's shared table: [256, G * L]
        pm = torch.zeros((256, G * L), dtype=torch.int64)
        pm[:, :ws] = tab[w0: w0 + ws].t()
        vp = torch.full((B, G, L), M32, dtype=torch.int64)
        vn = torch.zeros_like(vp)
        out = torch.zeros((B, G), dtype=torch.int64)     # handed on
        ein = torch.zeros(B, dtype=torch.int64)          # lane 0's word
        eacc = torch.zeros(B, dtype=torch.int64)         # top lane's word
        glive = -(-ws // L)
        for s in range(int(n.max()) + glive - 1):
            j = s - t                                    # [G]
            act = (j >= 0) & (j < nb)                    # [B, G]
            # shfl_up: lane t takes lane t - 1's last hand-off
            v = torch.cat([out[:, :1], out[:, :-1]], 1)
            # lane 0: the text's char and (1, 0), or the strip edge's
            c0 = chars[:, min(s, LB - 1)]
            if st == 0:
                v0 = c0 | (1 << 8)
            else:
                if s % ROWS == 0 and s < LB:
                    ein = torch.where(s < n, edge[:, s // ROWS], ein)
                v0 = c0 | (((ein >> (2 * (s % ROWS))) & 3) << 8)
            v[:, 0] = v0
            c = v & 0xFF
            hp_c, hn_c = (v >> 8) & 1, (v >> 9) & 1
            # the lane's L PM words of its char, one gather
            pmw = pm.view(-1).index_select(
                0, (t[:, None] * L + torch.arange(L) + G * L * c[..., None]
                    ).view(-1)).view(B, G, L)
            nvp, nvn = [], []
            for w in range(L):
                x = pmw[:, :, w] | hn_c
                p, m = vp[:, :, w], vn[:, :, w]
                d0 = ((((x & p) + p) & M32) ^ p) | x | m
                hp = m | (M32 ^ (d0 | p))
                hn = d0 & p
                hp_s = ((hp << 1) & M32) | hp_c
                hn_s = ((hn << 1) & M32) | hn_c
                nvp.append(hn_s | (M32 ^ (d0 | hp_s)))
                nvn.append(hp_s & d0)
                hp_c, hn_c = hp >> 31, hn >> 31
            a3 = act[..., None]
            vp = torch.where(a3, torch.stack(nvp, 2), vp)
            vn = torch.where(a3, torch.stack(nvn, 2), vn)
            o = c | (hp_c << 8) | (hn_c << 9)
            out = torch.where(act, o, out)
            if st + 1 < nstrip:
                # the top lane packs its row j's carries and stores a
                # whole word after its 16th row or the text's last
                jt = s - (G - 1)
                a = act[:, G - 1]
                r = jt % ROWS
                eacc = torch.where(a, eacc | ((o[:, G - 1] >> 8) << (2 * r)),
                                   eacc)
                store = a & ((r == ROWS - 1) | (jt == n - 1))
                if bool(store.any()):
                    edge[:, jt // ROWS] = torch.where(
                        store, eacc, edge[:, jt // ROWS])
                    eacc = torch.where(store, 0, eacc)
        # the query's bits among each lane's words
        gw = w0 + (t * L)[:, None] + torch.arange(L)     # [G, L]
        bits = torch.clamp(la - 32 * gw, 0, 32)
        mask = torch.where(bits == 32, M32, (1 << bits) - 1)
        part += (_popc(vp & mask) - _popc(vn & mask)).sum((1, 2))
    return n + part


def _near(rng, q, count, alph, L, S):
    """``count`` texts around the query's tile and strip edges (multiples
    of ``32 * L`` and ``32 * S`` chars): copies of the WIN chars on either
    side of one such edge, in turn, with a substitution, deletion or
    insertion planted beside the edge and beside a word edge (a multiple
    of 32) in the window, and a few random edits; a random text and an
    empty one."""
    la = q.size
    edges = sorted({p for p in range(32 * L, la, 32 * L)}
                   | {p for p in range(32 * S, la, 32 * S)})
    texts = [np.empty(0, np.int64), rng.choice(alph, 2 * WIN)]
    for r in range(2, count):
        e = edges[r % len(edges)]
        lo = max(0, e - WIN)
        s = list(q[lo: e + WIN])
        word = lo + 32 * int(rng.integers(0, len(s) // 32 + 1))
        for p in sorted({e - lo, min(word - lo, len(s) - 1)}, reverse=True):
            p = max(0, p + int(rng.integers(-1, 1)))
            kind = (r + p) % 3
            if kind == 0:
                s[p] = int(rng.choice(alph))
            elif kind == 1:
                del s[p]
            else:
                s.insert(p, int(rng.choice(alph)))
        for _ in range(r % 3):
            s[int(rng.integers(0, len(s)))] = int(rng.choice(alph))
        texts.append(np.array(s, np.int64))
    return texts


# (la, L, S): the kernel's tiles and strips (lk.tile_plan), and strips of
# 16 words for the same hand-off over a 600-char query (two strips of two
# lanes); 8,191 and 8,193 are a whole warp's tiles (32 x 8 words, two
# strips) less and more one char, the latter one past a strip
PLAN = lk.tile_plan(lk.MAX_REG_W + 1)
CASES = [(257, PLAN[0], PLAN[2]), (300, PLAN[0], PLAN[2]),
         (600, PLAN[0], 16), (8191, PLAN[0], PLAN[2]),
         (8193, PLAN[0], PLAN[2])]


@pytest.mark.parametrize("la,L,S", CASES)
@torch.inference_mode()
def test_tiles_and_strips_match_unsplit(la, L, S):
    rng = np.random.default_rng(la * 10 + L + S)
    alph = np.arange(97, 123)
    q = rng.choice(alph, la)
    texts = _near(rng, q, 12, alph, L, S)
    truth = np.array([oracle.levenshtein_uniform(q, t) for t in texts])
    np.testing.assert_array_equal(_tiled(q, texts, L, S).numpy(), truth)
    if la == 300:
        # the unsplit plain version too (its steps cost W times a lane's)
        lens = torch.tensor([t.size for t in texts], dtype=torch.int32)
        LB = -(-int(lens.max()) // 4) * 4
        chars = torch.full((len(texts), LB), -1, dtype=torch.int32)
        for r, t in enumerate(texts):
            chars[r, : t.size] = torch.from_numpy(t)
        cand, lb = lk.prepare_corpus(chars, lens)
        np.testing.assert_array_equal(
            lk.lev_1v_many(q, cand, lb).numpy(), truth)


def test_tile_plan_and_edge_chunk():
    """Every query past the register form gets at most a strip's lanes,
    enough for its words or a strip's, and a strip only past 128 words;
    the edge buffer's chunks are whole blocks within the budget, one chunk
    when it fits."""
    for W in range(lk.MAX_REG_W + 1, 400):
        L, G, S = lk.tile_plan(W)
        assert (L, S) == (lk.TILE_WORDS, lk.STRIP_WORDS) and S % L == 0
        assert 2 <= G <= S // L and G * L >= min(W, S) > (G - 1) * L
    assert lk.edge_chunk(8192, 131072) == 131072
    c = lk.edge_chunk(8192, 10**7, 16)
    assert c % lk.BLOCK == 0
    assert c * 16 * 4 * 8192 // lk.EDGE_ROWS <= lk.SCRATCH_BYTES
    assert lk.edge_chunk(1 << 20, 10**7, 16) == lk.BLOCK
