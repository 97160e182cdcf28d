"""The hand-off of K6's and K4's tile forms, on the CPU: a query split into
tiles of ``L`` words, one lane each, and into strips of ``S`` words, with
only the carry bits crossing between them, gives the unsplit OSA distance
and LCS length.

Both tile forms (``csrc/tile_scan.cuh``, run by ``csrc/osa_scan.cu`` and
``csrc/lcs_scan.cu``) give each CUDA lane ``L`` consecutive query words
of the recurrence's state: lane ``t`` of a candidate's group runs text
char ``s - t`` at step ``s`` and hands lane ``t + 1``, by one shuffle,
that char and the bits that cross its top word's edge; the group's lane
0 reads the text and starts them.  K6 (OSA) hands on three bits: the
horizontal carries ``(hp_c, hn_c)``, started at ``(1, 0)``, and bit 31 of
``t = ~d0_prev & pm`` of its top word, computed in its step for the same
char, started at 0.  K4 (LCS) hands on the add's carry, started at 0.
Past a strip of ``S`` words the strip's top lane packs those bits into
slots of an edge buffer (K6: 4 bits a text row, 8 rows a u32; K4: 1 bit,
32 rows a u32) that lane 0 of the next strip reads back a word at a time,
the buffer reused in place.  OSA's distance is the text's length plus
the final column's vertical deltas over the query's bits, LCS's length
the zero bits of S, each summed over the lanes.  Here that wavefront runs
in plain PyTorch, every lane of every candidate at once, with the
kernels' packing, and is held against the unsplit ``osa_scan_plain`` /
``lcs_scan_plain`` and the C++ oracle over near copies of 257- to
8,193-char queries with edits planted at word, tile and strip edges (for
OSA, adjacent swaps across them).  No JAX: the other K4 and K6 files hold
the plain versions against the JAX package.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

M32 = lk.M32
WIN = 24     # query chars a text copies on either side of an edge
KERNEL = {"osa": ok, "lcs": ck}


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in ``[0, 2**32)``."""
    return sum((x >> i) & 1 for i in range(32))


def _osa_words(pmw, st, bits):
    """K6's step over a lane's words (``osa_scan.cu:osa_word``): ``pmw``
    ``[B, G, L]``, ``st`` (vp, vn, d0p, pmp), ``bits`` the handed-on
    ``hp_c | hn_c << 1 | t << 2`` -> (new state, bits out)."""
    vp, vn, d0p, pmp = st
    hp_c, hn_c = bits & 1, (bits >> 1) & 1
    t_lo = (bits >> 2) << 31
    out = ([], [], [])
    for w in range(pmw.shape[2]):
        p, m, pm = vp[..., w], vn[..., w], pmw[..., w]
        t = (M32 ^ d0p[..., w]) & pm
        tr = (((t << 1) & M32) | (t_lo >> 31)) & pmp[..., w]
        t_lo = t
        x = pm | hn_c
        d0 = ((((x & p) + p) & M32) ^ p) | x | m | tr
        hp = m | (M32 ^ (d0 | p))
        hn = d0 & p
        hp_s = ((hp << 1) & M32) | hp_c
        hn_s = ((hn << 1) & M32) | hn_c
        out[0].append(hn_s | (M32 ^ (d0 | hp_s)))
        out[1].append(hp_s & d0)
        out[2].append(d0)
        hp_c, hn_c = hp >> 31, hn >> 31
    new = tuple(torch.stack(o, 2) for o in out) + (pmw,)
    return new, hp_c | (hn_c << 1) | ((t_lo >> 31) << 2)


def _lcs_words(pmw, st, carry):
    """K4's step over a lane's words (``lcs_scan.cu:lcs_word``)."""
    (s,) = st
    out = []
    for w in range(pmw.shape[2]):
        sw = s[..., w]
        u = sw & pmw[..., w]
        t = sw + u + carry
        carry = t >> 32
        out.append((t & M32) | (sw - u))
    return (torch.stack(out, 2),), carry


# kind -> (words step, state's initial words, lane 0's first bits, bits a
# text row's edge slot)
KINDS = {"osa": (_osa_words, (M32, 0, 0, 0), 1, 4),
         "lcs": (_lcs_words, (M32,), 0, 1)}


def _tiled(kind, q, texts, L, S, mode="byte"):
    """K6's or K4's tile form in plain PyTorch: ``G`` lanes of ``L`` words
    a candidate, strips of ``S`` words through a packed edge buffer."""
    words, init, start, slot = KINDS[kind]
    rows, smask = 32 // slot, (1 << slot) - 1
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
    # the edge buffer: u32 word r // rows of a candidate holds row r's
    # bits at slot r % rows
    edge = torch.zeros((B, -(-LB // rows)), dtype=torch.int64)
    part = torch.zeros(B, dtype=torch.int64)
    nstrip = -(-W // S)
    for st in range(nstrip):
        w0, ws = st * S, min(S, W - st * S)
        # char-major, as the kernel's shared table: [256, G * L]
        pm = torch.zeros((256, G * L), dtype=torch.int64)
        pm[:, :ws] = tab[w0: w0 + ws].t()
        state = tuple(torch.full((B, G, L), v, dtype=torch.int64)
                      for v in init)
        out = torch.zeros((B, G), dtype=torch.int64)     # handed on
        ein = torch.zeros(B, dtype=torch.int64)          # lane 0's word
        eacc = torch.zeros(B, dtype=torch.int64)         # top lane's word
        glive = -(-ws // L)
        for s in range(int(n.max()) + glive - 1):
            j = s - t                                    # [G]
            act = (j >= 0) & (j < nb)                    # [B, G]
            # shfl_up: lane t takes lane t - 1's last hand-off
            v = torch.cat([out[:, :1], out[:, :-1]], 1)
            # lane 0: the text's char and the first bits, or the edge's
            c0 = chars[:, min(s, LB - 1)]
            if st == 0:
                v0 = c0 | (start << 8)
            else:
                if s % rows == 0 and s < LB:
                    ein = torch.where(s < n, edge[:, s // rows], ein)
                v0 = c0 | (((ein >> (slot * (s % rows))) & smask) << 8)
            v[:, 0] = v0
            c = v & 0xFF
            # the lane's L PM words of its char, one gather
            pmw = pm.view(-1).index_select(
                0, (t[:, None] * L + torch.arange(L) + G * L * c[..., None]
                    ).view(-1)).view(B, G, L)
            new, bits = words(pmw, state, v >> 8)
            a3 = act[..., None]
            state = tuple(torch.where(a3, x, y) for x, y in zip(new, state))
            o = c | (bits << 8)
            out = torch.where(act, o, out)
            if st + 1 < nstrip:
                # the top lane packs its row j's bits and stores a whole
                # word after its last row of the word or the text's last
                jt = s - (G - 1)
                a = act[:, G - 1]
                r = jt % rows
                eacc = torch.where(
                    a, eacc | ((o[:, G - 1] >> 8) << (slot * r)), eacc)
                store = a & ((r == rows - 1) | (jt == n - 1))
                if bool(store.any()):
                    edge[:, jt // rows] = torch.where(
                        store, eacc, edge[:, jt // rows])
                    eacc = torch.where(store, 0, eacc)
        if kind == "lcs":
            part += _popc(M32 ^ state[0]).sum((1, 2))
        else:
            # the query's bits among each lane's words
            gw = w0 + (t * L)[:, None] + torch.arange(L)     # [G, L]
            bits = torch.clamp(la - 32 * gw, 0, 32)
            mask = torch.where(bits == 32, M32, (1 << bits) - 1)
            part += (_popc(state[0] & mask)
                     - _popc(state[1] & mask)).sum((1, 2))
    return part if kind == "lcs" else n + part


def _edit(rng, s, p, kind, alph):
    """Plants one edit at ``p`` of list ``s``: an adjacent swap of
    ``p - 1`` and ``p`` (kind 3), else a substitution, deletion or
    insertion."""
    p = min(max(p, 1), len(s) - 1)
    if kind == 3:
        s[p - 1], s[p] = s[p], s[p - 1]
    elif kind == 0:
        s[p] = int(rng.choice(alph))
    elif kind == 1:
        del s[p]
    else:
        s.insert(p, int(rng.choice(alph)))


def _edges(la, L, S):
    """The query's tile and strip edges: multiples of ``32 * L`` and
    ``32 * S`` chars inside it."""
    return sorted({p for p in range(32 * L, la, 32 * L)}
                  | {p for p in range(32 * S, la, 32 * S)})


def _query(rng, la, alph, L, S):
    """A query of ``la`` chars: random symbols of ``alph`` within WIN + 8
    chars of each edge, symbol 0 (never in a text) elsewhere.  A window of
    a long random query is a subsequence of the rest of it, edits and
    swaps included (its distance then is ``la - n`` whatever the
    hand-off); these windows are not."""
    q = np.zeros(la, np.int64)
    for e in _edges(la, L, S):
        lo, hi = max(0, e - WIN - 8), min(la, e + WIN + 8)
        q[lo:hi] = rng.choice(alph, hi - lo)
    return q


def _near(rng, q, count, alph, L, S, swaps):
    """``count`` texts around the query's edges: copies of the WIN chars
    on either side of one edge, in turn, with an edit planted across the
    edge and across a word edge (a multiple of 32) in the window
    (``swaps``: adjacent swaps, else a substitution, deletion or
    insertion), and a few random substitutions; a random text and an
    empty one."""
    edges = _edges(q.size, L, S)
    texts = [np.empty(0, np.int64), rng.choice(alph, 2 * WIN)]
    for r in range(2, count):
        e = edges[r % len(edges)]
        lo = max(0, e - WIN)
        s = list(q[lo: e + WIN])
        word = lo + 32 * int(rng.integers(0, len(s) // 32 + 1))
        for p in sorted({e - lo, min(word - lo, len(s) - 1)}, reverse=True):
            kind = 3 if swaps else (r + p) % 3
            _edit(rng, s, p + (0 if swaps else int(rng.integers(-1, 1))),
                  kind, alph)
        for _ in range(r % 3):
            s[int(rng.integers(0, len(s)))] = int(rng.choice(alph))
        texts.append(np.array(s, np.int64))
    return texts


def _plain(kind, q, texts):
    """The unsplit plain version over ``texts``."""
    lens = torch.tensor([t.size for t in texts], dtype=torch.int32)
    LB = -(-int(lens.max()) // 4) * 4
    chars = torch.full((len(texts), LB), -1, dtype=torch.int32)
    for r, t in enumerate(texts):
        chars[r, : t.size] = torch.from_numpy(t)
    cand, lb = lk.prepare_corpus(chars, lens)
    if kind == "osa":
        return ok.osa_1v_many(q, cand, lb)
    return ck.lcs_1v_many(q, cand, lb)


def _truth(kind, q, texts):
    f = oracle.osa if kind == "osa" else oracle.lcs_seq
    return np.array([f(q, t) for t in texts])


def _cases(kind):
    """(la, L, S): the kernel's tiles and strips (its ``tile_plan``) over
    the first query past its register form, one past its first lane edge
    (300 chars for K6) and two strips less and more one char (8,191 and
    8,193, the latter one past a strip); and strips of 16 words for the
    same hand-off over a 600-char query."""
    mod = KERNEL[kind]
    L, _, S = mod.tile_plan(mod.MAX_REG_W + 1)
    first = 32 * mod.MAX_REG_W + 1
    return [(kind, la, L, S) for la in (first, max(first, 32 * L) + 44,
                                        8191, 8193)] \
        + [(kind, 600, L, 16)]


@pytest.mark.parametrize("kind,la,L,S", _cases("osa") + _cases("lcs"))
@torch.inference_mode()
def test_tiles_and_strips_match_unsplit(kind, la, L, S):
    rng = np.random.default_rng(la * 10 + L + S + len(kind))
    alph = np.arange(1, 256)
    q = _query(rng, la, alph, L, S)
    texts = _near(rng, q, 8, alph, L, S, kind == "osa")
    truth = _truth(kind, q, texts)
    np.testing.assert_array_equal(
        _tiled(kind, q, texts, L, S).numpy(), truth)
    if la == _cases(kind)[1][1]:
        # the unsplit plain version too (its steps cost W times a lane's)
        np.testing.assert_array_equal(_plain(kind, q, texts).numpy(), truth)
    if kind == "osa":
        # the swaps across the edges are what OSA counts apart
        lev = np.array([oracle.levenshtein_uniform(q, t) for t in texts])
        assert (truth < lev).any()


@pytest.mark.parametrize("kind", sorted(KERNEL))
def test_tile_plan_and_edge_chunk(kind):
    """Every query past the register form gets at most a strip's lanes,
    enough for its words or a strip's, and a strip only past 128 words;
    the edge buffer's chunks are whole blocks within the budget, one chunk
    when it fits."""
    mod = KERNEL[kind]
    for W in range(mod.MAX_REG_W + 1, 400):
        L, G, S = mod.tile_plan(W)
        assert (L, S) == (mod.TILE_WORDS, lk.STRIP_WORDS) and S % L == 0
        assert 1 <= G <= S // L <= 32 and G * L >= min(W, S) > (G - 1) * L
    rows = mod.EDGE_ROWS
    assert lk.edge_chunk(8192, 131072, rows=rows) == 131072
    c = lk.edge_chunk(8192, 10**7, 16, rows)
    assert c % lk.BLOCK == 0 and c * 16 * 4 * 8192 // rows <= lk.SCRATCH_BYTES
    assert lk.edge_chunk(1 << 20, 10**7, 16, rows) == lk.BLOCK
