"""The hand-off of K7's tile form, on the CPU: a query split into tiles of
32 positions, one lane each, and into strips of 1,024, with only a tile's
right-edge value crossing between them, gives the unsplit distance.

K7's tile form (``csrc/wlev_scan.cu``) gives each CUDA lane
``wlev_kernel.TILE`` consecutive query positions of a candidate's row:
lane ``t`` of the candidate's group runs text row ``s - t`` at step ``s``
and hands lane ``t + 1``, by one shuffle each, its row's char and
``D[i][c0]`` at that lane's left edge ``c0``; the value taken a row
earlier is the diagonal ``D[i-1][c0]``.  The group's lane 0 reads the text
and starts the row at ``D[i][0] = i * ins``.  Past a strip of
``wlev_kernel.STRIP`` positions, the strip's last lane writes its right
edge per text row to an int32 edge buffer that lane 0 of the next strip
reads back a row ahead of its use, the buffer reused in place.  Here that
wavefront runs in plain PyTorch, every lane of every candidate at once,
and is held against the unsplit ``wlev_scan_plain`` and the C++ oracle
over near copies of 129- to 2,100-char queries with edits planted at
tile and strip edges, under ``(1, 2, 3)`` and ``(3, 2, 1)``.  No JAX:
``test_torch_wlev_scan.py`` holds ``wlev_scan_plain`` against the JAX
kernels.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel as wk

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

TILE = wk.TILE
WIN = 40     # query chars a text copies on either side of an edge


def _tiled(q, texts, w, strip=wk.STRIP):
    """K7's tile form in plain PyTorch: ``G`` lanes of TILE positions a
    candidate, strips of ``strip`` positions through an int32 edge
    buffer reused in place."""
    ins, dele, sub = w
    la, B = q.size, len(texts)
    W = lk.words(la)
    tab = lk.u32(lk.stage_query(q, "byte")[1])           # [W, 256]
    G = min(strip // TILE, -(-la // TILE))
    n = torch.tensor([t.size for t in texts])
    LB = max(int(n.max()), 1)
    chars = torch.zeros((B, LB + 1), dtype=torch.int64)
    for b, t in enumerate(texts):
        chars[b, 1: t.size + 1] = torch.from_numpy(t)
    t = torch.arange(G)
    nb = n[:, None]
    p1 = torch.arange(1, TILE + 1)                       # a tile's columns
    edge = torch.zeros((B, LB), dtype=torch.int64)       # row i at i - 1
    nstrip = -(-la // strip)
    for st in range(nstrip):
        cs = st * strip
        c0 = cs + TILE * t                               # [G]
        glive = min(G, -(-(la - cs) // TILE))
        # the strip's table, char-major: [256 * G, TILE] costs of each
        # char at each lane's positions (sub where the PM bit is clear;
        # positions past the table's words never match)
        pos = c0[:, None] + torch.arange(TILE)           # [G, TILE]
        word = tab.index_select(0, (pos // 32).clamp(max=W - 1).view(-1))
        bit = (word >> (pos % 32).view(-1, 1)) & 1       # [G*TILE, 256]
        bit = torch.where((pos // 32 < W).view(-1, 1), bit, 0)
        cost = ((1 - bit) * sub).t().reshape(256 * G, TILE)
        D = ((c0[:, None] + p1) * dele).expand(B, G, TILE).clone()
        diag = (c0 * dele).expand(B, G).clone()          # D[i-1][c0]
        o = torch.zeros((B, G), dtype=torch.int64)       # D[i][c0 + TILE]
        oc = torch.zeros((B, G), dtype=torch.int64)      # its char
        enext = edge[:, 0].clone()                       # lane 0's next row
        for s in range(1, int(n.max()) + glive):
            i = s - t                                    # [G]
            # lanes past la's run rows that no lane reads, as the kernel's
            act = (i >= 1) & (i <= nb)                   # [B, G]
            # shfl_up: lane t takes lane t - 1's last row
            left = torch.cat([o[:, :1], o[:, :-1]], 1)
            ch = torch.cat([oc[:, :1], oc[:, :-1]], 1)
            # lane 0: the text's char, and i * ins or the strip edge
            ch[:, 0] = chars[:, min(s, LB)]
            if st == 0:
                left[:, 0] = s * ins
            else:
                left[:, 0] = enext
                if s < LB:
                    enext = torch.where(s < n, edge[:, s], enext)
            c = cost.index_select(0, (ch * G + t).view(-1)).view(B, G, TILE)
            # t[p] = min(D_old[p] + ins, D_old[p-1] + cost), then the
            # chain D[p] = min(t[p], D[p-1] + del) from the left edge as a
            # prefix minimum of D - p * del
            dg = torch.cat([diag[..., None], D[..., :-1]], 2)
            tt = torch.minimum(D + ins, dg + c)
            e = torch.cat([left[..., None], tt - p1 * dele], 2)
            new = torch.cummin(e, 2).values[..., 1:] + p1 * dele
            D = torch.where(act[..., None], new, D)
            diag = torch.where(act, left, diag)
            o = torch.where(act, new[..., -1], o)
            oc = torch.where(act, ch, oc)
            if st + 1 < nstrip:
                # the last lane's row s - (G - 1) at its right edge
                il = s - (G - 1)
                if il >= 1:
                    edge[:, il - 1] = torch.where(act[:, G - 1],
                                                  new[:, G - 1, -1],
                                                  edge[:, il - 1])
    tla = (la - 1 - (nstrip - 1) * strip) // TILE
    return D[:, tla, (la - 1) % TILE]


def _near(rng, q, count, alph, strip):
    """``count`` texts: near copies of the query (with edits at tile
    edges, multiples of TILE) when it fits a strip and is short, else
    copies of the WIN chars on either side of a tile or strip edge, in
    turn; each with a substitution, deletion or insertion planted beside
    the edge and a few random edits; texts of 0-3 chars (shorter than a
    group's ramp) and a random one."""
    la = q.size
    texts = [np.empty(0, np.int64)] + [rng.choice(alph, k) for k in (1, 2, 3)]
    texts.append(rng.choice(alph, 2 * WIN))
    tiles = list(range(TILE, la, TILE))
    strips = list(range(strip, la, strip))
    whole = la <= 320
    for r in range(len(texts), count):
        e = int(rng.choice(strips if strips and r % 2 else tiles))
        lo = 0 if whole else max(0, e - WIN)
        s = list(q[lo: la if whole else e + WIN])
        for p in sorted({e - lo, int(rng.choice(tiles)) - lo}
                        if whole else {e - lo}, reverse=True):
            p = min(len(s) - 1, max(0, p + int(rng.integers(-1, 1))))
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


def _corpus(texts):
    lens = torch.tensor([t.size for t in texts], dtype=torch.int32)
    LB = max(4, -(-int(lens.max()) // 4) * 4)
    chars = torch.full((len(texts), LB), -1, dtype=torch.int32)
    for r, t in enumerate(texts):
        chars[r, : t.size] = torch.from_numpy(t)
    return lk.prepare_corpus(chars, lens)


# (la, strip, weights): one lane past the register form (5 lanes, the
# last holding one position), 300 chars in the kernel's strip and in
# strips of 64 (two lanes, five strips), a full strip, one position past
# it, and three strips
CASES = [(129, wk.STRIP, (1, 2, 3)), (300, wk.STRIP, (3, 2, 1)),
         (300, 64, (1, 2, 3)), (1024, wk.STRIP, (3, 2, 1)),
         (1025, wk.STRIP, (1, 2, 3)), (2100, wk.STRIP, (3, 2, 1))]


@pytest.mark.parametrize("la,strip,w", CASES)
@torch.inference_mode()
def test_tiles_and_strips_match_unsplit(la, strip, w):
    rng = np.random.default_rng(la + strip)
    alph = np.arange(97, 123)
    q = rng.choice(alph, la)
    texts = _near(rng, q, 14, alph, strip)
    truth = np.array([oracle.levenshtein_weighted(q, t, *w) for t in texts])
    np.testing.assert_array_equal(_tiled(q, texts, w, strip).numpy(), truth)
    cand, lb = _corpus(texts)
    _, tabs = lk.stage_query(q, "byte")
    np.testing.assert_array_equal(
        wk.wlev_scan_plain(la, tabs, cand, lb, *w).numpy(), truth)


def test_edge_chunk():
    """The edge buffer's chunks are whole blocks within the budget, one
    chunk when the buffers fit, one block at least."""
    assert wk.STRIP == 32 * wk.TILE and wk.MAX_REG_LA < wk.STRIP
    assert wk.edge_chunk(8192, 16384) == 16384
    c = wk.edge_chunk(8192, 131072)
    assert c % wk.BLOCK == 0 and c * 4 * 8192 <= wk.SCRATCH_BYTES
    assert -(-131072 // c) == 4
    assert wk.edge_chunk(1 << 20, 10**7) == wk.BLOCK
    assert wk.edge_chunk(64, 100) == 100
