"""The edge set of K9's full form, on the CPU: a query split into tiles of
32 columns, and into strips of 1,024, with only the kernel's left-edge
values crossing between them, gives the unsplit distance.

K9 gives each CUDA lane a tile of ``damerau_kernel.TILE`` query columns:
lane ``t`` runs text row ``s - t`` at step ``s`` and hands lane ``t + 1``
its row's ``D[i][c0]``, ``D[i][c0 - 1]``, ``rt`` and char; past
``damerau_kernel.STRIP`` columns, lane 31 writes ``D[i][c]``,
``D[i][c - 1]`` and ``rt`` per text row to an edge buffer that lane 0 of
the next strip reads, with ``eq(i, c)`` taken from the PM table.  Here the
same wavefront runs in plain PyTorch, every tile at once through
``ops/damerau.full_row`` with those values as its left-edge inputs, and is
held against the unsplit ``dam_scan_plain`` and the C++ oracle over near
copies of 33-, 64-, 100- and 1,025-char queries with adjacent swaps
planted across tile and strip edges (31/32, 63/64, 1023/1024), swaps
around a char, and transpositions with a char deleted or inserted
between.  No JAX: the other Damerau files hold ``dam_scan_plain`` against
the JAX package.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import damerau_kernel as dk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
from rapidfuzz_tpu_torch.ops.damerau import BIG, full_row

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

TILE = dk.TILE


def _near(rng, q, n, alph, start=0):
    """``n`` texts: near copies of ``q[start:]`` with 1-3 adjacent swaps
    (across the tile and strip edges among them) and one transposition
    with an edit between at an edge: a swap around a char
    (``abc -> cba``), a swap with a char deleted between (``axb -> ba``:
    only the row's carried rt finds it) or inserted between
    (``ab -> bya``: only ``eq(i, j - 1)`` and ``X`` find it); some with a
    substitution or an insertion; a random text and an empty one.  A copy
    of ``q``'s tail reaches the query's last columns in a few rows where
    no text holds ``q[:start]``'s symbols."""
    texts = [np.empty(0, np.int64), rng.choice(alph, q.size - start + 3)]
    m = q.size - start
    edges = [p - start for p in (30, 31, 62, 63, 1022, 1023)
             if 0 <= p - start < m - 1]
    gaps = [p for p in edges if p + 2 < m]
    for r in range(2, n):
        s = list(q[start:])
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.choice(edges + [int(rng.integers(0, len(s) - 1))]))
            s[p], s[p + 1] = s[p + 1], s[p]
        if r % 3 == 0:
            p = int(rng.choice(gaps))
            s[p], s[p + 2] = s[p + 2], s[p]
        elif r % 3 == 1:
            p = int(rng.choice(gaps))
            s[p: p + 3] = [s[p + 2], s[p]]
        else:
            p = int(rng.choice(edges))
            s[p: p + 2] = [s[p + 1], int(rng.choice(alph)), s[p]]
        if r % 4 == 0:
            s[int(rng.integers(0, len(s)))] = int(rng.choice(alph))
        if r % 5 == 0:
            s.insert(int(rng.integers(0, len(s))), int(rng.choice(alph)))
        texts.append(np.array(s, np.int64))
    return texts


def _tiled(q, texts, strip):
    """K9's wavefront in plain PyTorch: tiles of TILE columns in strips of
    ``strip``; only the left-edge values cross a tile or strip edge.  The
    kernel sweeps strips one after another through its edge buffer; here
    a strip's first tile runs one step behind the last tile of the strip
    before, as the tiles of a strip do, so the same values cross."""
    la, B = q.size, len(texts)
    n = torch.tensor([t.size for t in texts])
    LB = int(n.max())
    chars = torch.full((B, LB + 1), 256, dtype=torch.int64)
    for b, t in enumerate(texts):
        chars[b, 1: t.size + 1] = torch.from_numpy(t)
    G = -(-la // TILE)
    # eq[c, j - 1] = eq(c, j); row 256 (past a text's end) and the
    # columns past la all false, as the PM table's bits are
    eq = torch.zeros((257, G * TILE), dtype=torch.bool)
    eq[torch.from_numpy(q), torch.arange(la)] = True
    tiles = eq.view(257, G, TILE).reshape(257 * G, TILE)
    N = B * G
    t = torch.arange(G).repeat(B)[:, None]                 # [N, 1]
    b = torch.arange(B).repeat_interleave(G)
    c0 = TILE * t
    nb = n[b][:, None]
    # a strip's first tile: eq(i, c0) from the table, not from the left
    # (gathers by index_select: advanced indexing in a step stalls under
    # several test workers)
    lead = (c0 % strip == 0).expand(N, 4)
    d1 = c0 + torch.arange(TILE + 1)                       # row 0
    d2 = torch.full_like(d1, BIG)
    x = torch.full((N, TILE), BIG, dtype=torch.int64)
    pe = torch.zeros((N, TILE), dtype=torch.bool)
    hm = torch.where(c0 > 0, c0 - 1, BIG)                  # D[i-1][c0 - 1]
    # what each tile hands on after its last row: D[i][c0 + 32],
    # D[i][c0 + 31], rt, eq(i, c0 + 32)
    out = torch.zeros((N, 4), dtype=torch.int64)
    for s in range(1, LB + G):
        i = s - t
        act = (i >= 1) & (i <= nb)
        ic = i.clamp(0, LB)[:, 0]
        ch = chars.view(-1).index_select(0, b * (LB + 1) + ic)
        inp = torch.cat([out[:1], out[:-1]])
        # tile 0: column 0; a strip's first tile: the strip edge's three
        # values and eq(i, c0) from the table
        e0 = eq.view(-1).index_select(
            0, ch * G * TILE + (c0[:, 0] - 1).clamp(min=0))
        edge = torch.stack([inp[:, 0], inp[:, 1], inp[:, 2], e0.long()], 1)
        col0 = torch.stack([ic, torch.full_like(ic, BIG),
                            torch.full_like(ic, BIG), torch.zeros_like(ic)],
                           1)
        inp = torch.where(lead, torch.where(c0 == 0, col0, edge), inp)
        e = tiles.index_select(0, ch * G + t[:, 0])
        new, nx, rt = full_row(e, pe, d1, d2, x, i, left=inp[:, 0],
                               dprev=hm, rt=inp[:, 2], e1=inp[:, 3].bool(),
                               c0=c0)
        d1, d2 = torch.where(act, new, d1), torch.where(act, d1, d2)
        x = torch.where(act, nx, x)
        pe = torch.where(act, e, pe)
        hm = torch.where(act, inp[:, 1:2], hm)
        out = torch.where(act, torch.stack(
            [new[:, TILE], new[:, TILE - 1], rt, e[:, TILE - 1]], 1), out)
    p = (la - 1) % TILE
    return torch.where(n > 0, d1.view(B, G, TILE + 1)[:, -1, p + 1], la)


@pytest.mark.parametrize("la", [33, 64, 100, 1025])
@torch.inference_mode()
def test_tiles_and_strips_match_unsplit(la):
    rng = np.random.default_rng(la)
    alph = np.arange(97, 105)
    q = rng.choice(alph, la)
    start = 0
    if la > dk.STRIP:
        # the texts copy the query's last 48 chars, and its others are of
        # symbols no text holds: every alignment deletes those, so the
        # copies cross the strip edge at 1,024 diagonally in ~48 rows
        # (whole copies take ~1,060 steps, seconds here); 26 symbols, so
        # that few swaps there exchange equal chars
        start = la - 48
        alph = np.arange(97, 123)
        q = np.r_[rng.choice(np.arange(200, 208), start),
                  rng.choice(alph, 48)]
    texts = _near(rng, q, 24, alph, start)
    truth = np.array([oracle.damerau(q, t) for t in texts], np.int64)
    lens = torch.tensor([t.size for t in texts], dtype=torch.int32)
    LB = -(-int(lens.max()) // 4) * 4
    chars = torch.full((len(texts), LB), -1, dtype=torch.int32)
    for r, t in enumerate(texts):
        chars[r, : t.size] = torch.from_numpy(t)
    cand, lb = lk.prepare_corpus(chars, lens)
    _, tabs = lk.stage_query(q, "byte")
    np.testing.assert_array_equal(
        dk.dam_scan_plain(la, tabs, cand, lb).numpy(), truth)
    for strip in (dk.STRIP, 64) if la < 1000 else (dk.STRIP,):
        np.testing.assert_array_equal(_tiled(q, texts, strip).numpy(), truth)
    lev = np.array([oracle.levenshtein_uniform(q, t) for t in texts])
    assert (truth < lev).sum() > len(texts) // 3
