"""Batched unrestricted Damerau-Levenshtein distance over aligned pairs,
in plain PyTorch.

Counterpart of ``rapidfuzz_tpu/ops/damerau.py:damerau_distance`` (XLA code
with no Pallas twin): the Zhao-Sahni linear-space form of Lowrance-Wagner
(``damerau_levenshtein.rs:111-168``), one DP row per step of the first
string, vectorised over pairs and the second string's columns.  It serves
the library's aligned-pair batches; one-vs-many scans over a corpus go
through the scanner and K9 (``ops/cuda/damerau_kernel.py``), whose plain
versions take their row step, :func:`full_row`, from here.

The row is rewritten on three facts of the recurrence: the last row that
holds column ``j``'s char is the previous one iff the previous row's char
equals it; the last match of this row's char left of ``j`` is at ``j - 1``
iff this row's char equals column ``j - 1``'s; ``FR[j]`` and ``K[j]``
change together, so one array ``X = FR - K`` carries both.  The two
in-row dependencies are prefix scans, as the XLA form does: the left
neighbour ``new[j] = min(t[j], new[j-1] + 1)`` is ``torch.cummin`` of
``t - j``, and the row's last match ``(column, D[i-2][column-1])`` is
packed into one int64 (column in the high half) that one
``torch.cummax`` carries.
"""

from __future__ import annotations

import torch

from .levenshtein import _lengths

#: "no path": above every distance, and every sum with a length stays in
#: int32 (K9's value)
BIG = 1 << 28
#: offset that makes a packed last-match value non-negative
_OFF = 1 << 31
_M32 = 0xFFFFFFFF


def last_match(e: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """For each column ``j``, ``val`` at the last column ``< j`` where
    ``e`` is set, else ``BIG`` (``e``, ``val``: ``[B, L]``)."""
    col = torch.arange(1, e.shape[1] + 1, device=e.device)
    key = torch.where(e, (col << 32) | (val + _OFF), 0)
    key = torch.cummax(key, 1).values
    key = torch.cat([key.new_zeros(key.shape[0], 1), key[:, :-1]], 1)
    return torch.where(key > 0, (key & _M32) - _OFF, BIG)


def cell_targets(e, e1, pe, diag, up, xo, rt_j, i):
    """Each cell's value before its left neighbour: ``min(diag + !e,
    up + 1)``, and with no match the transposition: ``X[j] + i`` where the
    previous column matched, else ``rt + j`` where the previous row held
    the column's char, else none."""
    tr = torch.where(e1, xo + i, torch.where(pe, rt_j, BIG))
    return torch.where(e, torch.minimum(diag, up + 1),
                       torch.minimum(torch.minimum(diag, up) + 1, tr))


def left_scan(t: torch.Tensor, left0) -> torch.Tensor:
    """``new[p] = min(t[p], new[p-1] + 1)`` along the last axis, with
    ``new[-1] = left0``: a prefix minimum of ``t - p``."""
    p = torch.arange(t.shape[1], device=t.device)
    return torch.minimum(torch.cummin(t - p, 1).values + p, left0 + p + 1)


def full_row(e, pe, d1, d2, x, i: int):
    """One DP row ``i`` over columns ``1..L``: ``e`` ``[B, L]`` bool (this
    row's char equals column ``j``'s), ``pe`` the previous row's ``e``,
    ``d1``/``d2`` ``[B, L + 1]`` int64 rows ``i-1`` and ``i-2`` (column 0
    included; row -1 all ``BIG``), ``x`` ``[B, L]`` (``FR - K``).  Returns
    row ``i`` and the new ``x``."""
    B, L = e.shape
    j = torch.arange(1, L + 1, device=e.device)
    diag, up, d2l = d1[:, :-1], d1[:, 1:], d2[:, :-1]
    dprev = torch.cat([d1.new_full((B, 1), BIG), d1[:, :-2]], 1)
    e1 = torch.cat([e.new_zeros(B, 1), e[:, :-1]], 1)
    rt = last_match(e, d2l - j)
    t = cell_targets(e, e1, pe, diag, up, x, rt + j, i)
    new = left_scan(t, i)
    x = torch.where(e, dprev - i, x)
    return torch.cat([d1.new_full((B, 1), i), new], 1), x


def damerau_distance(a: torch.Tensor, la: torch.Tensor,
                     b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """True unrestricted Damerau-Levenshtein distance of each pair ->
    int32 ``[B]``: ``a [Ba, LA]`` (rows, PAD -1), ``b [Bb, LB]`` (columns,
    PAD -1), the batch axes broadcasting."""
    B = max(a.shape[0], b.shape[0])
    LA, LB = a.shape[-1], b.shape[-1]
    la_b, lb_b = _lengths(la, lb, B)
    a_b = a.to(torch.int64).expand(B, LA)
    # a pad of b never equals a pad of a
    b_b = torch.where(b < 0, -2, b.to(torch.int64)).expand(B, LB)
    d1 = torch.arange(LB + 1, device=b.device).expand(B, LB + 1).clone()
    d2 = torch.full_like(d1, BIG)
    x = torch.full((B, LB), BIG, dtype=torch.int64, device=b.device)
    pe = torch.zeros((B, LB), dtype=torch.bool, device=b.device)
    steps = min(LA, int(la_b.max())) if B else 0
    for r in range(steps):
        active = (r < la_b)[:, None]
        e = a_b[:, r: r + 1] == b_b
        new, nx = full_row(e, pe, d1, d2, x, r + 1)
        d1, d2 = torch.where(active, new, d1), torch.where(active, d1, d2)
        x = torch.where(active, nx, x)
        pe = e
    out = d1.gather(1, lb_b.clamp(max=LB)[:, None])[:, 0]
    return out.to(torch.int32)
