"""Batched OSA (optimal string alignment) distance over aligned pairs, in
plain PyTorch.

Counterpart of ``rapidfuzz_tpu/ops/osa.py:osa_distance`` (XLA code with no
Pallas kernel).  Hyyrö's bit-parallel Levenshtein step
(:func:`~.levenshtein.uniform_distance`) extended with the transposition
term of ``osa.rs:84-135`` (one word) and ``osa.rs:156-227`` (many): per
text char, with the previous step's D0 and PM kept per word,

    tr = ((~d0_prev & pm) << 1 | (~d0_prev[w-1] & pm[w-1]) >> 31) & pm_prev

is folded into D0.  The state of a pair stops changing past its text's
length (the JAX version masks it the same way), and an empty pattern
gives the text's length.  Inputs as in :mod:`.levenshtein`: ``a [Ba, LA]``
(PAD -1), ``la``, ``b [Bb, LB]``, ``lb``, the batch axes broadcasting.
"""

from __future__ import annotations

import torch

from .bitpack import M32, pm_columns, test_bit
from .levenshtein import _lengths


def osa_distance(a: torch.Tensor, la: torch.Tensor,
                 b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """True OSA distance of each pair -> int32 ``[B]``."""
    LA = a.shape[-1]
    if LA % 32:
        raise ValueError(f"pattern bucket {LA} is not a multiple of 32")
    W = LA // 32
    pm = pm_columns(a, b)                       # [B, LB, W]
    B = pm.shape[0]
    la_b, lb_b = _lengths(la, lb, B)
    last_pos = (la_b - 1).clamp(min=0)
    vp = pm.new_full((B, W), M32)
    vn = torch.zeros_like(vp)
    d0_prev = torch.zeros_like(vp)
    pm_prev = torch.zeros_like(vp)
    dist = la_b.clone()
    steps = min(pm.shape[1], int(lb_b.max())) if B else 0
    for j in range(steps):
        active = j < lb_b
        pm_j = pm[:, j]
        hp_c, hn_c = 1, 0
        lo = 0                          # ~d0_prev[w-1] & pm[w-1]
        hps, hns, nvp, nvn, nd0 = [], [], [], [], []
        for w in range(W):
            p = pm_j[:, w]
            t = (M32 ^ d0_prev[:, w]) & p
            tr = (((t << 1) & M32) | (lo >> 31)) & pm_prev[:, w]
            lo = t
            x = p | hn_c
            vpw, vnw = vp[:, w], vn[:, w]
            d0 = ((((x & vpw) + vpw) & M32) ^ vpw) | x | vnw | tr
            hp = vnw | (M32 ^ (d0 | vpw))
            hn = d0 & vpw
            hps.append(hp)
            hns.append(hn)
            hp_s = ((hp << 1) & M32) | hp_c
            hn_s = ((hn << 1) & M32) | hn_c
            nvp.append(hn_s | (M32 ^ (d0 | hp_s)))
            nvn.append(hp_s & d0)
            nd0.append(d0)
            hp_c, hn_c = hp >> 31, hn >> 31
        delta = (test_bit(torch.stack(hps, -1), last_pos)
                 - test_bit(torch.stack(hns, -1), last_pos))
        dist = torch.where(active, dist + delta, dist)
        sel = active[:, None]
        vp = torch.where(sel, torch.stack(nvp, -1), vp)
        vn = torch.where(sel, torch.stack(nvn, -1), vn)
        d0_prev = torch.where(sel, torch.stack(nd0, -1), d0_prev)
        pm_prev = torch.where(sel, pm_j, pm_prev)
    # empty-pattern edge: the distance is just len2
    dist = torch.where(la_b == 0, lb_b, dist)
    return dist.to(torch.int32)
