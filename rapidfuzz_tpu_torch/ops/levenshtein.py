"""Batched uniform and weighted Levenshtein over aligned pairs, in plain
PyTorch.

Counterpart of ``rapidfuzz_tpu/ops/levenshtein.py``, which is XLA code
with no Pallas kernel, so PyTorch code is its port.  These serve the
library's aligned-pair batches (``distance_many`` over pairs, short
one-vs-many batches); one-vs-many scans over a corpus go through
:class:`~rapidfuzz_tpu_torch.parallel.CorpusScanner` and its kernels.

* :func:`uniform_distance`: the Myers/Hyyrö multi-word recurrence, the
  inter-word HP/HN carries of ``levenshtein.rs:838-875`` (word size 32),
  text position as the sequential loop, the batch axis vectorised.
* :func:`weighted_distance`: the Wagner-Fischer row
  (``levenshtein.rs:212-259``) with the in-row ``new[i-1] + del``
  dependency as a min-plus prefix scan (``torch.cummin`` of the row minus
  a deletion ramp), in int64, so no weight table can overflow it.

Inputs are padded int32 batches from the codec: ``a [Ba, LA]`` pattern
chars (PAD -1), ``la [Ba]``, ``b [Bb, LB]``, ``lb [Bb]``; ``Ba`` and
``Bb`` broadcast (one may be 1).
"""

from __future__ import annotations

import torch

from .bitpack import M32, pm_columns, test_bit


def _lengths(la, lb, B):
    return (la.to(torch.int64).expand(B).contiguous(),
            lb.to(torch.int64).expand(B).contiguous())


def uniform_distance(a: torch.Tensor, la: torch.Tensor,
                     b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """True uniform Levenshtein distance of each pair -> int32 ``[B]``."""
    LA = a.shape[-1]
    if LA % 32:
        raise ValueError(f"pattern bucket {LA} is not a multiple of 32")
    W = LA // 32
    pm = pm_columns(a, b)                       # [B, LB, W]
    B = pm.shape[0]
    la_b, lb_b = _lengths(la, lb, B)
    last_pos = (la_b - 1).clamp(min=0)          # bit index of row m-1
    vp = pm.new_full((B, W), M32)
    vn = torch.zeros_like(vp)
    dist = la_b.clone()
    steps = min(pm.shape[1], int(lb_b.max())) if B else 0
    for j in range(steps):
        active = j < lb_b
        hp_c, hn_c = 1, 0                       # '| 1' into word 0's shift
        hps, hns, nvp, nvn = [], [], [], []
        for w in range(W):
            x = pm[:, j, w] | hn_c
            vpw, vnw = vp[:, w], vn[:, w]
            d0 = ((((x & vpw) + vpw) & M32) ^ vpw) | x | vnw
            hp = vnw | (M32 ^ (d0 | vpw))
            hn = d0 & vpw
            hps.append(hp)
            hns.append(hn)
            hp_s = ((hp << 1) & M32) | hp_c
            hn_s = ((hn << 1) & M32) | hn_c
            nvp.append(hn_s | (M32 ^ (d0 | hp_s)))
            nvn.append(hp_s & d0)
            hp_c, hn_c = hp >> 31, hn >> 31
        delta = (test_bit(torch.stack(hps, -1), last_pos)
                 - test_bit(torch.stack(hns, -1), last_pos))
        dist = torch.where(active, dist + delta, dist)
        vp = torch.where(active[:, None], torch.stack(nvp, -1), vp)
        vn = torch.where(active[:, None], torch.stack(nvn, -1), vn)
    # empty-pattern edge: the distance is just len2
    dist = torch.where(la_b == 0, lb_b, dist)
    return dist.to(torch.int32)


def weighted_distance(a: torch.Tensor, la: torch.Tensor,
                      b: torch.Tensor, lb: torch.Tensor,
                      ins: int, dele: int, sub: int) -> torch.Tensor:
    """Weighted Levenshtein (``generalized_wagner_fischer``) of each pair
    -> int64 ``[B]``: deleting an ``a`` element costs ``dele``, inserting a
    ``b`` element ``ins``, substituting ``sub``."""
    LA = a.shape[-1]
    eq = (b[..., :, None] == a[..., None, :]) & (a[..., None, :] >= 0)
    B = eq.shape[0]
    la_b, lb_b = _lengths(la, lb, B)
    ramp = torch.arange(LA + 1, dtype=torch.int64, device=a.device) * dele
    row = ramp.expand(B, LA + 1).clone()
    steps = min(eq.shape[1], int(lb_b.max())) if B else 0
    for j in range(steps):
        active = j < lb_b
        diag, up = row[:, :-1], row[:, 1:]      # old[i-1], old[i]
        cand = torch.where(eq[:, j], diag,
                           torch.minimum(diag + sub, up + ins))
        t = torch.cat([row[:, :1] + ins, cand], dim=-1)
        # new[i] = min over k <= i of t[k] + dele * (i - k)
        new = torch.cummin(t - ramp, dim=-1).values + ramp
        row = torch.where(active[:, None], new, row)
    return row.gather(1, la_b[:, None])[:, 0]
