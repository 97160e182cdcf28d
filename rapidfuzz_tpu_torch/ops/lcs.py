"""Batched LCS length over aligned pairs (Hyyrö bit-parallel), in plain
PyTorch.

Counterpart of ``rapidfuzz_tpu/ops/lcs.py:lcs_similarity`` (XLA code
with no Pallas kernel).  Per text char and word:
``u = s & pm; s = (s + u + carry) | (s - u)`` with the add's carry chained
across words (``lcs_seq.rs:199-261``); the LCS is the count of zero bits.
Bits at positions >= len(pattern) stay 1 (``u`` is a subset of ``s``, so
``s - u`` never borrows), so PAD positions need no mask.
"""

from __future__ import annotations

import torch

from .bitpack import M32, add_with_carry, pm_columns, popcount


def lcs_similarity(a: torch.Tensor, la: torch.Tensor,
                   b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """True LCS length of each padded pair -> int32 ``[B]``."""
    LA = a.shape[-1]
    if LA % 32:
        raise ValueError(f"pattern bucket {LA} is not a multiple of 32")
    W = LA // 32
    pm = pm_columns(a, b)                       # [B, LB, W]
    B = pm.shape[0]
    lb_b = lb.to(torch.int64).expand(B)
    s = pm.new_full((B, W), M32)
    steps = min(pm.shape[1], int(lb_b.max())) if B else 0
    for j in range(steps):
        active = j < lb_b
        carry = 0
        words = []
        for w in range(W):
            sw = s[:, w]
            u = sw & pm[:, j, w]
            x, carry = add_with_carry(sw, u, carry)
            words.append(x | (sw - u))
        s = torch.where(active[:, None], torch.stack(words, -1), s)
    return popcount(M32 ^ s).sum(-1).to(torch.int32)
