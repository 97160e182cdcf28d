"""Batched Jaro components (common chars, transpositions) over aligned
pairs, in plain PyTorch.

Counterpart of ``rapidfuzz_tpu/ops/jaro.py:jaro_components`` (XLA code
with no Pallas kernel), for the library's short batches; one-vs-many
scans over a corpus go through
:class:`~rapidfuzz_tpu_torch.parallel.CorpusScanner` and its kernel.  The
reference's match assignment (``jaro.rs:422-514``):

* window ``bound = max(la, lb) / 2 - 1`` (clamped at 0), the pattern
  truncated to ``len1 = min(la, lb + bound)``, the text to
  ``len2 = min(lb, la + bound)``;
* the common prefix, counted without transpositions;
* greedy flagging, text position as the sequential loop: each text char
  claims the lowest unclaimed matching pattern position in its window
  (the first ``True`` of the available row, an ``argmax``);
* transpositions: a second walk where each flagged text char pops the
  lowest remaining claimed pattern position and counts a mismatch.

Inputs as in :mod:`.levenshtein`: ``a [Ba, LA]`` (PAD -1), ``la``,
``b [Bb, LB]``, ``lb``, the batch axes broadcasting.  Returns
``[2, B]`` int32: common chars (the prefix included) and the raw
transposition count before the halving of ``jaro.rs:112``; the host
finishes the f64 similarity.
"""

from __future__ import annotations

import torch

from .levenshtein import _lengths


def jaro_components(a: torch.Tensor, la: torch.Tensor,
                    b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """(common chars, raw transpositions) of each pair -> ``[2, B]``."""
    LA, LB = a.shape[-1], b.shape[-1]
    B = max(a.shape[0], b.shape[0])
    la_b, lb_b = _lengths(la, lb, B)
    a_b = a.expand(B, LA)
    b_b = b.expand(B, LB)
    amask = a_b >= 0
    bound = (torch.maximum(la_b, lb_b) // 2 - 1).clamp(min=0)
    len1 = torch.minimum(la_b, lb_b + bound)
    len2 = torch.minimum(lb_b, la_b + bound)
    # common prefix within the truncated lengths
    L = min(LA, LB)
    idx = torch.arange(L, device=a.device)
    pre_eq = (a_b[:, :L] == b_b[:, :L]) & \
        (idx[None, :] < torch.minimum(len1, len2)[:, None])
    prefix = torch.cumprod(pre_eq.to(torch.int64), 1).sum(1)
    ii = torch.arange(LA, device=a.device)[None, :]
    pflag = torch.zeros((B, LA), dtype=torch.bool, device=a.device)
    tflag = torch.zeros((B, LB), dtype=torch.bool, device=a.device)
    steps = min(LB, int(lb_b.max())) if B else 0
    for j in range(steps):
        eq_j = (b_b[:, j: j + 1] == a_b) & amask
        active = (j >= prefix) & (j < len2)
        window = (ii >= (j - bound)[:, None]) & (ii <= (j + bound)[:, None]) \
            & (ii >= prefix[:, None]) & (ii < len1[:, None])
        avail = eq_j & window & ~pflag
        hit = avail.any(1) & active
        first = avail.to(torch.int8).argmax(1)
        pflag |= (ii == first[:, None]) & hit[:, None]
        tflag[:, j] = hit
    common = prefix + pflag.sum(1)
    rem = pflag
    trans = torch.zeros_like(prefix)
    for j in range(steps):
        pop = tflag[:, j]
        first = rem.to(torch.int8).argmax(1)
        ai = a_b.gather(1, first[:, None])[:, 0]
        trans += pop & (ai != b_b[:, j])
        rem = rem & ~((ii == first[:, None]) & pop[:, None])
    return torch.stack([common, trans]).to(torch.int32)
