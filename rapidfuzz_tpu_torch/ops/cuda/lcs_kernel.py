"""One-vs-many LCS length (Hyyrö bit-parallel) on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/lcs_kernel.py`` and of the LCS
part of ``stream_kernel.py``.  One kernel, ``csrc/lcs_scan.cu`` (K4),
replaces three TPU kernels:

* ``lcs_kernel._kernel`` in its one-query form (``_run``, launch name
  ``lcs_scan``) and its 16-query form (``_run_nq``, ``lcs_scan_nq``);
* ``stream_kernel._lcs_kernel`` (``_lcs_run``), which the JAX package
  takes for buckets over 1024 chars: the TPU streamed such texts in
  512-char chunks because a candidate block did not fit VMEM, while a
  CUDA thread walks its candidate's text at any length, so the same
  kernel serves every bucket.  One-query launches over buckets longer
  than :data:`~.lev_kernel.LONG_LB` count as ``lcs_scan_long``.

Queries up to :data:`MAX_REG_W` words run one thread a candidate; longer
ones run the tile form (:func:`tile_plan`): :data:`TILE_WORDS` query
words a lane, ``G`` lanes a candidate passing the add's carry by shuffle,
strips of :data:`~.lev_kernel.STRIP_WORDS` passing it through an edge
buffer, :data:`EDGE_ROWS` text rows a u32
(:func:`~.lev_kernel.tile_launches`).

The corpus and the PM tables are K1's (:func:`~.lev_kernel.prepare_corpus`,
:func:`~.lev_kernel.stage_query`): ``cand`` ``[LB/4, B]``, ``lb`` ``[B]``,
``tabs`` ``[W, 256]``.  The kernel returns LCS lengths; the scanner
finishes them into indel (``la + lb - 2*lcs``) or lcs_seq
(``max(la, lb) - lcs``) distances.

The wrapper runs the kernel when handed CUDA tensors and the plain PyTorch
version (:func:`lcs_scan_plain`) when handed CPU tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitpack import popcount
from . import check
from .lev_kernel import (LONG_LB, M32, PM_ROWS, stage_queries, stage_query,
                         tile_launches, u32, words)
from .lev_kernel import tile_plan as lev_tile_plan

MAX_REG_W = 16   # K4 keeps S in a thread's registers up to this many
                 # words; its tile form past it
TILE_WORDS = 16  # query words a lane of K4's tile form holds
EDGE_ROWS = 32   # text rows a u32 of the strip edge buffer packs (1 bit
                 # each: the add's carry)


def tile_plan(W: int):
    """``(L, G, S)`` of K4's tile form for a query of ``W`` words (past
    :data:`MAX_REG_W`): :func:`~.lev_kernel.tile_plan` at ``L`` =
    :data:`TILE_WORDS`."""
    return lev_tile_plan(W, TILE_WORDS)


def text_steps(cand: torch.Tensor, lb: torch.Tensor):
    """Yield each text step's chars of every candidate, ``[B]`` int64, up
    to the longest candidate, with :data:`PM_ROWS` (the all-zero row of
    :func:`padded_tables`) past each candidate's own length, so a plain
    step there matches nothing.  Unpacks one packed row (4 steps) at a
    time, so no ``[LB, B]`` copy of the corpus is made."""
    LB = cand.shape[0] * 4
    lb64 = lb.to(torch.int64)
    steps = int(lb64.max().clamp(max=LB)) if lb.numel() else 0
    shifts = torch.arange(0, 32, 8, device=cand.device)[:, None]
    for r in range(-(-steps // 4)):
        row = (u32(cand[r])[None, :] >> shifts) & 0xFF           # [4, B]
        pos = torch.arange(4 * r, 4 * r + 4, device=cand.device)[:, None]
        row = torch.where(pos < lb64[None, :], row, PM_ROWS)
        yield from row[: steps - 4 * r]


def padded_tables(tabs: torch.Tensor) -> torch.Tensor:
    """``[..., 256]`` int32 PM tables -> ``[..., 257]`` u32 values in
    int64, row 256 all zero (the "past the end" char of
    :func:`text_steps`)."""
    t = u32(tabs)
    return torch.cat([t, torch.zeros_like(t[..., :1])], -1)


def lcs_scan_plain(tabs: torch.Tensor, cand: torch.Tensor,
                   lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4: ``tabs [NQ, W, 256]`` -> ``[NQ, B]`` int32 LCS
    lengths.  The recurrence of ``lcs_kernel._kernel``
    (``u = s & pm; s = (s + u + carry) | (s - u)``, the carry chained
    across the W words) vectorised over queries and candidates.  Steps
    past a candidate's length read an all-zero PM row, which leaves S as
    it is, as the kernel's stop at that length does."""
    NQ, W, _ = tabs.shape
    tab = padded_tables(tabs)
    s = [torch.full((NQ, lb.numel()), M32, dtype=torch.int64,
                    device=lb.device) for _ in range(W)]
    for ch in text_steps(cand, lb):
        pm = tab.index_select(2, ch)                     # [NQ, W, B]
        carry = 0
        for w in range(W):
            u = s[w] & pm[:, w]
            t = s[w] + u + carry
            carry = t >> 32
            s[w] = (t & M32) | (s[w] - u)
    sim = sum(popcount(M32 ^ sw) for sw in s)
    return sim.to(torch.int32)


def _lcs_scan(tabs, cand, lb, name: str) -> torch.Tensor:
    """K4 over stacked queries -> ``[NQ, B]`` int32 (kernel on CUDA
    tensors, plain version on CPU tensors)."""
    dev = cand.device
    check(cand, "cand", torch.int32, 2)
    check(lb, "lb", torch.int32, 1, dev)
    check(tabs, "tabs", torch.int32, 3, dev)
    NQ, W, rows = tabs.shape
    B = lb.shape[0]
    if cand.shape[1] != B or rows != PM_ROWS:
        raise ValueError(f"shape mismatch: cand {tuple(cand.shape)}, lb "
                         f"{tuple(lb.shape)}, tabs {tuple(tabs.shape)}")
    if dev.type == "cpu":
        return lcs_scan_plain(tabs, cand, lb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((NQ, B), dtype=torch.int32, device=dev)
    if B and NQ:
        tile_launches(name, "rf_lcs_scan", (tabs, cand, lb, out), W,
                      EDGE_ROWS)
    return out


def lcs_1v_many(query: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """One-vs-many LCS lengths -> ``[B]`` int32, at any bucket length
    (``lcs_kernel.lcs_1v_many`` and ``stream_kernel.lcs_stream_1v_many``).

    ``staged`` is :func:`~.lev_kernel.stage_query`'s output for this query
    and mode.  An empty query gives zeros with no launch, as the JAX
    wrappers do."""
    q = np.asarray(query)
    if q.size == 0:
        return torch.zeros(lb.shape, dtype=torch.int32, device=lb.device)
    _, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "lcs_scan_long" if cand.shape[0] * 4 > LONG_LB else "lcs_scan"
    return _lcs_scan(tabs.reshape(1, *tabs.shape), cand, lb, name)[0]


def lcs_nq_many(queries, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """Many-vs-many LCS lengths -> ``[NQ, B]`` int32, all queries in one
    launch (``lcs_kernel.lcs_nq_many``).

    All queries must land in the same word bucket (equal
    ``ceil(len/32)``); callers bucket by W (``CorpusScanner.scan_many``).
    An empty query's table is all zero, so its row is 0."""
    qs = [np.asarray(q) for q in queries]
    Ws = {words(q.size) for q in qs}
    if len(Ws) != 1:
        raise ValueError(f"queries span word buckets {sorted(Ws)}")
    _, tabs = staged if staged is not None else stage_queries(
        qs, mode, cand.device)
    return _lcs_scan(tabs, cand, lb, "lcs_scan_nq")
