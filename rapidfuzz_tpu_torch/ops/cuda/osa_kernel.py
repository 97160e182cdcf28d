"""One-vs-many OSA (optimal string alignment) distance on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/osa_kernel.py`` and of the OSA
part of ``stream_kernel.py``.  One kernel, ``csrc/osa_scan.cu`` (K6),
replaces three TPU kernels:

* ``osa_kernel._kernel`` in its one-query form (``_run``, launch name
  ``osa_scan``) and its 16-query form (``_run_nq``, ``osa_scan_nq``);
* ``stream_kernel._osa_kernel`` (``_osa_run``), which the JAX package
  takes for buckets over 1024 chars: the TPU streamed such texts in
  512-char chunks because a candidate block did not fit VMEM, while a
  CUDA thread walks its candidate's text at any length, so the same
  kernel serves every bucket.  One-query launches over buckets longer
  than :data:`~.lev_kernel.LONG_LB` count as ``osa_scan_long``.

Queries up to :data:`MAX_REG_W` words run one thread a candidate; longer
ones run the tile form (:func:`tile_plan`): :data:`TILE_WORDS` query
words a lane, ``G`` lanes a candidate passing the HP/HN carries and the
transposition term's cross-word bit by shuffle, strips of
:data:`~.lev_kernel.STRIP_WORDS` passing those 3 bits through an edge
buffer, :data:`EDGE_ROWS` text rows a u32
(:func:`~.lev_kernel.tile_launches`).

The corpus and the PM tables are K1's (:func:`~.lev_kernel.prepare_corpus`,
:func:`~.lev_kernel.stage_query`): ``cand`` ``[LB/4, B]``, ``lb`` ``[B]``,
``las`` ``[NQ]``, ``tabs`` ``[W, 256]``.

The wrapper runs the kernel when handed CUDA tensors and the plain PyTorch
version (:func:`osa_scan_plain`) when handed CPU tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check
from .lcs_kernel import padded_tables, text_steps
from .lev_kernel import (LONG_LB, M32, PM_ROWS, stage_queries, stage_query,
                         tile_launches, words)
from .lev_kernel import tile_plan as lev_tile_plan

MAX_REG_W = 8    # K6 keeps VP, VN, D0 and PM of the last step in a thread's
                 # registers up to this many words; its tile form past it
TILE_WORDS = 8   # query words a lane of K6's tile form holds
EDGE_ROWS = 8    # text rows a u32 of the strip edge buffer packs (4-bit
                 # slots: hp_c, hn_c and the t bit)


def tile_plan(W: int):
    """``(L, G, S)`` of K6's tile form for a query of ``W`` words (past
    :data:`MAX_REG_W`): :func:`~.lev_kernel.tile_plan` at ``L`` =
    :data:`TILE_WORDS`."""
    return lev_tile_plan(W, TILE_WORDS)


def osa_scan_plain(las: torch.Tensor, tabs: torch.Tensor,
                   cand: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6: ``las [NQ]``, ``tabs [NQ, W, 256]`` -> ``[NQ, B]``
    int32 distances.  The recurrence of ``osa_kernel._kernel`` (K1's
    Myers word plus ``tr = (t[w] << 1 | t[w-1] >> 31) & pm_prev[w]`` with
    ``t = ~d0_prev & pm``, folded into D0) vectorised over queries and
    candidates.  PM_prev is the previous step's PM row, zero before the
    first step; each distance stops at its candidate's length, and an
    empty query gives the length."""
    NQ, W, _ = tabs.shape
    tab = padded_tables(tabs)
    lb64 = lb.to(torch.int64)
    la = las.to(torch.int64)[:, None]                    # [NQ, 1]
    last = (la - 1) & 31

    def state(v):
        return [torch.full((NQ, lb.numel()), v, dtype=torch.int64,
                           device=lb.device) for _ in range(W)]

    vp, vn, d0p, pmp = state(M32), state(0), state(0), state(0)
    dist = la.expand(NQ, lb.numel()).clone()
    for j, ch in enumerate(text_steps(cand, lb)):
        hp_c, hn_c, t_lo = 1, 0, 0
        delta = None
        for w in range(W):
            pmw = tab[:, w].index_select(1, ch)          # [NQ, B]
            t = (M32 ^ d0p[w]) & pmw
            tr = (((t << 1) & M32) | (t_lo >> 31)) & pmp[w]
            pmp[w] = pmw
            t_lo = t
            x = pmw | hn_c
            d0 = ((((x & vp[w]) + vp[w]) & M32) ^ vp[w]) | x | vn[w] | tr
            hp = vn[w] | (M32 ^ (d0 | vp[w]))
            hn = d0 & vp[w]
            if w == W - 1:
                delta = ((hp >> last) & 1) - ((hn >> last) & 1)
            hp_s = ((hp << 1) & M32) | hp_c
            hn_s = ((hn << 1) & M32) | hn_c
            vp[w] = hn_s | (M32 ^ (d0 | hp_s))
            vn[w] = hp_s & d0
            d0p[w] = d0
            hp_c, hn_c = hp >> 31, hn >> 31
        dist = torch.where(j < lb64, dist + delta, dist)
    dist = torch.where(la == 0, lb64[None, :], dist)
    return dist.to(torch.int32)


def _osa_scan(las, tabs, cand, lb, name: str) -> torch.Tensor:
    """K6 over stacked queries -> ``[NQ, B]`` int32 (kernel on CUDA
    tensors, plain version on CPU tensors)."""
    dev = cand.device
    check(cand, "cand", torch.int32, 2)
    check(lb, "lb", torch.int32, 1, dev)
    check(las, "las", torch.int32, 1, dev)
    check(tabs, "tabs", torch.int32, 3, dev)
    NQ, W, rows = tabs.shape
    B = lb.shape[0]
    if cand.shape[1] != B or rows != PM_ROWS or las.shape[0] != NQ:
        raise ValueError(f"shape mismatch: cand {tuple(cand.shape)}, lb "
                         f"{tuple(lb.shape)}, las {tuple(las.shape)}, tabs "
                         f"{tuple(tabs.shape)}")
    if dev.type == "cpu":
        return osa_scan_plain(las, tabs, cand, lb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((NQ, B), dtype=torch.int32, device=dev)
    if B and NQ:
        tile_launches(name, "rf_osa_scan", (tabs, las, cand, lb, out), W,
                      EDGE_ROWS)
    return out


def osa_1v_many(query: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """One-vs-many OSA distances -> ``[B]`` int32, at any bucket length
    (``osa_kernel.osa_1v_many`` and ``stream_kernel.osa_stream_1v_many``).

    ``staged`` is :func:`~.lev_kernel.stage_query`'s output for this query
    and mode.  An empty query gives each candidate's length."""
    q = np.asarray(query)
    las, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "osa_scan_long" if cand.shape[0] * 4 > LONG_LB else "osa_scan"
    return _osa_scan(las, tabs.reshape(1, *tabs.shape), cand, lb, name)[0]


def osa_nq_many(queries, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """Many-vs-many OSA distances -> ``[NQ, B]`` int32, all queries in one
    launch (``osa_kernel.osa_nq_many``).

    All queries must land in the same word bucket (equal
    ``ceil(len/32)``); callers bucket by W (``CorpusScanner.scan_many``).
    An empty query's row is each candidate's length, set by the kernel
    (the JAX wrapper patches it after the launch)."""
    qs = [np.asarray(q) for q in queries]
    Ws = {words(q.size) for q in qs}
    if len(Ws) != 1:
        raise ValueError(f"queries span word buckets {sorted(Ws)}")
    las, tabs = staged if staged is not None else stage_queries(
        qs, mode, cand.device)
    return _osa_scan(las, tabs, cand, lb, "osa_scan_nq")
