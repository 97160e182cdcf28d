"""One-vs-many Jaro components (common chars, transpositions) on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/jaro_kernel.py`` and of the Jaro
part of ``stream_kernel.py``.  One kernel, ``csrc/jaro_scan.cu`` (K8),
replaces three TPU kernels:

* ``jaro_kernel._kernel`` in its one-query form (``_run``, launch name
  ``jaro_scan``) and its 16-query form (``_run_nq``, ``jaro_scan_nq``);
* ``stream_kernel._jaro_kernel`` (``_jaro_run``), which the JAX package
  takes for buckets of 1025-16,384 chars that are whole 512-char chunks,
  for queries that fit its VMEM budget: the TPU streamed such texts in
  chunks and kept a candidate block's text flags in VMEM, while a CUDA
  thread walks its candidate's text at any length, so the same kernel
  serves every bucket and every query.  One-query launches over buckets
  longer than :data:`~.lev_kernel.LONG_LB` count as ``jaro_scan_long``.

The corpus and the PM tables are K1's (:func:`~.lev_kernel.prepare_corpus`,
:func:`~.lev_kernel.stage_query`): ``cand`` ``[LB/4, B]``, ``lb`` ``[B]``,
``las`` ``[NQ]``, ``tabs`` ``[W, 256]``.  The query is the pattern and the
candidate the text.  The kernel returns integer components; the caller
finishes them into f64 similarities on the host
(``distance.jaro.sim_from_components``), the transpositions halved there.

Queries of more than :data:`MAX_REG_W` words keep each candidate's pattern
flags and a text-flag bitmap in a ``[NQ, W + ceil(LB/32), chunk]`` u32
scratch: the wrapper launches over chunks of candidates whose scratch
stays within :data:`SCRATCH_BYTES`, read at each call, one launch each.

The wrapper runs the kernel when handed CUDA tensors and the plain PyTorch
version (:func:`jaro_scan_plain`) when handed CPU tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitpack import popcount
from . import check, launch, plain_slice
from .lcs_kernel import padded_tables, text_steps
from .lev_kernel import (LONG_LB, M32, PM_ROWS, stage_queries, stage_query,
                         words)

MAX_REG_W = 8            # K8 keeps its state in registers up to this many
                         # query words; longer queries use a scratch
SCRATCH_BYTES = 1 << 30  # bound of one launch's scratch (the scanner's
                         # memory plan)
BLOCK = 256              # candidates per CUDA block


def _below(n: torch.Tensor) -> torch.Tensor:
    """Bits ``[0, n)`` of a u32 word (int64 holding u32), ``n`` clamped to
    ``[0, 32]``."""
    return (1 << n.clamp(0, 32)) - 1


def jaro_scan_plain(las: torch.Tensor, tabs: torch.Tensor,
                    cand: torch.Tensor, lb: torch.Tensor,
                    steps: bool = False) -> torch.Tensor:
    """Plain PyTorch K8: ``las [NQ]``, ``tabs [NQ, W, 256]`` -> ``[2, NQ, B]``
    int32 (common chars, raw transpositions).

    The recurrence of ``jaro_kernel._kernel``, one text step at a time
    over ``[NQ, W, B]`` u32 words: the window ``[j - bound, j + bound]``,
    the prefix step (``pref == j`` and ``P[j] == T[j]``, claimed in both
    flag sets), the claim of the lowest available pattern bit in the
    first word that has one, the text flags kept per step; then the
    second walk, each flagged text char popping the lowest remaining
    claimed bit and counting a mismatch when its PM bit is clear.

    With ``steps``, four more rows give the text steps the kernel's two
    passes walk per pair (pass 1 from the end of the prefix until every
    pattern position is claimed or ``len2``, pass 2 until the last
    flagged char), the text chars they reach and the flagged text chars
    past the prefix (pass 2's pops), the work its bound counts.  On the
    CPU the candidates go in slices of at most ``PLAIN_GRAIN / (NQ * W)``,
    so a step's tensors stay under PyTorch's grain size and run on one
    thread."""
    NQ, W, _ = tabs.shape
    B = lb.numel()
    dev = lb.device
    tab = padded_tables(tabs)                            # [NQ, W, 257]
    la = las.to(torch.int64)[:, None]                    # [NQ, 1]
    base = (32 * torch.arange(W, device=dev))[None, :, None]
    step = plain_slice(B, NQ * W, dev)
    LB = cand.shape[0] * 4
    outs = []
    for s in range(0, B, step):
        cs, ls = cand[:, s: s + step], lb[s: s + step]
        n = ls.to(torch.int64).clamp(max=LB)[None, :]    # [1, b]
        bound = (torch.maximum(la, n) // 2 - 1).clamp(min=0)
        len1 = torch.minimum(la, n + bound)
        len2 = torch.minimum(n, la + bound)
        pref = torch.zeros_like(bound)
        claimed = torch.zeros_like(bound)
        pf = torch.zeros((NQ, W, ls.numel()), dtype=torch.int64, device=dev)
        it1 = torch.zeros_like(bound)
        last = torch.full_like(bound, -1)
        flags, prefixing = [], True
        # no step claims past a pair's len2 or once all its len1 pattern
        # positions are claimed (checked every 64 steps), and no pass-2
        # step pops past its last flagged char
        stop = int(len2.max()) if len2.numel() else 0
        for j, ch in enumerate(text_steps(cs, ls)):
            if j >= stop or (j % 64 == 63 and not bool(
                    ((claimed < len1) & (j < len2)).any())):
                break
            pm = tab.index_select(2, ch)                 # [NQ, W, b]
            lo = (j - bound).clamp(min=0)[:, None]
            hi = (j + bound + 1)[:, None]
            wm = _below(hi - base) & (M32 ^ _below(lo - base))
            in_pref = torch.zeros_like(pref, dtype=torch.bool)
            if j < 32 * W and prefixing:
                bit = (pm[:, j >> 5] >> (j & 31)) & 1
                in_pref = (pref == j) & (bit == 1) & (j < len1) & (j < len2)
                pf[:, j >> 5] |= in_pref.to(torch.int64) << (j & 31)
                pref = pref + in_pref
                claimed = claimed + in_pref
                prefixing = bool(in_pref.any())
            avail = pm & wm & (M32 ^ pf)
            nz = avail != 0
            first = nz & (nz.cumsum(1) == 1)
            act = (pref <= j) & (j < len2)
            hit = nz.any(1) & act
            pf |= torch.where(first & hit[:, None], avail & -avail, 0)
            if steps:
                it1 += act & (claimed < len1)
            claimed = claimed + hit
            last = torch.where(hit, j, last)
            flags.append(hit | in_pref)
        common = popcount(pf).sum(1)
        rem = pf
        t = torch.zeros_like(bound)
        stop = int(last.max()) + 1 if last.numel() else 0
        for j, ch in enumerate(text_steps(cs, ls)):
            if j >= stop:
                break
            pm = tab.index_select(2, ch)
            nz = rem != 0
            low = torch.where(nz & (nz.cumsum(1) == 1), rem & -rem, 0)
            match = ((pm & low) != 0).any(1)
            act = flags[j]
            rem = torch.where(act[:, None], rem ^ low, rem)
            t += act & ~match
        rows = [common, t]
        if steps:
            it2 = torch.where(last >= 0, last + 1 - pref, 0)
            rows += [it1, it2, pref + torch.maximum(it1, it2),
                     common - pref]
        outs.append(torch.stack(rows))
    if not outs:
        return torch.zeros((6 if steps else 2, NQ, 0), dtype=torch.int32,
                           device=dev)
    return torch.cat(outs, -1).to(torch.int32)


def _jaro_scan(las, tabs, cand, lb, name: str) -> torch.Tensor:
    """K8 over stacked queries -> ``[2, NQ, B]`` int32 (kernel on CUDA
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
        return jaro_scan_plain(las, tabs, cand, lb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((2, NQ, B), dtype=torch.int32, device=dev)
    if not (B and NQ):
        return out
    lb4 = cand.shape[0]
    if W <= MAX_REG_W:
        launch(name, "rf_jaro_scan", dev, tabs.data_ptr(), las.data_ptr(),
               cand.data_ptr(), lb.data_ptr(), out.data_ptr(), None, B, 0, B,
               lb4, W, NQ)
        return out
    # pattern flags and the text-flag bitmap, [NQ, W + TW, chunk] u32
    # coalesced by candidate, bounded by SCRATCH_BYTES: one launch per
    # chunk of candidates
    per = 4 * NQ * (W + -(-4 * lb4 // 32))
    chunk = min(B, max(BLOCK, SCRATCH_BYTES // per // BLOCK * BLOCK))
    scratch = torch.empty(per // 4 * chunk, dtype=torch.int32, device=dev)
    for b0 in range(0, B, chunk):
        launch(name, "rf_jaro_scan", dev, tabs.data_ptr(), las.data_ptr(),
               cand.data_ptr(), lb.data_ptr(), out.data_ptr(),
               scratch.data_ptr(), B, b0, min(chunk, B - b0), lb4, W, NQ)
    return out


def jaro_1v_many(query: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, *,
                 mode: str = "byte", staged=None):
    """One-vs-many Jaro components -> (common ``[B]``, transpositions
    ``[B]``) int32, at any bucket and query length
    (``jaro_kernel.jaro_1v_many`` and ``stream_kernel.jaro_stream_1v_many``).

    ``staged`` is :func:`~.lev_kernel.stage_query`'s output for this query
    and mode.  An empty query gives zeros."""
    q = np.asarray(query)
    las, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "jaro_scan_long" if cand.shape[0] * 4 > LONG_LB else "jaro_scan"
    out = _jaro_scan(las, tabs.reshape(1, *tabs.shape), cand, lb, name)
    return out[0, 0], out[1, 0]


def jaro_nq_many(queries, cand: torch.Tensor, lb: torch.Tensor, *,
                 mode: str = "byte", staged=None):
    """Many-vs-many Jaro components -> (common ``[NQ, B]``, transpositions
    ``[NQ, B]``) int32, all queries in one launch
    (``jaro_kernel.jaro_nq_many``).

    All queries must land in the same word bucket (equal
    ``ceil(len/32)``); callers bucket by W (``CorpusScanner.scan_many``).
    An empty query's rows are zeros."""
    qs = [np.asarray(q) for q in queries]
    Ws = {words(q.size) for q in qs}
    if len(Ws) != 1:
        raise ValueError(f"queries span word buckets {sorted(Ws)}")
    las, tabs = staged if staged is not None else stage_queries(
        qs, mode, cand.device)
    out = _jaro_scan(las, tabs, cand, lb, "jaro_scan_nq")
    return out[0], out[1]
