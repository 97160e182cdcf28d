"""One-vs-many unrestricted Damerau-Levenshtein distance on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/damerau_kernel.py``.  One CUDA
source, ``csrc/dam_scan.cu`` (K9), holds two kernels:

* the full form replaces ``_kernel_sq`` (``_run_sq``) at buckets of at
  most :data:`MAX_TEXT` chars (launch name ``dam_scan``) and
  ``_kernel_long`` / ``_kernel_long_stream`` (``_run_long``,
  ``_run_long_stream``) over longer buckets (``dam_scan_long``).  The
  lane-column forms ``_kernel`` (``_run``) and ``_kernel_lp``
  (``_run_lp``) and the int16 bodies ``_kernel_sq16`` (``_run_sq16``) and
  ``_kernel_sq16m`` (``_run_sq16m``) compute the same function at the
  same shapes: ``dam_scan`` ports them too.  The TPU's split followed its
  VMEM budget, lane layout and int16 compares; a CUDA thread walks its
  candidate's text at any length, so one kernel serves every bucket and
  every query length;
* the banded form replaces ``_kernel_sqband`` (``_run_sqband``,
  ``dam_band``) and ``_kernel_sqband_stream`` (``_run_sqband_stream``,
  ``dam_band_long``), radius ``kband`` in :data:`DAM_BAND_BUCKETS`:
  exact where the distance is at most ``kband``, some value above it
  elsewhere (callers mask on a cutoff ``<= kband``).

The corpus and the PM table are K1's (:func:`~.lev_kernel.prepare_corpus`,
:func:`~.lev_kernel.stage_query`): ``cand`` ``[LB/4, B]``, ``lb`` ``[B]``,
``tabs`` ``[W, 256]``.  The text is the DP's row axis and the query its
column axis; the distance is symmetric.

Queries of more than ``32 * MAX_REG_W`` chars keep each candidate's state
(three DP rows and ``FR - K``, four ints per query char) in a
``[4, la, chunk]`` int32 scratch: the wrapper launches over chunks of
candidates whose scratch stays within :data:`SCRATCH_BYTES`, read at each
call, one launch each.

The wrapper runs the kernel when handed CUDA tensors and the plain PyTorch
version (:func:`dam_scan_plain`, :func:`dam_band_plain`) when handed CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..damerau import BIG, cell_targets, full_row, last_match, left_scan
from . import check, launch, plain_slice
from .lcs_kernel import padded_tables, text_steps
from .lev_kernel import PM_ROWS, stage_query, words

MAX_TEXT = 128           # the JAX package's Damerau split
                         # (damerau_kernel.MAX_TEXT): longer buckets count
                         # as dam_scan_long / dam_band_long
MAX_REG_W = 1            # K9 keeps its state in registers up to this many
                         # query words (at two, ptxas spills); longer
                         # queries use a scratch
SCRATCH_BYTES = 1 << 30  # bound of one launch's scratch (the scanner's
                         # memory plan)
BLOCK = 256              # candidates per CUDA block
#: static band radii (damerau_kernel.py:1083-1087): a cutoff routes to
#: the smallest radius >= it, a wider band being exact for all results
#: <= the cutoff
DAM_BAND_BUCKETS = (3, 7, 15)


def pick_dam_band(cutoff: int, lbmax: int):
    """Band radius for ``score_cutoff``, or None when the band would not be
    meaningfully narrower than the full column walk
    (``damerau_kernel.py:1089-1097``)."""
    for kb in DAM_BAND_BUCKETS:
        if cutoff <= kb:
            if 2 * kb + 1 <= lbmax // 2:
                return kb
            return None
    return None


def _eq_table(la: int, tabs: torch.Tensor) -> torch.Tensor:
    """``[257, la]`` bool: query position ``p`` holds char ``c`` (bit
    ``p % 32`` of PM word ``p // 32`` at row ``c``; row 256, past a text's
    end, all false)."""
    pos = torch.arange(la, device=tabs.device)
    hit = (padded_tables(tabs)[pos >> 5] >> (pos & 31)[:, None]) & 1
    return hit.t().to(torch.bool).contiguous()


def dam_scan_plain(la: int, tabs: torch.Tensor, cand: torch.Tensor,
                   lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9 full form: ``tabs [W, 256]`` -> ``[B]`` int32.

    The recurrence of ``_kernel_sq`` in K9's orientation (text rows, query
    columns), one text row at a time over candidates x query columns
    (:func:`~rapidfuzz_tpu_torch.ops.damerau.full_row`: the left
    neighbour by ``cummin``, the row's last match by a packed
    ``cummax``).  Rows past a candidate's length leave its state as it
    is.  An empty query gives each candidate's length."""
    B = lb.numel()
    lb64 = lb.to(torch.int64)
    if la == 0 or B == 0:
        return lb64.to(torch.int32)
    dev = lb.device
    eq = _eq_table(la, tabs)
    step = plain_slice(B, la + 1, dev)
    out = []
    for s in range(0, B, step):
        lbs = lb64[s: s + step]
        b = lbs.numel()
        d1 = torch.arange(la + 1, device=dev).expand(b, la + 1).clone()
        d2 = torch.full_like(d1, BIG)
        x = torch.full((b, la), BIG, dtype=torch.int64, device=dev)
        pe = torch.zeros((b, la), dtype=torch.bool, device=dev)
        for j, ch in enumerate(text_steps(cand[:, s: s + step], lbs)):
            active = (j < lbs)[:, None]
            e = eq.index_select(0, ch)
            new, nx = full_row(e, pe, d1, d2, x, j + 1)
            d1, d2 = torch.where(active, new, d1), torch.where(active, d1, d2)
            x = torch.where(active, nx, x)
            pe = e
        out.append(d1[:, la])
    return torch.cat(out).to(torch.int32)


def dam_band_plain(la: int, kband: int, tabs: torch.Tensor,
                   cand: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9 banded form: ``tabs [W, 256]`` -> ``[B]`` int32,
    exact where the distance is at most ``kband``, above it elsewhere.

    ``_kernel_sqband``'s band-relative layout in K9's orientation:
    position ``p = 0..2k`` of text row ``i`` holds query column
    ``i - k + p``; the previous rows and ``FR - K`` shift by one position
    a row, their last slot a pad of ``BIG`` (a column entering the band
    starts fresh); positions at or left of column 0 hold the boundary
    (``i`` at column 0, ``BIG`` before it).  A candidate whose length
    differs from the query's by more than ``kband`` gives ``BIG``, as the
    kernel does without a row; an empty query gives the length."""
    B = lb.numel()
    lb64 = lb.to(torch.int64)
    if la == 0 or B == 0:
        return lb64.to(torch.int32)
    K, P = kband, 2 * kband + 1
    dev = lb.device
    LB = cand.shape[0] * 4
    # query positions -K .. LB + K - 1 at columns 0 .. LB + 2K - 1: every
    # window a text row of the bucket reads
    eq = torch.zeros((PM_ROWS + 1, LB + 2 * K), dtype=torch.bool,
                     device=dev)
    n = min(la, LB + K)
    eq[:, K: K + n] = _eq_table(la, tabs)[:, :n]
    p = torch.arange(P, device=dev)
    step = plain_slice(B, P + 1, dev)
    out = []
    for s in range(0, B, step):
        lbs = lb64[s: s + step]
        b = lbs.numel()
        bigs = torch.full((b, 1), BIG, dtype=torch.int64, device=dev)
        # row 0: D[0][j] = j at p = j + K; row -1 all BIG; pad slots BIG
        prv = torch.where(p >= K, p - K, BIG).expand(b, P).clone()
        prv = torch.cat([prv, bigs], 1)
        cur = torch.full_like(prv, BIG)
        x = torch.full_like(prv, BIG)
        eprev = torch.zeros((b, P), dtype=torch.bool, device=dev)
        for j, ch in enumerate(text_steps(cand[:, s: s + step], lbs)):
            i = j + 1
            active = (j < lbs)[:, None]
            # this row's window: query positions i - K - 1 + p
            e = eq[:, i - 1: i - 1 + P].index_select(0, ch)
            e1 = torch.cat([e.new_zeros(b, 1), e[:, :-1]], 1)
            # the previous row's bit at the same column; none at p = 2K
            pe = torch.cat([eprev[:, 1:], e.new_zeros(b, 1)], 1)
            diag, up = prv[:, :P], prv[:, 1:]
            d2l, xo = cur[:, 1:], x[:, 1:]
            dprev = torch.cat([bigs, prv[:, : P - 1]], 1)
            rt = last_match(e, d2l - p)
            t = cell_targets(e, e1, pe, diag, up, xo, rt + p, i)
            if i <= K + 1:
                jcol = i - K + p
                t = torch.where(jcol >= 1, t,
                                torch.where(jcol == 0, i, BIG))
            new = left_scan(t, i if i == K + 1 else BIG)
            nx = torch.where(e, dprev - i, xo)
            new = torch.cat([new, bigs], 1)
            nx = torch.cat([nx, bigs], 1)
            prv, cur = (torch.where(active, new, prv),
                        torch.where(active, prv, cur))
            x = torch.where(active, nx, x)
            eprev = e
        pf = la - lbs + K
        ok = (pf >= 0) & (pf < P)
        d = prv.gather(1, pf.clamp(0, P - 1)[:, None])[:, 0]
        out.append(torch.where(ok, d, BIG))
    return torch.cat(out).to(torch.int32)


def scratch_chunk(la: int, B: int) -> int:
    """Candidates per launch of the scratch form: ``16 * la`` bytes each,
    whole CUDA blocks, within :data:`SCRATCH_BYTES`."""
    return min(B, max(BLOCK, SCRATCH_BYTES // (16 * la) // BLOCK * BLOCK))


def _check(la, tabs, cand, lb):
    dev = cand.device
    check(cand, "cand", torch.int32, 2)
    check(lb, "lb", torch.int32, 1, dev)
    check(tabs, "tabs", torch.int32, 2, dev)
    W, rows = tabs.shape
    if cand.shape[1] != lb.shape[0] or rows != PM_ROWS or W != words(la):
        raise ValueError(f"shape mismatch: la {la}, cand "
                         f"{tuple(cand.shape)}, lb {tuple(lb.shape)}, tabs "
                         f"{tuple(tabs.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _dam_scan(la, tabs, cand, lb, name: str) -> torch.Tensor:
    """K9's full form over one query -> ``[B]`` int32 (kernel on CUDA
    tensors, plain version on CPU tensors)."""
    dev = _check(la, tabs, cand, lb)
    if dev.type == "cpu":
        return dam_scan_plain(la, tabs, cand, lb)
    B = lb.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=dev)
    chunk, scratch = B, None
    if la > 32 * MAX_REG_W and B:
        # three DP rows and FR - K, [4, la, chunk] int32 coalesced by
        # candidate, bounded by SCRATCH_BYTES: one launch per chunk
        chunk = scratch_chunk(la, B)
        scratch = torch.empty(4 * la * chunk, dtype=torch.int32, device=dev)
    for b0 in range(0, B, chunk):
        launch(name, "rf_dam_scan", dev, tabs.data_ptr(), la,
               cand.data_ptr(), lb.data_ptr(), out.data_ptr(),
               None if scratch is None else scratch.data_ptr(), B, b0,
               min(chunk, B - b0), cand.shape[0])
    return out


def _dam_band(la, kband, tabs, cand, lb, name: str) -> torch.Tensor:
    """K9's banded form over one query -> ``[B]`` int32 (kernel on CUDA
    tensors, plain version on CPU tensors)."""
    dev = _check(la, tabs, cand, lb)
    if kband not in DAM_BAND_BUCKETS:
        raise ValueError(f"band radius {kband} not in {DAM_BAND_BUCKETS}")
    if dev.type == "cpu":
        return dam_band_plain(la, kband, tabs, cand, lb)
    B = lb.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        launch(name, "rf_dam_band", dev, tabs.data_ptr(), tabs.shape[0], la,
               kband, cand.data_ptr(), lb.data_ptr(), out.data_ptr(), B,
               cand.shape[0])
    return out


def _long(cand: torch.Tensor) -> bool:
    return cand.shape[0] * 4 > MAX_TEXT


def dam_1v_many(query: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """One-vs-many Damerau-Levenshtein distances -> ``[B]`` int32, at any
    bucket and query length (``damerau_seq_1v_many`` and
    ``damerau_long_1v_many``).  ``staged`` is
    :func:`~.lev_kernel.stage_query`'s output for this query and mode.  An
    empty query gives each candidate's length."""
    q = np.asarray(query)
    _, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "dam_scan_long" if _long(cand) else "dam_scan"
    return _dam_scan(int(q.size), tabs, cand, lb, name)


def dam_band_1v_many(query: np.ndarray, cand: torch.Tensor,
                     lb: torch.Tensor, *, kband: int, mode: str = "byte",
                     staged=None) -> torch.Tensor:
    """One-vs-many banded Damerau-Levenshtein distances -> ``[B]`` int32,
    exact where the distance is at most ``kband`` and above it elsewhere,
    at any bucket length (``damerau_seqband_1v_many`` and
    ``damerau_seqband_long_1v_many``).  ``staged`` as for
    :func:`dam_1v_many`."""
    q = np.asarray(query)
    _, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "dam_band_long" if _long(cand) else "dam_band"
    return _dam_band(int(q.size), int(kband), tabs, cand, lb, name)
