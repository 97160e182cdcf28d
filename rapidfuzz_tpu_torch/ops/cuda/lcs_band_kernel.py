"""One-vs-many banded LCS under an indel cutoff, on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/lcs_band_kernel.py``.  One
kernel, ``csrc/lcs_band.cu`` (K5), serves both TPU kernels of that module;
its band is a register of ``bw`` u32 words whose bit 0 at text step ``j``
is pattern row ``j - 16*bw``:

* ``_kernel`` (``_run``, launch name ``lcs_band``): ``bw`` in {1, 2, 3}
  for indel cutoffs up to :data:`MAX_CUTOFF`, buckets up to
  :data:`~.band_kernel.FAST_MAX_LB`;
* ``_stream_kernel`` (``_run_stream``, ``lcs_band_long``): the same band
  over buckets of any length (:func:`lcs_banded_stream_1v_many`).  The TPU
  streamed the text in 512-char chunks to fit VMEM; a CUDA block walks its
  texts in chunks of its own PM ring at any length.

Results are LCS lengths: exact for candidates whose indel distance is
within the cutoff, and for the others the band's underestimate, bit for
bit the TPU kernel's (their indel distance comes out too large, so the
caller's cutoff mask rejects exactly the right rows).  The TPU kernels
read per-step windows pre-shifted on the host
(``band_kernel.build_shifted_tables``); here each step reads the words
around its window from the query's ``[W, 256]`` table and joins them with
a funnel shift, as K3 does, so the wrapper takes the query, not shifted
tables.

K5 walks a candidate ``min(lb, la + 16*bw)`` steps: from step
``la + 16*bw`` on every row of the window is past the query, so a step
there only moves the register's bit 0 into the accumulator and a 1 in at
the top, which leaves the result as it is (the source's header has the
argument).  Its design is K3's: a shared-memory PM ring a block, filled
by one bulk copy a chunk of :data:`~.band_kernel.CHUNK` steps
(``csrc/band_ring.cuh``, shared with K3), corpus words ahead, longest
blocks first; its blocks are as large as keep two an SM
(:func:`~.band_kernel.fill_threads`: it walks every text, where K3 walks
few over long buckets).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitpack import popcount
from . import check, launch
from .band_kernel import (FAST_MAX_LB, _sm_count, band_words, fill_threads,
                          table_words)
from .lcs_kernel import padded_tables, text_steps
from .lev_kernel import M32, PM_ROWS, stage_query

MAX_CUTOFF = 47          # 3-word band, as band_kernel.MAX_CUTOFF_FAST


def lcs_band_plain(bw: int, tabs: torch.Tensor, cand: torch.Tensor,
                   lb: torch.Tensor, la: int | None = None) -> torch.Tensor:
    """Plain PyTorch K5 -> ``[B]`` int32: the sliding-band recurrence of
    ``lcs_band_kernel._kernel`` vectorised over candidates.  ``tabs`` is
    the query's ``[ws, 256]`` table (rows past it read as zero) and
    ``la`` the query's length (``None``: ``32 * ws``, the rows the table
    holds).  Steps past a candidate's length read an all-zero PM row, and
    steps from ``min(la, 32 * ws) + 16*bw`` on an all-zero window; either
    only moves the register's bit 0 into the accumulator and a 1 in at the
    top, which leaves ``acc + popcount(~s)`` as it is.  So the loop ends
    at the kernel's stop, ``la + 16*bw`` steps (the table holds the
    query's rows up to the bucket's reach), past which every candidate's
    walk has ended."""
    WS = tabs.shape[0]
    stop = min(32 * WS if la is None else la, 32 * WS) + 16 * bw
    # bw + 1 zero words in front: every window reads words widx0 ..
    # widx0 + bw with widx0 >= -(bw + 1); rows w and w + 1 side by side,
    # so that a band word's window is one gather and one shift
    zeros = torch.zeros((bw + 1, PM_ROWS + 1), dtype=torch.int64,
                        device=lb.device)
    tab = torch.cat([zeros, padded_tables(tabs), zeros])
    tab = tab[:-1] | (tab[1:] << 32)
    s = [torch.full(lb.shape, M32, dtype=torch.int64, device=lb.device)
         for _ in range(bw)]
    ones = torch.zeros(lb.shape, dtype=torch.int64, device=lb.device)
    steps = 0
    for j, ch in enumerate(text_steps(cand, lb)):
        if j >= stop:
            break
        steps += 1
        start0 = j - 16 * bw
        lo = (start0 >> 5) + bw + 1
        pw = tab[lo: lo + bw].index_select(1, ch) >> (start0 & 31)
        ns = []
        for k in range(bw):
            u = s[k] & pw[k]
            t = s[k] + u if k == 0 else s[k] + u + (ns[k - 1] >> 32)
            ns.append(t | (s[k] ^ u))
        # bit 0 leaves the band: a zero there is one more match
        ones += ns[0] & 1
        # the slide; bit 32 of a word is its add's carry, which the next
        # word took (the top word's is dropped: a 1 enters over it)
        for k in range(bw - 1):
            s[k] = ((ns[k] & M32) >> 1) | ((ns[k + 1] << 31) & M32)
        s[bw - 1] = (ns[bw - 1] >> 1) | (1 << 31)
    acc = steps - ones
    for k in range(bw):
        acc = acc + popcount(M32 ^ s[k])
    return acc.to(torch.int32)


def _check_cutoff(cutoff: int) -> None:
    if not 0 <= cutoff <= MAX_CUTOFF:
        raise ValueError(f"cutoff {cutoff} outside [0, {MAX_CUTOFF}]")


def lcs_banded_1v_many(query: np.ndarray, cand: torch.Tensor,
                       lb: torch.Tensor, *, cutoff: int, mode: str = "byte",
                       staged=None) -> torch.Tensor:
    """Banded one-vs-many LCS similarity -> ``[B]`` int32.

    ``cutoff`` is the indel-distance bound of the band: similarities are
    exact for candidates with ``indel <= cutoff``, an underestimate for
    the others.  Requires ``0 <= cutoff <= MAX_CUTOFF`` and a bucket of at
    most ``FAST_MAX_LB`` chars (``ValueError`` otherwise, as the JAX
    wrapper); :func:`lcs_banded_stream_1v_many` serves longer buckets."""
    _check_cutoff(cutoff)
    LB = cand.shape[0] * 4
    if LB > FAST_MAX_LB:
        raise ValueError(f"bucket {LB} > {FAST_MAX_LB}")
    return _band(np.asarray(query), cand, lb, band_words(cutoff), mode,
                 staged, "lcs_band")


def lcs_banded_stream_1v_many(query: np.ndarray, cand: torch.Tensor,
                              lb: torch.Tensor, *, cutoff: int,
                              mode: str = "byte",
                              staged=None) -> torch.Tensor:
    """Banded LCS similarity over long (> 1024-char) candidate buckets ->
    ``[B]`` int32 (``lcs_band_kernel.lcs_banded_stream_1v_many``).  Same
    contract as :func:`lcs_banded_1v_many`; the TPU kernel also needed a
    bucket that is a multiple of its 512-char chunk, this one takes any."""
    _check_cutoff(cutoff)
    return _band(np.asarray(query), cand, lb, band_words(cutoff), mode,
                 staged, "lcs_band_long")


def _band(q: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, bw: int,
          mode: str, staged, name: str) -> torch.Tensor:
    """K5 with a ``bw``-word band -> ``[B]`` int32 (kernel on CUDA tensors
    counted under ``name``, plain version on CPU tensors)."""
    dev = cand.device
    check(cand, "cand", torch.int32, 2)
    check(lb, "lb", torch.int32, 1, dev)
    LB = cand.shape[0] * 4
    B = lb.shape[0]
    if cand.shape[1] != B:
        raise ValueError(f"cand {tuple(cand.shape)} vs lb {tuple(lb.shape)}")
    _, tabs = staged if staged is not None else stage_query(q, mode, dev)
    check(tabs, "tabs", torch.int32, 2, dev)
    if tabs.shape[1] != PM_ROWS:
        raise ValueError(f"tabs {tuple(tabs.shape)}, expected [W, 256]")
    # the windows of a bw <= 3 band over LB steps reach pattern rows below
    # LB + 16*bw + 32, inside table_words (band_kernel.table_words)
    la = int(q.size)
    tabs = tabs[: table_words(la, LB)]
    if dev.type == "cpu":
        return lcs_band_plain(bw, tabs, cand, lb, la)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        threads = fill_threads(B, _sm_count(dev.index))
        launch(name, "rf_lcs_band", dev, tabs.data_ptr(), tabs.shape[0], la,
               bw, cand.data_ptr(), lb.data_ptr(), out.data_ptr(), B,
               cand.shape[0], threads)
    return out
