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
  streamed the text in 512-char chunks to fit VMEM; a CUDA thread walks
  its candidate's whole text, so nothing is chunked.

Results are LCS lengths: exact for candidates whose indel distance is
within the cutoff, and for the others the band's underestimate, bit for
bit the TPU kernel's (their indel distance comes out too large, so the
caller's cutoff mask rejects exactly the right rows).  The TPU kernels
read per-step windows pre-shifted on the host
(``band_kernel.build_shifted_tables``); here each step reads the words
around its window from the query's ``[W, 256]`` table and joins them with
a funnel shift, as K3 does, so the wrapper takes the query, not shifted
tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitpack import popcount
from . import check, launch
from .band_kernel import FAST_MAX_LB, band_words, table_words
from .lcs_kernel import padded_tables, text_steps
from .lev_kernel import M32, PM_ROWS, stage_query

MAX_CUTOFF = 47          # 3-word band, as band_kernel.MAX_CUTOFF_FAST


def lcs_band_plain(bw: int, tabs: torch.Tensor, cand: torch.Tensor,
                   lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5 -> ``[B]`` int32: the sliding-band recurrence of
    ``lcs_band_kernel._kernel`` vectorised over candidates.  ``tabs`` is
    the query's ``[ws, 256]`` table (rows past it read as zero).  Steps
    past a candidate's length read an all-zero PM row, so they only move
    the register's bit 0 into the accumulator and a 1 in at the top,
    which leaves ``acc + popcount(~s)`` as the kernel's stop at that
    length does."""
    WS = tabs.shape[0]
    # two zero words on each side: every window reads words widx0 ..
    # widx0 + bw with widx0 >= -(bw + 1), all inside the padded table
    zeros = torch.zeros((bw + 1, PM_ROWS + 1), dtype=torch.int64,
                        device=lb.device)
    tab = torch.cat([zeros, padded_tables(tabs), zeros])
    s = [torch.full(lb.shape, M32, dtype=torch.int64, device=lb.device)
         for _ in range(bw)]
    acc = torch.zeros(lb.shape, dtype=torch.int64, device=lb.device)
    for j, ch in enumerate(text_steps(cand, lb)):
        start0 = j - 16 * bw
        widx0, sh = start0 >> 5, start0 & 31
        lo = widx0 + bw + 1
        if lo > WS + bw:                 # the window is past the table
            pw = [torch.zeros_like(acc)] * (bw + 1)
        else:
            col = tab[lo: lo + bw + 1].index_select(1, ch)  # [bw + 1, B]
            pw = list(col)
        ns = []
        carry = 0
        for k in range(bw):
            x = pw[k] if sh == 0 else (
                (pw[k] >> sh) | ((pw[k + 1] << (32 - sh)) & M32))
            u = s[k] & x
            t = s[k] + u + carry
            carry = t >> 32
            ns.append((t & M32) | (s[k] ^ u))
        acc = acc + ((M32 ^ ns[0]) & 1)
        for k in range(bw):
            hi = ((ns[k + 1] << 31) & M32) if k + 1 < bw else 1 << 31
            s[k] = (ns[k] >> 1) | hi
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
    tabs = tabs[: table_words(int(q.size), LB)]
    if dev.type == "cpu":
        return lcs_band_plain(bw, tabs, cand, lb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        launch(name, "rf_lcs_band", dev, tabs.data_ptr(), tabs.shape[0], bw,
               cand.data_ptr(), lb.data_ptr(), out.data_ptr(), B,
               cand.shape[0])
    return out
