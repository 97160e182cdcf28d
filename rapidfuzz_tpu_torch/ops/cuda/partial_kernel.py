"""One-vs-many ``fuzz.partial_ratio`` (the best window's indel ratio) on
Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/partial_kernel.py``.  One kernel,
``csrc/partial_scan.cu`` (K10, launch name ``partial_scan``), replaces
``partial_kernel._run`` with both its bodies (``_kernel_q``, the TPU's,
and ``_kernel``, the interpret one), at every bucket and query length:
the TPU's 64-char query and 1,024-char bucket caps were compile and VMEM
limits.  It also scores the candidates shorter than the query, which the
TPU kernel left to the host: there the candidate slides over the query.

The corpus and the PM table are K1's (:func:`~.lev_kernel.prepare_corpus`,
:func:`~.lev_kernel.stage_query`): ``cand`` ``[LB/4, B]``, ``lb`` ``[B]``,
``tabs`` ``[W, 256]``.  The kernel returns ``[4, B]`` int32: ``num``,
``den`` (the best window's ``2*lcs`` and ``m + wlen``, or ``n + wlen`` in
the swapped role) and the window's ``[start, end)``, in the candidate's
coordinates when it is at least as long as the query and in the query's
otherwise.  The caller finishes ``1.0 - (den - num) / den`` in f64.

Queries of more than :data:`MAX_REG_W` words keep one window's state in a
``[W, chunk]`` u32 scratch: the wrapper launches over chunks of
candidates whose scratch stays within :data:`SCRATCH_BYTES`, read at each
call, one launch each.

The wrapper runs the kernel when handed CUDA tensors and the plain PyTorch
version (:func:`partial_scan_plain`) when handed CPU tensors; it never
falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitpack import popcount
from . import check, launch, plain_slice
from .lcs_kernel import padded_tables
from .lev_kernel import M32, PM_ROWS, stage_query, u32, words

MAX_REG_W = 16           # K10 keeps its window states in registers up to
                         # this many query words; longer queries use a
                         # scratch
SCRATCH_BYTES = 1 << 30  # bound of one launch's scratch (the scanner's
                         # memory plan)
BLOCK = 256              # candidates per CUDA block


def _chars(cand: torch.Tensor, n: torch.Tensor, width: int) -> torch.Tensor:
    """``[b, width]`` int64: each candidate's chars, :data:`PM_ROWS` (the
    all-zero row of :func:`~.lcs_kernel.padded_tables`) at and past its
    length ``n``, so a step there is an identity step."""
    rows = min(cand.shape[0], -(-width // 4))
    shifts = torch.arange(0, 32, 8, device=cand.device)
    c = (u32(cand[:rows]).t()[:, :, None] >> shifts) & 0xFF
    c = c.reshape(c.shape[0], 4 * rows)[:, :width]
    if c.shape[1] < width:
        c = torch.cat([c, c.new_full((c.shape[0], width - c.shape[1]),
                                     PM_ROWS)], 1)
    pos = torch.arange(width, device=cand.device)[None, :]
    return torch.where(pos < n[:, None], c, PM_ROWS)


def _step(s, pm):
    """One Hyyrö LCS step of every word of ``s`` (a list of W int64
    tensors holding u32) against the PM words ``pm`` (same shapes), the
    add's carry chained from the low word up."""
    carry = 0
    for w, sw in enumerate(s):
        u = sw & pm[w]
        t = sw + u + carry
        carry = t >> 32
        s[w] = (t & M32) | (sw - u)


def _lcs2(s) -> torch.Tensor:
    return 2 * sum(popcount(M32 ^ sw) for sw in s)


def _first_best(num, den, st, en, valid) -> torch.Tensor:
    """``[4, b]``: per row, the first window (along the last axis) whose
    ``num / den`` is largest among the ``valid`` ones.  Fractions of
    denominators below 2**26 that differ map to f64 values that differ,
    so the f64 comparison is the kernel's exact one."""
    v = torch.where(valid, num.to(torch.float64) / den, -1.0)
    top = v.max(-1, keepdim=True).values
    k = torch.arange(v.shape[-1], device=v.device).expand_as(v)
    first = torch.where(v == top, k, v.shape[-1]).min(-1, keepdim=True)
    sel = k == first.values
    return torch.stack([(x * sel).sum(-1) for x in (num, den, st, en)])


def _windows_plain(m: int, tab, cand, n) -> torch.Tensor:
    """Candidates with ``n >= m``: the prefix windows ``[0, e)``,
    ``e = 1..m-1``, then every window ``[st, min(st + m, n))``.  All starts
    step together, reading text char ``st + p`` at offset ``p`` as a
    shifted slice; steps past a candidate's end read the zero PM row, so
    after ``m`` offsets each start holds its window's state.  Start 0's
    state after ``e`` steps is prefix window ``e``."""
    W = tab.shape[0]
    b = n.numel()
    nst = int(n.max())
    ch = _chars(cand, n, nst + m - 1)
    s = [torch.full((b, nst), M32, dtype=torch.int64, device=n.device)
         for _ in range(W)]
    pre = []
    for p in range(m):
        pm = tab.index_select(1, ch[:, p: p + nst].reshape(-1))
        _step(s, pm.reshape(W, b, nst))
        if p + 1 < m:
            pre.append(_lcs2([sw[:, 0] for sw in s]))
    e = torch.arange(1, m, device=n.device).expand(b, m - 1)
    st = torch.arange(nst, device=n.device).expand(b, nst)
    wlen = (n[:, None] - st).clamp(max=m)
    num = torch.cat([torch.stack(pre, 1) if pre else e, _lcs2(s)], 1)
    return _first_best(num, torch.cat([m + e, m + wlen], 1),
                       torch.cat([torch.zeros_like(e), st], 1),
                       torch.cat([e, st + wlen], 1),
                       torch.cat([e > 0, wlen > 0], 1))


def _swapped_plain(m: int, tab, cand, n) -> torch.Tensor:
    """Candidates with ``0 < n < m``: the query windows
    ``[max(0, i - n), min(m, i))``, ``i = 1..n+m-1``, each the pattern
    masked to its bits, against the whole candidate; all windows step
    together over the candidate's chars."""
    W = tab.shape[0]
    b = n.numel()
    nmax = int(n.max())
    i = torch.arange(1, nmax + m, device=n.device).expand(b, nmax + m - 1)
    a = (i - n[:, None]).clamp(min=0)
    e = i.clamp(max=m)
    valid = i < n[:, None] + m
    masks = []
    for w in range(W):
        lo = (a - 32 * w).clamp(0, 32)
        hi = (e - 32 * w).clamp(0, 32)
        masks.append(torch.where(valid & (hi > lo), (1 << hi) - (1 << lo),
                                 0))
    s = [torch.full_like(a, M32) for _ in range(W)]
    ch = _chars(cand, n, nmax)
    for p in range(nmax):
        pm = tab.index_select(1, ch[:, p])
        _step(s, [pm[w][:, None] & masks[w] for w in range(W)])
    return _first_best(_lcs2(s), n[:, None] + (e - a), a, e, valid)


def partial_scan_plain(la: int, tabs: torch.Tensor, cand: torch.Tensor,
                       lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10: query length ``la >= 1``, ``tabs [W, 256]`` ->
    ``[4, B]`` int32 (num, den, start, end).

    Vectorised over window starts with a loop over the ``<= la`` offsets
    of a window (or over the ``< la`` chars of a shorter candidate), so
    it takes O(la) steps, not O(n * la).  On the CPU the candidates go in
    slices of :func:`~rapidfuzz_tpu_torch.ops.cuda.plain_slice`, so that a
    step's tensors stay under PyTorch's grain size."""
    W = tabs.shape[0]
    B = lb.numel()
    dev = lb.device
    tab = padded_tables(tabs)                            # [W, 257]
    LB = cand.shape[0] * 4
    n_all = lb.to(torch.int64).clamp(max=LB)
    out = torch.zeros((4, B), dtype=torch.int64, device=dev)
    out[1] = 1                                           # empty: (0, 1, 0, 0)
    step = plain_slice(B, W * (LB + la), dev)
    for s0 in range(0, B, step):
        n = n_all[s0: s0 + step]
        for part, keep in ((_windows_plain, n >= la),
                           (_swapped_plain, (n > 0) & (n < la))):
            idx = torch.nonzero(keep).reshape(-1)
            if idx.numel():
                res = part(la, tab, cand[:, s0: s0 + step].index_select(
                    1, idx), n.index_select(0, idx))
                out[:, s0: s0 + step].index_copy_(1, idx, res)
    return out.to(torch.int32)


def _partial_scan(la: int, tabs, cand, lb) -> torch.Tensor:
    """K10 -> ``[4, B]`` int32 (kernel on CUDA tensors, plain version on
    CPU tensors)."""
    dev = cand.device
    check(cand, "cand", torch.int32, 2)
    check(lb, "lb", torch.int32, 1, dev)
    check(tabs, "tabs", torch.int32, 2, dev)
    W, rows = tabs.shape
    B = lb.shape[0]
    if cand.shape[1] != B or rows != PM_ROWS:
        raise ValueError(f"shape mismatch: cand {tuple(cand.shape)}, lb "
                         f"{tuple(lb.shape)}, tabs {tuple(tabs.shape)}")
    if la < 1 or W != words(la):
        raise ValueError(f"query length {la} does not fit a {W}-word table")
    if dev.type == "cpu":
        return partial_scan_plain(la, tabs, cand, lb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    if not B:
        return out
    lb4 = cand.shape[0]
    if W <= MAX_REG_W:
        launch("partial_scan", "rf_partial_scan", dev, tabs.data_ptr(), la,
               cand.data_ptr(), lb.data_ptr(), out.data_ptr(), None, B, 0, B,
               lb4, W)
        return out
    # one window's state, [W, chunk] u32 coalesced by candidate, bounded
    # by SCRATCH_BYTES: one launch per chunk of candidates
    chunk = min(B, max(BLOCK, SCRATCH_BYTES // (4 * W) // BLOCK * BLOCK))
    scratch = torch.empty(W * chunk, dtype=torch.int32, device=dev)
    for b0 in range(0, B, chunk):
        nb = min(chunk, B - b0)
        launch("partial_scan", "rf_partial_scan", dev, tabs.data_ptr(), la,
               cand.data_ptr(), lb.data_ptr(), out.data_ptr(),
               scratch.data_ptr(), B, b0, nb, lb4, W)
    return out


def partial_ratio_1v_many(query: np.ndarray, cand: torch.Tensor,
                          lb: torch.Tensor, *, mode: str = "byte",
                          staged=None):
    """Best windows -> ``(num, den, start, end)``, each ``[B]`` int32
    (``partial_kernel.partial_ratio_1v_many``), at any bucket and query
    length, candidates shorter than the query included.

    ``staged`` is :func:`~.lev_kernel.stage_query`'s output for this query
    and mode.  An empty query raises, as in the JAX package: callers
    answer it on the host."""
    q = np.asarray(query)
    if q.size == 0:
        raise ValueError("empty query is a host-side special case")
    _, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    out = _partial_scan(int(q.size), tabs, cand, lb)
    return out[0], out[1], out[2], out[3]
