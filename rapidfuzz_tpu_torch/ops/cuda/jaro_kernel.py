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

Two forms.  Up to :data:`MAX_REG_W` query words a thread keeps the window
and the pattern flags in registers and writes each flagged text char to
its own slot in shared memory, so that pass 2 pops the stored chars
against the claimed pattern bits without walking the corpus again.
Longer queries walk per-char cursors over the query's positions
(:func:`cursor_tables`, staged from the PM table once a launch): text char
``c`` at step ``j`` moves ``c``'s cursor past the positions under
``max(j - bound, pref)`` and claims the one there if it is at most
``j + bound``.  That is the greedy rule exactly, since a position of ``c``
is claimed only by a text char ``c`` and the window's lower end only
rises, so every position below a cursor is claimed or out of reach for
good; the cursors advance at most ``la`` times a pair, so a step costs
O(1) shared-memory loads amortised where a bit-parallel step costs O(W)
words.  Each candidate's cursors and pattern flags live in shared memory
(about 560 bytes at 4,001 chars over 27 symbols); nothing is kept in
device memory per candidate, so no launch is chunked.  A candidate's
state must fit one block's shared memory (227 KB: queries of about 1.8
million chars); past that the launch is refused.

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

MAX_REG_W = 5    # K8's register form up to this many query words; the
                 # cursor form past them (faster from 6 words on an H100)


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
    over ``[NQ, W, B]`` u32 words: the window ``[j - bound, j + bound]``
    (slid up a bit a step, as the kernel's register form slides it), the
    prefix step (``pref == j`` and ``P[j] == T[j]``, claimed in both
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
    thread; the steps run under ``torch.inference_mode()`` and the result
    is returned as an ordinary tensor."""
    with torch.inference_mode():
        out = _plain(las, tabs, cand, lb, steps)
    return out.clone()


def _plain(las, tabs, cand, lb, steps):
    """:func:`jaro_scan_plain`'s steps."""
    NQ, W, _ = tabs.shape
    P = 32 * W
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
        # the window [j - bound, j + bound] at j = 0, slid up a bit a step
        # (bit 0 kept while its lower end is clamped at 0); no step claims
        # past a pair's len2 or once all its len1 pattern positions are
        # claimed (checked every 64 steps), and no pass-2 step pops past
        # its last flagged char
        wm = _below(bound[:, None] + 1 - base)
        stop = int(len2.max()) if len2.numel() else 0
        for j, ch in enumerate(text_steps(cs, ls)):
            if j >= stop or (j % 64 == 63 and not bool(
                    ((claimed < len1) & (j < len2)).any())):
                break
            if j:
                wm = ((wm << 1) & M32) | torch.cat(
                    [(j <= bound)[:, None].to(torch.int64),
                     wm[:, :-1] >> 31], 1)
            pm = tab.index_select(2, ch)                 # [NQ, W, b]
            in_pref = None
            if j < P and prefixing:
                bit = (pm[:, j >> 5] >> (j & 31)) & 1
                in_pref = (pref == j) & (bit == 1) & (j < len1) & (j < len2)
                pf[:, j >> 5] |= in_pref.to(torch.int64) << (j & 31)
                pref = pref + in_pref
                claimed = claimed + in_pref
                prefixing = bool(in_pref.any())
            avail = pm & wm & (M32 ^ pf)
            nz = avail != 0
            first = nz if W == 1 else nz & (nz.cumsum(1) == 1)
            act = (pref <= j) & (j < len2)
            hit = nz.any(1) & act
            pf |= torch.where(first & hit[:, None], avail & -avail, 0)
            if steps:
                it1 += act & (claimed < len1)
            claimed = claimed + hit
            last = torch.where(hit, j, last)
            flags.append(hit if in_pref is None else hit | in_pref)
        common = popcount(pf).sum(1)
        rem = pf
        t = torch.zeros_like(bound)
        stop = int(last.max()) + 1 if last.numel() else 0
        for j, ch in enumerate(text_steps(cs, ls)):
            if j >= stop:
                break
            pm = tab.index_select(2, ch)
            low = rem & -rem
            if W > 1:
                low = torch.where((rem != 0).cumsum(1) == 1, low, 0)
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


def idx16(W: int) -> bool:
    """Whether the cursor form indexes a ``W``-word query's positions with
    u16 (else u32): every index and the sentinel stay below 0xFFFF."""
    return 32 * W + PM_ROWS + 1 < 0xFFFF


def cursor_layout(W: int, smax: int):
    """Byte offsets of one query's cursor tables (``off``, ``pos``, ``pch``)
    and their stride, each part at a multiple of 16 bytes (the C entry's
    ``CursorLayout``)."""
    isz = 2 if idx16(W) else 4
    off = 2 * PM_ROWS
    pos = off + -(-isz * smax // 16) * 16
    pch = pos + -(-isz * (32 * W + smax + 1) // 16) * 16
    return off, pos, pch, pch + 32 * W


def _as_bytes(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[NQ, n]`` int64 values below ``2**(8*size)`` -> ``[NQ, n*size]``
    uint8, little-endian."""
    bits = 8 * size
    x = torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)
    return x.to({1: torch.int8, 2: torch.int16, 4: torch.int32}[size]
                ).contiguous().view(torch.uint8)


def cursor_tables(tabs: torch.Tensor):
    """The cursor form's tables of each query, derived from its PM table
    ``tabs [NQ, W, 256]`` on its device -> (``[NQ, stride/4]`` int32 bytes,
    ``smax``), ``smax`` the most rows with positions of any query.

    Per query, at :func:`cursor_layout`'s offsets: ``slot [256]`` int16,
    row ``c``'s number among the rows with positions (-1 for none);
    ``off [smax]``, each such row's first index into ``pos``;
    ``pos [32 W + smax + 1]``, each row's positions ascending and then a
    sentinel (the index type's largest value, above every position and
    window end), the rest sentinels; ``pch [32 W]`` u8, the row of each
    position (0 where none).  Indices are u16 while :func:`idx16`, else
    u32.  A PM table sets each position in at most one row (one char a
    position), so a position's row is the sum of the rows holding it."""
    NQ, W, rows = tabs.shape
    dev = tabs.device
    P = 32 * W
    isz = 2 if idx16(W) else 4
    bits = (tabs[..., None] >> torch.arange(32, dtype=torch.int32,
                                            device=dev)) & 1
    bits = bits.permute(0, 2, 1, 3).reshape(NQ, rows, P)   # [NQ, row, p]
    counts = bits.sum(2)
    present = counts > 0
    smax = int(present.sum(1).max()) if NQ else 0
    slot = torch.where(present, present.cumsum(1) - 1, -1)    # [NQ, row]
    pch = (bits * torch.arange(rows, device=dev)[:, None]).sum(1)  # [NQ, p]
    # the positions sorted by (row, position), those in no row last; the
    # i-th goes to index i + its row's slot (a sentinel after each row)
    p = torch.arange(P, device=dev)
    order = torch.where(bits.any(1), pch * P + p, rows * P + p).argsort(1)
    dest = p + slot.gather(1, pch.gather(1, order))
    PP = P + smax + 1
    sent = (1 << (8 * isz)) - 1
    total = counts.sum(1, keepdim=True)
    pos = torch.full((NQ, PP + P), sent, dtype=torch.int64, device=dev)
    pos.scatter_(1, torch.where(p < total, dest, PP + p), order)
    # a row's first index: the positions and sentinels of the rows before
    start = counts.cumsum(1) - counts + slot.clamp(min=0)
    off = torch.full((NQ, smax + 1), PP - 1, dtype=torch.int64, device=dev)
    off.scatter_(1, torch.where(present, slot, smax), start)
    o_off, o_pos, o_pch, stride = cursor_layout(W, smax)
    parts = [(_as_bytes(slot, 2), o_off),
             (_as_bytes(off[:, :smax], isz), o_pos),
             (_as_bytes(pos[:, :PP], isz), o_pch),
             (pch.to(torch.uint8), stride)]
    out, at = [], 0
    for part, end in parts:
        out += [part, torch.zeros((NQ, end - at - part.shape[1]),
                                  dtype=torch.uint8, device=dev)]
        at = end
    return torch.cat(out, 1).view(torch.int32), smax


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
        launch(name, "rf_jaro_scan", dev, tabs.data_ptr(), None, 0, 0,
               las.data_ptr(), cand.data_ptr(), lb.data_ptr(),
               out.data_ptr(), B, lb4, W, NQ)
        return out
    tab, smax = cursor_tables(tabs)
    launch(name, "rf_jaro_scan", dev, tabs.data_ptr(), tab.data_ptr(),
           tab.shape[1] * 4, smax, las.data_ptr(), cand.data_ptr(),
           lb.data_ptr(), out.data_ptr(), B, lb4, W, NQ)
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
