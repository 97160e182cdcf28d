"""One-vs-many banded Levenshtein under a score cutoff, on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/band_kernel.py``.  One CUDA
kernel, ``csrc/lev_band.cu`` (K3), serves the three TPU band kernels; its
band has a run-time semiwidth ``semi`` and a register of ``bw`` u32 words:

* ``_fast_kernel`` (launch name ``lev_band``): semiwidth pinned at
  ``16*bw - 1`` for ``bw`` in {1, 2, 3} (cutoffs up to
  :data:`MAX_CUTOFF_FAST`), buckets up to :data:`FAST_MAX_LB`;
* ``_stream_kernel`` (``lev_band_long``): the same pinned band over
  buckets of any length (:func:`lev_banded_stream_1v_many`).  The TPU
  streamed the text in 512-char chunks to fit VMEM; a CUDA thread walks
  its candidate's whole text;
* ``_kernel`` (``lev_band_rt``): one word, semiwidth = the caller's cutoff
  (up to :data:`MAX_CUTOFF`), which the JAX wrapper takes for queries no
  longer than the pinned band or buckets over :data:`FAST_MAX_LB`.  It is
  K3 at ``bw = 1``, ``semi = cutoff``: one kernel with a semiwidth
  argument covers both bands, where a second kernel would repeat K3's
  recurrence line for line (the kernel is also built with the pinned
  semiwidth as a constant, which keeps the pinned band as fast as it
  was).

The diagonal phase runs until the band reaches the pattern's last row and
the horizontal phase after it (``levenshtein.rs:509-617``).  Results are
exact when ``<= cutoff`` and :data:`BIG` otherwise.

The TPU kernels read their PM windows from per-step tables pre-shifted on
the host (``build_shifted_tables``, ``probe_table``) because scalar shifts
were slow on the v5e.  Here each step reads the words around its window
from the query's ``[W, 256]`` table (the one K1 uses) and joins them with
a funnel shift; the probe bit is computed in-thread.  So only the first
:func:`table_words` words of the table are ever read.

What bounds K3 on an H100 and what its design does about it (the source's
header has the detail):

* a text whose answer the final masks fix (empty, or its length more than
  the cutoff from the query's) is not walked, and a block with no other
  stages nothing;
* its PM window comes from shared memory at every bucket: a block walks
  the text in chunks of :data:`CHUNK` steps, every thread at the same
  step, and stages the table rows a chunk reads into one of two slots by
  a bulk copy while it computes the chunk before, rows outside the table
  as zeros; one barrier a chunk, which a thread whose walk has ended
  keeps joining until the block's longest walk ends;
* a thread holds its next few packed corpus words in registers;
* chunks that miss the horizontal phase skip its test a step;
* blocks start with the last (longest) candidates, of 64 threads over
  buckets of more than one chunk and up to 256 over shorter ones
  (:func:`block_threads`).

Over short buckets it is bound by integer issue (14 INT32-lane
instructions a step at ``bw = 1``, 10 of them the recurrence); over long
ones, where only the texts near the query's length are walked, by the
serial chain of a block's longest walk.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import check, launch
from .lev_kernel import M32, PM_ROWS, stage_query, u32, words

BIG = np.int32(1 << 29)
MAX_CUTOFF = 15        # one-word band (the TPU's dynamic kernel)
MAX_CUTOFF_FAST = 47   # pinned band of up to 3 words
FLAT_MAX_STEPS = 512   # the TPU's flat-unroll budget (kept for routing)
FAST_MAX_LB = 1024     # the TPU's bucket cap of the pinned band (routing)
CHUNK = 256            # text steps a chunk of K3's PM ring (kChunk)
BLOCKS = (256, 128, 64)  # K3's block sizes, largest first
SMS = 132              # the H100's SMs (the block plan's default)


def band_words(cutoff: int) -> int:
    """u32 words needed for a pinned band of semiwidth >= cutoff
    (``16 * bw - 1 >= cutoff``)."""
    return max(1, -(-(cutoff + 1) // 16))


def table_words(la: int, LB: int) -> int:
    """PM words a band scan over an ``LB`` bucket reads: the window of
    band word ``k`` at step ``j`` starts at pattern position
    ``j + semi + 1 - 32*bw + 32*k <= LB + semi - 32 <= LB + 15`` (``semi``
    is at most 47), so words past ``(LB + 16)//32 + 1`` are never
    touched."""
    return min(words(la), (LB + 16) // 32 + 2)


def fill_threads(B: int, sms: int = SMS) -> int:
    """The largest of :data:`BLOCKS` that gives ``B`` candidates at least
    two blocks an SM, else the smallest: K5's block size at every bucket
    (it walks every text to about the same length, and a 256-thread
    block beat 64 at both of its rows on an H100, ``PERF.md`` §6) and
    K3's up to one chunk."""
    for t in BLOCKS:
        if -(-B // t) >= 2 * sms:
            return t
    return BLOCKS[-1]


def block_threads(B: int, LB: int, sms: int = SMS) -> int:
    """K3's block size for ``B`` candidates over an ``LB`` bucket: 64
    threads when the bucket takes more than one chunk (the few texts near
    the query's length that a long bucket walks then spread over more SMs,
    and a block waits on fewer of them at its barriers; with every text
    walked, 0.80 ms over 131,072 texts of up to 8,192 chars against 0.93
    at 256 on an H100, ``PERF.md`` §6), else :func:`fill_threads`."""
    return BLOCKS[-1] if LB > CHUNK else fill_threads(B, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of card ``index``, asked once (asked every launch, it took
    ~0.06 ms of host time a call)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vp0(bw: int, semi: int) -> list[int]:
    """Initial VP: the register's top ``semi + 1`` bits set."""
    lo = 32 * bw - 1 - semi
    out = []
    for k in range(bw):
        if 32 * k >= lo:
            out.append(M32)
        elif 32 * k + 31 < lo:
            out.append(0)
        else:
            out.append((M32 << (lo - 32 * k)) & M32)
    return out


def lev_band_plain(la: int, cut: int, bw: int, tabs: torch.Tensor,
                   cand: torch.Tensor, lb: torch.Tensor,
                   semi: int | None = None) -> torch.Tensor:
    """Plain PyTorch K3 -> ``[B]`` int32: the band recurrence of
    ``band_kernel._fast_kernel`` (``semi`` = ``16*bw - 1``, the default)
    and ``band_kernel._kernel`` (``bw = 1``, ``semi`` = the cutoff),
    vectorised over candidates."""
    semi = 16 * bw - 1 if semi is None else semi
    WS = tabs.shape[0]
    LB = cand.shape[0] * 4
    lbc = lb.to(torch.int64).clamp(max=LB)
    steps = int(lbc.max()) if lbc.numel() else 0
    tab = u32(tabs)
    c64 = u32(cand)
    zero = torch.zeros_like(lbc)
    vp = [torch.full_like(lbc, v) for v in _vp0(bw, semi)]
    vn = [zero] * bw
    dist = torch.full_like(lbc, semi)
    pstart = max(la - semi, 0)
    for j in range(steps):
        ch = (c64[j >> 2] >> (8 * (j & 3))) & 0xFF

        def pmw(w):
            return tab[w].index_select(0, ch) if 0 <= w < WS else zero

        x = []
        for k in range(bw):
            start = j + semi + 1 - 32 * bw + 32 * k
            widx, s = start >> 5, start & 31
            lo, hi = pmw(widx), pmw(widx + 1)
            x.append(lo if s == 0 else (lo >> s) | ((hi << (32 - s)) & M32))
        d0, hp, hn = [], [], []
        carry = 0
        for k in range(bw):
            t = (x[k] & vp[k]) + vp[k] + carry
            carry = t >> 32
            d0k = ((t & M32) ^ vp[k]) | x[k] | vn[k]
            d0.append(d0k)
            hp.append(vn[k] | (M32 ^ (d0k | vp[k])))
            hn.append(d0k & vp[k])
        kk = j - pstart
        if 0 <= kk <= 32 * bw - 2:        # horizontal phase: probe bit
            rb = 32 * bw - 2 - kk
            w, b = rb >> 5, rb & 31
            delta = ((hp[w] >> b) & 1) - ((hn[w] >> b) & 1)
        else:                             # diagonal phase
            delta = 1 - ((d0[bw - 1] >> 31) & 1)
        dist = torch.where(j < lbc, dist + delta, dist)
        for k in range(bw):
            hi = ((d0[k + 1] << 31) & M32) if k + 1 < bw else 0
            d0s = (d0[k] >> 1) | hi
            vp[k] = hn[k] | (M32 ^ (d0s | hp[k]))
            vn[k] = d0s & hp[k]
    lb64 = lb.to(torch.int64)
    dist = torch.where(lb64 == 0, la, dist)
    dist = torch.where((la - lb64).abs() > cut, int(BIG), dist)
    dist = torch.where(dist > cut, int(BIG), dist)
    return dist.to(torch.int32)


def lev_banded_1v_many(query: np.ndarray, cand: torch.Tensor,
                       lb: torch.Tensor, *, cutoff: int, mode: str = "byte",
                       staged=None) -> torch.Tensor:
    """Banded one-vs-many Levenshtein -> ``[B]`` int32.

    Exact when ``<= cutoff``; candidates above the cutoff yield
    :data:`BIG`.  Routes as the JAX wrapper does: the pinned band when the
    query is longer than it (``16*bw - 1`` chars) and the bucket is at
    most :data:`FAST_MAX_LB`, else the run-time band of semiwidth
    ``cutoff``, which needs ``cutoff <= MAX_CUTOFF`` (``ValueError``
    otherwise).  Requires ``0 <= cutoff <= MAX_CUTOFF_FAST`` and
    ``cutoff < len(query)``.  ``staged`` is
    :func:`~.lev_kernel.stage_query`'s output for this query and mode."""
    q = np.asarray(query)
    la = int(q.size)
    if not 0 <= cutoff <= MAX_CUTOFF_FAST:
        raise ValueError(f"cutoff {cutoff} outside [0, {MAX_CUTOFF_FAST}]")
    if cutoff >= la:
        raise ValueError("banded kernel requires cutoff < len(query)")
    LB = cand.shape[0] * 4
    bw = band_words(cutoff)
    if la > 16 * bw - 1 and LB <= FAST_MAX_LB:
        # the pinned band (semiwidth 16*bw - 1 >= cutoff; the true
        # cutoff applies in the final mask)
        return _band(q, cand, lb, cutoff, bw, 16 * bw - 1, mode, staged,
                     "lev_band")
    if cutoff > MAX_CUTOFF:
        raise ValueError(
            f"cutoff {cutoff} > {MAX_CUTOFF} needs the pinned band kernel "
            f"(query > {16 * bw - 1} chars, bucket <= {FAST_MAX_LB})")
    return _band(q, cand, lb, cutoff, 1, cutoff, mode, staged, "lev_band_rt")


def lev_banded_stream_1v_many(query: np.ndarray, cand: torch.Tensor,
                              lb: torch.Tensor, *, cutoff: int,
                              mode: str = "byte",
                              staged=None) -> torch.Tensor:
    """Banded scan over long (> 1024-char) candidate buckets -> ``[B]``
    int32, the pinned band of :func:`lev_banded_1v_many` at any bucket
    length (``band_kernel.lev_banded_stream_1v_many``).

    Same contract (exact when ``<= cutoff``, :data:`BIG` above it) and the
    JAX wrapper's refusals: ``0 <= cutoff <= MAX_CUTOFF_FAST``,
    ``cutoff < len(query)`` and a query longer than the pinned band.  The
    TPU kernel also needed a bucket that is a multiple of its 512-char
    chunk; this one takes any."""
    q = np.asarray(query)
    la = int(q.size)
    if not 0 <= cutoff <= MAX_CUTOFF_FAST:
        raise ValueError(f"cutoff {cutoff} outside [0, {MAX_CUTOFF_FAST}]")
    if cutoff >= la:
        raise ValueError("banded kernel requires cutoff < len(query)")
    bw = band_words(cutoff)
    if la <= 16 * bw - 1:
        raise ValueError("pinned band must be narrower than the pattern")
    return _band(q, cand, lb, cutoff, bw, 16 * bw - 1, mode, staged,
                 "lev_band_long")


def _band(q: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, cut: int,
          bw: int, semi: int, mode: str, staged, name: str) -> torch.Tensor:
    """K3 with a ``bw``-word band of semiwidth ``semi`` -> ``[B]`` int32
    (kernel on CUDA tensors counted under ``name``, plain version on CPU
    tensors)."""
    la = int(q.size)
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
    tabs = tabs[: table_words(la, LB)]
    if dev.type == "cpu":
        return lev_band_plain(la, cut, bw, tabs, cand, lb, semi)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        threads = block_threads(B, LB, _sm_count(dev.index))
        launch(name, "rf_lev_band", dev, tabs.data_ptr(), tabs.shape[0], la,
               cut, semi, bw, cand.data_ptr(), lb.data_ptr(),
               out.data_ptr(), B, cand.shape[0], threads)
    return out
