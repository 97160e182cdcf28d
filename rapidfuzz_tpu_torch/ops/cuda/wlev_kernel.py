"""One-vs-many weighted Levenshtein (Wagner-Fischer) on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/wlev_kernel.py`` and of the
weighted part of ``stream_kernel.py``.  One kernel, ``csrc/wlev_scan.cu``
(K7), replaces two TPU kernels:

* ``wlev_kernel._kernel`` (``_run``, launch name ``wlev_scan``), buckets
  of at most 1024 chars;
* ``stream_kernel._wlev_kernel`` (``_wlev_run``), which the JAX package
  takes for buckets over 1024 chars that are whole 512-char chunks, for
  queries of at most 256 chars: the TPU streamed such texts in chunks and
  capped the query because a candidate block and its row scratch had to
  fit VMEM, while here a candidate's thread, or its lanes, walk its text
  at any length with its row in registers, so the same kernel serves
  every bucket and every query.  Launches over buckets longer than
  :data:`~.lev_kernel.LONG_LB` count as ``wlev_scan_long``.

The corpus and the PM table are K1's (:func:`~.lev_kernel.prepare_corpus`,
:func:`~.lev_kernel.stage_query`): ``cand`` ``[LB/4, B]``, ``lb`` ``[B]``,
``tabs`` ``[W, 256]``.  Deletion is charged on the query's chars and
insertion on the candidate's, as ``levenshtein.distance(query, cand,
weights=(ins, del, sub))``.  Cells are int32, as on the TPU, so a table
whose cells could overflow raises ``ValueError`` (:func:`fits_int32`).

Queries of more than :data:`MAX_REG_LA` chars run K7's tile form: a lane
holds :data:`TILE` query positions of a candidate's row in registers, a
candidate takes up to a warp's lanes, and the lanes hand their tile's
right edge on by shuffle.  Past :data:`STRIP` chars the warp sweeps the
query in strips, passing one int32 per text row through an edge buffer
(``[chunk, LB]``); the wrapper launches over chunks of candidates whose
edge buffers stay within :data:`SCRATCH_BYTES`, read at each call, one
launch each (:func:`edge_chunk`).

The wrapper runs the kernel when handed CUDA tensors and the plain PyTorch
version (:func:`wlev_scan_plain`) when handed CPU tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, launch, plain_slice
from .lcs_kernel import padded_tables, text_steps
from .lev_kernel import LONG_LB, PM_ROWS, stage_query, words

MAX_REG_LA = 128         # K7 keeps a candidate's row in one thread's
                         # registers up to this many query chars; longer
                         # queries take the tile form
TILE = 32                # query positions a lane of the tile form holds
STRIP = 32 * TILE        # query positions a warp sweeps at once; longer
                         # queries pass an edge buffer between strips
SCRATCH_BYTES = 1 << 30  # bound of one launch's edge buffer (the
                         # scanner's memory plan)
BLOCK = 256              # chunks of candidates are whole multiples of this


def fits_int32(la: int, LB: int, ins: int, dele: int, sub: int) -> bool:
    """Whether the int32 cells of a query of ``la`` chars against a bucket
    of ``LB`` chars cannot overflow (``wlev_kernel.py:134-137``)."""
    return la * max(dele, sub, 1) + LB * max(ins, sub, 1) < 2 ** 31


def edge_chunk(LB: int, B: int) -> int:
    """Candidates per launch of the tile form for queries over
    :data:`STRIP` chars: ``4 * LB`` bytes of edge buffer each (``LB`` the
    bucket), whole multiples of :data:`BLOCK`, within
    :data:`SCRATCH_BYTES`."""
    return min(B, max(BLOCK, SCRATCH_BYTES // (4 * LB) // BLOCK * BLOCK))


def wlev_scan_plain(la: int, tabs: torch.Tensor, cand: torch.Tensor,
                    lb: torch.Tensor, ins: int, dele: int,
                    sub: int) -> torch.Tensor:
    """Plain PyTorch K7: ``tabs [W, 256]`` -> ``[B]`` int32 distances.

    The recurrence of ``wlev_kernel._kernel``, text step by text step,
    vectorised over candidates and query positions.  With
    ``t[0] = D_old[0] + ins`` and
    ``t[p] = min(D_old[p] + ins, D_old[p-1] + (P[p-1] == c ? 0 : sub))``,
    the new row ``D[p] = min(t[p], D[p-1] + del)`` is the prefix minimum
    ``min_{k<=p} t[k] + del*(p-k)``: kept as ``E[p] = D[p] - p*del``, a
    step is one ``cummin`` of ``E_t``.  The per-char costs come from the
    PM table (bit ``p % 32`` of word ``p // 32`` at the char's row).
    Steps past a candidate's length leave its row as it is.  Cells are
    int32, as the kernel's: :func:`fits_int32` bounds every ``E``, which
    lies in ``[-la*del, LB*max(ins, sub)]``.  On the CPU
    the candidates go in slices of at most ``PLAIN_GRAIN / (la+1)``, so a
    step's tensors stay under PyTorch's grain size and run on one
    thread."""
    B = lb.numel()
    lb64 = lb.to(torch.int64)
    if la == 0 or B == 0:
        return (lb64 * ins).to(torch.int32)
    dev = lb.device
    pos = torch.arange(la, device=dev)
    hit = (padded_tables(tabs)[pos >> 5] >> (pos & 31)[:, None]) & 1
    # [257, la]: the substitution cost of each char at each position,
    # less the deletion the shift to E folds in (row 256: past the end)
    cost = ((1 - hit) * sub - dele).t().to(torch.int32).contiguous()
    step = plain_slice(B, la + 1, dev)
    out = []
    for s in range(0, B, step):
        lbs = lb64[s: s + step]
        lmin = int(lbs.min())
        e = torch.zeros((lbs.numel(), la + 1), dtype=torch.int32,
                        device=dev)
        for j, ch in enumerate(text_steps(cand[:, s: s + step], lbs)):
            # index_select, not cost[ch]: on the CPU advanced indexing
            # runs multi-threaded at any size and stalls under load
            sub_or_match = e[:, :-1] + cost.index_select(0, ch)
            t = torch.cat([e[:, :1] + ins,
                           torch.minimum(e[:, 1:] + ins, sub_or_match)], 1)
            t = torch.cummin(t, 1).values
            e = t if j < lmin else torch.where((j < lbs)[:, None], t, e)
        out.append(e[:, la] + la * dele)
    return torch.cat(out).to(torch.int32)


def _wlev_scan(la, tabs, cand, lb, ins, dele, sub,
               name: str) -> torch.Tensor:
    """K7 over one query -> ``[B]`` int32 (kernel on CUDA tensors, plain
    version on CPU tensors)."""
    dev = cand.device
    check(cand, "cand", torch.int32, 2)
    check(lb, "lb", torch.int32, 1, dev)
    check(tabs, "tabs", torch.int32, 2, dev)
    W, rows = tabs.shape
    B = lb.shape[0]
    if cand.shape[1] != B or rows != PM_ROWS or W != words(la):
        raise ValueError(f"shape mismatch: la {la}, cand "
                         f"{tuple(cand.shape)}, lb {tuple(lb.shape)}, tabs "
                         f"{tuple(tabs.shape)}")
    if not fits_int32(la, cand.shape[0] * 4, ins, dele, sub):
        raise ValueError("weight table too large for the int32 device DP; "
                         "use the scalar API for costs of this magnitude")
    if dev.type == "cpu":
        return wlev_scan_plain(la, tabs, cand, lb, ins, dele, sub)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    chunk, edge = B, None
    if la > STRIP and B:
        # the strips' edge buffer, [chunk, LB] int32, bounded by
        # SCRATCH_BYTES: one launch per chunk of candidates
        LB = cand.shape[0] * 4
        chunk = edge_chunk(LB, B)
        edge = torch.empty(LB * chunk, dtype=torch.int32, device=dev)
    for b0 in range(0, B, chunk):
        launch(name, "rf_wlev_scan", dev, tabs.data_ptr(), la, ins, dele,
               sub, cand.data_ptr(), lb.data_ptr(), out.data_ptr(),
               None if edge is None else edge.data_ptr(), B, b0,
               min(chunk, B - b0), cand.shape[0])
    return out


def wlev_1v_many(query: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, *,
                 ins: int, dele: int, sub_cost: int, mode: str = "byte",
                 staged=None) -> torch.Tensor:
    """One-vs-many weighted Levenshtein distances -> ``[B]`` int32, at any
    bucket and query length (``wlev_kernel.wlev_1v_many`` and
    ``stream_kernel.wlev_stream_1v_many``).

    ``query`` is the pattern: deleting one of its chars costs ``dele``,
    inserting a candidate's char ``ins``, substituting ``sub_cost``.
    ``staged`` is :func:`~.lev_kernel.stage_query`'s output for this query
    and mode.  An empty query gives ``lb * ins``.  Raises ``ValueError``
    for a table whose int32 cells could overflow."""
    q = np.asarray(query)
    _, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "wlev_scan_long" if cand.shape[0] * 4 > LONG_LB else "wlev_scan"
    return _wlev_scan(int(q.size), tabs, cand, lb, int(ins), int(dele),
                      int(sub_cost), name)
