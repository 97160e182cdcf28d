"""One-vs-many uniform Levenshtein (Myers/Hyyrö) and the wide-alphabet
remap, on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/lev_kernel.py``.  Kernels:

* ``csrc/lev_scan.cu`` (K1) replaces ``lev_kernel._kernel`` in both its
  one-query form (``_run``) and its 16-query form (``_run_nq``), and
  ``stream_kernel._kernel`` (``_run``), which the JAX package takes for
  buckets over 1024 chars: the TPU streamed such texts in 512-char chunks
  because a candidate block did not fit VMEM, while CUDA lanes walk
  their candidate's text at any length, so the same kernel serves every
  bucket.  One-query launches over buckets longer than :data:`LONG_LB`
  count as ``lev_scan_long``.  Queries up to :data:`MAX_REG_W` words run
  one thread a candidate; longer ones run the tile form
  (:func:`tile_plan`): :data:`TILE_WORDS` query words a lane, ``G`` lanes
  a candidate passing the HP/HN carries by shuffle, strips of
  :data:`STRIP_WORDS` passing them through an edge buffer of 2 bits a
  text row (:func:`edge_chunk`);
* ``csrc/remap_pack.cu`` (K2) replaces ``lev_kernel._remap_kernel``
  (``remap_pack``).

Layouts (the JAX arrays with the TPU's ``(B/128, 128)`` tiling flattened):

* packed corpus ``cand``: ``[LB/4, B]`` int32 holding u32 bit patterns,
  char ``j`` of candidate ``b`` in byte ``j % 4`` of ``cand[j // 4, b]``
  (pad bytes 0);
* lengths ``lb``: ``[B]`` int32;
* PM table ``tabs``: ``[W, 256]`` int32 bit patterns, bit ``i % 32`` of
  ``tabs[i // 32, c]`` set iff ``query[i] == c``.  One table serves both
  the "byte" mode (chars < 256) and the "local" mode (chars < 128); the
  TPU's two 128-lane tables and their select were a gather-width artefact.

Each wrapper runs its kernel when handed CUDA tensors and the plain
PyTorch version (``*_plain``) when handed CPU tensors; it never falls
back from one to the other.  The plain versions compute in int64 masked
to 32 bits after every add and left shift, and complement by XOR with
``0xFFFFFFFF``, so shifts are logical and sums wrap exactly as the
kernels' u32 arithmetic does.  They read PM table rows with
``index_select``: PyTorch's advanced indexing runs on the CPU's thread
pool at any size, and stalls when other processes hold the cores.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, launch

LANE = 128       # the JAX package's lane width (layout mapping, pick_mode)
PM_ROWS = 256    # PM table entries: every byte value
MAX_REG_W = 8    # K1's register form (a thread a candidate) up to this
                 # many words; its tile form past it
TILE_WORDS = 8   # query words a lane of K1's tile form holds
STRIP_WORDS = 128  # query words a strip of the tile form holds (its
                   # shared PM table: 1 KB a word)
EDGE_ROWS = 16   # text rows a u32 of the strip edge buffer packs (2 bits
                 # each: hp_c, hn_c)
SCRATCH_BYTES = 1 << 30  # bound of one launch's edge buffer (the
                         # scanner's memory plan)
BLOCK = 1024     # the tile form's block; chunks are whole multiples of it
LONG_LB = 1024   # longest bucket of the TPU's lev_kernel; longer buckets
                 # were stream_kernel's (the lev_scan_long count)
MISS_ID = 127    # query-local id for "not in query": PM row 127 is zero
                 # whenever the query has <= 127 distinct symbols
M32 = 0xFFFFFFFF


def words(la: int) -> int:
    """u32 words of a query of ``la`` chars (W >= 1)."""
    return max(1, -(-int(la) // 32))


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in ``[0, 2**32)``."""
    return x.to(torch.int64) & M32


# ------------------------------------------------------------------ host side

def build_pm_tables(query: np.ndarray, mode: str) -> np.ndarray:
    """Host-side PM table build -> ``[W, 256]`` u32 (the reference's
    ``BatchComparator::new`` precompute, ``levenshtein.rs:1645-1657``).

    "local" mode keeps only chars < 128 and "byte" mode chars < 256, as
    the JAX tables do."""
    q = np.asarray(query, np.int64)
    dom = PM_ROWS if mode == "byte" else LANE
    pm = np.zeros((words(q.size), PM_ROWS), np.uint32)
    pos = np.nonzero((q >= 0) & (q < dom))[0]
    if pos.size:                       # ufunc.at ORs duplicates correctly
        np.bitwise_or.at(pm, (pos >> 5, q[pos]),
                         np.uint32(1) << (pos & 31).astype(np.uint32))
    return pm


def pm_tables_from_jax(tabs: np.ndarray, mode: str) -> np.ndarray:
    """JAX ``build_pm_tables`` output ``[W*ntab, sub, 128]`` u32 -> the
    port's ``[W, 256]`` (slot ``w*ntab + h`` covers chars
    ``[h*128, (h+1)*128)`` of word ``w``; local mode has ``ntab == 1`` and
    leaves rows 128..255 zero)."""
    ntab = 2 if mode == "byte" else 1
    rows = np.asarray(tabs, np.uint32)[:, 0, :]
    W = rows.shape[0] // ntab
    out = np.zeros((W, PM_ROWS), np.uint32)
    out[:, : ntab * LANE] = rows.reshape(W, ntab * LANE)
    return out


def corpus_from_jax(cand3: np.ndarray, lb2: np.ndarray):
    """JAX ``prepare_corpus`` output (``[LB/4, B/128, 128]`` u32,
    ``[B/128, 128]`` i32) -> the port's (``[LB/4, B]`` int32 bit patterns,
    ``[B]`` int32)."""
    c = np.ascontiguousarray(np.asarray(cand3, np.uint32))
    return (c.reshape(c.shape[0], -1).view(np.int32),
            np.asarray(lb2, np.int32).reshape(-1))


def _pack4(t: torch.Tensor) -> torch.Tensor:
    """``[LB, B]`` int64 byte values -> ``[LB/4, B]`` packed int32 bits."""
    LB, B = t.shape
    if LB % 4:
        raise ValueError(f"candidate bucket {LB} must be a multiple of 4")
    t = t.reshape(LB // 4, 4, B)
    packed = (t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)
              | (t[:, 3] << 24)) & M32
    return to_i32_bits(packed).contiguous()


def prepare_corpus(chars: torch.Tensor, lens: torch.Tensor):
    """``[B, LB]`` chars -> (``[LB/4, B]`` packed int32, ``[B]`` int32
    lengths), on the chars' device.

    ``chars`` is int32 (values < 256, PAD -1) or uint8 (PAD as 0).  Four
    text positions pack into each u32 so that each text step of a thread
    is one coalesced 4-byte load per 4 chars; pad bytes are 0 and never
    read (a thread stops at its candidate's length).  The bytes are
    reinterpreted in place (little-endian: char ``j`` in byte ``j % 4``),
    so packing needs one byte array and one transposed copy, never a wider
    temporary."""
    if chars.dtype == torch.int32:
        u8 = chars.clamp(min=0).to(torch.uint8)
    elif chars.dtype == torch.uint8:
        u8 = chars.contiguous()
    else:
        raise TypeError(f"chars: dtype {chars.dtype}, expected int32 or "
                        "uint8")
    if u8.dim() != 2:
        raise ValueError(f"chars: {u8.dim()}-d, expected 2-d")
    if u8.shape[1] % 4:
        raise ValueError(f"candidate bucket {u8.shape[1]} must be a "
                         "multiple of 4")
    packed = u8.view(torch.int32).t().contiguous()
    return packed, lens.to(device=chars.device,
                           dtype=torch.int32).contiguous()


def transpose_corpus(chars: torch.Tensor) -> torch.Tensor:
    """``[B, LB]`` int32 -> ``[LB, B]`` int32 (query-independent; done once
    at scanner build so each query's remap is elementwise work)."""
    check(chars, "chars", torch.int32, 2)
    return chars.t().contiguous()


def query_vocab(q: np.ndarray):
    """(sorted distinct chars padded to [128] i32, query-local ids) or
    ``None`` when the query has > 127 distinct symbols."""
    q32 = np.asarray(q, np.int64)
    vocab = np.unique(q32)
    dropped = vocab.size and vocab[-1] == np.iinfo(np.int32).max
    if dropped:
        vocab = vocab[:-1]               # == the qvocab128 pad sentinel
    if vocab.size > MISS_ID or (dropped and vocab.size >= MISS_ID):
        return None
    q_local = np.searchsorted(vocab, q32).astype(np.int32)
    # a query char of int32.max can't be in the vocab; corpus chars never
    # equal it either (CorpusScanner vocab-remaps such corpora), so park
    # it on an id no corpus char maps to — row `vocab.size` (< MISS_ID)
    q_local[q32 == np.iinfo(np.int32).max] = vocab.size
    padded = np.full(LANE, np.iinfo(np.int32).max, np.int32)
    padded[: vocab.size] = vocab
    return padded, q_local


def pick_mode(query: np.ndarray, corpus_max: int) -> str:
    """'local' when every char < 128, else 'byte' (the PM table serves
    both; the mode decides which query chars enter it)."""
    q = np.asarray(query)
    qmax = int(q.max()) if q.size else 0
    return "local" if max(qmax, corpus_max) < LANE else "byte"


def stage_query(query: np.ndarray, mode: str, device=None):
    """Upload a query's length and PM table: ``(las [1] int32,
    tabs [W, 256] int32)``, reusable across scans via ``staged=``."""
    q = np.asarray(query)
    las = torch.tensor([int(q.size)], dtype=torch.int32, device=device)
    tabs = torch.from_numpy(build_pm_tables(q, mode).view(np.int32))
    return las, tabs.to(device)


def stage_queries(queries, mode: str, device=None):
    """Upload NQ same-W-bucket queries: ``(las [NQ], tabs [NQ, W, 256])``
    for :func:`lev_nq_many`'s ``staged=``."""
    qs = [np.asarray(q) for q in queries]
    las = torch.tensor([q.size for q in qs], dtype=torch.int32,
                       device=device)
    tabs = np.stack([build_pm_tables(q, mode) for q in qs]).view(np.int32)
    return las, torch.from_numpy(tabs).to(device)


# ----------------------------------------------------------- K1: lev_scan

def lev_scan_plain(las: torch.Tensor, tabs: torch.Tensor,
                   cand: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: ``las [NQ]``, ``tabs [NQ, W, 256]`` -> ``[NQ, B]``
    int32 distances.  The block recurrence of ``lev_kernel._kernel``
    (Hyyrö's HP/HN carry chain across W words, ``levenshtein.rs:838-875``)
    vectorised over queries and candidates; each distance stops at its
    candidate's length."""
    NQ, W, _ = tabs.shape
    LB = cand.shape[0] * 4
    lbc = lb.to(torch.int64).clamp(max=LB)
    steps = int(lbc.max()) if lbc.numel() else 0
    c64 = u32(cand)
    tab = u32(tabs)
    la = las.to(torch.int64)[:, None]                    # [NQ, 1]
    last = (la - 1) & 31
    vp = [torch.full((NQ, lbc.numel()), M32, dtype=torch.int64,
                     device=lb.device) for _ in range(W)]
    vn = [torch.zeros_like(vp[0]) for _ in range(W)]
    dist = la.expand_as(vp[0]).clone()
    for j in range(steps):
        ch = (c64[j >> 2] >> (8 * (j & 3))) & 0xFF
        hp_c, hn_c = 1, 0
        delta = None
        for w in range(W):
            x = tab[:, w].index_select(1, ch) | hn_c
            d0 = ((((x & vp[w]) + vp[w]) & M32) ^ vp[w]) | x | vn[w]
            hp = vn[w] | (M32 ^ (d0 | vp[w]))
            hn = d0 & vp[w]
            if w == W - 1:
                delta = ((hp >> last) & 1) - ((hn >> last) & 1)
            hp_s = ((hp << 1) & M32) | hp_c
            hn_s = ((hn << 1) & M32) | hn_c
            vp[w] = hn_s | (M32 ^ (d0 | hp_s))
            vn[w] = hp_s & d0
            hp_c, hn_c = hp >> 31, hn >> 31
        dist = torch.where(j < lbc, dist + delta, dist)
    # an empty query gives each candidate's length
    dist = torch.where(la == 0, lb.to(torch.int64)[None, :], dist)
    return dist.to(torch.int32)


def tile_plan(W: int, L: int = TILE_WORDS):
    """``(L, G, S)`` of K1's tile form (K4's and K6's with their ``L``) for
    a query of ``W`` words (past :data:`MAX_REG_W`): ``L`` query words a
    lane, ``G`` lanes a candidate (``32 // G`` candidates a warp), strips of
    ``S`` words."""
    S = STRIP_WORDS
    return L, min(-(-W // L), S // L), S


def edge_chunk(LB: int, B: int, NQ: int = 1, rows: int = EDGE_ROWS) -> int:
    """Candidates per launch of a tile form (K1's; K4's and K6's with their
    ``rows``) for queries over a strip: ``ceil(LB / rows)`` u32 of edge
    buffer per candidate and query (``LB`` the bucket, ``rows`` text rows a
    u32), whole multiples of :data:`BLOCK`, within :data:`SCRATCH_BYTES`."""
    per = 4 * NQ * -(-LB // rows)
    return min(B, max(BLOCK, SCRATCH_BYTES // per // BLOCK * BLOCK))


def tile_launches(name: str, entry: str, tensors, W: int,
                  rows: int = EDGE_ROWS) -> None:
    """Launch K1's, K4's or K6's entry point ``entry`` (counted as
    ``name``) over every candidate: ``tensors`` are the pointers it takes
    before the edge buffer, the packed corpus ``[LB/4, B]`` third from the
    end and the output ``[NQ, B]`` last.  Queries over :data:`STRIP_WORDS`
    words get an edge buffer of ``rows`` text rows a u32 and one launch
    per chunk of candidates within :data:`SCRATCH_BYTES`
    (:func:`edge_chunk`), else one launch."""
    cand, out = tensors[-3], tensors[-1]
    NQ, B = out.shape
    dev = cand.device
    chunk, edge = B, None
    if W > STRIP_WORDS:
        LB = cand.shape[0] * 4
        chunk = edge_chunk(LB, B, NQ, rows)
        edge = torch.empty(NQ * -(-LB // rows) * chunk, dtype=torch.int32,
                           device=dev)
    for b0 in range(0, B, chunk):
        launch(name, entry, dev, *(t.data_ptr() for t in tensors),
               None if edge is None else edge.data_ptr(), B, b0,
               min(chunk, B - b0), cand.shape[0], W, NQ)


def _lev_scan(las, tabs, cand, lb, name: str) -> torch.Tensor:
    """K1 over stacked queries -> ``[NQ, B]`` int32 (kernel on CUDA
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
        return lev_scan_plain(las, tabs, cand, lb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((NQ, B), dtype=torch.int32, device=dev)
    if B and NQ:
        # strips pass 2 bits a text row through the edge buffer
        tile_launches(name, "rf_lev_scan", (tabs, las, cand, lb, out), W)
    return out


def lev_1v_many(query: np.ndarray, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """One-vs-many uniform Levenshtein distances -> ``[B]`` int32, at any
    bucket length (``lev_kernel.lev_1v_many`` and
    ``stream_kernel.lev_stream_1v_many``).

    ``cand``/``lb`` from :func:`prepare_corpus` (or :func:`remap_pack`);
    ``staged`` (from :func:`stage_query`) skips the per-call table
    upload.  An empty query gives each candidate's length."""
    q = np.asarray(query)
    las, tabs = staged if staged is not None else stage_query(
        q, mode, cand.device)
    name = "lev_scan_long" if cand.shape[0] * 4 > LONG_LB else "lev_scan"
    return _lev_scan(las, tabs.reshape(1, *tabs.shape), cand, lb, name)[0]


def lev_nq_many(queries, cand: torch.Tensor, lb: torch.Tensor, *,
                mode: str = "byte", staged=None) -> torch.Tensor:
    """Many-vs-many uniform Levenshtein -> ``[NQ, B]`` int32, all queries
    in one launch.

    All queries must land in the same word bucket (equal
    ``ceil(len/32)``); callers bucket by W (``CorpusScanner.scan_many``).
    Zero-length queries are valid (distance == candidate length)."""
    qs = [np.asarray(q) for q in queries]
    Ws = {words(q.size) for q in qs}
    if len(Ws) != 1:
        raise ValueError(f"queries span word buckets {sorted(Ws)}")
    las, tabs = staged if staged is not None else stage_queries(
        qs, mode, cand.device)
    return _lev_scan(las, tabs, cand, lb, "lev_scan_nq")


# --------------------------------------------------------- K2: remap_pack

def remap_pack_plain(chars_t: torch.Tensor,
                     qvocab128: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: 7-step lower-bound search of each corpus char in
    the sorted 128-entry query vocab, misses -> :data:`MISS_ID`, then the
    4-per-u32 byte pack."""
    c = chars_t.to(torch.int64)
    v = qvocab128.to(torch.int64)
    pos = torch.zeros_like(c)
    for k in (64, 32, 16, 8, 4, 2, 1):
        pos = torch.where(v[pos + (k - 1)] < c, pos + k, pos)
    # pos reaches at most 127, so a char above the whole vocab fails the
    # hit probe on entry 127 (lev_kernel.py:238-242)
    ids = torch.where(v[pos] == c, pos, MISS_ID)
    return _pack4(ids)


def remap_pack(chars_t: torch.Tensor,
               qvocab128: torch.Tensor) -> torch.Tensor:
    """Wide-alphabet corpus -> query-local byte ids, packed.

    ``chars_t`` ``[LB, B]`` int32 from :func:`transpose_corpus`;
    ``qvocab128`` ``[128]`` int32, the query's sorted distinct chars
    padded with ``int32.max`` (:func:`query_vocab`).  Returns the packed
    ``[LB/4, B]`` corpus the "local"-mode scans take."""
    dev = chars_t.device
    check(chars_t, "chars_t", torch.int32, 2)
    check(qvocab128, "qvocab128", torch.int32, 1, dev)
    LB, B = chars_t.shape
    if qvocab128.shape[0] != LANE:
        raise ValueError(f"vocab has {qvocab128.shape[0]} entries, "
                         f"expected {LANE}")
    if LB % 4:
        raise ValueError(f"candidate bucket {LB} must be a multiple of 4")
    if dev.type == "cpu":
        return remap_pack_plain(chars_t, qvocab128)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((LB // 4, B), dtype=torch.int32, device=dev)
    if B and LB:
        launch("remap_pack", "rf_remap_pack", dev, chars_t.data_ptr(),
               qvocab128.data_ptr(), out.data_ptr(), B, LB // 4)
    return out
