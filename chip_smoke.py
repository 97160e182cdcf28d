#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``rapidfuzz_tpu_torch``) once on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line before the next starts:

1. device  — ``torch.cuda.get_device_name()`` and ``nvidia-smi``'s name,
   power limit and maximum SM clock;
2. build   — nvcc builds the kernels from ``rapidfuzz_tpu_torch/csrc``,
   one process per source, all at once, and reports each kernel's
   registers and spills (``ptxas -v``; K1's, K3's, K4's, K5's, K6's and
   K8's per kernel instance, the run failing if a K3, K4, K5, K6 or K8
   instance spills)
   and, for K1, K3-K11, each kernel's SASS instruction
   count and commonest opcodes (``cuobjdump``);
3. kernels — each kernel route against its plain PyTorch version on the
   card, bit for bit: K1 at W = 1, 2, 3 and 8 (registers), its tile
   form at W = 9, 10, 33, 126 and 129 (one word past a strip, also over
   two chunks of a smaller edge-buffer budget) in byte and local mode
   over buckets 64, 1,056 and 8,192 (the plain version on the texts of
   up to 64 chars, the 32 longest of the long buckets against the
   oracle), 16 queries per launch at W = 1, 2 and 10; K6's and K4's tile
   forms likewise (K4's first tile width 17; K6's texts with adjacent
   swaps, beating K1 on some row of each bucket); the short-text
   routes at 262,144 candidates, the
   long routes (K1 and K4 over 2048- and 8192-char buckets, K4's
   tile form over 2048 only, the run-time band, the streamed bands
   over 2048) at 2,048 candidates, K3's PM ring (its three launch names
   at buckets 64, 1,024, 6,000 and 8,192, pinned bands bw 1-3 and the
   run-time band at semi 0-15, walked texts ending one before, at and
   one past chunk edges, texts just inside and outside the length gate,
   empty texts, far lengths, queries shorter than the bucket:
   ``BAND_CASES``) at 2,048 candidates, where the plain
   versions' per-step Python loops stay within seconds; K4 (the LCS scan)
   at W = 1, 2, 8 and 17 (its first tile width), 16 queries per
   launch, K5 (the LCS band) at indel cutoffs 3-47 with rows far out of
   band, and its exact stop and PM ring (``LCS_BAND_CASES``: buckets 128,
   1,024, 2,048 and 8,192, texts one before, at and one past each stop
   la + 16*bw and every chunk edge, a stop at a chunk edge, a 4,001-char
   query over 8,192 at bw 1 and 2) at 2,048 candidates, K6 (the OSA scan)
   at W = 1, 2, 4 and 9 (its first tile width) and 16 queries per launch
   over near copies with adjacent swaps planted
   across query words and packed 4-char rows, and over 2048- and
   8192-char buckets; K7 (weighted Levenshtein) under the tables
   (1, 2, 3), (3, 2, 1) and (2, 2, 3) in its register form at one to four
   words and for the empty query, its tile form (a tile of 32 query
   positions a lane) at 129-160 and 280-320 chars, at 262,144 candidates
   in byte and local mode, and over buckets of 1,056-8,192 chars at
   993-1,024 (a full strip), 1,025-1,100 (also over several chunks of a
   small edge-buffer budget) and ~2,100 chars (three strips); K8 (the
   Jaro components) in its register form at one, two and five words
   (the stored-char pass 2) and its cursor form at 8, 9, 10, 17, 126 and
   625 words (the last with its tables read through L1), at 262,144
   candidates in byte and local mode, 16 queries per launch (also in
   cursor form), and over 2048-, 8192- and 16,400-char buckets, over near copies with adjacent swaps planted, prefixes over
   the whole shorter string, texts of chars in no query row, empty texts
   and a sentinel char in every query;
   K9 (Damerau-Levenshtein) in its full form at queries of 0-4,001 chars
   (a tile of 32 query columns a lane: 1, 2, 4, 5, 10 and 32 lanes a
   candidate, and strips of 1,024 columns at 1,025, 2,100 and 4,001
   chars, also over several chunks of a small edge-buffer budget) over
   buckets of 32-16,400 chars, with adjacent swaps planted across tiles,
   strips and packed rows, byte and local mode, and its band at radius 3,
   7 and 15 (equal to the plain full distances within the radius, above
   it elsewhere); K10 (partial_ratio's window
   sweep) at queries of 1-300 chars in its register form and 520 in its
   scratch form (also over several chunks of a small scratch budget),
   over buckets of 64, 1,024 and 8,192 chars, byte and local mode, with
   empty candidates, candidates on both sides of the query's length and
   planted exact windows in both roles; K11 (one long pair's band) at
   every R = 1-8 over texts of 3,000-5,000 chars, at the band's edge,
   with la - lb > K, identical runs (the add's carry across every lane
   and warp), a char at every warp edge, a cutoff inside the band and a
   wide vocabulary;
   and one K2 case whose bucket (300,000 chars) makes its blocks
   stride past 65,535 grid rows, its scan held against the oracle on a
   sampled row;
4. serve   — ``ScanService`` over a 1,048,576-string word-like corpus
   (bucket 64) behind ``make_server``; ``/health``, ``/topk``,
   ``/distances`` (plain, ``score_cutoff``, ``score_hint``) and ``/batch``
   answers are held against the C++ oracle;
5. wide    — a ``CorpusScanner`` over 262,144 Cyrillic strings (the
   per-query remap route), held against the oracle;
6. library — ``levenshtein.BatchComparator(q).distances`` and
   ``levenshtein.distance_many([q], corpus, score_cutoff=...)`` over
   65,536 strings on the card, and the four scalar scores, held against
   the oracle;
7. lcs     — the LCS family: ``ScanService(metric="indel")`` over the
   serve corpus behind ``make_server`` (``/topk``, ``/distances`` plain
   and under a cutoff, ``/batch`` of 20 queries), ``CorpusScanner`` under
   lcs_seq and under the weights (2, 2, 5), a mid corpus of 262,144 texts
   of 225-1,024 chars (bucket 1024, near copies of 300 seed passages)
   under indel and lcs_seq cutoffs for 300- and 900-char queries (the LCS
   band), and ``fuzz.ratio_many``, ``RatioBatchComparator`` and
   ``indel.distance_many`` over 65,536 of its texts, all held against the
   oracle;
8. long    — ``ScanService`` over 131,072 texts of 1,025-8,192 chars
   (bucket 8192, 1 GiB packed on the card), near copies of 300 seed
   documents, behind ``make_server``: ``/topk``, ``/distances`` with
   ``score_cutoff`` 3, 15 and 40 and with ``score_hint``, and ``/batch``,
   for queries of 64, 300 and ~4,000 chars; then a second service over
   16,384 of those texts at bucket 6000 (not a whole 512-char chunk: the
   run-time band's route).  Every answer is held against the oracle over
   the whole corpus where a length argument bounds the work (top-k and
   cutoff answers), on sampled rows elsewhere; then a service with
   ``metric="indel"`` over the same texts: ``/topk`` for the three
   queries (K4 in register and tile form) and ``score_cutoff`` 15 and
   31 for the ~4,000-char query (the streamed LCS band);
9. osa     — OSA: ``ScanService(metric="osa")`` over the serve corpus
   behind ``make_server`` (``/topk``, ``/distances`` plain and under a
   cutoff, ``/batch`` of 20 queries), a ``CorpusScanner(metric="osa")``
   over the long corpus for the 64- and 300-char queries, an OSA service
   over the bucket-6000 texts for the ~4,000-char query (K6's tile
   form), and ``osa.distance_many`` over 65,536 strings, all held against
   the oracle (whole-corpus windows: OSA is at least the length
   difference and at least half the Levenshtein distance);
10. wlev   — weighted Levenshtein: ``ScanService(weights=(2, 2, 3))``
   over the serve corpus behind ``make_server`` (``/topk``, ``/distances``
   plain and under a cutoff, ``/batch`` of 20 queries), weighted
   ``CorpusScanner``s under (1, 2, 3) over the long corpus for the 64- and
   300-char queries, over the bucket-6000 texts for the ~4,000-char query
   (the tile form, four strips) and over the Cyrillic corpus, and
   ``levenshtein.distance_many`` with a cutoff and
   ``BatchComparator.normalized_similarities`` over 65,536 strings, all
   held against the oracle (whole-corpus windows: a weighted distance is
   at least the length difference times the insertion or deletion cost
   and at least the Levenshtein distance times the cheapest cost);
11. jaro   — the Jaro family: ``ScanService(metric="jaro_winkler")`` over
   the serve corpus behind ``make_server`` (``/topk``, ``/distances``
   plain and under a cutoff, ``/batch`` of 20 queries), a
   ``CorpusScanner(metric="jaro")`` over the long corpus for the 64-,
   300- and ~4,000-char queries, and
   ``jaro_winkler.BatchComparator(q).similarities`` over 65,536 strings,
   every answer held against the oracle's f64 ``1.0 - similarity`` bit
   for bit (whole-corpus windows: a row's similarity is at most that of
   as many common chars as the two strings share, with no
   transposition, boosted by its actual prefix; sampled rows where
   nearly every row lies within that bound);
12. dam    — Damerau-Levenshtein: ``ScanService(metric=
   "damerau_levenshtein")`` over the serve corpus behind ``make_server``
   (``/topk`` with no cutoff and under cutoffs 2, 7 and 15,
   ``/distances`` plain and under a cutoff, ``/batch`` of 20 queries),
   ``damerau_levenshtein.distance_many`` over 65,536 strings, a
   ``CorpusScanner`` over the Cyrillic corpus, one over the long corpus
   for the 64- and 300-char queries and the ~4,000-char query under
   cutoff 15, and the ~4,000-char query in full over 4,096 of the
   bucket-6000 texts, all held against the oracle (whole-corpus windows:
   Damerau is at least the length difference and at least half the
   Levenshtein distance);
13. partial — ``fuzz.partial_ratio``: ``ScanService(metric=
   "partial_ratio")`` over the serve corpus behind ``make_server``
   (``/topk`` for a 12- and a 64-char query, ``/distances`` plain and
   under a cutoff, ``/batch``), ``CorpusScanner``s over the long corpus
   (64-char query), 16,384 bucket-6000 texts (300-char query) and the
   Cyrillic corpus, and ``fuzz.partial_ratio_many`` and
   ``partial_ratio_alignment_many`` over 65,536 strings, held against the
   oracle's brute-force ``1.0 - partial_ratio`` bit for bit on sampled
   rows (the 12-char query's top-k over the whole corpus) and the
   windows against the port's scalar ``partial_ratio_alignment``;
14. pair    — one long pair on the library's device scalar route
   (``RAPIDFUZZ_TPU_SCALAR_BACKEND=device``, K11 and its hint ladder): the
   OCR fixture (106,514 x 107,244 chars, distance 5,278) with no cutoff,
   cutoff 2,500 (``None``) and hint 0, ``similarity`` and
   ``normalized_similarity`` under cutoffs, and a pair of two 30,000-char
   strings past the band's ceiling (4 rungs, then the host route), every
   answer held against the same call on the host oracle's route and each
   call's rungs counted;
15. timing — each kernel and its plain version at its main-path shape
   (the short-text kernels at 1,048,576 candidates of the serve corpus,
   the LCS band at the mid corpus, the long ones at the long phase's
   corpora), with each kernel's bound, the output of each timed launch
   held against the plain version; K1 also at 300 and 4,001 chars over
   the long corpus (its tile form), each with its launches, its plain
   version on the shortest texts, and, as for its register rows, the
   instructions its layout adds to the bound (ramps, idle lanes, the
   wait for a warp's longest text); K6 likewise at 300 and 4,001 chars,
   K4 at 4,001 (their tile forms); K7 also at 32-129 chars over the serve
   corpus and at 299 and 4,001 chars over the long corpus (its tile form,
   the second launched over chunks of the 1 GiB edge-buffer plan), its
   plain version on a slice of the candidates where the whole shape would
   take it over 10 s, each with its layout beside the bound as K1's; K8
   also at 300 and 4,001 chars over the long corpus (its cursor form,
   each with its launches, its plain version on every LONG_SLICE-th text
   and its bound over the steps this data needs); K9 also at
   32 chars (one lane a candidate) and at radius 3 and 15 over the serve
   corpus and at 300 chars over the long corpus, its full form's layout
   (hand-offs, ramps, padded columns) beside its bound; K10 with a 12-char query
   over the serve corpus, and a 64-char one over the serve and the long
   corpus; K11 on the OCR pair at R = 1, 2, 3, 4 and 8 (ms and ns a text
   step), its plain version on the first 4,096 text chars at R = 4, and
   beside its bound the one-warp and one-SM figures; K3's three rows,
   their bounds over the texts its length gate walks (within the cutoff
   of the query's length), with the instructions its layout adds beside
   the bound (a warp stepping to its longest walk) and, for the long
   rows, the floor their longest walks' chains of steps set: one warp
   alone over the 32 longest;
16. rate   — one len-64 query, then 16 per launch, against 67,108,864
   len-64 candidates packed on the device.

Kernel launch counters are zeroed just before phase 4 and read after phase
5, zeroed again just before phase 7 and read after it, just before phases
8, 9, 10, 11, 12, 13 and 14 and read after each, so the counts are those
of the nine main paths alone; every kernel must have launched in them.
The done line also counts the main paths' K1, K4, K5, K6 and K8 launches
and their candidates by query words (``launches_by_words``: [launches,
candidates] per W; K5's per "W/bw", query words and band words).  Each
phase's line gives its seconds and those of its oracle checks
(``oracle_s``), the kernels phase's also per family of cases and the wlev,
jaro, dam and partial phases' per part.
Any failure raises: the script then exits nonzero and never prints its
last line, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero before any phase.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LB = 64
N_SERVE = 1 << 20
N_WIDE = 1 << 18
N_KERNEL = 1 << 18
N_KERNEL_LONG = 1 << 11
N_TIMING = 1 << 20
N_RATE = 1 << 26
N_PLAIN_RATE = 1 << 22
N_SAMPLE = 4096
#: rows each of the wlev phase's 20 /batch queries is held on: the
#: oracle's weighted distance is one scalar call per row
N_BATCH_SAMPLE = 1024
N_LIB = 1 << 16
LONG_LB = 8192
N_LONG = 1 << 17
N_DOCS = 300
Q_LONG = 4000
ODD_LB = 6000
N_ODD = 1 << 14
LONG_SAMPLE = 256
N_MID = 1 << 18
MID_LB = 1024
MID_MIN = 225
N_PASSAGES = 300
N_RATIO = 1 << 16
#: K2's stride case: a bucket past 65,535 packed rows of 4 chars
STRIDE_LB = 300_000
N_STRIDE = 256
#: the timing phase holds K7's timed launches on every WLEV_SLICE-th of
#: the serve corpus's candidates and every LONG_SLICE[query]-th text of
#: the long corpus against its plain version, which takes over 10 s on
#: the whole long corpus
WLEV_SLICE = 64
LONG_SLICE = {"q64": 8, "q300": 32, "q4k": 512}
#: the timing phase holds K1's and K4's 300-char scans over the long corpus
#: on its LONG_SHORTEST shortest texts
LONG_SHORTEST = 2048
#: the kernel cases' bucket past the TPU's 16,384-char Jaro cap, and its
#: candidates
HUGE_LB = 16400
N_HUGE = 256
#: the Damerau phase's full ~4,000-char scan runs over the last DAM_ODD of
#: the bucket-6000 texts (the near copies of the query among them); and
#: the timing phase holds
#: K9's full scans on every DAM_SLICE-th candidate against its plain
#: version, the band over the long corpus on every DAM_BAND_SLICE-th
DAM_ODD = 4096
DAM_SLICE = 8
DAM_BAND_SLICE = 16
#: the timing phase holds K9's ~4,000-char scan of the long corpus on its
#: DAM_SHORTEST shortest texts
DAM_SHORTEST = 64
#: K1's tile form in the kernel cases: the query widths (129: one word
#: past a strip), the text length up to which the plain version holds the
#: long buckets' texts, and the longest texts held against the oracle
TILE_WS = (9, 10, 33, 126, 129)
TILE_PLAIN = 64
TILE_ORACLE = 32
#: the timing phase holds K1's ~4,000-char scan of the long corpus on its
#: LEV_SHORTEST shortest texts
LEV_SHORTEST = 64
#: the scans whose launches the main paths also count by query words: the
#: positions of W and of the launch's candidate count among each C entry
#: point's arguments
WORDS_ARG = {"rf_lev_scan": (10, 8), "rf_lcs_scan": (9, 7),
             "rf_osa_scan": (10, 8), "rf_jaro_scan": (10, 8)}
#: the Jaro service's prefix weight (the default) and the library's
JARO_PW = 0.1
JARO_LIB_PW = 0.2
#: K7's weight tables (insertion, deletion, substitution): asymmetric or
#: not reducible to uniform or indel, so an orientation slip shows
WLEV_TABLES = ((1, 2, 3), (3, 2, 1), (2, 2, 3))
#: the weighted service's table and the weighted scanners'
WLEV_SERVE = (2, 2, 3)
WLEV_SCAN = (1, 2, 3)
#: card peaks for the bounds: HBM bytes/s (NVIDIA's data sheet, H100 SXM)
#: and INT32 lanes (132 SMs x 64); the SM clock is read from nvidia-smi
HBM_BYTES_S = 3.35e12
INT32_LANES = 132 * 64
#: least integer operations per unit of work, counting each 3-input logic
#: op (LOP3) and each shift-and-add as one: K1 per query word and text
#: step (the Myers word: and, add, 2 x or3, 2 x lop3, and, 2 x shift-or,
#: 2 carry shifts), K3 per text step of its one-word band (the timed
#: rows' bw; INT32-lane instructions in the SASS of lev_band_kernel<1,1>'s
#: diagonal step: the window's funnel shift, 7 LOP3 (and, or, d0, hp, hn,
#: vp, vn), the shift of d0 and the distance's update, the add issuing on
#: the FMA lanes as an IMAD; an earlier count took 12, K1's word plus
#: the funnel shift), K2 per char (7 search probes of compare and
#: select, the hit test, the byte pack); K4 per query word and text step
#: (the Hyyro word: u = s & pm, the 3-input add s + u + carry, its
#: carry-out, one lop3 for t | (s & ~u)), K5 per band word and text step
#: at the timed rows' one band word (INT32-lane instructions in the SASS
#: of lcs_band_kernel<1>'s unrolled word: the window's funnel shift, and,
#: the lop3 t | (s ^ u), the slide's funnel shift; the add issues on the
#: FMA lanes as an IMAD, and at 2-3 words its carry chain takes ~1.7 more
#: a word; an earlier count took 6 and 1), plus LCS_BAND_STEP_OPS once
#: per text step for the accumulator (a lop3, and a 3-input add for two
#: steps); K6 per query word and text step
#: (K1's 11, plus the and-not t = ~d0_prev & pm, the funnel shift of t
#: with the lower word's t, and the and with pm_prev; the or into d0 folds
#: into K1's 3-input or); K7 per query position and text step
#: WLEV_CELL_OPS)
OPS = {"lev_scan": 11, "lev_scan_nq": 11, "lev_scan_long": 11,
       "lev_band": 10, "lev_band_rt": 10, "lev_band_long": 10,
       "remap_pack": 24, "lcs_scan": 4, "lcs_scan_nq": 4,
       "lcs_scan_long": 4, "lcs_band": 4, "lcs_band_long": 4,
       "osa_scan": 14, "osa_scan_nq": 14, "osa_scan_long": 14,
       "wlev_scan": 100 / 32, "wlev_scan_long": 100 / 32}
#: K7's bound charges every DP cell the INT32-lane instructions of the
#: tile form's unrolled row, counted in the SASS of the built library
#: (wlev_scan_tile's row block: 64 VIADDMNMX, the DPX add-mins
#: min(old + ins, diagonal + cost) and min(left + del, that), 32 SEL of
#: the cost and 4 R2P moving 8 PM bits at a time to predicates, 100 for
#: 32 cells; the cost's add and the moves issue as IMADs on the FMA lanes
#: and do not bind).  The register form's rows take the same count (its
#: step loop holds 3.4 a position with the step's own work).
WLEV_CELL_OPS = OPS["wlev_scan"]
#: What K7 issues beside its bound's cells goes beside it
#: (wlev_scan*_layout_bound_ms), counted in the same SASS under
#: alu_blocks' rule: the register form's INT32-lane instructions per
#: thread and text step (the step loop of wlev_scan_reg<W>, every word up
#: to la's, and its packed-word loop's 12 or 14 a 4 steps), and the tile
#: form's per lane and step beyond its 32 cells (the step loop of its
#: first strip: 122 over every path, of them 100 the cells, 1 the strip
#: edge's store, run only before a later strip, and 3 the corpus load,
#: run every 4th step)
WLEV_REG_STEP_OPS = {1: 110 + 12 / 4, 2: 218 + 14 / 4, 3: 328 + 14 / 4,
                     4: 436 + 14 / 4}
WLEV_TILE_STEP_OPS = 122 - 100 - 1 - 3 * 3 / 4
#: K8's bound counts the work the function needs, the flagging once:
#: pass 1 per text step, (INT32-lane operations per query word, per
#: step), counted from the SASS of the pass-1 loops of jaro_scan_reg<1>
#: and <2> (cuobjdump -sass of the built library: 14 and 23) leaving out
#: the IMADs (FMA lanes) and the load of the next packed word (once per 4
#: steps); then per step of pass 2 the test of a stored text flag (a
#: shift and a test), and per flagged text char past the prefix the pop
#: (the first non-zero word of the claimed set left: one select per
#: query word; then negate, and, clear, the PM bit test and the count).
#: The steps are those this run's data needs: pass 1 from the end of the
#: common prefix until every pattern position is claimed or len2, pass 2
#: until the last flagged char (jaro_scan_plain(..., steps=True)).
#: (The counts are those of the register form before it stored its
#: flagged chars; the bound is the function's work, whatever the form.)
JARO_OPS = {"pass1": (9, 5), "flag_test": 2, "pop": (1, 5)}
#: K8's cursor form (past MAX_REG_W words): INT32-lane instructions per
#: pass-1 step, beyond it per claim, and per pop of pass 2, counted (as
#: alu_blocks counts them) in the SASS of the built library's
#: jaro_scan_cursor<u16, tables in shared memory>: its pass-1 loop takes
#: a packed word a time, 60 instructions for the four steps without a
#: claim or a skip (the char's row, the window's ends, the cursor's
#: compare, the exits, the word's load and its four rows' lookups), 2
#: more a claim (the flag's bit and word for the atomic or); a pop takes
#: 9 (the flag word's lowest bit by BREV and FLO, the row's compare, the
#: counts).  Its replay of pass 1 in pass 2 goes beside the bound
#: (*_replay_bound_ms), not in it
JARO_CURSOR_OPS = {"step": 60 / 4, "claim": 2, "pop": 9}
LCS_BAND_STEP_OPS = 1.5
#: K9's bound charges every DP cell the least INT32-lane operations its
#: unrolled row bodies take for it, counted in the SASS of the built
#: library (the build line's sass row_blocks: the non-IMAD instructions of
#: the largest branch-free blocks; IMADs issue on the FMA lanes and do not
#: bind; alu_blocks: the same without VIADD either, nor the uniform
#: datapath's, memory and shuffle instructions).  The full form: the tile
#: row of dam_scan_tile<1,1>, 351 alu_blocks instructions per 32 cells.
#: Its VIADDs (95 a row; IMADs and VIADDs trade places between builds of
#: one body: 139 and 95 there, 83 and 159 in dam_scan_tile<0,1>) issue
#: off the INT32 lanes: counted on them, as the row_blocks rule counts
#: (450 a row, 14.06 a cell), the full form's scan of the long corpus
#: with a 64-char query would take 32.5 ms at the INT32 lanes' rate, and
#: it ran in 30.9 ms on an H100 (700 W).
#: The band, per radius (its shared-memory form dam_band_kernel<k,1>,
#: still under the row_blocks rule): (the unmasked rows, the first k + 1
#: rows, which also mask the column-0 edge) per cell: 190 and 224 per two
#: rows of 7 cells at k = 3, 437 and 577 of 15 at 7, 935 and 1,194 of 31
#: at 15.  The bound charges each band cell the unmasked rate; the edge
#: rows' extra goes beside it (*_edge_bound_ms).  The cells are those this
#: run's data needs: lb * la per candidate for the full form,
#: lb * (2k + 1) for the band's candidates within k of the query's length
#: (the others return without a row)
DAM_CELL_OPS = 351 / 32
#: What K9's full form issues beyond the bound's cells goes beside it
#: (dam_scan*_layout_bound_ms).  A warp of 32 / G candidates runs, per
#: strip of up to 1,024 query columns, nmax + G' - 1 steps (G lanes a
#: candidate, one per tile of 32 query columns, at most 32; nmax its
#: longest candidate, G' the strip's tiles), and each step issues for all
#: 32 lanes the tile row's 32 cells at DAM_CELL_OPS and the step's own
#: INT32-lane instructions (alu_blocks' rule), DAM_STEP_OPS[G > 1] a lane:
#: the step loop's other instructions, every path counted (the row test,
#: lane 0's char and strip-edge reads, the edge stores), half of the
#: two-step loop's: 43 / 2 in dam_scan_tile<1,1>; at G = 1 the row blocks
#: hold 33 and 46 more than the tile row, and 41 lie outside them.  The
#: layout bound is that issue less the bound's la * lb cells: the
#: hand-offs, the ramp steps, the cells past column la, the lanes that
#: 32 / G groups leave idle and the warp's wait for its longest candidate
DAM_STEP_OPS = ((33 + 46 + 41) / 2, 43 / 2)
#: What K1 runs beside its bound's OPS per query word and text step goes
#: beside it (lev_scan*_layout_bound_ms), counted in the SASS of the built
#: library under alu_blocks' rule: the register form's INT32-lane
#: instructions per thread and text step (lev_scan_reg<2>: 105 in its
#: unrolled 4-char loop, 88 of them the two words' 4 steps), and the tile
#: form's per lane and step (lev_scan_tile's loop when the query fits one
#: strip: 120 over every path, of them 88 its 8 words, 10 the strip edge's
#: store, not run then, and 5 the corpus load, run every 4th step)
LEV_REG_STEP_OPS = {2: 105 / 4}
#: the tile forms' INT32-lane instructions per lane and step, counted as
#: K1's (above) in the SASS of the built library, each step loop over
#: every path less the strip edge's load and store (not run in one strip)
#: and 3/4 of the corpus load (run every 4th step): K1's lev_scan_tile;
#: K6's osa_scan_tile, 173 of them 111 its 8 words (13.9 a word, OPS's 14;
#: the add issues as an IMAD), 11 the edge's load, 9 its store, 6 the
#: corpus load; K4's lcs_scan_tile in the loop its compiler keeps for the
#: first strip, 101 of them 64 its 16 words (OPS's 4 a word; S - u issues
#: as an IMAD), 8 the edge's store, 6 the corpus load
TILE_STEP_OPS = {"lev": 120 - 10 - 5 * 3 / 4,
                 "osa": 173 - 11 - 9 - 6 * 3 / 4,
                 "lcs": 101 - 8 - 6 * 3 / 4}
DAM_BAND_OPS = {3: (13.57, 16.0), 7: (14.57, 19.23), 15: (15.08, 19.26)}
#: What K3 issues beside its bound's OPS goes beside it
#: (lev_band*_layout_bound_ms), counted in a full cuobjdump -sass of the
#: built library under alu_blocks' rule: INT32-lane instructions per
#: thread and text step of lev_band_kernel<1,1>'s unrolled word (4 steps,
#: 8 LDS, 4 PRMT), in chunks with no horizontal phase ("diag": 56, of them
#: 40 the bound's, 12 the window's row, shift and address and 4 the
#: char's PRMT) and in those with it ("phase": 55, the word when no step
#: takes the horizontal branch)
LEV_BAND_STEP_OPS = {"diag": 56 / 4, "phase": 55 / 4}
#: K10's bound charges every window step the function needs, per query
#: word, the INT32-lane instructions of an unmasked Hyyro step, counted in
#: the SASS of the built library: the loop body of K10's role for
#: candidates shorter than the query (the non-IMAD instructions over one or
#: two text chars, divided by the G windows and W words it steps; IMADs,
#: here the W = 1 add, issue on the FMA lanes and do not bind), whose
#: window mask folds into the lop3 that ands S with the PM word:
#: partial_scan_reg<1,8> 55 per two chars, <2,8> 63 per char.  The steps
#: are those this run's data needs: for a candidate of n >= m chars the
#: m - 1 prefix steps and each window's min(m, n - st) chars, for
#: 0 < n < m the whole candidate once for each of its n + m - 1 query
#: windows.  What the group layout adds for n >= m goes beside the bound
#: (*_layout_bound_ms), not in it: its body selects each window's PM on
#: every step (PARTIAL_LAYOUT_OPS: 97 per two chars, 105 per char), and it
#: steps all G windows over the group's m + G - 1 chars, the steps before
#: a window's start and past its end being identity steps; the shorter
#: candidates' last group of windows is padded to G
PARTIAL_STEP_OPS = {1: 55 / 16, 2: 63 / 16}
PARTIAL_LAYOUT_OPS = {1: 97 / 16, 2: 105 / 16}
PARTIAL_G = 8
#: the kernel cases' first query length past K10's register form, and the
#: partial phase's sampled rows of the 300-char query over the
#: bucket-6000 texts (the oracle's brute force takes ~0.3 s a pair there)
PARTIAL_WIDE = 32 * 16 + 8
PARTIAL_ODD_SAMPLE = 24
#: K11's bound charges every band word of every text step the INT32-lane
#: instructions that the Myers/Hyyro band step needs, counted in the SASS
#: of the serial-carry one-warp kernel at R = 4 over its 16 words a lane:
#: the window's funnel shift, the and with vp, the add and its carry into
#: the next word (IADD3, IADD3.X: 16 + 15), the two LOP3s of d0, hp, hn,
#: the slide's funnel shift, vp and vn, 175 in all.  The lookahead kernel
#: keeps that core (its carry, a generate test and the carry's add, costs
#: about what IADD3.X did) and adds around it what goes beside the bound
#: (lev_pair_layout_bound_ms), not in it: lev_pair_kernel<4,4,3> issues
#: LEV_PAIR_STEP_ALU INT32-lane instructions a thread from one barrier to
#: the next, a step, in its diagonal-phase steps and in its others (the
#: mean of a group's inner steps; IMADs, loads, ballots and the barrier
#: not counted), 4 * LEV_PAIR_OPS of them the core's four words, the rest
#: its masks, lookahead, d0 under both carries and the pick, the slots,
#: the window's bounds tests and the delta, on each of its
#: LEV_PAIR_THREADS threads.  The one-warp and one-SM figures
#: (lev_pair_warp_*_ms, lev_pair_sm_*_ms) issue the same instructions at
#: one warp's 32 lanes and at the SM's four schedulers' 128 lanes a cycle:
#: the floors of designs that step one pair with one warp, or on one SM
LEV_PAIR_OPS = (16 + 16 + 16 + 15 + 2 * 16 + 16 + 16 + 3 * 16) / 16
LEV_PAIR_STEP_ALU = (122, 147)
LEV_PAIR_THREADS = 128
#: K3's ring cases (band_cases): (bucket, query length, [(launch name,
#: cutoff)]); lev_band_rt's semiwidth is its cutoff, the pinned bands'
#: 16 * bw - 1
BAND_CASES = (
    (64, 64, [("lev_band", c) for c in (15, 31, 47)]),
    (64, 15, [("lev_band_rt", c) for c in range(15)]),
    (1024, 257, [("lev_band", c) for c in (15, 31, 47)]
     + [("lev_band_long", 47)]),
    (1024, 12, [("lev_band_rt", c) for c in (0, 7, 11)]),
    (6000, 4001, [("lev_band_rt", 0), ("lev_band_rt", 15),
                  ("lev_band_long", 31)]),
    (6000, 40, [("lev_band_rt", 7), ("lev_band_long", 15)]),
    (8192, 4001, [("lev_band_rt", 7), ("lev_band_long", 15),
                  ("lev_band_long", 47)]),
    (8192, 40, [("lev_band_rt", 11), ("lev_band_long", 31)]),
    (8192, 4097, [("lev_band_rt", 15), ("lev_band_long", 15)]),
    (6000, 5990, [("lev_band_rt", 15), ("lev_band_long", 47)]))
#: K5's ring cases (lcs_band_cases): (bucket, query length, PM mode,
#: [(launch name, indel cutoff)]); a walk stops at min(lb, la + 16 * bw):
#: at 76-108 steps inside the 128 bucket and past it (la 120), at the
#: chunk edge 256 (la 240, bw 1), one past the edge at 512 (la 497), at
#: row 14's query length (300), one before the 512 edge (la 495) over
#: 2,048, at the 2,048 bucket's end (la 2,040), and for the 4,001-char
#: query over 8,192 (ws 126, past the 48 words the parent kept in shared
#: memory) at bw 1 and 2; their generators' salts start at LCS_BAND_SALT
LCS_BAND_SALT = 19000
LCS_BAND_CASES = (
    (128, 60, "byte", [("lcs_band", c) for c in (3, 15, 31, 47)]),
    (128, 120, "local", [("lcs_band", 15), ("lcs_band", 47)]),
    (1024, 240, "byte", [("lcs_band", c) for c in (15, 31, 47)]),
    (1024, 497, "local", [("lcs_band", 15)]),
    (1024, 300, "byte", [("lcs_band", 15)]),
    (2048, 495, "byte", [("lcs_band_long", 15), ("lcs_band_long", 31)]),
    (2048, 2040, "byte", [("lcs_band_long", 15)]),
    (8192, 40, "byte", [("lcs_band_long", 7)]),
    (8192, 4001, "byte", [("lcs_band_long", 15), ("lcs_band_long", 31)]))
#: the OCR pair (tests/fixtures/ocr.npz, the reference's proof fixture,
#: levenshtein.rs:2139-2161): its distance and the cutoff that must give
#: None; the pair past the band's ceiling (max_cutoff(8) = 16,383): two
#: independent strings of PAIR_FAR chars over 26 letters
OCR = "tests/fixtures/ocr.npz"
OCR_DIST = 5278
OCR_CUT = 2500
PAIR_FAR = 30000
#: text chars of the OCR pair the plain version walks in the timing phase
PAIR_PLAIN_STEPS = 4096
REPLACES = {
    "lev_scan": "rapidfuzz_tpu/ops/pallas/lev_kernel.py:149",
    "lev_scan_nq": "rapidfuzz_tpu/ops/pallas/lev_kernel.py:407",
    "remap_pack": "rapidfuzz_tpu/ops/pallas/lev_kernel.py:256",
    "lev_band": "rapidfuzz_tpu/ops/pallas/band_kernel.py:388",
    "lev_band_rt": "rapidfuzz_tpu/ops/pallas/band_kernel.py:165",
    "lev_band_long": "rapidfuzz_tpu/ops/pallas/band_kernel.py:620",
    "lev_scan_long": "rapidfuzz_tpu/ops/pallas/stream_kernel.py:135",
    "lcs_scan": "rapidfuzz_tpu/ops/pallas/lcs_kernel.py:107",
    "lcs_scan_nq": "rapidfuzz_tpu/ops/pallas/lcs_kernel.py:141",
    "lcs_scan_long": "rapidfuzz_tpu/ops/pallas/stream_kernel.py:271",
    "lcs_band": "rapidfuzz_tpu/ops/pallas/lcs_band_kernel.py:148",
    "lcs_band_long": "rapidfuzz_tpu/ops/pallas/lcs_band_kernel.py:276",
    "osa_scan": "rapidfuzz_tpu/ops/pallas/osa_kernel.py:118",
    "osa_scan_nq": "rapidfuzz_tpu/ops/pallas/osa_kernel.py:172",
    "osa_scan_long": "rapidfuzz_tpu/ops/pallas/stream_kernel.py:425",
    "wlev_scan": "rapidfuzz_tpu/ops/pallas/wlev_kernel.py:103",
    "wlev_scan_long": "rapidfuzz_tpu/ops/pallas/stream_kernel.py:862",
    "jaro_scan": "rapidfuzz_tpu/ops/pallas/jaro_kernel.py:204",
    "jaro_scan_nq": "rapidfuzz_tpu/ops/pallas/jaro_kernel.py:268",
    "jaro_scan_long": "rapidfuzz_tpu/ops/pallas/stream_kernel.py:683",
    # rows 26-29 (the lane-column forms and the int16 bodies) compute row
    # 21's function at its shapes: dam_scan ports them with it
    "dam_scan": "rapidfuzz_tpu/ops/pallas/damerau_kernel.py:522 "
                "(and :146, :393, :623, :743)",
    "dam_scan_long": "rapidfuzz_tpu/ops/pallas/damerau_kernel.py:1674 "
                     "(and :1648)",
    "dam_band": "rapidfuzz_tpu/ops/pallas/damerau_kernel.py:1038",
    "dam_band_long": "rapidfuzz_tpu/ops/pallas/damerau_kernel.py:1277",
    "partial_scan": "rapidfuzz_tpu/ops/pallas/partial_kernel.py:366 "
                    "(_kernel_q :227, _kernel :68)",
    "lev_pair": "rapidfuzz_tpu/ops/pallas/pair_kernel.py:191 (_kernel :79)",
}
SOURCES = {
    "lev_scan": "rapidfuzz_tpu_torch/csrc/lev_scan.cu",
    "lev_scan_nq": "rapidfuzz_tpu_torch/csrc/lev_scan.cu",
    "remap_pack": "rapidfuzz_tpu_torch/csrc/remap_pack.cu",
    "lev_band": "rapidfuzz_tpu_torch/csrc/lev_band.cu",
    "lev_band_rt": "rapidfuzz_tpu_torch/csrc/lev_band.cu",
    "lev_band_long": "rapidfuzz_tpu_torch/csrc/lev_band.cu",
    "lev_scan_long": "rapidfuzz_tpu_torch/csrc/lev_scan.cu",
    "lcs_scan": "rapidfuzz_tpu_torch/csrc/lcs_scan.cu",
    "lcs_scan_nq": "rapidfuzz_tpu_torch/csrc/lcs_scan.cu",
    "lcs_scan_long": "rapidfuzz_tpu_torch/csrc/lcs_scan.cu",
    "lcs_band": "rapidfuzz_tpu_torch/csrc/lcs_band.cu",
    "lcs_band_long": "rapidfuzz_tpu_torch/csrc/lcs_band.cu",
    "osa_scan": "rapidfuzz_tpu_torch/csrc/osa_scan.cu",
    "osa_scan_nq": "rapidfuzz_tpu_torch/csrc/osa_scan.cu",
    "osa_scan_long": "rapidfuzz_tpu_torch/csrc/osa_scan.cu",
    "wlev_scan": "rapidfuzz_tpu_torch/csrc/wlev_scan.cu",
    "wlev_scan_long": "rapidfuzz_tpu_torch/csrc/wlev_scan.cu",
    "jaro_scan": "rapidfuzz_tpu_torch/csrc/jaro_scan.cu",
    "jaro_scan_nq": "rapidfuzz_tpu_torch/csrc/jaro_scan.cu",
    "jaro_scan_long": "rapidfuzz_tpu_torch/csrc/jaro_scan.cu",
    "dam_scan": "rapidfuzz_tpu_torch/csrc/dam_scan.cu",
    "dam_scan_long": "rapidfuzz_tpu_torch/csrc/dam_scan.cu",
    "dam_band": "rapidfuzz_tpu_torch/csrc/dam_scan.cu",
    "dam_band_long": "rapidfuzz_tpu_torch/csrc/dam_scan.cu",
    "partial_scan": "rapidfuzz_tpu_torch/csrc/partial_scan.cu",
    "lev_pair": "rapidfuzz_tpu_torch/csrc/lev_pair.cu",
}
SHORT_PATH = ("lev_scan", "lev_scan_nq", "remap_pack", "lev_band")
LCS_PATH = ("lcs_scan", "lcs_scan_nq", "lcs_band")
LONG_PATH = ("lev_scan_long", "lev_band_rt", "lev_band_long",
             "lcs_scan_long", "lcs_band_long")
OSA_PATH = ("osa_scan", "osa_scan_nq", "osa_scan_long")
WLEV_PATH = ("wlev_scan", "wlev_scan_long")
JARO_PATH = ("jaro_scan", "jaro_scan_nq", "jaro_scan_long")
DAM_PATH = ("dam_scan", "dam_scan_long", "dam_band", "dam_band_long")
PARTIAL_PATH = ("partial_scan",)
PAIR_PATH = ("lev_pair",)
DAM = "damerau_levenshtein"
PR = "partial_ratio"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    p = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return p.stdout.strip().splitlines()[0]


def ptxas_summary(report: dict) -> dict:
    """Per source, from ``ptxas -v``: each kernel's registers (in the
    order ptxas compiled them) and the spill bytes of all its kernels."""
    out = {}
    for src, log in sorted(report.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        out[src] = {"registers": regs, "spill_bytes": spills}
    return out


def kernel_key(name: str, kernel: str) -> str:
    """A mangled kernel name as its template's name and arguments, e.g.
    ``dam_band_kernel<15,1>``, or as its plain name (``lev_scan_tile``);
    the mangled name where neither holds ``kernel``."""
    m = re.search(r"\d(%s\w*?)I((?:L[ib]\d+E)+)E" % kernel, name)
    if m:
        return f"{m[1]}<{','.join(re.findall(r'L[ib](\d+)E', m[2]))}>"
    m = re.search(r"\d(%s\w*?)E" % kernel, name)
    return m[1] if m else name


def ptxas_kernels(log: str, kernel: str) -> dict:
    """From one source's ``ptxas -v`` log: registers and spill bytes of
    each kernel whose name starts with ``kernel``, keyed by
    ``kernel_key``."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if not re.search(r"\d" + kernel, name):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        out[kernel_key(name, kernel)] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": sum(map(int, spill.groups())) if spill else None}
    return out


#: SASS opcodes (besides IMAD and the uniform datapath's U*) that do not
#: issue on the INT32 lanes: VIADD (it trades places with IMAD between
#: builds of one body), memory, shuffles, moves and control
SASS_OFF_ALU = frozenset(("VIADD", "LDG", "LDS", "LDC", "STG", "STS", "SHFL",
                          "MOV", "S2R", "S2UR", "CS2R", "NOP", "BAR",
                          "WARPSYNC"))


def sass_histogram(kc, kernel: str):
    """For each kernel of the built library whose name starts with ``kernel``:
    its SASS instruction count, its ten commonest opcodes and the
    instructions other than IMAD (which issue on the FMA lanes) in each of
    its four largest branch-free blocks, the bodies of an unrolled loop
    (``row_blocks``, largest first; ``cuobjdump -sass``, beside nvcc), and
    in the same blocks those that issue on the INT32 lanes
    (``alu_blocks``: neither IMAD nor SASS_OFF_ALU nor the uniform
    datapath's); None where the toolkit has no cuobjdump."""
    dump = os.path.join(os.path.dirname(kc._nvcc()), "cuobjdump")
    if not os.path.exists(dump):
        return None
    sass = subprocess.run([dump, "-sass", kc.library_path()],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not re.search(r"\d" + kernel, name):
            continue
        key = kernel_key(name, kernel)
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)|(\.L_x_\d+:)", body)
        blocks, run = [], [0, 0]
        for op, label in ops:
            if label or op in ("BRA", "BSYNC", "BSSY", "EXIT", "RET"):
                blocks.append(run)
                run = [0, 0]
            elif op != "IMAD":
                run[0] += 1
                run[1] += op not in SASS_OFF_ALU and op[0] != "U"
        ops = [op for op, _ in ops if op]
        blocks = sorted(blocks + [run])[:-5:-1]
        out[key] = {"instructions": len(ops),
                    "top": dict(collections.Counter(ops).most_common(10)),
                    "row_blocks": [b[0] for b in blocks],
                    "alu_blocks": [b[1] for b in blocks]}
    return out


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs (after one warm-up
    run unless ``warm`` is false), timed with CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def oracle_time(fn):
    """Adds the seconds of each outermost call of ``fn`` (a method of
    :class:`Smoke` that asks the C++ oracle) to ``Smoke.oracle_s``."""
    def run(self, *args, **kw):
        if self.in_oracle:
            return fn(self, *args, **kw)
        self.in_oracle = True
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kw)
        finally:
            self.in_oracle = False
            self.oracle_s += time.perf_counter() - t0
    return run


class Smoke:
    def __init__(self, seed: int):
        import torch

        from rapidfuzz_tpu_torch import oracle
        from rapidfuzz_tpu_torch.ops import cuda as kc
        from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk
        from rapidfuzz_tpu_torch.ops.cuda import damerau_kernel as dk
        from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel as jk
        from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk
        from rapidfuzz_tpu_torch.ops.cuda import lcs_kernel as ck
        from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk
        from rapidfuzz_tpu_torch.ops.cuda import osa_kernel as ok
        from rapidfuzz_tpu_torch.ops.cuda import pair_kernel as prk
        from rapidfuzz_tpu_torch.ops.cuda import partial_kernel as pk
        from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel as wk
        from rapidfuzz_tpu_torch.utils import codec

        self.torch, self.kc, self.lk, self.bk = torch, kc, lk, bk
        self.ck, self.cbk, self.ok, self.wk, self.jk = ck, cbk, ok, wk, jk
        self.dk, self.pk, self.prk = dk, pk, prk
        self.oracle, self.codec = oracle, codec
        self.seed = seed
        self.dev = torch.device("cuda")
        self.err = {name: 0 for name in kc.LAUNCHES}
        self.cases = {name: 0 for name in kc.LAUNCHES}
        #: the main paths' launches and their candidates by query words:
        #: name -> {W: [launches, candidates]}
        self.words = collections.defaultdict(
            lambda: collections.defaultdict(lambda: [0, 0]))
        #: seconds spent in the oracle, in all and at the last phase's end
        self.oracle_s, self.oracle_mark, self.in_oracle = 0.0, 0.0, False

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def count_words(self, on: bool) -> None:
        """Count K1's, K4's, K5's, K6's and K8's launches and their
        candidates also by query words (``self.words``; K5's by query
        words and band words, "W/bw") while ``on``: the launch function
        their wrappers call (``lev_kernel.tile_launches``'s,
        ``jaro_kernel``'s and ``lcs_band_kernel``'s) is wrapped, and
        restored when ``on`` is false."""
        lk, jk, cbk = self.lk, self.jk, self.cbk
        inner = getattr(lk.launch, "inner", lk.launch)
        if not on:
            lk.launch = jk.launch = cbk.launch = inner
            return

        def launch(name, entry, dev, *args):
            inner(name, entry, dev, *args)
            if entry in WORDS_ARG:
                w, nb = WORDS_ARG[entry]
                tally = self.words[name][args[w]]
            elif entry == "rf_lcs_band":     # K5: query words / band words
                nb = 7
                tally = self.words[name][f"{-(-args[2] // 32)}/{args[3]}"]
            else:
                return
            tally[0] += 1
            tally[1] += args[nb]

        launch.inner = inner
        lk.launch = jk.launch = cbk.launch = launch

    def emit_phase(self, obj) -> None:
        """A phase's JSON line, with the seconds its oracle checks took."""
        emit({**obj, "oracle_s": self.oracle_s - self.oracle_mark})
        self.oracle_mark = self.oracle_s

    def gen(self, salt: int):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(self.seed * 1000 + salt)
        return g

    def compare(self, name: str, got, ref, what: str) -> None:
        torch = self.torch
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.err[name] = max(self.err[name], err)
        self.cases[name] += 1
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"{name} {what}: kernel != plain "
                                 f"(max abs err {err})")

    def compare_band(self, name: str, got, full, kband: int,
                     what: str) -> None:
        """A band of radius ``kband`` against the plain full distances:
        equal where they are within the radius, above it elsewhere, and
        some candidate within it."""
        torch = self.torch
        within = full <= kband
        err = int((got[within].to(torch.int64)
                   - full[within].to(torch.int64)).abs().max()) \
            if bool(within.any()) else 0
        self.err[name] = max(self.err[name], err)
        self.cases[name] += 1
        if err or not bool((got[~within] > kband).all()):
            raise AssertionError(f"{name} {what}: kernel != plain within "
                                 f"the band or <= {kband} outside it "
                                 f"(max abs err {err})")
        if not bool(within.any()):
            raise AssertionError(f"{name} {what}: no candidate within "
                                 f"{kband}; inputs too far apart")

    # ------------------------------------------------------------ phase 3
    def byte_corpus(self, g, B, lb_max, alphabet):
        torch = self.torch
        lens = torch.randint(0, lb_max + 1, (B,), generator=g,
                             device=self.dev, dtype=torch.int32)
        pick = torch.randint(0, alphabet.numel(), (B, lb_max), generator=g,
                             device=self.dev)
        chars = alphabet[pick].to(torch.int32)
        pos = torch.arange(lb_max, device=self.dev)[None, :]
        chars = torch.where(pos < lens[:, None], chars, -1)
        return self.lk.prepare_corpus(chars, lens)

    def phase_kernels(self):
        torch, lk, bk = self.torch, self.lk, self.bk
        rng = np.random.default_rng(self.seed)
        t_start = time.perf_counter()
        alph = {
            "byte": np.unique(np.r_[0, 200, 255, rng.choice(256, 10)]),
            "local": np.unique(np.r_[0, 127, rng.choice(128, 10)]),
        }
        salt = 0
        # K1, one query: W = 1, 2, 3 and 8 (the largest register form), in
        # both PM modes; its tile form in tile_cases
        for W in (1, 2, 3, 8):
            for mode in ("byte", "local"):
                salt += 1
                a = alph[mode]
                la = 32 * (W - 1) + 1 + int(rng.integers(0, 32))
                q = rng.choice(a, la)
                cand, lb = self.byte_corpus(
                    self.gen(salt), N_KERNEL, LB if W <= 3 else 256,
                    torch.from_numpy(a).to(self.dev))
                got = lk.lev_1v_many(q, cand, lb, mode=mode)
                las, tabs = lk.stage_query(q, mode, self.dev)
                ref = lk.lev_scan_plain(las, tabs[None], cand, lb)[0]
                self.compare("lev_scan", got, ref, f"W={W} {mode}")
        # K1, 16 queries per launch: a W=1 group with an empty query and
        # a W=2 group
        for W in (1, 2):
            salt += 1
            a = alph["local"]
            qs = [rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
                  for _ in range(16)]
            if W == 1:
                qs[3] = np.empty(0, np.int64)
            cand, lb = self.byte_corpus(self.gen(salt), N_KERNEL, LB,
                                        torch.from_numpy(a).to(self.dev))
            got = lk.lev_nq_many(qs, cand, lb, mode="local")
            las, tabs = lk.stage_queries(qs, "local", self.dev)
            ref = lk.lev_scan_plain(las, tabs, cand, lb)
            self.compare("lev_scan_nq", got, ref, f"16 queries W={W}")
        # K2: Cyrillic + CJK corpus against a 127-symbol query vocab; the
        # corpus also holds chars absent from the vocab, chars above its
        # largest entry and PAD
        salt += 1
        pool = np.r_[np.arange(0x410, 0x450), np.arange(0x4E00, 0x4E40)]
        q = rng.permutation(pool[:-1])                  # 127 distinct
        corpus_alph = torch.from_numpy(
            np.r_[pool, 0x9FFF, 0x3000]).to(self.dev)
        g = self.gen(salt)
        lens = torch.randint(0, LB + 1, (N_KERNEL,), generator=g,
                             device=self.dev, dtype=torch.int32)
        chars = corpus_alph[torch.randint(0, corpus_alph.numel(),
                                          (N_KERNEL, LB), generator=g,
                                          device=self.dev)].to(torch.int32)
        chars = torch.where(torch.arange(LB, device=self.dev)[None, :]
                            < lens[:, None], chars, -1)
        chars_t = lk.transpose_corpus(chars)
        vocab, q_local = lk.query_vocab(q)
        vocab_t = torch.from_numpy(vocab).to(self.dev)
        got = lk.remap_pack(chars_t, vocab_t)
        self.compare("remap_pack", got, lk.remap_pack_plain(chars_t, vocab_t),
                     "127-symbol vocab")
        d = lk.lev_1v_many(q_local, got, lens, mode="local")
        las, tabs = lk.stage_query(q_local, "local", self.dev)
        self.compare("lev_scan", d,
                     lk.lev_scan_plain(las, tabs[None], got, lens)[0],
                     "remapped corpus")
        # K3: pinned bands bw = 1, 2, 3 over near-copies of a len-64 query
        for mode in ("byte", "local"):
            salt += 1
            a = alph[mode]
            q = rng.choice(a, 64)
            cand, lb = self.mutants(self.gen(salt), q, a, N_KERNEL, 128)
            las, tabs = lk.stage_query(q, mode, self.dev)
            for cut in (0, 2, 7, 15, 31, 47):
                bw = bk.band_words(cut)
                got = bk.lev_banded_1v_many(q, cand, lb, cutoff=cut,
                                            mode=mode)
                ref = bk.lev_band_plain(
                    64, cut, bw, tabs[: bk.table_words(64, 128)], cand, lb)
                self.compare("lev_band", got, ref,
                             f"{mode} cutoff={cut} bw={bw}")
                if int((got <= cut).sum()) == 0:
                    raise AssertionError(f"band cutoff={cut}: no candidate "
                                         "accepted; inputs too far apart")
        self.sync()
        # the seconds of each family of cases, for the phase's budget
        family_s = {"short": time.perf_counter() - t_start}
        for fam, run in (
                ("tile", lambda s: self.tile_cases("lev", rng, alph, s)),
                ("osa_tile", lambda s: self.tile_cases("osa", rng, alph, s)),
                ("lcs_tile", lambda s: self.tile_cases("lcs", rng, alph, s)),
                ("long", lambda s: self.long_kernel_cases(rng, alph["byte"],
                                                          s)),
                ("band", lambda s: self.band_cases(rng, alph["byte"], s)),
                ("lcs", lambda s: self.lcs_kernel_cases(rng, alph, s)),
                ("lcs_band", lambda s: self.lcs_band_cases(alph, s)),
                ("osa", lambda s: self.osa_kernel_cases(rng, alph, s)),
                ("wlev", lambda s: self.wlev_kernel_cases(rng, alph, s)),
                ("jaro", lambda s: self.jaro_kernel_cases(rng, alph, s)),
                ("dam", lambda s: self.dam_kernel_cases(rng, alph, s)),
                ("partial", lambda s: self.partial_kernel_cases(rng, alph,
                                                                s)),
                ("pair", lambda s: self.pair_kernel_cases(rng, s)),
                ("stride", lambda s: self.stride_case(rng))):
            t0 = time.perf_counter()
            salt = run(salt)
            self.sync()
            family_s[fam] = time.perf_counter() - t0
        self.emit_phase({"phase": "kernels", "candidates": N_KERNEL,
                         "long_candidates": N_KERNEL_LONG,
                         "cases": self.cases, "max_abs_err": self.err,
                         "family_s": family_s,
                         "seconds": time.perf_counter() - t_start})

    def tile_cases(self, kind, rng, alph, salt):
        """A tile form (queries past its register form) against its plain
        version: K1's (``kind`` "lev"), K6's ("osa") or K4's ("lcs"), at
        TILE_WS words (K4: its first tile width, past MAX_REG_W, for 9; 10
        then runs its register form; 129 is one word past a strip), the
        byte and the local PM table, over buckets 64 (N_KERNEL candidates,
        the plain version on all), 1,056 and 8,192 (N_KERNEL_LONG, the
        plain version on those of at most TILE_PLAIN chars, half of them;
        the other half spread to the bucket's end, 8 at it, held against
        the oracle on TILE_ORACLE of the longest in byte mode); 129 words
        at 1,056 once more over two chunks of a smaller edge-buffer budget;
        the 16-query launch at 10 words.  The texts are copies of windows
        of the query with up to 30 % of their chars substituted (K6's also
        with two adjacent swaps a text, and it must beat K1 on some row of
        every bucket), so their alignments cross the query's word, tile and
        strip edges (the module's ``tile_plan``).  The plain version takes
        both tables in one call (its cost is its steps times W, whatever
        the candidates)."""
        torch, lk, kc = self.torch, self.lk, self.kc
        mod, one, nq_many, plain, truth_of = {
            "lev": (lk, lk.lev_1v_many, lk.lev_nq_many, lk.lev_scan_plain,
                    self.oracle_lev),
            "osa": (self.ok, self.ok.osa_1v_many, self.ok.osa_nq_many,
                    self.ok.osa_scan_plain,
                    lambda q, t: self.oracle_ints(self.oracle.osa, q, t)),
            "lcs": (self.ck, self.ck.lcs_1v_many, self.ck.lcs_nq_many,
                    lambda las, tabs, c, lb: self.ck.lcs_scan_plain(tabs, c,
                                                                    lb),
                    lambda q, t: self.oracle_ints(self.oracle.lcs_seq, q,
                                                  t))}[kind]
        rows = getattr(mod, "EDGE_ROWS", lk.EDGE_ROWS)
        widths = [mod.MAX_REG_W + 1 if W == TILE_WS[0] else W
                  for W in TILE_WS]
        a = alph["byte"]
        at = torch.from_numpy(a).to(self.dev)
        for LBk in (LB, 1056, LONG_LB):
            B = N_KERNEL if LBk == LB else N_KERNEL_LONG
            name = f"{kind}_scan" if LBk <= lk.LONG_LB else f"{kind}_scan_long"
            beat = kind != "osa"     # K6 below K1 on some row of the bucket
            for W in widths:
                salt += 1
                g = self.gen(salt)
                la = 32 * (W - 1) + 1 + int(rng.integers(0, 32))
                q = rng.choice(a, la)
                qt = torch.from_numpy(q).to(self.dev)
                lens = torch.randint(0, LBk + 1, (B,), generator=g,
                                     device=self.dev)
                if LBk > LB:
                    lens[: B // 2] = torch.randint(
                        0, TILE_PLAIN + 1, (B // 2,), generator=g,
                        device=self.dev)
                    lens[-8:] = LBk
                pos = torch.arange(LBk, device=self.dev)[None, :]
                s0 = (torch.rand(B, generator=g, device=self.dev)
                      * (la - lens).clamp(min=0)).long()[:, None]
                win = qt[(s0 + pos).clamp(max=la - 1)]
                rate = torch.rand((B, 1), generator=g, device=self.dev) * 0.3
                rnd = at[torch.randint(0, at.numel(), (B, LBk), generator=g,
                                       device=self.dev)]
                sub = (torch.rand((B, LBk), generator=g, device=self.dev)
                       < rate) | (s0 + pos >= la)
                chars = torch.where(sub, rnd, win)
                if kind == "osa":
                    for _ in range(2):
                        p = torch.randint(0, LBk - 1, (B, 1), generator=g,
                                          device=self.dev)
                        c0, c1 = chars.gather(1, p), chars.gather(1, p + 1)
                        chars = chars.scatter(1, p, c1).scatter(1, p + 1, c0)
                chars = torch.where(pos < lens[:, None], chars, -1)
                cand, lb = lk.prepare_corpus(chars.to(torch.int32), lens)
                got = [one(q, cand, lb, mode=m) for m in ("byte", "local")]
                short = (lens <= TILE_PLAIN).nonzero()[:, 0]
                st = [lk.stage_query(q, m, self.dev) for m in ("byte",
                                                               "local")]
                las2 = torch.cat([st[0][0], st[1][0]])
                tabs2 = torch.stack([st[0][1], st[1][1]])
                cs = cand[:, short].contiguous()
                ref = plain(las2, tabs2, cs, lb[short])
                what = f"LB={LBk} W={W} plan={mod.tile_plan(W)}"
                for i, m in enumerate(("byte", "local")):
                    self.compare(name, got[i][short], ref[i], f"{what} {m}")
                if kind == "osa":
                    lev = lk.lev_1v_many(q, cand, lb)
                    beat |= bool((got[0] < lev).any())
                    if not bool((got[0] <= lev).all()):
                        raise AssertionError(f"{name} {what}: OSA above "
                                             "Levenshtein")
                if LBk > LB:
                    far = torch.argsort(lens, descending=True)[:TILE_ORACLE]
                    rws = chars[far].cpu().numpy()
                    nl = lens[far].cpu().numpy()
                    truth = truth_of(q, [r[: k] for r, k in zip(rws, nl)])
                    if not np.array_equal(got[0][far].cpu().numpy(), truth):
                        raise AssertionError(f"{name} {what}: kernel != "
                                             "oracle on the longest texts")
                if LBk == 1056 and W == widths[-1]:
                    # the edge buffer over two chunks of candidates
                    plan = lk.SCRATCH_BYTES
                    lk.SCRATCH_BYTES = 4 * -(-LBk // rows) * (B // 2)
                    before = kc.LAUNCHES[name]
                    try:
                        if lk.edge_chunk(LBk, B, rows=rows) != B // 2:
                            raise AssertionError(
                                f"{kind} edge plan: chunk of "
                                f"{lk.edge_chunk(LBk, B, rows=rows)}")
                        chunked = one(q, cand, lb)
                    finally:
                        lk.SCRATCH_BYTES = plan
                    if kc.LAUNCHES[name] - before != 2:
                        raise AssertionError(f"{kind} edge buffer: wrong "
                                             "number of chunk launches")
                    self.compare(name, chunked[short], ref[0],
                                 f"{what} over chunks of {B // 2}")
                    if not torch.equal(chunked, got[0]):
                        raise AssertionError(f"{name} {what}: chunked "
                                             "launches != one launch")
                if LBk == LB and W == 10:
                    # 16 queries of W = 10 per launch over the same texts
                    qs = [rng.choice(a, int(rng.integers(289, 321)))
                          for _ in range(16)]
                    got = nq_many(qs, cand, lb)
                    ref = plain(*lk.stage_queries(qs, "byte", self.dev),
                                cand, lb)
                    self.compare(f"{kind}_scan_nq", got, ref,
                                 "16 queries W=10")
                del chars, cand, lb, win, rnd, sub
            if not beat:
                raise AssertionError(f"{name} LB={LBk}: OSA should beat "
                                     "Levenshtein on some swapped row")
        return salt

    @oracle_time
    def oracle_ints(self, fn, q, texts) -> np.ndarray:
        """The oracle's ``fn`` of int array ``q`` and each of the int arrays
        ``texts``."""
        return np.array([fn(q, t) for t in texts], np.int64)

    @oracle_time
    def oracle_lev(self, q, texts) -> np.ndarray:
        """Oracle Levenshtein distances of int array ``q`` to each of the
        int arrays ``texts``."""
        return np.array([self.oracle.levenshtein_uniform(q, t)
                         for t in texts], np.int64)

    def long_kernel_cases(self, rng, a, salt):
        """The long routes against their plain versions at
        N_KERNEL_LONG candidates: K1 over 2048-char buckets at W = 2
        (registers) and 10 (tile form) and over 8192 at W = 2; the
        run-time band for cutoffs 1-15 and queries of 8-40 chars over 64-
        and 2048-char buckets; the streamed band at bw 1-3 over 2048-char
        buckets, with queries that keep its PM table in shared memory
        (300 chars) and that read it through the cache (2,000).  The
        plain versions take about 10 us per launch, some 20 launches per
        step and word, so the 8192 bucket's tile form and streamed
        band (seconds each) are held by their plain versions in the
        timing phase and by the oracle in the long phase, not here."""
        torch, lk, bk = self.torch, self.lk, self.bk
        at = torch.from_numpy(a).to(self.dev)
        for LBl, W in ((2048, 2), (2048, 10), (LONG_LB, 2)):
            salt += 1
            q = rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
            cand, lb = self.byte_corpus(self.gen(salt), N_KERNEL_LONG, LBl,
                                        at)
            lb[:8] = LBl                      # the bucket's last rows
            las, tabs = lk.stage_query(q, "byte", self.dev)
            self.compare("lev_scan_long", lk.lev_1v_many(q, cand, lb),
                         lk.lev_scan_plain(las, tabs[None], cand, lb)[0],
                         f"LB={LBl} W={W}")
        for LBl, las_ in ((64, (8, 15)), (2048, (8, 40))):
            for la in las_:
                salt += 1
                q = rng.choice(a, la)
                cand, lb = self.mutants(self.gen(salt), q, a, N_KERNEL_LONG,
                                        LBl)
                lb[:8] = LBl
                _, tabs = lk.stage_query(q, "byte", self.dev)
                cuts = range(1, min(la, 16)) if LBl == 64 else (7, 15)
                for cut in cuts:
                    if cut >= la:
                        continue
                    got = bk.lev_banded_1v_many(q, cand, lb, cutoff=cut)
                    ref = bk.lev_band_plain(
                        la, cut, 1, tabs[: bk.table_words(la, LBl)], cand,
                        lb, semi=cut)
                    self.compare("lev_band_rt", got, ref,
                                 f"LB={LBl} la={la} cutoff={cut}")
        for LBl, la in ((2048, 300), (2048, 2000)):
            salt += 1
            q = rng.choice(a, la)
            cand, lb = self.mutants(self.gen(salt), q, a, N_KERNEL_LONG, LBl)
            _, tabs = lk.stage_query(q, "byte", self.dev)
            ws = bk.table_words(la, LBl)
            for cut in {300: (31,), 2000: (15, 31, 47)}.get(la, (31, 47)):
                bw = bk.band_words(cut)
                got = bk.lev_banded_stream_1v_many(q, cand, lb, cutoff=cut)
                ref = bk.lev_band_plain(la, cut, bw, tabs[:ws], cand, lb)
                self.compare("lev_band_long", got, ref,
                             f"LB={LBl} la={la} cutoff={cut} ws={ws}")
                if int((got <= cut).sum()) == 0:
                    raise AssertionError(f"streamed band cutoff={cut}: no "
                                         "candidate accepted")
        return salt

    def band_cases(self, rng, a, salt):
        """K3's three launch names against ``lev_band_plain`` at buckets
        64, 1,024, 6,000 and 8,192 (N_KERNEL_LONG candidates each), every
        call's route checked by its launch count: ``lev_band`` (the pinned
        band, bw 1-3, up to 1,024), ``lev_band_long`` (the pinned band at
        any bucket) and ``lev_band_rt`` (the run-time band, semi 0-14 at
        bucket 64 and 0, 7, 11 and 15 past it).  The texts copy windows of
        the query with ~5 % of their chars substituted, two of them the
        whole query and 34 the query cut short or run on by 1-17 chars
        (distance d at length la -+ d: within the cutoff only if K3's
        length gate walks them); their lengths are 0, 1, one before, at
        and one past every chunk edge (``band_kernel.CHUNK``: the PM
        ring's chunk plan and its barrier), the bucket's end (6,000 ends
        in a part chunk), the query's +- 40 and near it.  The gate walks
        only texts within the cutoff of the query's length: those of the
        257- and 4,097-char queries end at, one before and one past the
        edges at 256 and 4,096, where their horizontal phases cross them,
        and the 5,990-char query's reach the 6,000 bucket's end.  Queries
        shorter than the bucket (15, 12 and 40 chars) read rows of ws and
        above as zero; the 4,001-char query's horizontal phase (cutoffs 31
        and 47) crosses the edge at 3,840 (BAND_CASES lists the bands)."""
        torch, lk, bk, kc = self.torch, self.lk, self.bk, self.kc
        at = torch.from_numpy(a).to(self.dev)
        B = N_KERNEL_LONG
        for LBk, la, calls in BAND_CASES:
            salt += 1
            g = self.gen(salt)
            q = rng.choice(a, la)
            qt = torch.from_numpy(q).to(self.dev)
            fixed = [0, 1, LBk - 1, LBk, max(la - 40, 0), la + 40, la, la]
            fixed += [la + d for d in range(1, 18)] + [
                max(la - d, 0) for d in range(1, 18)]
            whole = slice(6, len(fixed))      # the query, cut or run on
            fixed += [e + d for e in range(bk.CHUNK, LBk + 1, bk.CHUNK)
                      for d in (-1, 0, 1)]
            cand, lb = self.window_copies(g, qt, at, B, LBk, fixed, whole)
            _, tabs = lk.stage_query(q, "byte", self.dev)
            ws = bk.table_words(la, LBk)
            for name, cut in calls:
                fn = (bk.lev_banded_stream_1v_many if name == "lev_band_long"
                      else bk.lev_banded_1v_many)
                before = dict(kc.LAUNCHES)
                got = fn(q, cand, lb, cutoff=cut)
                if kc.LAUNCHES[name] != before[name] + 1 or sum(
                        kc.LAUNCHES.values()) != sum(before.values()) + 1:
                    raise AssertionError(f"K3 LB={LBk} la={la} cut={cut}: "
                                         f"not routed to {name}")
                bw, semi = ((1, cut) if name == "lev_band_rt"
                            else (bk.band_words(cut),
                                  16 * bk.band_words(cut) - 1))
                ref = bk.lev_band_plain(la, cut, bw, tabs[:ws], cand, lb,
                                        semi)
                self.compare(name, got, ref,
                             f"ring LB={LBk} la={la} cut={cut} bw={bw}")
                if not bool((got <= cut).any()):
                    raise AssertionError(f"K3 LB={LBk} la={la} cut={cut}: "
                                         "no candidate accepted")
        return salt

    def window_copies(self, g, qt, at, B, LBk, fixed, whole):
        """``B`` packed texts of a ``LBk`` bucket that copy windows of the
        query ``qt`` with ~5 % of their chars substituted from ``at``:
        the first lengths ``fixed``, the rest the query's +- 15, the
        slice ``whole`` of them from the query's start (its whole, cut or
        run on with random chars), the others from a random start."""
        torch = self.torch
        la = qt.numel()
        lens = la + torch.randint(-15, 16, (B,), generator=g,
                                  device=self.dev)
        lens[: len(fixed)] = torch.tensor(fixed, device=self.dev)
        lens = lens.clamp(0, LBk)
        pos = torch.arange(LBk, device=self.dev)[None, :]
        s0 = (torch.rand(B, generator=g, device=self.dev)
              * (la - lens).clamp(min=0)).long()[:, None]
        s0[whole] = 0
        chars = qt[(s0 + pos).clamp(max=la - 1)]
        sub = (torch.rand((B, LBk), generator=g, device=self.dev)
               < 0.05) | (s0 + pos >= la)
        sub[whole] = pos >= la
        rnd = at[torch.randint(0, at.numel(), (B, LBk), generator=g,
                               device=self.dev)]
        chars = torch.where(sub, rnd, chars)
        chars = torch.where(pos < lens[:, None], chars, -1)
        return self.lk.prepare_corpus(chars.to(torch.int32),
                                      lens.to(torch.int32))

    def lcs_band_cases(self, alph, salt):
        """K5's two launch names against ``lcs_band_plain`` (LCS_BAND_CASES,
        N_KERNEL_LONG candidates each), every call's route checked by its
        launch count and every candidate's value compared, and against
        K4's full LCS: equal where the indel distance is within the
        cutoff, at most it elsewhere, and below it on some row under a
        one-word band (rows far out of band: the query behind 64 chars of
        its alphabet, the last N_KERNEL_LONG // 256).  The texts copy
        windows of the query (window_copies); their lengths are 0, 1, the
        bucket's end and one before, one before, at and one past each
        call's stop la + 16*bw and every chunk edge (``band_kernel.CHUNK``:
        the PM ring's chunk plan and barrier), the query's +- 1-17 and +-
        40 (the whole query, cut or run on), and near it.  Queries shorter than the bucket read
        rows of ws and above as zero; the 4,001-char query's table (126
        words) is staged chunk by chunk like every other."""
        torch, lk, kc, ck, cbk = self.torch, self.lk, self.kc, self.ck, \
            self.cbk
        B = N_KERNEL_LONG
        # a generator and salts of their own, so that the families after
        # these cases draw the data they drew before them
        rng = np.random.default_rng(self.seed + 19)
        for i, (LBk, la, mode, calls) in enumerate(LCS_BAND_CASES):
            g = self.gen(LCS_BAND_SALT + i)
            a = alph[mode]
            q = rng.choice(a, la)
            qt = torch.from_numpy(q).to(self.dev)
            stops = sorted({la + 16 * cbk.band_words(c) for _, c in calls})
            fixed = [0, 1, LBk - 1, LBk, max(la - 40, 0), la + 40, la, la]
            fixed += [la + d for d in range(1, 18)] + [
                max(la - d, 0) for d in range(1, 18)]
            whole = slice(6, len(fixed))      # the query, cut or run on
            fixed += [e + d for e in stops for d in (-1, 0, 1)]
            fixed += [e + d for e in range(self.bk.CHUNK, LBk + 1,
                                           self.bk.CHUNK)
                      for d in (-1, 0, 1)]
            cand, lb = self.window_copies(g, qt, torch.from_numpy(a).to(
                self.dev), B, LBk, fixed, whole)
            far = np.r_[rng.choice(a, 64), q][:LBk]
            nfar = B // 256
            self.plant_rows(cand, lb, torch.from_numpy(far).to(self.dev),
                            nfar)
            _, tabs = lk.stage_query(q, mode, self.dev)
            ws = cbk.table_words(la, LBk)
            full = ck.lcs_1v_many(q, cand, lb, mode=mode)
            indel = la + lb - 2 * full
            for name, cut in calls:
                fn = (cbk.lcs_banded_stream_1v_many
                      if name == "lcs_band_long" else cbk.lcs_banded_1v_many)
                before = dict(kc.LAUNCHES)
                got = fn(q, cand, lb, cutoff=cut, mode=mode)
                if kc.LAUNCHES[name] != before[name] + 1 or sum(
                        kc.LAUNCHES.values()) != sum(before.values()) + 1:
                    raise AssertionError(f"K5 LB={LBk} la={la} cut={cut}: "
                                         f"not routed to {name}")
                bw = cbk.band_words(cut)
                what = f"ring LB={LBk} la={la} {mode} cut={cut} bw={bw}"
                self.compare(name, got, cbk.lcs_band_plain(
                    bw, tabs[:ws], cand, lb, la), what)
                ok = indel <= cut
                if not (ok.any() and torch.equal(got[ok], full[ok])
                        and bool((got <= full).all())
                        and (cut > 15 or bool((got < full).any()))):
                    raise AssertionError(f"K5 {what}: not exact within the "
                                         "band, or no row within it, or "
                                         "none under the full LCS")
        return salt

    def lcs_kernel_cases(self, rng, alph, salt):
        """K4 and K5 against their plain versions: ``lcs_scan`` at W = 1,
        2, 8 and 17 (the first tile width) and ``lcs_scan_nq`` over
        N_KERNEL candidates at bucket 64, in both PM modes; ``lcs_scan_long``
        at W = 2 and 10 over 2048-char buckets and at W = 2 over 8192;
        ``lcs_band`` at indel cutoffs 3, 15, 31 and 47 (bw 1-3) over near
        copies of a 100-char query with candidates far out of band (bucket
        128, N_KERNEL candidates: 256-thread blocks); the streamed band at
        bw 1 and 2 over a 2048-char bucket (lcs_band_cases holds K5's stop
        and ring).  Every candidate's value is compared, the band's
        underestimates for rows out of band included."""
        torch, lk, ck, cbk = self.torch, self.lk, self.ck, self.cbk
        for W in (1, 2, 8, ck.MAX_REG_W + 1):
            for mode in ("byte", "local"):
                salt += 1
                a = alph[mode]
                q = rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
                cand, lb = self.byte_corpus(self.gen(salt), N_KERNEL, LB,
                                            torch.from_numpy(a).to(self.dev))
                _, tabs = lk.stage_query(q, mode, self.dev)
                self.compare("lcs_scan", ck.lcs_1v_many(q, cand, lb,
                                                        mode=mode),
                             ck.lcs_scan_plain(tabs[None], cand, lb)[0],
                             f"W={W} {mode}")
        for W in (1, 2):
            salt += 1
            a = alph["byte"]
            qs = [rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
                  for _ in range(16)]
            if W == 1:
                qs[3] = np.empty(0, np.int64)
            cand, lb = self.byte_corpus(self.gen(salt), N_KERNEL, LB,
                                        torch.from_numpy(a).to(self.dev))
            _, tabs = lk.stage_queries(qs, "byte", self.dev)
            self.compare("lcs_scan_nq", ck.lcs_nq_many(qs, cand, lb),
                         ck.lcs_scan_plain(tabs, cand, lb),
                         f"16 queries W={W}")
        at = torch.from_numpy(alph["byte"]).to(self.dev)
        for LBl, W in ((2048, 2), (2048, 10), (LONG_LB, 2)):
            salt += 1
            q = rng.choice(alph["byte"],
                           32 * (W - 1) + 1 + int(rng.integers(0, 32)))
            cand, lb = self.byte_corpus(self.gen(salt), N_KERNEL_LONG, LBl,
                                        at)
            lb[:8] = LBl
            _, tabs = lk.stage_query(q, "byte", self.dev)
            self.compare("lcs_scan_long", ck.lcs_1v_many(q, cand, lb),
                         ck.lcs_scan_plain(tabs[None], cand, lb)[0],
                         f"LB={LBl} W={W}")
        for mode in ("byte", "local"):
            salt += 1
            a = alph[mode]
            q = rng.choice(a, 100)
            cand, lb = self.mutants(self.gen(salt), q, a, N_KERNEL, 128)
            # rows holding the query 64 chars off the diagonal: past any
            # band, which undercounts their LCS
            far = np.r_[rng.choice(a, 64), q][:128]
            self.plant_rows(cand, lb, torch.from_numpy(far).to(self.dev),
                            N_KERNEL // 16)
            _, tabs = lk.stage_query(q, mode, self.dev)
            full = ck.lcs_1v_many(q, cand, lb, mode=mode)
            indel = q.size + lb - 2 * full
            for cut in (3, 15, 31, 47):
                bw = cbk.band_words(cut)
                got = cbk.lcs_banded_1v_many(q, cand, lb, cutoff=cut,
                                             mode=mode)
                self.compare("lcs_band", got, cbk.lcs_band_plain(
                    bw, tabs[: cbk.table_words(100, 128)], cand, lb),
                             f"{mode} cutoff={cut} bw={bw}")
                ok = indel <= cut
                if not (ok.any() and (~ok).any()
                        and torch.equal(got[ok], full[ok])
                        and bool((got < full).any())):
                    raise AssertionError(f"lcs band cutoff={cut}: needs "
                                         "rows in and out of band, exact "
                                         "within it")
        for LBl, la, cuts in ((2048, 300, (15, 31)),):
            salt += 1
            q = rng.choice(alph["byte"], la)
            cand, lb = self.mutants(self.gen(salt), q, alph["byte"],
                                    N_KERNEL_LONG, LBl)
            self.plant_rows(cand, lb, torch.from_numpy(q[:-5]).to(self.dev),
                            4)
            _, tabs = lk.stage_query(q, "byte", self.dev)
            ws = cbk.table_words(la, LBl)
            for cut in cuts:
                got = cbk.lcs_banded_stream_1v_many(q, cand, lb, cutoff=cut)
                self.compare("lcs_band_long", got, cbk.lcs_band_plain(
                    cbk.band_words(cut), tabs[:ws], cand, lb),
                             f"LB={LBl} la={la} cutoff={cut} ws={ws}")
                if int((la + lb - 2 * got <= cut).sum()) == 0:
                    raise AssertionError(f"streamed lcs band cutoff={cut}: "
                                         "no candidate accepted")
        return salt

    def osa_kernel_cases(self, rng, alph, salt):
        """K6 against its plain version over near copies of the query
        with adjacent swaps planted across query bits 31/32 and across
        packed 4-char rows (text chars 3/4 and 7/8): ``osa_scan`` at W =
        1, 2, 4 and 9 (the first tile width) over N_KERNEL candidates,
        in both PM modes; ``osa_scan_nq`` for a one-word group holding an
        empty query and a two-word group; ``osa_scan_long`` at W = 2 over
        2048- and 8192-char buckets and at W = 9 over 2048, at
        N_KERNEL_LONG candidates.  In every case K6 must also beat K1 on
        some row, so the transposition term fired."""
        torch, lk, ok = self.torch, self.lk, self.ok

        def case(name, q, mode, cand, lb, what):
            las, tabs = lk.stage_query(q, mode, self.dev)
            got = ok.osa_1v_many(q, cand, lb, mode=mode)
            self.compare(name, got, ok.osa_scan_plain(las, tabs[None], cand,
                                                      lb)[0], what)
            lev = lk.lev_1v_many(q, cand, lb, mode=mode)
            if not (bool((got < lev).any()) and bool((got <= lev).all())):
                raise AssertionError(f"{name} {what}: OSA should beat "
                                     "Levenshtein on the swapped rows")

        for W in (1, 2, 4, ok.MAX_REG_W + 1):
            for mode in ("byte", "local"):
                salt += 1
                a = alph[mode]
                q = rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
                cand, lb = self.mutants(self.gen(salt), q, a, N_KERNEL,
                                        LB if W <= 2 else 320, swaps=True)
                case("osa_scan", q, mode, cand, lb, f"W={W} {mode}")
        for W in (1, 2):
            salt += 1
            a = alph["byte"]
            q0 = rng.choice(a, 32 * W)
            qs = [q0] + [rng.choice(a, 32 * (W - 1) + 1
                                    + int(rng.integers(0, 32)))
                         for _ in range(15)]
            if W == 1:
                qs[3] = np.empty(0, np.int64)
            cand, lb = self.mutants(self.gen(salt), q0, a, N_KERNEL, LB,
                                    swaps=True)
            las, tabs = lk.stage_queries(qs, "byte", self.dev)
            self.compare("osa_scan_nq", ok.osa_nq_many(qs, cand, lb),
                         ok.osa_scan_plain(las, tabs, cand, lb),
                         f"16 queries W={W}")
        for LBl, W in ((2048, 2), (2048, ok.MAX_REG_W + 1), (LONG_LB, 2)):
            salt += 1
            a = alph["byte"]
            q = rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
            cand, lb = self.mutants(self.gen(salt), q, a, N_KERNEL_LONG, LBl,
                                    swaps=True)
            lb[:8] = LBl                      # the bucket's last rows
            case("osa_scan_long", q, "byte", cand, lb, f"LB={LBl} W={W}")
        return salt

    def wlev_kernel_cases(self, rng, alph, salt):
        """K7 against its plain version over near copies of the query,
        under each of WLEV_TABLES: ``wlev_scan`` in its register form at
        one, two and three or four words (1-32, 33-64 and 65-128 chars),
        its tile form (a lane a tile of 32 query positions) at 129-160
        chars (five lanes a candidate) and at 280-320 (nine or ten), and
        for the empty query, over N_KERNEL candidates (the 300-char
        query over a quarter of them), in byte and local mode, with
        adjacent swaps planted across tiles and packed rows;
        ``wlev_scan_long`` at two words over 2048- and 8192-char buckets,
        in tile form at 993-1,024 chars (a warp's full strip), at
        1,025-1,100 (one strip and a part, also launched over chunks of
        an edge-buffer budget a quarter of the candidates', at its own
        candidate offsets), at N_KERNEL_LONG candidates, and at
        2,080-2,120 chars (three strips) over N_KERNEL_LONG // 4 texts of
        the 2,048-char bucket and 64 of the 8,192-char one, their last
        rows the buckets' longest."""
        torch, lk, wk, kc = self.torch, self.lk, self.wk, self.kc
        if (wk.MAX_REG_LA, wk.TILE, wk.STRIP) != (128, 32, 1024):
            raise AssertionError("K7's forms moved: update these cases")
        # swaps across packed rows, tiles and strips
        edges = (31, 3, 63, 1023, 2047)

        def case(name, q, mode, cand, lb, w, what):
            _, tabs = lk.stage_query(q, mode, self.dev)
            got = wk.wlev_1v_many(q, cand, lb, ins=w[0], dele=w[1],
                                  sub_cost=w[2], mode=mode)
            self.compare(name, got, wk.wlev_scan_plain(q.size, tabs, cand,
                                                       lb, *w), what)

        for lo, hi, lbm, B in ((1, 32, LB, N_KERNEL), (33, 64, LB, N_KERNEL),
                               (65, 128, 192, N_KERNEL),
                               (129, 160, 192, N_KERNEL),
                               (280, 320, 352, N_KERNEL // 4),
                               (0, 0, LB, N_KERNEL)):
            la = int(rng.integers(lo, hi + 1))
            for w in WLEV_TABLES:
                modes = ("byte", "local") if w == WLEV_TABLES[0] else \
                    ("byte",)
                for mode in modes:
                    salt += 1
                    a = alph[mode]
                    q = rng.choice(a, la)
                    cand, lb = self.mutants(self.gen(salt), q, a, B, lbm,
                                            swaps=la > 0, at=edges[:3])
                    case("wlev_scan", q, mode, cand, lb, w,
                         f"la={la} {w} {mode}")
        for k, (LBl, lo, hi, B) in enumerate((
                (2048, 33, 64, N_KERNEL_LONG),
                (1056, 993, 1024, N_KERNEL_LONG),
                (1152, 1025, 1100, N_KERNEL_LONG),
                (LONG_LB, 33, 64, N_KERNEL_LONG),
                (2048, 2080, 2120, N_KERNEL_LONG // 4),
                (LONG_LB, 2080, 2120, 64))):
            salt += 1
            a = alph["byte"]
            q = rng.choice(a, int(rng.integers(lo, hi + 1)))
            cand, lb = self.mutants(self.gen(salt), q, a, B, LBl,
                                    swaps=True, at=edges)
            lb[:8] = LBl                      # the bucket's last rows
            w = WLEV_TABLES[k % len(WLEV_TABLES)]
            case("wlev_scan_long", q, "byte", cand, lb, w,
                 f"LB={LBl} la={q.size} {w}")
            if lo == 1025:
                # the edge buffer over chunks of a quarter of the candidates
                chunk = B // 4
                before = kc.LAUNCHES["wlev_scan_long"]
                plan = wk.SCRATCH_BYTES
                wk.SCRATCH_BYTES = 4 * LBl * chunk
                try:
                    if wk.edge_chunk(LBl, B) != chunk:
                        raise AssertionError("K7 edge plan: chunk of "
                                             f"{wk.edge_chunk(LBl, B)}")
                    case("wlev_scan_long", q, "byte", cand, lb, w,
                         f"la={q.size} {w} over chunks of {chunk}")
                finally:
                    wk.SCRATCH_BYTES = plan
                if kc.LAUNCHES["wlev_scan_long"] - before != 4:
                    raise AssertionError("K7 edge buffer: wrong number of "
                                         "chunk launches")
        return salt

    def jaro_kernel_cases(self, rng, alph, salt):
        """K8 against its plain version, (common, transpositions) bit for
        bit, over near copies of the query with adjacent swaps planted
        (across query bits 31/32 and packed 4-char rows; unedited copies
        end pass 1 by their claims, edited ones at len2), joined by the
        query cut short (a prefix over the whole text), the query run on
        (a prefix over the whole query), a text of chars in no row of the
        query's table (every cursor list empty) and an empty text; each
        query holds a char outside its table's domain (the scanner's
        never-matching sentinel: 300 in byte mode, 200 in local mode).
        ``jaro_scan`` in register form at W = 1, 2 and 5 (its stored-char
        pass 2, up to its widest) and in cursor form at W = 8 and 17,
        over N_KERNEL candidates in byte and local mode; ``jaro_scan_nq`` for a one-word
        group holding an empty query, a two-word group and a ten-word
        group (the cursor form); ``jaro_scan_long`` in register form at
        W = 2 over 2048- and HUGE_LB-char buckets (past the TPU's cap) and
        in cursor form at W = 9, 17 (2048), 10 and 126 (8192) and 625
        (HUGE_LB: ~20,000 chars, its tables past a quarter of the shared
        memory, read through L1), at N_KERNEL_LONG candidates (N_HUGE, 32
        at W = 625, at HUGE_LB).  Every case must
        count some transposition."""
        torch, lk, jk = self.torch, self.lk, self.jk

        def query(a, mode, W):
            q = rng.choice(a, 32 * (W - 1) + 1 + int(rng.integers(0, 32)))
            q[int(rng.integers(0, q.size))] = 300 if mode == "byte" else 200
            return q

        def texts(q, a, mode, B, lbm):
            """B near copies of ``q`` and the four texts above, packed."""
            cand, lb = self.mutants(self.gen(salt), q, a, B, lbm, swaps=True)
            dom = 256 if mode == "byte" else 128
            absent = np.setdiff1d(np.arange(dom), a)
            n = min(q.size, lbm)
            rows = [q[: max(1, n - 5)],
                    np.r_[q, rng.choice(a, lbm)][:lbm],
                    rng.choice(absent, min(lbm, 2 * q.size)), q[:0]]
            chars = np.full((len(rows), lbm), -1, np.int32)
            for i, t in enumerate(rows):
                chars[i, : t.size] = np.where(t < dom, t, 7)
            extra = lk.prepare_corpus(
                torch.from_numpy(chars).to(self.dev),
                torch.tensor([t.size for t in rows], dtype=torch.int32))
            return (torch.cat([cand, extra[0]], 1).contiguous(),
                    torch.cat([lb, extra[1]]).contiguous())

        def case(name, q, mode, cand, lb, what):
            las, tabs = lk.stage_query(q, mode, self.dev)
            got = torch.stack(jk.jaro_1v_many(q, cand, lb, mode=mode))
            self.compare(name, got[:, None],
                         jk.jaro_scan_plain(las, tabs[None], cand, lb), what)
            if not bool((got[1] > 0).any()):
                raise AssertionError(f"{name} {what}: no transposition")

        for W in (1, 2, 5, 8, 17):
            lbm = LB if W <= 2 else 64 * ((40 * W + 63) // 64)
            for mode in ("byte", "local"):
                salt += 1
                a = alph[mode]
                q = query(a, mode, W)
                cand, lb = texts(q, a, mode, N_KERNEL, lbm)
                case("jaro_scan", q, mode, cand, lb, f"W={W} {mode}")
        for W in (1, 2, 10):
            salt += 1
            a = alph["byte"]
            q0 = rng.choice(a, 32 * W)
            qs = [q0] + [rng.choice(a, 32 * (W - 1) + 1
                                    + int(rng.integers(0, 32)))
                         for _ in range(15)]
            if W == 1:
                qs[3] = np.empty(0, np.int64)
            cand, lb = texts(q0, a, "byte",
                             N_KERNEL if W <= 2 else N_KERNEL_LONG,
                             LB if W <= 2 else 512)
            las, tabs = lk.stage_queries(qs, "byte", self.dev)
            self.compare("jaro_scan_nq", torch.stack(jk.jaro_nq_many(
                qs, cand, lb)), jk.jaro_scan_plain(las, tabs, cand, lb),
                         f"16 queries W={W}")
        for LBl, W, B, mode in ((2048, 2, N_KERNEL_LONG, "byte"),
                                (2048, 9, N_KERNEL_LONG, "local"),
                                (2048, 17, N_KERNEL_LONG, "byte"),
                                (LONG_LB, 10, N_KERNEL_LONG, "byte"),
                                (LONG_LB, 126, N_KERNEL_LONG, "local"),
                                (HUGE_LB, 2, N_HUGE, "byte"),
                                (HUGE_LB, 625, 32, "byte")):
            salt += 1
            a = alph[mode]
            q = query(a, mode, W)
            cand, lb = texts(q, a, mode, B, LBl)
            lb[:8] = LBl                      # the bucket's last rows
            case("jaro_scan_long", q, mode, cand, lb,
                 f"LB={LBl} W={W} {mode}")
        return salt

    def dam_kernel_cases(self, rng, alph, salt):
        """K9 against its plain versions over near copies of the query with
        adjacent swaps planted (across query tiles, strips and packed
        4-char rows): the full form bit for bit, the band of radius 3, 7
        or 15 equal to the plain full distances within the radius and
        above it elsewhere.  ``dam_scan`` over N_KERNEL candidates of
        buckets 32, 64 and 128 (queries of 0, 1 and 31 chars, one lane a
        candidate; 33 and 64, two lanes; 100, four lanes, the last tile
        partly past the query; byte and local mode; 300 chars, ten lanes,
        longer than every text, over N_KERNEL // 4);
        ``dam_scan_long`` and ``dam_band_long`` over N_KERNEL_LONG
        candidates of buckets 160, 1,024, 1,056 and 8,192 (33-1,025 chars:
        1,024 fills a warp's strip, 1,025 takes a second strip), a
        2,100-char query over N_KERNEL_LONG // 4 texts of about its length
        (three strips, the PM table past shared memory), a 4,001-char query
        over 64 texts of about its length at bucket 8,192, the 1,025-char
        one once more over chunks of an edge-buffer budget a quarter of
        the candidates', and a 33-char query over N_HUGE candidates of
        HUGE_LB chars (past the JAX package's 8,192-char cap)."""
        torch, lk, dk, kc = self.torch, self.lk, self.dk, self.kc
        if dk.TILE != 32 or dk.STRIP != 1024:
            raise AssertionError("K9's tiles moved: update these cases")
        # swaps across packed rows, tiles and strips
        edges = (31, 3, 7, 63, 1023, 2047)

        def case(name, q, mode, cand, lb, what, bands=()):
            _, tabs = lk.stage_query(q, mode, self.dev)
            got = dk.dam_1v_many(q, cand, lb, mode=mode)
            full = dk.dam_scan_plain(q.size, tabs, cand, lb)
            self.compare(name, got, full, what)
            band = name.replace("scan", "band")
            for kb in bands:
                self.compare_band(band, dk.dam_band_1v_many(
                    q, cand, lb, kband=kb, mode=mode), full, kb,
                    f"{what} radius {kb}")

        for LBs, la, mode, B, bands in (
                (32, 0, "byte", N_KERNEL, ()),
                (32, 1, "byte", N_KERNEL, (3,)),
                (32, 31, "byte", N_KERNEL, (3, 7, 15)),
                (32, 31, "local", N_KERNEL, (7,)),
                (64, 33, "byte", N_KERNEL, (3, 15)),
                (64, 64, "local", N_KERNEL, (7, 15)),
                (128, 64, "byte", N_KERNEL, (15,)),
                (128, 100, "byte", N_KERNEL, (7,)),
                (128, 300, "byte", N_KERNEL // 4, ())):
            salt += 1
            a = alph[mode]
            q = rng.choice(a, la)
            cand, lb = self.mutants(self.gen(salt), q, a, B, LBs, swaps=True,
                                    at=edges[:4])
            case("dam_scan", q, mode, cand, lb, f"LB={LBs} la={la} {mode}",
                 bands)
        a = alph["byte"]
        for LBl, la, B, bands in ((160, 33, N_KERNEL_LONG, (3, 7)),
                                  (160, 160, N_KERNEL_LONG, (15,)),
                                  (1024, 300, N_KERNEL_LONG, (15,)),
                                  (1056, 1024, N_KERNEL_LONG, (15,)),
                                  (1056, 1025, N_KERNEL_LONG, (7,)),
                                  (2144, 2100, N_KERNEL_LONG // 4, ()),
                                  (LONG_LB, 64, N_KERNEL_LONG, ()),
                                  (8192, 4001, 64, (15,)),
                                  (HUGE_LB, 33, N_HUGE, ())):
            salt += 1
            q = rng.choice(a, la)
            cand, lb = self.mutants(self.gen(salt), q, a, B, LBl, swaps=True,
                                    at=edges)
            if la < 4001:
                lb[:8] = LBl                  # the bucket's last rows
            if bands:
                # the query with swaps across a packed row, a tile and a
                # strip: within every band, however few random copies are
                row = q.copy()
                for p in (3, 31, 1023):
                    if p + 1 < la:
                        row[[p, p + 1]] = row[[p + 1, p]]
                self.plant_rows(cand, lb, torch.from_numpy(row).to(self.dev),
                                4)
            case("dam_scan_long", q, "byte", cand, lb, f"LB={LBl} la={la}",
                 bands)
            if la == 1025:
                # the edge buffer over chunks of a quarter of the candidates
                chunk = B // 4
                before = kc.LAUNCHES["dam_scan_long"]
                plan = dk.SCRATCH_BYTES
                dk.SCRATCH_BYTES = dk.EDGE_INTS * 4 * LBl * chunk
                try:
                    if dk.edge_chunk(LBl, B) != chunk:
                        raise AssertionError("K9 edge plan: chunk of "
                                             f"{dk.edge_chunk(LBl, B)}")
                    case("dam_scan_long", q, "byte", cand, lb,
                         f"la={la} over chunks of {chunk}")
                finally:
                    dk.SCRATCH_BYTES = plan
                if kc.LAUNCHES["dam_scan_long"] - before != 4:
                    raise AssertionError("K9 edge buffer: wrong number of "
                                         "chunk launches")
        return salt

    def partial_corpus(self, g, q, alphabet, B, lb_max):
        """Packed candidates of 0..lb_max chars for K10's cases, in four
        kinds by row: the query at a random offset inside a longer row
        (an exact window, n >= m), a piece of the query of fewer than m
        chars as the whole row (an exact window in the swapped role), a
        random row of exactly m chars, a random row; row 0 empty."""
        torch, dev = self.torch, self.dev
        m = q.size
        a = torch.from_numpy(alphabet).to(dev)
        qt = torch.from_numpy(q).to(dev)
        chars = a[torch.randint(0, a.numel(), (B, lb_max), generator=g,
                                device=dev)]
        lens = torch.randint(0, lb_max + 1, (B,), generator=g, device=dev)
        kind = torch.arange(B, device=dev) % 4
        pos = torch.arange(lb_max, device=dev)[None, :]
        if m <= lb_max:
            off = torch.randint(0, lb_max - m + 1, (B,), generator=g,
                                device=dev)
            at = (kind == 0)[:, None] & (pos >= off[:, None]) \
                & (pos < off[:, None] + m)
            chars = torch.where(at, qt[(pos - off[:, None]).clamp(0, m - 1)],
                                chars)
            lens = torch.where(kind == 0, torch.maximum(lens, off + m), lens)
            lens = torch.where(kind == 2, m, lens)
        if m > 1:
            k = torch.randint(1, min(m - 1, lb_max) + 1, (B,), generator=g,
                              device=dev)
            st = (torch.rand(B, generator=g, device=dev)
                  * (m - k + 1)).long().clamp(max=m - 1)
            piece = qt[(st[:, None] + pos).clamp(max=m - 1)]
            chars = torch.where((kind == 1)[:, None], piece, chars)
            lens = torch.where(kind == 1, k, lens)
        lens[0] = 0
        chars = torch.where(pos < lens[:, None], chars, -1).to(torch.int32)
        return self.lk.prepare_corpus(chars, lens.to(torch.int32))

    def partial_kernel_cases(self, rng, alph, salt):
        """K10 against its plain version, (num, den, start, end) bit for
        bit, over :meth:`partial_corpus` rows (every role with rows must
        hold an exact window, score 1.0): queries of 1, 7, 32, 33, 64, 65
        and 300 chars and PARTIAL_WIDE (past the register form) over
        N_KERNEL candidates of bucket 64 (N_KERNEL // 16 from 300 chars),
        byte and local mode; 33, 300 and PARTIAL_WIDE chars over
        N_KERNEL_LONG candidates of bucket 1,024 (PARTIAL_WIDE over a
        quarter of them) and 64 chars over bucket 8,192; the scratch form
        once more over chunks of a scratch budget a quarter of the
        candidates'."""
        torch, lk, pk, kc = self.torch, self.lk, self.pk, self.kc

        def case(q, mode, cand, lb, what):
            _, tabs = lk.stage_query(q, mode, self.dev)
            got = torch.stack(pk.partial_ratio_1v_many(q, cand, lb,
                                                       mode=mode))
            self.compare("partial_scan", got,
                         pk.partial_scan_plain(q.size, tabs, cand, lb), what)
            n = lb.to(torch.int64)
            exact = got[0] == got[1]
            for role, rows in (("n >= m", n >= q.size),
                               ("n < m", (n > 0) & (n < q.size))):
                if bool(rows.any()) and not bool((exact & rows).any()):
                    raise AssertionError(f"partial_scan {what}: no exact "
                                         f"window where {role}")

        for LBs, la, mode, B in (
                (64, 1, "byte", N_KERNEL), (64, 7, "local", N_KERNEL),
                (64, 32, "byte", N_KERNEL), (64, 33, "local", N_KERNEL),
                (64, 64, "byte", N_KERNEL), (64, 65, "local", N_KERNEL),
                (64, 300, "byte", N_KERNEL // 16),
                (64, PARTIAL_WIDE, "local", N_KERNEL // 16),
                (1024, 33, "byte", N_KERNEL_LONG),
                (1024, 300, "local", N_KERNEL_LONG),
                (1024, PARTIAL_WIDE, "byte", N_KERNEL_LONG // 4),
                (LONG_LB, 64, "byte", N_KERNEL_LONG)):
            salt += 1
            a = alph[mode]
            q = rng.choice(a, la)
            cand, lb = self.partial_corpus(self.gen(salt), q, a, B, LBs)
            what = f"LB={LBs} la={la} {mode}"
            case(q, mode, cand, lb, what)
            if LBs == 64 and la == PARTIAL_WIDE:
                W = lk.words(la)
                budget = 4 * W * (B // 4)
                chunk = max(pk.BLOCK, budget // (4 * W) // pk.BLOCK
                            * pk.BLOCK)
                before = kc.LAUNCHES["partial_scan"]
                plan = pk.SCRATCH_BYTES
                pk.SCRATCH_BYTES = budget
                try:
                    case(q, mode, cand, lb, f"{what} over chunks of {chunk}")
                finally:
                    pk.SCRATCH_BYTES = plan
                if kc.LAUNCHES["partial_scan"] - before != -(-B // chunk):
                    raise AssertionError("K10 scratch: wrong number of "
                                         "chunk launches")
        return salt

    def pair_kernel_cases(self, rng, salt):
        """K11 against its plain version, bit for bit, at every R = 1-8,
        over texts of 3,000-5,000 chars (the plain version's ~30 launches
        a step): a near copy at the band's edge K = max_cutoff(R) at R = 1
        and 6; la - lb > K at R = 2; at R = 3 (a band born of a hint)
        K = la - 1, the band spanning the pattern; identical runs at R = 4
        and 7, whose add generates a carry in every word, so that the
        carry crosses every lane and warp edge; at R = 5 a char at the
        first pattern position of every warp's quarter of the band, which
        the text opens with (the carry runs through all-ones words to a
        warp edge); a wide-vocabulary pair (Cyrillic and CJK) at R = 8's
        edge, K = 16,383, most of its steps in the horizontal phase; and
        the OCR pair's first 6,000 text chars at R = 1 and 2, most of whose
        windows K11 loads with no bounds test."""
        prk, enc = self.prk, self.codec.encode_one
        abc = np.arange(97, 101)
        wide = np.r_[np.arange(0x410, 0x450), np.arange(0x4E00, 0x4E40)]
        near = "".join(rng.choice(list("abcd"), 3000))
        near5 = "".join(rng.choice(list("abcd"), 5000))
        near6 = "".join(rng.choice(list("abcd"), prk.max_cutoff(6) + 200))
        edge5 = rng.choice(abc, prk.max_cutoff(5) + 300)
        edge5[:: 5 * 1024] = 122
        cases = (
            ("near copy", enc(near), enc(self.edit(rng, near, 60)), 1,
             prk.max_cutoff(1)),
            ("la - lb > K", rng.choice(abc, 8000), rng.choice(abc, 3000), 2,
             prk.max_cutoff(2)),
            ("band spans", enc(near5), enc(self.edit(rng, near5, 150)), 3,
             4999),
            ("identical runs", np.full(9000, 97), np.full(3500, 97), 4,
             prk.max_cutoff(4)),
            ("warp edges", edge5, np.r_[122, edge5[1: 3500]], 5,
             prk.max_cutoff(5)),
            ("near copy", enc(near6), enc(self.edit(rng, near6[:4000], 40)),
             6, prk.max_cutoff(6)),
            ("identical runs", np.full(15000, 98), np.full(3000, 98), 7,
             prk.max_cutoff(7)),
            ("wide vocab", rng.choice(wide, 17000), rng.choice(wide, 4000),
             8, prk.max_cutoff(8)))
        for what, a, b, R, K in cases:
            la, text, table = prk.stage_pair(a, b, self.dev)
            got = prk._pair(table, text, la, K, R)
            self.compare("lev_pair", got,
                         prk.lev_pair_plain(table, text, la, K, R),
                         f"{what} R={R} K={K}")
        # the OCR pair's first 6,000 text chars at R = 1 and 2: from step
        # B - K - 1 on every window lies in the table, where K11 loads it
        # with no bounds test
        fix = np.load(OCR)
        la, text, table = prk.stage_pair(fix["ex1"], fix["ex2"], self.dev)
        head = text[:6000].contiguous()
        for R in (1, 2):
            K = prk.max_cutoff(R)
            self.compare("lev_pair", prk._pair(table, head, la, K, R),
                         prk.lev_pair_plain(table, head, la, K, R),
                         f"OCR head R={R} K={K}")
        return salt

    def stride_case(self, rng):
        """K2 over a bucket of STRIDE_LB chars (75,000 packed rows: its
        blocks stride past the 65,535 rows grid.y can hold) of N_STRIDE
        Cyrillic candidates, about 300 MiB unpacked: bit for bit against
        its plain version, and the Levenshtein scan of the remapped corpus
        against the C++ oracle on a sampled row that runs to the end of
        the bucket."""
        torch, lk = self.torch, self.lk
        g = self.gen(4242)
        pool = np.arange(0x430, 0x450)
        chars_t = torch.from_numpy(pool).to(self.dev, torch.int32)[
            torch.randint(0, pool.size, (STRIDE_LB, N_STRIDE), generator=g,
                          device=self.dev)]
        lens = torch.randint(STRIDE_LB // 2, STRIDE_LB + 1, (N_STRIDE,),
                             generator=g, device=self.dev, dtype=torch.int32)
        row = int(rng.integers(0, N_STRIDE))
        lens[row] = STRIDE_LB
        chars_t = torch.where(torch.arange(STRIDE_LB, device=self.dev)[:, None]
                              < lens[None, :], chars_t, -1)
        q = rng.choice(pool[:20], 40)
        vocab, q_local = lk.query_vocab(q)
        vocab_t = torch.from_numpy(vocab).to(self.dev)
        got = lk.remap_pack(chars_t, vocab_t)
        self.compare("remap_pack", got, lk.remap_pack_plain(chars_t, vocab_t),
                     f"bucket {STRIDE_LB}, {STRIDE_LB // 4} rows")
        d = lk.lev_1v_many(q_local, got, lens, mode="local")
        text = chars_t[:, row].cpu().numpy()
        truth = self.oracle.levenshtein_uniform_bp(q, text.astype(np.int64))
        if int(d[row]) != truth:
            raise AssertionError(f"K2 stride case: row {row} distance "
                                 f"{int(d[row])} != oracle {truth}")
        del chars_t, got

    def plant_rows(self, cand, lb, row, n):
        """Overwrite the last ``n`` candidates of a packed corpus with the
        text ``row``."""
        torch = self.torch
        chars = torch.full((1, cand.shape[0] * 4), -1, dtype=torch.int32,
                           device=self.dev)
        chars[0, : row.numel()] = row.to(torch.int32)
        packed, _ = self.lk.prepare_corpus(
            chars, torch.tensor([row.numel()], device=self.dev))
        cand[:, -n:] = packed
        lb[-n:] = row.numel()

    def mutants(self, g, q, alphabet, B, lb_max, swaps: bool = False,
                at=(31, 3, 7)):
        """Packed near-copies of ``q``: random substitutions and length
        changes, so distances spread across the band cutoffs; with
        ``swaps``, one adjacent swap per row, at text chars ``at[k]`` /
        ``at[k] + 1`` (31/32: across query words; 3/4 or 7/8: across
        packed rows), in turn, or at random every ``len(at) + 1``-th
        row."""
        torch = self.torch
        a = torch.from_numpy(alphabet).to(self.dev)
        base = torch.full((lb_max,), int(alphabet[0]), device=self.dev,
                          dtype=torch.int64)
        base[: q.size] = torch.from_numpy(q[:lb_max]).to(self.dev)
        rnd = a[torch.randint(0, a.numel(), (B, lb_max), generator=g,
                              device=self.dev)]
        rate = torch.randint(0, 40, (B, 1), generator=g,
                             device=self.dev) / 100.0
        sub = torch.rand((B, lb_max), generator=g, device=self.dev) < rate
        chars = torch.where(sub, rnd, base[None, :])
        chars[:, q.size:] = rnd[:, q.size:]
        if swaps:
            p = torch.randint(0, lb_max - 1, (B,), generator=g,
                              device=self.dev)
            fixed = torch.tensor(at, device=self.dev).clamp(max=lb_max - 2)
            r = torch.arange(B, device=self.dev) % (len(at) + 1)
            p = torch.where(r < len(at), fixed[r.clamp(max=len(at) - 1)],
                            p)[:, None]
            a, b = chars.gather(1, p), chars.gather(1, p + 1)
            chars = chars.scatter(1, p, b).scatter(1, p + 1, a)
        lens = (q.size + torch.randint(-30, 31, (B,), generator=g,
                                       device=self.dev)).clamp(0, lb_max)
        lens = lens.to(torch.int32)
        pos = torch.arange(lb_max, device=self.dev)[None, :]
        chars = torch.where(pos < lens[:, None], chars, -1).to(torch.int32)
        return self.lk.prepare_corpus(chars, lens)

    # ------------------------------------------------------------ helpers
    @oracle_time
    def oracle_rows(self, query: str, strings,
                    metric="levenshtein") -> np.ndarray:
        """Oracle distances of ``query`` to ``strings`` under ``metric``
        (lcs_seq from indel: ``lcs = (la + lb - indel) / 2``; OSA and
        Damerau-Levenshtein one scalar call per string; a weight tuple
        ``(ins, del, sub)`` is
        weighted Levenshtein with the query as the pattern, one scalar
        call per string; "jaro" and "jaro_winkler" (at JARO_PW) are f64
        distances ``1.0 - similarity``, from :meth:`jaro_rows`, and
        "partial_ratio" ``1.0 - score``, from :meth:`partial_rows`)."""
        if metric in ("jaro", "jaro_winkler"):
            return self.jaro_rows(query, strings,
                                  None if metric == "jaro" else JARO_PW)
        if metric == PR:
            return self.partial_rows(query, strings)
        enc = [self.codec.encode_one(s) for s in strings]
        if metric in ("osa", DAM) or isinstance(metric, tuple):
            eq = self.codec.encode_one(query)
            one = ({"osa": self.oracle.osa, DAM: self.oracle.damerau}[metric]
                   if metric in ("osa", DAM) else
                   lambda a, b: self.oracle.levenshtein_weighted(a, b,
                                                                 *metric))
            # eight slices in parallel (ctypes drops the GIL)
            parts = np.array_split(np.arange(len(enc)), 8)
            with ThreadPoolExecutor(8) as ex:
                done = list(ex.map(lambda ix: [one(eq, enc[i]) for i in ix],
                                   parts))
            return np.array([d for part in done for d in part], np.int64)
        lens = np.fromiter((e.size for e in enc), np.int64, len(enc))
        offs = np.r_[0, np.cumsum(lens)]
        flat = np.concatenate(enc) if enc else np.empty(0, np.int64)
        eq = self.codec.encode_one(query)
        if metric == "levenshtein":
            return self.oracle.levenshtein_uniform_1vN(eq, flat, offs)
        d = self.oracle.indel_1vN(eq, flat, offs)
        if metric == "indel":
            return d
        return np.maximum(eq.size, lens) - (eq.size + lens - d) // 2

    @oracle_time
    def oracle_full(self, queries, corpus, metric: str):
        """Whole-corpus oracle rows for each query: the corpus's
        codepoints from one utf-32 encode, each row in eight slices of
        the corpus, all run in parallel (ctypes drops the GIL)."""
        lens = np.fromiter(map(len, corpus), np.int64, len(corpus))
        offs = np.r_[0, np.cumsum(lens)]
        flat = np.frombuffer("".join(corpus).encode("utf-32-le"),
                             np.uint32).astype(np.int64)
        one = (self.oracle.levenshtein_uniform_1vN if metric == "levenshtein"
               else self.oracle.indel_1vN)
        cuts = np.linspace(0, len(corpus), 9).astype(np.int64)
        jobs = [(self.codec.encode_one(q), a, b) for q in queries
                for a, b in zip(cuts[:-1], cuts[1:])]
        with ThreadPoolExecutor(8) as ex:
            done = list(ex.map(lambda j: one(
                j[0], flat[offs[j[1]]: offs[j[2]]],
                offs[j[1]: j[2] + 1] - offs[j[1]]), jobs))
        rows = [np.concatenate(done[i: i + 8])
                for i in range(0, len(done), 8)]
        if metric == "lcs_seq":
            rows = [np.maximum(len(q), lens) - (len(q) + lens - d) // 2
                    for q, d in zip(queries, rows)]
        return rows

    @staticmethod
    def expected_topk(d: np.ndarray, k: int):
        ids = np.lexsort((np.arange(d.size), d))[:k]
        return d[ids], ids

    def check_topk_sampled(self, query, corpus, vals, ids, sample, k, what,
                           metric="levenshtein"):
        """The returned (value, index) pairs are true distances, ordered by
        (distance, index), and no sampled row beats the k-th pair."""
        vals, ids = np.asarray(vals), np.asarray(ids)
        if len(ids) != k:
            raise AssertionError(f"{what}: {len(ids)} results, expected {k}")
        truth = self.oracle_rows(query, [corpus[i] for i in ids], metric)
        if not np.array_equal(truth, vals):
            raise AssertionError(f"{what}: values {vals} != oracle {truth}")
        key = list(zip(vals.tolist(), ids.tolist()))
        if key != sorted(key):
            raise AssertionError(f"{what}: not ordered by (distance, index)")
        ds = self.oracle_rows(query, [corpus[i] for i in sample], metric)
        kth = key[-1]
        chosen = set(ids.tolist())
        for dv, i in zip(ds.tolist(), sample.tolist()):
            if i not in chosen and (dv, i) < kth:
                raise AssertionError(f"{what}: row {i} (distance {dv}) "
                                     f"beats the k-th result {kth}")

    # ------------------------------------------------------------ phase 4
    def serve_corpus(self, rng):
        """1,048,576 word-like ASCII strings of 0..64 chars, with mutated
        copies of three len-64 anchors (near duplicates, exact copies and
        ties) spread through it."""
        lens = rng.integers(0, LB + 1, N_SERVE)
        letters = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8)
        letters[rng.random(letters.size) < 0.15] = 32
        big = letters.tobytes().decode("ascii")
        offs = np.r_[0, np.cumsum(lens)]
        corpus = [big[offs[i]:offs[i + 1]] for i in range(N_SERVE)]
        anchors = []
        planted = []
        for _ in range(3):
            a = rng.integers(97, 123, LB, dtype=np.uint8)
            a[rng.random(LB) < 0.15] = 32
            anchors.append(a.tobytes().decode("ascii"))
        for a in anchors:
            for m in range(40):
                s = list(a)
                for _ in range(m % 9):              # 0..8 edits
                    i = int(rng.integers(0, len(s)))
                    op = int(rng.integers(0, 3))
                    if op == 0:
                        s[i] = chr(int(rng.integers(97, 123)))
                    elif op == 1 and len(s) > 1:
                        del s[i]
                    elif len(s) < LB:
                        s.insert(i, chr(int(rng.integers(97, 123))))
                pos = int(rng.integers(0, N_SERVE))
                corpus[pos] = "".join(s)
                planted.append(pos)
        return corpus, anchors, np.unique(planted)

    def phase_serve(self):
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 1)
        t_start = time.perf_counter()
        corpus, anchors, planted = self.serve_corpus(rng)
        t_gen = time.perf_counter() - t_start
        t0 = time.perf_counter()
        service = ScanService(corpus, bucket=LB, device=self.dev)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad:
            raise AssertionError(f"warmup routes failed: {bad}")
        call, stop, timings = self.serve_http(service)
        try:
            h = call("/health")
            if not (h["ok"] and h["n"] == N_SERVE):
                raise AssertionError(f"/health: {h}")
            q_rand = rng.integers(97, 123, LB, dtype=np.uint8)
            queries = anchors + [q_rand.tobytes().decode("ascii")]
            answers = [call("/topk", {"query": q, "k": 10}) for q in queries]
            # whole-corpus oracle for each /topk query (ctypes drops the
            # GIL, so the four scans run in parallel)
            enc = [self.codec.encode_one(s) for s in corpus]
            lens = np.fromiter((e.size for e in enc), np.int64, len(enc))
            offs = np.r_[0, np.cumsum(lens)]
            flat = np.concatenate(enc)
            with ThreadPoolExecutor(4) as ex:
                full = list(ex.map(
                    lambda q: self.oracle.levenshtein_uniform_1vN(
                        self.codec.encode_one(q), flat, offs), queries))
            for q, ans, d in zip(queries, answers, full):
                ev, ei = self.expected_topk(d, 10)
                if ans["indices"] != ei.tolist() or \
                        ans["values"] != ev.tolist():
                    raise AssertionError(
                        f"/topk {q!r}: {ans['values']} {ans['indices']} != "
                        f"oracle {ev.tolist()} {ei.tolist()}")
                if ans["strings"] != [corpus[i] for i in ei]:
                    raise AssertionError("/topk strings mismatch")
            sample = np.unique(np.r_[rng.choice(N_SERVE, N_SAMPLE,
                                                replace=False), planted])
            q0 = anchors[0]
            truth = full[0][sample]
            out = call("/distances", {"query": q0})
            got = np.asarray(out["values"])[sample]
            if not np.array_equal(got, truth):
                raise AssertionError("/distances mismatch on sampled rows")
            out = call("/distances", {"query": q0, "score_cutoff": 7})
            valid = np.asarray(out["valid"])[sample]
            vals = np.asarray(out["values"])[sample]
            if not np.array_equal(valid, truth <= 7) or \
                    not np.array_equal(vals[valid], truth[valid]):
                raise AssertionError("/distances score_cutoff=7 mismatch")
            if not valid.any():
                raise AssertionError("score_cutoff=7 accepted no row")
            out = call("/distances", {"query": q0, "score_hint": 8})
            if not np.array_equal(np.asarray(out["values"])[sample], truth):
                raise AssertionError("/distances score_hint=8 mismatch")
            # /batch: 20 queries of 33..64 chars (one W=2 group, two
            # launches of 16)
            bq = list(queries)
            while len(bq) < 20:
                n = int(rng.integers(33, LB + 1))
                bq.append(rng.integers(97, 123, n, dtype=np.uint8)
                          .tobytes().decode("ascii"))
            out = call("/batch", {"queries": bq, "k": 10})
            for qi, q in enumerate(bq):
                self.check_topk_sampled(
                    q, corpus, out["values"][qi], out["indices"][qi],
                    sample, 10, f"/batch query {qi}")
            st = call("/stats")
            if st["queries"] != 4 + 3 + 20:
                raise AssertionError(f"/stats: {st}")
        finally:
            stop()
        self.sync()
        self.emit_phase({"phase": "serve", "corpus": N_SERVE, "bucket": LB,
                         "generate_s": t_gen, "scanner_build_s": t_build,
                         "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})
        self.serve_scanner = service.scanner
        self.serve_query = anchors[0]
        self.serve_anchors = anchors
        self.serve_corpus = corpus
        self.serve_queries, self.serve_lev = queries, full
        self.serve_planted = planted
        for name in ("lev_scan", "lev_scan_nq", "lev_band"):
            if self.kc.LAUNCHES[name] == 0:
                raise AssertionError(f"serve phase never launched {name}")

    # ------------------------------------------------------------ phase 5
    def phase_wide(self):
        from rapidfuzz_tpu_torch.parallel import CorpusScanner

        rng = np.random.default_rng(self.seed + 2)
        t_start = time.perf_counter()
        before = self.kc.LAUNCHES["remap_pack"]
        letters = np.r_[np.arange(0x430, 0x450), 0x20]
        lens = rng.integers(0, LB + 1, N_WIDE)
        cps = rng.choice(letters, int(lens.sum())).astype(np.uint32)
        big = cps.tobytes().decode("utf-32-le")
        offs = np.r_[0, np.cumsum(lens)]
        corpus = [big[offs[i]:offs[i + 1]] for i in range(N_WIDE)]
        query = corpus[int(np.argmax(lens))][:40]
        for pos in rng.choice(N_WIDE, 30, replace=False):
            s = list(query)
            s[int(rng.integers(0, len(s)))] = chr(int(rng.choice(letters)))
            corpus[int(pos)] = "".join(s)
        sc = CorpusScanner(corpus, bucket=LB, device=self.dev)
        sample = rng.choice(N_WIDE, N_SAMPLE, replace=False)
        d = sc.distances(query)
        truth = self.oracle_rows(query, [corpus[i] for i in sample])
        if not np.array_equal(d[sample], truth):
            raise AssertionError("wide distances mismatch on sampled rows")
        vals, ids = sc.topk(query, 10)
        self.check_topk_sampled(query, corpus, vals, ids, sample, 10,
                                "wide topk")
        if self.kc.LAUNCHES["remap_pack"] == before:
            raise AssertionError("wide phase never launched remap_pack")
        self.sync()
        self.emit_phase({"phase": "wide", "corpus": N_WIDE, "bucket": LB,
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})
        self.wide_chars_t = sc._chars_dev
        self.wide_query = sc._encode_query(query)
        self.wide_corpus, self.wide_query_str = corpus, query

    # ------------------------------------------------------------ phase 6
    def phase_library(self):
        """The library API on the card: ``BatchComparator.distances`` and
        ``distance_many`` with a cutoff over N_LIB strings of the serve
        corpus (one query against a corpus: the scanner route), and the
        four scalar scores, against the oracle."""
        from rapidfuzz_tpu_torch.distance import levenshtein

        t_start = time.perf_counter()
        corpus = self.serve_corpus[:N_LIB]
        q = self.serve_query
        truth = self.oracle_rows(q, corpus)
        res = levenshtein.BatchComparator(q).distances(corpus)
        if not (np.array_equal(res.values, truth) and res.valid.all()):
            raise AssertionError("BatchComparator.distances != oracle")
        res = levenshtein.distance_many([q], corpus, score_cutoff=7)
        ok = truth <= 7
        if not (np.array_equal(res.valid, ok) and ok.any()
                and np.array_equal(res.values[ok], truth[ok])):
            raise AssertionError("distance_many score_cutoff=7 != oracle")
        sim = levenshtein.BatchComparator(q).normalized_similarities(corpus)
        mx = np.maximum(len(q), np.array([len(s) for s in corpus]))
        if not np.array_equal(sim.values,
                              1.0 - np.where(mx == 0, 0.0, truth / mx)):
            raise AssertionError("normalized_similarities != oracle")
        pairs = [("kitten", "sitting"), ("Иванко", "Петрунко"),
                 (q, corpus[int(np.argmin(truth))])]
        for s1, s2 in pairs:
            d = int(self.oracle_rows(s1, [s2])[0])
            m = max(len(s1), len(s2))
            got = (levenshtein.distance(s1, s2),
                   levenshtein.similarity(s1, s2),
                   levenshtein.normalized_distance(s1, s2),
                   levenshtein.normalized_similarity(s1, s2))
            if got != (d, m - d, d / m, 1.0 - d / m):
                raise AssertionError(f"scalar scores {s1!r} {s2!r}: {got}")
        self.sync()
        self.emit_phase({"phase": "library", "corpus": N_LIB,
                         "seconds": time.perf_counter() - t_start})

    # ------------------------------------------------------------ phase 7
    def mid_corpus(self, rng):
        """N_MID texts of MID_MIN..MID_LB chars, each one of N_PASSAGES
        seed passages cut to a random length with up to 7 substitutions,
        and 40 near copies (0..20 edits) each of a 300- and a 900-char
        query (near copies of passages 0 and 1), so that the cutoffs
        accept rows."""
        docs = rng.integers(97, 123, (N_PASSAGES, MID_LB), dtype=np.uint8)
        docs[rng.random(docs.shape) < 0.15] = 32
        lens = rng.integers(MID_MIN, MID_LB + 1, N_MID)
        which = rng.integers(0, N_PASSAGES, N_MID)
        nsub = rng.integers(0, 8, N_MID)
        pos = (rng.random((N_MID, 7)) * lens[:, None]).astype(np.int64)
        vals = rng.integers(97, 123, (N_MID, 7), dtype=np.uint8)
        corpus = []
        for i in range(N_MID):
            t = docs[which[i], : lens[i]].copy()
            t[pos[i, : nsub[i]]] = vals[i, : nsub[i]]
            corpus.append(t.tobytes().decode("ascii"))
        queries = [self.edit(rng, docs[k, :n].tobytes().decode("ascii"), 3)
                   for k, n in ((0, 300), (1, 900))]
        planted = rng.choice(N_MID, 80, replace=False)
        for m, i in enumerate(planted):
            corpus[int(i)] = self.edit(rng, queries[m % 2], (m // 2) % 21)
        return corpus, queries

    def phase_lcs(self):
        """The LCS family on its main path: ``ScanService(metric="indel")``
        over the serve corpus (1,048,576 strings, bucket 64) behind
        ``make_server`` -- ``/topk``, ``/distances`` plain and under a
        cutoff, ``/batch`` of 20 queries; ``CorpusScanner`` under lcs_seq
        and under the weights (2, 2, 5) over the same corpus; a mid corpus
        of N_MID texts of 225-1,024 chars (bucket 1024) under indel
        cutoffs 7-47 and lcs_seq cutoffs 7 and 15 for 300- and 900-char
        queries (the LCS band); ``fuzz.ratio_many``,
        ``RatioBatchComparator`` and ``indel.distance_many`` over N_RATIO
        of its texts.  Every answer is held against the C++ oracle over
        the whole corpus (cutoff answers: every row that can lie within
        the cutoff)."""
        from rapidfuzz_tpu_torch import fuzz
        from rapidfuzz_tpu_torch.distance import indel
        from rapidfuzz_tpu_torch.parallel import CorpusScanner
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 6)
        t_start = time.perf_counter()
        corpus = self.serve_corpus
        t0 = time.perf_counter()
        service = ScanService(corpus, metric="indel", bucket=LB,
                              device=self.dev)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad or "distances_hint" in warm:
            raise AssertionError(f"indel warmup routes: {warm}")
        q_rand = rng.integers(97, 123, LB, dtype=np.uint8).tobytes().decode()
        queries = list(self.serve_anchors) + [q_rand]
        full = self.oracle_full(queries, corpus, "indel")
        call, stop, timings = self.serve_http(service)
        try:
            for q, d in zip(queries, full):
                ans = call("/topk", {"query": q, "k": 10})
                ev, ei = self.expected_topk(d, 10)
                if ans["indices"] != ei.tolist() or \
                        ans["values"] != ev.tolist():
                    raise AssertionError(
                        f"indel /topk {q!r}: {ans['values']} "
                        f"{ans['indices']} != oracle {ev.tolist()} "
                        f"{ei.tolist()}")
            q0, d0 = queries[0], full[0]
            out = call("/distances", {"query": q0})
            if not np.array_equal(np.asarray(out["values"]), d0):
                raise AssertionError("indel /distances != oracle")
            out = call("/distances", {"query": q0, "score_cutoff": 9})
            ok = d0 <= 9
            if not (np.array_equal(np.asarray(out["valid"]), ok) and
                    ok.any() and np.array_equal(
                        np.asarray(out["values"])[ok], d0[ok])):
                raise AssertionError("indel /distances cutoff 9 != oracle")
            bq = list(queries)
            while len(bq) < 20:
                n = int(rng.integers(33, LB + 1))
                bq.append(rng.integers(97, 123, n, dtype=np.uint8)
                          .tobytes().decode("ascii"))
            out = call("/batch", {"queries": bq, "k": 10})
            sample = rng.choice(N_SERVE, N_SAMPLE, replace=False)
            for qi, q in enumerate(bq):
                self.check_topk_sampled(q, corpus, out["values"][qi],
                                        out["indices"][qi], sample, 10,
                                        f"indel /batch query {qi}", "indel")
        finally:
            stop()
        del service
        lcs = CorpusScanner(corpus, metric="lcs_seq", bucket=LB,
                            device=self.dev)
        lens = np.array([len(s) for s in corpus])
        truth = (np.maximum(len(q0), lens)
                 - (len(q0) + lens - d0) // 2)
        if not np.array_equal(lcs.distances(q0), truth):
            raise AssertionError("lcs_seq distances != oracle")
        vals, ids = lcs.topk(q0, 10)
        ev, ei = self.expected_topk(truth, 10)
        if not (np.array_equal(vals, ev) and np.array_equal(ids, ei)):
            raise AssertionError("lcs_seq topk != oracle")
        del lcs
        w225 = CorpusScanner(corpus, bucket=LB, weights=(2, 2, 5),
                             device=self.dev)
        if w225.metric != "indel" or not np.array_equal(
                w225.distances(q0), 2 * d0):
            raise AssertionError("weights (2, 2, 5) != 2 x indel")
        del w225
        # the mid corpus: the LCS band's route (queries of 8+ words)
        t0 = time.perf_counter()
        mid, mq = self.mid_corpus(rng)
        t_mid = time.perf_counter() - t0
        mid_lens = np.array([len(s) for s in mid])
        mids = {m: CorpusScanner(mid, metric=m, bucket=MID_LB,
                                 device=self.dev)
                for m in ("indel", "lcs_seq")}
        before = self.kc.LAUNCHES["lcs_band"]
        for metric, cuts in (("indel", (7, 15, 31, 47)),
                             ("lcs_seq", (7, 15))):
            for q in mq:
                # one oracle window, at the largest cutoff, serves each
                win = self.window_truth(q, mid, mid_lens, max(cuts), metric)
                for cut in cuts:
                    res = mids[metric].distances(q, score_cutoff=cut)
                    self.check_cutoff_window(
                        q, mid, mid_lens,
                        {"values": res.values, "valid": res.valid}, cut,
                        f"mid {metric} len {len(q)} cutoff {cut}",
                        metric=metric, window=win)
        if self.kc.LAUNCHES["lcs_band"] - before != 12:
            raise AssertionError("mid cutoffs did not all take the band")
        vals, ids = mids["indel"].topk(mq[0], 10)
        self.check_topk_window(mq[0], mid, mid_lens, vals, ids, 10,
                               "mid indel topk", "indel")
        # the library on the mid texts: fuzz.ratio_many under a cutoff
        # (the band), RatioBatchComparator and indel.distance_many
        sub = mid[:N_RATIO]
        q = mq[0]
        d = self.oracle_rows(q, sub, "indel")
        mx = len(q) + mid_lens[:N_RATIO]
        ratio = 1.0 - np.where(mx == 0, 0.0, d / np.maximum(mx, 1))
        before = self.kc.LAUNCHES["lcs_band"]
        res = fuzz.ratio_many(q, sub, score_cutoff=0.97)
        ok = ratio >= 0.97
        if not (self.kc.LAUNCHES["lcs_band"] > before and ok.any()
                and np.array_equal(res.valid, ok)
                and np.array_equal(res.values[ok], ratio[ok])):
            raise AssertionError("fuzz.ratio_many cutoff 0.97 != oracle")
        res = fuzz.RatioBatchComparator(q).similarities(sub)
        if not np.array_equal(res.values, ratio):
            raise AssertionError("RatioBatchComparator != oracle")
        res = indel.distance_many([q], sub)
        if not np.array_equal(res.values, d):
            raise AssertionError("indel.distance_many != oracle")
        if fuzz.ratio(q, sub[0]) != ratio[0]:
            raise AssertionError("fuzz.ratio != oracle")
        self.sync()
        self.emit_phase({"phase": "lcs", "corpus": N_SERVE, "bucket": LB,
                         "mid_corpus": N_MID, "mid_bucket": MID_LB,
                         "scanner_build_s": t_build, "mid_generate_s": t_mid,
                         "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})
        self.mid_scanner = mids["indel"]
        self.mid_query = mq[0]

    @staticmethod
    def edit(rng, s: str, k: int) -> str:
        """``s`` with ``k`` random substitutions, deletions and
        insertions of lowercase letters."""
        s = list(s)
        for _ in range(k):
            i = int(rng.integers(0, len(s)))
            op = int(rng.integers(0, 3))
            c = chr(int(rng.integers(97, 123)))
            if op == 0:
                s[i] = c
            elif op == 1:
                del s[i]
            else:
                s.insert(i, c)
        return "".join(s)

    def long_corpus(self, rng):
        """N_LONG texts of 1,025..8,192 chars, each one of N_DOCS seed
        documents cut to a random length with up to 7 substitutions, and
        40 near copies (0..20 edits) of the ~4,000-char query, a near copy
        of document 0, so that the cutoffs accept rows."""
        docs = rng.integers(97, 123, (N_DOCS, LONG_LB), dtype=np.uint8)
        docs[rng.random(docs.shape) < 0.15] = 32
        lens = rng.integers(1025, LONG_LB + 1, N_LONG)
        which = rng.integers(0, N_DOCS, N_LONG)
        nsub = rng.integers(0, 8, N_LONG)
        pos = (rng.random((N_LONG, 7)) * lens[:, None]).astype(np.int64)
        vals = rng.integers(97, 123, (N_LONG, 7), dtype=np.uint8)
        corpus = []
        for i in range(N_LONG):
            t = docs[which[i], : lens[i]].copy()
            t[pos[i, : nsub[i]]] = vals[i, : nsub[i]]
            corpus.append(t.tobytes().decode("ascii"))
        q4k = self.edit(rng, docs[0, :Q_LONG].tobytes().decode("ascii"), 5)
        planted = rng.choice(N_LONG, 40, replace=False)
        for m, i in enumerate(planted):
            corpus[int(i)] = self.edit(rng, q4k, m % 21)
        return corpus, docs, q4k, planted

    @oracle_time
    def window_truth(self, q: str, corpus, lens, bound: int,
                     metric="levenshtein", lev=None):
        """Oracle distances of ``q`` to every row that can lie within
        ``bound``: rows with ``|len - len(q)| > bound`` cannot (each of
        the five metrics is at least the length difference), nor, under
        OSA and Damerau-Levenshtein, rows whose Levenshtein distance
        exceeds ``2 * bound`` (one OSA edit is at most two Levenshtein
        edits; a Damerau transposition with the edits between its chars,
        cost ``c``, at most ``c + 1 <= 2c``); a weight tuple
        ``(ins, del, sub)`` costs at least ``ins`` per char the row is
        longer and ``del`` per char it is shorter, and at least the
        cheapest cost times the Levenshtein distance.  The Levenshtein
        distances are ``lev`` where given, else, under OSA, Damerau and
        weights, the banded bit-parallel oracle's on the rows the lengths
        leave
        (far cheaper than their scalar calls).  Only the rows left are
        computed; Levenshtein banded at ``bound`` (exact when within it,
        ``bound + 1`` above), the other metrics exact.  Returns (row ids,
        distances)."""
        lev_bound = None
        if isinstance(metric, tuple):
            ins, dele, _ = metric
            diff = lens - len(q)
            near = np.where(diff >= 0, ins * diff, -dele * diff) <= bound
            if min(metric) > 0:
                lev_bound = bound // min(metric)
        else:
            near = np.abs(lens - len(q)) <= bound
            if lev is not None or metric in ("osa", DAM):
                lev_bound = 2 * bound
        if lev is not None and lev_bound is not None:
            near &= lev <= lev_bound
        rows = np.flatnonzero(near)
        eq = self.codec.encode_one(q)
        if lev is None and lev_bound is not None:
            lv = np.array([self.oracle.levenshtein_uniform_bp(
                eq, self.codec.encode_one(corpus[i]), lev_bound)
                for i in rows], np.int64)
            rows = rows[lv <= lev_bound]
        if metric != "levenshtein":
            return rows, self.oracle_rows(q, [corpus[i] for i in rows],
                                          metric)
        d = np.array([self.oracle.levenshtein_uniform_bp(
            eq, self.codec.encode_one(corpus[i]), bound) for i in rows],
            np.int64)
        return rows, d

    def check_topk_window(self, q, corpus, lens, vals, ids, k, what,
                          metric="levenshtein", lev=None, window=None):
        """The whole-corpus top-k, by (distance, index): only rows within
        the k-th returned distance can belong to it.  ``window``: the
        :meth:`window_truth` of ``q`` at a bound of at least that
        distance, where the caller has it."""
        vals, ids = np.asarray(vals), np.asarray(ids)
        if len(ids) != k:
            raise AssertionError(f"{what}: {len(ids)} results, expected {k}")
        rows, d = window or self.window_truth(q, corpus, lens, int(vals[-1]),
                                              metric, lev)
        keep = d <= int(vals[-1])
        order = np.lexsort((rows[keep], d[keep]))[:k]
        if not (np.array_equal(rows[keep][order], ids)
                and np.array_equal(d[keep][order], vals)):
            raise AssertionError(f"{what}: {vals.tolist()} {ids.tolist()} "
                                 f"!= oracle {d[keep][order].tolist()} "
                                 f"{rows[keep][order].tolist()}")

    def check_cutoff_window(self, q, corpus, lens, out, cut, what,
                            want_hits=True, metric="levenshtein",
                            lev=None, window=None):
        """A ``(values, valid)`` answer under ``cut`` against the oracle
        over the whole corpus (``window`` as in
        :meth:`check_topk_window`)."""
        valid = np.asarray(out["valid"])
        values = np.asarray(out["values"])
        rows, d = window or self.window_truth(q, corpus, lens, cut, metric,
                                              lev)
        ok = np.zeros(len(corpus), bool)
        ok[rows[d <= cut]] = True
        if not np.array_equal(valid, ok):
            raise AssertionError(f"{what}: valid rows != oracle")
        truth = np.zeros(len(corpus), np.int64)
        truth[rows] = d
        if not np.array_equal(values[ok], truth[ok]):
            raise AssertionError(f"{what}: values != oracle")
        if want_hits and not ok.any():
            raise AssertionError(f"{what}: no row accepted")

    def serve_http(self, service):
        """Start ``make_server`` on a free port; returns (call, stop)."""
        from rapidfuzz_tpu_torch.serve import make_server

        server = make_server(service, port=0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        timings = {}

        def call(path, body=None):
            t = time.perf_counter()
            url = f"http://127.0.0.1:{port}{path}"
            if body is None:
                req = urllib.request.Request(url)
            else:
                req = urllib.request.Request(
                    url, data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                out = json.loads(r.read())
            timings.setdefault(path, []).append(time.perf_counter() - t)
            return out

        def stop():
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
            if thread.is_alive():
                raise AssertionError("server thread did not stop")

        return call, stop, timings

    def phase_long(self):
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 5)
        t_start = time.perf_counter()
        corpus, docs, q4k, planted = self.long_corpus(rng)
        t_gen = time.perf_counter() - t_start
        lens = np.array([len(s) for s in corpus])
        t0 = time.perf_counter()
        service = ScanService(corpus, bucket=LONG_LB, device=self.dev)
        t_build = time.perf_counter() - t0
        if not service.scanner._stream:
            raise AssertionError("bucket 8192 did not take the long routes")
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad:
            raise AssertionError(f"long warmup routes failed: {bad}")
        q64 = rng.integers(97, 123, 64, dtype=np.uint8).tobytes().decode()
        q300 = self.edit(rng, docs[1, :300].tobytes().decode("ascii"), 3)
        call, stop, timings = self.serve_http(service)
        try:
            h = call("/health")
            if not (h["ok"] and h["n"] == N_LONG):
                raise AssertionError(f"/health: {h}")
            for q in (q64, q300, q4k):
                out = call("/topk", {"query": q, "k": 10})
                self.check_topk_window(q, corpus, lens, out["values"],
                                       out["indices"], 10,
                                       f"long /topk len {len(q)}")
                if out["strings"] != [corpus[i] for i in out["indices"]]:
                    raise AssertionError("long /topk strings mismatch")
            for q, cut in ((q4k, 3), (q4k, 15), (q4k, 40), (q300, 15),
                           (q64, 15)):
                out = call("/distances", {"query": q, "score_cutoff": cut})
                self.check_cutoff_window(q, corpus, lens, out, cut,
                                         f"long /distances len {len(q)} "
                                         f"cutoff {cut}",
                                         want_hits=q is q4k)
            sample = np.unique(np.r_[rng.choice(N_LONG, LONG_SAMPLE,
                                                replace=False), planted])
            for q, body in ((q4k, {"score_hint": 40}), (q300, {})):
                out = call("/distances", {"query": q, **body})
                got = np.asarray(out["values"])[sample]
                truth = self.oracle_rows(q, [corpus[i] for i in sample])
                if not np.array_equal(got, truth):
                    raise AssertionError(f"long /distances len {len(q)} "
                                         f"{body}: sampled rows != oracle")
            bq = [q64, q300, self.edit(rng, q64, 4)]
            out = call("/batch", {"queries": bq, "k": 10})
            for qi, q in enumerate(bq):
                self.check_topk_window(q, corpus, lens, out["values"][qi],
                                       out["indices"][qi], 10,
                                       f"long /batch query {qi}")
        finally:
            stop()
        # the run-time band's route: a bucket that is not whole 512-char
        # chunks, over the texts that fit it and the near copies of q4k
        fits = lens <= ODD_LB
        fits[planted] = False
        short = np.flatnonzero(fits)[: N_ODD - len(planted)]
        ids = np.r_[short, planted]
        odd_corpus = [corpus[i] for i in ids]
        odd = ScanService(odd_corpus, bucket=ODD_LB, device=self.dev)
        odd_scanner = odd.scanner
        if odd.scanner._stream or not odd.scanner._long:
            raise AssertionError("bucket 6000 did not take the odd route")
        odd_lens = lens[ids]
        for cut in (3, 15, 40):          # run-time band, then full scan
            out = odd.distances(q4k, score_cutoff=cut)
            self.check_cutoff_window(q4k, odd_corpus, odd_lens, out, cut,
                                     f"bucket {ODD_LB} cutoff {cut}")
        vals_ids = odd.topk(q4k, 10)
        self.check_topk_window(q4k, odd_corpus, odd_lens, vals_ids["values"],
                               vals_ids["indices"], 10,
                               f"bucket {ODD_LB} /topk")
        del odd
        # the LCS family over the same texts: the full long scan in its
        # register (64, 300 chars) and tile (~4,000) forms, and the
        # streamed band under indel cutoffs 15 (bw 1) and 31 (bw 2)
        indel = ScanService(corpus, metric="indel", bucket=LONG_LB,
                            device=self.dev)
        call, stop, indel_timings = self.serve_http(indel)
        try:
            for q in (q64, q300, q4k):
                out = call("/topk", {"query": q, "k": 10})
                self.check_topk_window(q, corpus, lens, out["values"],
                                       out["indices"], 10,
                                       f"long indel /topk len {len(q)}",
                                       metric="indel")
            for cut in (15, 31):
                out = call("/distances", {"query": q4k, "score_cutoff": cut})
                self.check_cutoff_window(q4k, corpus, lens, out, cut,
                                         f"long indel cutoff {cut}",
                                         metric="indel")
        finally:
            stop()
        del indel
        self.sync()
        self.emit_phase({"phase": "long", "corpus": N_LONG, "bucket": LONG_LB,
                         "odd_corpus": len(odd_corpus), "odd_bucket": ODD_LB,
                         "generate_s": t_gen, "scanner_build_s": t_build,
                         "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "indel_request_s": indel_timings,
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})
        self.long_scanner = service.scanner
        self.odd_scanner = odd_scanner
        self.long_queries = {"q64": q64, "q300": q300, "q4k": q4k}
        self.long_planted = planted
        self.long_corpus, self.long_lens = corpus, lens
        self.odd_corpus, self.odd_lens = odd_corpus, odd_lens

    # ------------------------------------------------------------ phase 9
    def phase_osa(self):
        """OSA on its main path: ``ScanService(metric="osa")`` over the
        serve corpus behind ``make_server`` -- ``/topk`` for the three
        anchors (whole corpus) and a random query (sampled rows),
        ``/distances`` plain (every row within the Levenshtein bounds,
        ``lev / 2 <= osa <= lev``, sampled and planted rows exact) and
        under cutoff 3 (whole corpus), ``/batch`` of 20 queries (sampled
        rows); a ``CorpusScanner(metric="osa")`` over the long corpus for
        the 64- and 300-char queries, and an OSA service over the
        bucket-6000 texts for the ~4,000-char query under top-k and cutoff
        15 (whole corpus); ``osa.distance_many`` over N_LIB strings (every
        row) and the scalar scores.  Whole-corpus checks compute the
        oracle only on rows that can lie within the bound: OSA is at least
        the length difference and at least half the Levenshtein distance
        (the serve phase's oracle rows)."""
        from rapidfuzz_tpu_torch.distance import osa
        from rapidfuzz_tpu_torch.parallel import CorpusScanner
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 7)
        t_start = time.perf_counter()
        corpus = self.serve_corpus
        lens = np.array([len(s) for s in corpus])
        t0 = time.perf_counter()
        service = ScanService(corpus, metric="osa", bucket=LB,
                              device=self.dev)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad or "distances_hint" in warm:
            raise AssertionError(f"osa warmup routes: {warm}")
        queries, levs = self.serve_queries, self.serve_lev
        sample = np.unique(np.r_[rng.choice(N_SERVE, N_SAMPLE,
                                            replace=False),
                                 self.serve_planted])
        call, stop, timings = self.serve_http(service)
        try:
            for qi, (q, lev) in enumerate(zip(queries, levs)):
                out = call("/topk", {"query": q, "k": 10})
                if qi < len(self.serve_anchors):
                    self.check_topk_window(q, corpus, lens, out["values"],
                                           out["indices"], 10,
                                           f"osa /topk anchor {qi}", "osa",
                                           lev)
                else:
                    self.check_topk_sampled(q, corpus, out["values"],
                                            out["indices"], sample, 10,
                                            "osa /topk random", "osa")
            q0, lev0 = queries[0], levs[0]
            d = np.asarray(call("/distances", {"query": q0})["values"])
            lo = np.maximum(np.abs(lens - len(q0)), (lev0 + 1) // 2)
            if not ((d >= lo).all() and (d <= lev0).all()):
                raise AssertionError("osa /distances outside the "
                                     "Levenshtein bounds")
            if not np.array_equal(d[sample], self.oracle_rows(
                    q0, [corpus[i] for i in sample], "osa")):
                raise AssertionError("osa /distances != oracle on sampled "
                                     "rows")
            if not (d < lev0).any():
                raise AssertionError("osa /distances never beat "
                                     "Levenshtein")
            out = call("/distances", {"query": q0, "score_cutoff": 3})
            self.check_cutoff_window(q0, corpus, lens, out, 3,
                                     "osa /distances cutoff 3",
                                     metric="osa", lev=lev0)
            bq = list(queries)
            while len(bq) < 20:
                n = int(rng.integers(33, LB + 1))
                bq.append(rng.integers(97, 123, n, dtype=np.uint8)
                          .tobytes().decode("ascii"))
            out = call("/batch", {"queries": bq, "k": 10})
            for qi, q in enumerate(bq):
                self.check_topk_sampled(q, corpus, out["values"][qi],
                                        out["indices"][qi], sample, 10,
                                        f"osa /batch query {qi}", "osa")
        finally:
            stop()
        del service
        # the library: one query against N_LIB strings (the scanner), and
        # the scalar scores
        sub = corpus[:N_LIB]
        truth = self.oracle_rows(q0, sub, "osa")
        res = osa.distance_many([q0], sub)
        if not (np.array_equal(res.values, truth) and res.valid.all()):
            raise AssertionError("osa.distance_many != oracle")
        for s1, s2, want in (("CA", "ABC", 3), ("CA", "AC", 1),
                             (q0, sub[int(np.argmin(truth))],
                              int(truth.min()))):
            m = max(len(s1), len(s2))
            got = (osa.distance(s1, s2), osa.similarity(s1, s2),
                   osa.normalized_distance(s1, s2))
            if got != (want, m - want, want / m):
                raise AssertionError(f"osa scalar scores {s1!r} {s2!r}: "
                                     f"{got}")
        # the long texts: K6 over buckets > 1024 in register form (64
        # chars) and tile form (300 and ~4,000 chars)
        qs = self.long_queries
        long_corpus, long_lens = self.long_corpus, self.long_lens
        t0 = time.perf_counter()
        long_sc = CorpusScanner(long_corpus, metric="osa", bucket=LONG_LB,
                                device=self.dev)
        t_long = time.perf_counter() - t0
        long_s = {}
        for key in ("q64", "q300"):
            t0 = time.perf_counter()
            vals, ids = long_sc.topk(qs[key], 10)
            long_s[key] = time.perf_counter() - t0
            self.check_topk_window(qs[key], long_corpus, long_lens, vals,
                                   ids, 10, f"osa long topk {key}", "osa")
        del long_sc
        odd = ScanService(self.odd_corpus, metric="osa", bucket=ODD_LB,
                          device=self.dev)
        if odd.scanner._stream or not odd.scanner._long:
            raise AssertionError("bucket 6000 did not take the odd route")
        q4k = qs["q4k"]
        t0 = time.perf_counter()
        out = odd.topk(q4k, 10)
        long_s["q4k"] = time.perf_counter() - t0
        self.check_topk_window(q4k, self.odd_corpus, self.odd_lens,
                               out["values"], out["indices"], 10,
                               "osa bucket 6000 topk q4k", "osa")
        out = odd.distances(q4k, score_cutoff=15)
        self.check_cutoff_window(q4k, self.odd_corpus, self.odd_lens, out, 15,
                                 "osa bucket 6000 cutoff 15", metric="osa")
        del odd
        self.sync()
        self.emit_phase({"phase": "osa", "corpus": N_SERVE, "bucket": LB,
                         "long_corpus": len(long_corpus), "odd_corpus":
                             len(self.odd_corpus), "scanner_build_s": t_build,
                         "long_build_s": t_long, "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "long_topk_s": long_s,
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})

    # ------------------------------------------------------------ phase 10
    def phase_wlev(self):
        """Weighted Levenshtein on its main path: ``ScanService(weights=
        WLEV_SERVE)`` over the serve corpus behind ``make_server`` --
        ``/topk`` for the three anchors (whole corpus) and a random query
        (sampled rows), ``/distances`` plain (every row within the
        Levenshtein bounds ``2*lev <= d <= 3*lev``, sampled and planted
        rows exact) and under cutoff 12 (whole corpus), ``/batch`` of 20
        queries (N_BATCH_SAMPLE sampled rows each); ``CorpusScanner``s under
        WLEV_SCAN over the long corpus for the 64- and 300-char queries
        (top-k, whole corpus), over the bucket-6000 texts for the
        ~4,000-char query (the tile form; top-k and cutoff 40, whole
        corpus) and over the Cyrillic corpus (the remap route; sampled
        rows); ``levenshtein.distance_many`` with a cutoff (whole corpus)
        and ``BatchComparator.normalized_similarities`` (sampled rows) over
        N_LIB strings."""
        from rapidfuzz_tpu_torch.distance import levenshtein
        from rapidfuzz_tpu_torch.parallel import CorpusScanner
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 8)
        t_start = time.perf_counter()
        corpus, w = self.serve_corpus, WLEV_SERVE
        lens = np.array([len(s) for s in corpus])
        t0 = time.perf_counter()
        service = ScanService(corpus, bucket=LB, device=self.dev, weights=w)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad:
            raise AssertionError(f"wlev warmup routes failed: {bad}")
        queries, levs = self.serve_queries, self.serve_lev
        sample = np.unique(np.r_[rng.choice(N_SERVE, N_SAMPLE,
                                            replace=False),
                                 self.serve_planted])
        call, stop, timings = self.serve_http(service)
        try:
            for qi, (q, lev) in enumerate(zip(queries, levs)):
                out = call("/topk", {"query": q, "k": 10})
                if qi < len(self.serve_anchors):
                    self.check_topk_window(q, corpus, lens, out["values"],
                                           out["indices"], 10,
                                           f"wlev /topk anchor {qi}", w, lev)
                else:
                    self.check_topk_sampled(q, corpus, out["values"],
                                            out["indices"], sample, 10,
                                            "wlev /topk random", w)
            q0, lev0 = queries[0], levs[0]
            d = np.asarray(call("/distances", {"query": q0})["values"])
            if not ((d >= 2 * lev0).all() and (d <= 3 * lev0).all()):
                raise AssertionError("wlev /distances outside the "
                                     "Levenshtein bounds")
            if not np.array_equal(d[sample], self.oracle_rows(
                    q0, [corpus[i] for i in sample], w)):
                raise AssertionError("wlev /distances != oracle on sampled "
                                     "rows")
            out = call("/distances", {"query": q0, "score_cutoff": 12})
            self.check_cutoff_window(q0, corpus, lens, out, 12,
                                     "wlev /distances cutoff 12", metric=w,
                                     lev=lev0)
            bq = list(queries)
            while len(bq) < 20:
                n = int(rng.integers(33, LB + 1))
                bq.append(rng.integers(97, 123, n, dtype=np.uint8)
                          .tobytes().decode("ascii"))
            out = call("/batch", {"queries": bq, "k": 10})
            bsample = np.unique(np.r_[rng.choice(N_SERVE, N_BATCH_SAMPLE,
                                                 replace=False),
                                      self.serve_planted])
            for qi, q in enumerate(bq):
                self.check_topk_sampled(q, corpus, out["values"][qi],
                                        out["indices"][qi], bsample, 10,
                                        f"wlev /batch query {qi}", w)
        finally:
            stop()
        del service
        # the seconds of each part, for the phase's budget
        t_part = time.perf_counter()
        parts = {"serve": t_part - t_start}
        # the long texts: K7 over buckets > 1024 in register form (64
        # chars) and tile form (300), then the ~4,000-char query over the
        # bucket-6000 texts (tile form, four strips)
        w = WLEV_SCAN
        qs = self.long_queries
        t0 = time.perf_counter()
        long_sc = CorpusScanner(self.long_corpus, bucket=LONG_LB,
                                weights=w, device=self.dev)
        t_long = time.perf_counter() - t0
        long_s = {}
        for key in ("q64", "q300"):
            t0 = time.perf_counter()
            vals, ids = long_sc.topk(qs[key], 10)
            long_s[key] = time.perf_counter() - t0
            self.check_topk_window(qs[key], self.long_corpus, self.long_lens,
                                   vals, ids, 10, f"wlev long topk {key}", w)
        del long_sc
        parts["long"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        odd = CorpusScanner(self.odd_corpus, bucket=ODD_LB, weights=w,
                            device=self.dev)
        q4k = qs["q4k"]
        t0 = time.perf_counter()
        vals, ids = odd.topk(q4k, 10)
        long_s["q4k"] = time.perf_counter() - t0
        res = odd.distances(q4k, score_cutoff=40)
        # one oracle window serves both checks
        win = self.window_truth(q4k, self.odd_corpus, self.odd_lens,
                                max(int(vals[-1]), 40), w)
        self.check_topk_window(q4k, self.odd_corpus, self.odd_lens, vals, ids,
                               10, "wlev bucket 6000 topk q4k", w,
                               window=win)
        self.check_cutoff_window(q4k, self.odd_corpus, self.odd_lens,
                                 {"values": res.values, "valid": res.valid},
                                 40, "wlev bucket 6000 cutoff 40", metric=w,
                                 window=win)
        del odd
        parts["odd"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # the Cyrillic corpus: K2's remap, then K7 in local mode
        wide = CorpusScanner(self.wide_corpus, bucket=LB, weights=w,
                             device=self.dev)
        qw = self.wide_query_str
        wsample = rng.choice(N_WIDE, N_SAMPLE, replace=False)
        if not np.array_equal(wide.distances(qw)[wsample], self.oracle_rows(
                qw, [self.wide_corpus[i] for i in wsample], w)):
            raise AssertionError("wlev wide distances != oracle on sampled "
                                 "rows")
        vals, ids = wide.topk(qw, 10)
        self.check_topk_sampled(qw, self.wide_corpus, vals, ids, wsample,
                                10, "wlev wide topk", w)
        del wide
        parts["wide"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # the library: one query against N_LIB strings (the scanner)
        # with the planted copies of the anchors among them (whole corpus
        # under the cutoff: a distance lies within [min(w) * lev,
        # max(w) * lev], so at least 17 rows meet it; sampled rows for
        # the scores)
        planted = self.serve_planted
        ids = np.r_[np.setdiff1d(np.arange(N_LIB), planted)[
            : N_LIB - planted.size], planted]
        sub = [corpus[i] for i in ids]
        lev_sub, lens_sub = lev0[ids], lens[ids]
        cut = int(np.sort(max(w) * lev_sub)[16])
        res = levenshtein.distance_many([q0], sub, weights=w,
                                        score_cutoff=cut)
        self.check_cutoff_window(q0, sub, lens_sub,
                                 {"values": res.values, "valid": res.valid},
                                 cut, f"wlev distance_many cutoff {cut}",
                                 metric=w, lev=lev_sub)
        sim = levenshtein.BatchComparator(
            q0, levenshtein.WeightTable(*w)).normalized_similarities(sub)
        lsample = rng.choice(N_LIB, N_SAMPLE, replace=False)
        truth = self.oracle_rows(q0, [sub[i] for i in lsample], w)
        mx = levenshtein.maximum(np.full(N_SAMPLE, len(q0)),
                                 lens_sub[lsample], w)
        if not np.array_equal(sim.values[lsample], 1.0 - np.where(
                mx == 0, 0.0, truth / np.maximum(mx, 1))):
            raise AssertionError("wlev normalized_similarities != oracle "
                                 "on sampled rows")
        self.sync()
        parts["library"] = time.perf_counter() - t_part
        self.emit_phase({
            "phase": "wlev", "corpus": N_SERVE, "bucket": LB,
            "serve_weights": WLEV_SERVE, "scan_weights": WLEV_SCAN,
            "long_corpus": len(self.long_corpus),
            "odd_corpus": len(self.odd_corpus), "wide_corpus": N_WIDE,
            "scanner_build_s": t_build, "long_build_s": t_long,
            "warmup_s": warm, "request_s": {k: v for k, v in timings.items()},
            "long_topk_s": long_s, "parts_s": parts,
            "launches": dict(self.kc.LAUNCHES),
            "seconds": time.perf_counter() - t_start})

    # ------------------------------------------------------------ phase 11
    @oracle_time
    def jaro_rows(self, query, strings, pw=None) -> np.ndarray:
        """The oracle's f64 distances ``1.0 - sim`` of ``query`` to
        ``strings``: Jaro, or Jaro-Winkler at prefix weight ``pw``, one
        scalar call per string, eight slices in parallel (ctypes drops
        the GIL)."""
        eq = self.codec.encode_one(query)
        enc = [self.codec.encode_one(s) for s in strings]
        if pw is None:
            one = self.oracle.jaro
        else:
            def one(a, b):
                return self.oracle.jaro_winkler(a, b, pw)
        parts = np.array_split(np.arange(len(enc)), 8)
        with ThreadPoolExecutor(8) as ex:
            done = list(ex.map(lambda ix: [one(eq, enc[i]) for i in ix],
                               parts))
        return 1.0 - np.array([v for part in done for v in part],
                              np.float64)

    def partial_rows(self, query, strings) -> np.ndarray:
        """The oracle's f64 distances ``1.0 - partial_ratio`` of ``query``
        to ``strings`` (its brute force: one indel DP per window), one
        scalar call per string, eight slices in parallel (ctypes drops the
        GIL)."""
        eq = self.codec.encode_one(query)
        enc = [self.codec.encode_one(s) for s in strings]
        parts = np.array_split(np.arange(len(enc)), 8)
        with ThreadPoolExecutor(8) as ex:
            done = list(ex.map(lambda ix: [self.oracle.partial_ratio(
                eq, enc[i]) for i in ix], parts))
        return 1.0 - np.array([v for part in done for v in part],
                              np.float64)

    def jaro_window(self, q, corpus, lens, s_min, pw=None, common=None,
                    prefix=None):
        """Rows whose similarity to ``q`` can reach ``s_min``, and the
        oracle's distances on them.  With at most ``m`` common chars a
        row's Jaro similarity is at most ``(m/la + m/lb + 1)/3`` (no
        transposition), ``m`` at most ``common`` (default ``min(la,
        lb)``); the Winkler boost at the row's ``prefix`` (default 4) is
        increasing in the similarity.  Returns (row ids, distances)."""
        m = (np.minimum(len(q), lens) if common is None
             else common).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            ub = np.where(m > 0, (m / len(q) + m / lens + 1.0) / 3.0, 0.0)
        if pw is not None:
            p = 4 if prefix is None else prefix
            ub = np.where(ub > 0.7, ub + p * pw * (1.0 - ub), ub)
        rows = np.flatnonzero(ub >= s_min - 1e-9)
        return rows, self.jaro_rows(q, [corpus[i] for i in rows], pw)

    def check_jaro_topk(self, q, corpus, lens, vals, ids, k, what, pw=None,
                        **bound):
        """The whole-corpus top-k by (distance, index): only rows whose
        bound reaches the k-th returned similarity can belong to it."""
        vals, ids = np.asarray(vals, np.float64), np.asarray(ids)
        if len(ids) != k:
            raise AssertionError(f"{what}: {len(ids)} results, expected {k}")
        rows, d = self.jaro_window(q, corpus, lens, 1.0 - vals[-1], pw,
                                   **bound)
        order = np.lexsort((rows, d))[:k]
        if not (np.array_equal(rows[order], ids)
                and np.array_equal(d[order], vals)):
            raise AssertionError(f"{what}: {vals.tolist()} {ids.tolist()} "
                                 f"!= oracle {d[order].tolist()} "
                                 f"{rows[order].tolist()}")

    def phase_jaro(self):
        """The Jaro family on its main path: ``ScanService(metric=
        "jaro_winkler")`` over the serve corpus behind ``make_server`` --
        ``/topk`` for the three anchors (whole corpus: the window of
        :meth:`jaro_window`, each row's common chars bounded by the
        multiset of chars it shares with the query, its prefix exact, both
        counted on the card) and a random query (sampled rows),
        ``/distances`` plain (sampled and planted rows) and under cutoff
        0.1 (whole corpus), ``/batch`` of 20 queries (N_BATCH_SAMPLE
        sampled rows and the planted ones, one two-word group: K8's
        16-query launches); a ``CorpusScanner(metric="jaro")`` over the
        long corpus: top-k for the 64-, 300- and ~4,000-char queries on
        sampled rows and the near copies of the last (nearly every text
        lies within the bounds of the first two, and the oracle's scalar
        Jaro of two ~4,000-char texts takes milliseconds); a
        ``CorpusScanner(metric="jaro_winkler")`` over the Cyrillic corpus
        (K2, then K8 in local mode; sampled rows and top-k); and
        ``jaro_winkler.BatchComparator(q, JARO_LIB_PW).similarities`` over
        N_LIB strings (sampled rows and the 64 most similar) and the
        scalar scores."""
        from rapidfuzz_tpu_torch.distance import jaro, jaro_winkler
        from rapidfuzz_tpu_torch.parallel import CorpusScanner
        from rapidfuzz_tpu_torch.serve import ScanService

        torch = self.torch
        rng = np.random.default_rng(self.seed + 8)
        t_start = time.perf_counter()
        corpus = self.serve_corpus
        lens = np.array([len(s) for s in corpus])
        t0 = time.perf_counter()
        service = ScanService(corpus, metric="jaro_winkler", bucket=LB,
                              device=self.dev)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad or "distances_hint" in warm:
            raise AssertionError(f"jaro warmup routes: {warm}")
        # the corpus as [N_SERVE, LB] bytes on the card (pads 0, which no
        # query holds), for the windows' per-row bounds
        chars = np.zeros((N_SERVE, LB), np.uint8)
        chars[np.arange(LB)[None, :] < lens[:, None]] = np.frombuffer(
            "".join(corpus).encode("latin-1"), np.uint8)
        chars = torch.from_numpy(chars).to(self.dev)
        lens_t = torch.from_numpy(lens).to(self.dev)

        def bound(q):
            """Each row's common-char bound (the multiset of chars it
            shares with ``q``) and its Winkler prefix with ``q``."""
            qa = np.frombuffer(q.encode("latin-1"), np.uint8)
            m = torch.zeros(N_SERVE, dtype=torch.int64, device=self.dev)
            for c, n in zip(*np.unique(qa, return_counts=True)):
                m += (chars == int(c)).sum(1).clamp(max=int(n))
            k = min(4, len(q))
            eq = (chars[:, :k] == torch.from_numpy(qa[:k].copy()).to(
                self.dev)) & (torch.arange(k, device=self.dev)
                              < lens_t[:, None])
            p = eq.to(torch.int64).cumprod(1).sum(1)
            return {"common": m.cpu().numpy(), "prefix": p.cpu().numpy()}

        anchors = self.serve_anchors
        queries = list(anchors) + [rng.integers(97, 123, LB, dtype=np.uint8)
                                   .tobytes().decode("ascii")]
        sample = np.unique(np.r_[rng.choice(N_SERVE, N_SAMPLE,
                                            replace=False),
                                 self.serve_planted])
        call, stop, timings = self.serve_http(service)
        try:
            for qi, q in enumerate(queries):
                out = call("/topk", {"query": q, "k": 10})
                if qi < len(anchors):
                    self.check_jaro_topk(q, corpus, lens, out["values"],
                                         out["indices"], 10,
                                         f"jaro /topk anchor {qi}", JARO_PW,
                                         **bound(q))
                else:
                    self.check_topk_sampled(q, corpus, out["values"],
                                            out["indices"], sample, 10,
                                            "jaro /topk random",
                                            "jaro_winkler")
                if out["strings"] != [corpus[i] for i in out["indices"]]:
                    raise AssertionError("jaro /topk strings mismatch")
            q0 = queries[0]
            d = np.asarray(call("/distances", {"query": q0})["values"])
            if not np.array_equal(d[sample], self.oracle_rows(
                    q0, [corpus[i] for i in sample], "jaro_winkler")):
                raise AssertionError("jaro /distances != oracle on sampled "
                                     "rows")
            cut = 0.1
            out = call("/distances", {"query": q0, "score_cutoff": cut})
            rows, dw = self.jaro_window(q0, corpus, lens, 1.0 - cut, JARO_PW,
                                        **bound(q0))
            ok = np.zeros(N_SERVE, bool)
            ok[rows[dw <= cut]] = True
            truth = np.zeros(N_SERVE)
            truth[rows] = dw
            values = np.asarray(out["values"])
            if not (np.array_equal(np.asarray(out["valid"]), ok) and ok.any()
                    and np.array_equal(values[ok], truth[ok])
                    and np.array_equal(values, d)):
                raise AssertionError(f"jaro /distances score_cutoff={cut} "
                                     "!= oracle")
            bq = list(queries)
            while len(bq) < 20:
                n = int(rng.integers(33, LB + 1))
                bq.append(rng.integers(97, 123, n, dtype=np.uint8)
                          .tobytes().decode("ascii"))
            out = call("/batch", {"queries": bq, "k": 10})
            bsample = np.unique(np.r_[rng.choice(N_SERVE, N_BATCH_SAMPLE,
                                                 replace=False),
                                      self.serve_planted])
            for qi, q in enumerate(bq):
                self.check_topk_sampled(q, corpus, out["values"][qi],
                                        out["indices"][qi], bsample, 10,
                                        f"jaro /batch query {qi}",
                                        "jaro_winkler")
        finally:
            stop()
        del service, chars
        parts = {"serve": time.perf_counter() - t_start,
                 "serve_oracle": self.oracle_s - self.oracle_mark}
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the long texts: K8 over buckets > 1024 in register form (64
        # chars) and scratch form (300 and ~4,000 chars)
        qs = self.long_queries
        long_corpus, long_lens = self.long_corpus, self.long_lens
        t0 = time.perf_counter()
        long_sc = CorpusScanner(long_corpus, metric="jaro", bucket=LONG_LB,
                                device=self.dev)
        t_long = time.perf_counter() - t0
        lsample = np.unique(np.r_[rng.choice(len(long_corpus), LONG_SAMPLE,
                                             replace=False),
                                  self.long_planted])
        long_s = {}
        for key in ("q64", "q300", "q4k"):
            t0 = time.perf_counter()
            vals, ids = long_sc.topk(qs[key], 10)
            long_s[key] = time.perf_counter() - t0
            self.check_topk_sampled(qs[key], long_corpus, vals, ids, lsample,
                                    10, f"jaro long topk {key}", "jaro")
        del long_sc
        parts["long"] = time.perf_counter() - t_part
        parts["long_oracle"] = self.oracle_s - o_part
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the Cyrillic corpus: K2's remap, then K8 in local mode, the
        # Winkler prefix on the chars before the remap
        before = self.kc.LAUNCHES["remap_pack"]
        wide = CorpusScanner(self.wide_corpus, metric="jaro_winkler",
                             bucket=LB, device=self.dev)
        qw = self.wide_query_str
        wsample = rng.choice(N_WIDE, N_SAMPLE, replace=False)
        if not np.array_equal(wide.distances(qw)[wsample], self.jaro_rows(
                qw, [self.wide_corpus[i] for i in wsample], JARO_PW)):
            raise AssertionError("jaro_winkler wide distances != oracle on "
                                 "sampled rows")
        vals, ids = wide.topk(qw, 10)
        self.check_topk_sampled(qw, self.wide_corpus, vals, ids, wsample,
                                10, "jaro_winkler wide topk", "jaro_winkler")
        if self.kc.LAUNCHES["remap_pack"] == before:
            raise AssertionError("jaro wide route never launched remap_pack")
        del wide
        parts["wide"] = time.perf_counter() - t_part
        parts["wide_oracle"] = self.oracle_s - o_part
        t_part = time.perf_counter()
        # the library: one query against N_LIB strings (the scanner,
        # whose 1.0 - d is the similarity, as in the JAX package), and the
        # scalar scores
        sub = corpus[:N_LIB]
        res = jaro_winkler.BatchComparator(q0, JARO_LIB_PW).similarities(sub)
        rows = np.unique(np.r_[rng.choice(N_LIB, N_SAMPLE, replace=False),
                               np.argsort(res.values)[-64:]])
        if not (np.array_equal(res.values[rows], 1.0 - self.jaro_rows(
                q0, [sub[i] for i in rows], JARO_LIB_PW))
                and res.valid.all()):
            raise AssertionError("jaro_winkler BatchComparator.similarities "
                                 "!= oracle on sampled rows")
        enc = self.codec.encode_one
        for s1, s2 in (("martha", "marhta"), ("dwayne", "duane"),
                       (q0, sub[int(np.argmax(res.values))])):
            sim = self.oracle.jaro(enc(s1), enc(s2))
            got = (jaro.similarity(s1, s2), jaro.distance(s1, s2),
                   jaro_winkler.similarity(s1, s2, prefix_weight=0.2))
            if got != (sim, 1.0 - sim, self.oracle.jaro_winkler(
                    enc(s1), enc(s2), 0.2)):
                raise AssertionError(f"jaro scalar scores {s1!r} {s2!r}: "
                                     f"{got}")
        self.sync()
        parts["library"] = time.perf_counter() - t_part
        self.emit_phase({"phase": "jaro", "corpus": N_SERVE, "bucket": LB,
                         "long_corpus": len(long_corpus),
                         "wide_corpus": N_WIDE,
                         "scanner_build_s": t_build, "long_build_s": t_long,
                         "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "long_topk_s": long_s, "parts_s": parts,
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})

    # ------------------------------------------------------------ phase 12
    def phase_dam(self):
        """Damerau-Levenshtein on its main path: ``ScanService(metric=
        "damerau_levenshtein")`` over the serve corpus behind
        ``make_server`` -- ``/topk`` with no cutoff for the three anchors
        (whole corpus) and a random query (sampled rows), ``/topk`` under
        cutoffs 2, 7 and 15 (the band at radius 3, 7 and 15; whole
        corpus), ``/distances`` plain (every row within the Levenshtein
        bounds, ``lev / 2 <= d <= lev``, sampled and planted rows exact)
        and under cutoff 7 (whole corpus), ``/batch`` of 20 queries
        (N_BATCH_SAMPLE sampled rows and the planted ones); the library's
        ``distance_many`` over N_LIB strings (every row) and its scalar
        scores; a ``CorpusScanner`` over the Cyrillic corpus (K2, then K9
        in local mode: sampled rows, top-k, cutoff 3); one over the long
        corpus: top-k for the 64- and 300-char queries (the full form)
        and the ~4,000-char query under cutoff 15 (the band; whole
        corpus); and the ~4,000-char query in full over the last DAM_ODD
        bucket-6000 texts (top-k, whole slice).  Whole-corpus checks
        compute the oracle only on rows that can lie within the bound
        (:meth:`window_truth`).  The full ~4,000-char query over the whole
        long corpus (~2.4e12 cells) runs in the timing phase, held against
        the plain version on its shortest texts, not against the
        oracle."""
        from rapidfuzz_tpu_torch.distance import damerau_levenshtein as dl
        from rapidfuzz_tpu_torch.parallel import CorpusScanner
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 9)
        t_start = time.perf_counter()
        corpus = self.serve_corpus
        lens = np.array([len(s) for s in corpus])
        t0 = time.perf_counter()
        service = ScanService(corpus, metric=DAM, bucket=LB, device=self.dev)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad or "distances_hint" in warm:
            raise AssertionError(f"damerau warmup routes: {warm}")
        queries, levs = self.serve_queries, self.serve_lev
        sample = np.unique(np.r_[rng.choice(N_SERVE, N_SAMPLE,
                                            replace=False),
                                 self.serve_planted])
        call, stop, timings = self.serve_http(service)
        try:
            for qi, (q, lev) in enumerate(zip(queries, levs)):
                out = call("/topk", {"query": q, "k": 10})
                if qi < len(self.serve_anchors):
                    self.check_topk_window(q, corpus, lens, out["values"],
                                           out["indices"], 10,
                                           f"dam /topk anchor {qi}", DAM,
                                           lev)
                else:
                    self.check_topk_sampled(q, corpus, out["values"],
                                            out["indices"], sample, 10,
                                            "dam /topk random", DAM)
                if out["strings"] != [corpus[i] for i in out["indices"]]:
                    raise AssertionError("dam /topk strings mismatch")
            for qi, cut in ((0, 2), (1, 7), (2, 15)):
                q, lev = queries[qi], levs[qi]
                out = call("/topk", {"query": q, "k": 10,
                                     "score_cutoff": cut})
                rows, dw = self.window_truth(q, corpus, lens, cut, DAM, lev)
                keep = dw <= cut
                order = np.lexsort((rows[keep], dw[keep]))[:10]
                if not order.size or \
                        out["indices"] != rows[keep][order].tolist() or \
                        out["values"] != dw[keep][order].tolist():
                    raise AssertionError(f"dam /topk cutoff {cut}: "
                                         f"{out['values']} "
                                         f"{out['indices']} != oracle")
            q0, lev0 = queries[0], levs[0]
            d = np.asarray(call("/distances", {"query": q0})["values"])
            lo = np.maximum(np.abs(lens - len(q0)), (lev0 + 1) // 2)
            if not ((d >= lo).all() and (d <= lev0).all()):
                raise AssertionError("dam /distances outside the "
                                     "Levenshtein bounds")
            if not np.array_equal(d[sample], self.oracle_rows(
                    q0, [corpus[i] for i in sample], DAM)):
                raise AssertionError("dam /distances != oracle on sampled "
                                     "rows")
            if not (d < lev0).any():
                raise AssertionError("dam /distances never beat "
                                     "Levenshtein")
            out = call("/distances", {"query": q0, "score_cutoff": 7})
            self.check_cutoff_window(q0, corpus, lens, out, 7,
                                     "dam /distances cutoff 7", metric=DAM,
                                     lev=lev0)
            bq = list(queries)
            while len(bq) < 20:
                n = int(rng.integers(33, LB + 1))
                bq.append(rng.integers(97, 123, n, dtype=np.uint8)
                          .tobytes().decode("ascii"))
            out = call("/batch", {"queries": bq, "k": 10})
            bsample = np.unique(np.r_[rng.choice(N_SERVE, N_BATCH_SAMPLE,
                                                 replace=False),
                                      self.serve_planted])
            for qi, q in enumerate(bq):
                self.check_topk_sampled(q, corpus, out["values"][qi],
                                        out["indices"][qi], bsample, 10,
                                        f"dam /batch query {qi}", DAM)
        finally:
            stop()
        del service
        parts = {"serve": time.perf_counter() - t_start,
                 "serve_oracle": self.oracle_s - self.oracle_mark}
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the library: one query against N_LIB strings (the scanner), and
        # the scalar scores
        sub = corpus[:N_LIB]
        truth = self.oracle_rows(q0, sub, DAM)
        res = dl.distance_many([q0], sub)
        if not (np.array_equal(res.values, truth) and res.valid.all()):
            raise AssertionError("damerau_levenshtein.distance_many != "
                                 "oracle")
        for s1, s2, want in (("CA", "ABC", 2), ("CA", "AC", 1),
                             (q0, sub[int(np.argmin(truth))],
                              int(truth.min()))):
            m = max(len(s1), len(s2))
            got = (dl.distance(s1, s2), dl.similarity(s1, s2),
                   dl.normalized_distance(s1, s2))
            if got != (want, m - want, want / m):
                raise AssertionError(f"damerau scalar scores {s1!r} "
                                     f"{s2!r}: {got}")
        # the Cyrillic corpus: K2's remap, then K9 in local mode
        before = self.kc.LAUNCHES["remap_pack"]
        wide = CorpusScanner(self.wide_corpus, metric=DAM, bucket=LB,
                             device=self.dev)
        qw = self.wide_query_str
        wsample = rng.choice(N_WIDE, N_SAMPLE, replace=False)
        wtruth = self.oracle_rows(qw, [self.wide_corpus[i] for i in wsample],
                                  DAM)
        if not np.array_equal(wide.distances(qw)[wsample], wtruth):
            raise AssertionError("damerau wide distances != oracle on "
                                 "sampled rows")
        res = wide.distances(qw, score_cutoff=3)
        ok = wtruth <= 3
        if not (np.array_equal(res.valid[wsample], ok) and ok.any()
                and np.array_equal(res.values[wsample][ok], wtruth[ok])):
            raise AssertionError("damerau wide cutoff 3 != oracle on "
                                 "sampled rows")
        vals, ids = wide.topk(qw, 10)
        self.check_topk_sampled(qw, self.wide_corpus, vals, ids, wsample,
                                10, "damerau wide topk", DAM)
        if self.kc.LAUNCHES["remap_pack"] == before:
            raise AssertionError("damerau wide route never launched "
                                 "remap_pack")
        del wide
        parts["library_wide"] = time.perf_counter() - t_part
        parts["library_wide_oracle"] = self.oracle_s - o_part
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the long texts: the full form over buckets > 128 (64 and 300
        # chars), the band with the ~4,000-char query under cutoff 15
        qs = self.long_queries
        long_corpus, long_lens = self.long_corpus, self.long_lens
        t0 = time.perf_counter()
        long_sc = CorpusScanner(long_corpus, metric=DAM, bucket=LONG_LB,
                                device=self.dev)
        t_long = time.perf_counter() - t0
        long_s = {}
        for key in ("q64", "q300"):
            t0 = time.perf_counter()
            vals, ids = long_sc.topk(qs[key], 10)
            long_s[key] = time.perf_counter() - t0
            self.check_topk_window(qs[key], long_corpus, long_lens, vals,
                                   ids, 10, f"dam long topk {key}", DAM)
        q4k = qs["q4k"]
        t0 = time.perf_counter()
        res = long_sc.distances(q4k, score_cutoff=15)
        long_s["q4k_cutoff15"] = time.perf_counter() - t0
        self.check_cutoff_window(q4k, long_corpus, long_lens,
                                 {"valid": res.valid, "values": res.values},
                                 15, "dam long cutoff 15", metric=DAM)
        del long_sc
        # the full ~4,000-char query over a slice of the bucket-6000 texts
        # (the near copies of it among them)
        odd_corpus = self.odd_corpus[-DAM_ODD:]
        odd_lens = self.odd_lens[-DAM_ODD:]
        odd = CorpusScanner(odd_corpus, metric=DAM, bucket=ODD_LB,
                            device=self.dev)
        t0 = time.perf_counter()
        vals, ids = odd.topk(q4k, 10)
        long_s["q4k_odd"] = time.perf_counter() - t0
        self.check_topk_window(q4k, odd_corpus, odd_lens, vals, ids, 10,
                               f"dam bucket {ODD_LB} topk q4k", DAM)
        del odd
        self.sync()
        parts["long"] = time.perf_counter() - t_part
        parts["long_oracle"] = self.oracle_s - o_part
        self.emit_phase({"phase": "dam", "corpus": N_SERVE, "bucket": LB,
                         "long_corpus": len(long_corpus),
                         "odd_corpus": len(odd_corpus),
                         "wide_corpus": N_WIDE, "scanner_build_s": t_build,
                         "long_build_s": t_long, "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "long_topk_s": long_s, "parts_s": parts,
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})
        del self.serve_lev

    # ------------------------------------------------------------ phase 13
    def phase_partial(self):
        """``fuzz.partial_ratio`` on its main path:
        ``ScanService(metric="partial_ratio")`` over the serve corpus behind
        ``make_server`` -- ``/topk`` for a 12-char piece of an anchor (every
        row whose score is 1.0, the query inside it or it inside the query,
        found on the host over the whole corpus; sampled rows) and for the
        64-char anchor (nearly every row shorter: the swapped role; sampled
        rows), ``/distances`` plain and under cutoff 0.1 (sampled and
        planted rows), ``/batch`` of both queries (equal to the ``/topk``
        answers); a ``CorpusScanner`` over the long corpus with the 64-char
        query and one over the first N_ODD bucket-6000 texts with the
        300-char query (top-k on sampled rows: the oracle's brute force
        takes ~0.3 s a pair at 300 chars); one over the Cyrillic corpus (K2,
        then K10 in local mode); and ``fuzz.partial_ratio_many`` and
        ``partial_ratio_alignment_many`` over N_LIB strings, the positions
        held against the port's scalar ``partial_ratio_alignment``.  Every
        value is the oracle's ``1.0 - partial_ratio`` bit for bit."""
        from rapidfuzz_tpu_torch import fuzz
        from rapidfuzz_tpu_torch.parallel import CorpusScanner
        from rapidfuzz_tpu_torch.serve import ScanService

        rng = np.random.default_rng(self.seed + 10)
        t_start = time.perf_counter()
        corpus = self.serve_corpus
        t0 = time.perf_counter()
        service = ScanService(corpus, metric=PR, bucket=LB, device=self.dev)
        t_build = time.perf_counter() - t0
        warm = service.warmup(full=True)
        bad = {k: v for k, v in warm.items() if not isinstance(v, float)}
        if bad or "distances_hint" in warm:
            raise AssertionError(f"partial warmup routes: {warm}")
        q64 = self.serve_anchors[0]
        q12 = q64[20:32]
        sample = np.unique(np.r_[rng.choice(N_SERVE, N_SAMPLE,
                                            replace=False),
                                 self.serve_planted])
        call, stop, timings = self.serve_http(service)
        try:
            answers = {}
            for q in (q12, q64):
                out = call("/topk", {"query": q, "k": 10})
                answers[q] = out
                self.check_topk_sampled(q, corpus, out["values"],
                                        out["indices"], sample, 10,
                                        f"partial /topk len {len(q)}", PR)
                if out["strings"] != [corpus[i] for i in out["indices"]]:
                    raise AssertionError("partial /topk strings mismatch")
            # score 1.0 exactly where the query lies in the row or the row
            # (non-empty, shorter) in the query: the whole-corpus top-k of
            # the 12-char query
            exact = [i for i, s in enumerate(corpus)
                     if (q12 in s if len(s) >= len(q12) else s and s in q12)]
            out = answers[q12]
            if not (len(exact) >= 10 and out["indices"] == exact[:10]
                    and out["values"] == [0.0] * 10):
                raise AssertionError(f"partial /topk len 12: "
                                     f"{out['indices']} != {exact[:10]}")
            d = np.asarray(call("/distances", {"query": q64})["values"])
            if not np.array_equal(d[sample], self.oracle_rows(
                    q64, [corpus[i] for i in sample], PR)):
                raise AssertionError("partial /distances != oracle on "
                                     "sampled rows")
            cut = 0.1
            out = call("/distances", {"query": q64, "score_cutoff": cut})
            valid = np.asarray(out["valid"])
            if not (np.array_equal(np.asarray(out["values"]), d)
                    and np.array_equal(valid, d <= cut) and valid.any()):
                raise AssertionError(f"partial /distances score_cutoff={cut}"
                                     " != the plain distances' mask")
            out = call("/batch", {"queries": [q12, q64], "k": 10})
            for qi, q in enumerate((q12, q64)):
                if (out["values"][qi] != answers[q]["values"]
                        or out["indices"][qi] != answers[q]["indices"]):
                    raise AssertionError(f"partial /batch query {qi} != "
                                         "/topk")
        finally:
            stop()
        del service
        parts = {"serve": time.perf_counter() - t_start,
                 "serve_oracle": self.oracle_s - self.oracle_mark}
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the long texts: the 64-char query over the long corpus, the
        # 300-char one over the bucket-6000 texts
        qs = self.long_queries
        long_s = {}
        for key, texts, bucket, nsample in (
                ("q64", self.long_corpus, LONG_LB, LONG_SAMPLE),
                ("q300", self.odd_corpus, ODD_LB, PARTIAL_ODD_SAMPLE)):
            sc = CorpusScanner(texts, metric=PR, bucket=bucket,
                               device=self.dev)
            t0 = time.perf_counter()
            vals, ids = sc.topk(qs[key], 10)
            long_s[key] = time.perf_counter() - t0
            lsample = rng.choice(len(texts), nsample, replace=False)
            self.check_topk_sampled(qs[key], texts, vals, ids, lsample, 10,
                                    f"partial long topk {key}", PR)
            del sc
        parts["long"] = time.perf_counter() - t_part
        parts["long_oracle"] = self.oracle_s - o_part
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the Cyrillic corpus: K2's remap, then K10 in local mode
        before = self.kc.LAUNCHES["remap_pack"]
        wide = CorpusScanner(self.wide_corpus, metric=PR, bucket=LB,
                             device=self.dev)
        qw = self.wide_query_str
        wsample = rng.choice(N_WIDE, N_SAMPLE, replace=False)
        if not np.array_equal(wide.distances(qw)[wsample], self.oracle_rows(
                qw, [self.wide_corpus[i] for i in wsample], PR)):
            raise AssertionError("partial wide distances != oracle on "
                                 "sampled rows")
        vals, ids = wide.topk(qw, 10)
        self.check_topk_sampled(qw, self.wide_corpus, vals, ids, wsample, 10,
                                "partial wide topk", PR)
        if self.kc.LAUNCHES["remap_pack"] == before:
            raise AssertionError("partial wide route never launched "
                                 "remap_pack")
        del wide
        parts["wide"] = time.perf_counter() - t_part
        parts["wide_oracle"] = self.oracle_s - o_part
        t_part, o_part = time.perf_counter(), self.oracle_s
        # the library: one K10 launch for the scores, one for the windows
        sub = corpus[:N_LIB]
        res = fuzz.partial_ratio_many(q12, sub, score_cutoff=0.5)
        al = fuzz.partial_ratio_alignment_many(q12, sub)
        rows = np.unique(np.r_[rng.choice(N_LIB, N_SAMPLE, replace=False),
                               np.argsort(res.values)[-64:]])
        truth = 1.0 - self.oracle_rows(q12, [sub[i] for i in rows], PR)
        if not (np.array_equal(res.values[rows], truth)
                and np.array_equal(res.valid, res.values >= 0.5)
                and [al[i].score for i in rows] == truth.tolist()):
            raise AssertionError("partial_ratio_many / _alignment_many != "
                                 "oracle on sampled rows")
        lens = np.array([len(s) for s in sub])
        for i in np.r_[rows[:4], np.flatnonzero(lens < len(q12))[:4],
                       int(np.argmax(res.values))]:
            if al[i] != fuzz.partial_ratio_alignment(q12, sub[i]):
                raise AssertionError(f"partial alignment row {i}: {al[i]} "
                                     "!= the scalar sweep's")
        self.sync()
        parts["library"] = time.perf_counter() - t_part
        parts["library_oracle"] = self.oracle_s - o_part
        self.emit_phase({"phase": "partial", "corpus": N_SERVE, "bucket": LB,
                         "long_corpus": len(self.long_corpus),
                         "odd_corpus": len(self.odd_corpus),
                         "wide_corpus": N_WIDE, "scanner_build_s": t_build,
                         "warmup_s": warm,
                         "request_s": {k: v for k, v in timings.items()},
                         "long_topk_s": long_s, "parts_s": parts,
                         "launches": dict(self.kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})
        del self.long_corpus, self.wide_corpus, self.odd_corpus

    # ------------------------------------------------------------ phase 14
    def phase_pair(self):
        """One long pair on the library's device scalar route
        (``RAPIDFUZZ_TPU_SCALAR_BACKEND=device``; K11 and the hint ladder):
        the OCR fixture (106,514 x 107,244 chars) gives 5,278 with no
        cutoff (3 rungs: R = 1, 2, 4), ``None`` under cutoff 2,500 (1 rung)
        and 5,278 under hint 0 (3 rungs); ``similarity`` and
        ``normalized_similarity`` under cutoffs (bands of R = 4 and 3) equal
        the same calls on the host oracle's route
        (``levenshtein_uniform_auto``); and two independent PAIR_FAR-char
        strings, whose distance passes the band's ceiling, climb 4 rungs and
        then take the host route, equal to the oracle.  The rungs of each
        call are its ``lev_pair`` launches."""
        from rapidfuzz_tpu_torch.distance import levenshtein as L

        kc, prk = self.kc, self.prk
        t_start = time.perf_counter()
        fix = np.load(OCR)
        a, b = fix["ex1"].astype(np.int64), fix["ex2"].astype(np.int64)
        rng = np.random.default_rng(self.seed + 11)
        far = (rng.integers(97, 123, PAIR_FAR), rng.integers(97, 123,
                                                             PAIR_FAR))
        mx = max(a.size, b.size)
        calls = (
            ("distance", L.distance, (a, b), {}, OCR_DIST, 3),
            ("distance_cutoff", L.distance, (a, b),
             {"score_cutoff": OCR_CUT}, None, 1),
            ("distance_hint0", L.distance, (a, b), {"score_hint": 0},
             OCR_DIST, 3),
            ("similarity_cutoff", L.similarity, (a, b),
             {"score_cutoff": mx - OCR_DIST - 1000}, None, 1),
            ("normalized_similarity_cutoff", L.normalized_similarity,
             (a, b), {"score_cutoff": 0.95}, None, 1),
            ("far_pair", L.distance, far, {}, None, 4))
        out = {}
        key = "RAPIDFUZZ_TPU_SCALAR_BACKEND"
        before_env = os.environ.get(key)
        try:
            # every call on the host oracle's route first (the "cpp"
            # backend), then on the device route
            os.environ[key] = "cpp"
            t0 = time.perf_counter()
            truth = {name: fn(*pair, **kw)
                     for name, fn, pair, kw, _, _ in calls}
            self.oracle_s += time.perf_counter() - t0
            if truth["distance"] != OCR_DIST or truth["distance_hint0"] \
                    != OCR_DIST or truth["distance_cutoff"] is not None:
                raise AssertionError(f"pair: the oracle's OCR answers "
                                     f"{truth}")
            if truth["far_pair"] <= prk.max_cutoff(prk.ROWS):
                raise AssertionError(f"pair: the far pair's distance "
                                     f"{truth['far_pair']} is within the "
                                     "band")
            os.environ[key] = "device"
            for name, fn, pair, kw, want, rungs in calls:
                n0 = kc.LAUNCHES["lev_pair"]
                t0 = time.perf_counter()
                got = fn(*pair, **kw)
                sec = time.perf_counter() - t0
                n = kc.LAUNCHES["lev_pair"] - n0
                out[name] = {"value": got, "rungs": n, "s": sec}
                if got != truth[name] or (want is not None and got != want):
                    raise AssertionError(f"pair {name}: {got} != the "
                                         f"oracle's {truth[name]}")
                if n != rungs:
                    raise AssertionError(f"pair {name}: {n} rungs, "
                                         f"expected {rungs}")
        finally:
            if before_env is None:
                del os.environ[key]
            else:
                os.environ[key] = before_env
        self.sync()
        self.emit_phase({"phase": "pair", "lengths": [int(a.size),
                                                      int(b.size)],
                         "far_lengths": PAIR_FAR, "calls": out,
                         "launches": dict(kc.LAUNCHES),
                         "seconds": time.perf_counter() - t_start})

    # ------------------------------------------------------------ phase 15
    def phase_timing(self, clock_mhz: float):
        """Each kernel and its plain version at its main-path shape, with
        the least time the card could take for the same work: the
        short-text kernels at N_TIMING candidates of the serve corpus
        (bucket 64, len-64 query), the long routes at the long phase's
        corpora (bucket 8192 and bucket 6000, the ~4,000-char query under
        cutoff 15 for the bands, the len-64 query for K1).  The plain
        versions of the long routes walk 6,000-8,192 steps in Python, so
        they run once, with no warm-up run."""
        torch, lk, bk = self.torch, self.lk, self.bk
        t_start = time.perf_counter()
        sc = self.serve_scanner
        n = N_TIMING
        cand = sc.cand[:, :n].contiguous()
        lb = sc.lb[:n].contiguous()
        q = sc._encode_query(self.serve_query)
        las, tabs = lk.stage_query(q, "local", self.dev)
        rng = np.random.default_rng(self.seed + 3)
        qs = [q] + [rng.integers(97, 123, int(rng.integers(33, LB + 1)))
                    for _ in range(15)]
        lasq, tabsq = lk.stage_queries(qs, "local", self.dev)
        ws = bk.table_words(q.size, LB)
        rows, bounds, plain_n, extra = {}, {}, {}, {}
        int_ops_s = INT32_LANES * clock_mhz * 1e6

        def timed(name, kernel, plain, reps, work, warm=True, every=1,
                  row=None, kwarm=True, cols=None):
            """Times ``kernel`` (after a warm-up run unless ``kwarm`` is
            false) and ``plain`` (likewise ``warm``) and holds the output
            of the kernel's last timed run, on every ``every``-th
            candidate (or on the slice ``cols`` of them), against
            ``plain``, which the caller gives those candidates alone where
            the whole shape would take it over 10 s.  Kept under ``row``
            (default: ``name``)."""
            sel = cols if cols is not None else slice(None, None, every)
            row = row or name
            last = [None]

            def run():
                last[0] = kernel()

            ms = cuda_ms(torch, run, reps, warm=kwarm)
            ref = []
            pms = cuda_ms(torch, lambda: ref.append(plain()), 1, warm=warm)
            self.compare(name, last[0][..., sel], ref[-1],
                         f"{row} timing inputs")
            rows[row] = (ms, pms)
            if every > 1 or cols is not None:
                plain_n[row] = int(ref[-1].shape[-1])
            nbytes, ops = work
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = ops / int_ops_s * 1e3
            bounds[row] = (max(t_bytes, t_ops),
                           "bytes" if t_bytes >= t_ops else "operations")

        def scan_work(name, lbv, words, nq=1, table_words=None):
            """Bytes and u32 operations of a K1 launch: each candidate's
            packed chars, length and output once, the PM table once, and
            OPS[name] per word and text step."""
            steps = int(lbv.to(torch.int64).sum())
            nbytes = (int(((lbv.to(torch.int64) + 3) // 4).sum()) * 4
                      + lbv.numel() * 4 * (1 + nq)
                      + nq * (table_words or words) * 1024)
            return nbytes, OPS[name] * words * nq * steps

        def lev_layout(lbv, W, row, nq=1, kind="lev"):
            """``extra[row + "_layout_bound_ms"]``: the instructions K1
            (K6, K4: ``kind`` "osa", "lcs") runs beyond its bound's OPS
            per query word and text step, over this run's data: the
            register form (LEV_REG_STEP_OPS a thread and step) runs a warp
            of 32 consecutive candidates to its longest; the tile form
            (TILE_STEP_OPS a lane and step) a warp of 32 // G candidates,
            per strip, nmax + G' - 1 steps of all 32 lanes (G' the strip's
            lanes with query words).  That is the per-step work beside the
            words, the words past the query, the ramps, the idle lanes and
            the wait for a warp's longest text."""
            l64 = lbv.to(torch.int64)
            mod = {"lev": lk, "osa": self.ok, "lcs": self.ck}[kind]
            if W <= mod.MAX_REG_W:
                per, ops, ramps = 32, LEV_REG_STEP_OPS[W], [0]
            else:
                L, G, S = mod.tile_plan(W)
                per, ops = 32 // G, TILE_STEP_OPS[kind]
                ramps = [-(-min(S, W - w0) // L) - 1
                         for w0 in range(0, W, S)]
            nmax = torch.cat([l64, l64.new_zeros((-l64.numel()) % per)])
            nmax = nmax.view(-1, per).max(1).values
            steps = sum(int(torch.where(nmax > 0, nmax + r, 0).sum())
                        for r in ramps)
            layout = nq * (steps * 32 * ops
                           - OPS[f"{kind}_scan"] * W * int(l64.sum()))
            extra[f"{row}_layout_bound_ms"] = layout / int_ops_s * 1e3

        def band_walks(lbv, la, cut):
            """The steps K3 walks a candidate: its length where the final
            masks leave its answer open (not empty, within ``cut`` of
            ``la``), else 0."""
            l64 = lbv.to(torch.int64)
            return torch.where((l64 > 0) & ((l64 - la).abs() <= cut), l64, 0)

        def k3_work(name, lbv, la, cut, bw, table_words):
            """Bytes and u32 operations of a K3 launch over this run's
            data: every candidate's length and output once, the packed
            chars of the texts whose answer needs the band (band_walks),
            the PM table once, and OPS[name] per band word and step of
            those texts."""
            n = band_walks(lbv, la, cut)
            nbytes = (int(((n + 3) // 4).sum()) * 4 + lbv.numel() * 8
                      + table_words * 1024)
            return nbytes, OPS[name] * bw * int(n.sum())

        def band_layout(lbv, la, cut, semi, bw, row):
            """``extra[row + "_layout_bound_ms"]``: what K3 issues beyond
            its bound's OPS per band word and step, over this run's data:
            a warp (32 consecutive candidates) steps to its longest walk
            (band_walks), LEV_BAND_STEP_OPS["phase"] a step in the chunks
            that hold the horizontal phase (band_kernel.CHUNK steps each)
            and ["diag"] in the others."""
            n = band_walks(lbv, la, cut)
            nmax = torch.cat([n, n.new_zeros((-n.numel()) % 32)])
            nmax = nmax.view(-1, 32).max(1).values
            S = bk.CHUNK
            pstart = max(la - semi, 0)
            c0, c1 = pstart // S, (pstart + 32 * bw - 2) // S
            hz = (nmax.clamp(max=(c1 + 1) * S) - c0 * S).clamp(min=0)
            issue = 32 * (LEV_BAND_STEP_OPS["diag"] * int((nmax - hz).sum())
                          + LEV_BAND_STEP_OPS["phase"] * int(hz.sum()))
            layout = issue - OPS[row] * bw * int(n.sum())
            extra[f"{row}_layout_bound_ms"] = layout / int_ops_s * 1e3

        def band_chain(sc, la, cut, staged, row):
            """``extra[row + "_chain_floor_ms"]``: one warp alone over the
            32 longest walks of ``sc``'s texts (band_walks), the least
            time a launch over them can take: their steps run one after
            another."""
            n = band_walks(sc.lb, la, cut)
            far = torch.argsort(n, descending=True)[:32]
            far = far[n[far] > 0]
            c32, l32 = sc.cand[:, far].contiguous(), sc.lb[far].contiguous()
            fn = (bk.lev_banded_stream_1v_many if row == "lev_band_long"
                  else bk.lev_banded_1v_many)
            extra[f"{row}_chain_floor_ms"] = cuda_ms(
                torch, lambda: fn(q4k, c32, l32, cutoff=cut, staged=staged),
                5)
            extra[f"{row}_chain_steps"] = int(n.max())

        lev_layout(lb, lk.words(q.size), "lev_scan")
        lev_layout(lb, 2, "lev_scan_nq", nq=16)
        band_layout(lb, q.size, 15, 15, 1, "lev_band")
        timed("lev_scan",
              lambda: lk.lev_1v_many(q, cand, lb, staged=(las, tabs)),
              lambda: lk.lev_scan_plain(las, tabs[None], cand, lb)[0], 20,
              scan_work("lev_scan", lb, lk.words(q.size)))
        timed("lev_scan_nq",
              lambda: lk.lev_nq_many(qs, cand, lb, staged=(lasq, tabsq)),
              lambda: lk.lev_scan_plain(lasq, tabsq, cand, lb), 10,
              scan_work("lev_scan_nq", lb, 2, nq=16))
        timed("lev_band",
              lambda: bk.lev_banded_1v_many(q, cand, lb, cutoff=15,
                                            staged=(las, tabs)),
              lambda: bk.lev_band_plain(q.size, 15, 1, tabs[:ws], cand, lb),
              20, k3_work("lev_band", lb, q.size, 15, 1, ws))
        # K2 at the same candidate count: the wide corpus tiled to N_TIMING
        ct = self.wide_chars_t
        reps_w = -(-n // ct.shape[1])
        chars_t = ct.repeat(1, reps_w)[:, :n].contiguous()
        vocab = torch.from_numpy(lk.query_vocab(self.wide_query)[0]).to(
            self.dev)
        timed("remap_pack", lambda: lk.remap_pack(chars_t, vocab),
              lambda: lk.remap_pack_plain(chars_t, vocab), 20,
              (chars_t.numel() * 5 + 512, OPS["remap_pack"] * chars_t.numel()))
        del chars_t
        # the long routes at the long phase's shapes
        long_sc, odd_sc = self.long_scanner, self.odd_scanner
        enc = {k: long_sc._encode_query(v)
               for k, v in self.long_queries.items()}
        q64, q4k = enc["q64"], enc["q4k"]
        l64 = lk.stage_query(q64, "local", self.dev)
        l4k = lk.stage_query(q4k, "local", self.dev)
        ws_long = bk.table_words(q4k.size, LONG_LB)
        ws_odd = bk.table_words(q4k.size, ODD_LB)
        lev_layout(long_sc.lb, 2, "lev_scan_long")
        band_layout(long_sc.lb, q4k.size, 15, 15, 1, "lev_band_long")
        band_layout(odd_sc.lb, q4k.size, 15, 15, 1, "lev_band_rt")
        band_chain(long_sc, q4k.size, 15, l4k, "lev_band_long")
        band_chain(odd_sc, q4k.size, 15, l4k, "lev_band_rt")
        timed("lev_scan_long",
              lambda: lk.lev_1v_many(q64, long_sc.cand, long_sc.lb,
                                     staged=l64),
              lambda: lk.lev_scan_plain(l64[0], l64[1][None], long_sc.cand,
                                        long_sc.lb)[0], 3,
              scan_work("lev_scan_long", long_sc.lb, 2), warm=False)
        timed("lev_band_long",
              lambda: bk.lev_banded_stream_1v_many(
                  q4k, long_sc.cand, long_sc.lb, cutoff=15, staged=l4k),
              lambda: bk.lev_band_plain(q4k.size, 15, 1, l4k[1][:ws_long],
                                        long_sc.cand, long_sc.lb), 3,
              k3_work("lev_band_long", long_sc.lb, q4k.size, 15, 1,
                        ws_long), warm=False)
        timed("lev_band_rt",
              lambda: bk.lev_banded_1v_many(
                  q4k, odd_sc.cand, odd_sc.lb, cutoff=15, staged=l4k),
              lambda: bk.lev_band_plain(q4k.size, 15, 1, l4k[1][:ws_odd],
                                        odd_sc.cand, odd_sc.lb, semi=15), 5,
              k3_work("lev_band_rt", odd_sc.lb, q4k.size, 15, 1, ws_odd),
              warm=False)
        # K4 and K5: the short scans at the serve corpus, the band at the
        # mid corpus (300-char query, cutoff 15), the long routes at the
        # long corpus
        ck, cbk = self.ck, self.cbk

        def band_work(name, lbv, la, bw, table_words, row=None):
            """Bytes and u32 operations of a K5 launch over this run's
            data: every candidate's length and output once, the PM table
            once, and the packed chars and OPS[name] per band word (plus
            LCS_BAND_STEP_OPS) of the min(lb, la + 16*bw) steps the
            exact stop leaves; the bound over every text's whole length
            goes beside it (extra[row + "_full_walk_bound_ms"])."""
            l64 = lbv.to(torch.int64)
            per = OPS[name] * bw + LCS_BAND_STEP_OPS
            fixed = lbv.numel() * 8 + table_words * 1024
            full = (int(((l64 + 3) // 4).sum()) * 4 + fixed,
                    per * int(l64.sum()))
            extra[f"{row or name}_full_walk_bound_ms"] = max(
                full[0] / HBM_BYTES_S, full[1] / int_ops_s) * 1e3
            n = l64.clamp(max=la + 16 * bw)
            return (int(((n + 3) // 4).sum()) * 4 + fixed,
                    per * int(n.sum()))

        timed("lcs_scan",
              lambda: ck.lcs_1v_many(q, cand, lb, staged=(las, tabs)),
              lambda: ck.lcs_scan_plain(tabs[None], cand, lb)[0], 20,
              scan_work("lcs_scan", lb, lk.words(q.size)))
        timed("lcs_scan_nq",
              lambda: ck.lcs_nq_many(qs, cand, lb, staged=(lasq, tabsq)),
              lambda: ck.lcs_scan_plain(tabsq, cand, lb), 10,
              scan_work("lcs_scan_nq", lb, 2, nq=16))
        mid = self.mid_scanner
        qm = mid._encode_query(self.mid_query)
        lm = lk.stage_query(qm, "local", self.dev)
        ws_mid = cbk.table_words(qm.size, MID_LB)
        timed("lcs_band",
              lambda: cbk.lcs_banded_1v_many(qm, mid.cand, mid.lb,
                                             cutoff=15, staged=lm),
              lambda: cbk.lcs_band_plain(1, lm[1][:ws_mid], mid.cand,
                                         mid.lb, qm.size), 10,
              band_work("lcs_band", mid.lb, qm.size, 1, ws_mid))
        timed("lcs_scan_long",
              lambda: ck.lcs_1v_many(q64, long_sc.cand, long_sc.lb,
                                     staged=l64),
              lambda: ck.lcs_scan_plain(l64[1][None], long_sc.cand,
                                        long_sc.lb)[0], 3,
              scan_work("lcs_scan_long", long_sc.lb, 2), warm=False)
        timed("lcs_band_long",
              lambda: cbk.lcs_banded_stream_1v_many(
                  q4k, long_sc.cand, long_sc.lb, cutoff=15, staged=l4k),
              lambda: cbk.lcs_band_plain(1, l4k[1][:ws_long], long_sc.cand,
                                         long_sc.lb, q4k.size), 3,
              band_work("lcs_band_long", long_sc.lb, q4k.size, 1, ws_long),
              warm=False)
        # K6 as K1: the short scans at the serve corpus, the long scan with
        # the len-64 query over the long corpus
        ok = self.ok
        timed("osa_scan",
              lambda: ok.osa_1v_many(q, cand, lb, staged=(las, tabs)),
              lambda: ok.osa_scan_plain(las, tabs[None], cand, lb)[0], 20,
              scan_work("osa_scan", lb, lk.words(q.size)))
        timed("osa_scan_nq",
              lambda: ok.osa_nq_many(qs, cand, lb, staged=(lasq, tabsq)),
              lambda: ok.osa_scan_plain(lasq, tabsq, cand, lb), 10,
              scan_work("osa_scan_nq", lb, 2, nq=16))
        timed("osa_scan_long",
              lambda: ok.osa_1v_many(q64, long_sc.cand, long_sc.lb,
                                     staged=l64),
              lambda: ok.osa_scan_plain(l64[0], l64[1][None], long_sc.cand,
                                        long_sc.lb)[0], 3,
              scan_work("osa_scan_long", long_sc.lb, 2), warm=False)
        # K7 as K1: its register form with the len-64 query at the serve
        # corpus (under WLEV_SERVE, as the wlev phase serves it) and over
        # the long corpus (under WLEV_SCAN); the bound counts the query's
        # positions, OPS per position and text step
        wk = self.wk

        def wlev(qq, c, lbv, w, staged):
            """K7 with the scanner's memory plan (its default budget)."""
            return wk.wlev_1v_many(qq, c, lbv, ins=w[0], dele=w[1],
                                   sub_cost=w[2], staged=staged)

        def wlev_layout(lbv, la, row):
            """``extra[row + "_layout_bound_ms"]``: the INT32-lane
            instructions K7 issues beyond its bound's OPS per query
            position and text step, over this run's data.  The register
            form (la <= MAX_REG_LA): a warp of 32 consecutive candidates
            runs to its longest text, each step WLEV_REG_STEP_OPS[W] a
            thread over the whole words up to la's.  The tile form: a warp
            of 32 // G candidates runs, per strip, nmax + G' - 1 steps of
            all 32 lanes (G' the strip's lanes with query positions), each
            TILE cells at OPS and WLEV_TILE_STEP_OPS for the step.  That
            is the hand-off, the char and the strip edge, the positions
            past la, the idle lanes, the ramps and the wait for a warp's
            longest text."""
            l64 = lbv.to(torch.int64)
            if la <= wk.MAX_REG_LA:
                per, ramps = 32, [0]
                ops = WLEV_REG_STEP_OPS[lk.words(la)]
            else:
                G = min(32, -(-la // wk.TILE))
                per = 32 // G
                ops = wk.TILE * WLEV_CELL_OPS + WLEV_TILE_STEP_OPS
                ramps = [min(G, -(-(la - cs) // wk.TILE)) - 1
                         for cs in range(0, la, wk.STRIP)]
            nmax = torch.cat([l64, l64.new_zeros((-l64.numel()) % per)])
            nmax = nmax.view(-1, per).max(1).values
            steps = sum(int(torch.where(nmax > 0, nmax + r, 0).sum())
                        for r in ramps)
            layout = steps * 32 * ops - WLEV_CELL_OPS * la * int(l64.sum())
            extra[f"{row}_layout_bound_ms"] = layout / int_ops_s * 1e3

        timed("wlev_scan",
              lambda: wlev(q, cand, lb, WLEV_SERVE, (las, tabs)),
              lambda: wk.wlev_scan_plain(q.size, tabs, cand, lb,
                                         *WLEV_SERVE), 5,
              scan_work("wlev_scan", lb, q.size,
                        table_words=lk.words(q.size)))
        # the register form at one, three and four words and the tile
        # form's first width (five lanes a candidate), at the same
        # candidates, each held on every WLEV_SLICE-th of them
        sl_cand = cand[:, ::WLEV_SLICE].contiguous()
        sl_lb = lb[::WLEV_SLICE].contiguous()
        wlev_layout(lb, q.size, "wlev_scan")
        for la in (32, 96, 128, 129):
            qw = rng.integers(97, 123, la)
            sw = lk.stage_query(qw, "local", self.dev)
            wlev_layout(lb, la, f"wlev_scan_la{la}")
            timed("wlev_scan", lambda: wlev(qw, cand, lb, WLEV_SERVE, sw),
                  lambda: wk.wlev_scan_plain(la, sw[1], sl_cand, sl_lb,
                                             *WLEV_SERVE), 5,
                  scan_work("wlev_scan", lb, la, table_words=lk.words(la)),
                  every=WLEV_SLICE, row=f"wlev_scan_la{la}")
        # over the long corpus: the len-64 query (the kernels line's row),
        # then the tile form at 299 chars (ten lanes a candidate) and at
        # 4,001 (four strips of a warp: 4 GiB of edge buffer, launched over
        # chunks under the scanner's 1 GiB plan, once, with no warm-up),
        # each timed output held against the plain version on every
        # LONG_SLICE[key]-th text (lengths as spread; the whole corpus
        # takes the plain version over 10 s)
        for key, reps in (("q64", 3), ("q300", 2), ("q4k", 1)):
            qk = enc[key]
            st = lk.stage_query(qk, "local", self.dev)
            every = LONG_SLICE[key]
            sl_cand = long_sc.cand[:, ::every].contiguous()
            sl_lb = long_sc.lb[::every].contiguous()
            row = "wlev_scan_long" if key == "q64" else \
                f"wlev_scan_long_{key}"
            wlev_layout(long_sc.lb, qk.size, row)
            before = self.kc.LAUNCHES["wlev_scan_long"]
            timed("wlev_scan_long",
                  lambda: wlev(qk, long_sc.cand, long_sc.lb, WLEV_SCAN, st),
                  lambda: wk.wlev_scan_plain(qk.size, st[1], sl_cand, sl_lb,
                                             *WLEV_SCAN), reps,
                  scan_work("wlev_scan_long", long_sc.lb, qk.size,
                            table_words=lk.words(qk.size)), warm=False,
                  every=every, kwarm=reps > 1, row=row)
            runs = reps + (reps > 1)
            scans = (self.kc.LAUNCHES["wlev_scan_long"] - before) // runs
            B = long_sc.lb.numel()
            chunk = B if qk.size <= wk.STRIP else \
                wk.edge_chunk(long_sc.cand.shape[0] * 4, B)
            if scans != -(-B // chunk) or (key == "q4k" and scans < 2):
                raise AssertionError(f"wlev_scan_long {key}: {scans} "
                                     "launches per scan")
            extra[f"wlev_scan_long_{key}_launches"] = scans
            del sl_cand, sl_lb
        # K8 as K1: its register form at the serve corpus (the len-64
        # query, and 16 queries per launch) and with the len-64 query over
        # the long corpus, its plain version there on every
        # LONG_SLICE["q64"]-th text; the bound counts the text steps this
        # data needs (the plain version's step rows over the whole shape)
        jk = self.jk

        def jaro_work(lbv, words, nq, st, row, tab_bytes=0):
            """Bytes and operations of a K8 launch: the packed chars each
            candidate's passes reach (read once), its length, two int32
            outputs per query, the PM tables once (and the cursor form's
            staged tables, ``tab_bytes``); per pass-1 step JARO_OPS's (its
            register form's per query word and step) or, given
            ``tab_bytes``, JARO_CURSOR_OPS's, the flag test per pass-2
            step and the pop per flagged char.  The cursor form's replay of
            pass 1 goes to ``extra[row + "_replay_bound_ms"]``."""
            reach = st[4].to(torch.int64).amax(0)
            nbytes = (int(((reach + 3) // 4).sum()) * 4
                      + lbv.numel() * 4 * (1 + 2 * nq) + nq * words * 1024
                      + tab_bytes)
            steps1, steps2, pops = (int(st[i].to(torch.int64).sum())
                                    for i in (2, 3, 5))
            if tab_bytes:
                step, claim = JARO_CURSOR_OPS["step"], JARO_CURSOR_OPS["claim"]
                pop = JARO_CURSOR_OPS["pop"]
                extra[f"{row}_replay_bound_ms"] = \
                    (step * steps2 + claim * pops) / int_ops_s * 1e3
            else:
                (w1, s1), (wp, sp) = JARO_OPS["pass1"], JARO_OPS["pop"]
                step, claim, pop = w1 * words + s1, 0, wp * words + sp
            ops = (step * steps1 + JARO_OPS["flag_test"] * steps2
                   + (claim + pop) * pops)
            extra[f"{row}_steps"] = [steps1, steps2, pops]
            return nbytes, ops

        def jaro_cursor_steps(qk, st):
            """``jaro_scan_plain(..., steps=True)``'s rows for one long
            query over the whole long corpus (common, 0, pass-1 steps,
            pass-2 steps, chars reached, flagged chars past the prefix),
            by the cursor walk in plain PyTorch over the staged tables: a
            step finds the char's first position at or above the window's
            lower end by one search of the positions sorted by (row,
            position), O(B) a step where the plain version's is O(W B)."""
            la, W = qk.size, st[1].shape[0]
            tab, smax = jk.cursor_tables(st[1][None])
            o_off, o_pos, _, _ = jk.cursor_layout(W, smax)
            raw = tab[0].view(torch.uint8)
            isz = 2 if jk.idx16(W) else 4
            wide = torch.int16 if isz == 2 else torch.int32
            PP = 32 * W + smax + 1
            slot = raw[:o_off].view(torch.int16).to(torch.int64)
            off = raw[o_off:o_off + isz * smax].view(wide).to(torch.int64)
            pos = (raw[o_pos:o_pos + isz * PP].view(wide).to(torch.int64)
                   & ((1 << (8 * isz)) - 1))
            sent = (1 << (8 * isz)) - 1
            row_of = torch.cumsum(pos == sent, 0) - (pos == sent).long()
            key = row_of * (1 << 32) + pos
            qrow = torch.full((32 * W + 1,), -2, dtype=torch.int64,
                              device=self.dev)
            real = pos != sent
            qrow[pos[real]] = row_of[real]
            cand, lbv = long_sc.cand, long_sc.lb
            n = lbv.to(torch.int64)
            bound = (torch.clamp(n, min=la) // 2 - 1).clamp(min=0)
            len1, len2 = torch.clamp(n + bound, max=la), \
                torch.clamp(la + bound, max=n)
            plim = torch.minimum(len1, len2)
            z = torch.zeros_like(n)
            pref, common, it1, last = z.clone(), z.clone(), z.clone(), z - 1
            cur = off[None, :].repeat(n.numel(), 1) if smax else None
            still = plim > 0
            for j in range(int(len2.max())):
                if j % 64 == 63 and not bool(
                        (still | ((common < len1) & (j < len2))).any()):
                    break
                c = (cand[j >> 2].to(torch.int64) >> (8 * (j & 3))) & 255
                sc = slot[c]
                if j < la:
                    still = still & (j < plim) & (sc >= 0) & (qrow[j] == sc)
                    pref += still
                    common += still
                act = (j >= pref) & (j < len2) & (common < len1)
                it1 += act
                has = act & (sc >= 0)
                if smax == 0:
                    continue
                s0 = sc.clamp(min=0)[:, None]
                k0 = cur.gather(1, s0)[:, 0]
                lo = torch.maximum(j - bound, pref)
                k = torch.maximum(k0, torch.searchsorted(
                    key, s0[:, 0] * (1 << 32) + lo))
                claim = has & (pos[k] <= torch.clamp(j + bound, max=la - 1))
                cur.scatter_(1, s0, torch.where(has, k + claim, k0)[:, None])
                common += claim
                last = torch.where(claim, j, last)
            it2 = torch.where(last >= 0, last + 1 - pref, 0)
            return torch.stack([common, z, it1, it2,
                                pref + torch.maximum(it1, it2),
                                common - pref])[:, None], tab.numel() * 4

        st = jk.jaro_scan_plain(las, tabs[None], cand, lb, steps=True)
        timed("jaro_scan",
              lambda: torch.stack(jk.jaro_1v_many(
                  q, cand, lb, staged=(las, tabs)))[:, None],
              lambda: jk.jaro_scan_plain(las, tabs[None], cand, lb), 20,
              jaro_work(lb, lk.words(q.size), 1, st, "jaro_scan"))
        st = jk.jaro_scan_plain(lasq, tabsq, cand, lb, steps=True)
        timed("jaro_scan_nq",
              lambda: torch.stack(jk.jaro_nq_many(
                  qs, cand, lb, staged=(lasq, tabsq))),
              lambda: jk.jaro_scan_plain(lasq, tabsq, cand, lb), 10,
              jaro_work(lb, 2, 16, st, "jaro_scan_nq"))
        every = LONG_SLICE["q64"]
        sl_cand = long_sc.cand[:, ::every].contiguous()
        sl_lb = long_sc.lb[::every].contiguous()
        st = jk.jaro_scan_plain(l64[0], l64[1][None], long_sc.cand,
                                long_sc.lb, steps=True)
        timed("jaro_scan_long",
              lambda: torch.stack(jk.jaro_1v_many(
                  q64, long_sc.cand, long_sc.lb, staged=l64))[:, None],
              lambda: jk.jaro_scan_plain(l64[0], l64[1][None], sl_cand,
                                         sl_lb), 3,
              jaro_work(long_sc.lb, 2, 1, st, "jaro_scan_long"), warm=False,
              every=every)
        del sl_cand, sl_lb, st
        # K9: the full form with the len-64 query at the serve corpus (two
        # lanes a candidate) and over the long corpus, the band at radius 7
        # (cutoff 7) at the serve corpus and at radius 15 with the
        # ~4,000-char query over the long corpus (cutoff 15), the main
        # paths' shapes; the full forms' plain versions on every
        # DAM_SLICE-th candidate, the long band's on every
        # DAM_BAND_SLICE-th
        dk = self.dk

        def dam_work(lbv, la, kband=None, row=None):
            """Bytes and operations of a K9 launch: the packed chars of each
            candidate that walks its rows (the band: those within
            ``kband`` of the query's length), every candidate's length and
            output, the PM table once; DAM_CELL_OPS (the band:
            DAM_BAND_OPS's unmasked rate) per cell of those walks.  The
            band's edge rows' extra goes to
            ``extra[row + "_edge_bound_ms"]``."""
            l64 = lbv.to(torch.int64)
            nbytes = lbv.numel() * 8 + lk.words(la) * 1024
            if kband is None:
                nbytes += int(((l64 + 3) // 4).sum()) * 4
                return nbytes, DAM_CELL_OPS * la * int(l64.sum())
            walk = torch.where((l64 - la).abs() <= kband, l64, 0)
            nbytes += int(((walk + 3) // 4).sum()) * 4
            width = 2 * kband + 1
            body, edge = DAM_BAND_OPS[kband]
            edge_cells = width * int(walk.clamp(max=kband + 1).sum())
            extra[f"{row}_edge_bound_ms"] = \
                (edge - body) * edge_cells / int_ops_s * 1e3
            return nbytes, body * width * int(walk.sum())

        def dam_layout(lbv, la, row):
            """``extra[row + "_layout_bound_ms"]``: K9's full form's issue
            beyond its bound's cells (DAM_STEP_OPS) over this run's data,
            a warp holding 32 / G consecutive candidates."""
            G = min(32, -(-la // dk.TILE))
            l64 = lbv.to(torch.int64)
            per = 32 // G
            nmax = torch.cat([l64, l64.new_zeros((-l64.numel()) % per)])
            nmax = nmax.view(-1, per).max(1).values
            steps = 0
            for cs in range(0, la, dk.STRIP):
                glive = min(G, -(-(la - cs) // dk.TILE))
                steps += int(torch.where(nmax > 0, nmax + glive - 1,
                                         0).sum())
            issued = steps * 32 * (dk.TILE * DAM_CELL_OPS
                                   + DAM_STEP_OPS[G > 1])
            layout = issued - DAM_CELL_OPS * la * int(l64.sum())
            extra[f"{row}_layout_bound_ms"] = layout / int_ops_s * 1e3

        sl_cand = cand[:, ::DAM_SLICE].contiguous()
        sl_lb = lb[::DAM_SLICE].contiguous()
        dam_layout(lb, q.size, "dam_scan")
        timed("dam_scan",
              lambda: dk.dam_1v_many(q, cand, lb, staged=(las, tabs)),
              lambda: dk.dam_scan_plain(q.size, tabs, sl_cand, sl_lb), 5,
              dam_work(lb, q.size), every=DAM_SLICE)
        timed("dam_band",
              lambda: dk.dam_band_1v_many(q, cand, lb, kband=7,
                                          staged=(las, tabs)),
              lambda: dk.dam_band_plain(q.size, 7, tabs, cand, lb), 20,
              dam_work(lb, q.size, 7, "dam_band"))
        # the register form (the query's first 32 chars) and the band at
        # radius 3 and 15, kernel times and bounds only
        q32 = q[:32]
        s32 = lk.stage_query(q32, "local", self.dev)
        extra["dam_scan_la32_ms"] = cuda_ms(
            torch, lambda: dk.dam_1v_many(q32, cand, lb, staged=s32), 10)
        nb, ops = dam_work(lb, 32)
        extra["dam_scan_la32_bound_ms"] = max(nb / HBM_BYTES_S,
                                              ops / int_ops_s) * 1e3
        dam_layout(lb, 32, "dam_scan_la32")
        for kb in (3, 15):
            extra[f"dam_band_k{kb}_ms"] = cuda_ms(
                torch, lambda: dk.dam_band_1v_many(q, cand, lb, kband=kb,
                                                   staged=(las, tabs)), 20)
            nb, ops = dam_work(lb, q.size, kb, f"dam_band_k{kb}")
            extra[f"dam_band_k{kb}_bound_ms"] = max(nb / HBM_BYTES_S,
                                                    ops / int_ops_s) * 1e3
        sl_cand = long_sc.cand[:, ::DAM_SLICE].contiguous()
        sl_lb = long_sc.lb[::DAM_SLICE].contiguous()
        dam_layout(long_sc.lb, q64.size, "dam_scan_long")
        timed("dam_scan_long",
              lambda: dk.dam_1v_many(q64, long_sc.cand, long_sc.lb,
                                     staged=l64),
              lambda: dk.dam_scan_plain(q64.size, l64[1], sl_cand, sl_lb), 2,
              dam_work(long_sc.lb, q64.size), warm=False, every=DAM_SLICE)
        sl_cand = long_sc.cand[:, ::DAM_BAND_SLICE].contiguous()
        sl_lb = long_sc.lb[::DAM_BAND_SLICE].contiguous()
        timed("dam_band_long",
              lambda: dk.dam_band_1v_many(q4k, long_sc.cand, long_sc.lb,
                                          kband=15, staged=l4k),
              lambda: dk.dam_band_plain(q4k.size, 15, l4k[1], sl_cand,
                                        sl_lb), 5,
              dam_work(long_sc.lb, q4k.size, 15, "dam_band_long"),
              warm=False, every=DAM_BAND_SLICE)
        del sl_cand, sl_lb
        s300 = lk.stage_query(enc["q300"], "local", self.dev)
        extra["dam_scan_long_q300_ms"] = cuda_ms(
            torch, lambda: dk.dam_1v_many(enc["q300"], long_sc.cand,
                                          long_sc.lb, staged=s300), 1,
            warm=False)
        nb, ops = dam_work(long_sc.lb, enc["q300"].size)
        extra["dam_scan_long_q300_bound_ms"] = max(nb / HBM_BYTES_S,
                                                   ops / int_ops_s) * 1e3
        dam_layout(long_sc.lb, enc["q300"].size, "dam_scan_long_q300")
        # the ~4,000-char query in full over the long corpus: strips of
        # 1,024 columns, the edge buffer over chunks of the 1 GiB plan,
        # held against the plain version on the DAM_SHORTEST shortest texts
        cols = slice(0, DAM_SHORTEST)
        sl_cand = long_sc.cand[:, cols].contiguous()
        sl_lb = long_sc.lb[cols].contiguous()
        before = self.kc.LAUNCHES["dam_scan_long"]
        timed("dam_scan_long",
              lambda: dk.dam_1v_many(q4k, long_sc.cand, long_sc.lb,
                                     staged=l4k),
              lambda: dk.dam_scan_plain(q4k.size, l4k[1], sl_cand, sl_lb), 1,
              dam_work(long_sc.lb, q4k.size), warm=False, kwarm=False,
              cols=cols, row="dam_scan_long_q4k")
        extra["dam_scan_long_q4k_launches"] = \
            self.kc.LAUNCHES["dam_scan_long"] - before
        dam_layout(long_sc.lb, q4k.size, "dam_scan_long_q4k")
        del sl_cand, sl_lb
        # K1 and K4 over the long corpus with the 300-char query (K1's
        # tile form, K4's registers), held against their plain versions
        # on the LONG_SHORTEST shortest texts (the plain versions walk as
        # many steps as the longest text they are given: 8,192 take K1's
        # over 20 s)
        cols = slice(0, LONG_SHORTEST)
        sl_cand = long_sc.cand[:, cols].contiguous()
        sl_lb = long_sc.lb[cols].contiguous()
        w300 = lk.words(enc["q300"].size)
        before = self.kc.LAUNCHES["lev_scan_long"]
        timed("lev_scan_long",
              lambda: lk.lev_1v_many(enc["q300"], long_sc.cand, long_sc.lb,
                                     staged=s300),
              lambda: lk.lev_scan_plain(s300[0], s300[1][None], sl_cand,
                                        sl_lb)[0], 2,
              scan_work("lev_scan_long", long_sc.lb, w300), warm=False,
              cols=cols, row="lev_scan_long_q300")
        extra["lev_scan_long_q300_launches"] = \
            (self.kc.LAUNCHES["lev_scan_long"] - before) // 3
        lev_layout(long_sc.lb, w300, "lev_scan_long_q300")
        timed("lcs_scan_long",
              lambda: ck.lcs_1v_many(enc["q300"], long_sc.cand, long_sc.lb,
                                     staged=s300),
              lambda: ck.lcs_scan_plain(s300[1][None], sl_cand, sl_lb)[0], 2,
              scan_work("lcs_scan_long", long_sc.lb, w300), warm=False,
              cols=cols, row="lcs_scan_long_q300")
        del sl_cand, sl_lb
        # K1's tile form with the ~4,000-char query over the long corpus
        # (126 words: one strip), held against the plain version on the
        # LEV_SHORTEST shortest texts (~1,030 steps of 126 words)
        cols = slice(0, LEV_SHORTEST)
        sl_cand = long_sc.cand[:, cols].contiguous()
        sl_lb = long_sc.lb[cols].contiguous()
        w4k = lk.words(q4k.size)
        before = self.kc.LAUNCHES["lev_scan_long"]
        timed("lev_scan_long",
              lambda: lk.lev_1v_many(q4k, long_sc.cand, long_sc.lb,
                                     staged=l4k),
              lambda: lk.lev_scan_plain(l4k[0], l4k[1][None], sl_cand,
                                        sl_lb)[0], 2,
              scan_work("lev_scan_long", long_sc.lb, w4k), warm=False,
              cols=cols, row="lev_scan_long_q4k")
        extra["lev_scan_long_q4k_launches"] = \
            (self.kc.LAUNCHES["lev_scan_long"] - before) // 3
        lev_layout(long_sc.lb, w4k, "lev_scan_long_q4k")
        extra["lev_scan_long_steps"] = int(long_sc.lb.to(torch.int64).sum())
        del sl_cand, sl_lb
        # K6's tile form with the 300- and ~4,000-char queries and K4's
        # with the ~4,000-char one over the long corpus, held against their
        # plain versions on the LONG_SHORTEST and LEV_SHORTEST shortest
        # texts as K1's rows are
        for key, kind, nshort in (("q300", "osa", LONG_SHORTEST),
                                  ("q4k", "osa", LEV_SHORTEST),
                                  ("q4k", "lcs", LEV_SHORTEST)):
            qk, st = enc[key], (s300 if key == "q300" else l4k)
            cols = slice(0, nshort)
            sl_cand = long_sc.cand[:, cols].contiguous()
            sl_lb = long_sc.lb[cols].contiguous()
            name, W = f"{kind}_scan_long", lk.words(qk.size)
            if kind == "osa":
                kern = (lambda: ok.osa_1v_many(qk, long_sc.cand, long_sc.lb,
                                               staged=st))
                plain = (lambda: ok.osa_scan_plain(st[0], st[1][None],
                                                   sl_cand, sl_lb)[0])
            else:
                kern = (lambda: ck.lcs_1v_many(qk, long_sc.cand, long_sc.lb,
                                               staged=st))
                plain = (lambda: ck.lcs_scan_plain(st[1][None], sl_cand,
                                                   sl_lb)[0])
            before = self.kc.LAUNCHES[name]
            timed(name, kern, plain, 2, scan_work(name, long_sc.lb, W),
                  warm=False, cols=cols, row=f"{name}_{key}")
            extra[f"{name}_{key}_launches"] = \
                (self.kc.LAUNCHES[name] - before) // 3
            lev_layout(long_sc.lb, W, f"{name}_{key}", kind=kind)
            del sl_cand, sl_lb
        # K8's cursor form over the long corpus at the other query widths
        # of the long phase, 300 and ~4,000 chars, each held against its
        # plain version on every LONG_SLICE[key]-th text; the bound's steps
        # from jaro_cursor_steps over every text, its rows on that slice
        # held against the plain version's own step rows
        for key, reps in (("q300", 3), ("q4k", 2)):
            qk = enc[key]
            st = s300 if key == "q300" else l4k
            every = LONG_SLICE[key]
            sl_cand = long_sc.cand[:, ::every].contiguous()
            sl_lb = long_sc.lb[::every].contiguous()
            steps, tab_bytes = jaro_cursor_steps(qk, st)
            ref = []

            def plain():
                ref.append(jk.jaro_scan_plain(st[0], st[1][None], sl_cand,
                                              sl_lb, steps=True))
                return ref[-1][:2]

            row = f"jaro_scan_long_{key}"
            before = self.kc.LAUNCHES["jaro_scan_long"]
            timed("jaro_scan_long",
                  lambda: torch.stack(jk.jaro_1v_many(
                      qk, long_sc.cand, long_sc.lb, staged=st))[:, None],
                  plain, reps,
                  jaro_work(long_sc.lb, lk.words(qk.size), 1, steps, row,
                            tab_bytes), warm=False, every=every, row=row)
            extra[f"{row}_launches"] = \
                (self.kc.LAUNCHES["jaro_scan_long"] - before) // (reps + 1)
            rows_ = [0, 2, 3, 4, 5]
            if not torch.equal(steps[rows_, :, ::every],
                               ref[-1][rows_].to(torch.int64)):
                raise AssertionError(f"jaro_cursor_steps {key} != the plain "
                                     "version's step rows")
            del sl_cand, sl_lb, steps, ref
        # K10: the serve corpus with a 12-char piece of the query (the
        # partial phase's /topk), the kernels line's row; then the 64-char
        # query over the serve corpus (nearly every candidate shorter: the
        # swapped role) and over the long corpus, kernel times and bounds
        pk = self.pk

        def partial_work(lbv, la, row):
            """Bytes and INT32 operations of a K10 launch: each candidate's
            packed chars, length and four outputs once, the PM table once,
            and PARTIAL_STEP_OPS per query word and window step this data
            needs.  The group layout's extra (see PARTIAL_STEP_OPS) goes to
            ``extra[row + "_layout_bound_ms"]``."""
            n = lbv.to(torch.int64)
            win = n >= la
            steps_win = int(torch.where(win, la - 1 + la * (n - la + 1)
                                        + la * (la - 1) // 2, 0).sum())
            steps_swap = int(torch.where(win, 0, n * (n + la - 1)).sum())
            W = lk.words(la)
            G, span = PARTIAL_G, la + PARTIAL_G - 1
            # the layout's steps for n >= m: G windows over min(span,
            # n - base) chars for each group base = 0, G, 2G, .. < n
            ng = (n + G - 1) // G
            full = (torch.div(n - span, G, rounding_mode="floor") + 1
                    ).clamp(min=0).minimum(ng)
            group = G * (full * span + (ng - full) * n
                         - G * ((ng - 1) * ng - (full - 1) * full) // 2)
            group = int(torch.where(win, group, 0).sum())
            nw = n + la - 1
            pad = int(torch.where(win | (n == 0), 0,
                                  n * ((nw + G - 1) // G * G - nw)).sum())
            prefix = (la - 1) * int(win.sum())
            layout = (PARTIAL_LAYOUT_OPS[W] * group
                      + PARTIAL_STEP_OPS[W] * (pad - steps_win + prefix))
            extra[f"{row}_layout_bound_ms"] = W * layout / int_ops_s * 1e3
            nbytes = int(((n + 3) // 4).sum()) * 4 + n.numel() * 20 + W * 1024
            return nbytes, W * PARTIAL_STEP_OPS[W] * (steps_win + steps_swap)

        q12 = q[20:32]
        s12 = lk.stage_query(q12, "local", self.dev)
        timed("partial_scan",
              lambda: torch.stack(pk.partial_ratio_1v_many(q12, cand, lb,
                                                           staged=s12)),
              lambda: pk.partial_scan_plain(q12.size, s12[1], cand, lb), 20,
              partial_work(lb, q12.size, "partial_scan"))
        for key, (qp, st, c, lv) in (
                ("q64", (q, (las, tabs), cand, lb)),
                ("long_q64", (q64, l64, long_sc.cand, long_sc.lb))):
            extra[f"partial_scan_{key}_ms"] = cuda_ms(
                torch, lambda: pk.partial_ratio_1v_many(qp, c, lv, staged=st),
                5)
            nb, ops = partial_work(lv, qp.size, f"partial_scan_{key}")
            extra[f"partial_scan_{key}_bound_ms"] = max(
                nb / HBM_BYTES_S, ops / int_ops_s) * 1e3
        # K11: the OCR pair's last rung (R = 4) and each other band on it;
        # the plain version on the first PAIR_PLAIN_STEPS text chars, held
        # to the kernel on those chars
        prk = self.prk
        fix = np.load(OCR)
        la, text, table = prk.stage_pair(fix["ex1"], fix["ex2"], self.dev)
        lbp = text.numel()
        rung_ms = {R: cuda_ms(torch, lambda: prk._pair(
            table, text, la, prk.max_cutoff(R), R), 3 if R == 4 else 1)
            for R in (1, 2, 3, 4, 8)}
        head = text[:PAIR_PLAIN_STEPS].contiguous()
        K4 = prk.max_cutoff(4)
        ref = []
        pms = cuda_ms(torch, lambda: ref.append(prk.lev_pair_plain(
            table, head, la, K4, 4)), 1, warm=False)
        self.compare("lev_pair", prk._pair(table, head, la, K4, 4), ref[-1],
                     f"timing inputs, first {PAIR_PLAIN_STEPS} text chars")
        rows["lev_pair"] = (rung_ms[4], pms)
        ops = LEV_PAIR_OPS * 4 * 128 * lbp
        # the design's own instructions, every thread every step: the
        # diagonal phase's and the rest's
        diag = min(la - K4, lbp)
        layout = LEV_PAIR_THREADS * sum(
            (alu - 4 * LEV_PAIR_OPS) * n for alu, n in zip(
                LEV_PAIR_STEP_ALU, (diag, lbp - diag)))
        t_bytes = (table.numel() + lbp + 1) * 4 / HBM_BYTES_S * 1e3
        t_ops = ops / int_ops_s * 1e3
        bounds["lev_pair"] = (max(t_bytes, t_ops),
                              "bytes" if t_bytes >= t_ops else "operations")
        extra.update({
            "lev_pair_rungs_ms": rung_ms,
            "lev_pair_plain_text_chars": PAIR_PLAIN_STEPS,
            "lev_pair_rungs_ns_per_step": {
                R: t * 1e6 / lbp for R, t in rung_ms.items()},
            "lev_pair_warp_bound_ms": ops / (32 * clock_mhz * 1e6) * 1e3,
            "lev_pair_sm_bound_ms": ops / (128 * clock_mhz * 1e6) * 1e3,
            "lev_pair_layout_bound_ms": layout / int_ops_s * 1e3,
            "lev_pair_warp_layout_ms": layout / (32 * clock_mhz * 1e6) * 1e3,
            "lev_pair_sm_layout_ms": layout / (128 * clock_mhz * 1e6) * 1e3,
            "lev_pair_ns_per_step": rung_ms[4] * 1e6 / lbp,
            "lev_pair_table_bytes": table.numel() * 4})
        del table, text, head
        steps = int(long_sc.lb.to(torch.int64).sum())
        ms_long = rows["lev_scan_long"][0]
        self.timing, self.bounds = rows, bounds
        self.emit_phase({
            "phase": "timing", "candidates": n, "bucket": LB,
            "query_len": int(q.size), "sm_clock_mhz": clock_mhz,
            "long_candidates": int(long_sc.lb.numel()),
            "long_bucket": LONG_LB, "odd_candidates": int(odd_sc.lb.numel()),
            "odd_bucket": ODD_LB,
            "long_query_lens": {k: int(v.size) for k, v in enc.items()},
            "plain_candidates": plain_n,
            "ms": {k: v[0] for k, v in rows.items()},
            "plain_ms": {k: v[1] for k, v in rows.items()},
            "bound_ms": {k: v[0] for k, v in bounds.items()},
            "bound_by": {k: v[1] for k, v in bounds.items()},
            "lev_scan_long_pairs_per_s": long_sc.lb.numel() / ms_long * 1e3,
            "lev_scan_long_char_steps_per_s": steps / ms_long * 1e3,
            **extra, "seconds": time.perf_counter() - t_start})
        del self.long_scanner, self.odd_scanner, self.mid_scanner

    # ------------------------------------------------------------ phase 16
    def phase_rate(self, card: str):
        """Each short-text kernel (K1 in both forms, K3, K6, K7, K2) at N_RATE
        len-64 candidates, its plain version (but K7's, timed in the
        timing phase) at N_PLAIN_RATE; sampled rows held against the
        oracle."""
        torch, lk, bk = self.torch, self.lk, self.bk
        t_start = time.perf_counter()
        g = self.gen(999)
        # packed on the device: [16, N] u32 words, 4 letters each
        cand = torch.randint(97, 123, (LB // 4, N_RATE, 4), generator=g,
                             device=self.dev, dtype=torch.uint8)
        cand = cand.view(torch.int32).reshape(LB // 4, N_RATE)
        lb = torch.full((N_RATE,), LB, dtype=torch.int32, device=self.dev)
        rng = np.random.default_rng(self.seed + 4)
        sample = torch.from_numpy(rng.choice(N_RATE, 1024, replace=False))
        rows = cand[:, sample.to(self.dev)].cpu().numpy()     # [16, 1024]
        chars = rows.T.copy().view(np.uint8).reshape(1024, LB)
        strs = [c.tobytes().decode("ascii") for c in chars]
        # the 1-query scans look for a near copy of a sampled row, so the
        # band accepts at least that row
        q = chars[0].astype(np.int64)
        q[rng.choice(LB, 3, replace=False)] = rng.integers(97, 123, 3)
        qs = [rng.integers(97, 123, LB) for _ in range(16)]
        qstr = [bytes(x.astype(np.uint8)).decode("ascii") for x in [q] + qs]
        las, tabs = lk.stage_query(q, "local", self.dev)
        lasq, tabsq = lk.stage_queries(qs, "local", self.dev)
        sdev = sample.to(self.dev)
        out = {"card": card, "candidates": N_RATE, "bucket": LB,
               "query_len": LB, "plain_candidates": N_PLAIN_RATE}

        def rate(name, fn, count, reps, unit="pairs"):
            ms = cuda_ms(torch, fn, reps)
            out[f"{name}_ms"] = ms
            out[f"{name}_{unit}_per_s"] = count / ms * 1e3
            return fn()

        truth = self.oracle_rows(qstr[0], strs)
        d1 = rate("lev_scan", lambda: lk.lev_1v_many(
            q, cand, lb, staged=(las, tabs)), N_RATE, 5)
        if not np.array_equal(d1[sdev].cpu().numpy(), truth):
            raise AssertionError("rate: 1-query kernel != oracle")
        del d1
        dq = rate("lev_scan_nq", lambda: lk.lev_nq_many(
            qs, cand, lb, staged=(lasq, tabsq)), 16 * N_RATE, 3)
        oq = dq[:, sdev].cpu().numpy()
        del dq
        for i in range(16):
            if not np.array_equal(oq[i], self.oracle_rows(qstr[i + 1],
                                                          strs)):
                raise AssertionError(f"rate: 16-query row {i} != oracle")
        db = rate("lev_band", lambda: bk.lev_banded_1v_many(
            q, cand, lb, cutoff=15, staged=(las, tabs)), N_RATE, 5)
        band_truth = np.where(truth <= 15, truth, int(bk.BIG))
        if not np.array_equal(db[sdev].cpu().numpy(), band_truth) or \
                band_truth[0] > 15:
            raise AssertionError("rate: band kernel != oracle")
        del db
        do = rate("osa_scan", lambda: self.ok.osa_1v_many(
            q, cand, lb, staged=(las, tabs)), N_RATE, 5)
        if not np.array_equal(do[sdev].cpu().numpy(),
                              self.oracle_rows(qstr[0], strs, "osa")):
            raise AssertionError("rate: OSA kernel != oracle")
        del do
        wt = WLEV_SERVE
        dw = rate("wlev_scan", lambda: self.wk.wlev_1v_many(
            q, cand, lb, ins=wt[0], dele=wt[1], sub_cost=wt[2],
            staged=(las, tabs)), N_RATE, 3)
        if not np.array_equal(dw[sdev].cpu().numpy(),
                              self.oracle_rows(qstr[0], strs, wt)):
            raise AssertionError("rate: weighted kernel != oracle")
        del dw
        # plain versions on the first N_PLAIN_RATE candidates, held to
        # the kernels bit for bit
        c4 = cand[:, :N_PLAIN_RATE].contiguous()
        l4 = lb[:N_PLAIN_RATE].contiguous()
        ws = bk.table_words(LB, LB)
        for name, kern, plain in (
                ("lev_scan",
                 lambda: lk.lev_1v_many(q, c4, l4, staged=(las, tabs)),
                 lambda: lk.lev_scan_plain(las, tabs[None], c4, l4)[0]),
                ("lev_scan_nq",
                 lambda: lk.lev_nq_many(qs, c4, l4, staged=(lasq, tabsq)),
                 lambda: lk.lev_scan_plain(lasq, tabsq, c4, l4)),
                ("lev_band",
                 lambda: bk.lev_banded_1v_many(q, c4, l4, cutoff=15,
                                               staged=(las, tabs)),
                 lambda: bk.lev_band_plain(LB, 15, 1, tabs[:ws], c4, l4)),
                ("osa_scan",
                 lambda: self.ok.osa_1v_many(q, c4, l4, staged=(las, tabs)),
                 lambda: self.ok.osa_scan_plain(las, tabs[None], c4,
                                                l4)[0])):
            out[f"{name}_plain_ms"] = cuda_ms(torch, plain, 1)
            self.compare(name, kern(), plain(), "rate slice")
        del cand, c4
        # K2 over a Cyrillic corpus of the same size, transposed [LB, N]
        chars_t = torch.randint(0x430, 0x450, (LB, N_RATE), generator=g,
                                device=self.dev, dtype=torch.int32)
        vocab = torch.from_numpy(lk.query_vocab(
            rng.integers(0x430, 0x450, 40))[0]).to(self.dev)
        rate("remap_pack", lambda: lk.remap_pack(chars_t, vocab), N_RATE, 5,
             unit="candidates")
        ct4 = chars_t[:, :N_PLAIN_RATE].contiguous()
        del chars_t
        out["remap_pack_plain_ms"] = cuda_ms(
            torch, lambda: lk.remap_pack_plain(ct4, vocab), 1)
        self.compare("remap_pack", lk.remap_pack(ct4, vocab),
                     lk.remap_pack_plain(ct4, vocab), "rate slice")
        self.sync()
        out["seconds"] = time.perf_counter() - t_start
        self.emit_phase({"phase": "rate", **out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smoke = Smoke(args.seed)
    kc = smoke.kc
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    emit({"phase": "device", "name": kind, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    kc.load()
    tiles = {f"ptxas_{k}": ptxas_kernels(kc.ptxas_report.get(f"{k}.cu", ""),
                                         k)
             for k in ("osa_scan", "lcs_scan", "lev_band", "lcs_band",
                       "jaro_scan")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kc.build_seconds, "library": kc.library_path(),
          "ptxas": ptxas_summary(kc.ptxas_report),
          "ptxas_lev_scan": ptxas_kernels(
              kc.ptxas_report.get("lev_scan.cu", ""), "lev_scan"),
          "sass_lev_scan": sass_histogram(kc, "lev_scan"),
          **tiles, "sass_osa_scan": sass_histogram(kc, "osa_scan"),
          "sass_lcs_scan": sass_histogram(kc, "lcs_scan"),
          "sass_lev_band": sass_histogram(kc, "lev_band"),
          "sass_lcs_band": sass_histogram(kc, "lcs_band"),
          "ptxas_wlev_scan": ptxas_kernels(
              kc.ptxas_report.get("wlev_scan.cu", ""), "wlev_scan"),
          "sass_wlev_scan": sass_histogram(kc, "wlev_scan"),
          "sass_jaro_scan": sass_histogram(kc, "jaro_scan"),
          "sass_dam_scan": sass_histogram(kc, "dam_"),
          "sass_partial_scan": sass_histogram(kc, "partial_scan"),
          "ptxas_lev_pair": ptxas_kernels(
              kc.ptxas_report.get("lev_pair.cu", ""), "lev_pair"),
          "sass_lev_pair": sass_histogram(kc, "lev_pair")})
    # no instance of K3, K4, K5, K6 or K8 spills (a fresh build reports
    # every one)
    spilled = {k: v for t in tiles.values() for k, v in t.items()
               if v["spill_bytes"]}
    if kc.build_seconds is not None and (
            spilled or not all(tiles.values())):
        raise AssertionError(f"K3/K4/K5/K6/K8 instances spill or were not "
                             f"reported: {spilled or tiles}")
    smoke.phase_kernels()
    smoke.count_words(True)
    # the main paths, each counted from zero: the serving path over
    # short texts, the LCS family's, the long texts', OSA's, the weighted
    # one's, the Jaro family's, Damerau-Levenshtein's, partial_ratio's,
    # then one long pair's
    kc.reset_launches()
    smoke.phase_serve()
    smoke.phase_wide()
    launches = dict(kc.LAUNCHES)
    for name in SHORT_PATH:
        if launches[name] == 0:
            raise AssertionError(f"serving path never launched {name}")
    # the library's launches are not a main path's
    smoke.count_words(False)
    smoke.phase_library()
    smoke.count_words(True)
    kc.reset_launches()
    smoke.phase_lcs()
    lcs_launches = dict(kc.LAUNCHES)
    for name in LCS_PATH:
        if lcs_launches[name] == 0:
            raise AssertionError(f"LCS serving path never launched {name}")
    kc.reset_launches()
    smoke.phase_long()
    long_launches = dict(kc.LAUNCHES)
    for name in LONG_PATH:
        if long_launches[name] == 0:
            raise AssertionError(f"long path never launched {name}")
    kc.reset_launches()
    smoke.phase_osa()
    osa_launches = dict(kc.LAUNCHES)
    for name in OSA_PATH:
        if osa_launches[name] == 0:
            raise AssertionError(f"OSA path never launched {name}")
    kc.reset_launches()
    smoke.phase_wlev()
    wlev_launches = dict(kc.LAUNCHES)
    for name in WLEV_PATH:
        if wlev_launches[name] == 0:
            raise AssertionError(f"weighted path never launched {name}")
    kc.reset_launches()
    smoke.phase_jaro()
    jaro_launches = dict(kc.LAUNCHES)
    for name in JARO_PATH:
        if jaro_launches[name] == 0:
            raise AssertionError(f"Jaro path never launched {name}")
    kc.reset_launches()
    smoke.phase_dam()
    dam_launches = dict(kc.LAUNCHES)
    for name in DAM_PATH:
        if dam_launches[name] == 0:
            raise AssertionError(f"Damerau path never launched {name}")
    kc.reset_launches()
    smoke.phase_partial()
    partial_launches = dict(kc.LAUNCHES)
    for name in PARTIAL_PATH:
        if partial_launches[name] == 0:
            raise AssertionError(f"partial_ratio path never launched {name}")
    kc.reset_launches()
    smoke.phase_pair()
    pair_launches = dict(kc.LAUNCHES)
    for name in PAIR_PATH:
        if pair_launches[name] == 0:
            raise AssertionError(f"long-pair path never launched {name}")
    launches = {k: launches[k] + lcs_launches[k] + long_launches[k]
                + osa_launches[k] + wlev_launches[k] + jaro_launches[k]
                + dam_launches[k] + partial_launches[k] + pair_launches[k]
                for k in launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}")
    smoke.count_words(False)
    clock = float(nvidia_smi("clocks.max.sm").split()[0])
    smoke.phase_timing(clock)
    smoke.phase_rate(card)
    emit({"phase": "done", "seconds": time.perf_counter() - t_all,
          "launches_by_words": {k: dict(sorted(v.items()))
                                for k, v in sorted(smoke.words.items())}})
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": smoke.err[name], "ms": smoke.timing[name][0],
         "plain_ms": smoke.timing[name][1],
         "bound_ms": smoke.bounds[name][0],
         "bound_by": smoke.bounds[name][1],
         # no single PyTorch call computes an edit distance (weighted,
         # uniform, banded or Damerau), an LCS length, Jaro's components or
         # a windowed LCS
         "library_ms": None}
        for name in kc.LAUNCHES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
