#!/usr/bin/env python3
"""K8 (``csrc/jaro_scan.cu``) of one checkout, through its wrapper, at the
shapes of ``PERF.md``'s rows 18, 19 and 10, to set two checkouts side by
side on one GPU.

Run on a machine with an NVIDIA GPU, once per checkout, in turns::

    python3 probes/jaro_scan_ab.py OLD_ROOT   # e.g. the parent, unpacked
    python3 probes/jaro_scan_ab.py .
    python3 probes/jaro_scan_ab.py .
    python3 probes/jaro_scan_ab.py OLD_ROOT

Imports ``rapidfuzz_tpu_torch`` from ``ROOT`` (which builds its own
library there) and makes two corpora on the card from a fixed seed, each
sorted by length as the scanner sorts it: 1,048,576 word-like strings of
0-64 chars (letters with 15 % spaces, 120 of them a 64-char query with
1-4 adjacent swaps), and 131,072 texts of 1,025-8,192 chars cut from 300
seed documents with up to 7 substitutions, 40 of them near copies of the
4,001-char query (document 0 with 5 substitutions), as ``chip_smoke.py``'s
long corpus is.  Times each row in turns (A B, B A; CUDA events around a
row's repeated calls) through the wrapper, the PM table staged once, so
that a call includes what the wrapper stages per launch, and by the C
entry with everything staged once (the kernel alone): ``jaro_scan`` (the
64-char query over the strings), ``jaro_scan_nq`` (16 queries of 33-64
chars), and ``jaro_scan_long`` with a 64-char query, a 300-char one
(document 1 with 3 substitutions) and the 4,001-char one over the texts.
A digest of each output lets two checkouts be held bit for bit.  One JSON
line per row, the card's name and power limit first.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, ROOT)

from rapidfuzz_tpu_torch.ops import cuda as kc  # noqa: E402
from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel as jk  # noqa: E402
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk  # noqa: E402

SYMS = list(range(97, 123)) + [32]
REPS = {"jaro_scan": 50, "jaro_scan_nq": 10, "jaro_scan_long_q64": 20,
        "jaro_scan_long_q300": 5, "jaro_scan_long_q4k": 2}


def emit(o):
    print(json.dumps(o), flush=True)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sym_chars(g, shape, dev):
    """uint8 chars: letters with 15 % spaces."""
    ch = torch.randint(97, 123, shape, generator=g, device=dev,
                       dtype=torch.uint8)
    sp = torch.rand(shape, generator=g, device=dev) < 0.15
    return torch.where(sp, torch.full_like(ch, 32), ch)


def finish(chars, lens):
    """[B, LB] uint8 chars and lengths -> packed corpus sorted by length,
    pad bytes zero."""
    lens, order = lens.sort(stable=True)
    chars = chars[order]
    chars.masked_fill_(torch.arange(chars.shape[1], device=chars.device)
                       [None, :] >= lens[:, None], 0)
    return lk.prepare_corpus(chars, lens)


def short_corpus(g, B, dev, q, near=120):
    lens = torch.randint(0, 65, (B,), generator=g, device=dev)
    chars = sym_chars(g, (B, 64), dev)
    qt = torch.from_numpy(q.astype(np.uint8)).to(dev)
    rng = np.random.default_rng(5)
    for k in range(near):
        t = qt.clone()
        for _ in range(1 + k % 4):
            i = int(rng.integers(0, 63))
            t[[i, i + 1]] = t[[i + 1, i]]
        chars[k * (B // near)] = t
        lens[k * (B // near)] = 64
    return finish(chars, lens)


def long_corpus(g, B, LB, dev):
    rng = np.random.default_rng(7)
    docs = sym_chars(g, (300, LB), dev)
    which = torch.randint(0, 300, (B,), generator=g, device=dev)
    lens = torch.randint(1025, LB + 1, (B,), generator=g, device=dev)
    chars = docs[which]
    del which
    nsub = torch.randint(0, 8, (B,), generator=g, device=dev)
    for s in range(7):
        at = (torch.rand(B, generator=g, device=dev) * lens).long()
        val = torch.randint(97, 123, (B,), generator=g, device=dev,
                            dtype=torch.uint8)
        rows = torch.nonzero(nsub > s)[:, 0]
        chars[rows, at[rows]] = val[rows]
    q4k = docs[0, :4001].cpu().numpy().astype(np.int64)
    q4k[rng.integers(0, 4001, 5)] = rng.integers(97, 123, 5)
    q300 = docs[1, :300].cpu().numpy().astype(np.int64)
    q300[rng.integers(0, 300, 3)] = rng.integers(97, 123, 3)
    q64 = rng.integers(97, 123, 64)
    for k in range(40):
        i = int(rng.integers(0, B))
        t = q4k.copy()
        t[rng.integers(0, 4001, k % 21)] = rng.integers(97, 123, k % 21)
        chars[i, :4001] = torch.from_numpy(t.astype(np.uint8)).to(dev)
        lens[i] = 4001
    cand, lb = finish(chars, lens)
    return cand, lb, q64, q300, q4k


def c_entry(st, cand, lb):
    """K8 by its C entry with the wrapper's arguments, staged once ->
    (run, out): this tree's register form or cursor form (its tables
    staged here), or the parent's register form or scratch form (the
    scratch allocated here, its chunks launched as its wrapper did)."""
    las, tabs = st
    tabs = tabs if tabs.dim() == 3 else tabs[None]
    NQ, W, _ = tabs.shape
    B, lb4 = lb.numel(), cand.shape[0]
    out = torch.empty((2, NQ, B), dtype=torch.int32, device=cand.device)
    fn = kc.load().rf_jaro_scan
    keep = []
    if hasattr(jk, "cursor_tables"):
        tab, smax = (None, 0) if W <= jk.MAX_REG_W else \
            jk.cursor_tables(tabs)
        keep.append(tab)
        calls = [(tabs.data_ptr(), None if tab is None else tab.data_ptr(),
                  0 if tab is None else tab.shape[1] * 4, smax,
                  las.data_ptr(), cand.data_ptr(), lb.data_ptr(),
                  out.data_ptr(), B, lb4, W, NQ)]
    elif W <= jk.MAX_REG_W:
        calls = [(tabs.data_ptr(), las.data_ptr(), cand.data_ptr(),
                  lb.data_ptr(), out.data_ptr(), None, B, 0, B, lb4, W, NQ)]
    else:
        per = 4 * NQ * (W + -(-4 * lb4 // 32))
        chunk = min(B, max(jk.BLOCK,
                           jk.SCRATCH_BYTES // per // jk.BLOCK * jk.BLOCK))
        scratch = torch.empty(per // 4 * chunk, dtype=torch.int32,
                              device=cand.device)
        keep.append(scratch)
        calls = [(tabs.data_ptr(), las.data_ptr(), cand.data_ptr(),
                  lb.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, b0,
                  min(chunk, B - b0), lb4, W, NQ)
                 for b0 in range(0, B, chunk)]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        for args in calls:
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"rf_jaro_scan: cudaError_t {err}")
        return out

    run.keep = keep          # the staged tables or scratch stay alive
    return run, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    kc.load()
    emit({"part": "device", "root": ROOT, "smi": smi,
          "build_s": time.perf_counter() - t0})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    rng = np.random.default_rng(11)
    q = rng.choice(SYMS, 64)
    s_cand, s_lb = short_corpus(g, 1 << 20, dev, q)
    qs = [q] + [rng.choice(SYMS, int(rng.integers(33, 65)))
                for _ in range(15)]
    l_cand, l_lb, q64, q300, q4k = long_corpus(g, 1 << 17, 8192, dev)
    rows = {"jaro_scan": ([q], s_cand, s_lb),
            "jaro_scan_nq": (qs, s_cand, s_lb),
            "jaro_scan_long_q64": ([q64], l_cand, l_lb),
            "jaro_scan_long_q300": ([q300], l_cand, l_lb),
            "jaro_scan_long_q4k": ([q4k], l_cand, l_lb)}
    for row, (qq, cand, lb) in rows.items():
        if len(qq) > 1:
            st = lk.stage_queries(qq, "local", dev)

            def run():
                return torch.stack(jk.jaro_nq_many(qq, cand, lb,
                                                   mode="local", staged=st))
        else:
            st = lk.stage_query(qq[0], "local", dev)

            def run():
                return torch.stack(jk.jaro_1v_many(qq[0], cand, lb,
                                                   mode="local", staged=st))
        ref = run()
        direct, out = c_entry(st, cand, lb)
        direct()
        torch.cuda.synchronize()
        ms = {"wrapper": [], "c_entry": []}
        for k, f in (("wrapper", run), ("c_entry", direct),
                     ("c_entry", direct), ("wrapper", run)):
            ms[k].append(cuda_ms(f, REPS[row]))
        emit({"part": "time", "row": row, "B": lb.numel(),
              "LB": cand.shape[0] * 4, "la": [int(x.size) for x in qq][:2],
              "ms": ms, "exact": bool(torch.equal(out.view(ref.shape), ref)),
              "digest": hashlib.sha256(
                  ref.cpu().numpy().tobytes()).hexdigest()[:16],
              "transpositions": int((ref[1] > 0).sum())})


if __name__ == "__main__":
    main()
