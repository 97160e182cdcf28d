#!/usr/bin/env python3
"""K3 (``csrc/lev_band.cu``) of one checkout, through its wrapper and by
its C entry, at the shapes of ``PERF.md``'s rows 4-6, to set two
checkouts side by side on one GPU.

Run on a machine with an NVIDIA GPU, once per checkout, in turns::

    python3 probes/lev_band_ab.py OLD_ROOT   # e.g. the parent, unpacked
    python3 probes/lev_band_ab.py .
    python3 probes/lev_band_ab.py .
    python3 probes/lev_band_ab.py OLD_ROOT

Imports ``rapidfuzz_tpu_torch`` from ``ROOT`` (which builds its own
library there) and makes three corpora from a fixed seed, each sorted by
length as the scanner sorts them: a 64-char query at cutoff 15 over
1,048,576 strings of 0-64 chars (bucket 64, ``lev_band``), a 4,001-char
query at cutoff 15 over 16,384 texts of 1,025-6,000 chars (bucket 6000,
``lev_band_rt``) and over 131,072 texts of 1,025-8,192 chars (bucket
8192, ``lev_band_long``); 40 texts of each long corpus are the query cut
or run on by 0-19 chars.  For each, in turns (A B, B A): the kernel
through the wrapper (``band_kernel.lev_banded_1v_many`` /
``lev_banded_stream_1v_many``, the PM table staged once)
and by its C entry with the wrapper's arguments, both timed with CUDA
events; then the wrapper's host time a call (the clock around 200 calls,
no synchronisation inside).  A digest of the output lets two checkouts be
held bit for bit.  One JSON line per row, the card's name and power limit
first.
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
from rapidfuzz_tpu_torch.ops.cuda import band_kernel as bk  # noqa: E402
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk  # noqa: E402

SYMS = np.array(list(range(97, 123)) + [32])
REPS = {"row4_lev_band": 50, "row5_lev_band_rt": 10,
        "row6_lev_band_long": 10}


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


def corpus(g, B, lo, hi, LB, q=None, near=0):
    """B texts of lo..hi chars over SYMS (the last ``near`` of them ``q``
    cut or run on by 0-19 chars), sorted by length, made on the card ->
    packed cand, lb."""
    dev = torch.device("cuda")
    lens = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
    i = torch.randint(0, len(SYMS), (B, LB), generator=g, device=dev,
                      dtype=torch.uint8)
    chars = torch.where(i == 26, torch.full_like(i, 32), i + 97)
    del i
    for k in range(near):
        d = k % 20
        n = min(q.size + (d if k % 2 else -d), LB)
        m = min(n, q.size)
        lens[B - 1 - k] = n
        chars[B - 1 - k, :m] = torch.from_numpy(q[:m].astype(np.uint8))
    lens, order = lens.sort(stable=True)
    chars = chars[order]
    chars.masked_fill_(torch.arange(LB, device=dev)[None, :]
                       >= lens[:, None], 0)
    return lk.prepare_corpus(chars, lens)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    lib = kc.load()
    emit({"part": "device", "root": ROOT, "smi": smi,
          "build_s": time.perf_counter() - t0})
    rng = np.random.default_rng(11)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    q64 = rng.choice(SYMS, 64)
    q4k = rng.choice(SYMS, 4001)
    shapes = {
        "row4_lev_band": (q64, *corpus(g, 1 << 20, 0, 64, 64)),
        "row5_lev_band_rt": (q4k, *corpus(g, 1 << 14, 1025, 6000, 6000,
                                          q4k, 40)),
        "row6_lev_band_long": (q4k, *corpus(g, 1 << 17, 1025, 8192, 8192,
                                            q4k, 40)),
    }
    args = kc._SIGNATURES["rf_lev_band"]
    stream = torch.cuda.current_stream().cuda_stream
    for row, (q, cand, lb) in shapes.items():
        la, LB, B = q.size, cand.shape[0] * 4, lb.numel()
        staged = lk.stage_query(q, "byte", cand.device)
        ws = bk.table_words(la, LB)
        tabs = staged[1][:ws]
        fn = (bk.lev_banded_stream_1v_many if row.endswith("long")
              else bk.lev_banded_1v_many)

        def wrap():
            return fn(q, cand, lb, cutoff=15, mode="byte", staged=staged)

        out = torch.empty(B, dtype=torch.int32, device=cand.device)
        head = [tabs.data_ptr(), ws, la, 15, 15, 1, cand.data_ptr(),
                lb.data_ptr(), out.data_ptr(), B, cand.shape[0]]
        if len(args) > len(head) + 1:            # the block size
            head.append(bk.block_threads(B, LB))

        def direct():
            err = lib.rf_lev_band(*head, stream)
            if err:
                raise RuntimeError(f"rf_lev_band: cudaError_t {err}")

        ref = wrap()
        direct()
        torch.cuda.synchronize()
        jobs = (("wrapper", wrap), ("c_entry", direct))
        ms = {k: [] for k, _ in jobs}
        for order in (jobs, jobs[::-1]):
            for k, f in order:
                ms[k].append(cuda_ms(f, REPS[row]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(200):
            wrap()
        host = (time.perf_counter() - t1) / 200 * 1e3
        torch.cuda.synchronize()
        emit({"part": "time", "row": row, "B": B, "LB": LB,
              "exact": bool(torch.equal(out, ref)),
              "digest": hashlib.sha256(ref.cpu().numpy().tobytes())
              .hexdigest()[:16],
              "accepted": int((ref <= 15).sum()), "ms": ms,
              "wrapper_host_ms_per_call": host})


if __name__ == "__main__":
    main()
