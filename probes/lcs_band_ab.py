#!/usr/bin/env python3
"""K5 (``csrc/lcs_band.cu``) of one checkout, through its wrapper and by
its C entry, at the shapes of ``PERF.md``'s rows 14 and 15, to set two
checkouts side by side on one GPU.

Run on a machine with an NVIDIA GPU, once per checkout, in turns::

    python3 probes/lcs_band_ab.py OLD_ROOT   # e.g. the parent, unpacked
    python3 probes/lcs_band_ab.py .
    python3 probes/lcs_band_ab.py .
    python3 probes/lcs_band_ab.py OLD_ROOT

Imports ``rapidfuzz_tpu_torch`` from ``ROOT`` (which builds its own
library there) and makes two corpora on the card from a fixed seed, each
sorted by length as the scanner sorts it: 262,144 texts of 225-1,024
chars (bucket 1024, ``lcs_band``, a 300-char query) and 131,072 texts of
1,025-8,192 chars (bucket 8192, ``lcs_band_long``, a 4,001-char query),
letters with 15 % spaces, 40 texts of each the query cut or run on by
0-19 chars.  For each row, at indel cutoff 15 (one band word), in turns
(A B, B A): the kernel through the wrapper
(``lcs_band_kernel.lcs_banded_1v_many`` /
``lcs_banded_stream_1v_many``, the PM table staged once) and by its C
entry with the wrapper's arguments, both timed with CUDA events; where
the C entry takes a block size, also at 64, 128 and 256 threads; then
the wrapper's host time a call (the clock around 200 calls, no
synchronisation inside).  Each row also gives the text steps the launch
needs, ``sum(min(lb, la + 16))``, and a digest of the output, which lets
two checkouts be held bit for bit.  One JSON line per row, the card's
name and power limit first.
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
from rapidfuzz_tpu_torch.ops.cuda import lcs_band_kernel as cbk  # noqa: E402
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk  # noqa: E402

SYMS = list(range(97, 123)) + [32]
CUT = 15
REPS = {"row14_lcs_band": 50, "row15_lcs_band_long": 10}


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


def corpus(g, B, lo, hi, LB, q, near=40):
    """B texts of lo..hi chars (letters, 15 % spaces; the last ``near`` of
    them ``q`` cut or run on by 0-19 chars), sorted by length, made on the
    card -> packed cand, lb."""
    dev = torch.device("cuda")
    lens = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
    chars = torch.randint(97, 123, (B, LB), generator=g, device=dev,
                          dtype=torch.uint8)
    chars[torch.rand((B, LB), generator=g, device=dev) < 0.15] = 32
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
    rng = np.random.default_rng(19)
    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    q300 = rng.choice(SYMS, 300)
    q4k = rng.choice(SYMS, 4001)
    shapes = {
        "row14_lcs_band": (q300, *corpus(g, 1 << 18, 225, 1024, 1024,
                                         q300)),
        "row15_lcs_band_long": (q4k, *corpus(g, 1 << 17, 1025, 8192, 8192,
                                             q4k)),
    }
    args = kc._SIGNATURES["rf_lcs_band"]
    takes_la = len(args) == 11        # pm, ws, la, bw, ..., threads, stream
    stream = torch.cuda.current_stream().cuda_stream
    for row, (q, cand, lb) in shapes.items():
        la, LB, B = q.size, cand.shape[0] * 4, lb.numel()
        staged = lk.stage_query(q, "byte", cand.device)
        ws = cbk.table_words(la, LB)
        tabs = staged[1][:ws]
        fn = (cbk.lcs_banded_stream_1v_many if row.endswith("long")
              else cbk.lcs_banded_1v_many)

        def wrap():
            return fn(q, cand, lb, cutoff=CUT, mode="byte", staged=staged)

        out = torch.empty(B, dtype=torch.int32, device=cand.device)

        def direct(threads=None):
            if takes_la:
                a = [tabs.data_ptr(), ws, la, 1, cand.data_ptr(),
                     lb.data_ptr(), out.data_ptr(), B, cand.shape[0],
                     threads or bk.fill_threads(B)]
            else:
                a = [tabs.data_ptr(), ws, 1, cand.data_ptr(), lb.data_ptr(),
                     out.data_ptr(), B, cand.shape[0]]
            err = lib.rf_lcs_band(*a, stream)
            if err:
                raise RuntimeError(f"rf_lcs_band: cudaError_t {err}")

        ref = wrap()
        direct()
        torch.cuda.synchronize()
        exact = {"c_entry": bool(torch.equal(out, ref))}
        jobs = [("wrapper", wrap), ("c_entry", direct)]
        if takes_la:
            for t in (64, 128, 256):
                out.zero_()
                direct(t)
                torch.cuda.synchronize()
                exact[f"t{t}"] = bool(torch.equal(out, ref))
                jobs.append((f"c_entry_t{t}",
                             lambda t=t: direct(t)))
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
        steps = int(lb.to(torch.int64).clamp(max=la + 16).sum())
        indel = la + lb.to(torch.int64) - 2 * ref.to(torch.int64)
        emit({"part": "time", "row": row, "B": B, "LB": LB, "la": la,
              "ws": ws, "steps": steps, "exact": exact,
              "digest": hashlib.sha256(ref.cpu().numpy().tobytes())
              .hexdigest()[:16],
              "accepted": int((indel <= CUT).sum()), "ms": ms,
              "wrapper_host_ms_per_call": host})


if __name__ == "__main__":
    main()
