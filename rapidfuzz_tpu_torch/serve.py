"""Serving layer: an HTTP daemon around :class:`CorpusScanner`.

Counterpart of ``rapidfuzz_tpu/serve.py``: load the corpus once, keep it
on the device, answer one-vs-many queries over HTTP under one metric
(``--metric levenshtein``, ``indel``, ``lcs_seq``, ``osa``, ``jaro``,
``jaro_winkler``, ``damerau_levenshtein`` or ``partial_ratio``).
Stdlib-only.  The Jaro family and ``partial_ratio`` answer f64 distances
``1.0 - similarity``; Jaro-Winkler's ``prefix_weight`` (default 0.1) and
Levenshtein's ``weights`` have no flag, as in the JAX server: pass them
to :class:`ScanService` in Python.

Endpoints (JSON):

* ``GET /health``                 -> ``{"ok": true, "n": corpus_size}``
* ``GET /stats``                  -> counters (queries, pairs, seconds)
* ``POST /reload`` body ``{"corpus": [str]}`` or ``{"path": file}``
                                  -> ``{"ok": true, "n": new_size}``
  (hot corpus swap: the new scanner builds and runs the routes the last
  warmup ran outside the lock, in-flight queries keep the old corpus
  until the atomic swap.  ``path`` reads a
  server-local file — operator input; the daemon binds 127.0.0.1 by
  default and has no auth, so do not expose it beyond trusted hosts)
* ``POST /topk``    body ``{"query": str, "k": int, "score_cutoff"?: num}``
                                  -> ``{"values": [...], "indices": [...],
                                        "strings": [...]}``
* ``POST /distances`` body ``{"query": str, "score_cutoff"?: num,
                              "score_hint"?: num}``
                                  -> ``{"values": [...], "valid"?: [...]}``
* ``POST /batch``   body ``{"queries": [str], "k"?: int}``
                                  -> ``{"values": [[...]], "indices"?:
                                        [[...]], "strings"?: [[...]]}``
  (rides ``CorpusScanner.scan_many``: queries share kernel launches in
  groups of 16)
* ``POST /editops``, ``POST /extract``: answer 400, not ported yet.

Run::

    python -m rapidfuzz_tpu_torch.serve --corpus words.txt --port 8947
    python -m rapidfuzz_tpu_torch.serve --corpus words.txt --metric indel
    python -m rapidfuzz_tpu_torch.serve --corpus words.txt --metric osa
    python -m rapidfuzz_tpu_torch.serve --corpus names.txt \
        --metric jaro_winkler
    python -m rapidfuzz_tpu_torch.serve --corpus words.txt \
        --metric damerau_levenshtein
    python -m rapidfuzz_tpu_torch.serve --corpus products.txt \
        --metric partial_ratio

Requests serialize through a lock: one scan saturates the card, so
concurrency would only interleave kernel launches.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .parallel.scan import CorpusScanner

_NOT_PORTED = ("/editops", "/extract")


class ScanService:
    """Device-resident corpus + scanner + counters."""

    def __init__(self, corpus, metric: str = "levenshtein",
                 bucket: int | None = None, device=None, **scanner_kw):
        self._build_kw = dict(metric=metric, bucket=bucket, device=device,
                              **scanner_kw)
        self.corpus = list(corpus)
        self.scanner = CorpusScanner(self.corpus, **self._build_kw)
        self.metric = metric
        self._lock = threading.Lock()
        self.stats = {"queries": 0, "pairs": 0, "device_seconds": 0.0}
        #: the level of the last warmup (a reload warms its scanner the
        #: same way) and the route table of the last reload's warmup
        self._warm_full = False
        self.reload_warmup = {}

    #: longest warmup query: long enough for every band route (the
    #: run-time band wants > 160 chars), short enough that a corpus of
    #: 100k-char texts warms up in seconds
    WARM_LEN = 320

    def warmup(self, full: bool = False):
        """Run the corpus's scan routes once before serving traffic.

        The first call builds the CUDA kernels (nvcc, once per source
        hash) and loads them; ``full`` also runs the cutoff (banded), hint
        (Levenshtein only, as the JAX server), top-k and grouped scan_many
        routes, over a long bucket the streamed bands, the run-time band
        and the long full scans among them.  Returns a route -> seconds
        table; a route the corpus cannot serve yet records its
        ``NotImplementedError``, and anything else, a failed build or
        launch among them, raises."""
        self._warm_full = full
        return self._warm(self.scanner, self.corpus, full)

    def _warm(self, scanner, corpus, full: bool):
        """:meth:`warmup`'s routes over ``scanner`` and its ``corpus``."""
        if not corpus:
            return {}
        q = max(corpus, key=len)[: self.WARM_LEN] or "a"
        q_short = q[:64] or "a"
        times = {}

        def step(name, fn):
            t0 = time.perf_counter()
            try:
                fn()
            except NotImplementedError as e:
                times[name] = f"error: NotImplementedError: {e}"
                return
            times[name] = round(time.perf_counter() - t0, 3)

        step("distances", lambda: scanner.distances(q))
        if q_short != q:
            step("distances_short", lambda: scanner.distances(q_short))
        if full:
            for cut in (2, 7, 15):
                step(f"distances_cutoff{cut}",
                     lambda c=cut: scanner.distances(q, score_cutoff=c))
            if scanner.metric == "levenshtein":
                step("distances_hint",
                     lambda: scanner.distances(q, score_hint=8))
            step("topk", lambda: scanner.topk(q, k=3))
            step("scan_many",
                 lambda: scanner.scan_many([q, q[:-1] or "a"]))
        return times

    def reload(self, corpus):
        """Swap in a new corpus: the replacement scanner (and its device
        upload) is built, and the routes of the last :meth:`warmup` run
        on it once, outside the lock, so in-flight queries keep serving
        the old corpus until the atomic swap and the first request after
        it pays no first-run cost.  A route that fails raises before the
        swap, leaving the old corpus in service."""
        corpus = list(corpus)
        scanner = CorpusScanner(corpus, **self._build_kw)
        self.reload_warmup = self._warm(scanner, corpus, self._warm_full)
        with self._lock:
            self.corpus = corpus
            self.scanner = scanner
        return {"ok": True, "n": scanner.n}

    def _timed(self, fn, nq: int = 1):
        with self._lock:
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            self.stats["queries"] += nq
            self.stats["pairs"] += nq * self.scanner.n
            self.stats["device_seconds"] += dt
        return out

    def topk(self, query: str, k: int, score_cutoff=None):
        vals, ids = self._timed(
            lambda: self.scanner.topk(query, k, score_cutoff=score_cutoff))
        return {
            "values": np.asarray(vals).tolist(),
            "indices": np.asarray(ids).tolist(),
            "strings": [self.corpus[i] for i in np.asarray(ids)],
        }

    def distances(self, query: str, score_cutoff=None, score_hint=None):
        res = self._timed(
            lambda: self.scanner.distances(query,
                                           score_cutoff=score_cutoff,
                                           score_hint=score_hint))
        if score_cutoff is None:
            return {"values": np.asarray(res).tolist()}
        return {"values": np.asarray(res.values).tolist(),
                "valid": np.asarray(res.valid).tolist()}

    def batch(self, queries, k=None):
        out = self._timed(lambda: self.scanner.scan_many(queries, k=k),
                          nq=len(queries))
        if k is None:
            return {"values": np.asarray(out).tolist()}
        vals, ids = out
        return {"values": np.asarray(vals).tolist(),
                "indices": np.asarray(ids).tolist(),
                "strings": [[self.corpus[i] if i >= 0 else None
                             for i in row] for row in np.asarray(ids)]}


def make_server(service: ScanService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) an HTTP server bound to ``host:port``
    (port 0 picks a free one; see ``server.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):     # library core stays silent
            pass

        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"ok": True, "n": service.scanner.n,
                                  "metric": service.metric})
            elif self.path == "/stats":
                self._reply(200, service.stats)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                cutoff = req.get("score_cutoff")
                if self.path == "/topk":
                    out = service.topk(req["query"], int(req.get("k", 10)),
                                       score_cutoff=cutoff)
                elif self.path == "/distances":
                    out = service.distances(req["query"],
                                            score_cutoff=cutoff,
                                            score_hint=req.get(
                                                "score_hint"))
                elif self.path == "/batch":
                    k = req.get("k")
                    out = service.batch(list(req["queries"]),
                                        k=None if k is None else int(k))
                elif self.path == "/reload":
                    if "corpus" in req:
                        new_corpus = list(req["corpus"])
                    else:
                        with open(req["path"], encoding="utf-8") as f:
                            new_corpus = [ln.rstrip("\n") for ln in f]
                    out = service.reload(new_corpus)
                elif self.path in _NOT_PORTED:
                    return self._reply(400, {
                        "error": f"{self.path} is not ported yet"})
                else:
                    return self._reply(404, {"error": "unknown path"})
                self._reply(200, out)
            except Exception as e:          # noqa: BLE001 — serve errors
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True,
                    help="text file, one corpus string per line")
    ap.add_argument("--metric", default="levenshtein",
                    help="levenshtein, indel, lcs_seq, osa, jaro, "
                         "jaro_winkler, damerau_levenshtein or "
                         "partial_ratio")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8947)
    ap.add_argument("--bucket", type=int, default=None,
                    help="candidate bucket length (default: the codec's "
                         "bucket of the longest string); any length is "
                         "served, buckets over 1024 chars by the long "
                         "routes")
    ap.add_argument("--device", default=None,
                    help="torch device for the corpus and the scans "
                         "(default: cuda; 'cpu' runs the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--warmup", choices=("basic", "full"), default="basic",
                    help="routes to run before binding the port: 'basic' = "
                         "the plain distances scan (builds the kernels); "
                         "'full' also the cutoff/hint/top-k/scan_many "
                         "routes")
    args = ap.parse_args(argv)

    with open(args.corpus, encoding="utf-8") as f:
        corpus = [line.rstrip("\n") for line in f]
    service = ScanService(corpus, metric=args.metric, bucket=args.bucket,
                          device=args.device)
    t0 = time.perf_counter()
    table = service.warmup(full=args.warmup == "full")
    print(json.dumps({"warmup": table,
                      "warmup_seconds": round(time.perf_counter() - t0, 3)}),
          flush=True)
    server = make_server(service, args.host, args.port)
    print(json.dumps({"serving": True, "host": server.server_address[0],
                      "port": server.server_address[1],
                      "n": service.scanner.n}), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
