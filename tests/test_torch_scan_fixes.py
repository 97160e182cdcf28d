"""Two repairs in the port's scanner and server, on the CPU.

* ``CorpusScanner`` and ``ScanService(..., weights=...)`` take the
  Levenshtein weights as a ``WeightTable`` or as a tuple, as the JAX
  scanner does (``as_weight_table``), and give the JAX scanner's
  distances for both forms.
* ``ScanService.reload`` runs the new scanner's routes once, outside the
  lock and before the swap, as ``warmup`` ran the first scanner's; a
  reloaded service then answers as a fresh one over the new corpus.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from rapidfuzz_tpu.distance.levenshtein import WeightTable as JaxWeightTable
from rapidfuzz_tpu.parallel.scan import CorpusScanner as JaxScanner
from rapidfuzz_tpu_torch.distance.levenshtein import WeightTable
from rapidfuzz_tpu_torch.parallel import CorpusScanner
from rapidfuzz_tpu_torch.parallel import scan as scan_mod
from rapidfuzz_tpu_torch.serve import ScanService, make_server

CORPUS = ["sitting", "mitten", "kitten", "", "kittenkitten", "sitt",
          "a" * 40, "kitchen", "Иванко", "k", "kitten"]


@pytest.mark.parametrize("form", ["table", "tuple"])
@pytest.mark.parametrize("costs", [(1, 1, 2), (2, 2, 2)])
def test_weight_forms_match_jax(form, costs):
    """``(1, 1, 2)`` reduces to indel, ``(2, 2, 2)`` to twice uniform
    Levenshtein; either form, through the scanner and the service, gives
    the JAX scanner's distances (fed the JAX package's own table)."""
    weights = WeightTable(*costs) if form == "table" else costs
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    js = JaxScanner(CORPUS, weights=JaxWeightTable(*costs), mesh=mesh)
    ps = CorpusScanner(CORPUS, weights=weights, device="cpu")
    assert (ps.metric, ps._wscale) == (js.metric, js._wscale)
    for q in ("kitten", "Иван", ""):
        want = js.distances(q)
        np.testing.assert_array_equal(ps.distances(q), want)
        service = ScanService(CORPUS, weights=weights, device="cpu")
        assert service.distances(q)["values"] == want.tolist()


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("metric", ["levenshtein", "osa"])
def test_reload_warms_then_answers_as_fresh(monkeypatch, metric):
    """After a full warmup, ``/reload`` runs the full warmup's routes on
    the new scanner while the old one still serves, then swaps; ``/topk``
    and ``/distances`` over HTTP then equal a fresh service's over the
    new corpus."""
    service = ScanService(CORPUS, metric=metric, bucket=64, device="cpu")
    table = service.warmup(full=True)
    new = ["zebra", "zebu", "", "arbez", "zebras", "ebra"]
    seen = []
    real = scan_mod.CorpusScanner.topk

    def topk(self, *a, **kw):
        seen.append(self is service.scanner)
        return real(self, *a, **kw)

    monkeypatch.setattr(scan_mod.CorpusScanner, "topk", topk)
    server = make_server(service, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert _post(port, "/reload", {"corpus": new}) == {"ok": True,
                                                           "n": len(new)}
        # the warmup's top-k ran on the new scanner before the swap
        assert seen == [False]
        assert service.reload_warmup.keys() == table.keys()
        assert all(isinstance(v, float)
                   for v in service.reload_warmup.values())
        fresh = ScanService(new, metric=metric, bucket=64, device="cpu")
        for q in ("zebra", "bre", ""):
            assert _post(port, "/topk", {"query": q, "k": 3}) \
                == fresh.topk(q, 3)
            assert _post(port, "/distances", {"query": q,
                                              "score_cutoff": 2}) \
                == fresh.distances(q, score_cutoff=2)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
