"""K11's plain version and the library's device route for one long pair,
on the CPU.

``pair_kernel.lev_pair_plain`` (through ``lev_pair_banded`` and
``lev_pair``) against the JAX package's ``ops/pallas/pair_kernel`` in
interpret mode, as ``tests/test_pallas.py`` runs it: raw banded values
bit for bit, at and above the cutoff (both run the same recurrence on the
same band), and the hint ladder's answers with the same rungs, each rung's
raw value included.  Then the public route under
``RAPIDFUZZ_TPU_SCALAR_BACKEND=device`` (its device pointed at the CPU)
against ``rapidfuzz_tpu.distance.levenshtein`` under the same variable,
and the host fallback past the band's ceiling.  Inputs are seeded numpy
pairs; the pairs share the JAX kernel's compilations (R = 1, a text of
1,025-1,536 chars) where a case allows.  The kernel itself is held to its
plain version on the card by the ``cuda``-marked test below and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu.distance import levenshtein as jlev
from rapidfuzz_tpu.ops.pallas import pair_kernel as jpk
from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.distance import levenshtein as lev
from rapidfuzz_tpu_torch.ops import cuda as kc
from rapidfuzz_tpu_torch.ops.cuda import pair_kernel as pk

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _edit(rng, a, n, alphabet):
    """``a`` with ``n`` random substitutions, deletions and insertions."""
    b = a.copy()
    for _ in range(n):
        op = rng.integers(0, 3)
        pos = int(rng.integers(0, b.size - 1))
        if op == 0:
            b[pos] = rng.choice(alphabet)
        elif op == 1:
            b = np.delete(b, pos)
        else:
            b = np.insert(b, pos, rng.choice(alphabet))
    return b


def _near_pair():
    """``tests/test_pallas.py``'s 1,400-char pair (40 edits)."""
    rng = np.random.default_rng(0)
    a = rng.integers(97, 101, 1400).astype(np.int64)
    return a, _edit(rng, a, 40, np.arange(97, 101))


def _far_pair():
    """2,600 x 1,500 random chars over 26 letters: the distance (2,107)
    exceeds one band's ceiling, so the ladder climbs to R = 2 (the text
    shares the other pairs' 1,536-char stream at R = 1)."""
    rng = np.random.default_rng(1)
    return (rng.integers(97, 123, 2600).astype(np.int64),
            rng.integers(97, 123, 1500).astype(np.int64))


def _wide_pair():
    """A near copy over Cyrillic and CJK code points (chars >= 256)."""
    rng = np.random.default_rng(2)
    alph = np.r_[np.arange(0x410, 0x450), np.arange(0x4E00, 0x4E40)]
    a = rng.choice(alph, 1300).astype(np.int64)
    return a, _edit(rng, a, 60, alph)


def _cases():
    a, b = _near_pair()
    exp = oracle.levenshtein_uniform(a, b)
    out = [("near K=exp", a, b, exp), ("near K=exp-1", a, b, exp - 1),
           ("near K=la-1", a, b, a.size - 1)]
    # identical runs: the add's carry ripples across every word of the run
    run = np.full(1500, 97, np.int64)
    out += [("run K=5", run, run[:1490], 5),
            ("run K=la-1", run, run[:1490], 1499)]
    # la - lb > K: the band never reaches the pattern's end
    out.append(("la-lb>K", a, a[:1100], 200))
    wa, wb = _wide_pair()
    wexp = oracle.levenshtein_uniform(wa, wb)
    out += [("wide K=exp", wa, wb, wexp), ("wide K=la-1", wb, wa,
                                           max(wa.size, wb.size) - 1)]
    return out


@pytest.mark.parametrize("case", range(8))
def test_banded_raw_values_match_jax(case):
    """``lev_pair_banded``'s raw value equals the JAX kernel's bit for bit,
    at, below and above the true distance."""
    what, a, b, K = _cases()[case]
    got = pk.lev_pair_banded(a, b, K, device=CPU)
    assert got == jpk.lev_pair_banded(a, b, K, interpret=True), what


def _ladder(monkeypatch, fn, mod, name, rung, a, b, **kw):
    """``fn(a, b, **kw)`` and the rungs it ran through ``mod``'s function
    ``name``: ``rung(out, *args, **kwargs)`` of each call, a
    ``(cutoff, R, raw value)``."""
    rungs = []
    inner = getattr(mod, name)

    def spy(*args, **k):
        out = inner(*args, **k)
        rungs.append(rung(out, *args, **k))
        return out

    monkeypatch.setattr(mod, name, spy)
    try:
        return fn(a, b, **kw), rungs
    finally:
        monkeypatch.setattr(mod, name, inner)


def _same_ladder(monkeypatch, a, b, **kw):
    """The port's rungs are its launches of ``_pair`` (the ladder stages
    the pair once), JAX's its calls of ``lev_pair_banded``."""
    got = _ladder(monkeypatch, pk.lev_pair, pk, "_pair",
                  lambda out, table, text, la, K, R: (K, R, int(out[0])),
                  a, b, device=CPU, **kw)
    ref = _ladder(monkeypatch, jpk.lev_pair, jpk, "lev_pair_banded",
                  lambda out, a, b, cutoff, **k: (cutoff, k.get("R"), out),
                  a, b, interpret=True, **kw)
    assert got == ref, kw
    return got


def test_ladder_matches_jax(monkeypatch):
    """``lev_pair``'s answer and rungs equal the JAX ladder's: no cutoff,
    cutoffs at and below the distance, a hint of 1 and a hint past the
    pattern's length."""
    a, b = _near_pair()
    exp = oracle.levenshtein_uniform(a, b)
    assert _same_ladder(monkeypatch, a, b)[0] == exp
    assert _same_ladder(monkeypatch, a, b, score_cutoff=exp)[0] == exp
    assert _same_ladder(monkeypatch, a, b, score_cutoff=exp - 1)[0] is None
    assert _same_ladder(monkeypatch, a, b, score_hint=1)[0] == exp
    assert _same_ladder(monkeypatch, a, b, score_hint=5000)[0] == exp
    # a gap past the cutoff answers without a rung
    assert _same_ladder(monkeypatch, a, a[:1100],
                        score_cutoff=200) == (None, [])


def test_ladder_escalates_like_jax(monkeypatch):
    """Past one band's ceiling the ladder climbs to R = 2: the rungs' raw
    values at R = 1 and 2 equal the JAX kernel's."""
    a, b = _far_pair()
    exp = oracle.levenshtein_uniform(a, b)
    assert exp > pk.max_cutoff(1)
    d, rungs = _same_ladder(monkeypatch, a, b)
    # the second band spans the pattern: K = la - 1
    assert d == exp and [r[:2] for r in rungs] == [(2047, 1), (2599, 2)]


def _text_pair():
    """~1,100 x 1,050 chars (a product past 10**6: the device route)."""
    rng = np.random.default_rng(3)
    alph = np.array(list("abcdefgh"))
    a = rng.choice(alph, 1100)
    b = np.delete(a, rng.choice(1100, 50, replace=False))
    b[rng.choice(b.size, 20, replace=False)] = "z"
    return "".join(a), "".join(b)


@pytest.fixture
def device_route(monkeypatch):
    """The device scalar backend on both sides, the port's device the
    CPU (the plain version)."""
    monkeypatch.setenv("RAPIDFUZZ_TPU_SCALAR_BACKEND", "device")
    monkeypatch.setattr(lev, "default_device", lambda: CPU)
    calls = []
    lev_pair = pk.lev_pair

    def spy(*args, **kw):
        calls.append(kw)
        return lev_pair(*args, **kw)

    monkeypatch.setattr(pk, "lev_pair", spy)
    return calls


def test_public_route_matches_jax(device_route):
    """The four scalar scores (and a ``_with_args`` form) with cutoffs and
    hints, uniform and under (2, 2, 2), equal the JAX module's under the
    device backend, through the pair kernel."""
    s1, s2 = _text_pair()
    exp = oracle.levenshtein_uniform(np.array([ord(c) for c in s1]),
                                     np.array([ord(c) for c in s2]))
    assert exp > 50
    mx = len(s1)
    calls = [
        ("distance", {}), ("distance", {"score_cutoff": exp}),
        ("distance", {"score_cutoff": exp - 1}),
        ("distance", {"score_hint": 1}),
        ("distance", {"weights": (2, 2, 2), "score_cutoff": 2 * exp - 1}),
        ("similarity", {"score_cutoff": mx - exp}),
        ("similarity", {"score_hint": mx}),
        ("normalized_distance", {"score_cutoff": 0.05}),
        ("normalized_distance", {"weights": (2, 2, 2), "score_hint": 0.2}),
        ("normalized_similarity", {"score_cutoff": 1 - exp / mx}),
        ("normalized_similarity", {"score_cutoff": 0.99}),
    ]
    for kind, kw in calls:
        got = getattr(lev, kind)(s1, s2, **kw)
        assert got == getattr(jlev, kind)(s1, s2, **kw), (kind, kw)
    args = lev.Args().score_cutoff(exp).score_hint(5)
    assert lev.distance_with_args(s1, s2, args) == exp
    assert len(device_route) == len(calls) + 1
    assert device_route[2] == {"score_cutoff": exp - 1, "score_hint": None,
                               "device": CPU}


def test_host_fallback_past_the_band(device_route, monkeypatch):
    """With the ceiling at R = 1 on both sides, a distance past it leaves
    the ladder with ``ValueError`` and takes the host route: the oracle's
    answer, as the JAX module's."""
    monkeypatch.setattr(pk, "ROWS", 1)
    monkeypatch.setattr(jpk, "ROWS", 1)
    a, b = _far_pair()
    exp = oracle.levenshtein_uniform(a, b)
    assert lev.distance(a, b) == jlev.distance(a, b) == exp
    assert len(device_route) == 1
    with pytest.raises(pk.BandLimit, match="band limit"):   # R = 2 at once
        pk.lev_pair(a, b, score_hint=2048, device=CPU)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """The wrapper checks the band and the table before any launch."""
    la, text, table = pk.stage_pair(np.arange(100), np.arange(50), CPU)
    assert table.shape == (100, 4) and text.tolist() == list(range(50))
    for K, R in ((100, 1), (10, 0), (10, 9), (-1, 1)):
        with pytest.raises(ValueError, match="cannot take"):
            pk._pair(table, text, la, K, R)
    with pytest.raises(ValueError, match="table"):
        pk._pair(table[:, :3].contiguous(), text, la, 5, 1)
    with pytest.raises(ValueError, match="requires cutoff < len"):
        pk.lev_pair_banded(np.arange(10), np.arange(9), 10, device=CPU)
    assert pk.lev_pair(np.arange(10), [], device=CPU) == 10
    assert pk.lev_pair(np.arange(10), [], score_cutoff=9, device=CPU) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6, 7, 8])
def test_pair_kernel_matches_plain_on_card(cuda_device, R):
    """K11 equals its plain version on the card at every band size, at
    the band's edge, and moves its counter once a rung."""
    a, b = _far_pair()
    K = min(pk.max_cutoff(R), a.size - 1)
    la, text, table = pk.stage_pair(a, b, cuda_device)
    before = kc.LAUNCHES["lev_pair"]
    got = pk._pair(table, text, la, K, R)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["lev_pair"] == before + 1
    assert torch.equal(got, pk.lev_pair_plain(table, text, la, K, R))
