"""C++ scalar oracle (``native/oracle.cpp``): build-on-first-use ctypes
bindings.

The port's counterpart of ``rapidfuzz_tpu.oracle``: the same source and
g++ flags, built into the port's own build directory so the two packages
never share (or race on) one shared object.  Bound so far: the uniform
Levenshtein, indel and LCS entry points the ported scans are checked
against and the library's scalar paths use, weighted Levenshtein, and
OSA (``rf_osa`` and ``rf_osa_bp``), Jaro and Jaro-Winkler (``rf_jaro``,
``rf_jaro_winkler``), Damerau-Levenshtein (``rf_damerau`` and its
rolling-row form ``rf_damerau_rows``), and ``fuzz.partial_ratio``
(``rf_partial_ratio``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .. import BUILD_DIR

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "oracle.cpp")
_SO = os.path.join(BUILD_DIR, "_librf_oracle.so")

_lock = threading.Lock()
_lib = None


def _build() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    # -ffp-contract=off: no FMA contraction (same flags as the JAX
    # package's oracle build)
    cmd = ["g++", "-O2", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        out = getattr(e, "stderr", b"") or b""
        raise RuntimeError(f"oracle build failed: {out.decode()[:2000]}") from e
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            i64 = ctypes.c_int64
            p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.rf_levenshtein_uniform.restype = i64
            lib.rf_levenshtein_uniform.argtypes = [p64, i64, p64, i64]
            lib.rf_levenshtein_uniform_1vN.restype = None
            lib.rf_levenshtein_uniform_1vN.argtypes = [p64, i64, p64, p64,
                                                       i64, p64]
            lib.rf_levenshtein_uniform_bp.restype = i64
            lib.rf_levenshtein_uniform_bp.argtypes = [p64, i64, p64, i64,
                                                      i64]
            lib.rf_levenshtein_weighted.restype = i64
            lib.rf_levenshtein_weighted.argtypes = [p64, i64, p64, i64, i64,
                                                    i64, i64]
            lib.rf_indel.restype = i64
            lib.rf_indel.argtypes = [p64, i64, p64, i64]
            lib.rf_indel_bp.restype = i64
            lib.rf_indel_bp.argtypes = [p64, i64, p64, i64]
            lib.rf_indel_1vN.restype = None
            lib.rf_indel_1vN.argtypes = [p64, i64, p64, p64, i64, p64]
            lib.rf_lcs_seq.restype = i64
            lib.rf_lcs_seq.argtypes = [p64, i64, p64, i64]
            lib.rf_lcs_seq_bp.restype = i64
            lib.rf_lcs_seq_bp.argtypes = [p64, i64, p64, i64]
            lib.rf_osa.restype = i64
            lib.rf_osa.argtypes = [p64, i64, p64, i64]
            lib.rf_osa_bp.restype = i64
            lib.rf_osa_bp.argtypes = [p64, i64, p64, i64]
            lib.rf_jaro.restype = ctypes.c_double
            lib.rf_jaro.argtypes = [p64, i64, p64, i64]
            lib.rf_jaro_winkler.restype = ctypes.c_double
            lib.rf_jaro_winkler.argtypes = [p64, i64, p64, i64,
                                            ctypes.c_double]
            lib.rf_damerau.restype = i64
            lib.rf_damerau.argtypes = [p64, i64, p64, i64]
            lib.rf_damerau_rows.restype = i64
            lib.rf_damerau_rows.argtypes = [p64, i64, p64, i64]
            lib.rf_partial_ratio.restype = ctypes.c_double
            lib.rf_partial_ratio.argtypes = [p64, i64, p64, i64]
            _lib = lib
    return _lib


def _arr(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def levenshtein_uniform(a, b) -> int:
    a, b = _arr(a), _arr(b)
    return int(_load().rf_levenshtein_uniform(a, a.size, b, b.size))


def levenshtein_uniform_1vN(q, flat, offsets) -> np.ndarray:
    """Distances of ``q`` to each of ``len(offsets) - 1`` strings stored
    back to back in ``flat`` (string ``i`` is
    ``flat[offsets[i]:offsets[i + 1]]``)."""
    q, flat, offsets = _arr(q), _arr(flat), _arr(offsets)
    n = offsets.size - 1
    out = np.empty(n, np.int64)
    _load().rf_levenshtein_uniform_1vN(q, q.size, flat, offsets, n, out)
    return out


#: above this len1*len2 product the bit-parallel u64 kernels beat the
#: textbook row DP (the JAX package's oracle routes on the same product)
_BP_MIN_CELLS = 64


def levenshtein_uniform_bp(a, b, cutoff: int = -1) -> int:
    """Myers/Hyyrö u64 blockwise uniform Levenshtein.  ``cutoff >= 0``:
    banded, exact when the distance is <= cutoff, else ``cutoff + 1``;
    ``cutoff < 0``: full and exact."""
    a, b = _arr(a), _arr(b)
    return int(_load().rf_levenshtein_uniform_bp(a, a.size, b, b.size,
                                                 int(cutoff)))


def levenshtein_uniform_auto(a, b, cutoff=None, hint=None) -> int:
    """Uniform Levenshtein with the reference's one-shot routing
    (``levenshtein.rs:1104-1222``): tiny pairs on the quadratic DP, a
    caller cutoff bounds the band directly, a ``score_hint`` seeds a
    geometric band ladder (exactness never depends on the hint).

    Returns the exact distance when it is <= the cutoff, else any value
    above it (callers mask).  A cutoff at or above ``max(len)`` cannot
    reject anything and is clamped there, so it fits the C int64."""
    a, b = _arr(a), _arr(b)
    m, n = a.size, b.size
    lim = max(m, n)
    if cutoff is not None:
        cutoff = min(cutoff, lim)
    lib = _load()
    if m * n <= _BP_MIN_CELLS:
        d = int(lib.rf_levenshtein_uniform(a, m, b, n))
        return d if cutoff is None or d <= cutoff else int(cutoff) + 1
    if cutoff is not None and (hint is None or hint >= cutoff):
        return int(lib.rf_levenshtein_uniform_bp(a, m, b, n, int(cutoff)))
    if cutoff is None and hint is None and lim <= 512:
        # short pairs: one full blockwise pass beats the band ladder
        return int(lib.rf_levenshtein_uniform_bp(a, m, b, n, -1))
    k = max(int(hint) if hint is not None else 64, abs(m - n), 16)
    while True:
        if cutoff is not None:
            k = min(k, int(cutoff))
        r = int(lib.rf_levenshtein_uniform_bp(a, m, b, n, int(k)))
        if r <= k or k >= lim or (cutoff is not None and k >= cutoff):
            return r
        k = min(k * 4, lim)


def levenshtein_weighted(a, b, ins: int, dele: int, sub: int) -> int:
    a, b = _arr(a), _arr(b)
    return int(_load().rf_levenshtein_weighted(a, a.size, b, b.size, ins,
                                               dele, sub))


def indel(a, b) -> int:
    a, b = _arr(a), _arr(b)
    if a.size * b.size > _BP_MIN_CELLS:
        return int(_load().rf_indel_bp(a, a.size, b, b.size))
    return int(_load().rf_indel(a, a.size, b, b.size))


def indel_1vN(q, flat, offsets) -> np.ndarray:
    """Indel distances of ``q`` to each of ``len(offsets) - 1`` strings
    stored back to back in ``flat`` (as :func:`levenshtein_uniform_1vN`)."""
    q, flat, offsets = _arr(q), _arr(flat), _arr(offsets)
    n = offsets.size - 1
    out = np.empty(n, np.int64)
    _load().rf_indel_1vN(q, q.size, flat, offsets, n, out)
    return out


def lcs_seq(a, b) -> int:
    """LCS length (similarity), routed as :func:`indel`."""
    a, b = _arr(a), _arr(b)
    if a.size * b.size > _BP_MIN_CELLS:
        return int(_load().rf_lcs_seq_bp(a, a.size, b, b.size))
    return int(_load().rf_lcs_seq(a, a.size, b, b.size))


def osa(a, b) -> int:
    """Optimal string alignment distance, routed as :func:`indel`."""
    a, b = _arr(a), _arr(b)
    if a.size * b.size > _BP_MIN_CELLS:
        return int(_load().rf_osa_bp(a, a.size, b, b.size))
    return int(_load().rf_osa(a, a.size, b, b.size))


def osa_dp(a, b) -> int:
    """Quadratic textbook OSA (third opinion vs the bit-parallel path)."""
    a, b = _arr(a), _arr(b)
    return int(_load().rf_osa(a, a.size, b, b.size))


def osa_bp(a, b) -> int:
    """Hyyro u64 bit-parallel OSA, O(ceil(N/64)*M) (osa.rs:84-227)."""
    a, b = _arr(a), _arr(b)
    return int(_load().rf_osa_bp(a, a.size, b, b.size))


def jaro(a, b) -> float:
    """Jaro similarity (``jaro.rs:422-514``), f64."""
    a, b = _arr(a), _arr(b)
    return float(_load().rf_jaro(a, a.size, b, b.size))


def jaro_winkler(a, b, prefix_weight: float = 0.1) -> float:
    """Jaro-Winkler similarity (``jaro_winkler.rs:64-101``), f64."""
    a, b = _arr(a), _arr(b)
    return float(_load().rf_jaro_winkler(a, a.size, b, b.size,
                                         float(prefix_weight)))


def damerau(a, b) -> int:
    """Unrestricted Damerau-Levenshtein distance
    (``damerau_levenshtein.rs:111-168``): the full matrix, the rolling-row
    form for long inputs."""
    a, b = _arr(a), _arr(b)
    return int(_load().rf_damerau(a, a.size, b, b.size))


def damerau_rows(a, b) -> int:
    """Rolling-row Lowrance-Wagner (the long-input route inside
    :func:`damerau`), a second opinion for the tests."""
    a, b = _arr(a), _arr(b)
    return int(_load().rf_damerau_rows(a, a.size, b, b.size))


def partial_ratio(a, b) -> float:
    """Brute-force best-window indel ratio of the shorter input over every
    clipped window of the longer (``native/oracle.cpp:501``), f64: one
    indel DP per window, independent of the library's window sweeps."""
    a, b = _arr(a), _arr(b)
    return float(_load().rf_partial_ratio(a, a.size, b, b.size))
