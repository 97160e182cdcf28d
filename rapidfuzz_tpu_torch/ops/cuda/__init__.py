"""Hand-written Hopper kernels: build, load and launch bookkeeping.

Counterpart of ``rapidfuzz_tpu/ops/pallas/__init__.py``.  Every kernel
under ``rapidfuzz_tpu_torch/csrc/*.cu`` exposes a plain ``extern "C"``
entry point that launches on the caller's stream and returns the launch's
``cudaError_t``.  At first use :func:`load` compiles each source with its
own ``nvcc``, all started together, links the objects into one shared
library under :data:`rapidfuzz_tpu_torch.BUILD_DIR`, named by a hash of the
sources and flags (a changed source never loads a stale library), and
binds it with ctypes.  A failed build raises with nvcc's stderr; nothing
falls back.

:data:`LAUNCHES` counts kernel launches per kernel; a wrapper adds one at
the point where it launches its kernel and nowhere else, so a run can show
which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from ... import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last :func:`reset_launches`.  The
#: names follow the TPU kernels they replace: K1 at buckets > 1024 chars
#: counts as ``lev_scan_long`` (``stream_kernel._kernel``), K3 with the
#: caller's cutoff as its semiwidth as ``lev_band_rt``
#: (``band_kernel._kernel``) and K3 on the streamed-band route as
#: ``lev_band_long`` (``band_kernel._stream_kernel``); likewise K4 (the
#: LCS scan) at buckets > 1024 as ``lcs_scan_long``
#: (``stream_kernel._lcs_kernel``), K5 (the LCS band) on the streamed
#: route as ``lcs_band_long`` (``lcs_band_kernel._stream_kernel``), K6
#: (the OSA scan) at buckets > 1024 as ``osa_scan_long``
#: (``stream_kernel._osa_kernel``) and K7 (weighted Levenshtein) at
#: buckets > 1024 as ``wlev_scan_long`` (``stream_kernel._wlev_kernel``)
#: and K8 (the Jaro components) at buckets > 1024 as ``jaro_scan_long``
#: (``stream_kernel._jaro_kernel``).  K9 (Damerau-Levenshtein) splits at
#: the JAX package's Damerau bucket of 128 chars instead: its full form
#: counts as ``dam_scan`` up to it and ``dam_scan_long``
#: (``damerau_kernel._kernel_long``) past it, its banded form as
#: ``dam_band`` and ``dam_band_long`` (``_kernel_sqband_stream``).  K10
#: (``partial_ratio``'s window sweep) counts as ``partial_scan`` at every
#: bucket: it replaces ``partial_kernel._run`` (``_kernel_q`` and
#: ``_kernel``), which the TPU ran only up to 1024 chars.  K11 (one long
#: pair's band) counts as ``lev_pair``, once per rung of the hint ladder
#: (``pair_kernel._run``).
LAUNCHES = {"lev_scan": 0, "lev_scan_nq": 0, "remap_pack": 0, "lev_band": 0,
            "lev_band_rt": 0, "lev_band_long": 0, "lev_scan_long": 0,
            "lcs_scan": 0, "lcs_scan_nq": 0, "lcs_scan_long": 0,
            "lcs_band": 0, "lcs_band_long": 0, "osa_scan": 0,
            "osa_scan_nq": 0, "osa_scan_long": 0, "wlev_scan": 0,
            "wlev_scan_long": 0, "jaro_scan": 0, "jaro_scan_nq": 0,
            "jaro_scan_long": 0, "dam_scan": 0, "dam_scan_long": 0,
            "dam_band": 0, "dam_band_long": 0, "partial_scan": 0,
            "lev_pair": 0}

#: elements under which a PyTorch CPU op runs on one thread (its grain
#: size); the plain versions' CPU steps stay under it
PLAIN_GRAIN = 32768

_lock = threading.Lock()
_lib = None
#: seconds the last nvcc build took (None: the library was already built)
build_seconds = None
#: source file name -> ptxas's resource report (registers, shared memory,
#: spills per kernel) from the last build
ptxas_report: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    # pm, las, cand, lb, out, edge, B, b0, nb, lb4, W, nq, stream
    "rf_lev_scan": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I,
                    _P],
    # chars_t, vocab, out, B, lb4, stream
    "rf_remap_pack": [_P, _P, _P, _I64, _I, _P],
    # pm, ws, la, cut, semi, bw, cand, lb, out, B, lb4, threads, stream
    "rf_lev_band": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I64, _I, _I, _P],
    # pm, cand, lb, out, edge, B, b0, nb, lb4, W, nq, stream
    "rf_lcs_scan": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P],
    # pm, ws, bw, cand, lb, out, B, lb4, stream
    "rf_lcs_band": [_P, _I, _I, _P, _P, _P, _I64, _I, _P],
    # pm, las, cand, lb, out, edge, B, b0, nb, lb4, W, nq, stream
    "rf_osa_scan": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I,
                    _P],
    # pm, la, ins, del, sub, cand, lb, out, edge, B, b0, nb, lb4, stream
    "rf_wlev_scan": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I64, _I64, _I64,
                     _I, _P],
    # pm, tab, stride, smax, las, cand, lb, out, B, lb4, W, nq, stream
    "rf_jaro_scan": [_P, _P, _I, _I, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    # pm, la, cand, lb, out, scratch, B, b0, nb, lb4, stream
    "rf_dam_scan": [_P, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I, _P],
    # pm, ws, la, kband, cand, lb, out, B, lb4, stream
    "rf_dam_band": [_P, _I, _I, _I, _P, _P, _P, _I64, _I, _P],
    # pm, la, cand, lb, out, scratch, B, b0, nb, lb4, W, stream
    "rf_partial_scan": [_P, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I,
                        _P],
    # pm, nwt, text, la, lb, K, R, out, stream
    "rf_lev_pair": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
}


def default_device() -> torch.device:
    """``cuda``: the port's entry points run on the card unless the caller
    passes ``device="cpu"``.  Raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return torch.device("cuda")


def plain_slice(B: int, width: int, dev: torch.device) -> int:
    """Candidates per slice of a plain version: all ``B`` on the card, on
    the CPU few enough that a step's ``[b, width]`` tensors stay under
    :data:`PLAIN_GRAIN` and run on one thread."""
    return B if dev.type != "cpu" else max(1, PLAIN_GRAIN // width)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librf_cuda_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> list[str]:
    """Run the commands in parallel; raise with the first failure's
    stderr once all have ended, else return each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [(c, p.communicate()[1], p.returncode) for c, p in
            zip(cmds, procs)]
    for c, err, rc in errs:
        if rc != 0:
            raise RuntimeError(f"nvcc build failed ({' '.join(c)}):\n"
                               f"{err[-8000:]}")
    return [err for _, err, _ in errs]


def build() -> str:
    """Compile ``csrc/*.cu`` into the build directory (once per content
    hash): one ``nvcc -c`` per source, all at once, then one link.
    Returns the library's path."""
    global build_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{so}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{stem}.{os.path.basename(src)}.o" for src in _sources()]
    t0 = time.perf_counter()
    try:
        # -Xptxas -v reports each kernel's registers and spills; it does
        # not change the code
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src,
                          "-o", obj] for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{stem}.tmp",
                   *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{stem}.tmp", so)
    build_seconds = time.perf_counter() - t0
    ptxas_report.clear()
    ptxas_report.update({os.path.basename(src): log
                         for src, log in zip(_sources(), logs)})
    return so


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Launch C entry point ``entry`` on ``device``'s current stream,
    count it under ``name``, and raise on a nonzero ``cudaError_t``."""
    fn = getattr(load(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          device: torch.device | None = None) -> None:
    """Validate a kernel argument's dtype, rank, contiguity and device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
