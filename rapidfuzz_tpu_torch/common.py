"""Score algebra and cutoff semantics shared by every metric.

The port's own copy of ``rapidfuzz_tpu/common.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_import.py`` holds the two
to the same behaviour.  It mirrors the observable contract of the
reference's metric algebra traits (``src/details/distance.rs``) and cutoff
typestates (``src/common.rs``):

* every metric defines ``maximum(len1, len2)`` and one primitive score; the
  other three score kinds derive from it:
  ``sim = maximum - dist``; ``norm_dist = dist / maximum`` (``0.0`` when
  ``maximum == 0``, ``distance.rs:247-251``); ``norm_sim = 1 - norm_dist``.
* ``score_cutoff`` changes the return type: distances keep ``raw <= cutoff``
  (``common.rs:43-45``), similarities keep ``raw >= cutoff``
  (``common.rs:83-85``); filtered-out results are ``None`` (scalar API) or
  masked out (batch API).  The reference's internal cutoff plumbing only
  prunes work and never changes which results survive, so the port
  computes true scores and applies the cutoff as a mask.
* ``score_hint`` is accepted everywhere for API parity; it is a pure
  performance hint in the reference (``levenshtein.rs:1176-1220``) and
  never changes results.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np

__all__ = [
    "ArgsBase", "apply_distance_cutoff", "apply_similarity_cutoff",
    "norm_dist_from_dist", "mask_distance", "mask_similarity",
    "scalar_backend",
]


def scalar_backend() -> str:
    """'cpp' (host oracle) or 'device' for one-shot scalar calls
    (``RAPIDFUZZ_TPU_SCALAR_BACKEND``, the JAX package's switch)."""
    return os.environ.get("RAPIDFUZZ_TPU_SCALAR_BACKEND", "cpp")


class ArgsBase:
    """Builder-style args mirroring the reference ``Args`` typestates.

    ``Args().score_cutoff(2).score_hint(5)``; presence of a cutoff switches
    the result type from ``T`` to ``Optional[T]`` as ``NoScoreCutoff`` /
    ``WithScoreCutoff`` select it at compile time in the reference.
    """

    __slots__ = ("cutoff", "hint")

    def __init__(self):
        self.cutoff: Optional[float] = None
        self.hint: Optional[float] = None

    def _copy(self):
        return copy.copy(self)

    def score_cutoff(self, v):
        new = self._copy()
        new.cutoff = v
        return new

    def score_hint(self, v):
        new = self._copy()
        new.hint = v
        return new


# ------------------------------------------------------------ scalar algebra

def apply_distance_cutoff(raw, cutoff):
    """raw distance -> raw | None under a distance cutoff."""
    if cutoff is None:
        return raw
    return raw if raw <= cutoff else None


def apply_similarity_cutoff(raw, cutoff):
    if cutoff is None:
        return raw
    return raw if raw >= cutoff else None


def norm_dist_from_dist(dist, maximum) -> float:
    return 0.0 if maximum == 0 else dist / maximum


# ------------------------------------------------------------- batch algebra

def mask_distance(raw: np.ndarray, cutoff) -> tuple[np.ndarray, np.ndarray]:
    """(values, valid) for a batch of distances under an optional cutoff."""
    raw = np.asarray(raw)
    if cutoff is None:
        return raw, np.ones(raw.shape, bool)
    return raw, raw <= cutoff


def mask_similarity(raw: np.ndarray, cutoff) -> tuple[np.ndarray, np.ndarray]:
    raw = np.asarray(raw)
    if cutoff is None:
        return raw, np.ones(raw.shape, bool)
    return raw, raw >= cutoff
