"""Metric modules, mirroring ``rapidfuzz::distance`` (``src/lib.rs:97-100``);
the port carries ``levenshtein``, ``indel`` and ``lcs_seq`` so far
(ROADMAP.md queue 1)."""

from . import indel  # noqa: F401
from . import lcs_seq  # noqa: F401
from . import levenshtein  # noqa: F401

__all__ = ["indel", "lcs_seq", "levenshtein"]
