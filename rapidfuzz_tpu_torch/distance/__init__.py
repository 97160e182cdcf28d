"""Metric modules, mirroring ``rapidfuzz::distance`` (``src/lib.rs:97-100``);
the port carries ``levenshtein``, ``indel``, ``lcs_seq`` and ``osa`` so far
(ROADMAP.md queue 1)."""

from . import indel  # noqa: F401
from . import lcs_seq  # noqa: F401
from . import levenshtein  # noqa: F401
from . import osa  # noqa: F401

__all__ = ["indel", "lcs_seq", "levenshtein", "osa"]
