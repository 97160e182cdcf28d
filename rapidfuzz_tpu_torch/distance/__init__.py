"""Metric modules, mirroring ``rapidfuzz::distance`` (``src/lib.rs:97-100``);
the port carries ``levenshtein`` so far (ROADMAP.md queue 1)."""

from . import levenshtein  # noqa: F401

__all__ = ["levenshtein"]
