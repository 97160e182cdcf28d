"""Metric modules, mirroring ``rapidfuzz::distance`` (``src/lib.rs:97-100``);
the port carries ``levenshtein``, ``indel``, ``lcs_seq``, ``osa``, ``jaro``,
``jaro_winkler`` and ``damerau_levenshtein`` so far (ROADMAP.md queue 1)."""

from . import damerau_levenshtein  # noqa: F401
from . import indel  # noqa: F401
from . import jaro  # noqa: F401
from . import jaro_winkler  # noqa: F401
from . import lcs_seq  # noqa: F401
from . import levenshtein  # noqa: F401
from . import osa  # noqa: F401

__all__ = ["damerau_levenshtein", "indel", "jaro", "jaro_winkler", "lcs_seq",
           "levenshtein", "osa"]
