"""Bit-vector primitives on u32 words, in plain PyTorch.

Counterpart of ``rapidfuzz_tpu/ops/bitpack.py``.  The reference's core
data structure is the pattern-match (PM) bitvector table, one mask per
symbol with bit ``i`` set iff ``pattern[i] == symbol``
(``src/details/pattern_match_vector.rs``).  The aligned-pair batches
materialise the per-text-position PM columns from an equality matrix, as
the JAX package does.  Words are int64 tensors holding u32 values in
``[0, 2**32)``: torch's ``uint32`` supports too few operations, and int64
keeps shifts logical and sums exact (callers mask to 32 bits).
"""

from __future__ import annotations

import torch

WORD = 32
M32 = 0xFFFFFFFF


def eq_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality matrix ``eq[..., j, i] = (b[..., j] == a[..., i])``, with
    PAD (< 0) pattern positions never matching."""
    return (b[..., :, None] == a[..., None, :]) & (a[..., None, :] >= 0)


def pack_bits(eq: torch.Tensor) -> torch.Tensor:
    """Pack a boolean array's last axis (a multiple of 32) into u32 words:
    ``eq[..., N] -> out[..., N // 32]``, bit ``k`` of word ``w`` =
    ``eq[..., w*32 + k]``."""
    n = eq.shape[-1]
    if n % WORD:
        raise ValueError(f"last axis {n} is not a multiple of {WORD}")
    e = eq.reshape(*eq.shape[:-1], n // WORD, WORD).to(torch.int64)
    weights = torch.ones(WORD, dtype=torch.int64, device=eq.device) \
        << torch.arange(WORD, device=eq.device)
    return (e * weights).sum(-1)


def pm_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PM columns for a batch of pairs: ``[B, LB, W]`` u32 words, bit ``k``
    of ``pm[b, j, w]`` set iff ``a[b, w*32 + k] == b[b, j]``
    (``levenshtein.rs:843``'s ``pm.get(word, ch2)``)."""
    return pack_bits(eq_matrix(a, b))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 word (SWAR count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def test_bit(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` (>= 0) of a multi-word little-endian bitvector
    ``words[..., W]``, as int64 0/1."""
    word = words.gather(-1, (pos >> 5)[..., None])[..., 0]
    return (word >> (pos & 31)) & 1


def add_with_carry(x: torch.Tensor, y: torch.Tensor, c):
    """``(x + y + c) mod 2**32`` and its carry-out, u32 words
    (``carrying_add``, ``src/details/intrinsics.rs:25-29``)."""
    s = x + y + c
    return s & M32, s >> 32
