"""Banded uniform Levenshtein for ONE long pair, on Hopper.

Counterpart of ``rapidfuzz_tpu/ops/pallas/pair_kernel.py``: the device
route of the library's scalar scores for one long uniform pair (the
reference's Ukkonen-banded block kernel, ``levenshtein.rs:769-1019``; its
proof fixture is the 106,514 x 107,244-char OCR pair of distance 5,278).
``csrc/lev_pair.cu`` (K11, launch name ``lev_pair``) replaces
``pair_kernel._kernel`` (``_run``).

The band.  The pattern ``a`` is the longer string, the text ``b`` the
shorter.  A band of ``B = R * 4096`` bits (``R`` in 1-8, the first from
the hint, then doubled; ``R * 128`` u32 words) slides one bit per text char: at text step ``j`` band
bit ``k`` stands for pattern position ``j + K + 1 - B + k``, its top bit
for ``j + K``.  VP starts with its top ``K + 1`` bits set, VN at 0, the
distance at ``K``.  Each step runs the Myers/Hyyrö band step on a
multi-word big integer: ``(x & vp) + vp`` with its carry across words,
``d0 >> 1`` taking bit 0 of the next word, and a distance delta that is
the inverse of the band's top bit while ``j < la - K`` (the diagonal
phase) and then ``hp - hn`` at bit ``max(B - 2 - (j - la + K), 0)``.
The result is exact when it is ``<= K``, otherwise only certified to
exceed ``K``.  :func:`lev_pair` climbs the score-hint ladder of the JAX
package (``levenshtein.rs:1069-1088``): ``R`` doubles until the result is
certified; past :data:`ROWS` it raises :class:`BandLimit` and the caller
takes the host route.

Not ported: the TPU's PM-window stream (``build_band_stream``), an XLA
prepass of ``[lb, R, 128]`` u32 words (R * 512 bytes a text char, 56 MB a
rung for the OCR pair at R = 4) that existed because the v5e's scalar
shifts were slow.  Here the pattern's PM table is built once per pair, as
``[V, table_words(la)]`` u32 (``ceil(la / 32)`` words) over the pair's
local vocabulary (``V`` distinct symbols of both strings; a text symbol
absent from the pattern has a zero row), and every
rung reads it: the window of band word ``k`` at step ``j`` joins table
words ``p0 // 32 + k`` and ``+ 1`` (``p0 = j + K + 1 - B``, which may be
negative) with one funnel shift, and a word index outside the table reads
as 0.  The table takes about ``V * la / 8`` bytes: 1.8 MB for the OCR pair
(137 symbols), about 67 MB for a pair of ~107,000 chars over 5,000
symbols, which an 80 GB card holds.

K11 runs one block a pair: at R = 1 one warp holding 4 band words a lane,
from R = 2 four warps, one a scheduler of the SM, holding R words a
thread.  The add's carry comes by lookahead (generate/propagate masks over
a thread's words, a warp's ballots and the four warps' slots in shared
memory, one barrier a step), and each thread loads its window one to
four steps ahead into registers (``csrc/lev_pair.cu`` has the design).

The plain version (:func:`lev_pair_plain`) runs the same recurrence on
the same state words, one text step at a time, the add's carry taken from
a ``cummax`` over the indices of the words that do not propagate one.
It serves the CPU (the tests) and, on a card, the comparisons of
``chip_smoke.py``; the wrapper runs it only for CPU tensors and launches
K11 for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, default_device, launch
from .lev_kernel import M32, u32

#: largest band, in units of 4,096 bits (the JAX module's name: there the
#: band's rows of a [8, 128] tile)
ROWS = 8
BAND_BITS = 4096     # bits of the band at R = 1 (128 u32 words)
HINT_DEFAULT = 31    # the ladder's first hint with no hint and no cutoff


class BandLimit(ValueError):
    """The pair's distance lies past the largest band's ceiling,
    ``max_cutoff(ROWS)``: the caller takes the host route."""



def max_cutoff(R: int) -> int:
    """Largest cutoff a band of ``R * 4096`` bits certifies."""
    return R * 2048 - 1


def band_rows(cutoff: int) -> int:
    """Smallest ``R`` whose band certifies ``cutoff``."""
    return max(1, -(-(2 * cutoff + 2) // BAND_BITS))


def table_words(la: int) -> int:
    """Words of a PM table row for a pattern of ``la`` chars:
    ``ceil(la / 32)`` (the bits past the pattern are 0)."""
    return -(-la // 32)


def stage_pair(a, b, device=None):
    """``(la, text, table)`` for the pair on ``device``: the longer string
    is the pattern (``la`` chars), the shorter the text, ``[lb]`` int32
    local ids, and ``table`` the pattern's ``[V, table_words(la)]`` PM words
    (int32 bit patterns; bit ``p % 32`` of ``table[c, p // 32]`` set iff
    the pattern's char ``p`` has local id ``c``).  Ids index the sorted
    distinct symbols of both strings, as the JAX wrapper remaps them."""
    dev = torch.device(device) if device is not None else default_device()
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    if a.size < b.size:
        a, b = b, a
    vocab = np.unique(np.concatenate([a, b]))
    a32 = np.searchsorted(vocab, a)
    pos = np.arange(a.size)
    table = np.zeros((vocab.size, table_words(a.size)), np.uint32)
    # each (row, word, bit) is set once, so the add is an or
    np.add.at(table, (a32, pos >> 5), np.uint32(1) << (pos & 31).astype(
        np.uint32))
    text = torch.from_numpy(np.searchsorted(vocab, b).astype(np.int32))
    return (int(a.size), text.to(dev),
            torch.from_numpy(table.view(np.int32)).to(dev))


@torch.inference_mode()
def lev_pair_plain(table: torch.Tensor, text: torch.Tensor, la: int, K: int,
                   R: int) -> torch.Tensor:
    """Plain PyTorch K11 -> ``[1]`` int32: the raw banded distance of the
    staged pair (:func:`stage_pair`), exact when ``<= K``.

    The band's ``R * 128`` words are int64 tensors of 32-bit values.  Each
    step reads its window from a copy of the table padded by one band of
    zero words on each side (a window before or past the pattern reads
    zeros) whose column ``w`` holds words ``w`` and ``w + 1`` in its low
    and high halves, so one shift takes the funnel shift of every word;
    the text char's row is a basic index, the text read to the host once
    (one sync on a card)."""
    NW = R * 128
    B = NW * 32
    dev = text.device
    pad = torch.zeros((table.shape[0], NW + 1), dtype=torch.int64,
                      device=dev)
    tab = torch.cat([pad, u32(table), pad], 1)
    tab = tab[:, :-1] | (tab[:, 1:] << 32)
    ar = torch.arange(NW, device=dev)
    lo = B - 1 - K                                  # VP: bits >= lo set
    vp = (torch.full_like(ar, M32) << (lo - 32 * ar).clamp(0, 32)) & M32
    vn = torch.zeros(NW, dtype=torch.int64, device=dev)
    # slot w + 1 of gen and kill is word w's: gen its generate bit, kill
    # its index + 1 where it does not propagate a carry (its sum is not
    # all ones) and -1 where it does; slot 0 is a word before the band that
    # generates none.  d0n[NW] is the word past the band's top, 0.
    ar1 = torch.arange(1, NW + 1, device=dev)
    neg = torch.full_like(ar1, -1)
    gen = torch.zeros(NW + 1, dtype=torch.int64, device=dev)
    kill = torch.zeros(NW + 1, dtype=torch.int64, device=dev)
    d0n = torch.zeros(NW + 1, dtype=torch.int64, device=dev)
    dist = torch.zeros((), dtype=torch.int64, device=dev)
    pstart = la - K
    for j, c in enumerate(text.tolist()):
        p0 = j + K + 1 - B
        w0 = (p0 >> 5) + NW + 1                     # padded word index
        x = (tab[c, w0: w0 + NW] >> (p0 & 31)) & M32
        s = (x & vp) + vp
        torch.bitwise_right_shift(s, 32, out=gen[1:])
        s &= M32
        # the carry into word w: the generate bit of the last word < w
        # that does not propagate one
        torch.where(s == M32, neg, ar1, out=kill[1:])
        s += gen.index_select(0, torch.cummax(kill, 0).values[:NW])
        d0 = ((s & M32) ^ vp) | x | vn
        hp = vn | (M32 ^ (d0 | vp))
        hn = d0 & vp
        if j < pstart:                              # diagonal phase:
            dist -= d0[NW - 1] >> 31                # 1 - the top bit
        else:                                       # horizontal phase
            hb = max(B - 2 - (j - pstart), 0)
            w, bit = hb >> 5, hb & 31
            dist += ((hp[w] >> bit) & 1) - ((hn[w] >> bit) & 1)
        d0n[:NW] = d0
        d0s = (d0n[1:] << 31 | d0 >> 1) & M32
        vp = hn | (M32 ^ (d0s | hp))
        vn = d0s & hp
    return (dist + K + min(pstart, text.numel())).reshape(1).to(torch.int32)


def _pair(table: torch.Tensor, text: torch.Tensor, la: int, K: int,
          R: int) -> torch.Tensor:
    """K11 -> ``[1]`` int32 (kernel on CUDA tensors, plain version on CPU
    tensors)."""
    dev = text.device
    check(text, "text", torch.int32, 1)
    check(table, "table", torch.int32, 2, dev)
    if table.shape[1] != table_words(la):
        raise ValueError(f"table {tuple(table.shape)} for a pattern of {la}")
    if not 1 <= R <= ROWS or not 0 <= K <= min(max_cutoff(R), la - 1):
        raise ValueError(f"band R={R} cannot take cutoff {K} (la={la})")
    if dev.type == "cpu":
        return lev_pair_plain(table, text, la, K, R)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    launch("lev_pair", "rf_lev_pair", dev, table.data_ptr(), table.shape[1],
           text.data_ptr(), la, text.numel(), K, R, out.data_ptr())
    return out


def lev_pair_banded(a, b, cutoff: int, *, R: int | None = None,
                    device=None) -> int:
    """Banded distance of one pair, exact when the result is ``<= cutoff``
    (above it only certified to exceed it), as
    ``pair_kernel.lev_pair_banded``."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    la, lb = max(a.size, b.size), min(a.size, b.size)
    if lb == 0:
        return la
    if R is None:
        R = band_rows(cutoff)
    if cutoff > max_cutoff(R):
        raise ValueError(f"cutoff {cutoff} needs R > {R}")
    if cutoff >= la:
        raise ValueError("banded pair kernel requires cutoff < len")
    _, text, table = stage_pair(a, b, device)
    return int(_pair(table, text, la, int(cutoff), R)[0])


def lev_pair(a, b, *, score_cutoff: int | None = None,
             score_hint: int | None = None, device=None) -> int | None:
    """Uniform Levenshtein of one long pair on ``device``, exact
    (``pair_kernel.lev_pair``).

    Score-hint ladder (``levenshtein.rs:1069-1088``): the first band from
    ``min(score_hint, score_cutoff)`` (31 with neither), clamped to
    ``[1, la - 1]``; ``R`` doubles until the result is certified exact,
    certified above ``score_cutoff`` (``None``), or the band spans the
    pattern.  A band whose cutoff is under ``la - lb`` is not launched:
    the distance exceeds its cutoff, but its raw value need not (the JAX
    ladder launches it and can return that value as exact).  Raises
    :class:`BandLimit` when it would need ``R >`` :data:`ROWS` (a distance
    past ``max_cutoff(ROWS)`` = 16,383): the caller then takes the host
    route."""
    a = np.asarray(np.asarray(a), np.int64)
    b = np.asarray(np.asarray(b), np.int64)
    la, lb = max(a.size, b.size), min(a.size, b.size)
    if lb == 0:
        return la if score_cutoff is None or la <= score_cutoff else None
    if score_cutoff is not None and la - lb > score_cutoff:
        return None
    cands = [v for v in (score_hint, score_cutoff) if v is not None]
    hint = max(min(min(cands) if cands else HINT_DEFAULT, la - 1), 1)
    R = band_rows(hint)
    table = None
    while True:
        if R > ROWS:
            raise BandLimit(
                f"distance exceeds the device band limit "
                f"{max_cutoff(ROWS)}; use the host oracle path")
        K = min(max_cutoff(R), la - 1)
        if K < la - lb:
            # the distance is at least la - lb > K, but this band's raw
            # value may fall under K: it certifies nothing, so skip it
            R *= 2
            continue
        if table is None:                  # once: every rung reads it
            _, text, table = stage_pair(a, b, device)
        dist = int(_pair(table, text, la, K, R)[0])
        if dist <= K:                      # certified exact
            if score_cutoff is not None and dist > score_cutoff:
                return None
            return dist
        if score_cutoff is not None and K >= score_cutoff:
            return None                    # certified above the cutoff
        if K >= la - 1:
            return dist                    # band spans everything
        R *= 2
