"""The partition of K11's band, on the CPU: a band of ``R * 128`` words
split over 4 warps x 32 lanes x ``R`` words, with the add's carry taken by
lookahead and only generate/propagate bits and one slide bit crossing
between lanes and warps, gives ``lev_pair_plain``'s raw value.

K11 (``csrc/lev_pair.cu``) gives each CUDA thread ``L`` consecutive band
words.  A step takes each word's sum ``(x & vp) + vp`` with no carry in;
a word generates a carry (its add carries out) or propagates one (its sum
is all ones), and the carry into word ``i`` of a mask pair ``(G, P)`` is
bit ``i`` of ``((G | P) + G + cin) ^ (G | P) ^ G``: over a thread's words,
over the ballots of a warp's threads, and over the four warps' bits, which
each warp publishes with bit 0 of its lowest ``x | vn``.  The slide bit
into a thread's top word, bit 0 of the next thread's ``d0``, is that
thread's bit of ``x | vn`` (a ballot, or the next warp's slot) or'ed with
the carry into it.  Here
that partition runs in plain PyTorch, every thread at once, and is held
against the unsplit ``lev_pair_plain`` at R = 1 and 2; the mutants that
drop the carry at a warp or lane edge or the slide bit at a warp edge must
disagree with it.  No JAX: ``test_torch_pair_kernel.py`` holds
``lev_pair_plain`` against the JAX kernel.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.ops.cuda import pair_kernel as pk
from rapidfuzz_tpu_torch.ops.cuda.lev_kernel import M32, u32

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
WARPS = 4


def _lookahead(G, P, cin):
    """The carry into each position of ``(G, P)`` masks: bit ``i`` of
    ``((G | P) + G + cin) ^ (G | P) ^ G``."""
    GP = G | P
    return (GP + G + cin) ^ GP ^ G


@torch.inference_mode()
def _split(table, text, la, K, R, warps=WARPS, drop=None):
    """K11's partition in plain PyTorch -> the raw banded distance.

    ``drop`` makes a mutant: ``"warp_carry"`` (no carry into a warp),
    ``"lane_carry"`` (no carry into a lane but a warp's lane 0) or
    ``"warp_slide"`` (no slide bit into a warp's top word)."""
    NT = 32 * warps
    L = 4 * R // warps
    NW, B = R * 128, R * 4096
    pad = torch.zeros((table.shape[0], NW + 1), dtype=torch.int64)
    tab = torch.cat([pad, u32(table), pad], 1)
    tab = tab[:, :-1] | (tab[:, 1:] << 32)       # words w, w + 1
    lo = B - 1 - K
    bit0 = 32 * torch.arange(NW)
    vp = (torch.full_like(bit0, M32) << (lo - bit0).clamp(0, 32)) & M32
    vn = torch.zeros(NW, dtype=torch.int64)
    lane = torch.arange(32)
    wv = torch.arange(warps)
    sh_l = torch.arange(L)
    all_l = (1 << L) - 1
    top = torch.arange(1, NT + 1) * L - 1          # each thread's top word
    up = torch.zeros(NW, dtype=torch.int64)
    dist = 0
    pstart = la - K
    for j, c in enumerate(text.tolist()):
        p0 = j + K + 1 - B
        w0 = (p0 >> 5) + NW + 1
        x = (tab[c, w0: w0 + NW] >> (p0 & 31)) & M32
        s = (x & vp) + vp
        g, s = s >> 32, s & M32
        G = (g.view(NT, L) << sh_l).sum(1)                   # [NT]
        P = ((s == M32).view(NT, L).long() << sh_l).sum(1)
        # the lanes' ballots: generate with no carry in, propagate
        gl = (((G | P) + G) >> L) & 1
        pl = (P == all_l).long()
        Gw = (gl.view(warps, 32) << lane).sum(1)             # [warps]
        Pw = (pl.view(warps, 32) << lane).sum(1)
        # the warps' slots: generate, propagate, bit 0 of lane 0's x | vn
        gw = (((Gw | Pw) + Gw) >> 32) & 1
        pw = (Pw == M32).long()
        low = (x[:: 32 * L] | vn[:: 32 * L]) & 1
        C4 = _lookahead((gw << wv).sum(), (pw << wv).sum(), 0)
        cw = (C4 >> wv) & 1
        slide = ((((low << wv).sum() | C4) & ((1 << warps) - 1))
                 >> (wv + 1)) & 1
        if drop == "warp_carry":
            cw = torch.zeros_like(cw)
        if drop == "warp_slide":
            slide = torch.zeros_like(slide)
        Cw = _lookahead(Gw, Pw, cw)                          # [warps]
        cl = (Cw[:, None] >> lane) & 1                       # [warps, 32]
        if drop == "lane_carry":
            cl[:, 1:] = 0
            Cw = Cw & 1
        # a lane's slide bit: bit 0 of the next lane's d0, which is the
        # carry into it or'ed with its ballot of bit 0 of x | vn; the next
        # warp's at lane 31
        Lw = (((x[::L] | vn[::L]) & 1).view(warps, 32) << lane).sum(1)
        nxt = ((Cw | Lw)[:, None] >> (lane + 1)) & 1
        nxt[:, 31] = slide
        cwd = _lookahead(G, P, cl.view(NT))
        s = (s + ((cwd[:, None] >> sh_l) & 1).view(NW)) & M32
        d0 = (s ^ vp) | x | vn
        hp = vn | (M32 ^ (d0 | vp))
        hn = d0 & vp
        if j < pstart:                               # diagonal phase
            dist += 1 - int(d0[NW - 1] >> 31)
        else:                                        # horizontal phase
            hb = max(B - 2 - (j - pstart), 0)
            w = hb >> 5
            dist += int((hp[w] >> (hb & 31)) & 1) \
                - int((hn[w] >> (hb & 31)) & 1)
        # the word above each: the thread's next word, or at its top word
        # the slide bit
        up[:-1] = d0[1:]
        up[top] = nxt.view(NT)
        d0s = (d0 >> 1) | ((up & 1) << 31)
        vp = hn | (M32 ^ (d0s | hp))
        vn = d0s & hp
    return K + dist


def _edit(rng, a, n, alphabet):
    """``a`` with ``n`` random substitutions, deletions and insertions."""
    b = a.copy()
    for _ in range(n):
        op, pos = rng.integers(0, 3), int(rng.integers(0, b.size - 1))
        if op == 0:
            b[pos] = rng.choice(alphabet)
        elif op == 1:
            b = np.delete(b, pos)
        else:
            b = np.insert(b, pos, rng.choice(alphabet))
    return b


def _case(name, R):
    """``(a, b, K)`` of the named case at band ``R``."""
    rng = np.random.default_rng(R * 10 + len(name))
    abc = np.arange(97, 101)
    K = pk.max_cutoff(R)
    if name == "identical runs":
        # x & vp + vp generates in every word: the carry crosses every
        # lane and warp edge
        return np.full(K + 300, 97), np.full(1000, 97), K
    if name == "near copy at the edge":
        a = rng.choice(abc, K + 60)
        return a, _edit(rng, a[:1050], 30, abc), K
    if name == "la - lb > K":
        return rng.choice(abc, K + 1100), rng.choice(abc, 1000), K
    # warp-edge run: at step 0 the band's upper two warps hold pattern
    # positions 0 .. B/2 - 1 with vp all ones; the text's first char
    # occurs only at the first position of each, so warp 2's carry runs
    # through all-ones words that end exactly at warp 3's first word;
    # later chars keep a 'z' at every warp edge of the pattern
    a = rng.choice(abc, K + 300)
    a[:: R * 1024] = 122
    b = np.r_[122, _edit(rng, a[1: 1000], 20, abc)]
    return a, b, K


NAMES = ("identical runs", "near copy at the edge", "la - lb > K",
         "warp-edge run")


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_split_matches_plain(name, R):
    a, b, K = _case(name, R)
    la, text, table = pk.stage_pair(a, b, CPU)
    want = int(pk.lev_pair_plain(table, text, la, K, R)[0])
    assert _split(table, text, la, K, R) == want


def test_one_warp_matches_plain():
    """K11's form at R = 1: one warp of 4 words a lane, no slots."""
    a, b, K = _case("near copy at the edge", 1)
    la, text, table = pk.stage_pair(a, b, CPU)
    want = int(pk.lev_pair_plain(table, text, la, K, 1)[0])
    assert _split(table, text, la, K, 1, warps=1) == want


@pytest.mark.parametrize("drop", ["warp_carry", "lane_carry", "warp_slide"])
def test_mutants_disagree(drop):
    """Each mutant of the partition differs from the plain version on a
    random pair at R = 1."""
    a, b, K = _case("la - lb > K", 1)
    la, text, table = pk.stage_pair(a, b, CPU)
    want = int(pk.lev_pair_plain(table, text, la, K, 1)[0])
    assert _split(table, text, la, K, 1, drop=drop) != want


def test_ladder_skips_bands_below_the_length_gap(monkeypatch):
    """A band whose cutoff is under ``la - lb`` certifies nothing (its raw
    value can fall under the cutoff): the ladder does not launch it.  At
    2,300 x 200 chars R = 1 (K = 2,047 < 2,100) is skipped and R = 2 gives
    the oracle's distance."""
    rng = np.random.default_rng(3)
    a, b = rng.integers(97, 101, 2300), rng.integers(97, 101, 200)
    la, text, table = pk.stage_pair(a, b, CPU)
    assert int(pk.lev_pair_plain(table, text, la, 2047, 1)[0]) <= 2047
    rungs = []

    def spy(table, text, la, K, R):
        rungs.append(R)
        return pk.lev_pair_plain(table, text, la, K, R)

    monkeypatch.setattr(pk, "_pair", spy)
    got = pk.lev_pair(a, b, device=CPU)
    assert rungs == [2]
    assert got == oracle.levenshtein_uniform(a, b) == 2100
