"""K8's two walks, on the CPU: the cursor form's per-char cursors over the
query's positions (its tables staged by ``jaro_kernel.cursor_tables``) and
the register form's pass 2 over stored text chars give the components of
``jaro_scan_plain`` and the C++ oracle's Jaro.

K8 (``csrc/jaro_scan.cu``) runs queries of more than ``MAX_REG_W`` words
as a cursor walk: text char ``c`` at step ``j`` moves ``c``'s cursor past
the positions under ``max(j - bound, pref)`` and claims the one there if
it is at most ``j + bound``; the prefix is found on the same cursors;
pass 2 replays the walk from reset cursors and pops the lowest claimed
pattern position left for each claim.  Shorter queries keep the window
and flags in registers and store each flagged text char, so that pass 2
pairs the k-th claimed pattern position with the k-th stored char.  This
file's models (:func:`cursor_walk`, :func:`register_walk`) mirror those
loops pair by pair over the staged bytes and the PM table.  No JAX:
``test_torch_jaro_scan.py`` holds ``jaro_scan_plain`` against the JAX Jaro
kernels.
"""

import numpy as np
import pytest
import torch

from rapidfuzz_tpu_torch import oracle
from rapidfuzz_tpu_torch.distance.jaro import sim_from_components
from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel as jk
from rapidfuzz_tpu_torch.ops.cuda import lev_kernel as lk

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ALPHABET = np.array([0, 32, 97, 98, 99, 100, 101, 200, 255])
ABSENT = np.array([102, 103, 104])   # text chars no query holds


def decode(tab: torch.Tensor, W: int, smax: int):
    """One query's staged bytes -> (slot, off, pos, pch) as numpy."""
    b = tab.view(torch.uint8).numpy()
    o_off, o_pos, o_pch, stride = jk.cursor_layout(W, smax)
    dt = np.dtype(np.uint16 if jk.idx16(W) else np.uint32)
    assert b.size == stride
    return (b[:o_off].view(np.int16).astype(np.int64),
            b[o_off:o_off + dt.itemsize * smax].view(dt).astype(np.int64),
            b[o_pos:o_pos + dt.itemsize * (32 * W + smax + 1)].view(dt)
            .astype(np.int64), b[o_pch:stride].astype(np.int64))


def _pair(la, n):
    bound = max(max(la, n) // 2 - 1, 0)
    return bound, min(la, n + bound), min(n, la + bound)


def cursor_walk(text, la, tables, smax):
    """The cursor form on one pair -> (common, raw transpositions)."""
    slot, off, pos, pch = tables
    n = len(text)
    if la == 0 or n == 0:
        return 0, 0
    bound, len1, len2 = _pair(la, n)
    top = la - 1

    def step(cur, j, pref):
        """Text char j at its row's cursor -> the claimed position or
        None (the cursor moved past the positions under the window)."""
        s = slot[text[j]]
        if s < 0:
            return None
        lo, hi = max(j - bound, pref), min(j + bound, top)
        k = cur[s]
        while pos[k] < lo:
            k += 1
        if pos[k] <= hi:
            cur[s] = k + 1
            return pos[k]
        cur[s] = k
        return None

    cur = [int(off[s]) for s in range(smax)]
    pref = 0
    while pref < min(len1, len2):
        s = slot[text[pref]]
        if s < 0 or pos[cur[s]] != pref:
            break
        cur[s] += 1
        pref += 1
    claimed, common, j = set(), pref, pref
    while j < len2 and common < len1:
        p = step(cur, j, pref)
        if p is not None:
            assert p not in claimed and pch[p] == text[j]
            claimed.add(p)
            common += 1
        j += 1
    # pass 2: the walk again from reset cursors, each claim popping the
    # lowest claimed position left
    order = iter(sorted(claimed))
    cur = [int(off[s]) for s in range(smax)]
    trans, left, j = 0, common - pref, pref
    while left:
        if step(cur, j, pref) is not None:
            trans += pch[next(order)] != text[j]
            left -= 1
        j += 1
    return common, trans


def pm_rows(pm):
    """``[W, 256]`` PM words -> each row as one Python int of ``32 W``
    bits."""
    return [sum(int(pm[w, c]) << (32 * w) for w in range(pm.shape[0]))
            for c in range(256)]


def register_walk(text, la, rows, P):
    """The register form on one pair over the PM rows (:func:`pm_rows`,
    ``P`` bits): the window, each flagged text char stored, pass 2 over
    the stored chars."""
    n = len(text)
    if la == 0 or n == 0:
        return 0, 0
    bound, len1, len2 = _pair(la, n)
    pref = 0
    while pref < min(len1, len2) and rows[text[pref]] >> pref & 1:
        pref += 1
    pf, held = (1 << pref) - 1, []
    for j in range(pref, len2):
        if pref + len(held) == len1:
            break
        lo, hi = max(j - bound, 0), j + bound
        avail = rows[text[j]] & ((1 << (hi + 1)) - (1 << lo)) & ~pf
        if avail:
            pf |= avail & -avail
            held.append(text[j])
    claimed = [p for p in range(pref, P) if pf >> p & 1]
    trans = sum(not rows[c] >> p & 1 for p, c in zip(claimed, held))
    return pref + len(held), trans


def make_texts(rng, q, n, lb_max):
    """Near copies of ``q`` (adjacent swaps, edits, chars no query holds),
    its whole length plus a tail (a prefix over the shorter string),
    texts far shorter and far longer than it, random texts, one empty."""
    out = []
    for i in range(n):
        kind = i % 6
        if kind == 0:
            t = q[: rng.integers(2, q.size + 2)].copy()
            for _ in range(rng.integers(1, 6)):
                k = rng.integers(0, t.size - 1)
                t[[k, k + 1]] = t[[k + 1, k]]
        elif kind == 1:
            t = q.copy()
            k = rng.integers(0, t.size, rng.integers(1, 8))
            t[k] = rng.choice(np.r_[ALPHABET, ABSENT], k.size)
        elif kind == 2:
            t = np.r_[q, rng.choice(ALPHABET, rng.integers(0, 40))]
        elif kind == 3:
            t = q[rng.integers(0, q.size): ][: rng.integers(1, 64)]
        elif kind == 4:
            t = rng.choice(np.r_[ALPHABET, ABSENT], rng.integers(1, lb_max))
        else:
            t = np.r_[rng.choice(ALPHABET, rng.integers(0, 3 * q.size + 8))]
        # a text is bytes: the query's sentinel char faces an 'a'
        out.append(np.where(t >= 256, 97, t)[:lb_max].astype(np.int64))
    out[-1] = out[-1][:0]
    return out


def pack(texts, LB):
    chars = np.full((len(texts), LB), -1, np.int32)
    for i, t in enumerate(texts):
        chars[i, : t.size] = t
    lens = torch.tensor([t.size for t in texts], dtype=torch.int32)
    return lk.prepare_corpus(torch.from_numpy(chars), lens)


@pytest.mark.parametrize("mode", ["byte", "local"])
@pytest.mark.parametrize("W", [1, 126])
def test_cursor_tables_hold_each_pm_row(mode, W):
    """Each PM row's positions ascending then the sentinel, the slot map,
    the row of each position, and the index type, in byte and local mode
    (chars outside the mode's domain: in no row)."""
    rng = np.random.default_rng(W)
    la = 32 * (W - 1) + 1 + int(rng.integers(0, 32))
    q = rng.choice(np.r_[ALPHABET, 130, 300], la)
    qs = [q, q[: 32 * (W - 1) + 1]]
    las, tabs = lk.stage_queries(qs, mode)
    tab, smax = jk.cursor_tables(tabs)
    dom = 256 if mode == "byte" else 128
    rows = [sorted(set(int(c) for c in x if c < dom)) for x in qs]
    assert smax == max(len(r) for r in rows)
    assert tab.dtype == torch.int32 and tab.shape == (
        2, jk.cursor_layout(W, smax)[3] // 4)
    sent = 0xFFFF if jk.idx16(W) else 0xFFFFFFFF
    assert jk.idx16(W) == (W < 2000)
    for x, r, t in zip(qs, rows, tab):
        slot, off, pos, pch = decode(t, W, smax)
        assert [c for c in range(256) if slot[c] >= 0] == r
        assert list(slot[r]) == list(range(len(r)))
        for s, c in enumerate(r):
            want = np.nonzero(x == c)[0]
            got = pos[off[s]: off[s] + want.size + 1]
            assert list(got) == list(want) + [sent]
            assert (pch[want] == c).all()
        assert (pos[off[len(r):]] == sent).all()
        assert (pos[sum(np.isin(x, r)) + len(r):] == sent).all()


@pytest.mark.parametrize("W,lb_max,mode", [(1, 64, "byte"),
                                           (2, 160, "local"),
                                           (9, 600, "local"),
                                           (126, 4600, "byte")])
def test_walks_match_plain_and_oracle(W, lb_max, mode):
    """Both walks give ``jaro_scan_plain``'s components (at W = 1, 2 and
    9; its per-step tensors at 126 words take seconds) and their
    similarity the oracle's, bit for bit, over near copies with swaps,
    absent symbols, whole-query prefixes, texts far shorter
    (``len1 < la``) and far longer (``len2 < lb``) than the query, a
    sentinel char (outside the table's domain) in the query and an empty
    text."""
    rng = np.random.default_rng(100 + W)
    la = 32 * (W - 1) + 1 + int(rng.integers(0, 32))
    q = rng.choice(ALPHABET if mode == "byte" else ALPHABET[:6], la)
    q[rng.integers(0, la)] = 300 if mode == "byte" else 200
    texts = make_texts(rng, q, 6 if W == 126 else 18, lb_max)
    las, tabs = lk.stage_query(q, mode)
    tab, smax = jk.cursor_tables(tabs[None])
    tables = decode(tab[0], W, smax)
    rows = pm_rows(tabs.numpy().view(np.uint32))
    got = np.array([cursor_walk(t, la, tables, smax) for t in texts])
    reg = np.array([register_walk(t, la, rows, 32 * W) for t in texts])
    np.testing.assert_array_equal(got, reg)
    if W < 126:
        cand, lb = pack(texts, -(-lb_max // 4) * 4)
        ref = jk.jaro_scan_plain(las, tabs[None], cand, lb)[:, 0]
        np.testing.assert_array_equal(got.T, ref.numpy())
    sim = sim_from_components(got[:, 0], got[:, 1], la,
                              [t.size for t in texts])
    dom = 256 if mode == "byte" else 128
    want = [oracle.jaro(np.where(q < dom, q, -1 - np.arange(la)), t)
            for t in texts]
    np.testing.assert_array_equal(sim, want)
    assert (got[:, 1] > 0).any() and (got[:, 0] < la).any()
