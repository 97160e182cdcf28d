// K8: one-vs-many Jaro components (common chars, transpositions), one
// query or NQ queries per launch, at any bucket length and any query
// length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/jaro_kernel.py:_kernel,
// launched there by _run (one query, buckets <= 1024) and _run_nq
// (multiq=True, 16 queries), and stream_kernel.py:_jaro_kernel
// (_jaro_run), which serves buckets over 1024 chars by streaming 512-char
// text chunks through a second grid axis with the text flags of a whole
// candidate block in a (ceil(LB/32), sub, 128) VMEM scratch.  That
// scratch capped the TPU's buckets at 16,384 chars
// (JARO_STREAM_MAX_LB) and its queries by a VMEM budget
// (jaro_stream_query_fits): both were VMEM limits.  A thread here walks
// its own candidate's text from global memory at any length and keeps
// its state in registers or in a device scratch of any size, so one
// kernel serves every bucket and every query, and the wrapper counts
// launches over 1024-char buckets apart (jaro_scan_long).
//
// What it computes (jaro_kernel.py:56-196; the reference's
// jaro.rs:422-514), with the query as the pattern P and the candidate as
// the text T, la and lb their lengths:
// * bound = max(max(la, lb) / 2 - 1, 0), the pattern truncated to
//   len1 = min(la, lb + bound), the text to len2 = min(lb, la + bound);
// * the common prefix (P[j] == T[j] for j < pref, pref <= min(len1,
//   len2)) is claimed in both flag sets and counts toward common;
// * greedy flagging: text char j in [pref, len2) claims the lowest
//   unclaimed pattern position p with P[p] == T[j] and
//   |p - j| <= bound;
// * transpositions: the flagged text chars, in text order, pop the
//   claimed pattern positions in pattern order, and each pair whose
//   chars differ counts one (the host halves the count).
// The output is [2, NQ, B] int32: common, then the raw transpositions.
// P[p] == c is bit p % 32 of the query's PM word p / 32 at row c (K1's
// table), so byte and local mode and the never-matching sentinel of the
// scanner's query encoding behave exactly as on the TPU, and no pattern
// char is materialised.
//
// Two facts keep the state small.  The window [j - bound, j + bound]
// never reaches past len1 - 1 while j < len2 (len1 < la only when
// len1 = lb + bound), so it needs no mask of len1 (the TPU's lenmask).
// The prefix pairs prefix text char j with pattern char j, so the prefix
// adds nothing to the transpositions: both passes start at pref with the
// prefix bits set in the pattern flags and left out of the pop.
//
// What bounds it on an H100: integer issue.  A text step of pass 1 costs
// per query word an and-not of the PM word with the window and the
// claimed bits, the lowest-bit claim (negate, and, or under the "not yet
// found" predicate) and the window's slide (one funnel shift); the corpus
// is read 1 byte per char.  Each thread stops pass 1 once every pattern
// position in len1 is claimed and pass 2 at its last flagged char, so a
// short query against a long text (64 chars against 8,192) runs a few
// hundred steps, not the bucket.
//
// Design:
// * one thread per candidate, candidates along blockIdx.x, the query
//   along blockIdx.y (the NQ form), so the queries share the corpus lines
//   the L2 holds;
// * the packed corpus keeps the JAX layout [LB/4, B] u32, a coalesced
//   load of 4 chars per 4 text steps;
// * register form (W <= kMaxRegW = 8 words, template on W): the PM table
//   ([W, 256] u32) in shared memory, the window and the pattern flags in
//   registers.  The text flags (one bit per text char, the TPU's
//   ceil(LB/32) words) are not kept: pass 2 reruns pass 1's flagging
//   beside the pop, from the same state, so the thread needs 3W words
//   (window, replayed flags, the flags left to pop) whatever the bucket,
//   and no memory plan, for about twice pass 1's operations (its SASS
//   issues as many INT32 instructions a step in the replay as in pass 1);
// * scratch form (W > 8): the pattern flags and a text-flag bitmap live
//   in a [NQ, W + ceil(LB/32), nb] u32 scratch, coalesced by candidate,
//   over the chunk [b0, b0 + nb) of candidates the wrapper sizes to its
//   memory plan; the PM table is read through the read-only cache.  Pass
//   1 visits only the words the window covers, skips a word whose PM row
//   holds no char c, and stops at the first claim; there the flags
//   already cost a memory access per word, so one bit per text char,
//   written once per 32 steps, is cheaper than a replay, and pass 2 pops
//   the claimed positions with a cursor over the final pattern flags
//   (the lowest remaining bit only rises), one step per char;
// * la == 0 or lb == 0 gives (0, 0);
// * every offset into the corpus, the output and the scratch is 64-bit
//   (row * B, row * nb); only per-candidate lengths, the row count lb4
//   and the query length are 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;     // PM entries: every byte value
constexpr int kMaxRegW = 8;    // state in registers up to this many words

// bits [0, n) of a u32, n clamped to [0, 32]
__device__ __forceinline__ uint32_t below(int n) {
    return n <= 0 ? 0u : n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

// Jaro's window and truncation for one (query, candidate) pair
struct Pair {
    int bound, len1, len2;
    __device__ Pair(int la, int lb) {
        bound = max(max(la, lb) / 2 - 1, 0);
        len1 = min(la, lb + bound);
        len2 = min(lb, la + bound);
    }
};

// text char j of the candidate whose packed column starts at col
__device__ __forceinline__ uint32_t char_at(const uint32_t* __restrict__ col,
                                            int64_t B, int j) {
    return (col[(size_t)(j >> 2) * B] >> (8 * (j & 3))) & 0xFFu;
}

// length of the common prefix of pattern and text, at most lim: P[j] ==
// T[j] is bit j % 32 of PM word j / 32 at row T[j]
__device__ __forceinline__ int common_prefix(const uint32_t* __restrict__ pm,
                                             const uint32_t* __restrict__ col,
                                             int64_t B, int lim) {
    int p = 0;
    uint32_t word = 0u;
    while (p < lim) {
        if ((p & 3) == 0) word = col[(size_t)(p >> 2) * B];
        const uint32_t c = (word >> (8 * (p & 3))) & 0xFFu;
        if (!((pm[(p >> 5) * kRows + c] >> (p & 31)) & 1u)) break;
        ++p;
    }
    return p;
}

// ------------------------------------------------------- register form

// the window [j - bound, j + bound] as W words
template <int W>
__device__ __forceinline__ void window_at(uint32_t* wm, int j, int bound) {
    const int lo = max(j - bound, 0), hi = j + bound + 1;
#pragma unroll
    for (int w = 0; w < W; ++w)
        wm[w] = below(hi - 32 * w) & ~below(lo - 32 * w);
}

// slide the window from j to j + 1: up one bit across the words, bit 0
// kept while the lower end stays clamped at 0 (j + 1 <= bound)
template <int W>
__device__ __forceinline__ void window_slide(uint32_t* wm, bool clamped) {
#pragma unroll
    for (int w = W - 1; w > 0; --w) wm[w] = __funnelshift_l(wm[w - 1], wm[w], 1);
    wm[0] = (wm[0] << 1) | (clamped ? 1u : 0u);
}

// claim the lowest unclaimed pattern position in the window whose char is
// the text char (PM words pmw); true if one was claimed
template <int W>
__device__ __forceinline__ bool claim(const uint32_t* pmw, const uint32_t* wm,
                                      uint32_t* pf) {
    bool found = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const uint32_t avail = pmw[w] & wm[w] & ~pf[w];
        if (!found && avail) {
            pf[w] |= avail & (0u - avail);
            found = true;
        }
    }
    return found;
}

// pop the lowest claimed position left in rem; true if its pattern char
// equals the text char (PM words pmw)
template <int W>
__device__ __forceinline__ bool pop_matches(const uint32_t* pmw,
                                            uint32_t* rem) {
    bool done = false, match = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        if (!done && rem[w]) {
            const uint32_t low = rem[w] & (0u - rem[w]);
            match = (pmw[w] & low) != 0u;
            rem[w] ^= low;
            done = true;
        }
    }
    return match;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
jaro_scan_reg(const uint32_t* __restrict__ pm_all,
              const int32_t* __restrict__ las,
              const uint32_t* __restrict__ cand,
              const int32_t* __restrict__ lb, int32_t* __restrict__ out,
              int64_t B, int lb4) {
    __shared__ uint32_t pm[W * kRows];
    const int q = blockIdx.y;
    const uint32_t* src = pm_all + (size_t)q * W * kRows;
    for (int i = threadIdx.x; i < W * kRows; i += kThreads) pm[i] = src[i];
    __syncthreads();

    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    int32_t* common_out = out + (size_t)q * B + b;
    int32_t* trans_out = common_out + (size_t)gridDim.y * B;
    if (la == 0 || n == 0) {
        *common_out = 0;
        *trans_out = 0;
        return;
    }
    const Pair J(la, n);
    const uint32_t* col = cand + b;
    const int pref = common_prefix(pm, col, B, min(J.len1, J.len2));

    // pass 1: flag
    uint32_t pf[W], wm[W], pmw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) pf[w] = below(pref - 32 * w);
    window_at<W>(wm, pref, J.bound);
    int common = pref;
    // (pref may be the text's whole length, one row past its last)
    uint32_t word = pref < J.len2 ? col[(size_t)(pref >> 2) * B] : 0u;
    for (int j = pref; j < J.len2 && common < J.len1; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
#pragma unroll
        for (int w = 0; w < W; ++w) pmw[w] = pm[w * kRows + c];
        common += claim<W>(pmw, wm, pf);
        window_slide<W>(wm, j + 1 <= J.bound);
    }

    // pass 2: replay the flagging; each flagged text char pops the lowest
    // claimed pattern position left
    int trans = 0, left = common - pref;
    if (left) {
        uint32_t rem[W], pf2[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
            pf2[w] = below(pref - 32 * w);
            rem[w] = pf[w] & ~pf2[w];
        }
        window_at<W>(wm, pref, J.bound);
        word = col[(size_t)(pref >> 2) * B];
        for (int j = pref; left && j < J.len2; ++j) {
            if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
            const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
#pragma unroll
            for (int w = 0; w < W; ++w) pmw[w] = pm[w * kRows + c];
            if (claim<W>(pmw, wm, pf2)) {
                trans += !pop_matches<W>(pmw, rem);
                --left;
            }
            window_slide<W>(wm, j + 1 <= J.bound);
        }
    }
    *common_out = common;
    *trans_out = trans;
}

// -------------------------------------------------------- scratch form

__global__ void __launch_bounds__(kThreads)
jaro_scan_generic(const uint32_t* __restrict__ pm_all,
                  const int32_t* __restrict__ las,
                  const uint32_t* __restrict__ cand,
                  const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                  uint32_t* __restrict__ scratch, int64_t B, int64_t b0,
                  int64_t nb, int lb4, int W) {
    const int q = blockIdx.y;
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= nb) return;
    const int64_t b = b0 + i;
    const uint32_t* pm = pm_all + (size_t)q * W * kRows;
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    int32_t* common_out = out + (size_t)q * B + b;
    int32_t* trans_out = common_out + (size_t)gridDim.y * B;
    if (la == 0 || n == 0) {
        *common_out = 0;
        *trans_out = 0;
        return;
    }
    const Pair J(la, n);
    const uint32_t* col = cand + b;
    // this query's block of the scratch: pattern flags in rows [0, W),
    // the text-flag bitmap in rows [W, W + TW)
    const int TW = (4 * lb4 + 31) / 32;
    uint32_t* pf = scratch + (size_t)q * (W + TW) * nb + i;
    uint32_t* tf = pf + (size_t)W * nb;
    const int pref = common_prefix(pm, col, B, min(J.len1, J.len2));
    for (int w = 0; w < (J.len1 + 31) / 32; ++w)
        pf[(size_t)w * nb] = below(pref - 32 * w);

    // pass 1: flag, visiting only the window's words, from the lowest
    int common = pref, j = pref;
    uint32_t tfw = 0u;
    uint32_t word = pref < J.len2 ? col[(size_t)(pref >> 2) * B] : 0u;
    for (; j < J.len2 && common < J.len1; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
        const int lo = max(j - J.bound, 0), hi = j + J.bound;
        const int wlo = lo >> 5, whi = min(hi >> 5, W - 1);
        bool found = false;
        for (int w = wlo; w <= whi && !found; ++w) {
            uint32_t m = __ldg(pm + w * kRows + c);
            if (w == wlo) m &= ~below(lo & 31);
            if (w == (hi >> 5)) m &= below((hi & 31) + 1);
            if (!m) continue;
            const uint32_t f = pf[(size_t)w * nb], avail = m & ~f;
            if (avail) {
                pf[(size_t)w * nb] = f | (avail & (0u - avail));
                found = true;
            }
        }
        if (found) {
            tfw |= 1u << (j & 31);
            ++common;
        }
        if ((j & 31) == 31) {
            tf[(size_t)(j >> 5) * nb] = tfw;
            tfw = 0u;
        }
    }
    if (j > pref && (j & 31) != 0) tf[(size_t)((j - 1) >> 5) * nb] = tfw;

    // pass 2: each flagged text char pops the lowest claimed pattern
    // position left, by a cursor over the final pattern flags
    int trans = 0, left = common - pref;
    if (left) {
        int cw = pref >> 5;
        uint32_t cur = pf[(size_t)cw * nb] & ~below(pref & 31);
        for (j = pref; left; ++j) {
            if ((j & 31) == 0 || j == pref) tfw = tf[(size_t)(j >> 5) * nb];
            if (!(tfw >> (j & 31))) {       // no flag left in this word
                j |= 31;
                continue;
            }
            if (!((tfw >> (j & 31)) & 1u)) continue;
            while (!cur) cur = pf[(size_t)(++cw) * nb];
            const uint32_t low = cur & (0u - cur);
            cur ^= low;
            trans += !(__ldg(pm + cw * kRows + char_at(col, B, j)) & low);
            --left;
        }
    }
    *common_out = common;
    *trans_out = trans;
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const int32_t* las,
                       const uint32_t* cand, const int32_t* lb, int32_t* out,
                       int64_t B, int lb4, int nq, cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), nq);
    jaro_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                    B, lb4);
    return cudaGetLastError();
}

}  // namespace

// out is [2, nq, B] int32 (common, transpositions).  The register form
// (W <= 8) runs over all B candidates at once and takes b0 = 0, nb = B;
// the scratch form runs over candidates [b0, b0 + nb) with a scratch of
// nq * (W + ceil(4*lb4/32)) * nb u32.
extern "C" cudaError_t rf_jaro_scan(const uint32_t* pm, const int32_t* las,
                                    const uint32_t* cand, const int32_t* lb,
                                    int32_t* out, uint32_t* scratch,
                                    int64_t B, int64_t b0, int64_t nb,
                                    int lb4, int W, int nq,
                                    cudaStream_t stream) {
    if (W <= kMaxRegW && (b0 != 0 || nb != B)) return cudaErrorInvalidValue;
    switch (W) {
        case 1: return launch_reg<1>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 2: return launch_reg<2>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 3: return launch_reg<3>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 4: return launch_reg<4>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 5: return launch_reg<5>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 6: return launch_reg<6>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 7: return launch_reg<7>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 8: return launch_reg<8>(pm, las, cand, lb, out, B, lb4, nq, stream);
        default: break;
    }
    static_assert(kMaxRegW == 8, "the switch above instantiates W <= 8");
    if (W < 1 || scratch == nullptr || b0 < 0 || nb < 1 || b0 + nb > B)
        return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((nb + kThreads - 1) / kThreads), nq);
    jaro_scan_generic<<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                     scratch, B, b0, nb, lb4,
                                                     W);
    return cudaGetLastError();
}
