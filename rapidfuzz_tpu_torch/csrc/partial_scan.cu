// K10: one-vs-many fuzz.partial_ratio, the best window's indel ratio, at
// any bucket and query length.
//
// Replaces the TPU kernel rapidfuzz_tpu/ops/pallas/partial_kernel.py:_run,
// with its bodies _kernel_q (the quantized hardware body) and _kernel (the
// interpret body).  Both compute one function: for a candidate of length
// n >= m (the query's length) the best 2*lcs / (m + wlen) over the prefix
// windows [0, e), e = 1..m-1, and every window [st, min(st + m, n)),
// st = 0..n-1, of the candidate.  "Best" is exact, num * bd > bn * den,
// and only a strict improvement replaces it, so the first window in that
// order wins ties.  The TPU kernel left candidates shorter than the query
// to the host, where the roles swap; here the same thread scores them:
// the windows are the query's [max(0, i - n), min(m, i)), i = 1..n+m-1,
// with the candidate as the text, in that order.  The outputs are four
// [B] int32 rows: num, den and the best window's [start, end), in the
// candidate's coordinates for n >= m and in the query's for n < m (as
// fuzz.partial_ratio_alignment reports them).  An empty candidate gives
// (0, 1, 0, 0), as the TPU kernel's invalid lanes did.
//
// Every window runs Hyyro's LCS (lcs_scan.cu's lcs_word) with the query
// as the pattern.  For n >= m the text is the window's chars; for n < m
// the text is the whole candidate and the pattern is masked to the
// window: the PM word ANDed with the window's bits.  A pattern position
// that never matches keeps its S bit 1 (u is a subset of S, so S - u never
// borrows), so the count of zero bits of S is the window's LCS; words of
// the mask that hold no window bit stay all ones and hand no carry on.
//
// What bounds it on an H100: integer throughput.  A window step costs per
// query word the and of S with the PM word, the add with its carry-in,
// the carry-out and one 3-input logic op, plus, for n >= m, the select
// that zeroes the PM outside the window: 6.1-6.6 INT32-lane instructions
// at one and two words for n >= m, 3.4-3.9 for n < m (SASS, with the
// shared char load and PM lookup).  A candidate runs ~n * (m + G - 1)
// window steps for n >= m, n * (n + m - 1) for n < m; the corpus is read
// once per window group, from L1/L2 after the first.
//
// Design:
// * one thread per candidate, candidates along blockIdx.x; K1's packed
//   [LB/4, B] corpus, read coalesced;
// * the query's PM table [W, 256] u32 in shared memory (K4's layout);
// * window starts go G at a time (template on W, G = 8 for W <= 2 and
//   16 / W past that, so G * W state words stay in registers): the G
//   states share each char's load and PM lookup, a window's steps before
//   its start and past its end have their PM zeroed (an identity step, as
//   in _kernel_q), and a group stops at the candidate's end;
// * queries past kMaxRegW words keep one window's state in a [W, chunk]
//   u32 scratch, coalesced by candidate, with PM read through the
//   read-only cache; the wrapper launches over chunks of candidates under
//   its memory plan (partial_kernel.SCRATCH_BYTES);
// * fractions are compared in int64: num * den overflows int32 past
//   ~23,000 query chars;
// * __launch_bounds__(256, 1): with the block size alone ptxas held
//   W = 7 and 9 to 40-48 registers and spilled 4-44 bytes;
// * every offset into the corpus and the outputs is 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;    // PM entries: every byte value
constexpr int kMaxRegW = 16;  // window states in registers up to this W

// Window starts per group for W query words.
constexpr int groups(int W) { return W <= 2 ? 8 : 16 / W; }

__device__ __forceinline__ uint32_t lcs_word(uint32_t pmw, uint32_t s,
                                             uint32_t& carry) {
    const uint32_t u = s & pmw;
    const uint64_t t = (uint64_t)s + u + carry;
    carry = (uint32_t)(t >> 32);
    return (uint32_t)t | (s - u);
}

// Bits [lo, hi) of a word, both clamped to [0, 32].
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
    lo = max(lo, 0);
    hi = min(hi, 32);
    if (hi <= lo) return 0u;
    const uint32_t up = hi == 32 ? 0xFFFFFFFFu : ((1u << hi) - 1u);
    return up & ~((1u << lo) - 1u);
}

// The best window so far: bn / bd over [bs, be).  Replaced only on a
// strict improvement, so the first best window in enumeration order wins
// ties.
struct Best {
    int bn = -1, bd = 1, bs = 0, be = 0;

    __device__ __forceinline__ void better(int num, int den, int st,
                                           int en) {
        const bool up = (int64_t)num * bd > (int64_t)bn * den;
        bn = up ? num : bn;
        bd = up ? den : bd;
        bs = up ? st : bs;
        be = up ? en : be;
    }
};

// Text char idx of the candidate whose packed column starts at col.
__device__ __forceinline__ uint32_t char_at(const uint32_t* col, int idx,
                                            int64_t B) {
    return (col[(size_t)(idx >> 2) * B] >> (8 * (idx & 3))) & 0xFFu;
}

__device__ __forceinline__ void emit(int32_t* out, int64_t B, int64_t b,
                                     const Best& best) {
    const bool none = best.bn < 0;          // no window: empty candidate
    out[b] = none ? 0 : best.bn;
    out[B + b] = none ? 1 : best.bd;
    out[2 * B + b] = none ? 0 : best.bs;
    out[3 * B + b] = none ? 0 : best.be;
}

template <int W>
__device__ __forceinline__ int lcs2(const uint32_t* s) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) t += __popc(~s[w]);
    return 2 * t;
}

template <int W, int G>
__global__ void __launch_bounds__(kThreads, 1)
partial_scan_reg(const uint32_t* __restrict__ pm_g, int m,
                 const uint32_t* __restrict__ cand,
                 const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                 int64_t B, int lb4) {
    __shared__ uint32_t pm[W * kRows];
    for (int i = threadIdx.x; i < W * kRows; i += kThreads) pm[i] = pm_g[i];
    __syncthreads();

    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const int n = min(lb[b], 4 * lb4);
    const uint32_t* col = cand + b;
    Best best;
    if (n >= m) {
        // prefix windows [0, e), e = 1..m-1: one running state
        uint32_t s[W];
#pragma unroll
        for (int w = 0; w < W; ++w) s[w] = 0xFFFFFFFFu;
        for (int p = 0; p + 1 < m; ++p) {
            const uint32_t c = char_at(col, p, B);
            uint32_t carry = 0u;
#pragma unroll
            for (int w = 0; w < W; ++w)
                s[w] = lcs_word(pm[w * kRows + c], s[w], carry);
            best.better(lcs2<W>(s), m + p + 1, 0, p + 1);
        }
        // windows [st, min(st + m, n)), G starts per group
        for (int base = 0; base < n; base += G) {
            uint32_t sg[G][W];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int w = 0; w < W; ++w) sg[g][w] = 0xFFFFFFFFu;
            const int span = min(m + G - 1, n - base);
            uint32_t word = col[(size_t)(base >> 2) * B];
            for (int o = 0; o < span; ++o) {
                const int idx = base + o;
                if (o > 0 && (idx & 3) == 0)
                    word = col[(size_t)(idx >> 2) * B];
                const uint32_t c = (word >> (8 * (idx & 3))) & 0xFFu;
                uint32_t pmc[W];
#pragma unroll
                for (int w = 0; w < W; ++w) pmc[w] = pm[w * kRows + c];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    // window g reads offsets [g, g + m) of the group
                    const uint32_t act =
                        (o >= g && o - g < m) ? 0xFFFFFFFFu : 0u;
                    uint32_t carry = 0u;
#pragma unroll
                    for (int w = 0; w < W; ++w)
                        sg[g][w] = lcs_word(pmc[w] & act, sg[g][w], carry);
                }
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int st = base + g;
                if (st < n) {
                    const int wlen = min(m, n - st);
                    best.better(lcs2<W>(sg[g]), m + wlen, st, st + wlen);
                }
            }
        }
    } else if (n > 0) {
        // the candidate slides over the query: query windows
        // [max(0, i - n), min(m, i)), i = 1..n+m-1, G per group
        for (int i0 = 1; i0 < n + m; i0 += G) {
            uint32_t sg[G][W], mask[G][W];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int i = i0 + g;
                const int a = max(0, i - n), e = i < n + m ? min(m, i) : a;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    sg[g][w] = 0xFFFFFFFFu;
                    mask[g][w] = bit_range(a - 32 * w, e - 32 * w);
                }
            }
            uint32_t word = 0u;
            for (int p = 0; p < n; ++p) {
                if ((p & 3) == 0) word = col[(size_t)(p >> 2) * B];
                const uint32_t c = (word >> (8 * (p & 3))) & 0xFFu;
                uint32_t pmc[W];
#pragma unroll
                for (int w = 0; w < W; ++w) pmc[w] = pm[w * kRows + c];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    uint32_t carry = 0u;
#pragma unroll
                    for (int w = 0; w < W; ++w)
                        sg[g][w] = lcs_word(pmc[w] & mask[g][w], sg[g][w],
                                            carry);
                }
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int i = i0 + g;
                if (i < n + m) {
                    const int a = max(0, i - n), e = min(m, i);
                    best.better(lcs2<W>(sg[g]), n + (e - a), a, e);
                }
            }
        }
    }
    emit(out, B, b, best);
}

// Queries past kMaxRegW words: one window at a time, its state in rows
// [0, W) of the scratch (stride nb), candidates b0..b0+nb-1.
__global__ void __launch_bounds__(kThreads, 1)
partial_scan_generic(const uint32_t* __restrict__ pm, int m,
                     const uint32_t* __restrict__ cand,
                     const int32_t* __restrict__ lb,
                     int32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                     int64_t B, int64_t b0, int64_t nb, int lb4, int W) {
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (t >= nb) return;
    const int64_t b = b0 + t;
    const int n = min(lb[b], 4 * lb4);
    const uint32_t* col = cand + b;
    uint32_t* s = scratch + t;
    Best best;
    if (n >= m) {
        for (int w = 0; w < W; ++w) s[(size_t)w * nb] = 0xFFFFFFFFu;
        for (int p = 0; p + 1 < m; ++p) {
            const uint32_t c = char_at(col, p, B);
            uint32_t carry = 0u;
            int zeros = 0;
            for (int w = 0; w < W; ++w) {
                const uint32_t v = lcs_word(__ldg(pm + w * kRows + c),
                                            s[(size_t)w * nb], carry);
                s[(size_t)w * nb] = v;
                zeros += __popc(~v);
            }
            best.better(2 * zeros, m + p + 1, 0, p + 1);
        }
        for (int st = 0; st < n; ++st) {
            for (int w = 0; w < W; ++w) s[(size_t)w * nb] = 0xFFFFFFFFu;
            const int wlen = min(m, n - st);
            for (int p = st; p < st + wlen; ++p) {
                const uint32_t c = char_at(col, p, B);
                uint32_t carry = 0u;
                for (int w = 0; w < W; ++w)
                    s[(size_t)w * nb] = lcs_word(__ldg(pm + w * kRows + c),
                                                 s[(size_t)w * nb], carry);
            }
            int zeros = 0;
            for (int w = 0; w < W; ++w) zeros += __popc(~s[(size_t)w * nb]);
            best.better(2 * zeros, m + wlen, st, st + wlen);
        }
    } else if (n > 0) {
        for (int i = 1; i < n + m; ++i) {
            // only the words that hold the window's bits change
            const int a = max(0, i - n), e = min(m, i);
            const int w0 = a >> 5, w1 = (e - 1) >> 5;
            for (int w = w0; w <= w1; ++w) s[(size_t)w * nb] = 0xFFFFFFFFu;
            for (int p = 0; p < n; ++p) {
                const uint32_t c = char_at(col, p, B);
                uint32_t carry = 0u;
                for (int w = w0; w <= w1; ++w)
                    s[(size_t)w * nb] = lcs_word(
                        __ldg(pm + w * kRows + c) &
                            bit_range(a - 32 * w, e - 32 * w),
                        s[(size_t)w * nb], carry);
            }
            int zeros = 0;
            for (int w = w0; w <= w1; ++w) zeros += __popc(~s[(size_t)w * nb]);
            best.better(2 * zeros, n + (e - a), a, e);
        }
    }
    emit(out, B, b, best);
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, int m, const uint32_t* cand,
                       const int32_t* lb, int32_t* out, int64_t B, int lb4,
                       cudaStream_t stream) {
    const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
    partial_scan_reg<W, groups(W)><<<grid, kThreads, 0, stream>>>(
        pm, m, cand, lb, out, B, lb4);
    return cudaGetLastError();
}

}  // namespace

// pm [W, 256] u32, m >= 1 the query's length; cand [lb4, B] packed, lb [B];
// out [4, B] int32.  W <= kMaxRegW launches over all B candidates (b0 and
// nb are ignored, scratch may be null); wider queries launch over
// candidates [b0, b0 + nb) with a [W, nb] u32 scratch.
extern "C" cudaError_t rf_partial_scan(const uint32_t* pm, int m,
                                       const uint32_t* cand,
                                       const int32_t* lb, int32_t* out,
                                       uint32_t* scratch, int64_t B,
                                       int64_t b0, int64_t nb, int lb4,
                                       int W, cudaStream_t stream) {
    if (m < 1 || W != (m + 31) / 32) return cudaErrorInvalidValue;
    switch (W) {
        case 1: return launch_reg<1>(pm, m, cand, lb, out, B, lb4, stream);
        case 2: return launch_reg<2>(pm, m, cand, lb, out, B, lb4, stream);
        case 3: return launch_reg<3>(pm, m, cand, lb, out, B, lb4, stream);
        case 4: return launch_reg<4>(pm, m, cand, lb, out, B, lb4, stream);
        case 5: return launch_reg<5>(pm, m, cand, lb, out, B, lb4, stream);
        case 6: return launch_reg<6>(pm, m, cand, lb, out, B, lb4, stream);
        case 7: return launch_reg<7>(pm, m, cand, lb, out, B, lb4, stream);
        case 8: return launch_reg<8>(pm, m, cand, lb, out, B, lb4, stream);
        case 9: return launch_reg<9>(pm, m, cand, lb, out, B, lb4, stream);
        case 10: return launch_reg<10>(pm, m, cand, lb, out, B, lb4, stream);
        case 11: return launch_reg<11>(pm, m, cand, lb, out, B, lb4, stream);
        case 12: return launch_reg<12>(pm, m, cand, lb, out, B, lb4, stream);
        case 13: return launch_reg<13>(pm, m, cand, lb, out, B, lb4, stream);
        case 14: return launch_reg<14>(pm, m, cand, lb, out, B, lb4, stream);
        case 15: return launch_reg<15>(pm, m, cand, lb, out, B, lb4, stream);
        case 16: return launch_reg<16>(pm, m, cand, lb, out, B, lb4, stream);
        default: break;
    }
    static_assert(kMaxRegW == 16, "the switch above instantiates W <= 16");
    if (scratch == nullptr || nb < 1) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((nb + kThreads - 1) / kThreads);
    partial_scan_generic<<<grid, kThreads, 0, stream>>>(
        pm, m, cand, lb, out, scratch, B, b0, nb, lb4, W);
    return cudaGetLastError();
}
