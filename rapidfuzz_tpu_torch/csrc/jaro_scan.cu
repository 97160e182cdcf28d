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
// scratch capped the TPU's buckets at 16,384 chars (JARO_STREAM_MAX_LB)
// and its queries by a VMEM budget (jaro_stream_query_fits): both were
// VMEM limits.  A thread here walks its own candidate's text from global
// memory at any length and keeps its state in registers and shared
// memory, so one kernel serves every bucket and every query; the wrapper
// counts launches over 1024-char buckets apart (jaro_scan_long).
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
// table); the cursor form's tables are derived from that table by the
// wrapper, so byte and local mode and the never-matching sentinel of the
// scanner's query encoding behave exactly as on the TPU.
//
// Two facts keep the state small.  The window [j - bound, j + bound]
// never reaches past len1 - 1 while j < len2 (len1 < la only when
// len1 = lb + bound), so it needs no mask of len1 (the TPU's lenmask),
// and its lower end j - bound stays below la.  The prefix pairs prefix
// text char j with pattern char j, so it adds nothing to the
// transpositions: both passes start at pref with the prefix claimed and
// left out of the pop.
//
// What bounds it on an H100: integer issue in the register form; in the
// cursor form the chain of shared-memory loads a text step makes (the
// row's cursor, then its position) and the replay of the walk in pass 2.
// The corpus is read 1 byte per char, a packed word held a word ahead of
// its use; each thread stops pass 1 once every pattern position in len1
// is claimed, so a short query against a long text (64 chars against
// 8,192) runs a few hundred steps, not the bucket.
//
// Design (one thread per candidate, candidates along blockIdx.x, the
// query along blockIdx.y, the last blocks, whose texts the scanner's
// length sort makes the longest, started first; the packed corpus keeps
// the JAX layout [LB/4, B] u32):
// * register form (W <= kMaxRegW = 5 query words, template on W): the PM
//   table ([W, 256] u32) in shared memory, the window and the pattern
//   flags in registers.  Pass 1 claims with an and-not and a lowest-bit
//   pick per word and writes each flagged text char (one byte) to the
//   thread's own 32W-byte slot in shared memory, laid out [k/4][thread]
//   so that a warp's stores hit 32 banks.  Pass 2 walks the claimed
//   pattern bits in order and pops one stored char for each: no second
//   walk of the corpus.
// * cursor form (longer queries; it beats the register form from 6 words
//   on an H100): per query, the wrapper stages from the PM table the
//   sorted positions of each PM row that has any (CSR: a row's positions
//   then a sentinel above every position; the rows numbered by a slot
//   map) and the row of each position, and a block copies them to shared
//   memory.  Per candidate, shared memory holds one cursor per row (an
//   index into the positions) and the pattern-flag bitmap.  Text char c
//   at step j moves c's cursor past positions under lo = max(j - bound,
//   pref) and claims the position there if it is at most j + bound.
//   This is the greedy rule exactly: a position of c is only claimed by
//   a text char c and the window's lower end only rises, so every
//   position below the cursor is claimed or below the window for good,
//   and the cursor's position is the lowest claimable one.  The cursors
//   advance at most la times over a pair, so a step costs O(1) shared
//   loads amortised, not O(W) words.  The prefix is found on the same
//   cursors (P[j] == T[j] iff c's cursor sits on j).  Pass 2 replays the
//   walk from reset cursors and pops the lowest claimed position left for
//   each claim, counting the pairs whose row differs.  The block size is
//   chosen per launch to keep the most threads resident (plan_cursor);
//   the tables live in shared memory while they take at most a quarter
//   of it (queries up to ~18,000 chars), past that they are read through
//   L1.  A candidate's cursors and flags must fit one block (227 KB:
//   queries up to ~1.8 million chars); past that the launch is refused.
// * la == 0 or lb == 0 gives (0, 0);
// * every offset into the corpus and the output is 64-bit (row * B);
//   only per-candidate lengths, the row count lb4 and the query length
//   are 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;          // PM entries: every byte value
constexpr int kMaxRegW = 5;         // register form up to this many words
constexpr int kSmemBlock = 232448;  // shared memory a block may opt into
constexpr int kSmemSM = 233472;     // shared memory an SM holds
constexpr int kSmemReserve = 1024;  // the runtime's share of it per block
constexpr int kMaxThreads = 256;    // threads a block, at most

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

// this thread's candidate: blocks in reverse order, so that the last
// blocks, whose texts the scanner's length sort makes the longest, start
// first
__device__ __forceinline__ int64_t candidate(int T) {
    return (int64_t)(gridDim.x - 1 - blockIdx.x) * T + threadIdx.x;
}

// the two outputs of this thread's pair (addresses worked out at the end,
// so that no register holds them through the walks)
__device__ __forceinline__ void put(int32_t* out, int64_t B, int T,
                                    int common, int trans) {
    const int64_t b = candidate(T);
    out[(size_t)blockIdx.y * B + b] = common;
    out[((size_t)gridDim.y + blockIdx.y) * B + b] = trans;
}

// a candidate's text chars in order, the next packed word held a word
// ahead of its use; rows past the text are not read
struct Text {
    const uint32_t* col;
    int64_t B;
    int rows;
    uint32_t word, next;
    __device__ Text(const uint32_t* c, int64_t b, int len)
        : col(c), B(b), rows((len + 3) >> 2), word(0u), next(0u) {}
    __device__ __forceinline__ uint32_t row(int r) const {
        return r < rows ? col[(size_t)r * B] : 0u;
    }
    // position the stream so that the next at() is char j
    __device__ __forceinline__ void start(int j) {
        if (j & 3) {
            word = row(j >> 2);
            next = row((j >> 2) + 1);
        } else {
            next = row(j >> 2);
        }
    }
    __device__ __forceinline__ uint32_t at(int j) {
        if ((j & 3) == 0) {
            word = next;
            next = row((j >> 2) + 1);
        }
        return (word >> (8 * (j & 3))) & 0xFFu;
    }
};

// ------------------------------------------------------- register form

template <int W>
struct RegPlan {
    // the stored chars take 32 W bytes a thread: 128 threads past 4
    // words keep a block's shared memory under 48 KB
    static constexpr int kThreads = W <= 4 ? 256 : 128;
};

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

template <int W>
__global__ void __launch_bounds__(RegPlan<W>::kThreads)
jaro_scan_reg(const uint32_t* __restrict__ pm_all,
              const int32_t* __restrict__ las,
              const uint32_t* __restrict__ cand,
              const int32_t* __restrict__ lb, int32_t* __restrict__ out,
              int64_t B, int lb4) {
    constexpr int T = RegPlan<W>::kThreads;
    __shared__ uint32_t pm[W * kRows];
    // flagged text chars past the prefix: char k of thread t in byte
    // k % 4 of word [k / 4][t]
    __shared__ uint32_t held[8 * W * T];
    const int q = blockIdx.y;
    const uint32_t* src = pm_all + (size_t)q * W * kRows;
    for (int i = threadIdx.x; i < W * kRows; i += T) pm[i] = src[i];
    __syncthreads();

    const int t = threadIdx.x;
    const int64_t b = candidate(T);
    if (b >= B) return;
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    if (la == 0 || n == 0) {
        put(out, B, T, 0, 0);
        return;
    }
    const Pair J(la, n);
    const uint32_t* col = cand + b;
    const int pref = common_prefix(pm, col, B, min(J.len1, J.len2));

    // pass 1: flag, storing each flagged text char
    uint32_t pf[W], wm[W], pmw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) pf[w] = below(pref - 32 * w);
    window_at<W>(wm, pref, J.bound);
    Text text(col, B, J.len2);
    text.start(pref);
    int k = 0;
    uint32_t acc = 0u;
    for (int j = pref; j < J.len2 && pref + k < J.len1; ++j) {
        const uint32_t c = text.at(j);
#pragma unroll
        for (int w = 0; w < W; ++w) pmw[w] = pm[w * kRows + c];
        if (claim<W>(pmw, wm, pf)) {
            acc |= c << (8 * (k & 3));
            if ((k & 3) == 3) {
                held[(k >> 2) * T + t] = acc;
                acc = 0u;
            }
            ++k;
        }
        window_slide<W>(wm, j + 1 <= J.bound);
    }
    if (k & 3) held[(k >> 2) * T + t] = acc;

    // pass 2: the claimed positions past the prefix in pattern order, the
    // k-th against the k-th stored char
    int trans = 0, i = 0;
    uint32_t hw = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        uint32_t m = pf[w] & ~below(pref - 32 * w);
        while (m) {
            const uint32_t low = m & (0u - m);
            m ^= low;
            if ((i & 3) == 0) hw = held[(i >> 2) * T + t];
            const uint32_t c = (hw >> (8 * (i & 3))) & 0xFFu;
            trans += !(pm[w * kRows + c] & low);
            ++i;
        }
    }
    put(out, B, T, pref + k, trans);
}

// --------------------------------------------------------- cursor form

// The staged tables of one query, `stride` bytes (the wrapper's
// cursor_tables), Idx u16 or u32 by the query's words (idx16):
//   int16 slot[256]           row c's slot, -1 where it holds no position
//   Idx   off[smax]           slot s's first position index (padded)
//   Idx   pos[32 W + smax + 1] each slot's positions ascending, then the
//                             sentinel (Idx's largest value)
//   u8    pch[32 W]           the row of each position (0 where none)
// each part starting at a multiple of 16 bytes
__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

struct CursorLayout {
    int off, pos, pch, stride;
    __host__ __device__ CursorLayout(int W, int smax, int isz) {
        off = 2 * kRows;
        pos = off + align16(isz * smax);
        pch = pos + align16(isz * (32 * W + smax + 1));
        stride = pch + 32 * W;
    }
};

__host__ __device__ constexpr bool idx16(int W) {
    return 32 * W + kRows + 1 < 0xFFFF;
}

// per-candidate shared memory of the cursor form: a cursor a row,
// Idx [smax][T] (rounded to a word), and u32 pattern flags [W][T]
__host__ __device__ inline int cursor_bytes(int W, int smax, int isz) {
    return (isz * smax + 3) / 4 * 4 + 4 * W;
}

// the cursor walk from text char j until `left` claims are made or len2:
// text char c moves its row's cursor past the positions under
// lo = max(j - bound, pref) and claims the one there if it is at most
// min(j + bound, la - 1), calling on_claim(position, c); returns the
// claims made.  A packed word at a time: the rows of its four chars are
// looked up together, off the chain of cursor loads.
template <typename Idx, typename OnClaim>
__device__ __forceinline__ int cursor_walk(Text& text, const int16_t* slot,
                                           const Idx* pos, Idx* cur, int T,
                                           int j, int len2, int left,
                                           int bound, int pref, int la,
                                           OnClaim on_claim) {
    const uint32_t top = (uint32_t)(la - 1);
    int made = 0;
    text.start(j);
    while (j < len2 && made < left) {
        text.at(j);
        const uint32_t w = text.word;
        int s4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) s4[i] = slot[(w >> (8 * i)) & 0xFFu];
        const int i0 = j & 3;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (i < i0 || j >= len2 || made >= left) continue;
            if (s4[i] >= 0) {
                const uint32_t lo = (uint32_t)max(j - bound, pref);
                const uint32_t hi = min((uint32_t)(j + bound), top);
                Idx* cs = cur + (size_t)s4[i] * T;
                uint32_t k = *cs, p = pos[k];
                while (p < lo) p = pos[++k];
                const bool hit = p <= hi;
                *cs = (Idx)(k + hit);
                if (hit) {
                    on_claim(p, (w >> (8 * i)) & 0xFFu);
                    ++made;
                }
            }
            ++j;
        }
    }
    return made;
}

template <typename Idx, bool kSharedTab>
__global__ void __launch_bounds__(kMaxThreads)
jaro_scan_cursor(const uint8_t* __restrict__ tab_all,
                 const int32_t* __restrict__ las,
                 const uint32_t* __restrict__ cand,
                 const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                 int64_t B, int lb4, int W, int smax) {
    extern __shared__ uint4 smem[];
    const int T = blockDim.x, t = threadIdx.x;
    const CursorLayout L(W, smax, sizeof(Idx));
    const int q = blockIdx.y;
    const uint8_t* tab = tab_all + (size_t)q * L.stride;
    uint8_t* base = reinterpret_cast<uint8_t*>(smem);
    if (kSharedTab) {
        const uint4* s4 = reinterpret_cast<const uint4*>(tab);
        for (int i = t; i < L.stride / 16; i += T) smem[i] = s4[i];
        tab = base;
        base += L.stride;
        __syncthreads();
    }
    const int16_t* slot = reinterpret_cast<const int16_t*>(tab);
    const Idx* off = reinterpret_cast<const Idx*>(tab + L.off);
    const Idx* pos = reinterpret_cast<const Idx*>(tab + L.pos);
    const uint8_t* pch = tab + L.pch;
    Idx* cur = reinterpret_cast<Idx*>(base) + t;
    uint32_t* pf = reinterpret_cast<uint32_t*>(
        base + (size_t)T * ((sizeof(Idx) * smax + 3) / 4 * 4)) + t;

    const int64_t b = candidate(T);
    if (b >= B) return;
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    if (la == 0 || n == 0) {
        put(out, B, T, 0, 0);
        return;
    }
    const Pair J(la, n);
    for (int s = 0; s < smax; ++s) cur[(size_t)s * T] = off[s];
    for (int w = 0; w < (J.len1 + 31) / 32; ++w) pf[(size_t)w * T] = 0u;

    // the common prefix: P[j] == T[j] iff T[j]'s cursor sits on j (every
    // position of that row below j is a prefix position, passed already)
    Text text(cand + b, B, J.len2);
    text.start(0);
    int pref = 0;
    const int plim = min(J.len1, J.len2);
    while (pref < plim) {
        const int s = slot[text.at(pref)];
        if (s < 0) break;
        Idx* cs = cur + (size_t)s * T;
        const Idx k = *cs;
        if ((int)pos[k] != pref) break;
        *cs = (Idx)(k + 1);
        ++pref;
    }
    for (int w = 0; w < pref / 32; ++w) pf[(size_t)w * T] = 0xFFFFFFFFu;
    if (pref & 31) pf[(size_t)(pref >> 5) * T] = below(pref & 31);

    // pass 1: each text char claims at its row's cursor; the flag is set
    // by an atomic or, which no later instruction waits on
    const int common = pref + cursor_walk<Idx>(
        text, slot, pos, cur, T, pref, J.len2, J.len1 - pref, J.bound, pref,
        la, [&](uint32_t p, uint32_t) {
            atomicOr(pf + (size_t)(p >> 5) * T, 1u << (p & 31));
        });

    // pass 2: the walk again from reset cursors; the k-th claim pops the
    // k-th claimed pattern position past the prefix, by a cursor over the
    // flags, and counts one where the rows differ
    int trans = 0;
    if (common > pref) {
        int cw = pref >> 5;
        uint32_t fw = pf[(size_t)cw * T] & ~below(pref & 31);
        for (int s = 0; s < smax; ++s) cur[(size_t)s * T] = off[s];
        cursor_walk<Idx>(text, slot, pos, cur, T, pref, J.len2,
                         common - pref, J.bound, pref, la,
                         [&](uint32_t, uint32_t c) {
            while (!fw) fw = pf[(size_t)(++cw) * T];
            const uint32_t low = fw & (0u - fw);
            fw ^= low;
            trans += pch[32 * cw + __ffs(low) - 1] != c;
        });
    }
    put(out, B, T, common, trans);
}

// block size and table placement of a cursor launch: the tables in shared
// memory while they take at most a quarter of a block's; the multiple of
// 32 threads up to 256 (else the largest power of two below 32) that keeps
// the most threads resident on an SM, the smaller on a tie.  Returns the
// dynamic shared memory a block takes, or -1 when one candidate's state
// does not fit.
int plan_cursor(int W, int smax, int isz, int stride, int* threads,
                bool* shared_tab) {
    const int per = cursor_bytes(W, smax, isz);
    *shared_tab = isz == 2 && stride <= kSmemBlock / 4;
    const int tabs = *shared_tab ? stride : 0;
    int best = 0, best_t = 0;
    for (int T = 32; T <= kMaxThreads; T += 32) {
        const long bytes = tabs + (long)T * per;
        if (bytes > kSmemBlock) break;
        long blocks = kSmemSM / (bytes + kSmemReserve);
        blocks = blocks < 32 ? blocks : 32;     // blocks an SM holds
        const long res = blocks * T < 2048 ? blocks * T : 2048;
        if (res > best) {
            best = (int)res;
            best_t = T;
        }
    }
    for (int T = 16; !best_t && T >= 1; T /= 2)
        if (tabs + (long)T * per <= kSmemBlock) best_t = T;
    if (!best_t) return -1;
    *threads = best_t;
    return tabs + best_t * per;
}

template <typename Idx, bool kSharedTab>
cudaError_t launch_cursor(const uint8_t* tab, const int32_t* las,
                          const uint32_t* cand, const int32_t* lb,
                          int32_t* out, int64_t B, int lb4, int W, int smax,
                          int T, int bytes, int nq, cudaStream_t stream) {
    auto kernel = jaro_scan_cursor<Idx, kSharedTab>;
    static int opted = 48 * 1024;
    if (bytes > opted) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        opted = bytes;
    }
    const dim3 grid((unsigned)((B + T - 1) / T), nq);
    kernel<<<grid, T, bytes, stream>>>(tab, las, cand, lb, out, B, lb4, W,
                                       smax);
    return cudaGetLastError();
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const int32_t* las,
                       const uint32_t* cand, const int32_t* lb, int32_t* out,
                       int64_t B, int lb4, int nq, cudaStream_t stream) {
    constexpr int T = RegPlan<W>::kThreads;
    const dim3 grid((unsigned)((B + T - 1) / T), nq);
    jaro_scan_reg<W><<<grid, T, 0, stream>>>(pm, las, cand, lb, out, B, lb4);
    return cudaGetLastError();
}

}  // namespace

// out is [2, nq, B] int32 (common, transpositions).  With tab null, the
// register form over the PM tables pm [nq, W, 256] (W <= 5); else the
// cursor form over the staged tables tab [nq, stride] bytes
// (cursor_tables: smax rows with positions at most, u16 indices while
// idx16(W)), at any W.
extern "C" cudaError_t rf_jaro_scan(const uint32_t* pm, const uint8_t* tab,
                                    int stride, int smax,
                                    const int32_t* las, const uint32_t* cand,
                                    const int32_t* lb, int32_t* out,
                                    int64_t B, int lb4, int W, int nq,
                                    cudaStream_t stream) {
    if (B < 1 || nq < 1 || W < 1) return cudaErrorInvalidValue;
    if (tab == nullptr) {
        switch (W) {
            case 1: return launch_reg<1>(pm, las, cand, lb, out, B, lb4, nq, stream);
            case 2: return launch_reg<2>(pm, las, cand, lb, out, B, lb4, nq, stream);
            case 3: return launch_reg<3>(pm, las, cand, lb, out, B, lb4, nq, stream);
            case 4: return launch_reg<4>(pm, las, cand, lb, out, B, lb4, nq, stream);
            case 5: return launch_reg<5>(pm, las, cand, lb, out, B, lb4, nq, stream);
            default: return cudaErrorInvalidValue;
        }
    }
    static_assert(kMaxRegW == 5, "the switch above instantiates W <= 5");
    const int isz = idx16(W) ? 2 : 4;
    if (smax < 0 || smax > kRows ||
        CursorLayout(W, smax, isz).stride != stride ||
        reinterpret_cast<uintptr_t>(tab) % 16)
        return cudaErrorInvalidValue;
    int T;
    bool shared_tab;
    const int bytes = plan_cursor(W, smax, isz, stride, &T, &shared_tab);
    if (bytes < 0) return cudaErrorInvalidValue;
    if (isz == 4)
        return launch_cursor<uint32_t, false>(tab, las, cand, lb, out, B,
                                              lb4, W, smax, T, bytes, nq,
                                              stream);
    if (shared_tab)
        return launch_cursor<uint16_t, true>(tab, las, cand, lb, out, B, lb4,
                                             W, smax, T, bytes, nq, stream);
    return launch_cursor<uint16_t, false>(tab, las, cand, lb, out, B, lb4, W,
                                          smax, T, bytes, nq, stream);
}
