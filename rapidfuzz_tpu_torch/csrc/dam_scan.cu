// K9: one-vs-many unrestricted Damerau-Levenshtein distance (the
// Zhao-Sahni linear-space form of Lowrance-Wagner), one query per launch,
// at any bucket and query length: a full form and a banded form.
//
// Replaces the TPU kernels of rapidfuzz_tpu/ops/pallas/damerau_kernel.py:
// * full form: _kernel_sq (_run_sq / _run_sq_flat, buckets <= 128 chars;
//   its int16 twins _kernel_sq16 (_run_sq16) and _kernel_sq16m
//   (_run_sq16m) and the lane-column forms _kernel (_run) and _kernel_lp
//   (_run_lp) compute the same function at the same shapes), and
//   _kernel_long (_run_long) and _kernel_long_stream (_run_long_stream),
//   the 129-8,192-char buckets.  The TPU split the work five ways by its
//   VMEM budget, its lane layout and its missing int16 compares; a CUDA
//   thread walks its own candidate at any length, so one kernel serves
//   every bucket (the wrapper counts launches over 128-char buckets apart,
//   dam_scan_long) and every query length;
// * banded form: _kernel_sqband (_run_sqband, buckets <= 128) and
//   _kernel_sqband_stream (_run_sqband_stream, the same band over 512-char
//   text chunks), radius kband in {3, 7, 15}: exact where the distance is
//   <= kband, some value > kband elsewhere (dam_band, dam_band_long).
//
// Orientation: the candidate's text is the DP's row axis (rows i = 1..lb,
// streamed from the packed corpus) and the query its column axis
// (j = 1..la, the same length across the launch, so the column loop does
// not diverge and the state is sized by the query, not by the bucket).
// The distance is symmetric, so this returns what the TPU kernels, which
// walk the query as rows, return.  Equality of text char c and query
// column j is bit (j-1) % 32 of the query's PM word (j-1) / 32 at row c,
// K1's table: byte and local mode and the scanner's never-matching query
// sentinel behave as in the other kernels.
//
// The recurrence (damerau_levenshtein.rs:111-168; _kernel_sq,
// damerau_kernel.py:443-516), rewritten on three facts:
// * "K[j] == i - 1" (the last text row holding query char j is the
//   previous one) is the previous row's equality bit at j;
// * "j - l == 1" (the last match of this row's char left of j is at
//   j - 1) is this row's equality bit at j - 1;
// * FR[j] and K[j] change together, at a match, so one array X[j] =
//   FR[j] - K[j] carries both (FR[j] + i - K[j] = X[j] + i).
// So a cell (i, j) with e = eq(i, j), e1 = eq(i, j-1), pe = eq(i-1, j) is
//   cand = min(D[i-1][j-1] + !e, min(D[i-1][j], D[i][j-1]) + 1)
//   tr   = e1 ? X[j] + i : pe ? rt + j : BIG
//   D[i][j] = e ? cand : min(cand, tr)
//   at a match: X[j] = D[i-1][j-2] - i, rt = D[i-2][j-1] - j
// with rt = D[i-2][l-1] - l of the row's last match l (BIG before one).
// The state of a candidate is D[i-1], D[i-2] and X, three ints per query
// column.
//
// What bounds it on an H100: integer issue.  A cell is 15.6 INT32-lane
// instructions in the SASS of the full form's unrolled register form
// (the bit tests, the mins and a DPX add-min for cand, the adds and
// selects of the transposition and of the match's updates), 13.6-15.1 in
// the band's at radius 3-15, 16-19.3 in its first kband + 1 rows, which
// also mask the column-0 edge: la cells per text row for the full form,
// 2*kband + 1 for the band (chip_smoke.DAM_CELL_OPS, DAM_BAND_OPS).
// The corpus is read once, a byte per char.  The scratch form adds a
// 4-byte load and a 4-byte store per cell, and those bytes bound it
// instead.
//
// Design:
// * one thread per candidate, over the chunk [b0, b0 + nb) of the corpus
//   (the wrapper bounds the scratch by launching over chunks); the packed
//   corpus is K1's [LB/4, B] u32, a coalesced load per 4 text rows, the
//   next word loaded while the current one's rows run; each thread stops
//   at its own length, so pad bytes are never compared;
// * register form (la <= 32 * kMaxRegW = 32; at 64 columns ptxas spills):
//   the PM table in shared memory, the three arrays in registers over a
//   compile-time width of 32*W columns (template on W), a row stopped
//   after the word that holds column la by a uniform branch; rows run in
//   pairs so that the two D buffers (each row overwriting the older)
//   swap at compile time, not by copying;
// * scratch form (la > 32 * kMaxRegW): three D rows (row i in plane
//   i % 3, so that D[i-2] outlives row i) and X in a [4, la, nb] int32
//   scratch, coalesced by candidate.  Each word of 32 columns loads its 32
//   D[i-1] values, D[i-2][j-1] only where the row's char matches column j
//   and X[j] only where it matches column j - 1 (predicated loads), all
//   before its cells run, so a thread keeps its loads in flight and moves
//   8 bytes a cell, not 16; the PM table in shared memory up to 48 KB
//   (W <= 48), through the read-only cache past that;
// * banded form: position p = 0..2k of row i holds column i - k + p
//   (_kernel_sqband's band-relative layout, damerau_kernel.py:899-1030),
//   the row's 2k + 1 equality bits one funnel shift of two PM words, the
//   previous row's the same word shifted by one; the three arrays of
//   2k + 2 positions in registers (the last a pad that column entering
//   the band reads as fresh), at any bucket length; the rows that reach
//   column 0 (i <= k + 1, the first (k + 1) / 4 packed words) run a loop
//   of their own that masks the edge, so the others do not pay for it
//   (a branch per row instead costs registers: ptxas spills at k = 15).
//   A candidate whose length differs from the query's by more than k
//   cannot be within k, so it returns BIG without a row;
// * la == 0 gives lb; lb == 0 gives la;
// * every offset into the corpus, the output and the scratch is 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;      // PM entries: every byte value
constexpr int kBig = 1 << 28;   // "no path"; every sum stays far below 2^31
constexpr int kMaxRegW = 1;     // register form up to 32 * kMaxRegW columns
                                // (W = 2 spills: 255 registers)
constexpr int kSmemWords = 48;  // PM table in shared memory up to 48 KB

template <bool SMEM>
__device__ __forceinline__ uint32_t pm_word(const uint32_t* pm, int w,
                                            uint32_t c) {
    return SMEM ? pm[w * kRows + c] : __ldg(pm + w * kRows + c);
}

// One cell.  up = D[i-1][j], diag = D[i-1][j-1], left = D[i][j-1],
// xo = X[j] before the row; returns D[i][j].
__device__ __forceinline__ int cell(int up, int diag, int left, int xo,
                                    int rt_j, int i, bool e, bool e1,
                                    bool pe) {
    const int cand = __viaddmin_s32(min(up, left), 1, diag + (e ? 0 : 1));
    const int tr = e1 ? xo + i : (pe ? rt_j : kBig);
    return e ? cand : min(cand, tr);
}

// One text row of the register form over columns 1..32W: cur holds
// D[i-2] and receives D[i]; prv holds D[i-1].  pmc / pmp: the PM words of
// this row's char and of the previous row's (zero before row 1).
template <int W>
__device__ __forceinline__ void row_reg(const uint32_t (&pmc)[W],
                                        const uint32_t (&pmp)[W],
                                        int (&cur)[32 * W],
                                        const int (&prv)[32 * W],
                                        int (&X)[32 * W], int i, int la) {
    int left = i, diag = i - 1, dprev = kBig;
    int d2l = i >= 2 ? i - 2 : kBig;
    int rt = kBig;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        if (32 * w >= la) break;
        const uint32_t ew = pmc[w];
        const uint32_t e1w = (ew << 1) | (w ? pmc[w > 0 ? w - 1 : 0] >> 31
                                            : 0u);
        const uint32_t pew = pmp[w];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
            const int p = 32 * w + b;           // column j = p + 1
            const int up = prv[p];
            const int d2 = cur[p];
            const bool e = (ew >> b) & 1u;
            const int nv = cell(up, diag, left, X[p], rt + p + 1, i, e,
                                (e1w >> b) & 1u, (pew >> b) & 1u);
            if (e) {
                X[p] = dprev - i;
                rt = d2l - (p + 1);
            }
            cur[p] = nv;
            left = nv;
            dprev = diag;
            diag = up;
            d2l = d2;
        }
    }
}

template <int W>
__device__ __forceinline__ void load_pm(const uint32_t* pm, uint32_t c,
                                        uint32_t (&out)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = pm[w * kRows + c];
}

template <int W>
__global__ void __launch_bounds__(kThreads)
dam_scan_reg(const uint32_t* __restrict__ pm_g, int la,
             const uint32_t* __restrict__ cand,
             const int32_t* __restrict__ lb, int32_t* __restrict__ out,
             int64_t B, int64_t b0, int64_t nb, int lb4) {
    constexpr int LA = 32 * W;
    __shared__ uint32_t pm[W * kRows];
    for (int t = threadIdx.x; t < W * kRows; t += kThreads) pm[t] = pm_g[t];
    __syncthreads();

    const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (k >= nb) return;
    const int64_t b = b0 + k;
    if (la == 0) { out[b] = lb[b]; return; }
    const int n = min(lb[b], 4 * lb4);

    // rows 1, 3, 5, ... write A over D[i-2]; rows 2, 4, ... write D
    int A[LA], D[LA], X[LA];
#pragma unroll
    for (int p = 0; p < LA; ++p) {
        A[p] = kBig;          // D[-1]
        D[p] = p + 1;         // D[0]
        X[p] = kBig;          // FR = BIG, K = 0
    }
    uint32_t pmp[W], pmc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) pmp[w] = 0u;
    const uint32_t* col = cand + b;
    const int rows = (n + 3) >> 2;
    uint32_t next = rows ? col[0] : 0u;
    int i = 0;
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = next;
        if (r + 1 < rows) next = col[(size_t)(r + 1) * B];
        const int m = min(4, n - 4 * r);
#pragma unroll 1
        for (int u = 0; u < m; u += 2) {
            load_pm<W>(pm, (word >> (8 * u)) & 0xFFu, pmc);
            row_reg<W>(pmc, pmp, A, D, X, ++i, la);
#pragma unroll
            for (int w = 0; w < W; ++w) pmp[w] = pmc[w];
            if (u + 1 < m) {
                load_pm<W>(pm, (word >> (8 * u + 8)) & 0xFFu, pmc);
                row_reg<W>(pmc, pmp, D, A, X, ++i, la);
#pragma unroll
                for (int w = 0; w < W; ++w) pmp[w] = pmc[w];
            }
        }
    }
    // row n sits in A when n is odd, in D when it is even (n == 0: D[0])
    const bool odd = n & 1;
    int dist = la;
#pragma unroll
    for (int p = 0; p < LA; ++p)
        dist = (p + 1 == la) ? (odd ? A[p] : D[p]) : dist;
    out[b] = dist;
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
dam_scan_scratch(const uint32_t* __restrict__ pm_g, int la,
                 const uint32_t* __restrict__ cand,
                 const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                 int32_t* __restrict__ scratch, int64_t B, int64_t b0,
                 int64_t nb, int lb4) {
    extern __shared__ uint32_t pm_s[];
    const int W = (la + 31) >> 5;
    if (SMEM) {
        for (int t = threadIdx.x; t < W * kRows; t += kThreads)
            pm_s[t] = pm_g[t];
        __syncthreads();
    }
    const uint32_t* pm = SMEM ? pm_s : pm_g;
    const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (k >= nb) return;
    const int64_t b = b0 + k;
    const int n = min(lb[b], 4 * lb4);
    // planes of this chunk's scratch: three D rows, row i in plane i % 3,
    // then X; column j of a plane at row (j - 1) * nb
    const size_t plane = (size_t)la * nb;
    int32_t* const base = scratch + k;
    int32_t* const xs = base + 3 * plane;
    for (int p = 0; p < la; ++p) {
        base[(size_t)p * nb] = p + 1;              // D[0]
        base[2 * plane + (size_t)p * nb] = kBig;   // D[-1]
        xs[(size_t)p * nb] = kBig;
    }
    int dist = la;
    const uint32_t* col = cand + b;
    uint32_t word = 0u, cprev = 0u;
    int pc = 1, pp = 0, p2 = 2;                    // planes of i, i-1, i-2
    for (int j = 0; j < n; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
        const int i = j + 1;
        int32_t* const cur = base + pc * plane;
        const int32_t* const prv = base + pp * plane;
        const int32_t* const pr2 = base + p2 * plane;
        int left = i, diag = i - 1, dprev = kBig;
        const int d2_0 = i >= 2 ? i - 2 : kBig;    // D[i-2][0]
        int rt = kBig;
        uint32_t carry = 0u;                       // bit 31 of the last word
        for (int w = 0; w < W; ++w) {
            const uint32_t ew = pm_word<SMEM>(pm, w, c);
            const uint32_t pew = j ? pm_word<SMEM>(pm, w, cprev) : 0u;
            const uint32_t e1w = (ew << 1) | carry;
            carry = ew >> 31;
            const int m = min(32, la - 32 * w);
            // D[i-2][j-1] is read only where this row's char matches
            // column j, and X[j] only where it matches column j - 1: the
            // loads of a word go out together, before its cells run
            int up[32], d2[32], xv[32];
#pragma unroll
            for (int t = 0; t < 32; ++t) {
                if (t < m) {
                    const int q = 32 * w + t;          // column q + 1
                    up[t] = prv[(size_t)q * nb];
                    d2[t] = ((ew >> t) & 1u)
                                ? (q ? pr2[(size_t)(q - 1) * nb] : d2_0)
                                : 0;
                    xv[t] = ((e1w >> t) & 1u) ? xs[(size_t)q * nb] : kBig;
                }
            }
#pragma unroll
            for (int t = 0; t < 32; ++t) {
                if (t < m) {
                    const int q = 32 * w + t;
                    const bool e = (ew >> t) & 1u;
                    const int nv = cell(up[t], diag, left, xv[t], rt + q + 1,
                                        i, e, (e1w >> t) & 1u,
                                        (pew >> t) & 1u);
                    if (e) {
                        xs[(size_t)q * nb] = dprev - i;
                        rt = d2[t] - (q + 1);
                    }
                    cur[(size_t)q * nb] = nv;
                    left = nv;
                    dprev = diag;
                    diag = up[t];
                }
            }
        }
        dist = left;                               // D[i][la]
        cprev = c;
        const int t3 = p2;
        p2 = pp;
        pp = pc;
        pc = t3;
    }
    out[b] = dist;
}

// Bits [off, off + 32) of the query's PM row c (zero outside the table's
// ws words): two words joined by a funnel shift.  off depends on the row
// alone, so the branches are uniform across the warp.
template <bool SMEM>
__device__ __forceinline__ uint32_t pm_window(const uint32_t* pm, int ws,
                                              uint32_t c, int off) {
    const int w = off >> 5;                   // floor (arithmetic shift)
    const uint32_t lo = (w >= 0 && w < ws) ? pm_word<SMEM>(pm, w, c) : 0u;
    const uint32_t hi = (w + 1 >= 0 && w + 1 < ws)
                            ? pm_word<SMEM>(pm, w + 1, c) : 0u;
    return __funnelshift_r(lo, hi, (unsigned)(off & 31));
}

// One text row of the band: positions p = 0..2K hold columns i - K + p;
// cur holds row i-2 and receives row i, prv holds row i-1, X is shifted
// by one position as it is read (column j sits one position further left
// in each row).  eb: bit p = eq(i, i - K + p); pb: bit p = eq(i-1, same
// column), cleared at p = 2K (that column was outside row i-1's band).
// EDGE: a row i <= K + 1, whose band reaches column 0 or left of it.
template <int K, bool EDGE>
__device__ __forceinline__ void row_band(uint32_t eb, uint32_t pb,
                                         int (&cur)[2 * K + 2],
                                         const int (&prv)[2 * K + 2],
                                         int (&X)[2 * K + 2], int i) {
    constexpr int P = 2 * K + 1;
    int left = (EDGE && i == K + 1) ? i : kBig;   // D[i][i - K - 1]
    int dprev = kBig;
    int rt = kBig;
    const uint32_t e1b = eb << 1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int diag = prv[p];
        const int up = prv[p + 1];
        const int d2l = cur[p + 1];           // D[i-2][j-1]
        const int xo = X[p + 1];
        const bool e = (eb >> p) & 1u;
        int nv = cell(up, diag, left, xo, rt + p, i, e, (e1b >> p) & 1u,
                      (pb >> p) & 1u);
        if (EDGE) {
            const int jcol = i - K + p;
            nv = jcol >= 1 ? nv : (jcol == 0 ? i : kBig);
        }
        X[p] = e ? dprev - i : xo;
        if (e) rt = d2l - p;
        cur[p] = nv;
        left = nv;
        dprev = diag;
    }
}

// The band's rows over packed words [r, r_end) of a candidate's text of
// n chars (rows words at col, stride B): next holds word r, already
// loaded; i is the last row done and eprev its equality bits.  EDGE: rows
// that reach column 0.  Rows run in pairs, so that A and D (each row
// overwriting the older) swap at compile time: a word holds 4 rows, so
// i = 4r is even at a call and row i + 1 writes A.
template <int K, bool EDGE, bool SMEM>
__device__ __forceinline__ void band_words(
        const uint32_t* pm, int ws, const uint32_t* col, int64_t B, int n,
        int rows, int r, int r_end, uint32_t& next, uint32_t& eprev, int& i,
        int (&A)[2 * K + 2], int (&D)[2 * K + 2], int (&X)[2 * K + 2]) {
    constexpr uint32_t kPrevMask = (1u << (2 * K)) - 1u;
#pragma unroll 1
    for (; r < r_end; ++r) {
        const uint32_t word = next;
        if (r + 1 < rows) next = col[(size_t)(r + 1) * B];
        const int m = min(4, n - 4 * r);
#pragma unroll 1
        for (int u = 0; u < m; u += 2) {
            ++i;
            uint32_t eb = pm_window<SMEM>(pm, ws, (word >> (8 * u)) & 0xFFu,
                                          i - K - 1);
            row_band<K, EDGE>(eb, (eprev >> 1) & kPrevMask, A, D, X, i);
            eprev = eb;
            if (u + 1 < m) {
                ++i;
                eb = pm_window<SMEM>(pm, ws, (word >> (8 * u + 8)) & 0xFFu,
                                     i - K - 1);
                row_band<K, EDGE>(eb, (eprev >> 1) & kPrevMask, D, A, X, i);
                eprev = eb;
            }
        }
    }
}

template <int K, bool SMEM>
__global__ void __launch_bounds__(kThreads)
dam_band_kernel(const uint32_t* __restrict__ pm_g, int ws, int la,
                const uint32_t* __restrict__ cand,
                const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                int64_t B, int lb4) {
    constexpr int P = 2 * K + 1;
    extern __shared__ uint32_t pm_s[];
    if (SMEM) {
        for (int t = threadIdx.x; t < ws * kRows; t += kThreads)
            pm_s[t] = pm_g[t];
        __syncthreads();
    }
    const uint32_t* pm = SMEM ? pm_s : pm_g;
    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    if (la == 0) { out[b] = lb[b]; return; }
    const int n = min(lb[b], 4 * lb4);
    if (n - la > K || la - n > K) { out[b] = kBig; return; }

    // rows 1, 3, ... write A over row i-2; rows 2, 4, ... write D; row 0
    // (D): D[0][j] = j at p = j + K, columns < 0 BIG; the pad slot BIG
    int A[P + 1], D[P + 1], X[P + 1];
#pragma unroll
    for (int p = 0; p <= P; ++p) {
        A[p] = kBig;
        D[p] = (p >= K && p < P) ? p - K : kBig;
        X[p] = kBig;
    }
    uint32_t eprev = 0u;                      // row i-1's bits at its offset
    const uint32_t* col = cand + b;
    const int rows = (n + 3) >> 2;
    uint32_t next = rows ? col[0] : 0u;
    int i = 0;
    // the first K + 1 rows (whole packed words) reach column 0 and take
    // the masked body, the others the unmasked one
    static_assert((K + 1) % 4 == 0, "edge rows fill whole packed words");
    const int r_edge = min(rows, (K + 1) / 4);
    band_words<K, true, SMEM>(pm, ws, col, B, n, rows, 0, r_edge, next,
                              eprev, i, A, D, X);
    band_words<K, false, SMEM>(pm, ws, col, B, n, rows, r_edge, rows, next,
                               eprev, i, A, D, X);
    // D[n][la] at position la - n + K of row n (A when n is odd)
    const bool odd = n & 1;
    const int pf = la - n + K;
    int dist = kBig;
#pragma unroll
    for (int p = 0; p < P; ++p)
        dist = (p == pf) ? (odd ? A[p] : D[p]) : dist;
    out[b] = dist;
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, int la, const uint32_t* cand,
                       const int32_t* lb, int32_t* out, int64_t B,
                       int64_t b0, int64_t nb, int lb4, cudaStream_t stream) {
    const unsigned grid = (unsigned)((nb + kThreads - 1) / kThreads);
    dam_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, la, cand, lb, out, B,
                                                   b0, nb, lb4);
    return cudaGetLastError();
}

template <int K>
cudaError_t launch_band(const uint32_t* pm, int ws, int la,
                        const uint32_t* cand, const int32_t* lb,
                        int32_t* out, int64_t B, int lb4,
                        cudaStream_t stream) {
    const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
    if (ws <= kSmemWords) {
        dam_band_kernel<K, true><<<grid, kThreads, ws * kRows * 4, stream>>>(
            pm, ws, la, cand, lb, out, B, lb4);
    } else {
        dam_band_kernel<K, false><<<grid, kThreads, 0, stream>>>(
            pm, ws, la, cand, lb, out, B, lb4);
    }
    return cudaGetLastError();
}

}  // namespace

// Full distances of the query (length la, PM table pm [W, 256]) to
// candidates [b0, b0 + nb) of the packed corpus cand [lb4, B], written to
// out[b].  Queries over 32 * kMaxRegW chars need scratch: 4 * la * nb
// int32.
extern "C" cudaError_t rf_dam_scan(const uint32_t* pm, int la,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, int32_t* scratch, int64_t B,
                                   int64_t b0, int64_t nb, int lb4,
                                   cudaStream_t stream) {
    if (la < 0 || b0 < 0 || nb < 0 || b0 + nb > B)
        return cudaErrorInvalidValue;
    if (nb == 0) return cudaSuccess;
    const int W = la > 0 ? (la + 31) / 32 : 1;
    static_assert(kMaxRegW == 1, "the branch below instantiates W == 1");
    if (W == 1)
        return launch_reg<1>(pm, la, cand, lb, out, B, b0, nb, lb4, stream);
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((nb + kThreads - 1) / kThreads);
    if (W <= kSmemWords) {
        dam_scan_scratch<true><<<grid, kThreads, W * kRows * 4, stream>>>(
            pm, la, cand, lb, out, scratch, B, b0, nb, lb4);
    } else {
        dam_scan_scratch<false><<<grid, kThreads, 0, stream>>>(
            pm, la, cand, lb, out, scratch, B, b0, nb, lb4);
    }
    return cudaGetLastError();
}

// Banded distances (radius kband in {3, 7, 15}) of the query (length la,
// PM table pm [ws, 256]) to every candidate of cand [lb4, B]: exact where
// the distance is <= kband, some value > kband elsewhere.
extern "C" cudaError_t rf_dam_band(const uint32_t* pm, int ws, int la,
                                   int kband, const uint32_t* cand,
                                   const int32_t* lb, int32_t* out,
                                   int64_t B, int lb4, cudaStream_t stream) {
    if (la < 0 || ws < 1 || B < 0) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    switch (kband) {
        case 3: return launch_band<3>(pm, ws, la, cand, lb, out, B, lb4,
                                      stream);
        case 7: return launch_band<7>(pm, ws, la, cand, lb, out, B, lb4,
                                      stream);
        case 15: return launch_band<15>(pm, ws, la, cand, lb, out, B, lb4,
                                        stream);
        default: return cudaErrorInvalidValue;
    }
}
