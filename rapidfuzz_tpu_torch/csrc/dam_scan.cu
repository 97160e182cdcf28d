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
//   VMEM budget, its lane layout and its missing int16 compares; here one
//   kernel serves every bucket (the wrapper counts launches over 128-char
//   buckets apart, dam_scan_long) and every query length;
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
// The state of a column is D[i-1][j], D[i-2][j] and X[j], three ints;
// what a row carries from column to column is D[i][j], D[i-1][j],
// D[i-2][j], D[i-1][j-1], rt and eq(i, j).
//
// What bounds it on an H100: integer issue.  A cell of the full form's
// unrolled tile row is 11.0 instructions on the INT32 lanes in its SASS
// (the bit tests, the mins and a DPX add-min for cand, the selects of the
// transposition and of the match's updates; its adds issue as IMAD and
// VIADD, off those lanes), a band cell 13.6-15.1 non-IMAD instructions at
// radius 3-15, 16-19.3 in its first kband + 1 rows, which also mask the
// column-0 edge: la cells per text row for the full form, 2*kband + 1
// for the band (chip_smoke.DAM_CELL_OPS, DAM_BAND_OPS).  The corpus is
// read once, a byte per char.  No cell's state goes through device
// memory.  What the full form's layout adds beside the cells
// (chip_smoke's dam_scan*_layout_bound_ms): the hand-off between lanes
// each step, the cells of a last tile past column la, the idle lanes of
// a warp that 32 / G groups do not fill, the G - 1 steps of a group's
// ramp in which its lanes wait for their first or after their last row,
// and a warp's wait for its longest candidate; past 1,024 query columns,
// 12 bytes per text row at each strip edge.
//
// Design of the full form:
// * a lane owns a tile of 32 query columns: its two DP rows and X in
//   registers (96 ints, the state one thread held for a whole 32-char
//   query before) and the PM words of its row's char and of the previous
//   row's; the PM table in shared memory up to 48 KB (W <= 48), through
//   the read-only cache past that;
// * a group of G lanes works one candidate, G the query's tiles (at most
//   32), 32 / G groups a warp, its other 32 % G lanes idle.  Lane t
//   runs text row s - t at step s (a wavefront): after each row it hands
//   lane t + 1, by __shfl_up_sync, D[i][c0] and D[i][c0 - 1] of that
//   lane's left edge c0, the row's rt and the row's char with
//   eq(i, c0); the values received one and two steps before are
//   D[i-1][c0], D[i-2][c0] and D[i-1][c0-1].  Only lane 0 reads the
//   packed corpus (K1's [LB/4, B] u32, a word every 4 rows, loaded a word
//   ahead).  A group runs lb + G - 1 steps per strip (G the strip's
//   tiles), and a warp runs to its longest candidate: every lane stays in
//   the loop (the shuffles need the whole warp) and leaves its state as it
//   is at rows outside [1, lb];
// * steps run in pairs, so that the two row buffers (each row overwriting
//   the older) swap at compile time: odd steps write A, even ones D, and
//   a lane starts with row 0 in the buffer that its first row, at step
//   t + 1, reads;
// * queries over 1,024 chars: the warp sweeps the query in strips of
//   1,024 columns.  Per text row, lane 31 writes D[i][c], D[i][c - 1] and
//   rt at the strip's right edge c (12 bytes) to the candidate's edge
//   buffer [3, LB], and lane 0 of the next strip reads them back a row
//   ahead of its use; the buffer is reused in place (a row is read 31
//   steps before lane 31 writes it again).  X is per column, so it stays
//   in the strip's registers.  The wrapper launches over chunks of
//   candidates whose edge buffers fit its memory plan
//   (damerau_kernel.SCRATCH_BYTES);
// * the corpus comes sorted by length, and block b works the candidates
//   of block nblocks - 1 - b, so the longest texts start first;
// * blocks of 128 threads: at ~170 registers a thread, 3 of them fit an
//   SM where a 256-thread block fits once;
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
// * every offset into the corpus, the output and the edge buffer is
//   64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // the band's block
constexpr int kTileThreads = 128;  // the full form's block
constexpr int kRows = 256;         // PM entries: every byte value
constexpr int kBig = 1 << 28;      // "no path"; every sum stays far below
                                   // 2^31
constexpr int kTile = 32;          // query columns a lane holds
constexpr int kStrip = 32 * kTile; // query columns a warp sweeps at once
constexpr int kSmemWords = 48;     // PM table in shared memory up to 48 KB
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// One text row i over a tile of query columns c0 + 1 .. c0 + 32: cur
// holds D[i-2] and receives D[i]; prv holds D[i-1].  ew / pew: the tile's
// PM words of this row's char and of the previous row's (zero before row
// 1); e1 = eq(i, c0).  From the left edge: left = D[i][c0], diag =
// D[i-1][c0], d2l = D[i-2][c0], dprev = D[i-1][c0-1], and the row's rt
// relative to the tile (rt + p + 1 is rt + j at column j = c0 + p + 1).
// Returns the rt past the tile's last column, relative to c0.
__device__ __forceinline__ int row_tile(uint32_t ew, uint32_t pew,
                                        uint32_t e1, int (&cur)[kTile],
                                        const int (&prv)[kTile],
                                        int (&X)[kTile], int i, int left,
                                        int diag, int d2l, int dprev,
                                        int rt) {
    const uint32_t e1w = (ew << 1) | e1;
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
        const int up = prv[p];
        const int d2 = cur[p];
        const bool e = (ew >> p) & 1u;
        const int nv = cell(up, diag, left, X[p], rt + p + 1, i, e,
                            (e1w >> p) & 1u, (pew >> p) & 1u);
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
    return rt;
}

// The full form over candidates [b0, b0 + nb): G lanes a candidate
// (MULTI: G > 1), a tile of 32 query columns each (the header's design).
// edge: [nb, 3, LB] int32, LB = 4 * lb4, read and written only when
// la > kStrip.
template <bool MULTI, bool SMEM>
__global__ void __launch_bounds__(kTileThreads)
dam_scan_tile(const uint32_t* __restrict__ pm_g, int la, int G,
              const uint32_t* __restrict__ cand,
              const int32_t* __restrict__ lb, int32_t* __restrict__ out,
              int32_t* __restrict__ edge, int64_t B, int64_t b0,
              int64_t nb, int lb4) {
    extern __shared__ uint32_t pm_s[];
    if (SMEM) {
        const int ws = (la + 31) >> 5;
        for (int q = threadIdx.x; q < ws * kRows; q += kTileThreads)
            pm_s[q] = pm_g[q];
        __syncthreads();
    }
    const uint32_t* const pm = SMEM ? pm_s : pm_g;
    // a warp holds 32 / G groups; its lanes past them idle
    const int lane = threadIdx.x & 31;
    const int per = MULTI ? 32 / G : 32;
    const int grp = MULTI ? lane / G : lane;
    const int t = MULTI ? lane - grp * G : 0;    // the lane's tile
    // the longest texts (the corpus's last) start first
    const int64_t k =
        ((int64_t)(gridDim.x - 1 - blockIdx.x) * (kTileThreads / 32)
         + threadIdx.x / 32) * per + grp;
    const bool real = grp < per && k < nb;
    const int64_t b = b0 + (real ? k : 0);
    if (la == 0) {
        if (real && t == 0) out[b] = lb[b];
        return;
    }
    const int LB = 4 * lb4;
    const int n = real ? min(lb[b], LB) : 0;
    const int nmax = __reduce_max_sync(kFull, n);
    const uint32_t* const col = cand + b;
    const int rows = (n + 3) >> 2;
    int32_t* const eg = edge != nullptr
                            ? edge + (size_t)(real ? k : 0) * 3 * LB
                            : nullptr;
    const int nstrip = (la + kStrip - 1) / kStrip;
    // the tile that holds column la, in the last strip
    const int tla = (la - 1 - (nstrip - 1) * kStrip) / kTile;
    int dist = la;                            // lb == 0: D[0][la]
    for (int st = 0; st < nstrip; ++st) {
        const int cs = st * kStrip;           // the strip's left edge
        const int c0 = cs + kTile * t;        // the tile's left edge
        const bool live = c0 < la;
        const int glive = min(G, (la - cs + kTile - 1) / kTile);
        const int steps = nmax > 0 ? nmax + glive - 1 : 0;
        const bool more = st + 1 < nstrip;
        // the tile's PM word and, for lane 0 past the first strip, the
        // word that holds column cs: indices, not pointers, and plain
        // loads (with pointers or __ldg ptxas spilled 12 bytes in the form
        // that reads the table from device memory)
        const int wt = live ? c0 / kTile : 0;
        const int we = cs > 0 ? cs / kTile - 1 : 0;
        // row 0 in the buffer that the lane's first row (step t + 1)
        // reads, row -1 (BIG) in the one it writes: odd steps write A
        int A[kTile], D[kTile], X[kTile];
        const bool even = (t & 1) == 0;
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
            A[p] = even ? kBig : c0 + p + 1;
            D[p] = even ? c0 + p + 1 : kBig;
            X[p] = kBig;
        }
        // the next row's D[i-1][c0], D[i-2][c0] and D[i-1][c0-1]
        int h1 = c0, h2 = kBig, hm = c0 > 0 ? c0 - 1 : kBig;
        uint32_t pew = 0u;
        // what the last row hands on: D[i][c0 + 32], D[i][c0 + 31], rt
        // relative to c0 + 32, and the row's char | eq(i, c0 + 32) << 8
        int oL = 0, oM = 0, oR = 0;
        uint32_t oC = 0u;
        // lane 0: the packed word after the current one and, past the
        // first strip, the edge values of its next row
        uint32_t word = 0u, next = 0u;
        int eL = 0, eM = 0, eR = 0;
        if (t == 0 && n > 0) {
            next = col[0];
            if (cs > 0) {
                eL = eg[0];
                eM = eg[LB];
                eR = eg[2 * LB];
            }
        }
        auto step = [&](int s, int (&cur)[kTile], int (&prv)[kTile]) {
            const int i = s - t;
            int iL = oL, iM = oM, iR = oR;
            uint32_t iC = oC;
            if (MULTI) {
                // lane t - 1's last row; a group's lane 0 ignores its
                iL = __shfl_up_sync(kFull, oL, 1);
                iM = __shfl_up_sync(kFull, oM, 1);
                iR = __shfl_up_sync(kFull, oR, 1);
                iC = __shfl_up_sync(kFull, oC, 1);
            }
            const bool act = live && i >= 1 && i <= n;
            if (t == 0 && act) {
                const int j = i - 1;
                if ((j & 3) == 0) {
                    word = next;
                    if ((j >> 2) + 1 < rows)
                        next = col[(size_t)((j >> 2) + 1) * B];
                }
                const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
                if (cs == 0) {
                    iL = i;
                    iM = kBig;
                    iR = kBig;
                    iC = c;
                } else {
                    iL = eL;
                    iM = eM;
                    iR = eR;
                    iC = c | ((pm[we * kRows + c] >> 31) << 8);
                    if (i < n) {
                        eL = eg[i];
                        eM = eg[LB + i];
                        eR = eg[2 * LB + i];
                    }
                }
            }
            if (act) {
                const uint32_t c = iC & 0xFFu;
                const uint32_t ew = pm[wt * kRows + c];
                const int rt = row_tile(ew, pew, iC >> 8, cur, prv, X, i,
                                        iL, h1, h2, hm, iR);
                oL = cur[kTile - 1];
                oM = cur[kTile - 2];
                oR = rt + kTile;
                oC = c | ((ew >> 31) << 8);
                h2 = h1;
                h1 = iL;
                hm = iM;
                pew = ew;
                if (MULTI && t == G - 1 && more) {
                    eg[i - 1] = oL;
                    eg[LB + i - 1] = oM;
                    eg[2 * LB + i - 1] = oR;
                }
            }
        };
#pragma unroll 1
        for (int s = 1; s <= steps; s += 2) {
            step(s, A, D);
            if (s < steps) step(s + 1, D, A);
        }
        if (more) {
            __syncwarp();                     // lane 31's edge, lane 0
        } else if (t == tla && n > 0) {
            // row n, written at step n + t
            const int p = (la - 1) % kTile;
            const bool odd = (n + t) & 1;
#pragma unroll
            for (int q = 0; q < kTile; ++q)
                dist = q == p ? (odd ? A[q] : D[q]) : dist;
        }
    }
    if (real && t == tla) out[b] = dist;
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

template <bool MULTI>
cudaError_t launch_tile(const uint32_t* pm, int la, int G,
                        const uint32_t* cand, const int32_t* lb,
                        int32_t* out, int32_t* edge, int64_t B, int64_t b0,
                        int64_t nb, int lb4, cudaStream_t stream) {
    const int64_t per = (kTileThreads / 32) * (32 / G);  // per block
    const unsigned grid = (unsigned)((nb + per - 1) / per);
    const int ws = (la + 31) / 32;
    if constexpr (MULTI) {
        if (ws > kSmemWords) {
            dam_scan_tile<true, false><<<grid, kTileThreads, 0, stream>>>(
                pm, la, G, cand, lb, out, edge, B, b0, nb, lb4);
            return cudaGetLastError();
        }
    }
    dam_scan_tile<MULTI, true><<<grid, kTileThreads, ws * kRows * 4,
                                 stream>>>(pm, la, G, cand, lb, out, edge, B,
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
// out[b].  Queries over kStrip = 1,024 chars need the edge buffer edge:
// 3 * 4 * lb4 int32 per candidate, [nb, 3, 4 * lb4].
extern "C" cudaError_t rf_dam_scan(const uint32_t* pm, int la,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, int32_t* edge, int64_t B,
                                   int64_t b0, int64_t nb, int lb4,
                                   cudaStream_t stream) {
    if (la < 0 || b0 < 0 || nb < 0 || b0 + nb > B)
        return cudaErrorInvalidValue;
    if (nb == 0) return cudaSuccess;
    if (la > kStrip && edge == nullptr) return cudaErrorInvalidValue;
    // a lane per tile of the query (its first strip), at most a warp
    const int G = min(32, max(1, (la + kTile - 1) / kTile));
    if (G == 1)
        return launch_tile<false>(pm, la, G, cand, lb, out, edge, B, b0, nb,
                                  lb4, stream);
    return launch_tile<true>(pm, la, G, cand, lb, out, edge, B, b0, nb, lb4,
                             stream);
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
