// K7: one-vs-many weighted Levenshtein (Wagner-Fischer row DP with
// per-operation costs), one query per launch, at any bucket length and
// any query length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/wlev_kernel.py:_kernel
// (launched by _run, buckets <= 1024 chars) and
// rapidfuzz_tpu/ops/pallas/stream_kernel.py:_wlev_kernel (_wlev_run),
// which serves buckets over 1024 chars by streaming 512-char text chunks
// through a second grid axis with the row carried in a VMEM scratch of
// (LA+1, sub, 128) int32, and so caps queries at 256 chars
// (WLEV_STREAM_MAX_LA).  Both limits were VMEM limits: here a candidate's
// thread, or its lanes, walk its text from global memory at any length
// and keep its row in registers, so one kernel serves every bucket and
// every query, and the wrapper counts launches over 1024-char buckets
// apart (wlev_scan_long).
//
// The recurrence (wlev_kernel.py:38-88; the reference's
// levenshtein.rs:212-259): the row D[0..la] starts at D[p] = p*del; text
// char c at step j < lb adds ins to D[0], then for p = 1..la
//   D[p] = min(D_old[p] + ins, D[p-1] + del,
//              D_old[p-1] + (P[p-1] == c ? 0 : sub))
// and the distance is D[la].  Deletion is charged on the query's chars,
// insertion on the candidate's.  P[p-1] == c is bit (p-1) % 32 of the
// query's PM word (p-1) / 32 at row c, K1's table: byte and local mode
// and the never-matching sentinel of the scanner's query encoding behave
// exactly as on the TPU.  Cells are int32, as there; the wrapper refuses
// tables whose cells could overflow.
//
// What bounds it on an H100: integer issue.  A cell needs 7 integer
// operations (the PM bit test, the select of 0 or sub, the add to the
// diagonal, the adds of ins and del, two mins), la cells per text step;
// the corpus is read once, 1 byte per char.  Hopper's DPX instruction
// __viaddmin_s32 (VIADDMNMX, min(a + b, c) in one instruction) fuses each
// add with its min, so a cell issues two of those, the bit test and the
// cost's select on the INT32 lanes (chip_smoke.WLEV_CELL_OPS counts them
// in the SASS), the add of the cost as an IMAD on the FMA lanes, and its
// dependent chain through the left neighbour is one instruction.  No form
// moves a cell through device memory.
//
// Two forms, both taking the corpus longest first (it comes sorted by
// length, and block b works the candidates of block nblocks - 1 - b):
// * register form (la <= 128): one thread per candidate, the query's PM
//   table ([W, 256] u32) in shared memory and the row in registers, the
//   position loop unrolled over a compile-time LA = 32*W (template on
//   W = 1..4) and stopped after the word holding position la by a uniform
//   branch per word; D[la] is read by a select chain, as a register array
//   takes compile-time indices only.  The text loop holds one copy of the
//   step (not one per char of a packed word), so the unrolled row stays
//   small in the instruction cache, and loads the next packed word while
//   the current one's 4 steps run;
// * tile form (la > 128): a lane holds a tile of kTile = 32 consecutive
//   query positions of one candidate's row, D[c0 + 1 .. c0 + 32], in
//   registers, and a candidate takes G = ceil(la / 32) lanes, at most a
//   warp, 32 / G candidates a warp, its other 32 % G lanes idle.  A cell
//   reads its left neighbour in the same row, so lane t runs text row
//   i = s - t at step s (a wavefront): it takes from lane t - 1, by
//   __shfl_up_sync, that lane's last row's char and D[i][c0] at its own
//   left edge c0; the value taken one row earlier is the diagonal
//   D[i-1][c0].  Only a group's lane 0 reads the packed corpus (K1's
//   [LB/4, B] u32, a word every 4 rows, loaded a word ahead) and starts
//   the row at D[i][0] = i*ins.  A group runs lb + G - 1 steps per strip,
//   and a warp runs to its longest candidate: every lane stays in the loop
//   (the shuffles need the whole warp) and leaves its row as it is at rows
//   outside [1, lb].  The lane that holds position la picks D[lb][la] by a
//   select chain; with lb == 0 its row is still row 0, la*del;
// * tile form's table: staged per strip in shared memory as [256, 32]
//   u32, char-major, so the lanes of a group, holding consecutive tiles,
//   read consecutive banks whatever their char;
// * strips: queries over kStrip = 1,024 chars are swept in strips of
//   1,024 positions, each a pass over the text.  Per text row the strip's
//   last lane writes D[i][c] at its right edge c to the candidate's edge
//   buffer ([nb, LB] int32, a candidate's rows contiguous), and lane 0 of
//   the next strip reads it back a row ahead of its use; the buffer is
//   reused in place (a row is read 31 steps before the last lane writes it
//   again).  The wrapper launches over chunks of candidates whose edge
//   buffers fit its memory plan (wlev_kernel.SCRATCH_BYTES);
// * la == 0 gives lb*ins, lb == 0 gives la*del;
// * every offset into the corpus, the output and the edge buffer is
//   64-bit (row * B, candidate * LB); only per-candidate lengths, the row
//   count lb4 and the query length are 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // the register form's block
constexpr int kTileThreads = 256;  // the tile form's block
constexpr int kRows = 256;         // PM entries: every byte value
constexpr int kMaxRegW = 4;        // row in registers up to 32*kMaxRegW chars
constexpr int kTile = 32;          // query positions a lane of the tile form
                                   // holds
constexpr int kTileWords = kTile / 32;
constexpr int kStrip = 32 * kTile; // query positions a warp sweeps at once
constexpr int kStripWords = kStrip / 32;
// blocks an SM keeps of the tile form: caps its registers at 80 (65,536
// a SM); at 2 (88 registers, 16 warps an SM) it ran 8 % slower
constexpr int kTileBlocks = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One Wagner-Fischer cell: the candidate's char was (hit) or was not the
// query's char at this position.  min(D_old[p] + ins, diag + cost) does
// not depend on the left neighbour; the chain through prev is one DPX
// add-min.
__device__ __forceinline__ int cell(int old, int diag, int prev,
                                    bool hit, int ins, int del, int sub) {
    const int up_or_diag = __viaddmin_s32(old, ins, diag + (hit ? 0 : sub));
    return __viaddmin_s32(prev, del, up_or_diag);
}

// One text step of the register form over D[0..LA], stopped after the
// word that holds position la: a branch per word, none per position (one
// per position tripled the step's time on the card).  The positions of
// that word past la run too, but no cell at or before la reads them.
template <int W>
__device__ __forceinline__ void step(const uint32_t* __restrict__ pm,
                                     uint32_t c, int (&D)[32 * W + 1],
                                     int la, int ins, int del, int sub) {
    int diag = D[0];
    D[0] += ins;
    int prev = D[0];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        if (32 * w >= la) break;
        const uint32_t pmw = pm[w * kRows + c];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int p = 32 * w + i + 1;
            const int old = D[p];
            prev = cell(old, diag, prev, (pmw >> i) & 1u, ins, del, sub);
            D[p] = prev;
            diag = old;
        }
    }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
wlev_scan_reg(const uint32_t* __restrict__ pm_g, int la, int ins, int del,
              int sub, const uint32_t* __restrict__ cand,
              const int32_t* __restrict__ lb, int32_t* __restrict__ out,
              int64_t B, int64_t b0, int64_t nb, int lb4) {
    constexpr int LA = 32 * W;
    __shared__ uint32_t pm[W * kRows];
    for (int i = threadIdx.x; i < W * kRows; i += kThreads) pm[i] = pm_g[i];
    __syncthreads();

    // the longest texts (the corpus's last) start first
    const int64_t k =
        (int64_t)(gridDim.x - 1 - blockIdx.x) * kThreads + threadIdx.x;
    if (k >= nb) return;
    const int64_t b = b0 + k;
    if (la == 0) { out[b] = lb[b] * ins; return; }
    const int n = min(lb[b], 4 * lb4);

    int D[LA + 1];
#pragma unroll
    for (int p = 0; p <= LA; ++p) D[p] = p * del;
    // the next packed word is loaded while the current one's 4 steps run:
    // at this occupancy nothing else would hide the load's latency
    const uint32_t* col = cand + b;
    const int rows = (n + 3) >> 2;
    uint32_t next = rows ? col[0] : 0u;
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = next;
        if (r + 1 < rows) next = col[(size_t)(r + 1) * B];
        const int m = min(4, n - 4 * r);
#pragma unroll 1
        for (int u = 0; u < m; ++u)
            step<W>(pm, (word >> (8 * u)) & 0xFFu, D, la, ins, del, sub);
    }
    int dist = D[0];
#pragma unroll
    for (int p = 1; p <= LA; ++p) dist = (p == la) ? D[p] : dist;
    out[b] = dist;
}

// The tile form over candidates [b0, b0 + nb) (the header's design): G
// lanes a candidate, kTile query positions each, the strip's table
// [256, kStripWords] in dynamic shared memory.  edge: [nb, LB] int32,
// LB = 4 * lb4, read and written only when la > kStrip.
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
wlev_scan_tile(const uint32_t* __restrict__ pm_g, int la, int G, int ins,
               int del, int sub, const uint32_t* __restrict__ cand,
               const int32_t* __restrict__ lb, int32_t* __restrict__ out,
               int32_t* __restrict__ edge, int64_t B, int64_t b0,
               int64_t nb, int lb4) {
    extern __shared__ uint32_t pm[];
    const int W = (la + 31) >> 5;
    // a warp holds 32 / G groups; its lanes past them idle
    const int lane = threadIdx.x & 31;
    const int per = 32 / G;
    const int grp = lane / G;
    const int t = lane - grp * G;               // the lane's tile
    // the longest texts (the corpus's last) start first
    const int64_t k =
        ((int64_t)(gridDim.x - 1 - blockIdx.x) * (kTileThreads / 32)
         + threadIdx.x / 32) * per + grp;
    const bool real = grp < per && k < nb;
    const int64_t b = b0 + (real ? k : 0);
    const int LB = 4 * lb4;
    const int n = real ? min(lb[b], LB) : 0;
    const int nmax = __reduce_max_sync(kFull, n);
    const uint32_t* const col = cand + b;
    int32_t* const eg =
        edge != nullptr ? edge + (size_t)(real ? k : 0) * LB : nullptr;
    const int nstrip = (la + kStrip - 1) / kStrip;
    // the lane and position that hold column la, in the last strip
    const int tla = (la - 1 - (nstrip - 1) * kStrip) / kTile;
    for (int st = 0; st < nstrip; ++st) {
        const int cs = st * kStrip;             // the strip's left edge
        const int ws = min(kStripWords, W - cs / 32);
        // the previous strip's table reads and edge stores are done
        if (st > 0) __syncthreads();
        for (int q = threadIdx.x; q < kStripWords * kRows;
             q += kTileThreads) {
            const int w = q >> 8, c = q & (kRows - 1);
            pm[c * kStripWords + w] =
                w < ws ? pm_g[(size_t)(cs / 32 + w) * kRows + c] : 0u;
        }
        __syncthreads();
        const int c0 = cs + kTile * t;          // the tile's left edge
        const int glive = min(G, (la - cs + kTile - 1) / kTile);
        const int steps = nmax > 0 ? nmax + glive - 1 : 0;
        const bool edge_out = st + 1 < nstrip && t == G - 1;
        const uint32_t* const tile = pm + kTileWords * t;
        // row 0, and D[i-1][c0] before row 1
        int D[kTile];
#pragma unroll
        for (int p = 0; p < kTile; ++p) D[p] = (c0 + p + 1) * del;
        int diag = c0 * del;
        // what the lane's last row hands on: D[i][c0 + kTile], its char
        int o = 0;
        uint32_t oc = 0u;
        // lane 0: the packed word after the current one and, past the
        // first strip, the edge value of its next row
        uint32_t word = 0u, next = 0u;
        int enext = 0;
        if (t == 0 && n > 0) {
            next = col[0];
            if (cs > 0) enext = eg[0];
        }
#pragma unroll 1
        for (int s = 1; s <= steps; ++s) {
            // lane t - 1's last row; a group's lane 0 replaces it
            int left = __shfl_up_sync(kFull, o, 1);
            uint32_t c = __shfl_up_sync(kFull, oc, 1);
            const int i = s - t;
            // a lane past la's (in the last strip) runs rows that no
            // lane reads: masking it would hold a predicate that ptxas
            // spills
            if (i >= 1 && i <= n) {
                if (t == 0) {
                    const int j = i - 1;
                    if ((j & 3) == 0) {
                        word = next;
                        if ((j | 3) + 1 < n)
                            next = col[(size_t)((j >> 2) + 1) * B];
                    }
                    c = (word >> (8 * (j & 3))) & 0xFFu;
                    if (cs == 0) {
                        left = i * ins;
                    } else {
                        left = enext;
                        if (i < n) enext = eg[i];
                    }
                }
                const uint32_t* const row = tile + c * kStripWords;
                int prev = left, dg = diag;
#pragma unroll
                for (int w = 0; w < kTileWords; ++w) {
                    const uint32_t pmw = row[w];
#pragma unroll
                    for (int u = 0; u < 32; ++u) {
                        const int p = 32 * w + u;
                        const int old = D[p];
                        prev = cell(old, dg, prev, (pmw >> u) & 1u, ins,
                                    del, sub);
                        D[p] = prev;
                        dg = old;
                    }
                }
                diag = left;
                o = prev;
                oc = c;
                if (edge_out) eg[i - 1] = prev;
            }
        }
        if (st + 1 == nstrip && real && t == tla) {
            // nothing stays live across the strips for this (ptxas spilled
            // a distance kept there)
            const int pla = (la - 1) % kTile;
            int dist = D[0];
#pragma unroll
            for (int p = 1; p < kTile; ++p) dist = (p == pla) ? D[p] : dist;
            out[b] = dist;
        }
    }
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, int la, int ins, int del, int sub,
                       const uint32_t* cand, const int32_t* lb, int32_t* out,
                       int64_t B, int64_t b0, int64_t nb, int lb4,
                       cudaStream_t stream) {
    const unsigned grid = (unsigned)((nb + kThreads - 1) / kThreads);
    wlev_scan_reg<W><<<grid, kThreads, 0, stream>>>(
        pm, la, ins, del, sub, cand, lb, out, B, b0, nb, lb4);
    return cudaGetLastError();
}

cudaError_t launch_tile(const uint32_t* pm, int la, int ins, int del,
                        int sub, const uint32_t* cand, const int32_t* lb,
                        int32_t* out, int32_t* edge, int64_t B, int64_t b0,
                        int64_t nb, int lb4, cudaStream_t stream) {
    if (la > kStrip && edge == nullptr) return cudaErrorInvalidValue;
    // a lane per tile of the query (its first strip), at most a warp
    const int G = min(32, (la + kTile - 1) / kTile);
    const int bytes = kStripWords * kRows * 4;
    cudaError_t err = cudaFuncSetAttribute(
        wlev_scan_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int64_t per = (kTileThreads / 32) * (32 / G);  // per block
    const unsigned grid = (unsigned)((nb + per - 1) / per);
    wlev_scan_tile<<<grid, kTileThreads, bytes, stream>>>(
        pm, la, G, ins, del, sub, cand, lb, out, edge, B, b0, nb, lb4);
    return cudaGetLastError();
}

}  // namespace

// Distances of the query (length la, PM table pm [W, 256]) to candidates
// [b0, b0 + nb) of the packed corpus cand [lb4, B], written to out[b].
// Queries over kStrip = 1,024 chars need the edge buffer edge: 4 * lb4
// int32 per candidate, [nb, 4 * lb4].
extern "C" cudaError_t rf_wlev_scan(const uint32_t* pm, int la, int ins,
                                    int del, int sub, const uint32_t* cand,
                                    const int32_t* lb, int32_t* out,
                                    int32_t* edge, int64_t B, int64_t b0,
                                    int64_t nb, int lb4,
                                    cudaStream_t stream) {
    if (la < 0 || b0 < 0 || nb < 0 || b0 + nb > B)
        return cudaErrorInvalidValue;
    if (nb == 0) return cudaSuccess;
    const int W = la > 0 ? (la + 31) / 32 : 1;
    static_assert(kMaxRegW == 4, "the switch below instantiates W <= 4");
    switch (W) {
        case 1: return launch_reg<1>(pm, la, ins, del, sub, cand, lb, out, B,
                                     b0, nb, lb4, stream);
        case 2: return launch_reg<2>(pm, la, ins, del, sub, cand, lb, out, B,
                                     b0, nb, lb4, stream);
        case 3: return launch_reg<3>(pm, la, ins, del, sub, cand, lb, out, B,
                                     b0, nb, lb4, stream);
        case 4: return launch_reg<4>(pm, la, ins, del, sub, cand, lb, out, B,
                                     b0, nb, lb4, stream);
        default:
            return launch_tile(pm, la, ins, del, sub, cand, lb, out, edge, B,
                               b0, nb, lb4, stream);
    }
}
