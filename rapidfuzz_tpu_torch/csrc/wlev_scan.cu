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
// (WLEV_STREAM_MAX_LA).  Both limits were VMEM limits: a thread here walks
// its own candidate's text from global memory at any length and keeps its
// row in registers or in a device scratch of any length, so one kernel
// serves every bucket and every query, and the wrapper counts launches
// over 1024-char buckets apart (wlev_scan_long).
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
// add with its min, and the compiler tests 8 PM bits per R2P and selects
// the cost with predicated IMADs, so a cell issues ~3 instructions on the
// INT32 lanes (2 x VIADDMNMX, and parts of a SEL, an ISETP and an R2P)
// and ~2 IMADs on the FMA lanes, and its dependent chain through the left
// neighbour is one instruction.  The scratch form adds a 4-byte load and
// a 4-byte store per cell, and those bytes bound it instead (a register
// tile of query positions passing a boundary column is the later
// design).
//
// Design:
// * one thread per candidate, candidates along blockIdx.x, over the
//   chunk [b0, b0 + nb) of the corpus, so the wrapper can bound the
//   scratch by launching over chunks of candidates;
// * the packed corpus keeps the JAX layout [LB/4, B] u32, a coalesced
//   load of 4 chars per 4 text steps;
// * each thread walks exactly its candidate's lb steps, and positions
//   past la only to the end of la's word in the register form (a cell
//   never reads a later position), so the TPU's masked select of D[la]
//   over the whole LA is not needed;
// * register form (la <= 128): the query's PM table ([W, 256] u32) sits
//   in shared memory and the row in registers (80-178 registers, no
//   spills), the position loop unrolled over a compile-time LA = 32*W
//   (template on W = 1..4) and stopped after the word holding position la
//   by a uniform branch per word; D[la] is read by a select chain,
//   as a register array takes compile-time indices only.  The text loop
//   holds one copy of the step (not one per char of a packed word), so
//   the unrolled row stays small in the instruction cache, and loads the
//   next packed word while the current one's 4 steps run;
// * scratch form (la > 128): the row D[1..la] lives in a [la, nb] int32
//   scratch, coalesced by candidate, D[0] and the running diagonal and
//   left neighbour in registers; each whole word of 32 positions is
//   loaded into registers before its cells run and stored after, so a
//   thread keeps 32 loads in flight; the PM table in shared memory up to
//   48 KB (W <= 48), through the read-only cache past that;
// * la == 0 gives lb*ins, lb == 0 gives la*del;
// * every offset into the corpus, the output and the scratch is 64-bit
//   (row * B, position * nb); only per-candidate lengths, the row count
//   lb4 and the query length are 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;     // PM entries: every byte value
constexpr int kMaxRegW = 4;    // row in registers up to 32*kMaxRegW chars
constexpr int kMaxSmemW = 48;  // PM table in shared memory up to 48 KB

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

    const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
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

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
wlev_scan_scratch(const uint32_t* __restrict__ pm_g, int la, int ins,
                  int del, int sub, const uint32_t* __restrict__ cand,
                  const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                  int32_t* __restrict__ scratch, int64_t B, int64_t b0,
                  int64_t nb, int lb4) {
    extern __shared__ uint32_t pm_s[];
    const int W = (la + 31) >> 5;
    if (kSmem) {
        for (int i = threadIdx.x; i < W * kRows; i += kThreads)
            pm_s[i] = pm_g[i];
        __syncthreads();
    }
    const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (k >= nb) return;
    const int64_t b = b0 + k;
    const int n = min(lb[b], 4 * lb4);
    // D[p] (p = 1..la) at row p - 1 of this chunk's scratch
    int32_t* row = scratch + k;
    for (int p = 1; p <= la; ++p) row[(size_t)(p - 1) * nb] = p * del;
    int d0 = 0, dist = la * del;
    const uint32_t* col = cand + b;
    uint32_t word = 0u;
    for (int j = 0; j < n; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
        int diag = d0;
        d0 += ins;
        int prev = d0;
        for (int w = 0; w < W; ++w) {
            const uint32_t pmw = kSmem ? pm_s[w * kRows + c]
                                       : __ldg(pm_g + w * kRows + c);
            int32_t* sp = row + (size_t)(32 * w) * nb;
            const int m = la - 32 * w;
            if (m >= 32) {
                // a whole word: 32 loads in flight, then the cells, then
                // 32 stores
                int v[32];
#pragma unroll
                for (int i = 0; i < 32; ++i) v[i] = sp[(size_t)i * nb];
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int old = v[i];
                    prev = cell(old, diag, prev, (pmw >> i) & 1u, ins, del,
                                sub);
                    v[i] = prev;
                    diag = old;
                }
#pragma unroll
                for (int i = 0; i < 32; ++i) sp[(size_t)i * nb] = v[i];
            } else {
                for (int i = 0; i < m; ++i, sp += nb) {
                    const int old = *sp;
                    prev = cell(old, diag, prev, (pmw >> i) & 1u, ins, del,
                                sub);
                    *sp = prev;
                    diag = old;
                }
            }
        }
        dist = prev;
    }
    out[b] = dist;
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

}  // namespace

// Distances of the query (length la, PM table pm [W, 256]) to candidates
// [b0, b0 + nb) of the packed corpus cand [lb4, B], written to out[b].
// Queries over 32 * kMaxRegW chars need scratch: nb * la int32.
extern "C" cudaError_t rf_wlev_scan(const uint32_t* pm, int la, int ins,
                                    int del, int sub, const uint32_t* cand,
                                    const int32_t* lb, int32_t* out,
                                    int32_t* scratch, int64_t B, int64_t b0,
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
        default: break;
    }
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((nb + kThreads - 1) / kThreads);
    if (W <= kMaxSmemW) {
        wlev_scan_scratch<true><<<grid, kThreads, W * kRows * 4, stream>>>(
            pm, la, ins, del, sub, cand, lb, out, scratch, B, b0, nb, lb4);
    } else {
        wlev_scan_scratch<false><<<grid, kThreads, 0, stream>>>(
            pm, la, ins, del, sub, cand, lb, out, scratch, B, b0, nb, lb4);
    }
    return cudaGetLastError();
}
