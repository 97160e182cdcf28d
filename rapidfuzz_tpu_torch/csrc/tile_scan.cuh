// The tile form shared by K4 (csrc/lcs_scan.cu) and K6 (csrc/osa_scan.cu):
// a candidate's query words in registers across a warp's lanes, the bits
// that cross a word edge handed on by shuffle in a wavefront.  K1's tile
// form (csrc/lev_scan.cu, lev_scan_tile) is the same design for its
// Myers word; this header runs any bit-parallel word whose only
// dependence between words is a few carry bits from low words to high
// ones within one text step.
//
// * A lane holds P::L consecutive query words of the recurrence's state
//   (P::State), and a candidate takes G = ceil(W / L) lanes (at most a
//   strip's S / L), 32 / G candidates a warp, its other 32 % G lanes idle.
// * Lane t runs text char s - t at step s: it takes (char, carry bits)
//   from lane t - 1's last step by one __shfl_up_sync, runs its L words
//   and hands (char, carries out) on.  Only a group's lane 0 reads the
//   packed corpus (a word every 4 chars, loaded a word ahead) and starts
//   the carries at P::kStart.  A group runs its candidate's n steps plus
//   G - 1 of ramp, and a warp runs to its longest candidate: every lane
//   stays in the step loop (the shuffles need the whole warp) and leaves
//   its state as it is at chars outside [0, n).
// * The table: [256, Wp + P::kPad] u32 in dynamic shared memory
//   (char-major, Wp = G * L rounded up to 32 words), so lane t's L words
//   of char c are L / 4 16-byte loads from row c: lane-major at L t, or
//   where P::kInterleave its k-th chunk at chunk k G + t, so that the
//   eight lanes a 16-byte load serves at once, a group's, hit eight
//   different bank groups (lane-major, lanes t and t + 2 hit the same
//   ones at L = 16, t and t + 4 at L = 8).  A pad of 4 words (P::kPad)
//   starts each row on another bank group, which spreads the loads of
//   groups on different chars (G < 8).  Where P::kPrev, the step also
//   reads the previous char's row, and a 257th row, all zero, stands for
//   the row before the first char.
//   Blocks of 1,024 threads (__launch_bounds__(1024, 1): 64 registers a
//   thread), so one table serves the SM's 32 warps.
// * Strips: queries over S = 128 words (4,096 chars; the table 128 KB)
//   go in strips of S words, each a pass over the text, the table
//   reloaded between them.  Per text row the strip's top lane packs its
//   carries out into a slot of P::kSlot bits of an edge buffer, 32 /
//   kSlot rows a u32 ([NQ, ceil(LB * kSlot / 32), nb] u32, coalesced by
//   candidate), and lane 0 of the next strip reads them back a word ahead
//   of its use; the buffer is reused in place (a word is read before the
//   top lane, G - 1 steps behind lane 0, writes it again).  The wrapper
//   launches over chunks of candidates whose edge buffers fit its memory
//   plan.
// * The corpus comes sorted by length, and block b works the candidates
//   of block nblocks - 1 - b, so the longest texts start first.
// * The NQ form puts the query index on blockIdx.y, so all NQ queries
//   reuse the corpus lines the L2 already holds.
// * The result: each lane's share of it (P::State::part), summed over the
//   group's lanes by a warp prefix sum, and finished with the text's
//   length (P::finish).
// * Every offset into the corpus, the output and the edge buffer is
//   64-bit (row * B).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tile {

constexpr int kThreads = 1024;     // a block: one an SM
constexpr int kRows = 256;         // PM entries: every byte value
constexpr int kStripWords = 128;   // query words a strip holds
constexpr unsigned kFull = 0xFFFFFFFFu;

// L PM words at p: L / 4 16-byte shared loads, `stride` words apart (p is
// aligned: rows are whole 16-byte chunks and a lane starts at one).
template <int L>
__device__ __forceinline__ void load_tile(const uint32_t* p, int stride,
                                          uint32_t (&w)[L]) {
    static_assert(L % 4 == 0, "a tile is whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < L; i += 4) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(p + (i / 4) * stride);
        w[i] = v.x;
        w[i + 1] = v.y;
        w[i + 2] = v.z;
        w[i + 3] = v.w;
    }
}

// The tile form over candidates [b0, b0 + nb) of the packed corpus cand
// [lb4, B]: G lanes a candidate, P::L query words each.  las (or null
// where P does not read the query's length): [NQ]; pm_all: [NQ, W, 256];
// edge: [NQ, ceil(4 * lb4 * kSlot / 32), nb] u32, read and written only
// when W > kStripWords.  The body of a kernel that each source declares
// under its own name (TILE_KERNEL), run in blocks of kThreads.
template <class P>
__device__ __forceinline__ void
scan_tile(const uint32_t* __restrict__ pm_all,
          const int32_t* __restrict__ las,
          const uint32_t* __restrict__ cand,
          const int32_t* __restrict__ lb, int32_t* __restrict__ out,
          uint32_t* __restrict__ edge, int64_t B, int64_t b0, int64_t nb,
          int lb4, int W, int G, int Wp) {
    constexpr int L = P::L, S = kStripWords;
    const int Rs = Wp + P::kPad;                // a table row's stride
    constexpr int kSlot = P::kSlot, kEdgeRows = 32 / kSlot;
    constexpr uint32_t kSlotMask = (1u << kSlot) - 1u;
    extern __shared__ uint4 smem[];
    uint32_t* const pm = reinterpret_cast<uint32_t*>(smem);
    const int q = blockIdx.y;
    const uint32_t* const pm_q = pm_all + (size_t)q * W * kRows;
    const int la = las != nullptr ? las[q] : 0;
    // a warp holds 32 / G groups; its lanes past them idle
    const int lane = threadIdx.x & 31;
    const int per = 32 / G;
    const int grp = lane / G;
    const int t = lane - grp * G;               // the lane's tile
    // the longest texts (the corpus's last) start first
    const int64_t k =
        ((int64_t)(gridDim.x - 1 - blockIdx.x) * (kThreads / 32)
         + threadIdx.x / 32) * per + grp;
    const bool real = grp < per && k < nb;
    const int64_t b = b0 + (real ? k : 0);
    const int LB = 4 * lb4;
    const int n = real ? min(lb[b], LB) : 0;
    const int nmax = __reduce_max_sync(kFull, n);
    const uint32_t* const col = cand + b;
    const int rows = (n + 3) >> 2;
    const int erows = (LB + kEdgeRows - 1) / kEdgeRows;
    uint32_t* const eg = edge != nullptr
        ? edge + (size_t)q * erows * nb + (real ? k : 0) : nullptr;
    const int nstrip = (W + S - 1) / S;
    int part = 0;   // the lane's share of the result
    for (int st = 0; st < nstrip; ++st) {
        const int w0 = st * S;
        const int ws = min(S, W - w0);
        // the previous strip's table reads and edge stores are done
        if (st > 0) __syncthreads();
        for (int i = threadIdx.x; i < Wp * kRows; i += kThreads) {
            const int w = i >> 8, c = i & (kRows - 1);
            if (P::kInterleave && w >= G * L) continue;   // never read
            // interleaved: lane t's chunk k (words 4k..4k+3 of its tile)
            // at chunk k G + t of the row
            const int at = P::kInterleave
                ? 4 * ((w % L) / 4 * G + w / L) + (w & 3) : w;
            pm[c * Rs + at] = w < ws ? pm_q[(size_t)(w0 + w) * kRows + c]
                                     : 0u;
        }
        if (P::kPrev)
            for (int i = threadIdx.x; i < Wp; i += kThreads)
                pm[kRows * Rs + i] = 0u;
        __syncthreads();
        const int glive = (ws + L - 1) / L;     // lanes with query words
        const int steps = nmax > 0 ? nmax + glive - 1 : 0;
        const bool edge_out = st + 1 < nstrip && t == G - 1;
        const uint32_t* const tile = pm + (P::kInterleave ? 4 * t : t * L);
        const int stride = P::kInterleave ? 4 * G : 4;  // between chunks
        typename P::State state;
        state.init();
        // lane 0: the packed word after the current one and, past the
        // first strip, the edge word after the current one; the top lane:
        // the edge word it fills
        uint32_t word = 0u, next = 0u, ein = 0u, enext = 0u, eacc = 0u;
        // what the lane hands on: char | carry bits << 8
        uint32_t o = 0u;
        // the previous char's row (kPrev): the zero row before the first
        uint32_t cp = kRows;
        if (t == 0 && n > 0) {
            next = col[0];
            if (st > 0) enext = eg[0];
        }
#pragma unroll 1
        for (int s = 0; s < steps; ++s) {
            // lane t - 1's last char; a group's lane 0 ignores it
            const uint32_t in = __shfl_up_sync(kFull, o, 1);
            const int j = s - t;
            if (j >= 0 && j < n) {
                uint32_t v = in;
                if (t == 0) {
                    if ((j & 3) == 0) {
                        word = next;
                        if ((j >> 2) + 1 < rows)
                            next = col[(size_t)((j >> 2) + 1) * B];
                    }
                    v = ((word >> (8 * (j & 3))) & 0xFFu) | (P::kStart << 8);
                    if (st > 0) {
                        if ((j & (kEdgeRows - 1)) == 0) {
                            ein = enext;
                            if (j + kEdgeRows < n)
                                enext = eg[(size_t)(j / kEdgeRows + 1) * nb];
                        }
                        v = (v & 0xFFu)
                            | (((ein >> (kSlot * (j & (kEdgeRows - 1))))
                                & kSlotMask) << 8);
                    }
                }
                const uint32_t c = v & 0xFFu;
                uint32_t bits = v >> 8;
                state.step(tile + c * Rs, tile + cp * Rs, stride, bits);
                if (P::kPrev) cp = c;
                o = c | (bits << 8);
                if (edge_out) {
                    const int r = j & (kEdgeRows - 1);
                    eacc |= bits << (kSlot * r);
                    if (r == kEdgeRows - 1 || j == n - 1) {
                        eg[(size_t)(j / kEdgeRows) * nb] = eacc;
                        eacc = 0u;
                    }
                }
            }
        }
        part += state.part(la, w0 + t * L);
    }
    // the group's sum: a warp prefix sum, less the lanes before the group
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, part, d);
        if (lane >= d) part += y;
    }
    const int hi = __shfl_sync(kFull, part, (grp * G + G - 1) & 31);
    const int lo = __shfl_sync(kFull, part, (grp * G + 31) & 31);
    if (real && t == 0)
        out[(size_t)q * B + b] = P::finish(n, hi - (grp > 0 ? lo : 0));
}

// Declares the __global__ kernel `name` that runs scan_tile<P>.
#define TILE_KERNEL(name, P)                                                \
    __global__ void __launch_bounds__(tile::kThreads, 1)                    \
    name(const uint32_t* __restrict__ pm_all,                               \
         const int32_t* __restrict__ las,                                   \
         const uint32_t* __restrict__ cand,                                 \
         const int32_t* __restrict__ lb, int32_t* __restrict__ out,         \
         uint32_t* __restrict__ edge, int64_t B, int64_t b0, int64_t nb,    \
         int lb4, int W, int G, int Wp) {                                   \
        tile::scan_tile<P>(pm_all, las, cand, lb, out, edge, B, b0, nb,    \
                           lb4, W, G, Wp);                                  \
    }

using TileKernel = void (*)(const uint32_t*, const int32_t*,
                            const uint32_t*, const int32_t*, int32_t*,
                            uint32_t*, int64_t, int64_t, int64_t, int, int,
                            int, int);

// Launches `kernel` (TILE_KERNEL(kernel, P)) for a query of W words (the
// header's plan).
template <class P>
cudaError_t launch_tile(TileKernel kernel, const uint32_t* pm,
                        const int32_t* las,
                        const uint32_t* cand, const int32_t* lb,
                        int32_t* out, uint32_t* edge, int64_t B, int64_t b0,
                        int64_t nb, int lb4, int W, int nq,
                        cudaStream_t stream) {
    if (W > kStripWords && edge == nullptr) return cudaErrorInvalidValue;
    const int G = min((W + P::L - 1) / P::L, kStripWords / P::L);
    const int Wp = (G * P::L + 31) / 32 * 32;
    const int bytes = (Wp + P::kPad) * (P::kPrev ? kRows + 1 : kRows) * 4;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int64_t per = (kThreads / 32) * (32 / G);  // per block
    const dim3 grid((unsigned)((nb + per - 1) / per), nq);
    kernel<<<grid, kThreads, bytes, stream>>>(pm, las, cand, lb, out, edge,
                                              B, b0, nb, lb4, W, G, Wp);
    return cudaGetLastError();
}

}  // namespace tile
