// K1: one-vs-many uniform Levenshtein (Myers/Hyyro bit-parallel), one
// query or NQ queries per launch, at any bucket and query length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/lev_kernel.py:_kernel,
// launched there by _run (one query) and _run_nq (multiq=True, 16
// queries), and rapidfuzz_tpu/ops/pallas/stream_kernel.py:_kernel (_run),
// which serves buckets over 1024 chars by streaming 512-char text chunks
// through a second grid axis with VP/VN carried in VMEM.  That chunking
// existed only because a candidate block of a long bucket did not fit
// VMEM; here a candidate's lanes walk its text from global memory
// whatever the bucket, so one kernel serves every length and the wrapper
// only counts launches at buckets > 1024 apart (lev_scan_long).
//
// What bounds it on an H100: integer throughput.  A step costs ~11 u32 ops
// per query word (chip_smoke.OPS) plus one shared-memory PM lookup; the
// corpus is read once per query (once per strip, below), 1 byte per char
// (4 chars per u32 load).  No form moves VP/VN through device memory.
//
// Two forms, both with the query's PM table in shared memory:
// * register form (W <= 8 words, template on W): one thread per
//   candidate holds all W words of VP/VN and adds each step's delta at
//   bit (la - 1) & 31 of word W - 1; the table [W, 256] u32, a lane's
//   lookup at row c;
// * tile form (W > 8): a lane holds L = 8 consecutive query words of
//   VP/VN in registers, and a candidate takes G = ceil(W / 8) lanes (at
//   most a strip's 16), 32 / G candidates a warp, its other 32 % G lanes
//   idle.  L = 8 ran fastest of 2, 4 and 8 at 10 and 126 words (a step's
//   own work, the hand-off and the char, weighs ~3 words a lane; fewer
//   lanes a candidate also idle fewer); it fits the 64-register cap.  In
//   Hyyro's block form only two bits cross a word edge, the horizontal
//   carries hp_c and hn_c, both from low words to high ones within one
//   text step, so lane t runs text char s - t at step s (a wavefront):
//   it takes (char, hp_c, hn_c) from lane t - 1's last step by one
//   __shfl_up_sync, runs its L words, and hands (char, carries out) on.
//   Only a group's lane 0 reads the packed
//   corpus (a word every 4 chars, loaded a word ahead) and starts the
//   carries at hp_c = 1, hn_c = 0.  A group runs its candidate's n steps
//   plus G - 1 of ramp, and a warp runs to its longest candidate: every
//   lane stays in the step loop (the shuffles need the whole warp) and
//   leaves its state as it is at chars outside [0, n).  No lane adds a
//   delta per step: at the end D[la][n] = n + sum of the final column's
//   vertical deltas, popc(VP) - popc(VN) over the query's la bits, summed
//   over the group's lanes by a warp prefix sum;
// * tile form's table: [256, Wp] u32 (char-major, Wp = G * 8 rounded up
//   to 32 words), so lane t's 8 words of char c are two 16-byte loads at
//   c * Wp + 8t, and the lanes of a group, holding consecutive tiles, hit
//   consecutive bank groups whatever their chars; blocks of 1,024
//   threads (__launch_bounds__(1024, 1): 64 registers a thread), so one
//   table serves the SM's 32 warps;
// * strips: queries over S = 128 words (4,096 chars; the table 128 KB)
//   go in strips of S words, each a pass over the text, the table
//   reloaded between them.  Per text row the strip's top lane packs its
//   carry-out (2 bits) into an edge buffer, 16 rows a u32
//   ([NQ, ceil(LB / 16), nb] u32, coalesced by candidate), and lane 0 of
//   the next strip reads them back a word ahead of its use; the buffer is
//   reused in place (a word is read before the top lane, G - 1 steps
//   behind lane 0, writes it again).  The wrapper launches over chunks of
//   candidates whose edge buffers fit its memory plan
//   (lev_kernel.SCRATCH_BYTES);
// * the corpus comes sorted by length, and block b works the candidates
//   of block nblocks - 1 - b, so the longest texts start first (both
//   forms);
// * the NQ form puts the query index on blockIdx.y, so all NQ queries
//   reuse the corpus lines the L2 already holds;
// * la == 0 gives lb (register form; a tile-form query has > 256 chars);
//   lb == 0 gives la;
// * every offset into the corpus, the output and the edge buffer is
//   64-bit (row * B): a 131072-char bucket of 65,536 candidates is 8 GiB
//   packed, past 2^31 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // the register form's block
constexpr int kTileThreads = 1024;  // the tile form's block: one an SM
constexpr int kRows = 256;          // PM entries: every byte value
constexpr int kMaxRegW = 8;         // register form up to this many words
constexpr int kTileWords = 8;       // query words a lane of the tile form
constexpr int kStripWords = 128;    // query words a strip holds
constexpr int kEdgeRows = 16;       // text rows per u32 of the edge buffer
constexpr unsigned kFull = 0xFFFFFFFFu;

// One Myers/Hyyro block step of one word: updates vp/vn, hands the
// horizontal carries (hp_c, hn_c) on to the next word, and returns the
// word's hp/hn for the last word's distance delta.
__device__ __forceinline__ void myers_word(uint32_t pmw, uint32_t& vp,
                                           uint32_t& vn, uint32_t& hp_c,
                                           uint32_t& hn_c, uint32_t& hp_o,
                                           uint32_t& hn_o) {
    const uint32_t x = pmw | hn_c;
    const uint32_t d0 = (((x & vp) + vp) ^ vp) | x | vn;
    const uint32_t hp = vn | ~(d0 | vp);
    const uint32_t hn = d0 & vp;
    hp_o = hp;
    hn_o = hn;
    const uint32_t hp_s = (hp << 1) | hp_c;
    const uint32_t hn_s = (hn << 1) | hn_c;
    vp = hn_s | ~(d0 | hp_s);
    vn = hp_s & d0;
    hp_c = hp >> 31;
    hn_c = hn >> 31;
}

template <int W>
__device__ __forceinline__ int step(const uint32_t* __restrict__ pm,
                                    uint32_t c, uint32_t* vp, uint32_t* vn,
                                    int last) {
    uint32_t hp_c = 1u, hn_c = 0u, hp = 0u, hn = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w)
        myers_word(pm[w * kRows + c], vp[w], vn[w], hp_c, hn_c, hp, hn);
    return (int)((hp >> last) & 1u) - (int)((hn >> last) & 1u);
}

// The register form over candidates [b0, b0 + nb).
template <int W>
__global__ void __launch_bounds__(kThreads)
lev_scan_reg(const uint32_t* __restrict__ pm_all,
             const int32_t* __restrict__ las,
             const uint32_t* __restrict__ cand,
             const int32_t* __restrict__ lb, int32_t* __restrict__ out,
             int64_t B, int64_t b0, int64_t nb, int lb4) {
    __shared__ uint32_t pm[W * kRows];
    const int q = blockIdx.y;
    const uint32_t* src = pm_all + (size_t)q * W * kRows;
    for (int i = threadIdx.x; i < W * kRows; i += kThreads) pm[i] = src[i];
    __syncthreads();

    // the longest texts (the corpus's last) start first
    const int64_t k =
        (int64_t)(gridDim.x - 1 - blockIdx.x) * kThreads + threadIdx.x;
    if (k >= nb) return;
    const int64_t b = b0 + k;
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    int32_t* dst = out + (size_t)q * B + b;
    if (la == 0) { *dst = lb[b]; return; }
    const int last = (la - 1) & 31;

    uint32_t vp[W], vn[W];
#pragma unroll
    for (int w = 0; w < W; ++w) { vp[w] = kFull; vn[w] = 0u; }
    int dist = la;
    const int rows = n >> 2;
    const uint32_t* col = cand + b;
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = col[(size_t)r * B];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            dist += step<W>(pm, (word >> (8 * u)) & 0xFFu, vp, vn, last);
    }
    const int rem = n & 3;
    if (rem) {
        const uint32_t word = col[(size_t)rows * B];
        for (int u = 0; u < rem; ++u)
            dist += step<W>(pm, (word >> (8 * u)) & 0xFFu, vp, vn, last);
    }
    *dst = dist;
}

// A lane's 8 PM words of one char: two 16-byte shared loads (p is
// aligned: Wp is a multiple of 32 and a lane starts at 8t).
__device__ __forceinline__ void load_tile(const uint32_t* p,
                                          uint32_t (&w)[kTileWords]) {
#pragma unroll
    for (int i = 0; i < kTileWords; i += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + i);
        w[i] = v.x;
        w[i + 1] = v.y;
        w[i + 2] = v.z;
        w[i + 3] = v.w;
    }
}

// The tile form over candidates [b0, b0 + nb) (the header's design): G
// lanes a candidate, 8 query words each, the table [256, Wp] in dynamic
// shared memory.  edge: [NQ, ceil(4 * lb4 / 16), nb] u32, read and
// written only when W > kStripWords.
__global__ void __launch_bounds__(kTileThreads, 1)
lev_scan_tile(const uint32_t* __restrict__ pm_all,
              const int32_t* __restrict__ las,
              const uint32_t* __restrict__ cand,
              const int32_t* __restrict__ lb, int32_t* __restrict__ out,
              uint32_t* __restrict__ edge, int64_t B, int64_t b0,
              int64_t nb, int lb4, int W, int G, int Wp) {
    constexpr int L = kTileWords, S = kStripWords;
    extern __shared__ uint4 smem[];
    uint32_t* const pm = reinterpret_cast<uint32_t*>(smem);
    const int q = blockIdx.y;
    const uint32_t* const pm_q = pm_all + (size_t)q * W * kRows;
    const int la = las[q];
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
    const int rows = (n + 3) >> 2;
    const int erows = (LB + kEdgeRows - 1) / kEdgeRows;
    uint32_t* const eg = edge != nullptr
        ? edge + (size_t)q * erows * nb + (real ? k : 0) : nullptr;
    const int nstrip = (W + S - 1) / S;
    const int full = la >> 5;                   // words wholly in the query
    int part = 0;   // the lane's share of the final column's deltas
    for (int st = 0; st < nstrip; ++st) {
        const int w0 = st * S;
        const int ws = min(S, W - w0);
        // the previous strip's table reads and edge stores are done
        if (st > 0) __syncthreads();
        for (int i = threadIdx.x; i < Wp * kRows; i += kTileThreads) {
            const int w = i >> 8, c = i & (kRows - 1);
            pm[c * Wp + w] = w < ws ? pm_q[(size_t)(w0 + w) * kRows + c]
                                    : 0u;
        }
        __syncthreads();
        const int glive = (ws + L - 1) / L;     // lanes with query words
        const int steps = nmax > 0 ? nmax + glive - 1 : 0;
        const bool edge_out = st + 1 < nstrip && t == G - 1;
        const uint32_t* const tile = pm + t * L;
        uint32_t vp[L], vn[L];
#pragma unroll
        for (int w = 0; w < L; ++w) {
            vp[w] = kFull;
            vn[w] = 0u;
        }
        // lane 0: the packed word after the current one and, past the
        // first strip, the edge word after the current one; the top lane:
        // the edge word it fills
        uint32_t word = 0u, next = 0u, ein = 0u, enext = 0u, eacc = 0u;
        // what the lane hands on: char | hp_c << 8 | hn_c << 9
        uint32_t o = 0u;
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
                    v = ((word >> (8 * (j & 3))) & 0xFFu) | (1u << 8);
                    if (st > 0) {
                        if ((j & (kEdgeRows - 1)) == 0) {
                            ein = enext;
                            if ((j + kEdgeRows) < n)
                                enext = eg[(size_t)(j / kEdgeRows + 1) * nb];
                        }
                        v = (v & 0xFFu)
                            | (((ein >> (2 * (j & (kEdgeRows - 1)))) & 3u)
                               << 8);
                    }
                }
                const uint32_t c = v & 0xFFu;
                uint32_t hp_c = (v >> 8) & 1u, hn_c = (v >> 9) & 1u;
                uint32_t pmw[L];
                load_tile(tile + c * Wp, pmw);
#pragma unroll
                for (int w = 0; w < L; ++w) {
                    uint32_t hp, hn;
                    myers_word(pmw[w], vp[w], vn[w], hp_c, hn_c, hp, hn);
                }
                o = c | (hp_c << 8) | (hn_c << 9);
                if (edge_out) {
                    const int r = j & (kEdgeRows - 1);
                    eacc |= (o >> 8) << (2 * r);
                    if (r == kEdgeRows - 1 || j == n - 1) {
                        eg[(size_t)(j / kEdgeRows) * nb] = eacc;
                        eacc = 0u;
                    }
                }
            }
        }
        // the query's bits among the lane's words: whole words below
        // la / 32, the low la % 32 bits of word la / 32, none past it
#pragma unroll
        for (int w = 0; w < L; ++w) {
            const int gw = w0 + t * L + w;
            const uint32_t m = gw < full ? kFull
                : (gw == full ? (1u << (la & 31)) - 1u : 0u);
            part += __popc(vp[w] & m) - __popc(vn[w] & m);
        }
    }
    // the group's sum: a warp prefix sum, less the lanes before the group
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, part, d);
        if (lane >= d) part += y;
    }
    const int hi = __shfl_sync(kFull, part, (grp * G + G - 1) & 31);
    const int lo = __shfl_sync(kFull, part, (grp * G + 31) & 31);
    if (real && t == 0) out[(size_t)q * B + b] = n + hi - (grp > 0 ? lo : 0);
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const int32_t* las,
                       const uint32_t* cand, const int32_t* lb,
                       int32_t* out, int64_t B, int64_t b0, int64_t nb,
                       int lb4, int nq, cudaStream_t stream) {
    const dim3 grid((unsigned)((nb + kThreads - 1) / kThreads), nq);
    lev_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                   B, b0, nb, lb4);
    return cudaGetLastError();
}

cudaError_t launch_tile(const uint32_t* pm, const int32_t* las,
                        const uint32_t* cand, const int32_t* lb,
                        int32_t* out, uint32_t* edge, int64_t B, int64_t b0,
                        int64_t nb, int lb4, int W, int nq,
                        cudaStream_t stream) {
    if (W > kStripWords && edge == nullptr) return cudaErrorInvalidValue;
    const int G = min((W + kTileWords - 1) / kTileWords,
                      kStripWords / kTileWords);
    const int Wp = (G * kTileWords + 31) / 32 * 32;
    const int bytes = Wp * kRows * 4;
    cudaError_t err = cudaFuncSetAttribute(
        lev_scan_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int64_t per = (kTileThreads / 32) * (32 / G);  // per block
    const dim3 grid((unsigned)((nb + per - 1) / per), nq);
    lev_scan_tile<<<grid, kTileThreads, bytes, stream>>>(
        pm, las, cand, lb, out, edge, B, b0, nb, lb4, W, G, Wp);
    return cudaGetLastError();
}

}  // namespace

// Distances of NQ queries (lengths las [NQ], PM tables pm [NQ, W, 256])
// to candidates [b0, b0 + nb) of the packed corpus cand [lb4, B], written
// to out[q * B + b].  W <= 8 takes the register form, past that the tile
// form; queries over 128 words need the edge buffer edge:
// [NQ, ceil(4 * lb4 / 16), nb] u32.
extern "C" cudaError_t rf_lev_scan(const uint32_t* pm, const int32_t* las,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, uint32_t* edge, int64_t B,
                                   int64_t b0, int64_t nb, int lb4, int W,
                                   int nq, cudaStream_t stream) {
    if (W < 1 || nq < 1 || b0 < 0 || nb < 0 || b0 + nb > B)
        return cudaErrorInvalidValue;
    if (nb == 0) return cudaSuccess;
    if (W <= kMaxRegW) switch (W) {
        case 1: return launch_reg<1>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 2: return launch_reg<2>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 3: return launch_reg<3>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 4: return launch_reg<4>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 5: return launch_reg<5>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 6: return launch_reg<6>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 7: return launch_reg<7>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 8: return launch_reg<8>(pm, las, cand, lb, out, B, b0, nb, lb4, nq, stream);
        default: break;
    }
    return launch_tile(pm, las, cand, lb, out, edge, B, b0, nb, lb4, W, nq,
                       stream);
}
