// K4: one-vs-many LCS length (Hyyro bit-parallel), one query or NQ
// queries per launch, at any bucket length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/lcs_kernel.py:_kernel,
// launched there by _run (one query, buckets <= 1024) and _run_nq
// (multiq=True, 16 queries), and stream_kernel.py:_lcs_kernel (_lcs_run),
// which serves buckets over 1024 chars by streaming 512-char text chunks
// through a second grid axis with S carried in VMEM.  As for K1, that
// chunking existed only because a candidate block of a long bucket did not
// fit VMEM: a thread (a group of lanes in the tile form) here walks its
// own candidate's text from global memory at any length, so one kernel
// serves every bucket and the wrapper counts launches over 1024-char
// buckets apart (lcs_scan_long).
//
// The recurrence (lcs_kernel.py:50-63, the reference's lcs_seq.rs:225-235):
// per query word w and text char c, u = S[w] & PM[c][w] and
// S[w] = (S[w] + u + carry) | (S[w] - u), the add's carry chained from the
// low word to the high word and dropped after the last.  S starts all
// ones; the LCS length is the count of zero bits.  Bits above the query's
// length stay 1 (PM rows are zero there and u is a subset of S, so S - u
// never borrows), so the kernel never reads the query length.  An empty
// query has an all-zero PM table and gives 0.
//
// What bounds it on an H100: integer throughput.  A step costs ~4 u32 ops
// per query word (u = s & pm, the 3-input add s + u + carry, its
// carry-out, one 3-input logic op for t | (s & ~u)) plus one shared-memory
// PM lookup, about a third of K1's Myers word; the corpus is read once per
// query, 1 byte per char, far on the compute side of the card's balance
// point.
//
// Design, as K1 (csrc/lev_scan.cu):
// * the packed corpus keeps the JAX layout [LB/4, B] u32, a coalesced load
//   of 4 chars per 4 text steps; the query's PM table sits in shared
//   memory; the NQ form puts the query index on blockIdx.y so the queries
//   share the corpus lines the L2 holds;
// * register form (W <= kMaxRegW, template on W): one thread per
//   candidate holds all W words of S; the table [W, 256] u32;
// * tile form (W > kMaxRegW; csrc/tile_scan.cuh, the design K1's
//   lev_scan_tile follows): a lane holds kTileWords consecutive query
//   words of S in registers and a candidate takes ceil(W / kTileWords)
//   lanes in a wavefront.  One bit crosses a word edge, the add's carry,
//   from low words to high ones within a text step: lane t takes it with
//   the char from lane t - 1 by shuffle, lane 0 starts it at 0.  A K4
//   word costs about a third of K1's, so the step's own work (the
//   shuffle, the char, the table's loads) weighs three times as much per
//   word, and a lane holds twice K1's words.  Bits above the query's
//   length stay 1 (above), in the padded words past W too (their PM rows
//   are zero, so S + 0 + carry | S is S), so the LCS length is the sum of
//   popc(~S) over every lane's words with no mask;
// * strips: queries over 128 words go in strips of 128, the strip's top
//   lane packing its carry, 1 bit a text row, 32 rows a u32, into an edge
//   buffer ([NQ, ceil(LB / 32), nb] u32), which lane 0 of the next strip
//   reads back, the buffer reused in place; the wrapper launches over
//   chunks of candidates whose edge buffers fit its memory plan
//   (lev_kernel.SCRATCH_BYTES); no form keeps state in device memory per
//   step;
// * the corpus comes sorted by length, and block b works the candidates
//   of block nblocks - 1 - b, so the longest texts start first (both
//   forms);
// * each candidate runs exactly its lb steps (the TPU masked j < lb
//   because lanes share control flow);
// * the carry is taken from a 64-bit add: s + u + carry < 2^33;
// * every offset into the corpus, the output and the edge buffer is
//   64-bit (row * B); only per-candidate lengths and the row count lb4 are
//   32-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

constexpr int kThreads = 256;  // the register form's block
constexpr int kRows = 256;     // PM entries: every byte value
constexpr int kMaxRegW = 16;    // register form up to this many words
constexpr int kTileWords = 16;  // query words a tile lane holds
constexpr unsigned kFull = 0xFFFFFFFFu;

// One Hyyro LCS step of one word; hands the add's carry to the next word.
__device__ __forceinline__ uint32_t lcs_word(uint32_t pmw, uint32_t s,
                                             uint32_t& carry) {
    const uint32_t u = s & pmw;
    const uint64_t t = (uint64_t)s + u + carry;
    carry = (uint32_t)(t >> 32);
    return (uint32_t)t | (s - u);
}

template <int W>
__device__ __forceinline__ void step(const uint32_t* __restrict__ pm,
                                     uint32_t c, uint32_t* s) {
    uint32_t carry = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w)
        s[w] = lcs_word(pm[w * kRows + c], s[w], carry);
}

// The register form over candidates [b0, b0 + nb).
template <int W>
__global__ void __launch_bounds__(kThreads)
lcs_scan_reg(const uint32_t* __restrict__ pm_all,
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
    const int n = min(lb[b], 4 * lb4);
    uint32_t s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = kFull;
    const int rows = n >> 2;
    const uint32_t* col = cand + b;
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = col[(size_t)r * B];
#pragma unroll
        for (int u = 0; u < 4; ++u) step<W>(pm, (word >> (8 * u)) & 0xFFu, s);
    }
    const int rem = n & 3;
    if (rem) {
        const uint32_t word = col[(size_t)rows * B];
        for (int u = 0; u < rem; ++u)
            step<W>(pm, (word >> (8 * u)) & 0xFFu, s);
    }
    int sim = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) sim += __popc(~s[w]);
    out[(size_t)q * B + b] = sim;
}

// The tile form's word recurrence (csrc/tile_scan.cuh): a lane's
// kTileWords words of S; the carry bit handed on is the add's.  Its word
// is cheap, so the table's loads weigh: the table is interleaved (a
// group's lanes read consecutive 16-byte chunks, where lane-major lanes t
// and t + 2 hit the same banks) and its rows padded by a chunk (so the
// lanes of groups on other chars spread over the banks).
struct LcsTile {
    static constexpr int L = kTileWords;
    static constexpr int kSlot = 1;
    static constexpr uint32_t kStart = 0u;     // no carry into word 0
    static constexpr bool kPrev = false;
    static constexpr bool kInterleave = true;
    static constexpr int kPad = 4;

    struct State {
        uint32_t s[L];

        __device__ __forceinline__ void init() {
#pragma unroll
            for (int w = 0; w < L; ++w) s[w] = kFull;
        }

        __device__ __forceinline__ void step(const uint32_t* row,
                                             const uint32_t*, int stride,
                                             uint32_t& bits) {
            uint32_t pmw[L];
            tile::load_tile<L>(row, stride, pmw);
#pragma unroll
            for (int w = 0; w < L; ++w) s[w] = lcs_word(pmw[w], s[w], bits);
        }

        // the lane's share of the LCS length: its zero bits (none past
        // the query's length)
        __device__ __forceinline__ int part(int, int) const {
            int sum = 0;
#pragma unroll
            for (int w = 0; w < L; ++w) sum += __popc(~s[w]);
            return sum;
        }
    };

    static __device__ __forceinline__ int finish(int, int sum) {
        return sum;
    }
};

TILE_KERNEL(lcs_scan_tile, LcsTile)

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const uint32_t* cand,
                       const int32_t* lb, int32_t* out, int64_t B,
                       int64_t b0, int64_t nb, int lb4, int nq,
                       cudaStream_t stream) {
    const dim3 grid((unsigned)((nb + kThreads - 1) / kThreads), nq);
    lcs_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, cand, lb, out, B, b0,
                                                   nb, lb4);
    return cudaGetLastError();
}

}  // namespace

// LCS lengths of NQ queries (PM tables pm [NQ, W, 256]) to candidates
// [b0, b0 + nb) of the packed corpus cand [lb4, B], written to
// out[q * B + b].  W <= kMaxRegW takes the register form, past that the
// tile form; queries over 128 words need the edge buffer edge:
// [NQ, ceil(4 * lb4 / 32), nb] u32.
extern "C" cudaError_t rf_lcs_scan(const uint32_t* pm, const uint32_t* cand,
                                   const int32_t* lb, int32_t* out,
                                   uint32_t* edge, int64_t B, int64_t b0,
                                   int64_t nb, int lb4, int W, int nq,
                                   cudaStream_t stream) {
    if (W < 1 || nq < 1 || b0 < 0 || nb < 0 || b0 + nb > B)
        return cudaErrorInvalidValue;
    if (nb == 0) return cudaSuccess;
    static_assert(kMaxRegW == 16, "the switch below instantiates W <= 16");
    if (W <= kMaxRegW) switch (W) {
        case 1: return launch_reg<1>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 2: return launch_reg<2>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 3: return launch_reg<3>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 4: return launch_reg<4>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 5: return launch_reg<5>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 6: return launch_reg<6>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 7: return launch_reg<7>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 8: return launch_reg<8>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 9: return launch_reg<9>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 10: return launch_reg<10>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 11: return launch_reg<11>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 12: return launch_reg<12>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 13: return launch_reg<13>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 14: return launch_reg<14>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 15: return launch_reg<15>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        case 16: return launch_reg<16>(pm, cand, lb, out, B, b0, nb, lb4, nq, stream);
        default: break;
    }
    return tile::launch_tile<LcsTile>(lcs_scan_tile, pm, nullptr, cand, lb, out,
                                      edge, B, b0, nb, lb4, W, nq, stream);
}
