// K5: one-vs-many banded LCS under an indel cutoff, at any bucket length.
//
// Replaces two TPU kernels of rapidfuzz_tpu/ops/pallas/lcs_band_kernel.py:
// * _kernel (_run): the sliding 32*BW-bit band for BW in {1, 2, 3} u32
//   words (indel cutoffs up to 47), buckets <= 1024;
// * _stream_kernel (_run_stream): the same band over buckets of any
//   length, the text streamed in 512-char chunks with the register and the
//   accumulator carried in VMEM between grid steps.  Here a block walks
//   its texts in chunks of its own (below), so the wrapper launches the
//   same kernel at any LB (lcs_band_long).
//
// An indel cutoff k keeps every matched pair of an alignment of cost <= k
// within |i - j| <= k (indel.rs:80-104 -> lcs_seq.rs:267-341), so only a
// diagonal band of the Hyyro S row is needed.  The band register holds
// S in band coordinates: at text step j, bit 0 is pattern row
// j - 16*BW and bit 32*BW - 1 row j + 16*BW - 1.  Per step
// (lcs_band_kernel.py:73-111):
// * u = s & pm_window; s' = (s + u + carry) | (s ^ u) (u is a subset of
//   s, so s - u == s ^ u), the add's carry chained from low word to high;
// * bit 0 (pattern row j - 16*BW) leaves the band and is frozen: a zero
//   there is one more LCS match, acc += 1 - (s' & 1);
// * the register slides one pattern row: shifted right one bit across
//   words, a 1 entering at bit 32*BW - 1 (a row the band has not reached
//   holds "no match yet").
// The result is acc + popcount(~s) over the band words: the exact LCS for
// a candidate whose indel distance is <= 16*BW - 1, and an underestimate
// (so an indel overestimate) for the others, bit for bit the TPU kernel's.
//
// The exact stop.  A thread walks n = min(lb, la + 16*BW) steps of its
// text, la the query's length; the TPU kernel runs the whole bucket (or
// the block's longest row).  Past a candidate's length no char matches,
// and from step la + 16*BW on every row of the window, j - 16*BW and up,
// is at least la, so its PM word is zero whatever the char: then x = u =
// 0, the add is s + 0 with no carry, so s' = s, and the slide moves bit 0
// into acc and a 1 in at the top bit, which leaves acc + popcount(~s)
// unchanged.  So every step past n changes nothing, for candidates in and
// out of band alike.  Past the text's own length that needs the padding
// never to match, which the scanner guarantees by refusing the band in
// byte mode for a query holding NUL (the pad byte), as the JAX scanner
// does; this kernel never reads padding at all.
//
// What bounds it on an H100: integer issue over the min(lb, la + 16*BW)
// steps of every text.  At one band word a step is 4 INT32-lane
// instructions of the band word (the window's funnel shift, and, the or
// with s ^ u, the slide's funnel shift; the add issues on the FMA lanes),
// 1.5 of the accumulator, and the char's byte, two shared loads and the
// address beside them; the corpus loads, 8 words ahead, cost 5-6 % of the
// time (all in the SASS and the probe's figures of PERF.md section 6).
//
// Design, as K3 (csrc/lev_band.cu), whose band has the same geometry (bit
// 0 at pattern row j + off, off = -16*BW here):
// * one thread per candidate over the [LB/4, B] packed corpus; the BW + 1
//   PM words around the window are read from the query's [W, 256] table
//   (the K1/K4 table) and joined with __funnelshift_r (the TPU read
//   per-step windows pre-shifted on the host, build_shifted_tables);
// * the PM ring (band_ring.cuh): a block walks its texts in chunks of
//   kChunk steps, every thread at the same step index, and reads PM only
//   from a shared-memory slot that one bulk copy a chunk filled while the
//   chunk before ran, rows outside [0, ws) zeroed; so at any query length
//   and bucket no step reads the table from device memory or tests a
//   row's range;
// * a packed word's four steps j = 4r .. 4r + 3 share their window's first
//   row and shift base: j - 16*BW is a multiple of 4, so its offset in the
//   row is at most 28 and adding u <= 3 stays in it; both are computed
//   once a word;
// * corpus words ahead: each thread holds its next kAhead packed words in
//   registers (band_ring.cuh's walk_words), 8 where K3 holds 4 (7 % faster
//   at both timed shapes);
// * longest first: block i takes the candidates of block nblocks - 1 - i,
//   the longest as the scanner sorts by length; the wrapper passes the
//   block size, as large as keeps two blocks an SM
//   (band_kernel.fill_threads: 256 threads at both timed shapes, where 64,
//   K3's over long buckets, took 11-15 % longer).
// Corpus offsets are 64-bit (row * B).

#include <cstdint>
#include <cuda_runtime.h>

#include "band_ring.cuh"

namespace {

using namespace band_ring;

constexpr int kMaxThreads = 256;
constexpr int kAhead = 8;         // packed corpus words a thread holds ahead

template <int BW>
struct Lcs {
    uint32_t s[BW];
    int acc;
};

// One text step of the band recurrence: `row` is the char's entry in the
// first of the window's BW + 1 ring rows, sh the window's shift in it.
template <int BW>
__device__ __forceinline__ void lcs_step(const uint32_t* row, unsigned sh,
                                         Lcs<BW>& st) {
    uint32_t pw[BW + 1];
#pragma unroll
    for (int i = 0; i <= BW; ++i) pw[i] = row[i * kRows];
    uint32_t ns[BW];
    uint32_t carry = 0u;
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        const uint32_t x = __funnelshift_r(pw[k], pw[k + 1], sh);
        const uint32_t u = st.s[k] & x;
        const uint64_t t = (uint64_t)st.s[k] + u + carry;
        carry = (uint32_t)(t >> 32);
        ns[k] = (uint32_t)t | (st.s[k] ^ u);
    }
    st.acc += (int)(~ns[0] & 1u);
#pragma unroll
    for (int k = 0; k < BW; ++k)
        st.s[k] = __funnelshift_r(ns[k], k + 1 < BW ? ns[k + 1] : 1u, 1);
}

// The steps of one packed word (walk_words's step) over the chunk's ring
// slot, which holds table rows wb..: the word's steps j .. j + 3 read rows
// from (j - 16*BW) >> 5 at shift ((j - 16*BW) & 31) + u.
template <int BW>
struct WordSteps {
    const uint32_t* ring;
    int wb;
    Lcs<BW>& st;

    __device__ __forceinline__ void full(uint32_t word, int j) {
        const int start0 = j - 16 * BW;
        const uint32_t* row = ring + ((start0 >> 5) - wb) * kRows;
        const unsigned sh = (unsigned)(start0 & 31);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            lcs_step<BW>(row + __byte_perm(word, 0u, 0x4440u + u), sh + u,
                         st);
    }
    __device__ __forceinline__ void part(uint32_t word, int j, int m) {
        const int start0 = j - 16 * BW;
        const uint32_t* row = ring + ((start0 >> 5) - wb) * kRows;
        const unsigned sh = (unsigned)(start0 & 31);
        for (int u = 0; u < m; ++u)
            lcs_step<BW>(row + __byte_perm(word, 0u, 0x4440u + u), sh + u,
                         st);
    }
};

template <int BW>
__global__ void __launch_bounds__(kMaxThreads)
lcs_band_kernel(const uint32_t* __restrict__ pm, int ws, int la,
                const uint32_t* __restrict__ cand,
                const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                int64_t B, int lb4, int R) {
    extern __shared__ uint4 ring4[];
    uint32_t* ring = reinterpret_cast<uint32_t*>(ring4);
    __shared__ Ring rs;
    const int64_t blk = (int64_t)gridDim.x - 1 - blockIdx.x;  // longest first
    const int64_t b = blk * blockDim.x + threadIdx.x;
    // the walk: the text up to the exact stop
    const int n = b < B ? min(min(lb[b], la + 16 * BW), 4 * lb4) : 0;
    const uint32_t* col = cand + (b < B ? b : 0);
    uint32_t nxt[kAhead];
    words_ahead(col, B, n, nxt);
    ring_setup(rs);
    __syncthreads();
    ring_vote(rs, n);

    Lcs<BW> st;
#pragma unroll
    for (int k = 0; k < BW; ++k) st.s[k] = 0xFFFFFFFFu;
    st.acc = 0;

    __syncthreads();
    ring_walk(rs, ring, pm, ws, -16 * BW, R, rs.nmax,
              [&](const uint32_t* cur, int wb, int j0, int jend) {
        WordSteps<BW> step{cur, wb, st};
        walk_words(j0, jend, n, col, B, nxt, step);
    });
    if (b >= B) return;
#pragma unroll
    for (int k = 0; k < BW; ++k) st.acc += __popc(~st.s[k]);
    out[b] = st.acc;
}

template <int BW>
cudaError_t launch_band(const uint32_t* pm, int ws, int la,
                        const uint32_t* cand, const int32_t* lb, int32_t* out,
                        int64_t B, int lb4, int threads,
                        cudaStream_t stream) {
    // no block walks past the bucket or the exact stop
    const int walk = min(4 * lb4, la + 16 * BW);
    const int R = ring_rows(BW, 16 * BW - 1, walk);
    const int64_t blocks = (B + threads - 1) / threads;
    lcs_band_kernel<BW><<<(unsigned)blocks, threads, ring_bytes(R, walk),
                          stream>>>(pm, ws, la, cand, lb, out, B, lb4, R);
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lcs_band(const uint32_t* pm, int ws, int la, int bw,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, int64_t B, int lb4,
                                   int threads, cudaStream_t stream) {
    // the bulk copy takes 16-byte aligned rows
    if (ws < 1 || la < 0 || lb4 < 0 || threads < 32
        || threads > kMaxThreads || threads % 32
        || (reinterpret_cast<uintptr_t>(pm) & 15))
        return cudaErrorInvalidValue;
    switch (bw) {
        case 1: return launch_band<1>(pm, ws, la, cand, lb, out, B, lb4, threads, stream);
        case 2: return launch_band<2>(pm, ws, la, cand, lb, out, B, lb4, threads, stream);
        case 3: return launch_band<3>(pm, ws, la, cand, lb, out, B, lb4, threads, stream);
        default: return cudaErrorInvalidValue;
    }
}
