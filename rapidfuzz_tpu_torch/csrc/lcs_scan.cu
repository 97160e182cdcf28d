// K4: one-vs-many LCS length (Hyyro bit-parallel), one query or NQ
// queries per launch, at any bucket length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/lcs_kernel.py:_kernel,
// launched there by _run (one query, buckets <= 1024) and _run_nq
// (multiq=True, 16 queries), and stream_kernel.py:_lcs_kernel (_lcs_run),
// which serves buckets over 1024 chars by streaming 512-char text chunks
// through a second grid axis with S carried in VMEM.  As for K1, that
// chunking existed only because a candidate block of a long bucket did not
// fit VMEM: a thread here walks its own candidate's text from global
// memory at any length, so one kernel serves every bucket and the wrapper
// counts launches over 1024-char buckets apart (lcs_scan_long).
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
// What bounds it on an H100: integer throughput.  A step costs ~5 u32 ops per
// query word (and, the 3-input add with its carry-in, the carry-out, one
// 3-input logic op for (t | (s & ~u))) plus one shared-memory PM lookup,
// about half of K1's Myers word; the corpus is read once per query, 1 byte
// per char, far on the compute side of the card's balance point.
//
// Design, as K1 (csrc/lev_scan.cu):
// * one thread per candidate, candidates along blockIdx.x; the NQ form
//   puts the query index on blockIdx.y so the queries share the corpus
//   lines the L2 holds;
// * the packed corpus keeps the JAX layout [LB/4, B] u32, a coalesced load
//   of 4 chars per text step group;
// * the query's PM table ([W, 256] u32) sits in shared memory;
// * S lives in registers for W <= kMaxRegW (template on W).  The state is
//   half of K1's (S only, no VP/VN pair), so the register form reaches
//   twice as far; longer queries keep S in a [NQ, W, B] scratch read and
//   written coalesced by candidate, with PM read through the read-only
//   cache, so no query length is refused;
// * each thread runs exactly its candidate's lb steps (the TPU masked
//   j < lb because lanes share control flow);
// * the carry is taken from a 64-bit add: s + u + carry < 2^33;
// * every offset into the corpus, the output and the scratch is 64-bit
//   (row * B); only per-candidate lengths and the row count lb4 are
//   32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;    // PM entries: every byte value
constexpr int kMaxRegW = 16;  // S in registers up to this many words

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

template <int W>
__global__ void __launch_bounds__(kThreads)
lcs_scan_reg(const uint32_t* __restrict__ pm_all,
             const uint32_t* __restrict__ cand,
             const int32_t* __restrict__ lb, int32_t* __restrict__ out,
             int64_t B, int lb4) {
    __shared__ uint32_t pm[W * kRows];
    const int q = blockIdx.y;
    const uint32_t* src = pm_all + (size_t)q * W * kRows;
    for (int i = threadIdx.x; i < W * kRows; i += kThreads) pm[i] = src[i];
    __syncthreads();

    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const int n = min(lb[b], 4 * lb4);
    uint32_t s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = 0xFFFFFFFFu;
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

__global__ void __launch_bounds__(kThreads)
lcs_scan_generic(const uint32_t* __restrict__ pm_all,
                 const uint32_t* __restrict__ cand,
                 const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                 uint32_t* __restrict__ scratch, int64_t B, int lb4, int W) {
    const int q = blockIdx.y;
    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const uint32_t* pm = pm_all + (size_t)q * W * kRows;
    const int n = min(lb[b], 4 * lb4);
    // S rows [0, W) of this query's scratch block
    uint32_t* st = scratch + (size_t)q * W * B + b;
    for (int w = 0; w < W; ++w) st[(size_t)w * B] = 0xFFFFFFFFu;
    const uint32_t* col = cand + b;
    uint32_t word = 0u;
    for (int j = 0; j < n; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
        uint32_t carry = 0u;
        for (int w = 0; w < W; ++w)
            st[(size_t)w * B] = lcs_word(__ldg(pm + w * kRows + c),
                                         st[(size_t)w * B], carry);
    }
    int sim = 0;
    for (int w = 0; w < W; ++w) sim += __popc(~st[(size_t)w * B]);
    out[(size_t)q * B + b] = sim;
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const uint32_t* cand,
                       const int32_t* lb, int32_t* out, int64_t B, int lb4,
                       int nq, cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), nq);
    lcs_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, cand, lb, out, B,
                                                   lb4);
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lcs_scan(const uint32_t* pm, const uint32_t* cand,
                                   const int32_t* lb, int32_t* out,
                                   uint32_t* scratch, int64_t B, int lb4,
                                   int W, int nq, cudaStream_t stream) {
    switch (W) {
        case 1: return launch_reg<1>(pm, cand, lb, out, B, lb4, nq, stream);
        case 2: return launch_reg<2>(pm, cand, lb, out, B, lb4, nq, stream);
        case 3: return launch_reg<3>(pm, cand, lb, out, B, lb4, nq, stream);
        case 4: return launch_reg<4>(pm, cand, lb, out, B, lb4, nq, stream);
        case 5: return launch_reg<5>(pm, cand, lb, out, B, lb4, nq, stream);
        case 6: return launch_reg<6>(pm, cand, lb, out, B, lb4, nq, stream);
        case 7: return launch_reg<7>(pm, cand, lb, out, B, lb4, nq, stream);
        case 8: return launch_reg<8>(pm, cand, lb, out, B, lb4, nq, stream);
        case 9: return launch_reg<9>(pm, cand, lb, out, B, lb4, nq, stream);
        case 10: return launch_reg<10>(pm, cand, lb, out, B, lb4, nq, stream);
        case 11: return launch_reg<11>(pm, cand, lb, out, B, lb4, nq, stream);
        case 12: return launch_reg<12>(pm, cand, lb, out, B, lb4, nq, stream);
        case 13: return launch_reg<13>(pm, cand, lb, out, B, lb4, nq, stream);
        case 14: return launch_reg<14>(pm, cand, lb, out, B, lb4, nq, stream);
        case 15: return launch_reg<15>(pm, cand, lb, out, B, lb4, nq, stream);
        case 16: return launch_reg<16>(pm, cand, lb, out, B, lb4, nq, stream);
        default: break;
    }
    static_assert(kMaxRegW == 16, "the switch above instantiates W <= 16");
    if (W < 1 || scratch == nullptr) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), nq);
    lcs_scan_generic<<<grid, kThreads, 0, stream>>>(pm, cand, lb, out,
                                                    scratch, B, lb4, W);
    return cudaGetLastError();
}
