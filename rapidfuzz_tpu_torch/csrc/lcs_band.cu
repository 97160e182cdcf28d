// K5: one-vs-many banded LCS under an indel cutoff, at any bucket length.
//
// Replaces two TPU kernels of rapidfuzz_tpu/ops/pallas/lcs_band_kernel.py:
// * _kernel (_run): the sliding 32*BW-bit band for BW in {1, 2, 3} u32
//   words (indel cutoffs up to 47), buckets <= 1024;
// * _stream_kernel (_run_stream): the same band over buckets of any
//   length, the text streamed in 512-char chunks with the register and the
//   accumulator carried in VMEM between grid steps.  Here a thread walks
//   all of its candidate's steps, so nothing is chunked: the wrapper
//   launches the same kernel at any LB (lcs_band_long).
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
// Stopping at the candidate's own length is exact: the TPU kernel runs the
// whole bucket (or the block's longest row), but past a candidate's
// length no char matches, so a step only moves the register's bit 0 into
// acc and a 1 in at its top bit, which keeps acc + popcount(~s).  That
// needs the padding never to match, which the scanner guarantees by
// refusing the band in byte mode for a query holding NUL (the pad byte),
// as the JAX scanner does; this kernel never reads padding at all.
//
// What bounds it on an H100: integer throughput, ~9 ops per band word and step
// (the window's funnel shift, and, the 3-input add with its carry-out,
// the or with s ^ u, the slide's shift-or) plus the per-step window index
// and the accumulator, independent of the query's length.
//
// Design, as K3 (csrc/lev_band.cu): one thread per candidate over the
// [LB/4, B] packed corpus.  The TPU read per-step windows pre-shifted on
// the host (band_kernel.build_shifted_tables, LB x BW tables per query)
// because its scalar shifts were slow; here the BW + 1 PM words around the
// window are read from the query's [W, 256] table (the K1/K4 table, cut to
// the ws words a bucket of LB chars can reach) and joined with
// __funnelshift_r.  The table sits in shared memory when its ws KB fit the
// 48 KB a block gets without opting in; longer queries over long buckets
// read it through the read-only cache, where the rows around the moving
// window stay hot.  Corpus offsets are 64-bit (row * B).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;
constexpr int kSmemWords = 48;   // table words that fit 48 KB of shared

template <bool SMEM>
__device__ __forceinline__ uint32_t pm_word(const uint32_t* pm, int w,
                                            uint32_t c) {
    return SMEM ? pm[w * kRows + c] : __ldg(pm + w * kRows + c);
}

template <int BW, bool SMEM>
__device__ __forceinline__ void band_step(const uint32_t* pm, int ws, int j,
                                          uint32_t c, uint32_t* s,
                                          int& acc) {
    // PM window of band word k starts at pattern row j - 16*BW + 32*k:
    // words widx0 + k and widx0 + k + 1, same shift for every k
    const int start0 = j - 16 * BW;
    const int widx0 = start0 >> 5;  // floor division (arithmetic shift)
    const unsigned sh = (unsigned)(start0 & 31);
    uint32_t pw[BW + 1];
#pragma unroll
    for (int i = 0; i <= BW; ++i) {
        const int w = widx0 + i;
        pw[i] = (w >= 0 && w < ws) ? pm_word<SMEM>(pm, w, c) : 0u;
    }
    uint32_t ns[BW];
    uint32_t carry = 0u;
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        const uint32_t x = __funnelshift_r(pw[k], pw[k + 1], sh);
        const uint32_t u = s[k] & x;
        const uint64_t t = (uint64_t)s[k] + u + carry;
        carry = (uint32_t)(t >> 32);
        ns[k] = (uint32_t)t | (s[k] ^ u);
    }
    acc += (int)(~ns[0] & 1u);
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        const uint32_t hi = (k + 1 < BW) ? (ns[k + 1] << 31) : 0x80000000u;
        s[k] = (ns[k] >> 1) | hi;
    }
}

template <int BW, bool SMEM>
__global__ void __launch_bounds__(kThreads)
lcs_band_kernel(const uint32_t* __restrict__ pm_g, int ws,
                const uint32_t* __restrict__ cand,
                const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                int64_t B, int lb4) {
    extern __shared__ uint32_t pm_s[];
    if (SMEM) {
        for (int i = threadIdx.x; i < ws * kRows; i += kThreads)
            pm_s[i] = pm_g[i];
        __syncthreads();
    }
    const uint32_t* pm = SMEM ? pm_s : pm_g;
    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;

    uint32_t s[BW];
#pragma unroll
    for (int k = 0; k < BW; ++k) s[k] = 0xFFFFFFFFu;
    int acc = 0;
    const int n = min(lb[b], 4 * lb4);
    const uint32_t* col = cand + b;
    const int rows = n >> 2;
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = col[(size_t)r * B];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            band_step<BW, SMEM>(pm, ws, 4 * r + u, (word >> (8 * u)) & 0xFFu,
                                s, acc);
    }
    const int rem = n & 3;
    if (rem) {
        const uint32_t word = col[(size_t)rows * B];
        for (int u = 0; u < rem; ++u)
            band_step<BW, SMEM>(pm, ws, 4 * rows + u,
                                (word >> (8 * u)) & 0xFFu, s, acc);
    }
#pragma unroll
    for (int k = 0; k < BW; ++k) acc += __popc(~s[k]);
    out[b] = acc;
}

template <int BW>
cudaError_t launch_band(const uint32_t* pm, int ws, const uint32_t* cand,
                        const int32_t* lb, int32_t* out, int64_t B, int lb4,
                        cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
    if (ws <= kSmemWords) {
        const size_t smem = (size_t)ws * kRows * sizeof(uint32_t);
        lcs_band_kernel<BW, true><<<grid, kThreads, smem, stream>>>(
            pm, ws, cand, lb, out, B, lb4);
    } else {
        lcs_band_kernel<BW, false><<<grid, kThreads, 0, stream>>>(
            pm, ws, cand, lb, out, B, lb4);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lcs_band(const uint32_t* pm, int ws, int bw,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, int64_t B, int lb4,
                                   cudaStream_t stream) {
    if (ws < 1) return cudaErrorInvalidValue;
    switch (bw) {
        case 1: return launch_band<1>(pm, ws, cand, lb, out, B, lb4, stream);
        case 2: return launch_band<2>(pm, ws, cand, lb, out, B, lb4, stream);
        case 3: return launch_band<3>(pm, ws, cand, lb, out, B, lb4, stream);
        default: return cudaErrorInvalidValue;
    }
}
