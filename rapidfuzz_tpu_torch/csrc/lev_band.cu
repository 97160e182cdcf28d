// K3: one-vs-many banded uniform Levenshtein under a score cutoff, at any
// bucket length.
//
// Replaces three TPU kernels of rapidfuzz_tpu/ops/pallas/band_kernel.py:
// * _fast_kernel (_run_fast): the band semiwidth pinned at 16*BW - 1 for
//   BW in {1, 2, 3} u32 words (cutoffs up to 47), buckets <= 1024;
// * _stream_kernel (_run_stream): the same pinned band over buckets of
//   any length, with the text streamed in 512-char chunks and the band
//   carried in VMEM between grid steps.  Here a thread walks all of its
//   candidate's steps, so nothing is chunked: the wrapper launches the
//   same kernel at any LB;
// * _kernel (_run): a one-word band whose semiwidth is the caller's cutoff
//   (<= 15), for queries no longer than the pinned band or buckets > 1024.
//   It is the BW = 1 case of the general band below with semi = cutoff.
//
// The general band: semiwidth `semi`, a register of 32*BW bits whose top
// bit sits at pattern row j + semi at text step j, so bit 0 is row
// start0 = j + semi + 1 - 32*BW (j - 16*BW for the pinned band).  VP
// starts with its top semi + 1 bits set and dist at semi.  Each step runs
// the BW-word band recurrence (the add's carry chained from low to high
// word, the register shifted right one bit across words), a diagonal phase
// whose distance delta is the inverse of d0's top bit, then, from step
// pstart = max(la - semi, 0), a horizontal phase that reads the delta at
// register bit 32*BW - 2 - (j - pstart), the pattern's last row.  Past
// that (j - pstart > 32*BW - 2) the band has left the pattern; only
// candidates with |la - lb| > semi >= cut get there, and the length mask
// rejects them.  Final masks as band_kernel.py:374-376: lb == 0 -> la,
// |la - lb| > cut -> BIG, dist > cut -> BIG.
//
// What bounds it on an H100: integer issue, as K1, but the per-step cost
// is ~25 ops per band word independent of the query's length.
//
// Design: one thread per candidate over the [LB/4, B] packed corpus, as
// K1.  The v5e needed per-step PM windows pre-shifted on the host
// (build_shifted_tables) and probe masks from a table (probe_table)
// because its scalar shifts were slow; here the BW + 1 PM words around
// the window are read from the query's [W, 256] table (the K1 table, cut
// to the ws words a bucket of LB chars can reach) and joined with
// __funnelshift_r, and the probe bit is computed in-thread.  The table
// sits in shared memory when its ws KB fit the 48 KB a block gets without
// opting in; longer queries over long buckets read it through the
// read-only cache, where the few rows around the moving window stay hot.
// Every index that depends on the step alone is uniform across the warp;
// corpus offsets are 64-bit (row * B).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;
constexpr int kBig = 1 << 29;
constexpr int kSmemWords = 48;   // table words that fit 48 KB of shared

template <int BW>
struct Band {
    uint32_t vp[BW], vn[BW];
    int dist;
};

template <bool SMEM>
__device__ __forceinline__ uint32_t pm_word(const uint32_t* pm, int w,
                                            uint32_t c) {
    return SMEM ? pm[w * kRows + c] : __ldg(pm + w * kRows + c);
}

template <int BW, bool SMEM>
__device__ __forceinline__ void band_step(const uint32_t* pm, int ws, int j,
                                          int semi, int pstart, uint32_t c,
                                          Band<BW>& st) {
    // PM window of band word k starts at pattern position start0 + 32*k:
    // words widx0 + k and widx0 + k + 1, same shift for every k
    const int start0 = j + semi + 1 - 32 * BW;
    const int widx0 = start0 >> 5;  // floor division (arithmetic shift)
    const unsigned sh = (unsigned)(start0 & 31);
    uint32_t pw[BW + 1];
#pragma unroll
    for (int i = 0; i <= BW; ++i) {
        const int w = widx0 + i;
        pw[i] = (w >= 0 && w < ws) ? pm_word<SMEM>(pm, w, c) : 0u;
    }
    uint32_t d0[BW], hp[BW], hn[BW];
    uint32_t carry = 0u;
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        const uint32_t x = __funnelshift_r(pw[k], pw[k + 1], sh);
        const uint64_t t = (uint64_t)(x & st.vp[k]) + st.vp[k] + carry;
        carry = (uint32_t)(t >> 32);
        d0[k] = ((uint32_t)t ^ st.vp[k]) | x | st.vn[k];
        hp[k] = st.vn[k] | ~(d0[k] | st.vp[k]);
        hn[k] = d0[k] & st.vp[k];
    }
    const int kk = j - pstart;
    if (kk >= 0 && kk <= 32 * BW - 2) {       // horizontal phase
        const int rb = 32 * BW - 2 - kk;
        uint32_t hpw = 0u, hnw = 0u;
#pragma unroll
        for (int k = 0; k < BW; ++k)
            if (k == (rb >> 5)) { hpw = hp[k]; hnw = hn[k]; }
        st.dist += (int)((hpw >> (rb & 31)) & 1u)
                 - (int)((hnw >> (rb & 31)) & 1u);
    } else {                                  // diagonal phase
        st.dist += 1 - (int)(d0[BW - 1] >> 31);
    }
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        const uint32_t hi = (k + 1 < BW) ? (d0[k + 1] << 31) : 0u;
        const uint32_t d0s = (d0[k] >> 1) | hi;
        st.vp[k] = hn[k] | ~(d0s | hp[k]);
        st.vn[k] = d0s & hp[k];
    }
}

// PINNED fixes semi at 16*BW - 1 at compile time, which folds the window
// and probe arithmetic as K3 did before it took a run-time semiwidth.
template <int BW, bool SMEM, bool PINNED>
__global__ void __launch_bounds__(kThreads)
lev_band_kernel(const uint32_t* __restrict__ pm_g, int ws, int la, int cut,
                int semi_arg, const uint32_t* __restrict__ cand,
                const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                int64_t B, int lb4) {
    const int semi = PINNED ? 16 * BW - 1 : semi_arg;
    extern __shared__ uint32_t pm_s[];
    if (SMEM) {
        for (int i = threadIdx.x; i < ws * kRows; i += kThreads)
            pm_s[i] = pm_g[i];
        __syncthreads();
    }
    const uint32_t* pm = SMEM ? pm_s : pm_g;
    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;

    Band<BW> st;
    const int lo = 32 * BW - 1 - semi;     // VP: top semi + 1 bits set
#pragma unroll
    for (int k = 0; k < BW; ++k) {
        st.vp[k] = (32 * k >= lo) ? 0xFFFFFFFFu
                 : (32 * k + 31 < lo) ? 0u
                 : (0xFFFFFFFFu << (lo - 32 * k));
        st.vn[k] = 0u;
    }
    st.dist = semi;
    const int pstart = max(la - semi, 0);
    const int lbv = lb[b];
    const int n = min(lbv, 4 * lb4);
    const uint32_t* col = cand + b;
    const int rows = n >> 2;
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = col[(size_t)r * B];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            band_step<BW, SMEM>(pm, ws, 4 * r + u, semi, pstart,
                                (word >> (8 * u)) & 0xFFu, st);
    }
    const int rem = n & 3;
    if (rem) {
        const uint32_t word = col[(size_t)rows * B];
        for (int u = 0; u < rem; ++u)
            band_step<BW, SMEM>(pm, ws, 4 * rows + u, semi, pstart,
                                (word >> (8 * u)) & 0xFFu, st);
    }
    int d = (lbv == 0) ? la : st.dist;
    if (abs(la - lbv) > cut) d = kBig;
    if (d > cut) d = kBig;
    out[b] = d;
}

template <int BW, bool PINNED>
void launch_table(const uint32_t* pm, int ws, int la, int cut, int semi,
                  const uint32_t* cand, const int32_t* lb, int32_t* out,
                  int64_t B, int lb4, cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
    if (ws <= kSmemWords) {
        const size_t smem = (size_t)ws * kRows * sizeof(uint32_t);
        lev_band_kernel<BW, true, PINNED><<<grid, kThreads, smem, stream>>>(
            pm, ws, la, cut, semi, cand, lb, out, B, lb4);
    } else {
        lev_band_kernel<BW, false, PINNED><<<grid, kThreads, 0, stream>>>(
            pm, ws, la, cut, semi, cand, lb, out, B, lb4);
    }
}

template <int BW>
cudaError_t launch_band(const uint32_t* pm, int ws, int la, int cut,
                        int semi, const uint32_t* cand, const int32_t* lb,
                        int32_t* out, int64_t B, int lb4,
                        cudaStream_t stream) {
    if (semi == 16 * BW - 1) {
        launch_table<BW, true>(pm, ws, la, cut, semi, cand, lb, out, B, lb4,
                               stream);
    } else if constexpr (BW == 1) {   // the run-time band is one word
        launch_table<BW, false>(pm, ws, la, cut, semi, cand, lb, out, B,
                                lb4, stream);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lev_band(const uint32_t* pm, int ws, int la,
                                   int cut, int semi, int bw,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, int64_t B, int lb4,
                                   cudaStream_t stream) {
    // the band register holds 2*semi + 2 <= 32*bw rows
    if (ws < 1 || semi < 0 || 2 * semi + 2 > 32 * bw)
        return cudaErrorInvalidValue;
    switch (bw) {
        case 1: return launch_band<1>(pm, ws, la, cut, semi, cand, lb, out, B, lb4, stream);
        case 2: return launch_band<2>(pm, ws, la, cut, semi, cand, lb, out, B, lb4, stream);
        case 3: return launch_band<3>(pm, ws, la, cut, semi, cand, lb, out, B, lb4, stream);
        default: return cudaErrorInvalidValue;
    }
}
