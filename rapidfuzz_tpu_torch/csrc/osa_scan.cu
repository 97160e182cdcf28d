// K6: one-vs-many OSA (optimal string alignment) distance, Hyyro's
// bit-parallel Levenshtein step plus the transposition term, one query or
// NQ queries per launch, at any bucket length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/osa_kernel.py:_kernel,
// launched there by _run (one query, buckets <= 1024) and _run_nq
// (multiq=True, 16 queries), and stream_kernel.py:_osa_kernel (_osa_run),
// which serves buckets over 1024 chars by streaming 512-char text chunks
// through a second grid axis with VP, VN, D0 and PM of the previous step
// carried in VMEM.  As for K1, that chunking existed only because a
// candidate block of a long bucket did not fit VMEM: a thread here walks
// its own candidate's text from global memory at any length, so one
// kernel serves every bucket and the wrapper counts launches over
// 1024-char buckets apart (osa_scan_long).
//
// The recurrence (osa_kernel.py:56-61; the reference's osa.rs:84-135 for
// one word, :156-227 for many): K1's Myers word, with
//   t[w]  = ~d0_prev[w] & pm[w]
//   tr[w] = (t[w] << 1 | t[w-1] >> 31) & pm_prev[w]
//   d0   |= tr[w]
// where d0_prev and pm_prev are the previous text step's D0 and PM row.
// Two traps when the state is updated in place: the cross-word bit reads
// word w-1's PREVIOUS-step d0 (t[w-1] is taken before word w-1's new d0
// overwrites it) and its CURRENT-step pm.  Both sit in t[w-1], which the
// loop carries from one word to the next; the shift-or is one
// __funnelshift_l.  At step 0 pm_prev is zero, so tr is 0.
//
// What bounds it on an H100: integer issue, as K1.  A step costs ~14 u32
// ops per query word (K1's 11 plus the and-not, the funnel shift and the
// and with pm_prev; the or into d0 folds into K1's 3-input or) and one
// shared-memory PM lookup per word; the corpus is read once per query,
// 1 byte per char, far on the compute side of the card's balance point.
//
// Design, as K1 (csrc/lev_scan.cu):
// * one thread per candidate, candidates along blockIdx.x; the NQ form
//   puts the query index on blockIdx.y so the queries share the corpus
//   lines the L2 holds;
// * the packed corpus keeps the JAX layout [LB/4, B] u32, a coalesced load
//   of 4 chars per 4 text steps;
// * the query's PM table ([W, 256] u32) sits in shared memory;
// * VP, VN, D0_prev and PM_prev live in registers for W <= kMaxRegW
//   (template on W; 4W state words, twice K1's).  Longer queries keep VP,
//   VN and D0_prev in a [NQ, 3W, B] scratch read and written coalesced by
//   candidate, with PM read through the read-only cache; PM_prev is not
//   stored there: the thread keeps the previous text char and re-reads
//   its row, so no query length is refused;
// * each thread runs exactly its candidate's lb steps (the TPU froze the
//   distance at j == lb because lanes share control flow);
//   la == 0 gives lb, lb == 0 gives la;
// * every offset into the corpus, the output and the scratch is 64-bit
//   (row * B); only per-candidate lengths and the row count lb4 are
//   32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;   // PM entries: every byte value
constexpr int kMaxRegW = 8;  // state in registers up to this many words

// One OSA step of one word.  `t_lo` comes in as word w-1's
// ~d0_prev & pm (0 for word 0) and leaves as this word's; `d0p` comes in
// as this word's previous-step D0 and leaves as the new one.  The
// horizontal carries (hp_c, hn_c) pass on to the next word, as in K1.
__device__ __forceinline__ void osa_word(uint32_t pmw, uint32_t pmp,
                                         uint32_t& vp, uint32_t& vn,
                                         uint32_t& d0p, uint32_t& t_lo,
                                         uint32_t& hp_c, uint32_t& hn_c,
                                         uint32_t& hp_o, uint32_t& hn_o) {
    const uint32_t t = ~d0p & pmw;
    const uint32_t tr = __funnelshift_l(t_lo, t, 1) & pmp;
    t_lo = t;
    const uint32_t x = pmw | hn_c;
    const uint32_t d0 = (((x & vp) + vp) ^ vp) | x | vn | tr;
    const uint32_t hp = vn | ~(d0 | vp);
    const uint32_t hn = d0 & vp;
    hp_o = hp;
    hn_o = hn;
    const uint32_t hp_s = (hp << 1) | hp_c;
    const uint32_t hn_s = (hn << 1) | hn_c;
    vp = hn_s | ~(d0 | hp_s);
    vn = hp_s & d0;
    d0p = d0;
    hp_c = hp >> 31;
    hn_c = hn >> 31;
}

template <int W>
__device__ __forceinline__ int step(const uint32_t* __restrict__ pm,
                                    uint32_t c, uint32_t* vp, uint32_t* vn,
                                    uint32_t* d0p, uint32_t* pmp,
                                    int last) {
    uint32_t hp_c = 1u, hn_c = 0u, hp = 0u, hn = 0u, t_lo = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const uint32_t pmw = pm[w * kRows + c];
        osa_word(pmw, pmp[w], vp[w], vn[w], d0p[w], t_lo, hp_c, hn_c, hp,
                 hn);
        pmp[w] = pmw;
    }
    return (int)((hp >> last) & 1u) - (int)((hn >> last) & 1u);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
osa_scan_reg(const uint32_t* __restrict__ pm_all,
             const int32_t* __restrict__ las,
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
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    int32_t* dst = out + (size_t)q * B + b;
    if (la == 0) { *dst = lb[b]; return; }
    const int last = (la - 1) & 31;

    uint32_t vp[W], vn[W], d0p[W], pmp[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        vp[w] = 0xFFFFFFFFu;
        vn[w] = 0u;
        d0p[w] = 0u;
        pmp[w] = 0u;
    }
    int dist = la;
    const int rows = n >> 2;
    const uint32_t* col = cand + b;
    for (int r = 0; r < rows; ++r) {
        const uint32_t word = col[(size_t)r * B];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            dist += step<W>(pm, (word >> (8 * u)) & 0xFFu, vp, vn, d0p, pmp,
                            last);
    }
    const int rem = n & 3;
    if (rem) {
        const uint32_t word = col[(size_t)rows * B];
        for (int u = 0; u < rem; ++u)
            dist += step<W>(pm, (word >> (8 * u)) & 0xFFu, vp, vn, d0p, pmp,
                            last);
    }
    *dst = dist;
}

__global__ void __launch_bounds__(kThreads)
osa_scan_generic(const uint32_t* __restrict__ pm_all,
                 const int32_t* __restrict__ las,
                 const uint32_t* __restrict__ cand,
                 const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                 uint32_t* __restrict__ scratch, int64_t B, int lb4,
                 int W) {
    const int q = blockIdx.y;
    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    const uint32_t* pm = pm_all + (size_t)q * W * kRows;
    const int la = las[q];
    const int n = min(lb[b], 4 * lb4);
    int32_t* dst = out + (size_t)q * B + b;
    if (la == 0) { *dst = lb[b]; return; }
    const int last = (la - 1) & 31;
    // VP rows [0, W), VN rows [W, 2W), D0_prev rows [2W, 3W) of this
    // query's scratch block
    uint32_t* st = scratch + (size_t)q * 3 * W * B + b;
    for (int w = 0; w < W; ++w) {
        st[(size_t)w * B] = 0xFFFFFFFFu;
        st[(size_t)(W + w) * B] = 0u;
        st[(size_t)(2 * W + w) * B] = 0u;
    }
    int dist = la;
    const uint32_t* col = cand + b;
    uint32_t word = 0u, c_prev = 0u;
    for (int j = 0; j < n; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
        uint32_t hp_c = 1u, hn_c = 0u, hp = 0u, hn = 0u, t_lo = 0u;
        for (int w = 0; w < W; ++w) {
            uint32_t vp = st[(size_t)w * B], vn = st[(size_t)(W + w) * B];
            uint32_t d0p = st[(size_t)(2 * W + w) * B];
            // PM_prev: the previous char's row, zero before the first
            const uint32_t pmp = j ? __ldg(pm + w * kRows + c_prev) : 0u;
            osa_word(__ldg(pm + w * kRows + c), pmp, vp, vn, d0p, t_lo, hp_c,
                     hn_c, hp, hn);
            st[(size_t)w * B] = vp;
            st[(size_t)(W + w) * B] = vn;
            st[(size_t)(2 * W + w) * B] = d0p;
        }
        c_prev = c;
        dist += (int)((hp >> last) & 1u) - (int)((hn >> last) & 1u);
    }
    *dst = dist;
}

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const int32_t* las,
                       const uint32_t* cand, const int32_t* lb,
                       int32_t* out, int64_t B, int lb4, int nq,
                       cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), nq);
    osa_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                   B, lb4);
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_osa_scan(const uint32_t* pm, const int32_t* las,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, uint32_t* scratch,
                                   int64_t B, int lb4, int W, int nq,
                                   cudaStream_t stream) {
    switch (W) {
        case 1: return launch_reg<1>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 2: return launch_reg<2>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 3: return launch_reg<3>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 4: return launch_reg<4>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 5: return launch_reg<5>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 6: return launch_reg<6>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 7: return launch_reg<7>(pm, las, cand, lb, out, B, lb4, nq, stream);
        case 8: return launch_reg<8>(pm, las, cand, lb, out, B, lb4, nq, stream);
        default: break;
    }
    static_assert(kMaxRegW == 8, "the switch above instantiates W <= 8");
    if (W < 1 || scratch == nullptr) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), nq);
    osa_scan_generic<<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                    scratch, B, lb4, W);
    return cudaGetLastError();
}
