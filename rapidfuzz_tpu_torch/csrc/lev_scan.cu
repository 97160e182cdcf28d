// K1: one-vs-many uniform Levenshtein (Myers/Hyyro bit-parallel), one
// query or NQ queries per launch, at any bucket length.
//
// Replaces the TPU kernels rapidfuzz_tpu/ops/pallas/lev_kernel.py:_kernel,
// launched there by _run (one query) and _run_nq (multiq=True, 16
// queries), and rapidfuzz_tpu/ops/pallas/stream_kernel.py:_kernel (_run),
// which serves buckets over 1024 chars by streaming 512-char text chunks
// through a second grid axis with VP/VN carried in VMEM.  That chunking
// existed only because a candidate block of a long bucket did not fit
// VMEM; here a thread walks its own candidate's steps from global memory
// whatever the bucket, so one kernel serves every length and the wrapper
// only counts launches at buckets > 1024 apart (lev_scan_long).
//
// What bounds it on an H100: integer issue.  A step costs ~17 u32 ops per
// query word plus one shared-memory PM lookup per word; the corpus is
// read once per query, 1 byte per char (4 chars per coalesced u32 load),
// which at len-64 candidates is ~70 bytes per pair against ~2,000 integer
// ops, far on the compute side of the card's balance point.
//
// Design:
// * one thread per candidate, candidates along blockIdx.x; the NQ form
//   puts the query index on blockIdx.y, so all NQ queries reuse the
//   corpus lines the L2 already holds;
// * the packed corpus keeps the JAX layout [LB/4, B] u32: at text step j
//   a warp reads 32 neighbouring words of row j/4;
// * the query's PM table ([W, 256] u32, both "byte" and "local" mode)
//   sits in shared memory; the TPU's two 128-lane tables and their select
//   were a gather-width artefact;
// * VP/VN live in registers for W <= 8 (template on W); longer queries
//   run a generic kernel that keeps VP/VN in a [NQ, 2W, B] scratch read
//   and written coalesced by candidate, with PM read through the
//   read-only cache, so no query length is refused;
// * each thread runs exactly lb steps.  The TPU froze distances at
//   j == lb because lanes share control flow; the scanner's length sort
//   keeps the lengths inside one warp close.
//   la == 0 gives lb, lb == 0 gives la.
// * every offset into the corpus, the output and the scratch is 64-bit
//   (row * B): a 131072-char bucket of 65,536 candidates is 8 GiB packed,
//   past 2^31 bytes; only per-candidate lengths and the row count lb4 are
//   32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // PM entries: every byte value

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

template <int W>
__global__ void __launch_bounds__(kThreads)
lev_scan_reg(const uint32_t* __restrict__ pm_all,
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

    uint32_t vp[W], vn[W];
#pragma unroll
    for (int w = 0; w < W; ++w) { vp[w] = 0xFFFFFFFFu; vn[w] = 0u; }
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

__global__ void __launch_bounds__(kThreads)
lev_scan_generic(const uint32_t* __restrict__ pm_all,
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
    // VP rows [0, W), VN rows [W, 2W) of this query's scratch block
    uint32_t* st = scratch + (size_t)q * 2 * W * B + b;
    for (int w = 0; w < W; ++w) {
        st[(size_t)w * B] = 0xFFFFFFFFu;
        st[(size_t)(W + w) * B] = 0u;
    }
    int dist = la;
    const uint32_t* col = cand + b;
    uint32_t word = 0u;
    for (int j = 0; j < n; ++j) {
        if ((j & 3) == 0) word = col[(size_t)(j >> 2) * B];
        const uint32_t c = (word >> (8 * (j & 3))) & 0xFFu;
        uint32_t hp_c = 1u, hn_c = 0u, hp = 0u, hn = 0u;
        for (int w = 0; w < W; ++w) {
            uint32_t vp = st[(size_t)w * B], vn = st[(size_t)(W + w) * B];
            myers_word(__ldg(pm + w * kRows + c), vp, vn, hp_c, hn_c, hp,
                       hn);
            st[(size_t)w * B] = vp;
            st[(size_t)(W + w) * B] = vn;
        }
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
    lev_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                   B, lb4);
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lev_scan(const uint32_t* pm, const int32_t* las,
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
    if (W < 1 || scratch == nullptr) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), nq);
    lev_scan_generic<<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                    scratch, B, lb4, W);
    return cudaGetLastError();
}
