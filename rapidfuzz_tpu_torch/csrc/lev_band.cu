// K3: one-vs-many banded uniform Levenshtein under a score cutoff, at any
// bucket length.
//
// Replaces three TPU kernels of rapidfuzz_tpu/ops/pallas/band_kernel.py:
// * _fast_kernel (_run_fast): the band semiwidth pinned at 16*BW - 1 for
//   BW in {1, 2, 3} u32 words (cutoffs up to 47), buckets <= 1024;
// * _stream_kernel (_run_stream): the same pinned band over buckets of
//   any length, with the text streamed in 512-char chunks and the band
//   carried in VMEM between grid steps.  Here a thread walks all of its
//   candidate's steps, so the wrapper launches the same kernel at any LB;
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
// What bounds it on an H100: a text whose answer the final masks fix
// (empty, or its length more than the cutoff from la) is not walked, so a
// launch walks only the texts within the cutoff of the query's length:
// over long buckets a few blocks of the length-sorted corpus, each bound
// by the serial chain of its longest text's steps; over short buckets,
// integer issue (at BW = 1, 10 INT32-lane instructions a step in the
// recurrence, 14 issued with the window's address and the char).
//
// Design: one thread per candidate over the [LB/4, B] packed corpus, as
// K1; the BW + 1 PM words around the window are joined with
// __funnelshift_r and the probe bit is computed in-thread (the v5e needed
// host-shifted tables for both).
// * The length gate.  A thread's walk is its text's length n, or 0 where
//   the final masks fix its answer; a block whose texts all have n = 0
//   stages nothing and writes its masks.
// * The PM ring.  Every row a step reads depends on the step j alone, so
//   a block walks the text in chunks of kChunk steps, every thread at the
//   same step index up to the block's longest walk (a thread steps only
//   its own), and the ring_rows(...) table rows chunk c reads, from
//   widx0(c*kChunk), come from one of two shared-memory slots: one bulk
//   copy (TMA) a chunk, issued by thread 0 while the block computes the
//   chunk before and completing on the slot's mbarrier, rows outside
//   [0, ws) zeroed by the block.  No step reads device memory for PM or
//   tests a row's range.  One barrier a chunk: after it chunk c's rows
//   are in and every thread is done with chunk c - 1, whose slot is
//   refilled; a thread whose walk has ended keeps joining the barriers
//   until the block's longest walk ends.
// * Chunks that miss the horizontal phase run the diagonal step with no
//   test of the phase, counting d0's top bits; their steps are added to
//   the distance after the chunk.
// * Corpus words ahead: each thread holds its next kAhead packed words in
//   registers and loads word r + kAhead while it steps word r.
// * Longest first: block i takes the candidates of block nblocks - 1 - i,
//   the longest as the scanner sorts by length; the wrapper picks 64
//   threads a block over buckets of more than one chunk (the few texts a
//   long bucket walks spread over more SMs) and up to 256 otherwise
//   (band_kernel.block_threads).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;        // PM entries a table word (a byte value)
constexpr int kBig = 1 << 29;
constexpr int kMaxThreads = 256;
constexpr int kAhead = 4;         // packed corpus words a thread holds ahead
constexpr int kChunk = 256;       // text steps a chunk of the PM ring
constexpr unsigned kFull = 0xFFFFFFFFu;

// Rows a chunk reads: from widx0(c*kChunk) to widx0(c*kChunk + L - 1) +
// bw, L = min(kChunk, LB) steps (at least 1); kChunk is a multiple of 32,
// so every chunk starts at the same offset m in its first row.
__host__ __device__ constexpr int ring_rows(int bw, int semi, int LB) {
    return ((((semi + 1 - 32 * bw) % 32) + 32) % 32
            + (kChunk < LB ? kChunk : (LB > 1 ? LB : 1)) - 1) / 32 + bw + 1;
}

// a chunk is whole groups of kAhead words; the ring's two slots at their
// widest (bw = 3, an offset past 0 in the first row) fit the 48 KB a
// launch takes unasked
static_assert(kChunk % 32 == 0 && kChunk % (4 * kAhead) == 0, "chunk");
static_assert(2 * ring_rows(3, 0, kChunk) * kRows * 4 <= 48 * 1024, "ring");

template <int BW>
struct Band {
    uint32_t vp[BW], vn[BW];
    int dist;
    int top;    // d0's top bits over the steps of diagonal-only chunks
};

// One text step of the band recurrence (band_kernel.py's step), its PM
// window read from the ring slot `ring` that holds table rows wb..;
// PHASE false runs the diagonal phase with no test of the phase.
template <int BW, bool PHASE>
__device__ __forceinline__ void band_step(const uint32_t* ring, int wb,
                                          int j, int off, int pstart,
                                          uint32_t c, Band<BW>& st) {
    // PM window of band word k starts at pattern position start0 + 32*k:
    // words widx0 + k and widx0 + k + 1, same shift for every k
    const int start0 = j + off;
    const uint32_t* row = ring + ((start0 >> 5) - wb) * kRows + c;
    const unsigned sh = (unsigned)(start0 & 31);
    uint32_t pw[BW + 1];
#pragma unroll
    for (int i = 0; i <= BW; ++i) pw[i] = row[i * kRows];
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
    if (!PHASE) {                                  // diagonal-only chunk
        st.top += (int)(d0[BW - 1] >> 31);
    } else if (kk >= 0 && kk <= 32 * BW - 2) {     // horizontal phase
        const int rb = 32 * BW - 2 - kk;
        // the word holding bit rb, by selects (an indexed pick goes to a
        // stack array)
        uint32_t hpw = hp[0], hnw = hn[0];
#pragma unroll
        for (int k = 1; k < BW; ++k) {
            const bool at = (rb >> 5) == k;
            hpw = at ? hp[k] : hpw;
            hnw = at ? hn[k] : hnw;
        }
        st.dist += (int)((hpw >> (rb & 31)) & 1u)
                 - (int)((hnw >> (rb & 31)) & 1u);
    } else {                                       // diagonal phase
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

// Steps [j0, jend) of the block (jend: the chunk's end or the block's
// longest text), every thread at the same step index and stepping only
// its own steps, j < n: word r of its column comes from nxt[r % kAhead],
// which then loads word r + kAhead.
template <int BW, bool PHASE>
__device__ __forceinline__ void run_chunk(const uint32_t* ring, int wb,
                                          int j0, int jend, int n, int off,
                                          int pstart, const uint32_t* col,
                                          int64_t B, uint32_t (&nxt)[kAhead],
                                          Band<BW>& st) {
    const int nw = (n + 3) >> 2;
    for (int g = j0 >> 2; 4 * g < jend; g += kAhead) {
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
            const int r = g + d;
            const uint32_t word = nxt[d];
            if (r + kAhead < nw) nxt[d] = col[(size_t)(r + kAhead) * B];
            const int j = 4 * r;
            if (j + 4 <= n && j + 4 <= jend) {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    band_step<BW, PHASE>(ring, wb, j + u, off, pstart,
                                         __byte_perm(word, 0u, 0x4440u + u),
                                         st);
            } else {
                for (int u = 0; j + u < min(jend, n); ++u)
                    band_step<BW, PHASE>(ring, wb, j + u, off, pstart,
                                         __byte_perm(word, 0u, 0x4440u + u),
                                         st);
            }
        }
    }
    if (!PHASE) st.dist += max(min(jend, n) - j0, 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    }
}

// Stage rows wb .. wb + R - 1 of the [ws, 256] table into `slot`: the rows
// in [0, ws) by one bulk copy that completes on `bar`, the others zeroed.
__device__ __forceinline__ void stage_rows(uint32_t* slot, const uint32_t* pm,
                                           int ws, int wb, int R,
                                           uint64_t* bar) {
    const int lo = max(wb, 0), hi = max(min(wb + R, ws), lo);
    uint4* s4 = reinterpret_cast<uint4*>(slot);
    const int zlo = (lo - wb) * (kRows / 4), zhi = (hi - wb) * (kRows / 4);
    for (int i = threadIdx.x; i < R * (kRows / 4); i += blockDim.x)
        if (i < zlo || i >= zhi) s4[i] = make_uint4(0u, 0u, 0u, 0u);
    // the zeros are ordered before a later bulk copy into the slot
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
        const uint32_t bytes = (uint32_t)(hi - lo) * kRows * 4u;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
        if (bytes)
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                         "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                         :: "r"(smem_addr(slot + (lo - wb) * kRows)),
                            "l"(pm + (size_t)lo * kRows), "r"(bytes),
                            "r"(smem_addr(bar)) : "memory");
    }
}

// PINNED fixes semi at 16*BW - 1 at compile time, which folds the window
// and probe arithmetic as K3 did before it took a run-time semiwidth.
template <int BW, bool PINNED>
__global__ void __launch_bounds__(kMaxThreads)
lev_band_kernel(const uint32_t* __restrict__ pm, int ws, int la, int cut,
                int semi_arg, const uint32_t* __restrict__ cand,
                const int32_t* __restrict__ lb, int32_t* __restrict__ out,
                int64_t B, int lb4, int R) {
    const int semi = PINNED ? 16 * BW - 1 : semi_arg;
    const int off = semi + 1 - 32 * BW;       // start0 = j + off
    extern __shared__ uint4 ring4[];
    uint32_t* ring = reinterpret_cast<uint32_t*>(ring4);
    const int slot = R * kRows;
    __shared__ uint64_t bars[2];
    __shared__ int nmax_s;
    const int64_t blk = (int64_t)gridDim.x - 1 - blockIdx.x;  // longest first
    const int64_t b = blk * blockDim.x + threadIdx.x;
    const int lbv = b < B ? lb[b] : 0;
    // the walk: none where the final masks fix the answer
    const int n = (lbv == 0 || abs(la - lbv) > cut) ? 0 : min(lbv, 4 * lb4);
    const uint32_t* col = cand + (b < B ? b : 0);
    uint32_t nxt[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
        nxt[d] = 4 * d < n ? col[(size_t)d * B] : 0u;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(smem_addr(&bars[i])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        nmax_s = 0;
    }
    __syncthreads();
    const int wmax = __reduce_max_sync(kFull, n);
    if ((threadIdx.x & 31) == 0 && wmax) atomicMax(&nmax_s, wmax);

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
    st.top = 0;
    const int pstart = max(la - semi, 0);
    const int pend = pstart + 32 * BW - 2;

    __syncthreads();
    const int nblk = nmax_s;                  // the block's longest walk
    if (nblk > 0) stage_rows(ring, pm, ws, off >> 5, R, &bars[0]);
    for (int c = 0, j0 = 0; j0 < nblk; ++c, j0 += kChunk) {
        // one barrier a chunk: chunk c has landed, and every thread is done
        // with chunk c - 1, whose slot is refilled
        mbar_wait(&bars[c & 1], (uint32_t)(c >> 1) & 1u);
        __syncthreads();
        if (j0 + kChunk < nblk)
            stage_rows(ring + ((c + 1) & 1) * slot, pm, ws,
                       (j0 + kChunk + off) >> 5, R, &bars[(c + 1) & 1]);
        const uint32_t* cur = ring + (c & 1) * slot;
        const int wb = (j0 + off) >> 5;       // first row of chunk c
        const int jend = min(j0 + kChunk, nblk);
        if (j0 <= pend && pstart < j0 + kChunk)
            run_chunk<BW, true>(cur, wb, j0, jend, n, off, pstart, col, B,
                                nxt, st);
        else
            run_chunk<BW, false>(cur, wb, j0, jend, n, off, pstart, col, B,
                                 nxt, st);
    }
    if (b >= B) return;
    int d = (lbv == 0) ? la : st.dist - st.top;
    if (abs(la - lbv) > cut) d = kBig;
    if (d > cut) d = kBig;
    out[b] = d;
}

template <int BW, bool PINNED>
cudaError_t launch(const uint32_t* pm, int ws, int la, int cut, int semi,
                   const uint32_t* cand, const int32_t* lb, int32_t* out,
                   int64_t B, int lb4, int threads, cudaStream_t stream) {
    const int64_t blocks = (B + threads - 1) / threads;
    const int R = ring_rows(BW, semi, 4 * lb4);
    const int slots = kChunk < 4 * lb4 ? 2 : 1;   // more than one chunk
    const size_t smem = (size_t)slots * R * kRows * sizeof(uint32_t);
    lev_band_kernel<BW, PINNED><<<(unsigned)blocks, threads, smem, stream>>>(
        pm, ws, la, cut, semi, cand, lb, out, B, lb4, R);
    return cudaGetLastError();
}

template <int BW>
cudaError_t launch_band(const uint32_t* pm, int ws, int la, int cut,
                        int semi, const uint32_t* cand, const int32_t* lb,
                        int32_t* out, int64_t B, int lb4, int threads,
                        cudaStream_t stream) {
    if (semi == 16 * BW - 1)
        return launch<BW, true>(pm, ws, la, cut, semi, cand, lb, out, B, lb4,
                                threads, stream);
    if constexpr (BW == 1)   // the run-time band is one word
        return launch<BW, false>(pm, ws, la, cut, semi, cand, lb, out, B,
                                 lb4, threads, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" cudaError_t rf_lev_band(const uint32_t* pm, int ws, int la,
                                   int cut, int semi, int bw,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, int64_t B, int lb4,
                                   int threads, cudaStream_t stream) {
    // the band register holds 2*semi + 2 <= 32*bw rows; the bulk copy
    // takes 16-byte aligned rows
    if (ws < 1 || semi < 0 || 2 * semi + 2 > 32 * bw || lb4 < 0
        || threads < 32 || threads > kMaxThreads || threads % 32
        || (reinterpret_cast<uintptr_t>(pm) & 15))
        return cudaErrorInvalidValue;
    switch (bw) {
        case 1: return launch_band<1>(pm, ws, la, cut, semi, cand, lb, out, B, lb4, threads, stream);
        case 2: return launch_band<2>(pm, ws, la, cut, semi, cand, lb, out, B, lb4, threads, stream);
        case 3: return launch_band<3>(pm, ws, la, cut, semi, cand, lb, out, B, lb4, threads, stream);
        default: return cudaErrorInvalidValue;
    }
}
