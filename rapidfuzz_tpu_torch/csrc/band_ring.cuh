// The shared-memory PM ring of the band kernels K3 (lev_band.cu) and K5
// (lcs_band.cu).
//
// Both bands put their register's bit 0 at pattern row j + off at text
// step j (off = semi + 1 - 32*BW), so the BW + 1 table words a step reads,
// widx0(j) = (j + off) >> 5 and the BW after it, depend on the step alone.
// A block therefore walks its texts in chunks of kChunk steps, every
// thread at the same step index up to the block's longest walk (a thread
// steps only its own), and reads PM only from one of two shared-memory
// slots: the ring_rows(...) table rows chunk c reads, from widx0(c*kChunk),
// land there by one bulk copy (TMA) that thread 0 issues while the block
// computes the chunk before, completing on the slot's mbarrier; rows
// outside [0, ws) are zeroed by the block.  One barrier a chunk: after it
// chunk c's rows are in and every thread is done with chunk c - 1, whose
// slot is refilled; a thread whose walk has ended keeps joining the
// barriers until the block's longest walk ends.
//
// Corpus words ahead: a thread holds the next AHEAD packed words of its
// [LB/4, B] column in registers and loads word r + AHEAD while it steps
// word r (walk_words; AHEAD is the length of the kernel's array).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace band_ring {

constexpr int kRows = 256;        // PM entries a table word (a byte value)
constexpr int kChunk = 256;       // text steps a chunk of the PM ring
constexpr unsigned kFull = 0xFFFFFFFFu;

// Rows a chunk reads: from widx0(c*kChunk) to widx0(c*kChunk + L - 1) +
// bw, L = min(kChunk, LB) steps (at least 1); kChunk is a multiple of 32,
// so every chunk starts at the same offset m in its first row.
__host__ __device__ constexpr int ring_rows(int bw, int semi, int LB) {
    return ((((semi + 1 - 32 * bw) % 32) + 32) % 32
            + (kChunk < LB ? kChunk : (LB > 1 ? LB : 1)) - 1) / 32 + bw + 1;
}

// the ring's two slots at their widest (bw = 3, an offset past 0 in the
// first row) fit the 48 KB a launch takes unasked
static_assert(kChunk % 32 == 0, "chunk");
static_assert(2 * ring_rows(3, 0, kChunk) * kRows * 4 <= 48 * 1024, "ring");

// Bytes of shared memory a launch gives the ring: two slots when the walk
// takes more than one chunk.
__host__ constexpr size_t ring_bytes(int R, int walk) {
    return (size_t)(kChunk < walk ? 2 : 1) * R * kRows * sizeof(uint32_t);
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

// The ring's barriers and the block's longest walk, in static shared
// memory.
struct Ring {
    uint64_t bars[2];
    int nmax;
};

// Thread 0 sets up the barriers and zeroes the longest walk; a
// __syncthreads must follow before ring_vote.
__device__ __forceinline__ void ring_setup(Ring& r) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(smem_addr(&r.bars[i])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        r.nmax = 0;
    }
}

// Adds a thread's walk n to the block's longest (read r.nmax after the
// next __syncthreads).
__device__ __forceinline__ void ring_vote(Ring& r, int n) {
    const int wmax = __reduce_max_sync(kFull, n);
    if ((threadIdx.x & 31) == 0 && wmax) atomicMax(&r.nmax, wmax);
}

// The block's walk of nblk steps over the ring `ring` (two slots of R rows
// each; one is enough when nblk <= kChunk): chunk(slot, wb, j0, jend) runs
// steps [j0, jend) reading rows wb .. wb + R - 1 from `slot`.
template <class Chunk>
__device__ __forceinline__ void ring_walk(Ring& r, uint32_t* ring,
                                          const uint32_t* pm, int ws, int off,
                                          int R, int nblk, Chunk&& chunk) {
    const int slot = R * kRows;
    if (nblk > 0) stage_rows(ring, pm, ws, off >> 5, R, &r.bars[0]);
    for (int c = 0, j0 = 0; j0 < nblk; ++c, j0 += kChunk) {
        // one barrier a chunk: chunk c has landed, and every thread is done
        // with chunk c - 1, whose slot is refilled
        mbar_wait(&r.bars[c & 1], (uint32_t)(c >> 1) & 1u);
        __syncthreads();
        if (j0 + kChunk < nblk)
            stage_rows(ring + ((c + 1) & 1) * slot, pm, ws,
                       (j0 + kChunk + off) >> 5, R, &r.bars[(c + 1) & 1]);
        chunk(ring + (c & 1) * slot, (j0 + off) >> 5, j0,
              min(j0 + kChunk, nblk));
    }
}

// Steps [j0, jend) of the block (jend: the chunk's end or the block's
// longest walk), every thread at the same step index and stepping only
// its own steps, j < n: word r of its column comes from nxt[r % AHEAD],
// which then loads word r + AHEAD.  step.full(word, j) runs the four
// steps j .. j + 3 of a packed word, step.part(word, j, m) its first m.
template <int AHEAD, class Step>
__device__ __forceinline__ void walk_words(int j0, int jend, int n,
                                           const uint32_t* col, int64_t B,
                                           uint32_t (&nxt)[AHEAD],
                                           Step& step) {
    // a chunk is whole groups of AHEAD words
    static_assert(kChunk % (4 * AHEAD) == 0, "words ahead");
    const int nw = (n + 3) >> 2;
    // word r + AHEAD's address, a row (B words) further each word
    const uint32_t* p = col + (size_t)((j0 >> 2) + AHEAD) * B;
    for (int g = j0 >> 2; 4 * g < jend; g += AHEAD) {
#pragma unroll
        for (int d = 0; d < AHEAD; ++d) {
            const int r = g + d;
            const uint32_t word = nxt[d];
            if (r + AHEAD < nw) nxt[d] = *p;
            p += B;
            const int j = 4 * r;
            if (j + 4 <= n && j + 4 <= jend)
                step.full(word, j);
            else
                step.part(word, j, min(jend, n) - j);
        }
    }
}

// The first AHEAD words of a column walked n steps.
template <int AHEAD>
__device__ __forceinline__ void words_ahead(const uint32_t* col, int64_t B,
                                            int n, uint32_t (&nxt)[AHEAD]) {
#pragma unroll
    for (int d = 0; d < AHEAD; ++d)
        nxt[d] = 4 * d < n ? col[(size_t)d * B] : 0u;
}

}  // namespace band_ring
