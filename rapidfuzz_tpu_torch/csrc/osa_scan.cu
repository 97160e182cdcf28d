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
// candidate block of a long bucket did not fit VMEM: a thread (a group of
// lanes in the tile form) here walks its own candidate's text from global
// memory at any length, so one
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
// * the packed corpus keeps the JAX layout [LB/4, B] u32, a coalesced load
//   of 4 chars per 4 text steps; the query's PM table sits in shared
//   memory; the NQ form puts the query index on blockIdx.y so the queries
//   share the corpus lines the L2 holds;
// * register form (W <= kMaxRegW = 8 words, template on W): one thread per
//   candidate holds VP, VN, D0_prev and PM_prev of all W words (4W state
//   words, twice K1's) and adds each step's delta at bit (la - 1) & 31 of
//   word W - 1; the table [W, 256] u32;
// * tile form (W > 8; csrc/tile_scan.cuh, the design K1's lev_scan_tile
//   follows): a lane holds kTileWords consecutive query words of VP, VN
//   and D0_prev in registers and a candidate takes ceil(W / kTileWords)
//   lanes in a wavefront.  Three bits cross a word edge, all from low
//   words to high ones: the horizontal carries hp_c and hn_c, and bit 31
//   of the lower word's t = ~d0_prev & pm.  Lane t - 1 computes that t
//   bit in its step for char j, one step before lane t runs char j, so
//   the bit it hands on with the char is the one for the SAME char (the
//   first trap above, across lanes).  Lane 0 starts them at hp_c = 1,
//   hn_c = 0, t = 0.  PM_prev is the previous char's row, re-read from
//   the shared table (a 257th all-zero row before the first char).  No
//   lane adds a delta per step: VP and VN are the final column's vertical
//   deltas, so D[la][n] = n + popc(VP) - popc(VN) over the query's la
//   bits, summed over the group's lanes by a warp prefix sum;
// * strips: queries over 128 words go in strips of 128, the strip's top
//   lane packing its 3 bits a text row into 4-bit slots of an edge
//   buffer, 8 rows a u32 ([NQ, ceil(LB / 8), nb] u32), which lane 0 of
//   the next strip reads back, the buffer reused in place; the wrapper
//   launches over chunks of candidates whose edge buffers fit its memory
//   plan (lev_kernel.SCRATCH_BYTES); no form keeps state in device memory
//   per step;
// * the corpus comes sorted by length, and block b works the candidates
//   of block nblocks - 1 - b, so the longest texts start first (both
//   forms);
// * each candidate runs exactly its lb steps (the TPU froze the distance
//   at j == lb because lanes share control flow); la == 0 gives lb, lb ==
//   0 gives la;
// * every offset into the corpus, the output and the edge buffer is
//   64-bit (row * B); only per-candidate lengths and the row count lb4 are
//   32-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

constexpr int kThreads = 256;  // the register form's block
constexpr int kRows = 256;     // PM entries: every byte value
constexpr int kMaxRegW = 8;    // register form up to this many words
constexpr int kTileWords = 8;  // query words a tile lane holds
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// The register form over candidates [b0, b0 + nb).
template <int W>
__global__ void __launch_bounds__(kThreads)
osa_scan_reg(const uint32_t* __restrict__ pm_all,
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

    uint32_t vp[W], vn[W], d0p[W], pmp[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        vp[w] = kFull;
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

// The tile form's word recurrence (csrc/tile_scan.cuh): a lane's
// kTileWords words of VP, VN and D0_prev, PM_prev re-read from the shared
// table (kept in registers, it took the lane past the 64-register cap:
// 16 bytes of spill); the bits handed on are hp_c | hn_c << 1 | t << 2,
// in 4-bit edge slots.  The table stays lane-major and unpadded: K6 is
// bound by its integer issue, and the interleaved table's stride took a
// register it lacks.
struct OsaTile {
    static constexpr int L = kTileWords;
    static constexpr int kSlot = 4;
    static constexpr uint32_t kStart = 1u;     // hp_c = 1, hn_c = 0, t = 0
    static constexpr bool kPrev = true;
    static constexpr bool kInterleave = false;
    static constexpr int kPad = 0;

    struct State {
        uint32_t vp[L], vn[L], d0p[L];

        __device__ __forceinline__ void init() {
#pragma unroll
            for (int w = 0; w < L; ++w) {
                vp[w] = kFull;
                vn[w] = 0u;
                d0p[w] = 0u;
            }
        }

        __device__ __forceinline__ void step(const uint32_t* row,
                                             const uint32_t* prev,
                                             int stride, uint32_t& bits) {
            uint32_t pmw[L], pmp[L];
            tile::load_tile<L>(row, stride, pmw);
            tile::load_tile<L>(prev, stride, pmp);
            uint32_t hp_c = bits & 1u, hn_c = (bits >> 1) & 1u;
            uint32_t t_lo = (bits >> 2) << 31, hp, hn;
#pragma unroll
            for (int w = 0; w < L; ++w)
                osa_word(pmw[w], pmp[w], vp[w], vn[w], d0p[w], t_lo, hp_c,
                         hn_c, hp, hn);
            bits = hp_c | (hn_c << 1) | ((t_lo >> 31) << 2);
        }

        // popc(VP) - popc(VN) over the query's bits among the lane's
        // words (gw0 the first one's index in the query): whole words
        // below la / 32, the low la % 32 bits of word la / 32, none past
        __device__ __forceinline__ int part(int la, int gw0) const {
            const int full = la >> 5;
            int sum = 0;
#pragma unroll
            for (int w = 0; w < L; ++w) {
                const int gw = gw0 + w;
                const uint32_t m = gw < full ? kFull
                    : (gw == full ? (1u << (la & 31)) - 1u : 0u);
                sum += __popc(vp[w] & m) - __popc(vn[w] & m);
            }
            return sum;
        }
    };

    static __device__ __forceinline__ int finish(int n, int sum) {
        return n + sum;
    }
};

TILE_KERNEL(osa_scan_tile, OsaTile)

template <int W>
cudaError_t launch_reg(const uint32_t* pm, const int32_t* las,
                       const uint32_t* cand, const int32_t* lb,
                       int32_t* out, int64_t B, int64_t b0, int64_t nb,
                       int lb4, int nq, cudaStream_t stream) {
    const dim3 grid((unsigned)((nb + kThreads - 1) / kThreads), nq);
    osa_scan_reg<W><<<grid, kThreads, 0, stream>>>(pm, las, cand, lb, out,
                                                   B, b0, nb, lb4);
    return cudaGetLastError();
}

}  // namespace

// OSA distances of NQ queries (lengths las [NQ], PM tables pm [NQ, W, 256])
// to candidates [b0, b0 + nb) of the packed corpus cand [lb4, B], written
// to out[q * B + b].  W <= 8 takes the register form, past that the tile
// form; queries over 128 words need the edge buffer edge:
// [NQ, ceil(4 * lb4 / 8), nb] u32.
extern "C" cudaError_t rf_osa_scan(const uint32_t* pm, const int32_t* las,
                                   const uint32_t* cand, const int32_t* lb,
                                   int32_t* out, uint32_t* edge, int64_t B,
                                   int64_t b0, int64_t nb, int lb4, int W,
                                   int nq, cudaStream_t stream) {
    if (W < 1 || nq < 1 || b0 < 0 || nb < 0 || b0 + nb > B)
        return cudaErrorInvalidValue;
    if (nb == 0) return cudaSuccess;
    static_assert(kMaxRegW == 8, "the switch below instantiates W <= 8");
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
    return tile::launch_tile<OsaTile>(osa_scan_tile, pm, las, cand, lb, out,
                                      edge, B, b0, nb, lb4, W, nq, stream);
}
