// K11: banded uniform Levenshtein of ONE long pair.
//
// Replaces rapidfuzz_tpu/ops/pallas/pair_kernel.py: _kernel (_run).  The
// pattern (the longer string, la chars) sits in a PM table of [V, ws] u32
// words over the pair's local vocabulary (ws >= ceil(la / 32), the words
// past the pattern 0), the text (the shorter string, lb chars) is a [lb]
// int32 array of local ids.  A band of B = R * 4096 bits (NW = R * 128
// words, R in 1..8) slides one bit per text char: at text step j, band
// bit k stands for pattern position j + K + 1 - B + k.  VP starts with its
// top K + 1 bits set, VN at 0, the distance at K.  Each step:
// * the PM window: band word w joins table words p0 / 32 + w and + 1
//   (p0 = j + K + 1 - B, floor division; it is negative at first) with one
//   funnel shift; a word index outside [0, ws) reads as 0;
// * the Myers/Hyyro band step on the NW-word big integer:
//   d0 = (((x & vp) + vp) ^ vp) | x | vn, hp = vn | ~(d0 | vp),
//   hn = d0 & vp, then d0 >> 1 across words and the new vp, vn;
// * the distance delta: while j < la - K (the diagonal phase) the inverse
//   of d0's top bit, then hp - hn at bit max(B - 2 - (j - la + K), 0).
// The result is K plus the deltas: exact when <= K, above K otherwise.
//
// The TPU kernel read a [lb, R, 128] window stream that an XLA prepass
// (build_band_stream) shifted into place, R * 512 bytes a text char,
// because the v5e's scalar shifts were slow; Hopper's funnel shift takes
// each window from the table the pair stages once, which every rung of
// the ladder reads.
//
// What bounds it on an H100: the text steps form one serial chain, each
// step a few hundred instructions that depend on the last step's state,
// so one pair can use one SM at most; the card-wide integer rate is far
// away.  The floor of a design that keeps the pair on one SM is the
// step's instructions over the SM's four schedulers (32 lanes each a
// cycle).  What keeps a step above it is its dependent chain (about 380
// cycles at R = 4): each scheduler holds one warp, so no other warp hides
// a latency, and the add's carry crosses the whole band every step.
//
// Design: one block per pair, one launch per rung, templated on R (the
// ladder doubles R from the hint's band, so any of 1..8 can run) and on
// the form timed best for it (kWarps, kAhead below).  Thread t of the
// block's NT = 32 * WARPS owns band words [t * L, (t + 1) * L),
// L = NW / NT, in registers; with four warps each of the SM's four
// schedulers issues one warp of the band.
// * The add (x & vp) + vp by carry lookahead, not a serial chain: each
//   word's sum is taken with no carry in, so the L adds are independent;
//   word i generates a carry (G bit i) when its add carries out and
//   propagates one (P bit i) when its sum is all ones, and the carry into
//   word i is bit i of ((G | P) + G + cin) ^ (G | P) ^ G.  The same rule
//   over a warp's ballots of its threads' (generate, propagate) bits gives
//   the carry into each lane, and over the four warps' bits the carry into
//   each warp.  d0 is taken under both carries into the thread before the
//   warps meet, and the carry picks one.
// * Across warps: each warp publishes its generate and propagate bits and
//   bit 0 of its lowest x | vn in a shared slot of the step's parity, then
//   one __syncthreads a step.
// * The slide (d0 >> 1 across words) needs bit 0 of the next thread's
//   lowest d0, which is its x | vn bit or'ed with the carry into it: a
//   third ballot of that bit, or the next warp's slot, and the carries
//   already known give it with no shuffle.
// * The window: a thread loads its L + 1 table words (word indices outside
//   [0, ws) read as 0) one to four steps ahead (kAhead) into a rotation of
//   register buffers.  A ring of 4-byte cp.async copies in shared memory,
//   2-8 steps ahead, lost to loading a step ahead into registers: its
//   copies, reads and waits are instructions on a warp that issues alone.
// * The diagonal phase (j < la - K, most steps when K is far under la)
//   runs in whole groups of steps with no test of the phase: its delta is
//   the top bit's, on one thread (a test of the phase every step made a
//   rung 8-25 % slower).
// * The text is read 32 chars at a time, one per lane, each broadcast by
//   __shfl_sync, a block ahead.
// * Only the thread that owns the delta's bit adds it (the word picked by
//   masks, which keeps the word arrays in registers); warp sums and a
//   shared sum end the launch.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// The form of each band size R (index R), chosen by timing the OCR pair at
// every R: warps a pair (at R = 1 one warp of 4 words a lane beat four of
// one word, 14.9 ms against 15.2) and how many steps ahead a thread loads
// its window into registers (three won at R = 2-5 and 7 by 2-14 % over
// one, four at R = 6, one at R = 8 by 4 % over three)
constexpr int kWarps[9] = {0, 1, 4, 4, 4, 4, 4, 4, 4};
constexpr int kAhead[9] = {0, 2, 3, 3, 3, 3, 4, 3, 1};

// A thread's L-bit word masks; L = 32 (one warp at R = 8) needs the 64-bit
// form for the carry out of its top word.
template <int L>
using Mask = typename std::conditional<(L < 32), uint32_t, uint64_t>::type;

// The text's chars in order, 32 at a time, one per lane, the next block
// loaded a block ahead; next() gives the char of step n and moves on.
struct TextStream {
    const int32_t* text;
    int lb, n, chars, ahead;

    __device__ __forceinline__ int load(int i) const {
        return i < lb ? text[i] : 0;
    }
    __device__ __forceinline__ void start(int lane) {
        n = 0;
        chars = load(lane);
        ahead = load(32 + lane);
    }
    __device__ __forceinline__ int next(int lane) {
        const int u = n & 31;
        const int c = __shfl_sync(kFull, chars, u);
        if (u == 31) {
            chars = ahead;
            ahead = load(n + 33 + lane);
        }
        ++n;
        return c;
    }
};

template <int R, int WARPS, int AHEAD>
struct Pair {
    static constexpr int NT = 32 * WARPS;      // threads
    static constexpr int L = 4 * R / WARPS;    // band words a thread
    static constexpr int B = R * 4096;         // band bits

    const uint32_t* pm;
    int ws, K, pstart, tid, lane, warp;
    TextStream ts;
    uint32_t vp[L], vn[L];
    int dist;

    // Loads the window of the next step the text stream gives, table words
    // w0 .. w0 + L of its char's row (w0 = floor(p0 / 32) + tid * L), into
    // y; words outside [0, ws) read as 0.
    __device__ __forceinline__ void fetch(uint32_t (&y)[L + 1]) {
        const int n = ts.n;
        const int w0 = ((n + K + 1 - B) >> 5) + tid * L;
        const uint32_t* row = pm + (size_t)ts.next(lane) * ws + w0;
#pragma unroll
        for (int k = 0; k <= L; ++k)
            y[k] = ((unsigned)(w0 + k) < (unsigned)ws) ? __ldg(row + k) : 0u;
    }

    // One text step j on its window pw.  Every word's sum is taken with no
    // carry in, and d0 under both carries into the thread; the ballots,
    // and across warps the slots, pick one.
    template <bool DIAGONAL>   // true: j < pstart is known
    __device__ __forceinline__ void step(int j, const uint32_t (&pw)[L + 1],
                                         uint4* xch) {
        const unsigned sh = (unsigned)(j + K + 1 - B) & 31u;
        uint32_t x[L], s[L], t[L];
        Mask<L> G = 0, P = 0;
#pragma unroll
        for (int i = 0; i < L; ++i) {
            x[i] = __funnelshift_r(pw[i], pw[i + 1], sh);
            s[i] = (x[i] & vp[i]) + vp[i];
            t[i] = x[i] | vn[i];
            G |= (Mask<L>)(s[i] < vp[i]) << i;
            P |= (Mask<L>)(s[i] == kFull) << i;
        }
        // the thread's generate and propagate bits with no carry in, and
        // bit 0 of its lowest x | vn: bit 0 of its d0 is that bit or'ed
        // with the carry into the thread
        const Mask<L> all =
            (Mask<L>)(~(Mask<L>)0) >> (8 * sizeof(Mask<L>) - L);
        const Mask<L> GP = G | P;
        const unsigned Gw = __ballot_sync(kFull, ((GP + G) >> L) & 1u);
        const unsigned Pw = __ballot_sync(kFull, P == all);
        const unsigned Lw = __ballot_sync(kFull, t[0] & 1u);
        const unsigned GPw = Gw | Pw;
        // bit l: the carry into lane l when none enters the warp (C0) and
        // when one does (C1); d0 under no carry into this thread (d0a) and
        // under one (d0b)
        const unsigned C0 = (GPw + Gw) ^ GPw ^ Gw;
        const unsigned C1 = (GPw + Gw + 1u) ^ GPw ^ Gw;
        const Mask<L> ca = (GP + G) ^ GP ^ G;
        const Mask<L> cb = (GP + G + 1u) ^ GP ^ G;
        uint32_t d0a[L], d0b[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
            d0a[i] = ((s[i] + (uint32_t)((ca >> i) & 1u)) ^ vp[i]) | t[i];
            d0b[i] = ((s[i] + (uint32_t)((cb >> i) & 1u)) ^ vp[i]) | t[i];
        }
        unsigned Cw = C0, slide = 0u;
        if constexpr (WARPS > 1) {
            // the warp's generate and propagate bits and bit 0 of its
            // lowest x | vn, published for the other warps
            const unsigned g = (GPw + Gw) < GPw;
            const unsigned p = Pw == kFull;
            reinterpret_cast<unsigned*>(&xch[j & 1])[warp] =
                (g | (p << 8) | ((Lw & 1u) << 16)) << warp;
            __syncthreads();
            const uint4 v4 = xch[j & 1];
            const unsigned v = v4.x | v4.y | v4.z | v4.w;
            const unsigned G4 = v & 15u, P4 = (v >> 8) & 15u;
            // bit w: the carry into warp w; the slide bit into warp w is
            // bit 0 of warp w + 1's d0: its x | vn or its carry in
            const unsigned C4 = ((G4 | P4) + G4) ^ (G4 | P4) ^ G4;
            Cw = ((C4 >> warp) & 1u) ? C1 : C0;
            slide = ((((v >> 16) | C4) & 15u) >> (warp + 1)) & 1u;
        }
        const bool cl = (Cw >> lane) & 1u;
        // the slide: bit 0 of the next lane's d0, or the next warp's
        const uint32_t next =
            lane < 31 ? ((Cw | Lw) >> (lane + 1)) & 1u : slide;

        uint32_t d0[L], hp[L], hn[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
            d0[i] = cl ? d0b[i] : d0a[i];
            hp[i] = vn[i] | ~(d0[i] | vp[i]);
            hn[i] = d0[i] & vp[i];
        }
        if (DIAGONAL || j < pstart) {                 // diagonal phase
            if (tid == NT - 1) dist += 1 - (int)(d0[L - 1] >> 31);
        } else {                                      // horizontal phase
            const int hb = max(B - 2 - (j - pstart), 0);
            const int wi = (hb >> 5) - tid * L;       // in this thread
            if ((unsigned)wi < (unsigned)L) {
                uint32_t hpw = 0u, hnw = 0u;
#pragma unroll
                for (int i = 0; i < L; ++i) {
                    const uint32_t m = 0u - (uint32_t)(i == wi);
                    hpw |= hp[i] & m;
                    hnw |= hn[i] & m;
                }
                dist += (int)((hpw >> (hb & 31)) & 1u)
                      - (int)((hnw >> (hb & 31)) & 1u);
            }
        }
#pragma unroll
        for (int i = 0; i < L; ++i) {
            const uint32_t d0s =
                __funnelshift_r(d0[i], (i + 1 < L) ? d0[i + 1] : next, 1);
            vp[i] = hn[i] | ~(d0s | hp[i]);
            vn[i] = d0s & hp[i];
        }
    }
};

template <int R, int WARPS, int AHEAD>
__global__ void __launch_bounds__(32 * WARPS, 1)
lev_pair_kernel(const uint32_t* __restrict__ pm, int ws,
                const int32_t* __restrict__ text, int la, int lb, int K,
                int32_t* __restrict__ out) {
    using P = Pair<R, WARPS, AHEAD>;
    constexpr int L = P::L, NB = AHEAD + 1;
    __shared__ uint4 xch[2];
    __shared__ int part[WARPS];

    P p;
    p.pm = pm;
    p.ws = ws;
    p.K = K;
    p.pstart = la - K;
    p.tid = threadIdx.x;
    p.lane = threadIdx.x & 31;
    p.warp = threadIdx.x >> 5;
    p.ts.text = text;
    p.ts.lb = lb;
    p.ts.start(p.lane);
    const int lo = P::B - 1 - K;        // VP: band bits >= lo set
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int bit0 = 32 * (p.tid * L + i);
        p.vp[i] = (bit0 >= lo) ? kFull
                : (bit0 + 31 < lo) ? 0u : (kFull << (lo - bit0));
        p.vn[i] = 0u;
    }
    p.dist = 0;

    // NB window buffers: step j reads buffer j % NB and, first, loads the
    // window of step j + AHEAD into buffer (j + AHEAD) % NB; NB steps an
    // iteration, so the buffers rotate with no copy
    uint32_t buf[NB][L + 1];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) p.fetch(buf[k]);
    // the diagonal phase's whole iterations with no test of the phase,
    // then the rest
    const int jd = min(la - K, lb);
    int j = 0;
    for (; j + NB <= jd; j += NB) {
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            p.fetch(buf[(k + AHEAD) % NB]);
            p.template step<true>(j + k, buf[k], xch);
        }
    }
    for (; j < lb; j += NB) {
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            if (j + k < lb) {
                p.fetch(buf[(k + AHEAD) % NB]);
                p.template step<false>(j + k, buf[k], xch);
            }
        }
    }
    const int dist = __reduce_add_sync(kFull, p.dist);
    if constexpr (WARPS == 1) {
        if (p.lane == 0) out[0] = K + dist;
    } else {
        if (p.lane == 0) part[p.warp] = dist;
        __syncthreads();
        if (p.tid == 0) {
            int total = 0;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) total += part[w];
            out[0] = K + total;
        }
    }
}

template <int R>
cudaError_t launch_pair(const uint32_t* pm, int ws, const int32_t* text,
                        int la, int lb, int K, int32_t* out,
                        cudaStream_t stream) {
    constexpr int W = kWarps[R], A = kAhead[R];
    lev_pair_kernel<R, W, A><<<1, 32 * W, 0, stream>>>(pm, ws, text, la, lb,
                                                       K, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lev_pair(const uint32_t* pm, int ws,
                                   const int32_t* text, int la, int lb,
                                   int K, int R, int32_t* out,
                                   cudaStream_t stream) {
    // the band certifies K <= R * 2048 - 1; the pattern holds K + 1 chars
    if (lb < 1 || K < 0 || K >= la || K > R * 2048 - 1
            || ws < (la + 31) / 32)
        return cudaErrorInvalidValue;
    switch (R) {
        case 1: return launch_pair<1>(pm, ws, text, la, lb, K, out, stream);
        case 2: return launch_pair<2>(pm, ws, text, la, lb, K, out, stream);
        case 3: return launch_pair<3>(pm, ws, text, la, lb, K, out, stream);
        case 4: return launch_pair<4>(pm, ws, text, la, lb, K, out, stream);
        case 5: return launch_pair<5>(pm, ws, text, la, lb, K, out, stream);
        case 6: return launch_pair<6>(pm, ws, text, la, lb, K, out, stream);
        case 7: return launch_pair<7>(pm, ws, text, la, lb, K, out, stream);
        case 8: return launch_pair<8>(pm, ws, text, la, lb, K, out, stream);
        default: return cudaErrorInvalidValue;
    }
}
