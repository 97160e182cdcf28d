// K11: banded uniform Levenshtein of ONE long pair.
//
// Replaces rapidfuzz_tpu/ops/pallas/pair_kernel.py: _kernel (_run).  The
// pattern (the longer string, la chars) sits in a PM table of [V, ws] u32
// words over the pair's local vocabulary (ws = ceil(la / 32) rounded up to
// a multiple of 4, the words past the pattern 0), the text (the shorter
// string, lb chars) is a [lb] int32 array of local ids.  A band of
// B = R * 4096 bits (NW = R * 128 words, R in 1..8) slides one bit per
// text char: at text step j, band bit k stands for pattern position
// j + K + 1 - B + k.  VP starts with its top K + 1 bits set, VN at 0, the
// distance at K.  Each step:
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
// What bounds it on an H100: the serial chain of text steps, each a few
// hundred instructions of one warp that depend on the last step's state.
// The card-wide integer rate is far away: one warp issues at most one
// instruction a cycle, on one of the 132 SMs' four schedulers, so the
// floor of this design is the step's instructions over one warp's issue
// rate, and the dependent chains within a step keep it above that.
//
// Design: one warp per pair, one launch per rung, templated on R (the
// ladder doubles R from the hint's band, so any of 1..8 can run).  Lane l
// owns band words [l * L, (l + 1) * L), L = 4 * R, in registers.
// * The add runs with a serial carry over each lane's words.  The carry
//   between lanes comes from two ballots: lane l generates a carry (g) or
//   propagates one (p: its sum is all ones; g and p exclude each other),
//   and with G, P the ballots the carry into lane l is bit l of
//   ((G | P) + G) ^ (G | P) ^ G.  Inside the lane the same rule on the
//   mask of its all-ones words hands that carry to words 0..t at once, t
//   the first word that is not all ones.
// * The slide takes the next lane's first d0 word by __shfl_down_sync.
// * The window: a lane's L + 1 table words start at the same offset mod 4
//   in every lane, so it loads the aligned L + 4 words around them as 16-
//   byte quads (a per-word load across lanes L words apart touched up to
//   32 cache lines an instruction) and selects the offset by a warp-
//   uniform switch; only steps whose window leaves the table load word by
//   word with a bounds test.  The next step's window is loaded before the
//   current step's arithmetic, into the other of two register buffers
//   (two steps an iteration, so the buffers swap with no copy).
// * The text is read 32 chars at a time, one per lane, each broadcast by
//   __shfl_sync.
// * Only the lane that owns the delta's bit adds it (the word picked by
//   masks, which keeps the word arrays in registers); a warp sum ends the
//   launch.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// A lane's L-bit word masks; L = 32 at R = 8 needs the 64-bit form for the
// carry out of its top word.
template <int L>
using Mask = typename std::conditional<(L < 32), uint32_t, uint64_t>::type;

// The table words of this lane's window for the step whose band starts
// at pattern position p0: words s .. s + L, s = floor(p0 / 32) + L * lane
// (its first band bit stands for position p0 + 32 * L * lane), held as the
// L + 4 words from a = s - (s mod 4), so that they load as L / 4 + 1
// aligned 16-byte quads (rows of ws words, ws a multiple of 4); s mod 4 is
// the same in every lane.  CHECK loads word by word and reads a word
// outside [0, ws) as 0; the caller drops it when the whole warp's window
// lies in the table.
template <int L, bool CHECK>
__device__ __forceinline__ void load_window(const uint32_t* __restrict__ pm,
                                            int ws, int c, int p0, int lane,
                                            uint32_t (&w)[L + 4]) {
    const int a = ((p0 >> 5) + L * lane) & ~3;   // floor to a quad
    const uint32_t* row = pm + (size_t)c * ws;
    if (CHECK) {
#pragma unroll
        for (int k = 0; k < L + 4; ++k)
            w[k] = ((unsigned)(a + k) < (unsigned)ws) ? __ldg(row + a + k)
                                                      : 0u;
    } else {
        const uint4* q = reinterpret_cast<const uint4*>(row + a);
#pragma unroll
        for (int k = 0; k <= L / 4; ++k) {
            const uint4 v = __ldg(q + k);
            w[4 * k] = v.x;
            w[4 * k + 1] = v.y;
            w[4 * k + 2] = v.z;
            w[4 * k + 3] = v.w;
        }
    }
}

// The step's band words x from its window: word i joins window words
// O + i and O + i + 1 (O = s mod 4) with a funnel shift.
template <int L, int O>
__device__ __forceinline__ void band_words(const uint32_t (&w)[L + 4],
                                           unsigned sh, uint32_t (&x)[L]) {
#pragma unroll
    for (int i = 0; i < L; ++i)
        x[i] = __funnelshift_r(w[O + i], w[O + i + 1], sh);
}

template <int L>
struct Pair {
    uint32_t vp[L], vn[L];
    int dist;
};

// One text step j on the window pw; it first loads the next step's window
// (char cn) into pn, so that its latency overlaps this step's arithmetic.
template <int L, int B>
__device__ __forceinline__ void pair_step(
        const uint32_t* __restrict__ pm, int ws, int j, int K, int pstart,
        int cn, int lane, const uint32_t (&pw)[L + 4], uint32_t (&pn)[L + 4],
        Pair<L>& st) {
    const int p0 = j + K + 1 - B;                 // this step's band start
    const int p1 = p0 + 1;
    if (p1 >= 0 && ((p1 >> 5) & ~3) + 32 * L + 3 < ws)   // in the table
        load_window<L, false>(pm, ws, cn, p1, lane, pn);
    else
        load_window<L, true>(pm, ws, cn, p1, lane, pn);

    // the window: the same word offset and bit shift in every lane
    const unsigned sh = (unsigned)p0 & 31u;
    uint32_t x[L];
    switch ((p0 >> 5) & 3) {
        case 0: band_words<L, 0>(pw, sh, x); break;
        case 1: band_words<L, 1>(pw, sh, x); break;
        case 2: band_words<L, 2>(pw, sh, x); break;
        default: band_words<L, 3>(pw, sh, x); break;
    }
    // the add (x & vp) + vp: the lane's words with a serial carry, then
    // the carry into the lane from the ballots of the lanes that generate
    // one (g) and propagate one (p: every word all ones)
    uint32_t s[L];
    uint32_t carry = 0u;
    Mask<L> ones = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const uint64_t t = (uint64_t)(x[i] & st.vp[i]) + st.vp[i] + carry;
        s[i] = (uint32_t)t;
        carry = (uint32_t)(t >> 32);
        ones |= (Mask<L>)(s[i] == kFull) << i;
    }
    const Mask<L> all = (Mask<L>)(~(Mask<L>)0) >> (8 * sizeof(Mask<L>) - L);
    const unsigned G = __ballot_sync(kFull, carry != 0u);
    const unsigned GP = G | __ballot_sync(kFull, ones == all);
    const Mask<L> cin = (((GP + G) ^ GP ^ G) >> lane) & 1u;
    // word i takes the lane's carry when words 0..i-1 are all ones: bits
    // 0..t of (ones + 1) ^ ones, t the first word that is not
    const Mask<L> cw = (ones + cin) ^ ones;

    // d0, hp, hn; the delta; the slide and the new vp, vn
    uint32_t d0[L], hp[L], hn[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const uint32_t si = s[i] + (uint32_t)((cw >> i) & 1u);
        d0[i] = (si ^ st.vp[i]) | x[i] | st.vn[i];
        hp[i] = st.vn[i] | ~(d0[i] | st.vp[i]);
        hn[i] = d0[i] & st.vp[i];
    }
    if (j < pstart) {                             // diagonal phase
        if (lane == 31) st.dist += 1 - (int)(d0[L - 1] >> 31);
    } else {                                      // horizontal phase
        const int hb = max(B - 2 - (j - pstart), 0);
        const int wi = (hb >> 5) - lane * L;      // in this lane: [0, L)
        uint32_t hpw = 0u, hnw = 0u;
#pragma unroll
        for (int i = 0; i < L; ++i) {
            const uint32_t m = 0u - (uint32_t)(i == wi);
            hpw |= hp[i] & m;
            hnw |= hn[i] & m;
        }
        st.dist += (int)((hpw >> (hb & 31)) & 1u)
                 - (int)((hnw >> (hb & 31)) & 1u);
    }
    uint32_t next = __shfl_down_sync(kFull, d0[0], 1);
    if (lane == 31) next = 0u;
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const uint32_t d0s =
            __funnelshift_r(d0[i], (i + 1 < L) ? d0[i + 1] : next, 1);
        st.vp[i] = hn[i] | ~(d0s | hp[i]);
        st.vn[i] = d0s & hp[i];
    }
}

template <int R>
__global__ void __launch_bounds__(32)
lev_pair_kernel(const uint32_t* __restrict__ pm, int ws,
                const int32_t* __restrict__ text, int la, int lb, int K,
                int32_t* __restrict__ out) {
    constexpr int L = 4 * R;            // band words per lane
    constexpr int B = R * 4096;         // band bits
    const int lane = threadIdx.x;

    Pair<L> st;
    const int lo = B - 1 - K;           // VP: band bits >= lo set
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int bit0 = 32 * (lane * L + i);
        st.vp[i] = (bit0 >= lo) ? kFull
                 : (bit0 + 31 < lo) ? 0u : (kFull << (lo - bit0));
        st.vn[i] = 0u;
    }
    st.dist = 0;
    const int pstart = la - K;

    // the text 32 chars at a time, one per lane: chars holds the block of
    // step j, ahead the next block, loaded a block ahead
    int chars = (lane < lb) ? text[lane] : 0;
    int ahead = (32 + lane < lb) ? text[32 + lane] : 0;
    uint32_t pa[L + 4], pb[L + 4];
    load_window<L, true>(pm, ws, __shfl_sync(kFull, chars, 0), K + 1 - B,
                         lane, pa);
    // two steps an iteration, so the windows alternate between pa and pb
    // with no copy; the text's next char is the shuffle of lane u + 1
    for (int j = 0; j < lb; j += 2) {
        int u = j & 31;
        int cn = __shfl_sync(kFull, chars, u + 1);
        pair_step<L, B>(pm, ws, j, K, pstart, cn, lane, pa, pb, st);
        if (j + 1 == lb) break;
        u = (j + 1) & 31;
        cn = __shfl_sync(kFull, u == 31 ? ahead : chars, (u + 1) & 31);
        pair_step<L, B>(pm, ws, j + 1, K, pstart, cn, lane, pb, pa, st);
        if (u == 31) {
            chars = ahead;
            ahead = (j + 34 + lane < lb) ? text[j + 34 + lane] : 0;
        }
    }
    const int dist = __reduce_add_sync(kFull, st.dist);
    if (lane == 0) out[0] = K + dist;
}

template <int R>
cudaError_t launch_pair(const uint32_t* pm, int ws, const int32_t* text,
                        int la, int lb, int K, int32_t* out,
                        cudaStream_t stream) {
    lev_pair_kernel<R><<<1, 32, 0, stream>>>(pm, ws, text, la, lb, K, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t rf_lev_pair(const uint32_t* pm, int ws,
                                   const int32_t* text, int la, int lb,
                                   int K, int R, int32_t* out,
                                   cudaStream_t stream) {
    // the band certifies K <= R * 2048 - 1; the pattern holds K + 1 chars;
    // rows of ws words, a multiple of 4 from a 16-byte-aligned table
    if (lb < 1 || K < 0 || K >= la || K > R * 2048 - 1 || ws % 4 != 0
            || ws < (la + 31) / 32 || (reinterpret_cast<uintptr_t>(pm) & 15))
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
