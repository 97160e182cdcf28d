// K2: remap a wide-alphabet corpus to query-local ids and byte-pack it.
//
// Replaces the TPU kernel
// rapidfuzz_tpu/ops/pallas/lev_kernel.py:_remap_kernel (remap_pack).
//
// What bounds it on an H100: memory.  Each output u32 costs 16 bytes read
// (4 int32 chars) and 4 written, against 7 shared-memory probes and ~30
// integer ops per char, so the kernel sits near the HBM roofline.
//
// Design: one thread per (candidate, group of 4 text positions); threads
// of a warp take neighbouring candidates of one group, so each of the 4
// char loads of the transposed [LB, B] corpus and the packed store to
// [LB/4, B] are coalesced.  The query's sorted 128-entry vocab (padded
// with int32 max) sits in shared memory; each char runs the same 7-step
// branchless lower bound as the TPU kernel.  pos reaches at most 127, so
// a char above the whole vocab fails the hit probe on entry 127 and
// misses, like every other absent char, to MISS_ID 127 (whose PM row is
// zero for queries of at most 127 distinct symbols).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVocab = 128;
constexpr uint32_t kMissId = 127u;

__device__ __forceinline__ uint32_t lookup(const int32_t* vocab, int32_t c) {
    int pos = 0;
#pragma unroll
    for (int k = 64; k >= 1; k >>= 1)
        pos = (vocab[pos + k - 1] < c) ? pos + k : pos;
    return (vocab[pos] == c) ? (uint32_t)pos : kMissId;
}

__global__ void __launch_bounds__(kThreads)
remap_pack_kernel(const int32_t* __restrict__ chars_t,
                  const int32_t* __restrict__ vocab_g,
                  uint32_t* __restrict__ out, int64_t B, int lb4) {
    __shared__ int32_t vocab[kVocab];
    if (threadIdx.x < kVocab) vocab[threadIdx.x] = vocab_g[threadIdx.x];
    __syncthreads();
    const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (b >= B) return;
    // packed row g holds text positions 4g .. 4g+3; grid.y is capped at
    // 65,535, so blocks stride over the rows of buckets past 262,140 chars
    for (size_t g = blockIdx.y; g < (size_t)lb4; g += gridDim.y) {
        const int32_t* src = chars_t + 4 * g * B + b;
        uint32_t w = 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u)
            w |= lookup(vocab, src[(size_t)u * B]) << (8 * u);
        out[g * B + b] = w;
    }
}

}  // namespace

extern "C" cudaError_t rf_remap_pack(const int32_t* chars_t,
                                     const int32_t* vocab, uint32_t* out,
                                     int64_t B, int lb4,
                                     cudaStream_t stream) {
    const dim3 grid((unsigned)((B + kThreads - 1) / kThreads),
                    (unsigned)(lb4 < 65535 ? lb4 : 65535));
    remap_pack_kernel<<<grid, kThreads, 0, stream>>>(chars_t, vocab, out, B,
                                                     lb4);
    return cudaGetLastError();
}
