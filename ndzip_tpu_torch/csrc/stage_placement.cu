// Stage kernels of the fp32 1D encoder's placement pass, for Hopper (sm_90a):
// the pass with its compute taken out (placement_floor) and the pass with
// its compaction taken out (placement_compute).
//
// Replaces the TPU probe dev/enc_floor_probe.py:100 (the pallas_call of
// build(mode).run, kernel make_kernel(mode) at :56-93), which times B1's
// grid, DMAs and staging with parts of its compute removed. What the probe
// computes is ported, not its DMA schedule: its staging buffer goes out whole
// at an offset that advances by 2/3 of it, so the windows of consecutive
// steps overlap by design; CTAs that wrote overlapping windows would race,
// so here every CTA writes its own disjoint range:
//   * placement_floor: CTA b stages block b in shared memory as B1's
//     placement pass does, then writes the first K = 2 * 4224 / 3 = 2816
//     words of [words[b, :128] ^ b, words[b, :]] to out[b*K, (b+1)*K): a
//     block read, 2/3 of its dense size written (the traffic of a placement
//     pass at 66% occupancy), no compute.
//   * placement_compute: CTA b writes block b's dense row of 4224 words to
//     out[b*4224, (b+1)*4224): the 128 chunk heads, then the 4096
//     bit-transposed words of the 1D-transformed block, zeros kept
//     (golden.encode_blocks_dense). B1's placement pass without the header
//     read, the scan of the chunk counts and the compaction; the load,
//     transform and transpose are common.cuh's (load_transform_1d,
//     warp_transpose_bits), as B1 ran them before it took its block by a
//     bulk copy (encode_fp32.cu).
// The probe's "dbuf" mode, its staging double-buffered so one step's output
// DMA overlaps the next step's compute, has no kernel here: several CTAs are
// resident on an SM and overlap one another's loads and stores without code.
//
// Bound: bytes. Per block, floor reads 16 KiB and writes 11 KiB; compute
// reads 16 KiB and writes 16.5 KiB, with B1's per-word arithmetic (a handful
// of integer ops, five shuffles per chunk, one ballot). Both move 16-byte
// words on the load and warp-wide 128 B runs on the store; offsets are
// 64-bit.

#include "common.cuh"

namespace ndzip {

constexpr int kDense = kChunks + kHcSize;   // a block's dense row: heads, then words
constexpr int kFloor = 2 * kDense / 3;      // the floor's words written per block

static_assert(kFloor % 4 == 0 && kChunks % 4 == 0, "the floor stores 16-byte words");

__global__ void __launch_bounds__(kThreads)
placement_floor(const uint32_t* __restrict__ words, uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t x[kHcSize];
    const uint64_t b = blockIdx.x;
    const int t = threadIdx.x;
    const uint4* src = reinterpret_cast<const uint4*>(words + b * kHcSize);
    uint4* s = reinterpret_cast<uint4*>(x);
#pragma unroll
    for (int k = 0; k < kHcSize / 4 / kThreads; ++k) s[t + k * kThreads] = src[t + k * kThreads];
    __syncthreads();

    uint4* dst = reinterpret_cast<uint4*>(out + b * kFloor);
    const uint32_t step = static_cast<uint32_t>(b);
    for (int q = t; q < kFloor / 4; q += kThreads) {
        if (q < kChunks / 4) {
            const uint4 v = s[q];
            dst[q] = make_uint4(v.x ^ step, v.y ^ step, v.z ^ step, v.w ^ step);
        } else {
            dst[q] = s[q - kChunks / 4];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
placement_compute(const uint32_t* __restrict__ words, uint32_t* __restrict__ out) {
    __shared__ EncodeShared s;
    const uint64_t b = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    load_transform_1d(words + b * kHcSize, s.x);

    uint32_t* dense = out + b * kDense;
#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const int c = warp * kChunksPerWarp + k;
        const uint32_t v = warp_transpose_bits(s.x[pad(32 * c + lane)], lane);
        const uint32_t nz = __ballot_sync(kFull, v != 0);
        if (lane == 0) s.heads[c] = __brev(nz);  // head bit (31-i) <=> word i != 0
        dense[kChunks + 32 * c + lane] = v;
    }
    __syncthreads();
    if (t < kChunks) dense[t] = s.heads[t];
}

}  // namespace ndzip

// words: num_hc >= 1 blocks of 4096 words, 16-byte aligned. out: num_hc *
// 2816 words (floor) or num_hc * 4224 words (compute), 16-byte aligned.
// Launch on the current device; return the CUDA error of the launch, 0 if
// none.
extern "C" int ndzip_placement_floor(const void* words, int64_t num_hc, void* out, void* cuda_stream) {
    using namespace ndzip;
    placement_floor<<<static_cast<unsigned>(num_hc), kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out));
    return cudaGetLastError();
}

extern "C" int ndzip_placement_compute(const void* words, int64_t num_hc, void* out, void* cuda_stream) {
    using namespace ndzip;
    placement_compute<<<static_cast<unsigned>(num_hc), kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out));
    return cudaGetLastError();
}
