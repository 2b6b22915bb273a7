// fp64 1D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp64 in
// flat mode, launched by _decode_blocks_fp64, together with the border glue
// of _decode_fp64_device.
//
// The TPU kernel fetches a fixed window of interleaved u32 rows per block,
// splits it into (lo, hi) planes, and re-expands it with one-hot matmuls.
// Here the stream is read as u64 words, and a block's words are taken as what
// they are: one contiguous run of the stream, [start, start + length) with
// start = hw + header[b-1] and length = header[b] - header[b-1] in u64 words,
// known from two header words.
//   * One CTA decodes one block. Its thread 0 reads the two header words and
//     starts one bulk copy of the run into shared memory (cp.async.bulk,
//     completing on an mbarrier; common64.cuh's start_run_copy64): the block
//     waits on one copy, not on three rounds of dependent loads.
//   * The heads and the rank gather read shared memory (expand_run64): each
//     warp finds where its 8 chunks start from a warp scan of the heads'
//     popcounts, gathers their words, 16 a lane, into registers, and after a
//     barrier transposes them (TransposeLane64, four 32-bit transposes) into
//     the same buffer, now the padded block.
//   * The CTA runs the inverse transform (complement, wrapping prefix sum over
//     the 4096 words, 16 a thread, a warp scan and a carry, rotate right) and
//     stores the block at out[b*4096 ..), the 1D output order itself, with
//     16-byte stores.
//   * A damaged or truncated stream cannot fault: the run is clamped to
//     64 .. 4160 words and to the stream's size, what lies past it reads as 0,
//     and the copy's window never leaves [0, size).
//   * The CTAs after the blocks copy the border tail.
// The run and the block share one buffer, 35 KB a CTA. The 16 words a lane
// holds across the barrier and the 64-bit scan need 64 registers, so four
// CTAs share an SM, not the six that the shared memory allows: bound to five
// (48 registers) the kernel spilled 16 bytes a thread, and to six (40) 100,
// and both ran slower. A run buffer beside the block (68 KB, three CTAs an
// SM) took 4% more time with the same gather and 8% more gathering chunk by
// chunk (at 2^27 + 17 elements on an NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6). CTAs are not persistent: a persistent fp32 2D/3D decoder
// spilled its loop's state under its register bound and took 2.5 times as
// long (PERF.md §6).
//
// Bound: bytes. Each element reads 8 B x ratio of stream and writes 8 B of
// output; per element the work is that of the fp32 decoder on twice the
// bytes. Element and stream offsets are 64-bit.

#include "common64.cuh"

namespace ndzip {

struct DecodeShared64 {
    alignas(16) u64 x[kPadded64];  // the block's run as the copy brings it in, then the block
    u64 partial[kWarps];           // the prefix sum's per-warp sums
    uint64_t full;                 // mbarrier: the run has arrived
    RunView64 run;
};

__global__ void __launch_bounds__(kThreads, 4)
decode_blocks64(const uint32_t* __restrict__ stream, uint64_t size, uint64_t num_hc, Border border,
                u64* __restrict__ out) {
    const uint64_t b = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (b >= num_hc) {  // a border CTA
        decode_border64(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ DecodeShared64 s;
    if (t == 0) {  // the header lies inside the stream
        mbarrier_init(&s.full, 1);
        mbarrier_init_fence();
        start_run_copy64(stream, size, num_hc, b ? stream[b - 1] : 0u, stream[b], s.x, s.run, &s.full);
    }
    __syncthreads();
    mbarrier_wait(&s.full, 0);
    expand_run64(s.x, s.run);

    // inverse transform: complement, wrapping inclusive prefix sum, rotate right
    u64* seg_slots = s.x + pad64(kWordsPerThread * t);  // a thread's 16 words lie side by side
    u64 seg[kWordsPerThread];
    u64 sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        sum += complement_negative(seg_slots[k]);
        seg[k] = sum;
    }
    const u64 incl = warp_inclusive_scan64(sum, lane);
    if (lane == 31) s.partial[warp] = incl;
    __syncthreads();
    u64 carry = incl - sum;
    for (int w = 0; w < warp; ++w) carry += s.partial[w];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) seg_slots[k] = rotr1(seg[k] + carry);
    __syncthreads();

    ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + b * kHcSize);
#pragma unroll
    for (int k = 0; k < kHcSize / 2 / kThreads; ++k) {
        const int q = t + k * kThreads;
        dst[q] = make_ulonglong2(s.x[pad64(2 * q)], s.x[pad64(2 * q + 1)]);
    }
}

}  // namespace ndzip

// stream: `size` u32 words (even), header from word 0, 8-byte aligned. out:
// num_hc * 4096 + border u64 words, 16-byte aligned. num_hc >= 1. Launches on
// the current device. Returns the CUDA error of the launch, 0 if none.
extern "C" int ndzip_decode_fp64(const void* stream, int64_t size, int64_t num_hc, int64_t border,
                                 void* out, void* cuda_stream) {
    using namespace ndzip;
    const auto n = static_cast<uint64_t>(num_hc), covered = n * kHcSize;
    const auto count = static_cast<uint64_t>(border);
    const Border tail{1, covered + count, 1, 1, covered, count};  // three-axis view (1, 1, n)
    const auto grid = static_cast<unsigned>(num_hc + border_ctas(count));
    decode_blocks64<<<grid, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(stream), static_cast<uint64_t>(size), n, tail,
        static_cast<u64*>(out));
    return cudaGetLastError();
}

// CTAs of decode_blocks64 that one SM holds at a time, or minus the CUDA error.
extern "C" int ndzip_decode_fp64_ctas_per_sm() {
    int ctas = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, ndzip::decode_blocks64,
                                                                          ndzip::kThreads, 0);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
}
