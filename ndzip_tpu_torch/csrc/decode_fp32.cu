// fp32 1D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp32 in
// flat mode, launched by _decode_blocks_fp32, together with the border glue
// of _decode_fp32_device.
//
// The TPU kernel fetches a fixed 34-row window per block and re-expands it
// with one-hot matmuls, so its stream must be zero-padded past the end. Here
// a block's words are taken as what they are: one contiguous run of the
// stream, [start, start + length) with start = num_hc + header[b-1] and
// length = header[b] - header[b-1], known from two header words.
//   * CTAs are persistent, a few an SM, each walking blocks b, b + grid, ...
//     One thread starts the bulk copy (cp.async.bulk, completing on an
//     mbarrier) of the next block's run into shared memory as soon as this
//     block's run is expanded, so it comes in while this block is summed and
//     stored; the two header words it needs were loaded a block earlier. A
//     block waits on one copy, not on three rounds of dependent loads.
//   * The heads and the rank gather read shared memory (common.cuh's
//     start_run_copy and expand_run), each warp expands and transposes its
//     chunks with the cheap transpose, and the CTA runs the inverse transform
//     (complement, wrapping prefix sum over the 4096 words, rotate right)
//     before storing the block at out[b*4096 ..) with 16-byte stores.
//   * A run starts at any word and the stream itself may be a slice at any
//     word: the copy takes the 16-byte aligned window around the run and
//     never leaves [0, size). A damaged or truncated stream cannot fault: the
//     run is clamped to 128 .. 4224 words and to the stream's size, and what
//     lies past it reads as 0.
//   * One more CTA copies the border tail from num_hc + header[num_hc-1].
//
// Bound: bytes. Each element reads 4 B x ratio of stream and writes 4 B of
// output; the arithmetic per word is a handful of integer ops and five warp
// shuffles per chunk, which together keep the SMs' schedulers about as busy
// as the bytes keep the memory (so the kernel uses common.cuh's 13-instruction
// transpose). The run buffer and the block take 34 KB of shared memory a CTA,
// six CTAs an SM: a second run buffer (51 KB, four CTAs an SM) was measured
// and lost 4-7% to this (at 2^24 and 2^28 + 17 elements on an NVIDIA H100 80GB
// HBM3, 700.00 W). Element and stream offsets are 64-bit.

#include "common.cuh"

namespace ndzip {

struct DecodeRunShared {
    RunBuffer run;
    uint64_t full;  // mbarrier: the run has arrived
    uint32_t x[kPadded];
    uint32_t partial[kWarps];  // the prefix sum's per-warp sums
};

__global__ void __launch_bounds__(kThreads)
decode_blocks(const uint32_t* __restrict__ stream, uint64_t size, uint64_t num_hc, uint64_t block_ctas,
              Border border, uint32_t* __restrict__ out) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (blockIdx.x >= block_ctas) {  // the border CTA
        decode_border(stream, size, num_hc, border, blockIdx.x - block_ctas, out);
        return;
    }

    __shared__ DecodeRunShared s;

    // thread 0 is the producer: h0, h1 are the header words of the next block to copy
    uint64_t next = blockIdx.x;
    uint32_t h0 = 0, h1 = 0;
    if (t == 0) {
        mbarrier_init(&s.full, 1);
        mbarrier_init_fence();
        start_run_copy(stream, size, num_hc, next ? stream[next - 1] : 0u, stream[next], s.run, &s.full);
        next += block_ctas;
        if (next < num_hc) {
            h0 = stream[next - 1];
            h1 = stream[next];
        }
    }
    __syncthreads();

    uint32_t* seg_slots = s.x + pad(kWordsPerThread * t);  // a thread's 16 words of the scans lie side by side
    uint32_t* quad_slots = s.x + pad(4 * t);               // the 4 words of its first 16-byte store
    uint32_t parity = 0;
    for (uint64_t b = blockIdx.x; b < num_hc; b += block_ctas, parity ^= 1) {
        mbarrier_wait(&s.full, parity);
        expand_run(s.run, s.x);
        if (t == 0 && next < num_hc) {
            // the expansion, the run's only reader, ended with a barrier: the next block's run
            // comes in while this block is summed and stored
            start_run_copy(stream, size, num_hc, h0, h1, s.run, &s.full);
            next += block_ctas;
            if (next < num_hc) {  // loaded now, used a block later
                h0 = stream[next - 1];
                h1 = stream[next];
            }
        }

        // inverse transform: complement, wrapping inclusive prefix sum, rotate right
        uint32_t seg[kWordsPerThread];
        uint32_t sum = 0;
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) {
            sum += complement_negative(seg_slots[k]);
            seg[k] = sum;
        }
        const uint32_t incl = warp_inclusive_scan(sum, lane);
        if (lane == 31) s.partial[warp] = incl;
        __syncthreads();
        uint32_t carry = incl - sum;
        for (int w = 0; w < warp; ++w) carry += s.partial[w];
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) seg_slots[k] = rotr1(seg[k] + carry);
        __syncthreads();

        uint4* dst = reinterpret_cast<uint4*>(out + b * kHcSize);
#pragma unroll
        for (int k = 0; k < kHcSize / 4 / kThreads; ++k) {
            const uint32_t* q = quad_slots + k * (4 * kThreads + 4 * kThreads / 32);
            dst[t + k * kThreads] = make_uint4(q[0], q[1], q[2], q[3]);
        }
        // the stores above read words of x that other threads wrote; the next block's
        // expand_run writes x, and the wait on its run's copy does not hold any thread back
        __syncthreads();
    }
}

// The current device's SMs and the CTAs of decode_blocks that one SM holds.
// Returns the first CUDA error, 0 if none.
static cudaError_t decode_residency(int* sms, int* ctas_per_sm) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, decode_blocks, kThreads, 0);
    if (err != cudaSuccess) return err;
    return *ctas_per_sm < 1 ? cudaErrorLaunchOutOfResources : cudaSuccess;
}

}  // namespace ndzip

// stream: `size` words at any 4-byte aligned address, header from word 0,
// size >= num_hc. out: num_hc * 4096 + border words, 16-byte aligned.
// num_hc >= 1, border < 4096. Launches on the current device. Returns the
// first CUDA error (of the residency query or the launch), 0 if none.
extern "C" int ndzip_decode_fp32(const void* stream, int64_t size, int64_t num_hc, int64_t border,
                                 void* out, void* cuda_stream) {
    using namespace ndzip;
    int sms = 0, ctas_per_sm = 0;
    const cudaError_t err = decode_residency(&sms, &ctas_per_sm);
    if (err != cudaSuccess) return err;
    const auto n = static_cast<uint64_t>(num_hc), covered = n * kHcSize;
    const auto count = static_cast<uint64_t>(border);
    const Border tail{1, covered + count, 1, 1, covered, count};  // three-axis view (1, 1, n)
    const uint64_t resident = static_cast<uint64_t>(sms) * ctas_per_sm;
    const uint64_t block_ctas = n < resident ? n : resident;
    decode_blocks<<<static_cast<unsigned>(block_ctas + border_ctas(count)), kThreads, 0,
                    static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(stream), static_cast<uint64_t>(size), n, block_ctas, tail,
        static_cast<uint32_t*>(out));
    return cudaGetLastError();
}

// CTAs of decode_blocks that one SM holds at a time, or minus the CUDA error.
extern "C" int ndzip_decode_fp32_ctas_per_sm() {
    int sms = 0, ctas_per_sm = 0;
    const cudaError_t err = ndzip::decode_residency(&sms, &ctas_per_sm);
    return err == cudaSuccess ? ctas_per_sm : -static_cast<int>(err);
}
