// fp64 1D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp64 in
// flat mode, launched by _decode_blocks_fp64, together with the border glue
// of _decode_fp64_device.
//
// The TPU kernel fetches a fixed window of interleaved u32 rows per block,
// splits it into (lo, hi) planes, and re-expands it with one-hot matmuls.
// Here the stream is read as u64 words, and, as in the fp32 decoder
// (decode_fp32.cu), one CTA decodes one block and reads only the words it
// owns: its start hw + (b ? header[b-1] : 0) in u64 words, its 64 heads, and
// for each chunk the nonzero words its head marks. Each warp expands a chunk,
// two words a lane, and transposes it (common64.cuh's expand_chunks64), and
// the CTA runs the inverse transform (complement, wrapping prefix sum over the
// 4096 words, rotate right) before storing the block at out[b*4096 ..), the 1D
// output order itself. The CTAs after the blocks copy the border tail. Every
// read is clamped to the stream's size, so a damaged stream cannot fault.
//
// Bound: bytes. Each element reads 8 B x ratio of stream and writes 8 B of
// output; per element the work is that of the fp32 decoder on twice the
// bytes. Element and stream offsets are 64-bit.

#include "common64.cuh"

namespace ndzip {

// At most 48 registers, so that 5 CTAs share an SM as its shared memory
// allows: uncapped, ptxas takes 64 and 4 fit (PERF.md, PR 3).
__global__ void __launch_bounds__(kThreads, 5)
decode_blocks64(const uint32_t* __restrict__ stream, uint64_t size, uint64_t num_hc, Border border,
                u64* __restrict__ out) {
    const uint64_t b = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (b >= num_hc) {  // a border CTA
        decode_border64(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ DecodeShared64 s;
    expand_chunks64(s, stream, size, num_hc, b);

    // inverse transform: complement, wrapping inclusive prefix sum, rotate right
    u64 seg[kWordsPerThread];
    u64 sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        sum += complement_negative(s.x[pad64(kWordsPerThread * t + k)]);
        seg[k] = sum;
    }
    const u64 incl = warp_inclusive_scan64(sum, lane);
    if (lane == 31) s.partial[warp] = incl;
    __syncthreads();
    u64 carry = incl - sum;
    for (int w = 0; w < warp; ++w) carry += s.partial[w];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) s.x[pad64(kWordsPerThread * t + k)] = rotr1(seg[k] + carry);
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
