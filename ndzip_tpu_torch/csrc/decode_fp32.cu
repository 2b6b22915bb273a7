// fp32 1D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp32 in
// flat mode, launched by _decode_blocks_fp32, together with the border glue
// of _decode_fp32_device.
//
// The TPU kernel fetches a fixed 34-row window per block and re-expands it
// with one-hot matmuls, so its stream must be zero-padded past the end. Here
// one CTA decodes one block and reads only the words the block owns: its
// start num_hc + (b ? header[b-1] : 0), its 128 heads, and for each chunk the
// nonzero words its head marks. Each warp expands a chunk and transposes it
// (common.cuh's expand_chunks, shared with the 2D/3D decoder), and the CTA
// runs the inverse transform (complement, wrapping prefix sum over the 4096
// words, rotate right) before storing the block at out[b*4096 ..), the 1D
// output order itself. One more CTA copies the border tail from
// num_hc + header[num_hc-1]. Every read is clamped to the stream's size, so a
// damaged stream cannot fault.
//
// Bound: bytes. Each element reads 4 B x ratio of stream and writes 4 B of
// output; the arithmetic per word is a handful of integer ops and five warp
// shuffles per chunk. Element and stream offsets are 64-bit.

#include "common.cuh"

namespace ndzip {

__global__ void __launch_bounds__(kThreads)
decode_blocks(const uint32_t* __restrict__ stream, uint64_t size, uint64_t num_hc, Border border,
              uint32_t* __restrict__ out) {
    const uint64_t b = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    if (b >= num_hc) {  // the border CTA
        decode_border(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ DecodeShared s;
    expand_chunks(s, stream, size, num_hc, b);

    // inverse transform: complement, wrapping inclusive prefix sum, rotate right
    uint32_t seg[kWordsPerThread];
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        sum += complement_negative(s.x[pad(kWordsPerThread * t + k)]);
        seg[k] = sum;
    }
    const uint32_t incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) s.partial[warp] = incl;
    __syncthreads();
    uint32_t carry = incl - sum;
    for (int w = 0; w < warp; ++w) carry += s.partial[w];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) s.x[pad(kWordsPerThread * t + k)] = rotr1(seg[k] + carry);
    __syncthreads();

    uint4* dst = reinterpret_cast<uint4*>(out + b * kHcSize);
#pragma unroll
    for (int k = 0; k < kHcSize / 4 / kThreads; ++k) {
        const int q = t + k * kThreads;
        dst[q] = make_uint4(s.x[pad(4 * q)], s.x[pad(4 * q + 1)], s.x[pad(4 * q + 2)], s.x[pad(4 * q + 3)]);
    }
}

}  // namespace ndzip

// stream: `size` words, header from word 0. out: num_hc * 4096 + border
// words, 16-byte aligned. num_hc >= 1, border < 4096. Launches on the current
// device. Returns the CUDA error of the launch, 0 if none.
extern "C" int ndzip_decode_fp32(const void* stream, int64_t size, int64_t num_hc, int64_t border,
                                 void* out, void* cuda_stream) {
    using namespace ndzip;
    const auto n = static_cast<uint64_t>(num_hc), covered = n * kHcSize;
    const auto count = static_cast<uint64_t>(border);
    const Border tail{1, covered + count, 1, 1, covered, count};  // three-axis view (1, 1, n)
    const auto grid = static_cast<unsigned>(num_hc + border_ctas(count));
    decode_blocks<<<grid, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint32_t*>(stream), static_cast<uint64_t>(size), n, tail,
        static_cast<uint32_t*>(out));
    return cudaGetLastError();
}
