// fp32 1D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp32 in
// flat mode, launched by _encode_blocks_fp32, together with the header and
// border glue of _encode_fp32_device.
//
// The TPU kernel walks the blocks in order and carries the running stream
// offset from one grid step to the next. CTAs run in no fixed order, so the
// encode here is three launches on one stream, as in the reference's CUDA
// codec (lengths, device-wide scan, placement):
//   1. encode_blocks<false>: one CTA per 4096-word block transforms and
//      counts, and writes the block's length (128 heads + its nonzero
//      transposed words, counted without the transpose: common.cuh's
//      encode_chunks);
//   2. scan_lengths (common.cuh): one CTA scans the lengths into the header
//      of offset-after entries, stream[0 .. num_hc), and writes the stream
//      length, so the host never waits;
//   3. encode_blocks<true>: each CTA recomputes its block and writes its
//      heads and nonzero words at num_hc + (b ? header[b-1] : 0); one more
//      CTA copies the border tail words[num_hc*4096 ..) after the last body
//      word.
// The load and transform are common.cuh's load_transform_1d, which the
// placement stage kernels (stage_placement.cu) share; everything after the
// transform is common.cuh's encode_chunks, which the 2D/3D encoder
// (encode_fp32_nd.cu) shares.
//
// Bound: bytes. Each element is read twice (4 B in pass 1 and 4 B in pass 3;
// recomputing costs less than a scratch copy of the stream, which would be
// written once and read once) and the stream is written once (4 B x ratio per
// element); the arithmetic per word is a handful of integer ops, five warp
// shuffles per chunk and one ballot. Element and stream offsets are 64-bit.

#include "common.cuh"

namespace ndzip {

template <bool kPlace>
__global__ void __launch_bounds__(kThreads)
encode_blocks(const uint32_t* __restrict__ words, uint64_t num_hc, Border border,
              uint32_t* __restrict__ lengths, uint32_t* __restrict__ stream) {
    const uint64_t b = blockIdx.x;
    if (kPlace && b >= num_hc) {  // the border CTA
        encode_border(words, border, num_hc, b - num_hc, stream);
        return;
    }

    __shared__ EncodeShared s;
    load_transform_1d(words + b * kHcSize, s.x);  // common.cuh
    encode_chunks<kPlace>(s, b, num_hc, lengths, stream);
}

}  // namespace ndzip

// words: num_hc * 4096 + border words, 16-byte aligned. stream: room for the
// compressed bound. lengths: num_hc words of scratch. length: one int32.
// num_hc >= 1. Launches on the current device. Returns the first CUDA error
// of the launches, 0 if none.
extern "C" int ndzip_encode_fp32(const void* words, int64_t num_hc, int64_t border, void* stream,
                                 void* lengths, void* length, void* cuda_stream) {
    using namespace ndzip;
    cudaError_t err;
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    const auto* in = static_cast<const uint32_t*>(words);
    auto* out = static_cast<uint32_t*>(stream);
    auto* lens = static_cast<uint32_t*>(lengths);
    const auto n = static_cast<uint64_t>(num_hc);

    // the border tail words[num_hc * 4096 ..) on the three-axis view (1, 1, n)
    const uint64_t covered = n * kHcSize, count = static_cast<uint64_t>(border);
    const Border tail{1, covered + count, 1, 1, covered, count};
    const auto grid = static_cast<unsigned>(num_hc);
    encode_blocks<false><<<grid, kThreads, 0, s>>>(in, n, tail, lens, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_lengths<<<1, 1024, 0, s>>>(lens, n, count, out, static_cast<int32_t*>(length));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    encode_blocks<true><<<grid + border_ctas(count), kThreads, 0, s>>>(in, n, tail, lens, out);
    return cudaGetLastError();
}
