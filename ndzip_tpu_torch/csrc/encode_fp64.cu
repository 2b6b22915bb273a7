// fp64 1D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp64 in
// flat mode, launched by _encode_blocks_fp64, together with the header, pad
// and border glue of _encode_fp64_device.
//
// The TPU has no 64-bit lanes, so its kernel carries each word as (lo, hi)
// u32 planes: a quadrant transpose with lane rolls, heads from bf16
// matmuls, and an interleave of the planes into the u32 stream. Here a word
// is a u64 and the stream is written as u64 words, so none of that carries
// over; the structure is that of the fp32 encoder (encode_fp32.cu), three
// launches on one stream:
//   1. encode_blocks64<false>: one CTA per 4096-word block transforms and
//      counts, and writes the block's length (64 heads + its nonzero
//      transposed words, counted without the transpose: common64.cuh's
//      encode_chunks64);
//   2. scan_lengths64 (common64.cuh): one CTA scans the lengths into the
//      header of offset-after entries in u64 words, zeroes the pad entry of
//      an odd block count, and writes the stream length in u32 words;
//   3. encode_blocks64<true>: each CTA recomputes its block and writes its
//      heads and nonzero words from u64 word hw + (b ? header[b-1] : 0); the
//      CTAs after the blocks copy the border tail words[num_hc*4096 ..)
//      after the last body word.
//
// Bound: bytes. Each element is read twice (8 B in pass 1 and 8 B in pass 3)
// and the stream is written once (8 B x ratio per element). Per element the
// work is that of the fp32 encoder on twice the bytes: a chunk is 64 words,
// two a lane, so the transpose takes one in-lane round and five rounds of two
// 64-bit shuffles for 64 words, against five shuffles for 32 in fp32.
// Element and stream offsets are 64-bit.

#include "common64.cuh"

namespace ndzip {

template <bool kPlace>
__global__ void __launch_bounds__(kThreads)
encode_blocks64(const u64* __restrict__ words, uint64_t num_hc, Border border,
                uint32_t* __restrict__ lengths, uint32_t* __restrict__ stream) {
    const uint64_t b = blockIdx.x;
    const int t = threadIdx.x;
    if (kPlace && b >= num_hc) {  // a border CTA
        encode_border64(words, border, num_hc, b - num_hc, stream);
        return;
    }

    __shared__ EncodeShared64 s;

    // load the block with 16-byte loads, rotating each word left by one
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(words + b * kHcSize);
#pragma unroll
    for (int k = 0; k < kHcSize / 2 / kThreads; ++k) {
        const int q = t + k * kThreads;
        const ulonglong2 v = src[q];
        s.x[pad64(2 * q)] = rotl1(v.x);
        s.x[pad64(2 * q + 1)] = rotl1(v.y);
    }
    __syncthreads();

    // first differences along the block (word 0 stays), then complement
    u64 seg[kWordsPerThread];
    u64 prev = t ? s.x[pad64(kWordsPerThread * t - 1)] : 0ull;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) seg[k] = s.x[pad64(kWordsPerThread * t + k)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        s.x[pad64(kWordsPerThread * t + k)] = complement_negative(seg[k] - prev);
        prev = seg[k];
    }
    __syncthreads();

    encode_chunks64<kPlace>(s, b, num_hc, lengths, stream);
}

}  // namespace ndzip

// words: num_hc * 4096 + border u64 words, 16-byte aligned. stream: room for
// the fp64 compressed bound, 8-byte aligned. lengths: num_hc words of
// scratch. length: one int32. num_hc >= 1. Launches on the current device.
// Returns the first CUDA error of the launches, 0 if none.
extern "C" int ndzip_encode_fp64(const void* words, int64_t num_hc, int64_t border, void* stream,
                                 void* lengths, void* length, void* cuda_stream) {
    using namespace ndzip;
    cudaError_t err;
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    const auto* in = static_cast<const u64*>(words);
    auto* out = static_cast<uint32_t*>(stream);
    auto* lens = static_cast<uint32_t*>(lengths);
    const auto n = static_cast<uint64_t>(num_hc);

    // the border tail words[num_hc * 4096 ..) on the three-axis view (1, 1, n)
    const uint64_t covered = n * kHcSize, count = static_cast<uint64_t>(border);
    const Border tail{1, covered + count, 1, 1, covered, count};
    const auto grid = static_cast<unsigned>(num_hc);
    encode_blocks64<false><<<grid, kThreads, 0, s>>>(in, n, tail, lens, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_lengths64<<<1, 1024, 0, s>>>(lens, n, count, out, static_cast<int32_t*>(length));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    encode_blocks64<true><<<grid + border_ctas(count), kThreads, 0, s>>>(in, n, tail, lens, out);
    return cudaGetLastError();
}
