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
// over. The design is the fp32 encoder's (encode_fp32.cu), one kernel that
// reads its input once:
//   * a CTA takes its 4096-word block by a ticket, loads it with 16-byte
//     loads and transforms it on the way in (rotate, the differences along
//     the block in registers, complement: common64.cuh's
//     load_transform64_1d), and counts its length without the transpose;
//   * it publishes the length in the block's status word at once, then
//     transposes the chunks (four 32-bit TransposeLane calls a 64-word
//     chunk: common64.cuh's TransposeLane64), each warp compacting the
//     nonzero words of its chunks in place, and only then learns its offset
//     by decoupled look-back;
//   * the CTA stores the heads at u64 word hw + offset and each warp its
//     words after them, on two 128-byte lines at a time, and writes
//     header[b] in u64 words (common64.cuh's encode_run64);
//   * the last block's CTA writes the stream length in u32 words, zeroes the
//     pad entry of an odd block count and copies the border tail
//     words[num_hc*4096 ..), under 4096 words, after its own run.
// The status words and the ticket are cleared on the same CUDA stream before
// the launch, and belong to one call.
//
// Bound: bytes. Each element is read once (8 B) and the stream written once
// (8 B x ratio per element). The block takes 35 KB of shared memory a CTA,
// six CTAs an SM; a second buffer for the run (68 KB, three CTAs an SM) was
// 10% slower at 2^23 elements and 20% at 2^27 + 17 (PERF.md). Per 64-bit
// word the kernel runs the instructions that the fp32 encoder runs per
// 32-bit word, so it needs half as many per byte. Element and stream
// offsets are 64-bit.

#include "common64.cuh"

namespace ndzip {

__global__ void __launch_bounds__(kThreads)
encode_blocks64(const u64* __restrict__ words, uint64_t num_hc, uint64_t border, uint64_t* status,
                uint32_t* __restrict__ stream, int32_t* __restrict__ length) {
    __shared__ EncodeRunShared64 s;
    // the ticket counter is the word after the num_hc status words
    const uint64_t b = take_ticket(reinterpret_cast<uint32_t*>(status + num_hc), &s.block);
    load_transform64_1d(words + b * kHcSize, s.x);
    encode_run64(s, b, num_hc, status, stream);

    if (b == num_hc - 1) {  // the body's total is s.exclusive + s.length
        const uint64_t hw = header_words64(num_hc), body_end = hw + s.exclusive + s.length;
        if (threadIdx.x == 0) {
            *length = static_cast<int32_t>(2 * (body_end + border));
            if (num_hc & 1) stream[num_hc] = 0u;  // the pad entry
        }
        const u64* tail = words + num_hc * kHcSize;
        u64* dst = reinterpret_cast<u64*>(stream) + body_end;
        for (uint64_t i = threadIdx.x; i < border; i += kThreads) dst[i] = tail[i];
    }
}

}  // namespace ndzip

// words: num_hc * 4096 + border u64 words, 16-byte aligned, border < 4096.
// stream: room for the fp64 compressed bound, 8-byte aligned. status: num_hc
// + 1 64-bit words of scratch, which belong to this call alone. length: one
// int32, the stream's length in u32 words. num_hc >= 1. Launches on the
// current device. Returns the first CUDA error, 0 if none.
extern "C" int ndzip_encode_fp64(const void* words, int64_t num_hc, int64_t border, void* stream,
                                 void* status, void* length, void* cuda_stream) {
    using namespace ndzip;
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    const auto n = static_cast<uint64_t>(num_hc);
    const cudaError_t err = cudaMemsetAsync(status, 0, (n + 1) * sizeof(uint64_t), s);
    if (err != cudaSuccess) return err;
    encode_blocks64<<<static_cast<unsigned>(num_hc), kThreads, 0, s>>>(
        static_cast<const u64*>(words), n, static_cast<uint64_t>(border), static_cast<uint64_t*>(status),
        static_cast<uint32_t*>(stream), static_cast<int32_t*>(length));
    return cudaGetLastError();
}

// CTAs of encode_blocks64 that one SM holds at a time, or minus the CUDA error.
extern "C" int ndzip_encode_fp64_ctas_per_sm() {
    int ctas = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, ndzip::encode_blocks64, ndzip::kThreads, 0);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
}
