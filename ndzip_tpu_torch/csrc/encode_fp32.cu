// fp32 1D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp32 in
// flat mode, launched by _encode_blocks_fp32, together with the header and
// border glue of _encode_fp32_device.
//
// The TPU kernel walks the blocks in order and carries the running stream
// offset from one grid step to the next. CTAs run in no fixed order, so a
// block's offset is the sum of the lengths of all blocks before it, which no
// CTA knows when it starts. The encode is one kernel that reads its input
// once:
//   * a CTA takes its 4096-word block by a ticket, loads and transforms it
//     (common.cuh's load_transform_1d, shared with stage_placement.cu) and
//     counts its length without the transpose; the block stays in shared
//     memory;
//   * it publishes the length in the block's status word at once, then
//     transposes the chunks and compacts the heads and nonzero words into a
//     second shared buffer, and only then learns its offset by decoupled
//     look-back (common.cuh's look_back): one warp sums its predecessors'
//     status words 32 at a time until it meets one that holds an inclusive
//     sum, then publishes its own. No block waits for the block before it to
//     finish, only to have counted, and by the time a block looks back its
//     predecessors have (looking back before the transposes, with the other
//     warps working meanwhile, was measured and was 10% slower);
//   * the whole CTA then stores the run with consecutive threads on
//     consecutive words, a warp on one 128-byte line at a time (common.cuh's
//     encode_run);
//   * the block's CTA writes header[b]. The last block's CTA is the one that
//     knows the body's total without waiting, so it also writes the stream
//     length and copies the border tail words[num_hc*4096 ..), under 4096
//     words, after its own run: no border CTA has to wait on a status word.
// The status words and the ticket are cleared on the same CUDA stream before
// the launch, and belong to one call.
//
// Bound: bytes. Each element is read once (4 B) and the stream written once
// (4 B x ratio per element). Beside that the kernel runs, per word, a
// handful of integer ops and shared-memory accesses and, per chunk, five warp
// shuffles, one OR reduction and one ballot: that keeps the SMs' schedulers
// about as busy as the bytes keep the memory, so the instruction count
// matters too (common.cuh's 13-instruction transpose). Two block buffers take
// 34 KB of shared memory a CTA, six CTAs an SM; compacting in place in the
// block's own buffer (17 KB, eight CTAs an SM, each warp storing its own
// words) was measured and was 4-11% slower. Element and stream offsets are
// 64-bit. The measurements named here: 2^24 and 2^28 + 17 elements on an NVIDIA
// H100 80GB HBM3, 700.00 W.

#include "common.cuh"

namespace ndzip {

__global__ void __launch_bounds__(kThreads)
encode_blocks(const uint32_t* __restrict__ words, uint64_t num_hc, uint64_t border,
              uint64_t* status, uint32_t* __restrict__ stream, int32_t* __restrict__ length) {
    __shared__ EncodeRunShared s;
    // the ticket counter is the word after the num_hc status words
    const uint64_t b = take_ticket(reinterpret_cast<uint32_t*>(status + num_hc), &s.block);
    load_transform_1d(words + b * kHcSize, s.x);
    encode_run(s, b, num_hc, status, stream);

    if (b == num_hc - 1) {  // the body's total is s.exclusive + s.length
        const uint64_t body_end = num_hc + s.exclusive + s.length;
        if (threadIdx.x == 0) *length = static_cast<int32_t>(body_end + border);
        const uint32_t* tail = words + num_hc * kHcSize;
        for (uint64_t i = threadIdx.x; i < border; i += kThreads) stream[body_end + i] = tail[i];
    }
}

}  // namespace ndzip

// words: num_hc * 4096 + border words, 16-byte aligned, border < 4096.
// stream: room for the compressed bound. status: num_hc + 1 64-bit words of
// scratch, which belong to this call alone. length: one int32. num_hc >= 1.
// Launches on the current device. Returns the first CUDA error, 0 if none.
extern "C" int ndzip_encode_fp32(const void* words, int64_t num_hc, int64_t border, void* stream,
                                 void* status, void* length, void* cuda_stream) {
    using namespace ndzip;
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    const auto n = static_cast<uint64_t>(num_hc);
    cudaError_t err = cudaMemsetAsync(status, 0, (n + 1) * sizeof(uint64_t), s);
    if (err != cudaSuccess) return err;
    encode_blocks<<<static_cast<unsigned>(num_hc), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words), n, static_cast<uint64_t>(border), static_cast<uint64_t*>(status),
        static_cast<uint32_t*>(stream), static_cast<int32_t*>(length));
    return cudaGetLastError();
}

// CTAs of encode_blocks that one SM holds at a time, or minus the CUDA error.
extern "C" int ndzip_encode_fp32_ctas_per_sm() {
    int ctas = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, ndzip::encode_blocks, ndzip::kThreads, 0);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
}
