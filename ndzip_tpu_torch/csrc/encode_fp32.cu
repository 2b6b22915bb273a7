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
//   * a CTA takes its 4096-word block by a ticket. The thread that draws
//     the ticket starts one 16 KiB bulk copy of the block (the copy engine:
//     cp.async.bulk, completing on an mbarrier) into the run buffer, which
//     lies unused until the compaction, and asks the L2 for the block that
//     the CTA kAhead tickets later will copy (cp.async.bulk.prefetch.L2):
//     tickets run in order, so that block is wanted a few microseconds
//     later, and its copy then waits on the L2 and not on the memory. No
//     thread holds a register or issues a load for the block. When the copy
//     has landed, one pass (transform_run_1d) takes it into the padded
//     block with the whole transform, and the CTA counts its length without
//     the transpose; the block stays in shared memory. This replaced 16-byte
//     loads by every thread, issued only after the ticket's barrier, and a
//     transform of three barriers and two more round trips through shared
//     memory (common.cuh's load_transform_1d, which the placement stage of
//     stage_placement.cu keeps): 800.10 -> 688.18 us at HACC's 280,953,867
//     elements (68.0% -> 79.1% of the bound), 763.23 -> 655.87 us at
//     2^28 + 17. The copy alone gave 755.60 us at HACC, the prefetch alone
//     on the old load 722.54. kAhead 264 and 396 measured the same (688.18,
//     688.70 us), 132, B3's distance, 0.7% slower (692.85);
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
// 34 KB of shared memory a CTA, six CTAs an SM (32 registers); compacting in
// place in the block's own buffer (17 KB, eight CTAs an SM, each warp storing
// its own words) was measured and was 4-11% slower. Element and stream
// offsets are 64-bit. The measurements named here: 2^24, 2^28 + 17 and
// 280,953,867 elements on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md).

#include <cstddef>

#include "common.cuh"

namespace ndzip {

// Tickets between a CTA and the block it asks the L2 for: two CTAs an SM of
// an H100 ahead (132 measured 0.7% slower, 396 the same).
constexpr uint32_t kAhead = 264;
constexpr uint32_t kBlockBytes = kHcSize * sizeof(uint32_t);

// From the block as its bulk copy left it in `run` (dense, in order) to x in
// the padded layout, with the whole 1D transform: each word rotated left by
// one, less the rotated word before it (word 0 of the block stays), then
// complement-negative. Thread t takes the 16 bytes q = t + 256k, words 4q ..
// 4q + 3, a warp 512 consecutive bytes; the rotated word before them is the
// lane before's last, by shuffle, and lane 0 reads word 4q - 1 itself. The
// padded slots of a warp's 32 words 4q + j fall in 32 banks, so neither side
// has a bank conflict. Ends with a barrier.
__device__ __forceinline__ void transform_run_1d(const uint32_t* run, uint32_t* x) {
    const int t = threadIdx.x, lane = t & 31;
    const uint4* src = reinterpret_cast<const uint4*>(run);
#pragma unroll
    for (int k = 0; k < kHcSize / 4 / kThreads; ++k) {
        const int q = t + k * kThreads;
        const uint4 v = src[q];
        const uint32_t w0 = rotl1(v.x), w1 = rotl1(v.y), w2 = rotl1(v.z), w3 = rotl1(v.w);
        const uint32_t left = __shfl_up_sync(kFull, w3, 1);
        const uint32_t before = lane ? left : q ? rotl1(run[4 * q - 1]) : 0u;
        x[pad(4 * q)] = complement_negative(w0 - before);
        x[pad(4 * q + 1)] = complement_negative(w1 - w0);
        x[pad(4 * q + 2)] = complement_negative(w2 - w1);
        x[pad(4 * q + 3)] = complement_negative(w3 - w2);
    }
    __syncthreads();
}

static_assert(offsetof(EncodeRunShared, run) % 16 == 0, "the block lands in s.run, 16-byte aligned");

// Six CTAs an SM, as its shared memory allows: the bound keeps ptxas under
// the 42 registers a thread that leaves (it takes 32).
__global__ void __launch_bounds__(kThreads, 6)
encode_blocks(const uint32_t* __restrict__ words, uint64_t num_hc, uint64_t border,
              uint64_t* status, uint32_t* __restrict__ stream, int32_t* __restrict__ length) {
    __shared__ __align__(16) EncodeRunShared s;
    __shared__ uint64_t full;  // mbarrier: the block has landed
    // The CTA's block is a ticket (common.cuh's take_ticket; the counter is
    // the word after the num_hc status words). The thread that draws it
    // starts the block's bulk copy into s.run, which lies unused until the
    // compaction, and asks the L2 for the block kAhead tickets on.
    if (threadIdx.x == 0) {
        const uint64_t ticket = atomicAdd(reinterpret_cast<uint32_t*>(status + num_hc), 1u);
        s.block = static_cast<uint32_t>(ticket);
        mbarrier_init(&full, 1);
        mbarrier_init_fence();
        mbarrier_arrive_expect(&full, kBlockBytes);
        bulk_copy_to_shared(s.run, words + ticket * kHcSize, kBlockBytes, &full);
        if (ticket + kAhead < num_hc) bulk_prefetch_l2(words + (ticket + kAhead) * kHcSize, kBlockBytes);
    }
    __syncthreads();
    const uint64_t b = s.block;
    mbarrier_wait(&full, 0);
    transform_run_1d(s.run, s.x);
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
