// Stage kernel of the fp32 encoder's compaction select, for Hopper (sm_90a):
// the keep mask of a staging layout of 128-word rows.
//
// Replaces the TPU probe dev/mosaic_repro.py:39 (the pallas_call of run(kern),
// kernel bodies kern_bool_where/kern_int_where at :15-35), which isolates the
// select B1 computes over its staging rows before compaction. For an (R, 128)
// int32 input x with fill = x[0][0] and a row limit:
//   out[0][c] = c < fill                                   (the fill row)
//   out[r][c] = (r % 33 == 1 || x[r][c] != 0) && r < limit  (r >= 1)
// as int32. Each run of 33 rows is one fp32 block's dense row (128 heads,
// then 4096 words), whose first row, the heads, is always kept. On
// [fill row ; dense rows of nb blocks] with limit 1 + 33 nb, rows 1 .. 33 nb
// are golden.encode_blocks_dense's `valid`.
//
// On Hopper the nonzero mask of 32 consecutive words is one warp ballot, as
// B1's compaction takes it (common.cuh's encode_run): each warp owns a
// run of 32 words of one row, and each lane reads its word's bit from the
// ballot. R * 128 is a multiple of 32, so every warp is whole or past the end.
//
// Bound: bytes. Each word is read once and its int32 mask written once (8 B
// a word, 33.8 KiB per block's dense row); grid-stride, 4 B a lane, coalesced.

#include "common.cuh"

namespace ndzip {

constexpr int kLanes = 128;  // words per row of the staging layout
constexpr int kRowsPerBlock = kChunks / kLanes + kHcSize / kLanes;  // 33

__global__ void __launch_bounds__(kThreads)
keep_mask(const int32_t* __restrict__ x, uint64_t n, int64_t limit, int32_t* __restrict__ out) {
    const int32_t fill = x[0];
    const int lane = threadIdx.x & 31;
    const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kThreads;
    for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        const uint32_t nz = __ballot_sync(kFull, x[i] != 0);  // the warp's run of 32 words
        const uint64_t r = i / kLanes;
        const int c = static_cast<int>(i % kLanes);
        const bool keep = r == 0 ? c < fill
                                 : (r % kRowsPerBlock == 1 || ((nz >> lane) & 1u)) &&
                                       r < static_cast<uint64_t>(limit > 0 ? limit : 0);
        out[i] = keep;
    }
}

}  // namespace ndzip

// x, out: rows * 128 int32 words, rows >= 1. Launch on the current device;
// return the CUDA error of the launch, 0 if none.
extern "C" int ndzip_keep_mask(const void* x, int64_t rows, int64_t limit, void* out, void* cuda_stream) {
    using namespace ndzip;
    const uint64_t n = static_cast<uint64_t>(rows) * kLanes;
    const uint64_t ctas = (n + kThreads - 1) / kThreads;
    const unsigned grid = static_cast<unsigned>(ctas < 132 * 64 ? ctas : 132 * 64);
    keep_mask<<<grid, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int32_t*>(x), n, limit, static_cast<int32_t*>(out));
    return cudaGetLastError();
}
