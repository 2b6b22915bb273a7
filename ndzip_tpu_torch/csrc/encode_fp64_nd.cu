// fp64 2D/3D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp64 in
// tile2d/tile3d mode, launched by _encode_interior_fp64, together with the
// header, pad and border glue of _encode_fp64_device for 2D/3D shapes (and
// the XLA gather route into _encode_blocks_fp64 of shapes whose minor
// block-grid axis does not divide).
//
// The TPU kernel DMAs multi-block tiles of both (lo, hi) planes and
// rearranges them into blocks in VMEM. Here the encode is one kernel that
// reads the grid once, the fp32 2D/3D encoder's design (encode_fp32_nd.cu)
// on u64 words:
//   * a CTA takes its block by a ticket, in the header's order; the thread
//     that draws the ticket splits it over the block grid once, in 32-bit
//     arithmetic. Before it loads, it asks the L2 for the block kAhead
//     tickets on (grid_nd64.cuh's prefetch_block64);
//   * it loads its block straight from the grid, row by row (64 rows of 64
//     words in 2D, 256 rows of 16 in 3D; 16-byte loads of two words when
//     every row starts aligned, else one word a lane), into shared memory in
//     the block's row-major order, rotating each word and taking the
//     differences along the rows on the way in (grid_nd64.cuh's
//     load_block64). One pass over shared memory does the rest of the
//     transform: the differences along the columns (2D) or along y and z
//     (3D), a thread on 16 words of one line, then complement-negative;
//   * common64.cuh's encode_run64 does the rest as in 1D: the length by OR
//     and popcount, published at once; the transposes (TransposeLane64) and
//     each warp's compaction in place; the offset by decoupled look-back;
//     header[b] in u64 words; the run stored in whole lines. The
//     last block's CTA writes the stream length in u32 words and zeroes the
//     pad entry of an odd block count;
//   * the border has no bound, so border CTAs are the CTAs whose ticket is
//     num_hc or more: they wait for the last block's inclusive sum, which
//     says where the border starts, and copy 4096 elements each in
//     format.border_slices order (common.cuh's Border). Every block's CTA
//     has started when the first border CTA waits, so the wait ends.
// The status words and the ticket are cleared on the same CUDA stream before
// the launch, and belong to one call.
//
// Bound: bytes. Each element is read once, in rows of 512 B (2D) or 128 B
// (3D), and the stream is written once. The block takes 35 KB of shared
// memory a CTA; at the 63 (3D) and 57 (2D) registers that ptxas takes, four
// CTAs fit an SM. Fewer registers for more CTAs lost: a bound of five CTAs
// spilled and ran 16-19% slower, the difference pass in two halves of eight
// words (40 registers, six CTAs) 1.5-3%. A second buffer for the run (three
// CTAs an SM) was 2% slower. Element and stream offsets are 64-bit. The
// measurements named here: PERF.md (fp64 256^3, 512^3 and 16384x8192 on an
// NVIDIA H100 80GB HBM3, 700.00 W).

#include "grid_nd64.cuh"

namespace ndzip {

// 2D: the first differences along the columns in shared memory (the first
// word of each column stays), a thread on 16 words of one column, then
// complement-negative. Ends with a barrier.
__device__ __forceinline__ void difference_columns64(u64* x) {
    const Segment g = segment<2, 0>(threadIdx.x);
    u64 v[kWordsPerThread];
    u64 prev = g.s ? x[pad64(g.start - g.step)] : 0ull;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) v[k] = x[pad64(g.start + k * g.step)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        x[pad64(g.start + k * g.step)] = complement_negative(v[k] - prev);
        prev = v[k];
    }
    __syncthreads();
}

// 3D: the first differences along y and along z in one pass, thread t on the
// z line at (y, x) = (t / 16, t % 16): each word less its neighbour at y - 1,
// then the differences of those along the line, then complement-negative.
// Ends with a barrier.
__device__ __forceinline__ void difference_yz64(u64* x) {
    const int t = threadIdx.x;
    u64 v[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const u64 own = x[pad64(t + 256 * k)];
        v[k] = own - (t >= 16 ? x[pad64(t - 16 + 256 * k)] : 0ull);
    }
    __syncthreads();
    u64 prev = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        x[pad64(t + 256 * k)] = complement_negative(v[k] - prev);
        prev = v[k];
    }
    __syncthreads();
}

// Tickets between a CTA and the block it asks the L2 for: one CTA an SM of an
// H100 ahead. 33 to 132 measured within 1.2% of each other, 198 up to 3%
// slower, no prefetch 6-13% slower.
constexpr uint32_t kAhead = 132;

template <int Dims>
__global__ void __launch_bounds__(kThreads)
encode_blocks64_nd(const u64* __restrict__ words, Blocks<Dims> geo, Border border, bool vec,
                   uint64_t num_hc, uint64_t* status, uint32_t* __restrict__ stream,
                   int32_t* __restrict__ length) {
    __shared__ EncodeRunShared64 s;
    __shared__ uint64_t origin;  // of the CTA's block in the grid
    __shared__ uint64_t ahead;   // of the block kAhead tickets on, or ~0 past the last block
    // the ticket counter is the word after the num_hc status words
    if (threadIdx.x == 0) {
        s.block = atomicAdd(reinterpret_cast<uint32_t*>(status + num_hc), 1u);
        if (s.block < num_hc) origin = geo.origin32(s.block);
        ahead = s.block + kAhead < num_hc ? geo.origin32(s.block + kAhead) : ~0ull;
    }
    __syncthreads();
    const uint64_t b = s.block, hw = header_words64(num_hc);
    if (b >= num_hc) {  // a border CTA: the border starts after the last block's run
        if (threadIdx.x == 0) s.exclusive = wait_inclusive(status + num_hc - 1);
        __syncthreads();
        encode_border64(words, border, b - num_hc, reinterpret_cast<u64*>(stream) + hw + s.exclusive);
        return;
    }

    if (ahead != ~0ull) prefetch_block64(words + ahead, geo);
    load_block64(words + origin, geo, vec, s.x);  // with the differences along the rows
    __syncthreads();
    if constexpr (Dims == 2) {
        difference_columns64(s.x);
    } else {
        difference_yz64(s.x);
    }
    encode_run64(s, b, num_hc, status, stream);

    if (b == num_hc - 1 && threadIdx.x == 0) {  // the body's total is s.exclusive + s.length
        *length = static_cast<int32_t>(2 * (hw + s.exclusive + s.length + border.count));
        if (num_hc & 1) stream[num_hc] = 0u;  // the pad entry
    }
}

template <int Dims>
int encode64_nd(const u64* in, uint64_t e0, uint64_t e1, uint64_t e2, uint32_t* out, uint64_t* status,
                int32_t* length, cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    const cudaError_t err = cudaMemsetAsync(status, 0, (g.num_hc + 1) * sizeof(uint64_t), s);
    if (err != cudaSuccess) return err;
    encode_blocks64_nd<Dims><<<static_cast<unsigned>(g.num_hc + border_ctas(g.border.count)), kThreads, 0, s>>>(
        in, g.blocks, g.border, rows_aligned64(in, e2), g.num_hc, status, out, length);
    return cudaGetLastError();
}

template <int Dims>
int encode64_nd_ctas_per_sm() {
    int ctas = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, encode_blocks64_nd<Dims>, kThreads, 0);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

}  // namespace ndzip

// words: the u64 grid of `dims` (2 or 3) dims, its shape padded in front with
// 1s to (e0, e1, e2), with at least one whole block, 8-byte aligned. stream:
// room for the fp64 compressed bound, 8-byte aligned. status: num_hc + 1
// 64-bit words of scratch, which belong to this call alone. length: one
// int32, the stream's length in u32 words. Launches on the current device.
// Returns the first CUDA error, 0 if none.
extern "C" int ndzip_encode_fp64_nd(const void* words, int64_t dims, int64_t e0, int64_t e1, int64_t e2,
                                    void* stream, void* status, void* length, void* cuda_stream) {
    using namespace ndzip;
    const auto* in = static_cast<const u64*>(words);
    auto* out = static_cast<uint32_t*>(stream);
    auto* st = static_cast<uint64_t*>(status);
    auto* len = static_cast<int32_t*>(length);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return encode64_nd<2>(in, e0, e1, e2, out, st, len, s);
    if (dims == 3) return encode64_nd<3>(in, e0, e1, e2, out, st, len, s);
    return cudaErrorInvalidValue;
}

// CTAs of encode_blocks64_nd for `dims` (2 or 3) that one SM holds at a time,
// or minus the CUDA error.
extern "C" int ndzip_encode_fp64_nd_ctas_per_sm(int64_t dims) {
    if (dims == 2) return ndzip::encode64_nd_ctas_per_sm<2>();
    if (dims == 3) return ndzip::encode64_nd_ctas_per_sm<3>();
    return -static_cast<int>(cudaErrorInvalidValue);
}
