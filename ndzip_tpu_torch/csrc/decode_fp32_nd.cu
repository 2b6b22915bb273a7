// fp32 2D/3D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp32 in
// tile2d/tile3d mode, launched by _decode_interior_fp32, together with the
// border glue of _decode_fp32_device for 2D/3D shapes (and the route through
// _decode_blocks_fp32 and _scatter_blocks_xla).
//
// The TPU kernel decodes G blocks a step into multi-block tiles, rearranges
// them with XOR cell swaps and writes a minor-axis-padded array whose fake
// blocks the caller slices off or overwrites. Here a block's words are taken
// as what they are, one contiguous run of the stream known from two header
// words, and the block goes straight into the grid of the exact shape:
//   * one CTA decodes one block, in the header's order (row-major over the
//     block grid), so the CTAs that run together store neighbouring blocks.
//     One thread starts the bulk copy of the block's run into shared memory
//     (cp.async.bulk, completing on an mbarrier) and splits the block's index
//     over the block grid, once, in 32-bit arithmetic. The block waits on one
//     copy, not on three rounds of dependent loads;
//   * the heads and the rank gather read shared memory (common.cuh's
//     start_run_copy and expand_run, the 1D decoder's), and each warp expands
//     and transposes its chunks with the cheap transpose, into the padded
//     block layout that the passes below walk;
//   * the inverse transform is complement-negative, then wrapping inclusive
//     prefix sums along each axis, then rotate-right-1. The sums along
//     different axes commute, so they need not run in the format's reversed
//     order: those along the columns (2D) or along z and then y (3D) are each
//     a pass over shared memory in which a thread scans 16 words of one line
//     (grid_nd.cuh's segment; a 2D column's four segments add the sums of the
//     ones before them), and those along the rows are taken in registers on
//     the store, where the 4 or 16 lanes of a row scan their sums
//     (grid_nd.cuh's store_block_rowsum). Rows that do not start 16-byte
//     aligned are stored one word a lane, after one more pass for their sums;
//   * a 3D grid whose rows start 16-byte aligned takes another store
//     (decode_blocks_nd_box; the same kernel otherwise). A 3D row is 64 B, so
//     the row walk spends a 64-bit address and a store on every 16 bytes, and
//     each warp's store spans eight rows in eight lines. Instead the threads
//     write the block with its sums along the rows into the run buffer, free
//     once the run is expanded, dense in the box's order (16-byte stores,
//     consecutive for consecutive lanes), and one thread stores it as one
//     16^3 box of the output's tensor map (grid_nd.cuh's box_map, built on
//     the host for each call): the copy engine makes the 256 row addresses
//     (10% of the kernel's time at 512^3 and at 512x512x2048);
//   * a run starts at any word and the stream itself may be a slice at any
//     word: the copy takes the 16-byte aligned window around the run and
//     never leaves [0, size). A damaged or truncated stream cannot fault: the
//     run is clamped to 128 .. 4224 words and to the stream's size, and what
//     lies past it reads as 0;
//   * CTAs past the blocks copy the border, 4096 elements each, from the
//     stream (after the last body word, known from the header: nothing waits)
//     to their places in format.border_slices order, each read clamped.
// The 1D decoder's persistent CTAs, each starting the next block's copy while
// it sums and stores this one, were measured here and lost: the loop carries
// the grid's geometry beside the producer's state, which under the register
// bound of six CTAs an SM spilled 160-212 bytes a thread into the passes (2.5
// times this kernel's time), and unbounded took 9% more time than one CTA a
// block, whose neighbours on the SM hide the copy's latency as well.
//
// Bound: bytes: 4 B x ratio of stream read and 4 B written per element, in
// rows of 256 B (2D) or 64 B (3D). The run buffer, the block and the 2D
// passes' partial sums take 34-35 KB of shared memory a CTA, six CTAs an SM
// (the box goes out of the run buffer).
// Element and stream offsets are 64-bit. The measurements named here and the
// variants beside them: PERF.md (512x512x2048 on an NVIDIA H100 80GB HBM3,
// 700.00 W).

#include <cstddef>

#include "grid_nd.cuh"

namespace ndzip {

template <int Dims>
struct DecodeNdShared {
    RunBuffer run;
    uint64_t full;  // mbarrier: the run has arrived
    uint32_t x[kPadded];
    uint32_t partial[Dims == 2 ? kThreads : 1];  // the 2D scans' per-thread sums
    uint64_t origin;                             // of the CTA's block in the grid
};

// Wrapping inclusive prefix sums along Axis in shared memory, after
// complement-negative on the first pass. Ends with a barrier.
template <int Dims, int Axis, bool kFirst>
__device__ __forceinline__ void prefix_sum(uint32_t* x, uint32_t* partial) {
    const int t = threadIdx.x;
    const Segment g = segment<Dims, Axis>(t);
    uint32_t v[kWordsPerThread];
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const uint32_t u = x[pad(g.start + k * g.step)];
        sum += kFirst ? complement_negative(u) : u;
        v[k] = sum;
    }
    if constexpr (Dims == 2) {  // add the sums of the segments before this one on its line
        partial[t] = sum;
        __syncthreads();
        uint32_t carry = 0;
        for (int j = 1; j <= g.s; ++j) carry += partial[t - j * g.tstride];
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) v[k] += carry;
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) x[pad(g.start + k * g.step)] = v[k];
    __syncthreads();
}

// Six CTAs an SM is what the shared memory allows; the bound keeps ptxas from
// taking more registers than that leaves (42).
template <int Dims>
__global__ void __launch_bounds__(kThreads, 6)
decode_blocks_nd(const uint32_t* __restrict__ stream, uint64_t size, Blocks<Dims> geo, Border border,
                 bool vec, uint64_t num_hc, uint32_t* __restrict__ out) {
    const int t = threadIdx.x;
    const uint32_t b = blockIdx.x;
    if (b >= num_hc) {  // a border CTA
        decode_border(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ DecodeNdShared<Dims> s;
    if (t == 0) {  // the header lies inside the stream: size >= num_hc
        mbarrier_init(&s.full, 1);
        mbarrier_init_fence();
        start_run_copy(stream, size, num_hc, b ? stream[b - 1] : 0u, stream[b], s.run, &s.full);
        s.origin = geo.origin32(b);
    }
    __syncthreads();
    mbarrier_wait(&s.full, 0);
    expand_run(s.run, s.x);

    prefix_sum<Dims, 0, true>(s.x, s.partial);
    if constexpr (Dims == 3) prefix_sum<3, 1, false>(s.x, s.partial);
    if (vec) {  // the sums along the rows in registers, on the way out
        store_block_rowsum(out + s.origin, geo, s.x);
    } else {
        prefix_sum<Dims, Dims - 1, false>(s.x, s.partial);
        store_block_words(out + s.origin, geo, s.x);
    }
}

static_assert(offsetof(DecodeNdShared<3>, run) % 128 == 0 && offsetof(RunBuffer, words) == 0,
              "the box goes out of s.run, 128-byte aligned");

// decode_blocks_nd<3> for a grid whose rows start 16-byte aligned, with the
// block's store through the output's tensor map (grid_nd.cuh's box_map): the
// sums along the rows go into s.run, which lies unused once expand_run has
// read it, as the dense 16^3 box (z*256 + y*16 + x), and one thread stores
// it as one 16 KiB box. Border CTAs and everything up to the sums along the
// rows are decode_blocks_nd's. Six CTAs an SM, as there.
__global__ void __launch_bounds__(kThreads, 6)
decode_blocks_nd_box(const __grid_constant__ CUtensorMap map, const uint32_t* __restrict__ stream, uint64_t size,
                     Blocks<3> geo, Border border, uint64_t num_hc, uint32_t* __restrict__ out) {
    const int t = threadIdx.x;
    const uint32_t b = blockIdx.x;
    if (b >= num_hc) {
        decode_border(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ __align__(128) DecodeNdShared<3> s;
    if (t == 0) {
        mbarrier_init(&s.full, 1);
        mbarrier_init_fence();
        start_run_copy(stream, size, num_hc, b ? stream[b - 1] : 0u, stream[b], s.run, &s.full);
    }
    __syncthreads();
    mbarrier_wait(&s.full, 0);
    expand_run(s.run, s.x);

    prefix_sum<3, 0, true>(s.x, s.partial);
    prefix_sum<3, 1, false>(s.x, s.partial);
    uint32_t* box = s.run.words;
    rowsum_words<3>(s.x, [&](int i, uint4 v) { *reinterpret_cast<uint4*>(box + i) = v; });
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
        tensor_store_from_shared(&map, geo.corner32(b), box);
        bulk_store_wait_read();
    }
}

template <int Dims>
int decode_nd(const uint32_t* stream, uint64_t size, uint64_t e0, uint64_t e1, uint64_t e2,
              uint32_t* out, cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    const auto ctas = static_cast<unsigned>(g.num_hc + border_ctas(g.border.count));
    const bool vec = rows_aligned(out, e2);
    if constexpr (Dims == 3) {
        if (vec) {
            CUtensorMap map;
            if (const int bad = box_map(&map, out, e0, e1, e2)) return bad;
            decode_blocks_nd_box<<<ctas, kThreads, 0, s>>>(map, stream, size, g.blocks, g.border, g.num_hc, out);
            return cudaGetLastError();
        }
    }
    decode_blocks_nd<Dims><<<ctas, kThreads, 0, s>>>(stream, size, g.blocks, g.border, vec, g.num_hc, out);
    return cudaGetLastError();
}

}  // namespace ndzip

// stream: `size` words at any 4-byte aligned address, header from word 0,
// size >= num_hc. out: the grid of `dims` (2 or 3) dims, its shape padded in
// front with 1s to (e0, e1, e2), with at least one whole block. Launches on
// the current device. Returns the CUDA error of the launch, 0 if none.
extern "C" int ndzip_decode_fp32_nd(const void* stream, int64_t size, int64_t dims, int64_t e0,
                                    int64_t e1, int64_t e2, void* out, void* cuda_stream) {
    using namespace ndzip;
    const auto* in = static_cast<const uint32_t*>(stream);
    auto* grid = static_cast<uint32_t*>(out);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return decode_nd<2>(in, size, e0, e1, e2, grid, s);
    if (dims == 3) return decode_nd<3>(in, size, e0, e1, e2, grid, s);
    return cudaErrorInvalidValue;
}

// CTAs of decode_blocks_nd for `dims` (2 or 3) that one SM holds at a time,
// or minus the CUDA error.
extern "C" int ndzip_decode_fp32_nd_ctas_per_sm(int64_t dims) {
    if (dims == 2) return ndzip::ctas_per_sm(ndzip::decode_blocks_nd<2>);
    if (dims == 3) return ndzip::ctas_per_sm(ndzip::decode_blocks_nd<3>);
    return -static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of decode_blocks_nd_box (3D grids whose rows start 16-byte aligned)
// that one SM holds at a time, or minus the CUDA error.
extern "C" int ndzip_decode_fp32_nd_box_ctas_per_sm() { return ndzip::ctas_per_sm(ndzip::decode_blocks_nd_box); }
