// fp64 2D/3D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp64 in
// tile2d/tile3d mode, launched by _decode_interior_fp64, together with the
// border glue of _decode_fp64_device for 2D/3D shapes (and the route through
// _decode_blocks_fp64 and _scatter_blocks_xla).
//
// The TPU kernel decodes G blocks a step into multi-block tiles of (lo, hi)
// planes and writes a minor-axis-padded array. Here, as in the fp32 decoder
// (decode_fp32_nd.cu), a block's words are taken as what they are, one
// contiguous run of the stream known from two header words, and the block
// goes straight into the grid of the exact shape:
//   * one CTA decodes one block, in the header's order (row-major over the
//     block grid). Its thread 0 starts the bulk copy of the run into shared
//     memory (common64.cuh's start_run_copy64, the 1D decoder's) and splits
//     the block's index over the block grid, once, in 32-bit arithmetic;
//   * each warp gathers its 8 chunks from the run and transposes them
//     (expand_run64) into the same buffer, now the padded block that the
//     passes below walk;
//   * the inverse transform is complement-negative, then wrapping inclusive
//     prefix sums along each axis, then rotate-right-1. The sums along
//     different axes commute, so they need not run in the format's reversed
//     order: those along the columns (2D) or along z and then y (3D) are each
//     a pass over shared memory in which a thread scans 16 words of one line
//     (grid_nd.cuh's segment; a 2D column's four segments add the sums of the
//     ones before them), and those along the rows are taken in registers on
//     the store, where the 32 or 8 lanes of a row scan their sums
//     (grid_nd64.cuh's store_block64_rowsum). Rows that do not start 16-byte
//     aligned are stored one word a lane, after one more pass for their sums;
//   * a damaged or truncated stream cannot fault: the run is clamped to
//     64 .. 4160 words and to the stream's size, and what lies past it reads
//     as 0;
//   * CTAs past the blocks copy the border, 4096 elements each, from the
//     stream to their places in format.border_slices order, each read clamped.
//
// Bound: bytes, as the 1D decoder: 8 B x ratio of stream read and 8 B
// written per element, in rows of 512 B (2D) or 128 B (3D). The run and the
// block share one buffer; with the 2D passes' partial sums 35-37 KB of shared
// memory a CTA. As in the 1D decoder the registers, 64, set four CTAs an SM:
// bound to five the kernel spilled 12-36 bytes a thread and to six 160-216,
// and a run buffer beside the block (70 KB, three CTAs an SM) took 4-9% more
// time (at 512^3 elements on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// §6). Element and stream offsets are 64-bit.

#include "grid_nd64.cuh"

namespace ndzip {

template <int Dims>
struct DecodeNdShared64 {
    alignas(16) u64 x[kPadded64];           // the block's run as the copy brings it in, then the block
    u64 partial[Dims == 2 ? kThreads : 1];  // the 2D scans' per-thread sums
    uint64_t full;                          // mbarrier: the run has arrived
    uint64_t origin;                        // of the CTA's block in the grid
    RunView64 run;
};

// Wrapping inclusive prefix sums along Axis in shared memory, after
// complement-negative on the first pass. Ends with a barrier.
template <int Dims, int Axis, bool kFirst>
__device__ __forceinline__ void prefix_sum64(u64* x, u64* partial) {
    const int t = threadIdx.x;
    const Segment g = segment<Dims, Axis>(t);
    u64 v[kWordsPerThread];
    u64 sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const u64 u = x[pad64(g.start + k * g.step)];
        sum += kFirst ? complement_negative(u) : u;
        v[k] = sum;
    }
    if constexpr (Dims == 2) {  // add the sums of the segments before this one on its line
        partial[t] = sum;
        __syncthreads();
        u64 carry = 0;
        for (int j = 1; j <= g.s; ++j) carry += partial[t - j * g.tstride];
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) v[k] += carry;
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) x[pad64(g.start + k * g.step)] = v[k];
    __syncthreads();
}

template <int Dims>
__global__ void __launch_bounds__(kThreads, 4)
decode_blocks64_nd(const uint32_t* __restrict__ stream, uint64_t size, Blocks<Dims> geo, Border border,
                   bool vec, uint64_t num_hc, u64* __restrict__ out) {
    const int t = threadIdx.x;
    const uint32_t b = blockIdx.x;
    if (b >= num_hc) {  // a border CTA
        decode_border64(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ DecodeNdShared64<Dims> s;
    if (t == 0) {  // the header lies inside the stream
        mbarrier_init(&s.full, 1);
        mbarrier_init_fence();
        start_run_copy64(stream, size, num_hc, b ? stream[b - 1] : 0u, stream[b], s.x, s.run, &s.full);
        s.origin = geo.origin32(b);
    }
    __syncthreads();
    mbarrier_wait(&s.full, 0);
    expand_run64(s.x, s.run);

    prefix_sum64<Dims, 0, true>(s.x, s.partial);
    if constexpr (Dims == 3) prefix_sum64<3, 1, false>(s.x, s.partial);
    if (vec) {  // the sums along the rows in registers, on the way out
        store_block64_rowsum(out + s.origin, geo, s.x);
    } else {
        prefix_sum64<Dims, Dims - 1, false>(s.x, s.partial);
        store_block64(out + s.origin, geo, s.x);
    }
}

template <int Dims>
int decode64_nd(const uint32_t* stream, uint64_t size, uint64_t e0, uint64_t e1, uint64_t e2, u64* out,
                cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    decode_blocks64_nd<Dims><<<static_cast<unsigned>(g.num_hc + border_ctas(g.border.count)), kThreads, 0,
                               s>>>(stream, size, g.blocks, g.border, rows_aligned64(out, e2), g.num_hc, out);
    return cudaGetLastError();
}

template <int Dims>
int decode64_nd_ctas_per_sm() {
    int ctas = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, decode_blocks64_nd<Dims>, kThreads, 0);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

}  // namespace ndzip

// stream: `size` u32 words (even), header from word 0, 8-byte aligned. out:
// the u64 grid of `dims` (2 or 3) dims, its shape padded in front with 1s to
// (e0, e1, e2), with at least one whole block. Launches on the current
// device. Returns the CUDA error of the launch, 0 if none.
extern "C" int ndzip_decode_fp64_nd(const void* stream, int64_t size, int64_t dims, int64_t e0,
                                    int64_t e1, int64_t e2, void* out, void* cuda_stream) {
    using namespace ndzip;
    const auto* in = static_cast<const uint32_t*>(stream);
    auto* grid = static_cast<u64*>(out);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return decode64_nd<2>(in, size, e0, e1, e2, grid, s);
    if (dims == 3) return decode64_nd<3>(in, size, e0, e1, e2, grid, s);
    return cudaErrorInvalidValue;
}

// CTAs of decode_blocks64_nd for `dims` (2 or 3) that one SM holds at a time,
// or minus the CUDA error.
extern "C" int ndzip_decode_fp64_nd_ctas_per_sm(int64_t dims) {
    if (dims == 2) return ndzip::decode64_nd_ctas_per_sm<2>();
    if (dims == 3) return ndzip::decode64_nd_ctas_per_sm<3>();
    return -static_cast<int>(cudaErrorInvalidValue);
}
