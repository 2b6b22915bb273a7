// fp64 2D/3D block decoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_decode_kernel_fp64 in
// tile2d/tile3d mode, launched by _decode_interior_fp64, together with the
// border glue of _decode_fp64_device for 2D/3D shapes (and the route through
// _decode_blocks_fp64 and _scatter_blocks_xla).
//
// The TPU kernel decodes G blocks a step into multi-block tiles of (lo, hi)
// planes and writes a minor-axis-padded array. Here, as in the fp32 decoder
// (decode_fp32_nd.cu), one CTA decodes one block (common64.cuh's
// expand_chunks64: only the words the block owns, each read clamped to the
// stream's size), runs the inverse transform in shared memory, and stores the
// block of u64 words straight into the grid of the exact shape, row by row.
// The inverse transform is complement-negative, then wrapping inclusive
// prefix sums along each axis in the reversed forward order (2D: 0, 1; 3D: 0,
// 2, 1), each a pass in which a thread scans 16 words of one line
// (grid_nd.cuh's segment; a 2D line's four segments add the sums of the ones
// before them), then rotate-right-1 on the store. CTAs past the blocks copy
// the border, 4096 elements each, from the stream to their places in
// format.border_slices order.
//
// Bound: bytes, as the 1D decoder: 8 B x ratio of stream read and 8 B
// written per element, in rows of 512 B (2D) or 128 B (3D). Its shared
// memory (37.6 KB a CTA) lets 5 CTAs share an SM. Element and stream offsets
// are 64-bit.

#include "grid_nd64.cuh"

namespace ndzip {

// Wrapping inclusive prefix sums along Axis in shared memory, after
// complement-negative on the first pass. Ends with a barrier.
template <int Dims, int Axis, bool kFirst>
__device__ __forceinline__ void prefix_sum64(DecodeShared64& s) {
    const int t = threadIdx.x;
    const Segment g = segment<Dims, Axis>(t);
    u64 v[kWordsPerThread];
    u64 sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const u64 u = s.x[pad64(g.start + k * g.step)];
        sum += kFirst ? complement_negative(u) : u;
        v[k] = sum;
    }
    if constexpr (Dims == 2) {  // add the sums of the segments before this one on its line
        s.partial[t] = sum;
        __syncthreads();
        u64 carry = 0;
        for (int j = 1; j <= g.s; ++j) carry += s.partial[t - j * g.tstride];
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) v[k] += carry;
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) s.x[pad64(g.start + k * g.step)] = v[k];
    __syncthreads();
}

// At most 48 registers, so that 5 CTAs share an SM as its shared memory
// allows: uncapped, ptxas takes 60-62 and 4 fit, and the 3D decoder ran 10%
// slower on an H100 (PERF.md, PR 3). The encoders are left uncapped: the same
// cap spilled and made them 3-14% slower.
template <int Dims>
__global__ void __launch_bounds__(kThreads, 5)
decode_blocks64_nd(const uint32_t* __restrict__ stream, uint64_t size, Blocks<Dims> geo, Border border,
                   bool vec, uint64_t num_hc, u64* __restrict__ out) {
    const uint64_t b = blockIdx.x;
    if (b >= num_hc) {  // a border CTA
        decode_border64(stream, size, num_hc, border, b - num_hc, out);
        return;
    }

    __shared__ DecodeShared64 s;
    expand_chunks64(s, stream, size, num_hc, b);
    if constexpr (Dims == 2) {
        prefix_sum64<2, 0, true>(s);
        prefix_sum64<2, 1, false>(s);
    } else {
        prefix_sum64<3, 0, true>(s);
        prefix_sum64<3, 2, false>(s);
        prefix_sum64<3, 1, false>(s);
    }
    store_block64(out + geo.origin(b), geo, vec, s.x);
}

template <int Dims>
int decode64_nd(const uint32_t* stream, uint64_t size, uint64_t e0, uint64_t e1, uint64_t e2, u64* out,
                cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    decode_blocks64_nd<Dims><<<static_cast<unsigned>(g.num_hc + border_ctas(g.border.count)), kThreads, 0,
                               s>>>(stream, size, g.blocks, g.border, rows_aligned64(out, e2), g.num_hc, out);
    return cudaGetLastError();
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
