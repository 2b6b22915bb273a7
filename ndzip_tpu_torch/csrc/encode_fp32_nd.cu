// fp32 2D/3D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp32 in
// tile2d/tile3d mode, launched by _encode_interior_fp32, together with the
// header and border glue of _encode_fp32_device for 2D/3D shapes (and the
// XLA gather route of shapes whose minor block-grid axis does not divide).
//
// The TPU kernel DMAs multi-block tiles of the full array and rearranges them
// into blocks in VMEM with XOR cell swaps sized to Mosaic's lane tiling. Here
// a CTA loads its one block straight from the grid, row by row (64 rows of 64
// words in 2D, 256 rows of 16 in 3D; 16-byte loads when every row starts
// aligned, else one word a lane), into shared memory in the block's row-major
// order. From there a chunk is 32 consecutive block words, as in 1D, so the
// transpose, heads, compaction and the three launches are those of the 1D
// encoder (encode_fp32.cu; common.cuh's encode_chunks and scan_lengths):
//   1. encode_blocks_nd<D, false>: block b = blockIdx.x, its origin split
//      row-major over the block grid (the header's order); load, transform,
//      count, write its length;
//   2. scan_lengths: header and stream length;
//   3. encode_blocks_nd<D, true>: recompute and place; CTAs past the blocks
//      copy the border after the last body word, 4096 elements each, in
//      format.border_slices order (common.cuh's Border).
// The transform is rotate-left-1, then first differences along each axis in
// the format's order (2D: 1, 0; 3D: 1, 2, 0), each a pass over shared memory
// in which a thread walks 16 words of one line (grid_nd.cuh's segment), then
// complement-negative.
//
// Bound: bytes, as the 1D encoder. Each element is read twice (passes 1 and
// 3) in rows of 256 B (2D) or 64 B (3D); the stream is written once. The
// per-axis passes add two shared-memory reads and one write per word and
// axis, and a barrier each. Element and stream offsets are 64-bit.

#include "grid_nd.cuh"

namespace ndzip {

// First differences along Axis in shared memory (the first word of each line
// stays); complement-negative after the last axis. Ends with a barrier.
template <int Dims, int Axis, bool kLast>
__device__ __forceinline__ void difference(uint32_t* x) {
    const Segment g = segment<Dims, Axis>(threadIdx.x);
    uint32_t v[kWordsPerThread];
    uint32_t prev = g.s ? x[pad(g.start - g.step)] : 0u;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) v[k] = x[pad(g.start + k * g.step)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const uint32_t d = v[k] - prev;
        prev = v[k];
        x[pad(g.start + k * g.step)] = kLast ? complement_negative(d) : d;
    }
    __syncthreads();
}

template <int Dims, bool kPlace>
__global__ void __launch_bounds__(kThreads)
encode_blocks_nd(const uint32_t* __restrict__ words, Blocks<Dims> geo, Border border, bool vec,
                 uint64_t num_hc, uint32_t* __restrict__ lengths, uint32_t* __restrict__ stream) {
    const uint64_t b = blockIdx.x;
    if (kPlace && b >= num_hc) {  // a border CTA
        encode_border(words, border, num_hc, b - num_hc, stream);
        return;
    }

    __shared__ EncodeShared s;
    load_block(words + geo.origin(b), geo, vec, s.x);
    __syncthreads();
    if constexpr (Dims == 2) {
        difference<2, 1, false>(s.x);
        difference<2, 0, true>(s.x);
    } else {
        difference<3, 1, false>(s.x);
        difference<3, 2, false>(s.x);
        difference<3, 0, true>(s.x);
    }
    encode_chunks<kPlace>(s, b, num_hc, lengths, stream);
}

template <int Dims>
int encode_nd(const uint32_t* in, uint64_t e0, uint64_t e1, uint64_t e2, uint32_t* out, uint32_t* lens,
              int32_t* length, cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    const bool vec = rows_aligned(in, e2);
    const auto grid = static_cast<unsigned>(g.num_hc);
    cudaError_t err;
    encode_blocks_nd<Dims, false><<<grid, kThreads, 0, s>>>(in, g.blocks, g.border, vec, g.num_hc,
                                                            lens, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_lengths<<<1, 1024, 0, s>>>(lens, g.num_hc, g.border.count, out, length);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    encode_blocks_nd<Dims, true><<<grid + border_ctas(g.border.count), kThreads, 0, s>>>(
        in, g.blocks, g.border, vec, g.num_hc, lens, out);
    return cudaGetLastError();
}

}  // namespace ndzip

// words: the grid of `dims` (2 or 3) dims, its shape padded in front with 1s
// to (e0, e1, e2), with at least one whole block. stream: room for the
// compressed bound. lengths: one word of scratch per block. length: one
// int32. Launches on the current device. Returns the first CUDA error of the
// launches, 0 if none.
extern "C" int ndzip_encode_fp32_nd(const void* words, int64_t dims, int64_t e0, int64_t e1, int64_t e2,
                                    void* stream, void* lengths, void* length, void* cuda_stream) {
    using namespace ndzip;
    const auto* in = static_cast<const uint32_t*>(words);
    auto* out = static_cast<uint32_t*>(stream);
    auto* lens = static_cast<uint32_t*>(lengths);
    auto* len = static_cast<int32_t*>(length);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return encode_nd<2>(in, e0, e1, e2, out, lens, len, s);
    if (dims == 3) return encode_nd<3>(in, e0, e1, e2, out, lens, len, s);
    return cudaErrorInvalidValue;
}
