// fp64 2D/3D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp64 in
// tile2d/tile3d mode, launched by _encode_interior_fp64, together with the
// header, pad and border glue of _encode_fp64_device for 2D/3D shapes (and
// the XLA gather route into _encode_blocks_fp64 of shapes whose minor
// block-grid axis does not divide).
//
// The TPU kernel DMAs multi-block tiles of both (lo, hi) planes and
// rearranges them into blocks in VMEM. Here, as in the fp32 encoder
// (encode_fp32_nd.cu), a CTA loads its one block of u64 words straight from
// the grid, row by row (64 rows of 64 words in 2D, 256 rows of 16 in 3D;
// 16-byte loads of two words when every row starts aligned, else one word a
// lane), into shared memory in the block's row-major order. From there a
// chunk is 64 consecutive block words, as in 1D, so the transpose, heads,
// compaction and the three launches are those of the fp64 1D encoder
// (encode_fp64.cu; common64.cuh's encode_chunks64 and scan_lengths64):
//   1. encode_blocks64_nd<D, false>: load, transform, count, write the length;
//   2. scan_lengths64: header, pad entry and stream length;
//   3. encode_blocks64_nd<D, true>: recompute and place; CTAs past the blocks
//      copy the border after the last body word, 4096 elements each, in
//      format.border_slices order (common.cuh's Border).
// The transform is rotate-left-1, then first differences along each axis in
// the format's order (2D: 1, 0; 3D: 1, 2, 0), each a pass over shared memory
// in which a thread walks 16 words of one line (grid_nd.cuh's segment), then
// complement-negative.
//
// Bound: bytes, as the 1D encoder: each element is read twice (8 B in passes
// 1 and 3) in rows of 512 B (2D) or 128 B (3D); the stream is written once.
// Element and stream offsets are 64-bit.

#include "grid_nd64.cuh"

namespace ndzip {

// First differences along Axis in shared memory (the first word of each line
// stays); complement-negative after the last axis. Ends with a barrier.
template <int Dims, int Axis, bool kLast>
__device__ __forceinline__ void difference64(u64* x) {
    const Segment g = segment<Dims, Axis>(threadIdx.x);
    u64 v[kWordsPerThread];
    u64 prev = g.s ? x[pad64(g.start - g.step)] : 0ull;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) v[k] = x[pad64(g.start + k * g.step)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const u64 d = v[k] - prev;
        prev = v[k];
        x[pad64(g.start + k * g.step)] = kLast ? complement_negative(d) : d;
    }
    __syncthreads();
}

template <int Dims, bool kPlace>
__global__ void __launch_bounds__(kThreads)
encode_blocks64_nd(const u64* __restrict__ words, Blocks<Dims> geo, Border border, bool vec,
                   uint64_t num_hc, uint32_t* __restrict__ lengths, uint32_t* __restrict__ stream) {
    const uint64_t b = blockIdx.x;
    if (kPlace && b >= num_hc) {  // a border CTA
        encode_border64(words, border, num_hc, b - num_hc, stream);
        return;
    }

    __shared__ EncodeShared64 s;
    load_block64(words + geo.origin(b), geo, vec, s.x);
    __syncthreads();
    if constexpr (Dims == 2) {
        difference64<2, 1, false>(s.x);
        difference64<2, 0, true>(s.x);
    } else {
        difference64<3, 1, false>(s.x);
        difference64<3, 2, false>(s.x);
        difference64<3, 0, true>(s.x);
    }
    encode_chunks64<kPlace>(s, b, num_hc, lengths, stream);
}

template <int Dims>
int encode64_nd(const u64* in, uint64_t e0, uint64_t e1, uint64_t e2, uint32_t* out, uint32_t* lens,
                int32_t* length, cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    const bool vec = rows_aligned64(in, e2);
    const auto grid = static_cast<unsigned>(g.num_hc);
    cudaError_t err;
    encode_blocks64_nd<Dims, false><<<grid, kThreads, 0, s>>>(in, g.blocks, g.border, vec, g.num_hc,
                                                              lens, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_lengths64<<<1, 1024, 0, s>>>(lens, g.num_hc, g.border.count, out, length);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    encode_blocks64_nd<Dims, true><<<grid + border_ctas(g.border.count), kThreads, 0, s>>>(
        in, g.blocks, g.border, vec, g.num_hc, lens, out);
    return cudaGetLastError();
}

}  // namespace ndzip

// words: the u64 grid of `dims` (2 or 3) dims, its shape padded in front with
// 1s to (e0, e1, e2), with at least one whole block, 8-byte aligned. stream:
// room for the fp64 compressed bound, 8-byte aligned. lengths: one word of
// scratch per block. length: one int32. Launches on the current device.
// Returns the first CUDA error of the launches, 0 if none.
extern "C" int ndzip_encode_fp64_nd(const void* words, int64_t dims, int64_t e0, int64_t e1, int64_t e2,
                                    void* stream, void* lengths, void* length, void* cuda_stream) {
    using namespace ndzip;
    const auto* in = static_cast<const u64*>(words);
    auto* out = static_cast<uint32_t*>(stream);
    auto* lens = static_cast<uint32_t*>(lengths);
    auto* len = static_cast<int32_t*>(length);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return encode64_nd<2>(in, e0, e1, e2, out, lens, len, s);
    if (dims == 3) return encode64_nd<3>(in, e0, e1, e2, out, lens, len, s);
    return cudaErrorInvalidValue;
}
