// Stage kernels of the 2D/3D codec's block load and store, for Hopper
// (sm_90a): the strided copy of whole blocks between a grid and a dense
// (num_hc, 4096) array, for 32-bit (fp32) and 64-bit (fp64) words.
//
// Replaces the TPU probe dev/tile_xpose_probe.py:67 (the pallas_call of
// build(fn, ...).run, kernel :59-60), which times B3/B4's tile<->block
// rearrangement alone: codec_pallas.tile_to_blocks_2d/3d and
// blocks_to_tile_2d/3d (and their XOR cell-swap _bfly twins) between
// (64, G*64) or (16, 16, G*16) strips of G blocks and (G, 32, 128) blocks in
// row-major block order. Here the strip is any 2D/3D grid with at least one
// whole block (a strip is the grid (64, G*64) or (16, 16, G*16)), and the
// copy is the one B3/B6 and B4/B8 make, without transform or border:
//   * gather_blocks: CTA b reads block b (row-major over the block grid, the
//     header's order: grid_nd.cuh's Blocks) from the grid row by row and
//     writes it to blocks[b] in the block's row-major order;
//   * scatter_blocks: the inverse; grid words outside whole blocks are left
//     as they are.
// Rows move by grid_nd.cuh's walk_block, the walk B3/B4/B6/B8 move a block
// with: 16-byte accesses when every row starts 16-byte aligned, else one word
// a lane; a warp covers 256 B rows in 2D, 64 B (fp32) or 128 B (fp64) rows in
// 3D. These kernels take the strided load and store out of B3/B4/B6/B8 so
// that they can be timed alone. They copy global memory to global memory:
// the codec kernels' other side of the walk is shared memory, with a rotate
// of each word, which these do not time.
//
// Bound: bytes. Each block word is read once and written once: 2 x 16 KiB
// (fp32) or 2 x 32 KiB (fp64) a block, in row runs of the sizes above.

#include "grid_nd64.cuh"

namespace ndzip {

template <typename T> struct Vec16;  // 16 bytes of words of type T
template <> struct Vec16<uint32_t> { using type = uint4; };
template <> struct Vec16<u64> { using type = ulonglong2; };

template <int Dims, typename T, bool kGather>
__global__ void __launch_bounds__(kThreads)
move_blocks(T* __restrict__ grid, Blocks<Dims> geo, bool vec, T* __restrict__ blocks) {
    using V = typename Vec16<T>::type;
    const uint64_t b = blockIdx.x;
    T* block = grid + geo.origin(b);
    T* dense = blocks + b * kHcSize;
    if (vec) {
        walk_block<sizeof(V) / sizeof(T)>([&](int i) {
            V* g = reinterpret_cast<V*>(block + geo.word(i));
            V* d = reinterpret_cast<V*>(dense + i);
            if constexpr (kGather) *d = *g; else *g = *d;
        });
    } else {
        walk_block<1>([&](int i) {
            if constexpr (kGather) dense[i] = block[geo.word(i)]; else block[geo.word(i)] = dense[i];
        });
    }
}

template <typename T, int Dims>
int move_nd(T* grid, uint64_t e0, uint64_t e1, uint64_t e2, T* blocks, bool gather, cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    const bool aligned = sizeof(T) == 4 ? rows_aligned(grid, e2) : rows_aligned64(grid, e2);
    const bool vec = aligned && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
    const auto ctas = static_cast<unsigned>(g.num_hc);
    if (gather)
        move_blocks<Dims, T, true><<<ctas, kThreads, 0, s>>>(grid, g.blocks, vec, blocks);
    else
        move_blocks<Dims, T, false><<<ctas, kThreads, 0, s>>>(grid, g.blocks, vec, blocks);
    return cudaGetLastError();
}

template <typename T>
int move(void* grid, int64_t dims, int64_t e0, int64_t e1, int64_t e2, void* blocks, bool gather,
         void* cuda_stream) {
    auto* gp = static_cast<T*>(grid);
    auto* bp = static_cast<T*>(blocks);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return move_nd<T, 2>(gp, e0, e1, e2, bp, gather, s);
    if (dims == 3) return move_nd<T, 3>(gp, e0, e1, e2, bp, gather, s);
    return cudaErrorInvalidValue;
}

int move_words(void* grid, int64_t word_bytes, int64_t dims, int64_t e0, int64_t e1, int64_t e2,
               void* blocks, bool gather, void* cuda_stream) {
    if (word_bytes == 4) return move<uint32_t>(grid, dims, e0, e1, e2, blocks, gather, cuda_stream);
    if (word_bytes == 8) return move<u64>(grid, dims, e0, e1, e2, blocks, gather, cuda_stream);
    return cudaErrorInvalidValue;
}

}  // namespace ndzip

// grid: `dims` (2 or 3) dims of words of `word_bytes` (4 or 8) bytes, its
// shape padded in front with 1s to (e0, e1, e2), with at least one whole
// block. blocks: num_hc * 4096 words of the same size. gather copies the
// grid's blocks into `blocks`, scatter the other way. Launch on the current
// device; return the CUDA error of the launch, 0 if none.
extern "C" int ndzip_gather_blocks_nd(const void* grid, int64_t word_bytes, int64_t dims, int64_t e0,
                                      int64_t e1, int64_t e2, void* blocks, void* cuda_stream) {
    return ndzip::move_words(const_cast<void*>(grid), word_bytes, dims, e0, e1, e2, blocks, true,
                             cuda_stream);
}

extern "C" int ndzip_scatter_blocks_nd(const void* blocks, int64_t word_bytes, int64_t dims, int64_t e0,
                                       int64_t e1, int64_t e2, void* grid, void* cuda_stream) {
    return ndzip::move_words(grid, word_bytes, dims, e0, e1, e2, const_cast<void*>(blocks), false,
                             cuda_stream);
}
