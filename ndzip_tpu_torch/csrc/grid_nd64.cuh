// Geometry of the fp64 2D/3D kernels (encode_fp64_nd.cu, decode_fp64_nd.cu):
// the strided copy of a block of u64 words between the grid and shared
// memory. Where a block lies (Blocks, GridNd) and the lines the transform
// walks (segment) count words, not bytes, and come from grid_nd.cuh as the
// fp32 kernels use them; with common64.cuh's pad64 every segment pattern is
// free of bank conflicts, since each half-warp of 8-byte accesses runs on 16
// consecutive words aligned to 16 or on the scans' 16-word runs.
//
// A block row is kSide words: 64 x 8 B = 512 B in 2D, 16 x 8 B = 128 B in 3D.
#pragma once

#include "common64.cuh"
#include "grid_nd.cuh"

namespace ndzip {

// Rows start 16-byte aligned when the grid does and its minor extent is even
// (block origins and row starts are then even word offsets, kSide being
// even): then a block moves in 16-byte accesses of two words.
inline bool rows_aligned64(const void* grid, uint64_t e2) {
    return reinterpret_cast<uintptr_t>(grid) % 16 == 0 && e2 % 2 == 0;
}

// Load the block whose first word is `block` into x, rotating each word left
// by one. A warp reads whole rows: one 512 B row (2D) or four 128 B rows (3D).
template <int Dims>
__device__ __forceinline__ void load_block64(const u64* __restrict__ block, const Blocks<Dims>& geo,
                                             bool vec, u64* x) {
    if (vec) {
        walk_block<2>([&](int i) {
            const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(block + geo.word(i));
            x[pad64(i)] = rotl1(v.x);
            x[pad64(i + 1)] = rotl1(v.y);
        });
    } else {
        walk_block<1>([&](int i) { x[pad64(i)] = rotl1(block[geo.word(i)]); });
    }
}

// Store x into the block whose first word is `block`, rotating each word
// right by one.
template <int Dims>
__device__ __forceinline__ void store_block64(u64* __restrict__ block, const Blocks<Dims>& geo, bool vec,
                                              const u64* x) {
    if (vec) {
        walk_block<2>([&](int i) {
            *reinterpret_cast<ulonglong2*>(block + geo.word(i)) =
                make_ulonglong2(rotr1(x[pad64(i)]), rotr1(x[pad64(i + 1)]));
        });
    } else {
        walk_block<1>([&](int i) { block[geo.word(i)] = rotr1(x[pad64(i)]); });
    }
}

}  // namespace ndzip
