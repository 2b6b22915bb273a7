// Geometry of the fp64 2D/3D kernels (encode_fp64_nd.cu, decode_fp64_nd.cu):
// the strided copy of a block of u64 words between the grid and shared
// memory, the encoder's with the differences along the rows and the
// decoder's with the sums along the rows, and the encoder's L2 prefetch.
// Where a block lies (Blocks, GridNd) and the lines the transform walks
// (segment) count words, not bytes, and come from grid_nd.cuh as the fp32
// kernels use them; with common64.cuh's pad64 every segment pattern is free
// of bank conflicts, since each half-warp of 8-byte accesses runs on 16
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

// Load the block whose first word is `block` into x: each word rotated left by
// one, less its rotated left neighbour in the row (the first word of a row
// stays): the forward transform's differences along the rows, done on the
// way in, as grid_nd.cuh's load_block does for fp32. A warp reads whole rows:
// one 512 B row (2D) or four 128 B rows (3D). With 16-byte loads of two words
// the neighbour comes from the lane before (a row starts at lane 0 of its 32
// or 8 lanes); one word a lane reads its neighbour again, from the L1. A 3D
// row is a whole 128-byte line, so the L2 hint of load_block, which serves
// two 3D blocks that share a line, has nothing to serve here: with it or
// without, the same time (PERF.md).
template <int Dims>
__device__ __forceinline__ void load_block64(const u64* __restrict__ block, const Blocks<Dims>& geo,
                                             bool vec, u64* x) {
    constexpr int kSide = Blocks<Dims>::kSide;
    if (vec) {
        walk_block<2>([&](int i) {
            const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(block + geo.word(i));
            const u64 a = rotl1(v.x), c = rotl1(v.y);
            const u64 left = __shfl_up_sync(kFull, c, 1);
            x[pad64(i)] = a - (i % kSide ? left : 0ull);
            x[pad64(i + 1)] = c - a;
        });
    } else {
        walk_block<1>([&](int i) {
            const u64* p = block + geo.word(i);
            x[pad64(i)] = rotl1(p[0]) - (i % kSide ? rotl1(p[-1]) : 0ull);
        });
    }
}

// Ask the L2 for the block whose first word is `block`, one prefetch for
// each 128-byte piece of a row (four a 2D row of 512 B, one a 3D row): 256
// pieces, one a thread, in both cases. For a block that another CTA will
// load soon.
template <int Dims>
__device__ __forceinline__ void prefetch_block64(const u64* block, const Blocks<Dims>& geo) {
    constexpr int kPieces = Blocks<Dims>::kSide / 16;
    static_assert(kPieces * (kHcSize / Blocks<Dims>::kSide) == kThreads, "one piece a thread");
    const int t = threadIdx.x;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(block + geo.row(t / kPieces) + 16 * (t % kPieces)));
}

// Store x into the block whose first word is `block`, one word a lane,
// rotating each word right by one (rows that do not start 16-byte aligned).
template <int Dims>
__device__ __forceinline__ void store_block64(u64* __restrict__ block, const Blocks<Dims>& geo, const u64* x) {
    walk_block<1>([&](int i) { block[geo.word(i)] = rotr1(x[pad64(i)]); });
}

// Store the wrapping inclusive prefix sums of x along the rows into the block
// whose first word is `block`, each rotated right by one, with 16-byte stores
// of two words (rows start 16-byte aligned): the inverse transform's sums
// along the rows, which commute with those along the other axes, done in
// registers on the way out, as grid_nd.cuh's store_block_rowsum does for
// fp32. A lane sums its two words, and the 32 lanes of a 2D row (512 B) or
// the 8 of a 3D row (128 B) scan their sums.
template <int Dims>
__device__ __forceinline__ void store_block64_rowsum(u64* __restrict__ block, const Blocks<Dims>& geo,
                                                     const u64* x) {
    constexpr int kLanes = Blocks<Dims>::kSide / 2;  // lanes a row
    const int at = threadIdx.x & (kLanes - 1);
    walk_block<2>([&](int i) {
        const u64 a = x[pad64(i)], c = a + x[pad64(i + 1)];
        u64 sum = c;
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
            const u64 up = __shfl_up_sync(kFull, sum, off);
            if (at >= off) sum += up;
        }
        const u64 before = sum - c;
        *reinterpret_cast<ulonglong2*>(block + geo.word(i)) = make_ulonglong2(rotr1(a + before), rotr1(c + before));
    });
}

}  // namespace ndzip
