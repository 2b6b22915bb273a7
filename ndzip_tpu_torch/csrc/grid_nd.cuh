// Geometry shared by the fp32 2D/3D kernels (encode_fp32_nd.cu,
// decode_fp32_nd.cu): where a block lies in the grid, the row walk that moves
// a block between the grid and shared memory (walk_block, which the fp64
// kernels and stage_blocks_nd.cu move blocks with too), and the lines of a
// block along each axis that the transform walks.
//
// A grid of 2 or 3 dims is seen with three axes (e0, e1, e2), e0 = 1 in 2D.
// Its blocks are 64x64 (2D) or 16^3 (3D) words. In shared memory a block sits
// in its row-major order (common.cuh's pad), rows of kSide words along axis
// 2: word r*64 + c in 2D, z*256 + y*16 + x in 3D.
#pragma once

#include "common.cuh"

namespace ndzip {

template <int Dims>
struct Blocks {
    static_assert(Dims == 2 || Dims == 3, "the 2D/3D kernels");
    static constexpr int kSide = Dims == 2 ? 64 : 16;
    static constexpr int kSide0 = Dims == 3 ? kSide : 1;  // a block's extent along axis 0
    uint64_t e1, e2;  // extents of axes 1 and 2
    uint64_t g1, g2;  // whole blocks along axes 1 and 2

    // Offset in the grid of block b's first word; b runs row-major over the
    // block grid (ndzip_tpu/format.py:hypercube_origins), which is the
    // header's order.
    __device__ __forceinline__ uint64_t origin(uint64_t b) const {
        const uint64_t c2 = b % g2, c1 = (b / g2) % g1, c0 = b / g2 / g1;  // c0 = 0 in 2D
        return (c0 * kSide0 * e1 + c1 * kSide) * e2 + c2 * kSide;
    }
    // Offset from a block's first word of the first word of its row r.
    __device__ __forceinline__ uint64_t row(int r) const {
        return Dims == 2 ? r * e2 : (r / kSide) * e1 * e2 + (r % kSide) * e2;
    }
    // Offset from a block's first word of its word i (row-major in the block).
    __device__ __forceinline__ uint64_t word(int i) const { return row(i / kSide) + i % kSide; }
};

// The blocks and the border of a grid of extents (e0, e1, e2).
template <int Dims>
struct GridNd {
    Blocks<Dims> blocks;
    Border border;
    uint64_t num_hc;

    GridNd(uint64_t e0, uint64_t e1, uint64_t e2) {
        constexpr uint64_t S = Blocks<Dims>::kSide, S0 = Blocks<Dims>::kSide0;
        blocks = {e1, e2, e1 / S, e2 / S};
        const uint64_t g0 = e0 / S0, b0 = g0 * S0, b1 = blocks.g1 * S, b2 = blocks.g2 * S;
        num_hc = g0 * blocks.g1 * blocks.g2;
        border = {e1, e2, b0, b1, b2, e0 * e1 * e2 - b0 * b1 * b2};
    }
};

// Rows start 16-byte aligned when the grid does and its minor extent is a
// multiple of 4 words: then a block moves in 16-byte accesses.
inline bool rows_aligned(const void* grid, uint64_t e2) {
    return reinterpret_cast<uintptr_t>(grid) % 16 == 0 && e2 % 4 == 0;
}

// The walk of a block's words that every 2D/3D kernel moves a block through
// the grid with: thread t calls f(i) for block words i = W * (t + k *
// kThreads); the W words from i lie in one row, at geo.word(i) in the grid.
// W = 16 / sizeof(word) where every row starts 16-byte aligned (one 16-byte
// access a call), else 1. A warp covers whole rows.
template <int W, typename F>
__device__ __forceinline__ void walk_block(F f) {
    constexpr int kUnroll = W > 1 ? kHcSize / W / kThreads : 4;
#pragma unroll (kUnroll)
    for (int k = 0; k < kHcSize / W / kThreads; ++k) f(W * (static_cast<int>(threadIdx.x) + k * kThreads));
}

// Load the block whose first word is `block` into x, rotating each word left
// by one. A warp reads whole rows: 256 B (2D) or 64 B (3D) runs.
template <int Dims>
__device__ __forceinline__ void load_block(const uint32_t* __restrict__ block, const Blocks<Dims>& geo,
                                           bool vec, uint32_t* x) {
    if (vec) {
        walk_block<4>([&](int i) {
            const uint4 v = *reinterpret_cast<const uint4*>(block + geo.word(i));
            x[pad(i)] = rotl1(v.x);
            x[pad(i + 1)] = rotl1(v.y);
            x[pad(i + 2)] = rotl1(v.z);
            x[pad(i + 3)] = rotl1(v.w);
        });
    } else {
        walk_block<1>([&](int i) { x[pad(i)] = rotl1(block[geo.word(i)]); });
    }
}

// Store x into the block whose first word is `block`, rotating each word
// right by one.
template <int Dims>
__device__ __forceinline__ void store_block(uint32_t* __restrict__ block, const Blocks<Dims>& geo,
                                            bool vec, const uint32_t* x) {
    if (vec) {
        walk_block<4>([&](int i) {
            *reinterpret_cast<uint4*>(block + geo.word(i)) =
                make_uint4(rotr1(x[pad(i)]), rotr1(x[pad(i + 1)]), rotr1(x[pad(i + 2)]), rotr1(x[pad(i + 3)]));
        });
    } else {
        walk_block<1>([&](int i) { block[geo.word(i)] = rotr1(x[pad(i)]); });
    }
}

// The 16 block words start + k * step (k < 16) that thread t walks along
// `Axis`: segment s of its line, the segment before it being thread
// t - tstride's. Every line of a 3D block is 16 words, one segment; a 2D line
// is 64 words, four segments. Lanes run along x or y, never only along z, so
// each access of a warp touches 32 distinct banks (common.cuh's pad).
struct Segment {
    int start, step, s, tstride;
};

template <int Dims, int Axis>
__device__ __forceinline__ Segment segment(int t) {
    if (Dims == 2) {
        if (Axis == 1) return {16 * t, 1, t & 3, 1};                 // rows: four threads a row
        return {(t >> 6) * 16 * 64 + (t & 63), 64, t >> 6, 64};       // columns: lanes along x
    }
    if (Axis == 2) return {16 * t, 1, 0, 0};                          // lines along x
    if (Axis == 0) return {t, 256, 0, 0};                             // lines along z, lanes along (y, x)
    // lines along y, lanes along x; the two z of a warp differ by 2 mod 4,
    // which puts its two half-warps 16 banks apart
    const int w = t >> 5, lane = t & 31;
    const int z = 4 * (w >> 1) + (w & 1) + 2 * (lane >> 4);
    return {z * 256 + (lane & 15), 16, 0, 0};
}

}  // namespace ndzip
