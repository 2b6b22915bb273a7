// Geometry shared by the fp32 2D/3D kernels (encode_fp32_nd.cu,
// decode_fp32_nd.cu): where a block lies in the grid, the row walk that moves
// a block between the grid and shared memory (walk_block, which the fp64
// kernels and stage_blocks_nd.cu move blocks with too), the tensor map that
// moves a 3D block as one box instead (box_map), and the lines of a block
// along each axis that the transform walks.
//
// A grid of 2 or 3 dims is seen with three axes (e0, e1, e2), e0 = 1 in 2D.
// Its blocks are 64x64 (2D) or 16^3 (3D) words. In shared memory a block sits
// in its row-major order (common.cuh's pad), rows of kSide words along axis
// 2: word r*64 + c in 2D, z*256 + y*16 + x in 3D.
#pragma once

#include <cuda.h>  // CUtensorMap and its encoding's types; the function is found at run time

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
    // origin(b) in 32-bit arithmetic (a grid's block count fits 32 bits): a
    // fraction of the instructions of three 64-bit divisions, which weigh on
    // a kernel that runs a few hundred instructions a thread and block.
    __device__ __forceinline__ uint64_t origin32(uint32_t b) const {
        const uint32_t n1 = static_cast<uint32_t>(g1), n2 = static_cast<uint32_t>(g2);
        const uint32_t c2 = b % n2, q = b / n2;
        const uint64_t c1 = Dims == 2 ? q : q % n1, c0 = Dims == 2 ? 0 : q / n1;
        return (c0 * kSide0 * e1 + c1 * kSide) * e2 + static_cast<uint64_t>(c2) * kSide;
    }
    // Block b's first word as coordinates in the grid, innermost first:
    // (x, y, z) = (axis 2, axis 1, axis 0), in 32-bit arithmetic. What a
    // tensor map's box is placed by (3D).
    __device__ __forceinline__ uint3 corner32(uint32_t b) const {
        const uint32_t n1 = static_cast<uint32_t>(g1), n2 = static_cast<uint32_t>(g2);
        const uint32_t q = b / n2;
        return make_uint3(kSide * (b % n2), kSide * (q % n1), kSide0 * (q / n1));
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

// The tensor map of a 3D grid of (e0, e1, e2) u32 words whose rows start
// 16-byte aligned (rows_aligned: the map needs a 16-byte aligned base and
// strides of 16-byte multiples), with a 16^3 box and the L2 asked for whole
// 128-byte lines, as load_block asks: what the 3D encoder loads a block
// through (encode_fp32_nd.cu) and the 3D decoder stores one through
// (decode_fp32_nd.cu). No element of a block's box lies outside the grid.
// cuTensorMapEncodeTiled is looked up once through the runtime, so the
// library links no -lcuda. Returns 0 or the error of the encoding.
inline int box_map(CUtensorMap* map, const uint32_t* grid, uint64_t e0, uint64_t e1, uint64_t e2) {
    using Encode = decltype(&cuTensorMapEncodeTiled);
    static const Encode encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
    }();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {e2, e1, e0};                   // innermost first
    const cuuint64_t strides[2] = {4 * e2, 4 * e1 * e2};        // bytes, of axes 1 and 0
    const cuuint32_t box[3] = {16, 16, 16}, steps[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<uint32_t*>(grid), dims, strides, box, steps,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// CTAs of `kernel` (kThreads threads, static shared memory) that one SM
// holds at a time, or minus the CUDA error.
template <typename Kernel>
int ctas_per_sm(Kernel kernel) {
    int ctas = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, 0);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
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

// Load the block whose first word is `block` into x: each word rotated left by
// one, less its rotated left neighbour in the row (the first word of a row
// stays): the forward transform's differences along the rows, which commute
// with those along the other axes, done on the way in. The 2D encoder's load,
// and the 3D encoder's where rows do not start 16-byte aligned; a 3D grid
// whose rows do moves each block as one tensor-map box (encode_fp32_nd.cu's
// encode_blocks_nd_box). A warp reads whole
// rows: 256 B (2D) or 64 B (3D) runs. With 16-byte loads the neighbour comes
// from the lane before (a row starts at lane 0 of its 4 or 16 lanes), and the
// load asks the L2 for the whole 128-byte line: the other half of a 3D row's
// line belongs to the next block along the row, which a CTA running at the
// same time reads. One word a lane reads its neighbour again, from the L1.
template <int Dims>
__device__ __forceinline__ void load_block(const uint32_t* __restrict__ block, const Blocks<Dims>& geo,
                                           bool vec, uint32_t* x) {
    constexpr int kSide = Blocks<Dims>::kSide;
    if (vec) {
        walk_block<4>([&](int i) {
            uint4 v;
            asm volatile("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
                         : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                         : "l"(block + geo.word(i)));
            const uint32_t a = rotl1(v.x), b = rotl1(v.y), c = rotl1(v.z), d = rotl1(v.w);
            const uint32_t left = __shfl_up_sync(kFull, d, 1);
            x[pad(i)] = a - (i % kSide ? left : 0u);
            x[pad(i + 1)] = b - a;
            x[pad(i + 2)] = c - b;
            x[pad(i + 3)] = d - c;
        });
    } else {
        walk_block<1>([&](int i) {
            const uint32_t* p = block + geo.word(i);
            x[pad(i)] = rotl1(p[0]) - (i % kSide ? rotl1(p[-1]) : 0u);
        });
    }
}

// Ask the L2 for the block whose first word is `block`, one prefetch for
// each 128-byte piece of a row (two a 2D row; a 3D row's 64 bytes lie in one
// line): for a block that another CTA will load soon. Beside load_block; the
// box path asks with one tensor prefetch instead (common.cuh's
// tensor_prefetch_l2).
template <int Dims>
__device__ __forceinline__ void prefetch_block(const uint32_t* block, const Blocks<Dims>& geo) {
    constexpr int kPieces = Dims == 2 ? 2 : 1;
    const int t = threadIdx.x;
    if (t < kPieces * (kHcSize / Blocks<Dims>::kSide))
        asm volatile("prefetch.global.L2 [%0];" ::"l"(block + geo.row(t / kPieces) + 32 * (t % kPieces)));
}

// Store x into the block whose first word is `block`, one word a lane,
// rotating each word right by one (rows that do not start 16-byte aligned).
template <int Dims>
__device__ __forceinline__ void store_block_words(uint32_t* __restrict__ block, const Blocks<Dims>& geo,
                                                  const uint32_t* x) {
    walk_block<1>([&](int i) { block[geo.word(i)] = rotr1(x[pad(i)]); });
}

// The wrapping inclusive prefix sums of x along the rows, each rotated right
// by one: the inverse transform's sums along the rows, which commute with
// those along the other axes, taken in registers on the way out. Thread t
// calls f(i, v) with the four words from block word i (walk_block<4>'s i) in
// v: it sums its four words, and the 4 or 16 lanes of a row scan their sums.
template <int Dims, typename F>
__device__ __forceinline__ void rowsum_words(const uint32_t* x, F f) {
    constexpr int kLanes = Blocks<Dims>::kSide / 4;  // lanes a row
    const int at = threadIdx.x & (kLanes - 1);
    walk_block<4>([&](int i) {
        const uint32_t a = x[pad(i)], b = a + x[pad(i + 1)], c = b + x[pad(i + 2)], d = c + x[pad(i + 3)];
        uint32_t sum = d;
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
            const uint32_t up = __shfl_up_sync(kFull, sum, off);
            if (at >= off) sum += up;
        }
        const uint32_t before = sum - d;
        f(i, make_uint4(rotr1(a + before), rotr1(b + before), rotr1(c + before), rotr1(d + before)));
    });
}

// Store x with its sums along the rows (rowsum_words) into the block whose
// first word is `block`, with 16-byte stores (rows start 16-byte aligned).
// The 2D decoder's store; a 3D block whose rows are aligned goes out as one
// tensor-map box instead (decode_fp32_nd.cu's decode_blocks_nd_box).
template <int Dims>
__device__ __forceinline__ void store_block_rowsum(uint32_t* __restrict__ block, const Blocks<Dims>& geo,
                                                   const uint32_t* x) {
    rowsum_words<Dims>(x, [&](int i, uint4 v) { *reinterpret_cast<uint4*>(block + geo.word(i)) = v; });
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
