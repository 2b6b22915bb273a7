// Pieces shared by the fp32 encode and decode kernels of the ndzip format
// (1D in encode_fp32.cu/decode_fp32.cu, 2D/3D in encode_fp32_nd.cu/
// decode_fp32_nd.cu): block geometry, the word transforms, the warp-wide
// 32x32 bit transpose, the scans, the per-block encode tail and decode head
// that follow and precede the transform, the header scan and the border map.
// One CTA of kThreads threads works on one 4096-word block staged in shared
// memory in the block's row-major order, so a chunk is 32 consecutive block
// words whatever the dimensionality. Border elements are copied by border
// CTAs after the blocks' CTAs, 4096 each, on both sides.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ndzip {

constexpr int kHcSize = 4096;                         // words per block
constexpr int kChunks = kHcSize / 32;                 // 32-word chunks = head words per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerThread = kHcSize / kThreads;   // 16 words per thread in the scans
constexpr int kChunksPerWarp = kChunks / kWarps;      // 16
constexpr int kPadded = kHcSize + kHcSize / 32;       // shared words with padding
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory slot of block word i, one pad word after every 32. With it
// both access patterns are free of bank conflicts: lane j of a warp on word
// 32c + j (chunk c), and thread t on words 16t .. 16t + 15 (scans).
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ uint32_t rotl1(uint32_t v) { return (v << 1) | (v >> 31); }
__device__ __forceinline__ uint32_t rotr1(uint32_t v) { return (v >> 1) | (v << 31); }

// If the sign bit is set, flip every other bit (an involution).
__device__ __forceinline__ uint32_t complement_negative(uint32_t v) {
    return (v & 0x80000000u) ? v ^ 0x7fffffffu : v;
}

__device__ __forceinline__ uint32_t lanemask_lt(int lane) { return (1u << lane) - 1u; }

// Stream word i, or 0 past the stream's size: a damaged stream cannot fault.
__device__ __forceinline__ uint32_t load_clamped(const uint32_t* stream, uint64_t size, uint64_t i) {
    return i < size ? stream[i] : 0u;
}

// 32x32 bit-matrix transpose across a warp. Lane r holds word r of a chunk;
// on return lane i holds word i of the transpose, in the format's MSB-first
// convention: out[i] bit (31-j) == in[j] bit (31-i). The butterfly of
// ndzip_tpu/ops/bitops.py:transpose_bits with lanes for rows: at shift j,
// the upper lane of each pair takes the lower lane's bits outside mask m
// shifted down, the lower lane the upper's bits inside m shifted up.
__device__ __forceinline__ uint32_t warp_transpose_bits(uint32_t x, int lane) {
    const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        const int j = 16 >> s;
        const uint32_t m = masks[s];
        const uint32_t p = __shfl_xor_sync(kFull, x, j);
        x = (lane & j) ? ((x & m) | ((p << j) & ~m)) : ((x & ~m) | ((p >> j) & m));
    }
    return x;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += t;
    }
    return v;
}

// Exclusive scan, in place, of the kChunks per-chunk counts of a block.
// Called by all of warp 0.
__device__ __forceinline__ void chunk_exclusive_scan(uint32_t* counts, int lane) {
    static_assert(kChunks == 4 * 32, "each lane scans four chunks");
    const uint32_t c0 = counts[4 * lane], c1 = counts[4 * lane + 1];
    const uint32_t c2 = counts[4 * lane + 2], c3 = counts[4 * lane + 3];
    const uint32_t sum = c0 + c1 + c2 + c3;
    const uint32_t incl = warp_inclusive_scan(sum, lane);
    const uint32_t excl = incl - sum;
    counts[4 * lane] = excl;
    counts[4 * lane + 1] = excl + c0;
    counts[4 * lane + 2] = excl + c0 + c1;
    counts[4 * lane + 3] = excl + c0 + c1 + c2;
}

// The border of a grid of 1-3 dims on its three-axis view: the shape padded
// in front with extents of 1, each padded axis counted as covered by whole
// blocks. In stream order (ndzip_tpu/format.py:border_slices) the border is,
// for each p < b0, first words[p, :b1, b2:] then words[p, b1:, :], and after
// them words[b0:]. The mapping is ndzip_tpu_torch/codec_torch.py:
// border_offsets, which the tests hold to border_slices.
struct Border {
    uint64_t e1, e2;      // extents of axes 1 and 2
    uint64_t b0, b1, b2;  // extents of axes 0, 1, 2 covered by whole blocks
    uint64_t count;       // border elements

    // Linear offset in the grid of stream-order border element i.
    __device__ __forceinline__ uint64_t offset(uint64_t i) const {
        const uint64_t r2 = e2 - b2, rows = b1 * r2, per_p = rows + (e1 - b1) * e2;
        if (i >= b0 * per_p) return b0 * e1 * e2 + (i - b0 * per_p);
        const uint64_t p = i / per_p, j = i % per_p;
        return p * e1 * e2 + (j < rows ? (j / r2) * e2 + b2 + j % r2 : b1 * e2 + (j - rows));
    }
};

struct EncodeShared {
    uint32_t x[kPadded];
    uint32_t heads[kChunks];
    uint32_t offsets[kChunks];  // per-chunk counts, then their exclusive scan
};

// The 1D encoders' load and transform (encode_fp32.cu; the placement stage
// of stage_placement.cu): load the 16-byte aligned 4096-word block `block`
// into x with 16-byte loads, rotating each word left by one, then first
// differences along the block (word 0 stays) and complement-negative. Ends
// with a barrier.
__device__ __forceinline__ void load_transform_1d(const uint32_t* __restrict__ block, uint32_t* x) {
    const int t = threadIdx.x;
    const uint4* src = reinterpret_cast<const uint4*>(block);
#pragma unroll
    for (int k = 0; k < kHcSize / 4 / kThreads; ++k) {
        const int q = t + k * kThreads;
        const uint4 v = src[q];
        x[pad(4 * q)] = rotl1(v.x);
        x[pad(4 * q + 1)] = rotl1(v.y);
        x[pad(4 * q + 2)] = rotl1(v.z);
        x[pad(4 * q + 3)] = rotl1(v.w);
    }
    __syncthreads();

    uint32_t seg[kWordsPerThread];
    uint32_t prev = t ? x[pad(kWordsPerThread * t - 1)] : 0u;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) seg[k] = x[pad(kWordsPerThread * t + k)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        x[pad(kWordsPerThread * t + k)] = complement_negative(seg[k] - prev);
        prev = seg[k];
    }
    __syncthreads();
}

struct DecodeShared {
    uint32_t x[kPadded];
    uint32_t heads[kChunks];
    uint32_t offsets[kChunks];  // per-chunk counts, then their exclusive scan
    uint32_t partial[kThreads]; // the scans' per-thread or per-warp sums
};

// The encoders' work after the transform (s.x holds the transformed block,
// and a barrier has passed). Without kPlace: write the block's length to
// lengths[b], 128 heads plus its nonzero transposed words. A chunk's head is
// the OR of its words before the transpose (golden.encode_blocks_dense), so
// the count of nonzero transposed words is that OR's popcount, and the
// lengths pass needs no transpose. With kPlace, once the header is written:
// transpose each chunk, head bit (31-i) set iff transposed word i != 0,
// scan the counts, and write the heads and nonzero words at
// num_hc + (b ? header[b-1] : 0).
template <bool kPlace>
__device__ __forceinline__ void encode_chunks(EncodeShared& s, uint64_t b, uint64_t num_hc,
                                              uint32_t* __restrict__ lengths,
                                              uint32_t* __restrict__ stream) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (!kPlace) {
        uint32_t n = 0;
#pragma unroll 4
        for (int k = 0; k < kChunksPerWarp; ++k)
            n += __popc(__reduce_or_sync(kFull, s.x[pad(32 * (warp * kChunksPerWarp + k) + lane)]));
        if (lane == 0) s.offsets[warp] = n;
        __syncthreads();
        if (t == 0) {
            uint32_t length = kChunks;
            for (int w = 0; w < kWarps; ++w) length += s.offsets[w];
            lengths[b] = length;
        }
        return;
    }

#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const int c = warp * kChunksPerWarp + k;
        const uint32_t v = warp_transpose_bits(s.x[pad(32 * c + lane)], lane);
        s.x[pad(32 * c + lane)] = v;
        const uint32_t nz = __ballot_sync(kFull, v != 0);
        if (lane == 0) {
            s.heads[c] = __brev(nz);
            s.offsets[c] = __popc(nz);
        }
    }
    __syncthreads();
    if (warp == 0) chunk_exclusive_scan(s.offsets, lane);
    __syncthreads();

    uint32_t* dst = stream + num_hc + (b ? stream[b - 1] : 0u);
    if (t < kChunks) dst[t] = s.heads[t];
#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const int c = warp * kChunksPerWarp + k;
        const uint32_t v = s.x[pad(32 * c + lane)];
        const uint32_t nz = __ballot_sync(kFull, v != 0);
        if (v) dst[kChunks + s.offsets[c] + __popc(nz & lanemask_lt(lane))] = v;
    }
}

// The decoders' work before the inverse transform: read block b's heads from
// its start num_hc + (b ? header[b-1] : 0), expand each chunk's nonzero words
// (rank of a word = popcount of the present bits below it, chunk start =
// exclusive scan of the heads' popcounts) and transpose it back into s.x.
// Reads only the words the block owns, each clamped to the stream's size.
// Ends with a barrier.
__device__ __forceinline__ void expand_chunks(DecodeShared& s, const uint32_t* __restrict__ stream,
                                              uint64_t size, uint64_t num_hc, uint64_t b) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const uint64_t start = num_hc + (b ? load_clamped(stream, size, b - 1) : 0u);
    if (t < kChunks) {
        const uint32_t h = load_clamped(stream, size, start + t);
        s.heads[t] = h;
        s.offsets[t] = __popc(h);
    }
    __syncthreads();
    if (warp == 0) chunk_exclusive_scan(s.offsets, lane);
    __syncthreads();

    const uint64_t body = start + kChunks;
#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const int c = warp * kChunksPerWarp + k;
        const uint32_t present = __brev(s.heads[c]);  // bit i <=> word i is in the stream
        const uint32_t v = (present >> lane) & 1u
            ? load_clamped(stream, size, body + s.offsets[c] + __popc(present & lanemask_lt(lane)))
            : 0u;
        s.x[pad(32 * c + lane)] = warp_transpose_bits(v, lane);
    }
    __syncthreads();
}

// Border elements [c * 4096, (c + 1) * 4096), the share of border CTA c.
__device__ __forceinline__ uint64_t border_end(const Border& border, uint64_t c) {
    return (c + 1) * kHcSize < border.count ? (c + 1) * kHcSize : border.count;
}

// A border CTA of the encoders' placement pass: its share of the border of
// `words` to the stream, after the last body word (num_hc + header[num_hc-1]).
__device__ __forceinline__ void encode_border(const uint32_t* __restrict__ words, const Border& border,
                                              uint64_t num_hc, uint64_t c, uint32_t* __restrict__ stream) {
    uint32_t* dst = stream + num_hc + stream[num_hc - 1];
    for (uint64_t i = c * kHcSize + threadIdx.x; i < border_end(border, c); i += kThreads)
        dst[i] = words[border.offset(i)];
}

// A border CTA of the decoders: its share of the border from the stream
// (after the last body word) to its places in the grid.
__device__ __forceinline__ void decode_border(const uint32_t* __restrict__ stream, uint64_t size,
                                              uint64_t num_hc, const Border& border, uint64_t c,
                                              uint32_t* __restrict__ out) {
    const uint64_t from = num_hc + load_clamped(stream, size, num_hc - 1);
    for (uint64_t i = c * kHcSize + threadIdx.x; i < border_end(border, c); i += kThreads)
        out[border.offset(i)] = load_clamped(stream, size, from + i);
}

// CTAs that copy a border of `count` elements, 4096 each.
inline uint64_t border_ctas(uint64_t count) { return (count + kHcSize - 1) / kHcSize; }

// Inclusive scan of the n block lengths into header[0 .. n), one CTA of
// 1024 threads, each over a contiguous run of ceil(n / 1024) entries. The
// body's total is then known: the CTA writes the stream length in words
// (n + body + border), so the host never waits.
static __global__ void __launch_bounds__(1024)
scan_lengths(const uint32_t* __restrict__ lengths, uint64_t n, uint64_t border,
             uint32_t* __restrict__ header, int32_t* __restrict__ length) {
    __shared__ uint32_t warp_offset[32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const uint64_t per = (n + 1023) / 1024;
    const uint64_t begin = t * per < n ? t * per : n;
    const uint64_t end = begin + per < n ? begin + per : n;
    uint32_t sum = 0;
    for (uint64_t i = begin; i < end; ++i) sum += lengths[i];
    const uint32_t incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) warp_offset[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const uint32_t w = warp_offset[lane];
        const uint32_t all = warp_inclusive_scan(w, lane);
        warp_offset[lane] = all - w;
        if (lane == 31) *length = static_cast<int32_t>(n + all + border);
    }
    __syncthreads();
    uint32_t run = warp_offset[warp] + incl - sum;
    for (uint64_t i = begin; i < end; ++i) {
        run += lengths[i];
        header[i] = run;
    }
}

}  // namespace ndzip
