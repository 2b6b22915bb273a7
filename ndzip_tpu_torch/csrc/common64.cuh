// Pieces shared by the fp64 encode and decode kernels of the ndzip format
// (1D in encode_fp64.cu/decode_fp64.cu, 2D/3D in encode_fp64_nd.cu/
// decode_fp64_nd.cu), on native 64-bit words: the word transforms, the
// warp-wide 64x64 bit transpose, the scans, the per-block encode tail and
// decode head, the header scan and the border copies. The block size, the
// thread layout, the border map (Border) and the 32-bit warp scan come from
// common.cuh, which the fp32 kernels share and which this file leaves as it
// is.
//
// One CTA of kThreads threads works on one 4096-word block staged in shared
// memory in the block's row-major order, so a chunk is 64 consecutive block
// words whatever the dimensionality. A warp holds a chunk two words a lane:
// word `lane` and word `lane + 32`.
//
// The fp64 stream (ndzip_tpu/format.py), in u32 words: num_hc header entries,
// each the offset after a block counted in u64 words from the first body
// word; one zero pad entry when num_hc is odd, so the body starts at u64 word
// hw = (num_hc + 1) / 2; block b's 64 heads and nonzero words from u64 word
// hw + (b ? header[b-1] : 0); after the last body word the border elements,
// one u64 word each.
#pragma once

#include "common.cuh"

namespace ndzip {

using u64 = unsigned long long;  // the type the 64-bit intrinsics take

constexpr int kChunks64 = kHcSize / 64;               // 64-word chunks = head words per block
constexpr int kChunksPerWarp64 = kChunks64 / kWarps;  // 8
constexpr int kPadded64 = kHcSize + kHcSize / 16;     // shared words with padding

// Shared-memory slot of block word i, one pad word after every 16. Shared
// memory has 32 banks of 4 bytes, and a warp's 8-byte accesses are served a
// half-warp (16 lanes, 128 bytes) at a time. With the pad both access
// patterns are free of bank conflicts: lanes on consecutive words (a
// half-warp on 16 words aligned to 16 gets 16 consecutive slots), and thread
// t on words 16t .. 16t + 15 in the scans (a half-warp's slots lie 17 apart,
// on 16 distinct bank pairs).
__device__ __forceinline__ int pad64(int i) { return i + (i >> 4); }

__device__ __forceinline__ u64 rotl1(u64 v) { return (v << 1) | (v >> 63); }
__device__ __forceinline__ u64 rotr1(u64 v) { return (v >> 1) | (v << 63); }

// If the sign bit is set, flip every other bit (an involution).
__device__ __forceinline__ u64 complement_negative(u64 v) {
    return (v >> 63) ? v ^ 0x7fffffffffffffffull : v;
}

// The bits of a 64-bit mask below bit i, 0 <= i < 64.
__device__ __forceinline__ u64 below(int i) { return (1ull << i) - 1ull; }

// u64 word i of a stream of `size` u64 words, or 0 past it.
__device__ __forceinline__ u64 load_clamped64(const u64* stream, uint64_t size, uint64_t i) {
    return i < size ? stream[i] : 0ull;
}

// 64x64 bit-matrix transpose across a warp. Lane r holds rows r (in a) and
// r + 32 (in b) of a chunk; on return lane i holds transposed words i (in a)
// and i + 32 (in b), in the format's MSB-first convention: out[i] bit (63-j)
// == in[j] bit (63-i). The butterfly of ndzip_tpu/ops/bitops.py:
// transpose_bits on _MASKS64: the round of shift 32 pairs rows r and r + 32,
// which sit in one lane; the rounds of shift 16 .. 1 pair lanes r and r ^ j
// as common.cuh's warp_transpose_bits does, on both words.
__device__ __forceinline__ void warp_transpose_bits64(u64& a, u64& b, int lane) {
    const u64 t = (a ^ (b >> 32)) & 0x00000000ffffffffull;
    a ^= t;
    b ^= t << 32;
    const u64 masks[5] = {0x0000ffff0000ffffull, 0x00ff00ff00ff00ffull, 0x0f0f0f0f0f0f0f0full,
                          0x3333333333333333ull, 0x5555555555555555ull};
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        const int j = 16 >> s;
        const u64 m = masks[s];
        const u64 pa = __shfl_xor_sync(kFull, a, j), pb = __shfl_xor_sync(kFull, b, j);
        if (lane & j) {
            a = (a & m) | ((pa << j) & ~m);
            b = (b & m) | ((pb << j) & ~m);
        } else {
            a = (a & ~m) | ((pa >> j) & m);
            b = (b & ~m) | ((pb >> j) & m);
        }
    }
}

__device__ __forceinline__ u64 warp_inclusive_scan64(u64 v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const u64 t = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += t;
    }
    return v;
}

// Exclusive scan, in place, of the kChunks64 per-chunk counts of a block.
// Called by all of warp 0.
__device__ __forceinline__ void chunk_exclusive_scan64(uint32_t* counts, int lane) {
    static_assert(kChunks64 == 2 * 32, "each lane scans two chunks");
    const uint32_t c0 = counts[2 * lane], c1 = counts[2 * lane + 1];
    const uint32_t excl = warp_inclusive_scan(c0 + c1, lane) - (c0 + c1);
    counts[2 * lane] = excl;
    counts[2 * lane + 1] = excl + c0;
}

struct EncodeShared64 {
    u64 x[kPadded64];
    u64 heads[kChunks64];
    uint32_t offsets[kChunks64];  // per-chunk counts, then their exclusive scan
};

struct DecodeShared64 {
    u64 x[kPadded64];
    u64 heads[kChunks64];
    uint32_t offsets[kChunks64];  // per-chunk counts, then their exclusive scan
    u64 partial[kThreads];        // the scans' per-thread or per-warp sums
};

// The body's first u64 word in a stream of num_hc blocks.
__device__ __forceinline__ uint64_t header_words64(uint64_t num_hc) { return (num_hc + 1) / 2; }

// The encoders' work after the transform (s.x holds the transformed block,
// and a barrier has passed). Without kPlace: write the block's length to
// lengths[b], 64 heads plus its nonzero transposed words; a chunk's head is
// the OR of its words before the transpose (golden.encode_blocks_dense), so
// the count is that OR's popcount, with no transpose. __reduce_or_sync takes
// 32 bits, so the two halves are reduced apart. With kPlace, once the header
// is written: transpose each chunk, head = the bit-reversed 64-bit ballot
// (bit 63-i set iff transposed word i != 0), scan the counts, and write the
// heads and nonzero words from u64 word hw + (b ? header[b-1] : 0).
template <bool kPlace>
__device__ __forceinline__ void encode_chunks64(EncodeShared64& s, uint64_t b, uint64_t num_hc,
                                                uint32_t* __restrict__ lengths,
                                                uint32_t* __restrict__ stream) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (!kPlace) {
        uint32_t n = 0;
#pragma unroll 4
        for (int k = 0; k < kChunksPerWarp64; ++k) {
            const int c = warp * kChunksPerWarp64 + k;
            const u64 v = s.x[pad64(64 * c + lane)] | s.x[pad64(64 * c + lane + 32)];
            n += __popc(__reduce_or_sync(kFull, static_cast<uint32_t>(v))) +
                 __popc(__reduce_or_sync(kFull, static_cast<uint32_t>(v >> 32)));
        }
        if (lane == 0) s.offsets[warp] = n;
        __syncthreads();
        if (t == 0) {
            uint32_t length = kChunks64;
            for (int w = 0; w < kWarps; ++w) length += s.offsets[w];
            lengths[b] = length;
        }
        return;
    }

#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        const int c = warp * kChunksPerWarp64 + k;
        u64 w0 = s.x[pad64(64 * c + lane)], w1 = s.x[pad64(64 * c + lane + 32)];
        warp_transpose_bits64(w0, w1, lane);
        s.x[pad64(64 * c + lane)] = w0;
        s.x[pad64(64 * c + lane + 32)] = w1;
        const u64 nz = (static_cast<u64>(__ballot_sync(kFull, w1 != 0)) << 32) | __ballot_sync(kFull, w0 != 0);
        if (lane == 0) {
            s.heads[c] = __brevll(nz);
            s.offsets[c] = __popcll(nz);
        }
    }
    __syncthreads();
    if (warp == 0) chunk_exclusive_scan64(s.offsets, lane);
    __syncthreads();

    u64* dst = reinterpret_cast<u64*>(stream) + header_words64(num_hc) + (b ? stream[b - 1] : 0u);
    if (t < kChunks64) dst[t] = s.heads[t];
#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        const int c = warp * kChunksPerWarp64 + k;
        const u64 present = __brevll(s.heads[c]);  // bit i <=> transposed word i != 0
        const u64 w0 = s.x[pad64(64 * c + lane)], w1 = s.x[pad64(64 * c + lane + 32)];
        u64* out = dst + kChunks64 + s.offsets[c];
        if (w0) out[__popcll(present & below(lane))] = w0;
        if (w1) out[__popcll(present & below(lane + 32))] = w1;
    }
}

// The decoders' work before the inverse transform: read block b's 64 heads
// from its start hw + (b ? header[b-1] : 0), expand each chunk's nonzero
// words (rank of a word = popcount of the present bits below it, chunk
// start = exclusive scan of the heads' popcounts) and transpose it back into
// s.x. `size` counts the stream's u32 words and is even. Reads only the
// words the block owns, each clamped to the stream's size. Ends with a
// barrier.
__device__ __forceinline__ void expand_chunks64(DecodeShared64& s, const uint32_t* __restrict__ stream,
                                                uint64_t size, uint64_t num_hc, uint64_t b) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const u64* words = reinterpret_cast<const u64*>(stream);
    const uint64_t size64 = size / 2;
    const uint64_t start = header_words64(num_hc) + (b ? load_clamped(stream, size, b - 1) : 0u);
    if (t < kChunks64) {
        const u64 h = load_clamped64(words, size64, start + t);
        s.heads[t] = h;
        s.offsets[t] = __popcll(h);
    }
    __syncthreads();
    if (warp == 0) chunk_exclusive_scan64(s.offsets, lane);
    __syncthreads();

    const uint64_t body = start + kChunks64;
#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        const int c = warp * kChunksPerWarp64 + k;
        const u64 present = __brevll(s.heads[c]);  // bit i <=> word i is in the stream
        const uint64_t from = body + s.offsets[c];
        u64 w0 = (present >> lane) & 1ull
            ? load_clamped64(words, size64, from + __popcll(present & below(lane))) : 0ull;
        u64 w1 = (present >> (lane + 32)) & 1ull
            ? load_clamped64(words, size64, from + __popcll(present & below(lane + 32))) : 0ull;
        warp_transpose_bits64(w0, w1, lane);
        s.x[pad64(64 * c + lane)] = w0;
        s.x[pad64(64 * c + lane + 32)] = w1;
    }
    __syncthreads();
}

// A border CTA of the encoders' placement pass: its share of the border of
// `words` to the stream, after the last body word (hw + header[num_hc-1]).
__device__ __forceinline__ void encode_border64(const u64* __restrict__ words, const Border& border,
                                                uint64_t num_hc, uint64_t c, uint32_t* __restrict__ stream) {
    u64* dst = reinterpret_cast<u64*>(stream) + header_words64(num_hc) + stream[num_hc - 1];
    for (uint64_t i = c * kHcSize + threadIdx.x; i < border_end(border, c); i += kThreads)
        dst[i] = words[border.offset(i)];
}

// A border CTA of the decoders: its share of the border from the stream
// (`size` u32 words, after the last body word) to its places in the grid.
__device__ __forceinline__ void decode_border64(const uint32_t* __restrict__ stream, uint64_t size,
                                                uint64_t num_hc, const Border& border, uint64_t c,
                                                u64* __restrict__ out) {
    const u64* words = reinterpret_cast<const u64*>(stream);
    const uint64_t from = header_words64(num_hc) + load_clamped(stream, size, num_hc - 1);
    for (uint64_t i = c * kHcSize + threadIdx.x; i < border_end(border, c); i += kThreads)
        out[border.offset(i)] = load_clamped64(words, size / 2, from + i);
}

// common.cuh's scan_lengths for fp64: the header entries count u64 words, the
// pad entry after them is zeroed when n is odd (the stream buffer is not
// cleared), and the stream length is written in u32 words,
// 2 * (hw + body + border), so the host never waits.
static __global__ void __launch_bounds__(1024)
scan_lengths64(const uint32_t* __restrict__ lengths, uint64_t n, uint64_t border,
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
        if (lane == 31) *length = static_cast<int32_t>(2 * (header_words64(n) + all + border));
    }
    if (t == 0 && (n & 1)) header[n] = 0u;
    __syncthreads();
    uint32_t run = warp_offset[warp] + incl - sum;
    for (uint64_t i = begin; i < end; ++i) {
        run += lengths[i];
        header[i] = run;
    }
}

}  // namespace ndzip
