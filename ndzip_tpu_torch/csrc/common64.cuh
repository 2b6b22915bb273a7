// Pieces shared by the fp64 encode and decode kernels of the ndzip format
// (1D in encode_fp64.cu/decode_fp64.cu, 2D/3D in encode_fp64_nd.cu/
// decode_fp64_nd.cu), on native 64-bit words: the word transforms, the
// warp-wide 64x64 bit transpose (TransposeLane64, four of common.cuh's 32-bit
// ones), the scans, the border copies, the decoders' bulk copy of a block's
// run and its expansion, and the encoders' one-pass run with its look-back.
// The block size, the thread layout, the border map (Border), the 32-bit warp
// scan and the mbarrier and bulk-copy primitives come from common.cuh, which
// the fp32 kernels share and which this file leaves as it is.
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

__device__ __forceinline__ u64 warp_inclusive_scan64(u64 v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const u64 t = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += t;
    }
    return v;
}

// The body's first u64 word in a stream of num_hc blocks.
__device__ __forceinline__ uint64_t header_words64(uint64_t num_hc) { return (num_hc + 1) / 2; }

// 64x64 bit-matrix transpose across a warp, on common.cuh's 13-instruction
// TransposeLane, in the format's MSB-first convention: out[i] bit (63-j) ==
// in[j] bit (63-i) (ndzip_tpu/ops/bitops.py:transpose_bits on _MASKS64). The
// 64x64 transpose is a swap and four 32x32 transposes: with rows r < 32 in a
// and r + 32 in b, the quadrant of rows 32.. and bits 63..32 (b's high
// halves) goes to rows ..31 and bits 31..0 (a's low halves) and back, each
// quadrant transposed in place. So the butterfly's round at distance 32 is a
// swap of a's low half with b's high half, which costs no instruction, and
// the rounds at 16 .. 1 are TransposeLane on each of the four 32-bit halves:
// each 64-bit mask of those rounds is the 32-bit mask twice, and the bits a
// shift moves across bit 32 land where the mask drops them. 52 instructions
// for 64 words, where the butterfly on 64-bit words runs two 64-bit shuffles
// and 64-bit masks in each of its five rounds. The transpose is its own
// inverse: the encoders and the decoders run the same one.
struct TransposeLane64 {
    TransposeLane half;

    __device__ __forceinline__ explicit TransposeLane64(int lane) : half(lane) {}

    // Lane r holds rows r (a) and r + 32 (b) of a chunk; on return lane i
    // holds transposed words i (a) and i + 32 (b).
    __device__ __forceinline__ void operator()(u64& a, u64& b) const {
        const uint32_t a_hi = half(static_cast<uint32_t>(a >> 32)), a_lo = half(static_cast<uint32_t>(b >> 32));
        const uint32_t b_hi = half(static_cast<uint32_t>(a)), b_lo = half(static_cast<uint32_t>(b));
        a = (static_cast<u64>(a_hi) << 32) | a_lo;
        b = (static_cast<u64>(b_hi) << 32) | b_lo;
    }
};

// A warp's 8 chunks lie in 544 consecutive slots of the padded block: chunk
// k's words `lane` and `lane + 32` at chunk_slots64(x, warp, lane)[68 * k]
// and [68 * k + 34] (the 16 words of a half-warp lie side by side).
constexpr int kChunkStride64 = 68, kUpperHalf64 = 34;
__device__ __forceinline__ u64* chunk_slots64(u64* x, int warp, int lane) {
    return x + pad64(64 * kChunksPerWarp64 * warp + lane);
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

// ------------------------------------------------------------------------
// One-pass encode on u64 words (encode_fp64.cu, encode_fp64_nd.cu): common.cuh's
// tickets, status words and look-back as B1 and B3 use them, with the run
// counted, compacted and stored in u64 words.

struct EncodeRunShared64 {
    u64 x[kPadded64];             // the block, then each warp's run in its own 512 words
    u64 heads[kChunks64];
    uint32_t warp_count[kWarps];  // nonzero words of each warp's 8 chunks
    uint32_t block;               // the CTA's ticket
    uint32_t length;              // u64 words of the run
    uint32_t exclusive;           // body u64 words of all blocks before this one
};

// The 1D encoder's load and transform: load the 16-byte aligned 4096-word
// block `block` into x with 16-byte loads, each word rotated left by one,
// less its rotated left neighbour (word 0 stays), complement-negative: the
// differences taken in registers on the way in, as grid_nd64.cuh's
// load_block64 takes those along the rows. The neighbour comes from the lane
// before; lane 0 reads it again, from the L1. Ends with a barrier.
__device__ __forceinline__ void load_transform64_1d(const u64* __restrict__ block, u64* x) {
    const int t = threadIdx.x, lane = t & 31;
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(block);
#pragma unroll
    for (int k = 0; k < kHcSize / 2 / kThreads; ++k) {
        const int q = t + k * kThreads;
        const ulonglong2 v = src[q];
        const u64 a = rotl1(v.x), c = rotl1(v.y);
        u64 left = __shfl_up_sync(kFull, c, 1);
        if (lane == 0) left = q ? rotl1(block[2 * q - 1]) : 0ull;
        x[pad64(2 * q)] = complement_negative(a - left);
        x[pad64(2 * q + 1)] = complement_negative(c - a);
    }
    __syncthreads();
}

// common.cuh's encode_run on u64 words (s.x holds block b's transformed
// words and a barrier has passed): a chunk's head is the OR of its 64 words
// before the transpose, reduced as two 32-bit halves, and its count that
// OR's popcount, so the length is known, and published as the block's
// aggregate, before any transpose. Then each warp transposes its 8 chunks
// (TransposeLane64) and compacts their nonzero words in place, in its own
// 512 words of s.x: a chunk's words land at or before its own slots, which
// the warp has read by then, and never on a later chunk's. After that warp 0
// looks back for the offset, publishes the inclusive sum and writes
// header[b] (u32, in u64 words); the CTA stores the heads at u64 word hw +
// s.exclusive, and each warp its words after the words of the warps before
// it, on two 128-byte lines at a time. One block buffer and no second one
// for the run: 35 KB a CTA, where a run buffer beside the block (68 KB,
// three CTAs an SM) was 2-20% slower (PERF.md). On return s.length and
// s.exclusive are set for all threads.
__device__ __forceinline__ void encode_run64(EncodeRunShared64& s, uint64_t b, uint64_t num_hc,
                                             uint64_t* status, uint32_t* __restrict__ stream) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const u64* mine = chunk_slots64(s.x, warp, lane);
    uint32_t count = 0;
#pragma unroll
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        const u64 v = mine[kChunkStride64 * k] | mine[kChunkStride64 * k + kUpperHalf64];
        const uint32_t lo = __reduce_or_sync(kFull, static_cast<uint32_t>(v));
        const uint32_t hi = __reduce_or_sync(kFull, static_cast<uint32_t>(v >> 32));
        count += __popc(lo) + __popc(hi);
        if (lane == 0) s.heads[kChunksPerWarp64 * warp + k] = (static_cast<u64>(hi) << 32) | lo;
    }
    if (lane == 0) s.warp_count[warp] = count;
    __syncthreads();
    uint32_t at = kChunks64, length = kChunks64;  // where this warp's words go in the run; the run's length
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const uint32_t n = s.warp_count[w];
        if (w < warp) at += n;
        length += n;
    }
    if (t == 0) store_status(status + b, (b ? kStatusAggregate : kStatusInclusive) | length);

    const TransposeLane64 transpose(lane);
    const uint32_t below = lanemask_lt(lane);
    u64* span = s.x + pad64(64 * kChunksPerWarp64 * warp);  // the warp's 512 words; its run's word i at pad64(i)
    uint32_t put = 0;
#pragma unroll 4
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        u64 a = mine[kChunkStride64 * k], c = mine[kChunkStride64 * k + kUpperHalf64];
        transpose(a, c);
        const uint32_t nza = __ballot_sync(kFull, a != 0), nzc = __ballot_sync(kFull, c != 0);
        if (a) span[pad64(put + __popc(nza & below))] = a;
        if (c) span[pad64(put + __popc(nza) + __popc(nzc & below))] = c;
        put += __popc(nza) + __popc(nzc);
    }
    if (warp == 0) {
        const uint32_t exclusive = b ? look_back(status, b, lane) : 0u;
        if (lane == 0) {
            const uint32_t inclusive = exclusive + length;
            if (b) store_status(status + b, kStatusInclusive | inclusive);
            stream[b] = inclusive;
            s.exclusive = exclusive;
            s.length = length;
        }
    }
    __syncthreads();

    u64* dst = reinterpret_cast<u64*>(stream) + header_words64(num_hc) + s.exclusive;
    if (t < kChunks64) dst[t] = s.heads[t];
    dst += at;
    const int skew = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 3) & 15);  // words past a line's start
    for (int i = lane - skew; i < static_cast<int>(put); i += 32)
        if (i >= 0) dst[i] = span[pad64(i)];
}

// A border CTA of the 2D/3D encoder: its share of the border of `words` to
// `dst`, the stream from the u64 word after the last body word on.
__device__ __forceinline__ void encode_border64(const u64* __restrict__ words, const Border& border, uint64_t c,
                                                u64* __restrict__ dst) {
    for (uint64_t i = c * kHcSize + threadIdx.x; i < border_end(border, c); i += kThreads)
        dst[i] = words[border.offset(i)];
}

// ------------------------------------------------------------------------
// Decode from a run in shared memory (decode_fp64.cu, decode_fp64_nd.cu), as
// common.cuh's start_run_copy and expand_run do for fp32: block b's stream
// words are one contiguous run of u64 words, [start, start + length) with
// start = hw + header[b-1] and length = header[b] - header[b-1], so one bulk
// copy (completing on an mbarrier) brings them in, and the heads, the scan of
// their counts and the rank gather read shared memory.

constexpr int kRunMax64 = kChunks64 + kHcSize;  // most u64 words a block's run can hold: 4160
constexpr int kRunSlots64 = kRunMax64 + 2;      // a run and its skew of 0-1 words, 16-byte multiples

// Where the copy put the run: word i of the run at words[skew + i] for i <
// avail; past avail (what lies past the stream's size) it reads as 0.
struct RunView64 {
    uint32_t skew, avail;
};

// For one thread: start the copy of block b's run into `words` (16-byte
// aligned, kRunSlots64 words), to complete on `bar` (one arrival). h0 and h1
// are header[b-1] (0 for b = 0) and header[b], u32 entries counting u64
// words; `size` counts the stream's u32 words and is even. A damaged header
// cannot fault: the length is clamped to 64 .. 4160 (a header that decreases
// gives a huge unsigned difference) and the run to the stream's size. The
// bulk copy takes the 16-byte aligned window around the run: the stream is
// 8-byte aligned, so the run's skew in it is 0 or 1 word. A window never
// leaves [0, size): where rounding would, at the stream's last word, the copy
// stops at the aligned boundary inside and the word beyond comes by a plain
// load.
__device__ __forceinline__ void start_run_copy64(const uint32_t* __restrict__ stream, uint64_t size,
                                                 uint64_t num_hc, uint32_t h0, uint32_t h1, u64* words,
                                                 RunView64& view, uint64_t* bar) {
    const u64* src = reinterpret_cast<const u64*>(stream);
    uint32_t length = h1 - h0;
    length = length < kChunks64 ? kChunks64 : length > kRunMax64 ? kRunMax64 : length;
    const int64_t n = static_cast<int64_t>(size / 2), start = static_cast<int64_t>(header_words64(num_hc)) + h0;
    const int64_t avail = start < n ? (n - start < length ? n - start : length) : 0;
    const int64_t base = (reinterpret_cast<uintptr_t>(stream) >> 3) & 1;  // the stream's own skew in memory
    const int64_t skew = (start + base) & 1, end = start + avail;
    view.skew = static_cast<uint32_t>(skew);
    view.avail = static_cast<uint32_t>(avail);
    // the aligned window [lo, hi) in stream indices, cut to whole 16 bytes inside [0, size); lo >= 0,
    // since a run starts past the header, at start >= hw >= 1
    int64_t lo = start - skew, hi = end + ((end + base) & 1);
    if (hi > n) hi -= 2;
    u64* run = words + skew - start;  // run[w]: the slot of stream word w
    uint32_t bytes = 0;
    if (hi > lo) {
        bytes = static_cast<uint32_t>(hi - lo) * 8;
        for (int64_t w = start; w < lo; ++w) run[w] = src[w];
        for (int64_t w = hi; w < end; ++w) run[w] = src[w];
    } else {
        for (int64_t w = start; w < end; ++w) run[w] = src[w];  // a run inside one window: one word
    }
    mbarrier_arrive_expect(bar, bytes);
    if (bytes) bulk_copy_to_shared(run + lo, src + lo, bytes, bar);
}

// The decoders' work before the inverse transform, from the run that the
// copy (completed) left in x: expand each chunk's nonzero words (rank of a
// word = popcount of the present bits below it) and transpose it back into x,
// now the padded block. The heads are read where they lie, at the run's start.
// A warp finds the start of its 8 chunks itself, from a scan of all 64
// heads' popcounts, two a lane: no shared scan, no barrier before the
// expansion. Words past view.avail read as 0. The heads are read whether or
// not they lie below avail (the 64 slots lie inside the buffer): a run cut at
// or before its 64th word has all its other words past avail, and one cut
// after it has all its heads. The run and the block share x: each warp
// gathers its 8 chunks, 16 words a lane, into registers, and writes x only
// after a barrier, when every warp has read the run. Ends with a barrier.
static_assert(kRunSlots64 <= kPadded64, "the run fits the block's buffer");
__device__ __forceinline__ void expand_run64(u64* x, const RunView64 view) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const u64* run = x + view.skew;
    const uint32_t avail = view.avail;
    const uint32_t two = __popcll(run[2 * lane]) + __popcll(run[2 * lane + 1]);  // chunks 2 lane, 2 lane + 1
    const uint32_t before = warp_inclusive_scan(two, lane) - two;
    uint32_t at = kChunks64 + __shfl_sync(kFull, before, kChunksPerWarp64 / 2 * warp);

    const u64 below_a = below(lane), below_c = below(lane + 32);
    u64 a[kChunksPerWarp64], c[kChunksPerWarp64];  // chunk k's words lane and lane + 32
#pragma unroll
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        const uint32_t chunk = kChunksPerWarp64 * warp + k;
        const u64 present = __brevll(run[chunk]);  // bit i <=> word i is in the stream
        const uint32_t i = at + __popcll(present & below_a), j = at + __popcll(present & below_c);
        a[k] = ((present >> lane) & 1ull) && i < avail ? run[i] : 0ull;
        c[k] = ((present >> (lane + 32)) & 1ull) && j < avail ? run[j] : 0ull;
        at += __popcll(present);
    }
    __syncthreads();  // every warp has read the run, which the block overwrites

    const TransposeLane64 transpose(lane);
    u64* mine = chunk_slots64(x, warp, lane);
#pragma unroll
    for (int k = 0; k < kChunksPerWarp64; ++k) {
        transpose(a[k], c[k]);
        mine[kChunkStride64 * k] = a[k];
        mine[kChunkStride64 * k + kUpperHalf64] = c[k];
    }
    __syncthreads();
}

}  // namespace ndzip
