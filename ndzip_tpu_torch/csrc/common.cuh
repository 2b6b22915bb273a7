// Pieces shared by the fp32 encode and decode kernels of the ndzip format
// (1D in encode_fp32.cu/decode_fp32.cu, 2D/3D in encode_fp32_nd.cu/
// decode_fp32_nd.cu): block geometry, the word transforms, the warp-wide
// 32x32 bit transpose, the border map, the one-pass encode of a block with
// its look-back, and the decode of a block from its run in shared memory.
// One CTA of kThreads threads works on one 4096-word block at a time, staged
// in shared memory in the block's row-major order, so a chunk is 32
// consecutive block words whatever the dimensionality. Border elements are
// copied by border CTAs, 4096 each, on both sides (the 1D encoder's last
// block copies its short tail itself).
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

// The shared-state-space address of p, a pointer into shared memory.
__device__ __forceinline__ uint32_t shared_address(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The block and its heads as the placement stage keeps them (stage_placement.cu).
struct EncodeShared {
    uint32_t x[kPadded];
    uint32_t heads[kChunks];
    uint32_t offsets[kChunks];
};

// The placement stage's load and transform (stage_placement.cu; B1 in
// encode_fp32.cu loads its block by a bulk copy instead and transforms it in
// one pass): load the 16-byte aligned 4096-word block `block`
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

// Border elements [c * 4096, (c + 1) * 4096), the share of border CTA c.
__device__ __forceinline__ uint64_t border_end(const Border& border, uint64_t c) {
    return (c + 1) * kHcSize < border.count ? (c + 1) * kHcSize : border.count;
}

// A border CTA of the 2D/3D encoder, before it waits for where the border
// starts in the stream: its share of the border of `words` into x in stream
// order (x[j] = element c * 4096 + j), each word by a 4-byte cp.async, which
// holds no register, a thread's 16 issued back to back. A thread splits its
// first element over (plane, row, column) once, in 32-bit arithmetic (the
// border of a grid the codec takes has fewer than 2**31 elements), and steps
// by kThreads from there: a division again only where a step leaves its
// plane. Border::offset in this loop, two 64-bit divisions an element, was
// measured: it took the encoder to 46-47 registers (five CTAs an SM, not
// six) and the tail after the last block's sum at 1800x3600 from 1.8 to
// 2.7 us (PERF.md). Returns when the thread's copies have landed.
__device__ __forceinline__ void stage_border(const uint32_t* __restrict__ words, const Border& border,
                                             uint64_t c, uint32_t* x) {
    const uint32_t e2 = static_cast<uint32_t>(border.e2), b2 = static_cast<uint32_t>(border.b2);
    const uint32_t r2 = e2 - b2;                                       // words of a row past the blocks
    const uint32_t rows = static_cast<uint32_t>(border.b1) * r2;       // of a plane, those rows first
    const uint32_t below = static_cast<uint32_t>(border.b1) * e2;      // then from row b1 on, all of it
    const uint32_t per_p = rows + static_cast<uint32_t>(border.e1 - border.b1) * e2;
    const uint32_t planes = static_cast<uint32_t>(border.b0) * per_p;  // then words[b0:]
    const uint64_t plane = border.e1 * border.e2, tail = border.b0 * plane;
    const uint32_t first = static_cast<uint32_t>(c) * kHcSize, end = static_cast<uint32_t>(border_end(border, c));
    const uint32_t q = r2 ? kThreads / r2 : 0, m = r2 ? kThreads % r2 : 0;  // a step, in rows and words
    uint32_t p = 0, j = 0, r = 0, col = 0;  // element i is word j of plane p, in the rows: row r, column col
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const uint32_t at = threadIdx.x + k * kThreads, i = first + at;
        if (i >= end) break;
        uint64_t offset;
        if (i >= planes) {
            offset = tail + (i - planes);
        } else {
            if (k) {
                j += kThreads;
                r += q;
                col += m;
                if (col >= r2) col -= r2, ++r;
            }
            if (k == 0 || j >= per_p) {
                p = i / per_p;
                j = i - p * per_p;
                r = r2 ? j / r2 : 0;
                col = j - r * r2;
            }
            offset = p * plane + (j < rows ? static_cast<uint64_t>(r) * e2 + b2 + col : below + (j - rows));
        }
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(shared_address(x + at)), "l"(words + offset)
                     : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// `length` words from shared memory to dst in global memory, a warp on one
// whole 128-byte line at a time: lane l of the first warp on the word that
// falls l words past a line's start.
__device__ __forceinline__ void store_lines(uint32_t* __restrict__ dst, const uint32_t* src, int length) {
    const int skew = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 31);  // words past a line's start
    for (int i = static_cast<int>(threadIdx.x) - skew; i < length; i += kThreads)
        if (i >= 0) dst[i] = src[i];
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

// ------------------------------------------------------------------------
// Pieces of the one-pass encoders and the run decoders (encode_fp32.cu,
// decode_fp32.cu and their 2D/3D counterparts). These kernels run about as
// many instructions as the SMs can take in the time their bytes need, so
// these count instructions.

// warp_transpose_bits in 13 instructions a chunk instead of about 30: what a
// lane does in each round depends only on its lane number, so it is set up
// once a thread. The rounds at distances 16 and 8 move whole bytes (one byte
// permute each); the rounds at 4, 2 and 1 rotate the partner's word, left in
// the upper lane of a pair and right in the lower, and merge under a mask
// (the bits a rotate wraps around fall where the mask drops them).
struct TransposeLane {
    uint32_t perm16, perm8;        // byte selectors of the rounds at 16 and 8
    uint32_t rot4, rot2, rot1;     // left rotates of the partner's word
    uint32_t keep4, keep2, keep1;  // the bits a lane keeps of its own word

    __device__ __forceinline__ explicit TransposeLane(int lane)
        : perm16(lane & 16 ? 0x5410u : 0x3276u), perm8(lane & 8 ? 0x6240u : 0x3715u),
          rot4(lane & 4 ? 4 : 28), rot2(lane & 2 ? 2 : 30), rot1(lane & 1 ? 1 : 31),
          keep4(lane & 4 ? 0x0f0f0f0fu : 0xf0f0f0f0u), keep2(lane & 2 ? 0x33333333u : 0xccccccccu),
          keep1(lane & 1 ? 0x55555555u : 0xaaaaaaaau) {}

    __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
        x = __byte_perm(x, __shfl_xor_sync(kFull, x, 16), perm16);
        x = __byte_perm(x, __shfl_xor_sync(kFull, x, 8), perm8);
        uint32_t p = __shfl_xor_sync(kFull, x, 4);
        x = (x & keep4) | (__funnelshift_l(p, p, rot4) & ~keep4);
        p = __shfl_xor_sync(kFull, x, 2);
        x = (x & keep2) | (__funnelshift_l(p, p, rot2) & ~keep2);
        p = __shfl_xor_sync(kFull, x, 1);
        return (x & keep1) | (__funnelshift_l(p, p, rot1) & ~keep1);
    }
};

// A warp's 16 chunks lie in 528 consecutive slots of the padded block, chunk
// k's word `lane` at chunk_slots(x, warp, lane)[33 * k].
constexpr int kChunkStride = 33;
__device__ __forceinline__ uint32_t* chunk_slots(uint32_t* x, int warp, int lane) {
    return x + pad(32 * kChunksPerWarp * warp) + lane;
}

// ------------------------------------------------------------------------
// One-pass encode (encode_fp32.cu, encode_fp32_nd.cu): a block's offset by
// decoupled look-back, its run compacted in shared memory and stored in whole
// lines.

// One 64-bit status word a block: a flag in the top two bits, a count of body
// words in the low 32 (header entries are u32). Flag and value travel in one
// word, so one load or store carries both and no fence is needed. 0: nothing
// published yet (the array is cleared before the launch).
constexpr uint64_t kStatusAggregate = 1ull << 62;  // value = this block's length
constexpr uint64_t kStatusInclusive = 2ull << 62;  // value = the lengths of blocks 0 .. b
constexpr int kRunMax = kChunks + kHcSize;         // most words a block's run can hold

// Loads and stores of status words at the device's scope: served by L2,
// never by a stale L1 line.
__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
    uint64_t v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

struct EncodeRunShared {
    uint32_t x[kPadded];
    uint32_t run[kRunMax];        // the block's stream words: 128 heads, then the nonzero words
    uint32_t warp_count[kWarps];  // nonzero words of each warp's 16 chunks
    uint32_t block;               // the CTA's ticket
    uint32_t length;              // words of the run
    uint32_t exclusive;           // body words of all blocks before this one
};

// The CTA's block: a ticket, not blockIdx.x, so that every block with a lower
// index belongs to a CTA that has started, and a block never waits for one
// that is not resident. Ends with a barrier.
__device__ __forceinline__ uint64_t take_ticket(uint32_t* counter, uint32_t* slot) {
    if (threadIdx.x == 0) *slot = atomicAdd(counter, 1u);
    __syncthreads();
    return *slot;
}

// The sum of the lengths of blocks 0 .. b-1, b >= 1, for one whole warp: it
// reads its predecessors' status words 32 at a time, nearest first, waits
// until each has published, and stops at the nearest inclusive one. No block
// waits for the sum of the block before it, only for its own length.
__device__ __forceinline__ uint32_t look_back(const uint64_t* status, uint64_t b, int lane) {
    uint32_t exclusive = 0;
    for (int64_t base = static_cast<int64_t>(b) - 1;; base -= 32) {
        const int64_t i = base - lane;
        uint64_t v;
        do {
            v = i >= 0 ? load_status(status + i) : kStatusInclusive;  // before block 0: an inclusive sum of 0
        } while (__any_sync(kFull, (v >> 62) == 0));
        const uint32_t inclusive = __ballot_sync(kFull, (v >> 62) == 2);
        const uint32_t value = static_cast<uint32_t>(v);
        if (inclusive) {
            const int nearest = __ffs(inclusive) - 1;
            return exclusive + __reduce_add_sync(kFull, lane <= nearest ? value : 0u);
        }
        exclusive += __reduce_add_sync(kFull, value);
    }
}

// For one thread: wait until the block of status word `p` has published its
// inclusive sum, and return it. Only for a CTA whose ticket came after that
// block's: the block's CTA has then started, so the wait ends.
__device__ __forceinline__ uint32_t wait_inclusive(const uint64_t* p) {
    uint64_t v;
    while (((v = load_status(p)) >> 62) != 2) __nanosleep(200);
    return static_cast<uint32_t>(v);
}

// The encoder's work after the transform, in one pass (s.x holds block b's
// transformed words and a barrier has passed). First the count: a chunk's
// head is the OR of its words before the transpose and its count that OR's
// popcount, so the length is known, and published as the block's aggregate,
// before any transpose. Then each warp transposes its 16 chunks and compacts
// their nonzero words into s.run from its own start, the sum of the counts
// of the warps before it. Last, when its predecessors have long published,
// warp 0 looks back for the offset, publishes the inclusive sum and writes
// header[b], and the whole CTA stores the run at num_hc + s.exclusive, a warp
// on one 128-byte line at a time. On return s.length and s.exclusive are set
// for all threads.
__device__ __forceinline__ void encode_run(EncodeRunShared& s, uint64_t b, uint64_t num_hc,
                                           uint64_t* status, uint32_t* __restrict__ stream) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const uint32_t* mine = chunk_slots(s.x, warp, lane);
    uint32_t count = 0;
#pragma unroll
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const uint32_t head = __reduce_or_sync(kFull, mine[kChunkStride * k]);
        count += __popc(head);
        if (lane == 0) s.run[kChunksPerWarp * warp + k] = head;
    }
    if (lane == 0) s.warp_count[warp] = count;
    __syncthreads();
    uint32_t at = kChunks, length = kChunks;  // where this warp's words go in the run; the run's length
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const uint32_t n = s.warp_count[w];
        if (w < warp) at += n;
        length += n;
    }
    if (t == 0) store_status(status + b, (b ? kStatusAggregate : kStatusInclusive) | length);

    const TransposeLane transpose(lane);
    const uint32_t below = lanemask_lt(lane);
#pragma unroll 8
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const uint32_t v = transpose(mine[kChunkStride * k]);
        const uint32_t nz = __ballot_sync(kFull, v != 0);
        const uint32_t slot = at + __popc(nz & below);
        if (v) s.run[slot] = v;
        at += __popc(nz);
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

    store_lines(stream + num_hc + s.exclusive, s.run, static_cast<int>(length));
}

// ------------------------------------------------------------------------
// Decode from a run in shared memory (decode_fp32.cu, decode_fp32_nd.cu): a block's stream words
// are one contiguous run, [start, start + length) with start = num_hc +
// header[b-1] and length = header[b] - header[b-1], so one bulk copy (TMA's
// 1D form, completing on an mbarrier) brings them in and the heads, the
// 128-count scan and the rank gather read shared memory. The barrier helpers
// serve the encoders' block loads too: the bulk copy and its L2 prefetch the
// 1D encoder's (encode_fp32.cu), the tensor copy the 3D encoder's
// (encode_fp32_nd.cu); the tensor store serves the 3D decoder's block store.

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, uint32_t arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(arrivals) : "memory");
}

// After the barriers are initialised and before any thread or copy uses them.
__device__ __forceinline__ void mbarrier_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrive and announce `bytes` of bulk copies that will complete on the barrier.
__device__ __forceinline__ void mbarrier_arrive_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_address(bar)), "r"(bytes)
                 : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}"
            : "=r"(done)
            : "r"(shared_address(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// `bytes` from global to shared memory, both 16-byte aligned, bytes a multiple
// of 16, completing on the barrier.
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     shared_address(dst)),
                 "l"(src), "r"(bytes), "r"(shared_address(bar))
                 : "memory");
}

// Ask the L2 for `bytes` from src (16-byte aligned, bytes a multiple of 16),
// without a copy or a barrier: the 1D encoder's hint for the block that the
// CTA kAhead tickets later will copy, so that its copy is served by the L2.
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}

// The box of a 3D tensor map whose first element is at (c.x, c.y, c.z),
// innermost first, to dst in shared memory (128-byte aligned), completing on
// the barrier. `map` is the map's generic address: a __grid_constant__
// kernel parameter.
__device__ __forceinline__ void tensor_copy_to_shared(void* dst, const void* map, uint3 c, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
            shared_address(dst)),
        "l"(map), "r"(c.x), "r"(c.y), "r"(c.z), "r"(shared_address(bar))
        : "memory");
}

// Ask the L2 for the same box, without a copy or a barrier.
__device__ __forceinline__ void tensor_prefetch_l2(const void* map, uint3 c) {
    asm volatile("cp.async.bulk.prefetch.tensor.3d.L2.global [%0, {%1, %2, %3}];" ::"l"(map), "r"(c.x), "r"(c.y),
                 "r"(c.z)
                 : "memory");
}

// The box of a 3D tensor map whose first element is at (c.x, c.y, c.z) from
// src in shared memory (128-byte aligned, dense in the box's order) to the
// map's tensor, in this thread's bulk group. The threads that wrote src issue
// fence_proxy_async first, then a barrier; this thread then commits the group
// and waits for src to be read (bulk_store_wait_read) before the CTA exits.
__device__ __forceinline__ void tensor_store_from_shared(const void* map, uint3 c, const void* src) {
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(map),
                 "r"(c.x), "r"(c.y), "r"(c.z), "r"(shared_address(src))
                 : "memory");
}

// Make this thread's writes to shared memory visible to the bulk copies
// (the async proxy) that a later barrier orders after them.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Commit this thread's bulk stores as one group and wait until their sources
// in shared memory have been read (not until the writes complete).
__device__ __forceinline__ void bulk_store_wait_read() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

constexpr int kRunSlots = kRunMax + 4;  // a run and its skew of 0-3 words, 16-byte multiples

// One run buffer: word i of the run is words[skew + i] for i < avail, and 0
// past avail (what lies past the stream's size reads as 0).
struct RunBuffer {
    alignas(16) uint32_t words[kRunSlots];
    uint32_t skew, avail;
};

// For one thread: start the copy of block b's run into `buf`, to complete on
// `bar` (one arrival). h0 and h1 are header[b-1] (0 for b = 0) and header[b].
// A damaged header cannot fault: the length is clamped to 128 .. 4224 (a
// header that decreases gives a huge unsigned difference) and the run to the
// stream's size. The bulk copy needs 16-byte aligned addresses: it takes the
// aligned window around the run, and the run's skew in it, 0-3 words, goes
// into the shared-memory index. The stream's base may itself lie at any word
// (a slice), so windows are aligned in memory, not in stream indices. A
// window never leaves [0, size): where rounding would, at the stream's first
// or last words, the bulk copy stops at the aligned boundary inside and the
// at most three words beyond come by plain loads.
__device__ __forceinline__ void start_run_copy(const uint32_t* __restrict__ stream, uint64_t size,
                                               uint64_t num_hc, uint32_t h0, uint32_t h1, RunBuffer& buf,
                                               uint64_t* bar) {
    uint32_t length = h1 - h0;
    length = length < kChunks ? kChunks : length > kRunMax ? kRunMax : length;
    const int64_t n = static_cast<int64_t>(size), start = static_cast<int64_t>(num_hc) + h0;
    const int64_t avail = start < n ? (n - start < length ? n - start : length) : 0;
    const int64_t base = (reinterpret_cast<uintptr_t>(stream) >> 2) & 3;  // the stream's own skew in memory
    const int64_t skew = (start + base) & 3, end = start + avail;
    buf.skew = static_cast<uint32_t>(skew);
    buf.avail = static_cast<uint32_t>(avail);
    // the aligned window [lo, hi) in stream indices, cut to whole 16 bytes inside [0, size)
    int64_t lo = start - skew, hi = end + ((4 - ((end + base) & 3)) & 3);
    if (lo < 0) lo += 4;
    if (hi > n) hi -= 4;
    uint32_t* run = buf.words + skew - start;  // run[w]: the slot of stream word w
    uint32_t bytes = 0;
    if (hi > lo) {
        bytes = static_cast<uint32_t>(hi - lo) * 4;
        for (int64_t w = start; w < lo; ++w) run[w] = stream[w];
        for (int64_t w = hi; w < end; ++w) run[w] = stream[w];
    } else {
        for (int64_t w = start; w < end; ++w) run[w] = stream[w];  // a run inside one window: under 8 words
    }
    mbarrier_arrive_expect(bar, bytes);
    if (bytes) bulk_copy_to_shared(run + lo, stream + lo, bytes, bar);
}

// The decoders' work before the inverse transform, from a run in shared
// memory (the copy has completed): expand each chunk's nonzero words (rank of
// a word = popcount of the present bits below it) and transpose it back into
// x. The heads are read where they lie, at the run's start. A warp finds the
// start of its 16 chunks itself, from a scan of all 128 heads' popcounts,
// four a lane, and then counts on: no shared scan, no barrier before the
// expansion. Words past buf.avail read as 0. Ends with a barrier.
__device__ __forceinline__ void expand_run(const RunBuffer& buf, uint32_t* x) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const uint32_t* run = buf.words + buf.skew;
    const uint32_t avail = buf.avail;
    uint32_t four = 0;  // the words of chunks 4 * lane .. 4 * lane + 3
#pragma unroll
    for (int k = 0; k < 4; ++k) four += 4 * lane + k < avail ? __popc(run[4 * lane + k]) : 0;
    const uint32_t before = warp_inclusive_scan(four, lane) - four;
    uint32_t at = kChunks + __shfl_sync(kFull, before, kChunksPerWarp / 4 * warp);

    const TransposeLane transpose(lane);
    const uint32_t below = lanemask_lt(lane);
    uint32_t* mine = chunk_slots(x, warp, lane);
#pragma unroll 8
    for (int k = 0; k < kChunksPerWarp; ++k) {
        const uint32_t c = kChunksPerWarp * warp + k;
        const uint32_t present = c < avail ? __brev(run[c]) : 0u;  // bit i <=> word i is in the stream
        const uint32_t i = at + __popc(present & below);
        const uint32_t v = ((present >> lane) & 1u) && i < avail ? run[i] : 0u;
        mine[kChunkStride * k] = transpose(v);
        at += __popc(present);
    }
    __syncthreads();
}

}  // namespace ndzip
