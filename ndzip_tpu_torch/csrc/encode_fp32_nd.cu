// fp32 2D/3D block encoder of the ndzip format, for Hopper (sm_90a).
//
// Replaces the TPU kernel ndzip_tpu/codec_pallas.py:_encode_kernel_fp32 in
// tile2d/tile3d mode, launched by _encode_interior_fp32, together with the
// header and border glue of _encode_fp32_device for 2D/3D shapes (and the
// XLA gather route of shapes whose minor block-grid axis does not divide).
//
// The TPU kernel DMAs multi-block tiles of the full array, rearranges them
// into blocks in VMEM with XOR cell swaps sized to Mosaic's lane tiling, and
// carries the running stream offset from one grid step to the next. CTAs run
// in no fixed order, so a block's offset is the sum of the lengths of all
// blocks before it, which no CTA knows when it starts. The encode is one
// kernel that reads its input once, the 1D encoder's design (encode_fp32.cu)
// with the block read from the grid:
//   * a CTA takes its block by a ticket, in the header's order (row-major
//     over the block grid; the thread that draws the ticket splits it over
//     the block grid once, in 32-bit arithmetic), and loads it straight from
//     the grid, row by row (64 rows of 64 words in 2D, 256 rows of 16 in 3D;
//     16-byte loads when every row starts aligned, else one word a lane),
//     into shared memory in the block's row-major order. From there a chunk
//     is 32 consecutive block words, as in 1D. Neighbouring tickets run at
//     the same time, and the load asks the L2 for whole 128-byte lines, so of
//     the two 3D blocks that share each line of the grid the second finds its
//     half in the L2 (9% of the kernel's time at 512x512x2048). Before it
//     loads, a CTA asks the L2 for the block that the CTA kAhead tickets
//     later will load: tickets run in order, so that block is wanted a few
//     microseconds later, and its CTA then waits on the L2 and not on the
//     memory (12% of the kernel's time in 3D and 7% in 2D at 2 GiB; twice the
//     distance gains the same, six times the distance loses it all);
//   * the transform is rotate-left-1, first differences along each axis (the
//     first word of a line stays), complement-negative. The differences along
//     different axes commute, so they need not run in the format's order:
//     those along the rows are taken in registers on the load (grid_nd.cuh's
//     load_block), and one pass over shared memory does the rest, in which a
//     thread walks 16 words of a column (2D) or of a line along z, less their
//     neighbours at y - 1 (3D). One pass where the format's order suggests two
//     or three: 3% of the kernel's time;
//   * a 3D grid whose rows start 16-byte aligned takes another load
//     (encode_blocks_nd_box; the same kernel otherwise, and the same stream).
//     A 3D row is 64 B, so the row walk above spends a 64-bit address, a
//     load and its latency on every 64 bytes. Instead the thread that draws
//     the ticket copies the whole 16^3 block as one box of the grid's tensor
//     map (built on the host for each call) into the run buffer, which lies
//     unused until the compaction, and asks the L2 for the box kAhead tickets
//     on with one tensor prefetch: the copy engine makes the 256 row
//     addresses, and no thread holds a register for the load. When the
//     box's barrier completes, one pass (difference_box) takes it into the
//     padded block with the whole transform, a thread on a line along z:
//     the differences along y from the word 16 before in the box, along x
//     from the lane before, along z in registers;
//   * common.cuh's encode_run does the rest as in 1D: the length by OR and
//     popcount, published at once in the block's status word; the transposes
//     and the compaction into a second shared buffer; the offset by decoupled
//     look-back; header[b]; the run stored in whole 128-byte lines. The last
//     block's CTA writes the stream length;
//   * the border has no bound (a grid of (20, 1024, 1024) has 1024 border
//     CTAs of 4096 words, more than the card holds at once), so it cannot
//     ride with the last block as the 1D tail does. Border CTAs are the CTAs
//     whose ticket is num_hc or more, 4096 border words each. A border CTA
//     first loads its share into shared memory, in stream order (common.cuh's
//     stage_border: 4-byte cp.async copies, all of a thread's in flight at
//     once, their grid offsets stepped from one 32-bit split a thread). Only
//     then does it wait for the last block's inclusive sum, which says where
//     the border starts, and store the share there in whole 128-byte lines.
//     So the border's loads run beside the last blocks, and after the last
//     sum only the stores remain. Because border CTAs are told from block
//     CTAs by ticket and not by blockIdx.x, every block's CTA has started
//     when the first border CTA waits, so the wait ends whatever order the
//     CTAs come in. The other sound way, a second small launch for the
//     border that reads header[num_hc - 1], was measured too: it costs 3 us
//     more on every bordered grid and nothing less on any.
// The status words and the ticket are cleared on the same CUDA stream before
// the launch, and belong to one call.
//
// Bound: bytes. Each element is read once, in rows of 256 B (2D) or 64 B
// (3D), and the stream is written once. Two block buffers take 34 KB of
// shared memory a CTA, six CTAs an SM (the box lands in one of them).
// Element and stream offsets are 64-bit.
// The measurements named here and the variants beside them: PERF.md (2 GiB
// grids, 512x512x2048 and 16384x32768, on an NVIDIA H100 80GB HBM3, 700.00 W).

#include <cstddef>

#include "grid_nd.cuh"

namespace ndzip {

// 2D: the first differences along the columns in shared memory (the first
// word of each column stays), a thread on 16 words of one column, then
// complement-negative. Ends with a barrier.
__device__ __forceinline__ void difference_columns(uint32_t* x) {
    const Segment g = segment<2, 0>(threadIdx.x);
    uint32_t v[kWordsPerThread];
    uint32_t prev = g.s ? x[pad(g.start - g.step)] : 0u;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) v[k] = x[pad(g.start + k * g.step)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        x[pad(g.start + k * g.step)] = complement_negative(v[k] - prev);
        prev = v[k];
    }
    __syncthreads();
}

// 3D: the first differences along y and along z in one pass, thread t on the
// z line at (y, x) = (t / 16, t % 16): each word less its neighbour at y - 1,
// then the differences of those along the line, then complement-negative.
// Ends with a barrier.
__device__ __forceinline__ void difference_yz(uint32_t* x) {
    const int t = threadIdx.x;
    uint32_t v[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const uint32_t own = x[pad(t + 256 * k)];
        v[k] = own - (t >= 16 ? x[pad(t - 16 + 256 * k)] : 0u);
    }
    __syncthreads();
    uint32_t prev = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        x[pad(t + 256 * k)] = complement_negative(v[k] - prev);
        prev = v[k];
    }
    __syncthreads();
}

// 3D, from the block as its box left it in shared memory (dense, row-major,
// no pad) to x in the padded layout, with the whole transform, thread t on the
// z line at (y, x) = (t / 16, t % 16): each word rotated left by one, less the
// rotated word 16 before it in the box, its neighbour at y - 1 (the first row
// stays); those differences less the left neighbour's, from the lane before
// (the first word of a row stays); those less the ones before them on the
// line (z), then complement-negative. Every access of a warp touches 32
// consecutive words, so no bank conflicts on either side. Ends with a barrier.
__device__ __forceinline__ void difference_box(const uint32_t* box, uint32_t* x) {
    const int t = threadIdx.x;
    uint32_t prev = 0;
#pragma unroll
    for (int z = 0; z < Blocks<3>::kSide; ++z) {
        const int i = 256 * z + t;
        const uint32_t dy = rotl1(box[i]) - (t >= 16 ? rotl1(box[i - 16]) : 0u);
        const uint32_t left = __shfl_up_sync(kFull, dy, 1);
        const uint32_t dxy = dy - (t % 16 ? left : 0u);
        x[pad(i)] = complement_negative(dxy - prev);
        prev = dxy;
    }
    __syncthreads();
}

// Tickets between a CTA and the block it asks the L2 for: one CTA an SM of an
// H100 ahead. 66 to 264 measured the same, for the row walk and for the box.
constexpr uint32_t kAhead = 132;

// The whole work of border CTA c: its share of the border staged in s.x, then
// stored where the border starts, after the last block's run.
__device__ __forceinline__ void encode_border_share(const uint32_t* __restrict__ words, const Border& border,
                                                    uint64_t c, uint64_t num_hc, uint64_t* status,
                                                    uint32_t* __restrict__ stream, EncodeRunShared& s) {
    stage_border(words, border, c, s.x);
    if (threadIdx.x == 0) s.exclusive = wait_inclusive(status + num_hc - 1);
    __syncthreads();
    store_lines(stream + num_hc + s.exclusive + c * kHcSize, s.x,
                static_cast<int>(border_end(border, c) - c * kHcSize));
}

template <int Dims>
__global__ void __launch_bounds__(kThreads)
encode_blocks_nd(const uint32_t* __restrict__ words, Blocks<Dims> geo, Border border, bool vec,
                 uint64_t num_hc, uint64_t* status, uint32_t* __restrict__ stream,
                 int32_t* __restrict__ length) {
    __shared__ EncodeRunShared s;
    __shared__ uint64_t origin;  // of the CTA's block in the grid
    __shared__ uint64_t ahead;   // of the block kAhead tickets on, or ~0 past the last block
    // The CTA's block is a ticket (common.cuh's take_ticket; the counter is the word after the
    // num_hc status words); the thread that draws it also splits it over the block grid, once.
    if (threadIdx.x == 0) {
        s.block = atomicAdd(reinterpret_cast<uint32_t*>(status + num_hc), 1u);
        if (s.block < num_hc) origin = geo.origin32(s.block);
        ahead = s.block + kAhead < num_hc ? geo.origin32(s.block + kAhead) : ~0ull;
    }
    __syncthreads();
    const uint64_t b = s.block;
    if (b >= num_hc) {
        encode_border_share(words, border, b - num_hc, num_hc, status, stream, s);
        return;
    }

    if (ahead != ~0ull) prefetch_block(words + ahead, geo);
    load_block(words + origin, geo, vec, s.x);  // with the differences along the rows
    __syncthreads();
    if constexpr (Dims == 2) {
        difference_columns(s.x);
    } else {
        difference_yz(s.x);
    }
    encode_run(s, b, num_hc, status, stream);

    if (b == num_hc - 1 && threadIdx.x == 0)  // the body's total is s.exclusive + s.length
        *length = static_cast<int32_t>(num_hc + s.exclusive + s.length + border.count);
}

static_assert(offsetof(EncodeRunShared, run) % 128 == 0, "the box lands in s.run, 128-byte aligned");

// encode_blocks_nd<3> for a grid whose rows start 16-byte aligned, with the
// block's load and prefetch through the grid's tensor map (grid_nd.cuh's
// box_map): the CTA's block moves into s.run, which lies unused until the
// compaction, as one 16 KiB box, and difference_box takes it from there into
// s.x. Border CTAs and everything from s.x on are encode_blocks_nd's. Six
// CTAs an SM, as there: the bound keeps ptxas under the 42 registers a thread
// that leaves.
__global__ void __launch_bounds__(kThreads, 6)
encode_blocks_nd_box(const __grid_constant__ CUtensorMap map, const uint32_t* __restrict__ words, Blocks<3> geo,
                     Border border, uint64_t num_hc, uint64_t* status, uint32_t* __restrict__ stream,
                     int32_t* __restrict__ length) {
    __shared__ __align__(128) EncodeRunShared s;
    __shared__ uint64_t full;  // mbarrier: the box has landed
    // The thread that draws the ticket starts the box's copy and asks the L2
    // for the box kAhead tickets on.
    if (threadIdx.x == 0) {
        s.block = atomicAdd(reinterpret_cast<uint32_t*>(status + num_hc), 1u);
        if (s.block < num_hc) {
            mbarrier_init(&full, 1);
            mbarrier_init_fence();
            mbarrier_arrive_expect(&full, kHcSize * sizeof(uint32_t));
            tensor_copy_to_shared(s.run, &map, geo.corner32(s.block), &full);
            if (s.block + kAhead < num_hc) tensor_prefetch_l2(&map, geo.corner32(s.block + kAhead));
        }
    }
    __syncthreads();
    const uint64_t b = s.block;
    if (b >= num_hc) {
        encode_border_share(words, border, b - num_hc, num_hc, status, stream, s);
        return;
    }

    mbarrier_wait(&full, 0);
    difference_box(s.run, s.x);
    encode_run(s, b, num_hc, status, stream);

    if (b == num_hc - 1 && threadIdx.x == 0)
        *length = static_cast<int32_t>(num_hc + s.exclusive + s.length + border.count);
}

template <int Dims>
int encode_nd(const uint32_t* in, uint64_t e0, uint64_t e1, uint64_t e2, uint32_t* out, uint64_t* status,
              int32_t* length, cudaStream_t s) {
    const GridNd<Dims> g(e0, e1, e2);
    const cudaError_t err = cudaMemsetAsync(status, 0, (g.num_hc + 1) * sizeof(uint64_t), s);
    if (err != cudaSuccess) return err;
    const auto ctas = static_cast<unsigned>(g.num_hc + border_ctas(g.border.count));
    const bool vec = rows_aligned(in, e2);
    if constexpr (Dims == 3) {
        if (vec) {
            CUtensorMap map;
            if (const int bad = box_map(&map, in, e0, e1, e2)) return bad;
            encode_blocks_nd_box<<<ctas, kThreads, 0, s>>>(map, in, g.blocks, g.border, g.num_hc, status, out,
                                                            length);
            return cudaGetLastError();
        }
    }
    encode_blocks_nd<Dims><<<ctas, kThreads, 0, s>>>(in, g.blocks, g.border, vec, g.num_hc, status, out, length);
    return cudaGetLastError();
}

}  // namespace ndzip

// words: the grid of `dims` (2 or 3) dims, its shape padded in front with 1s
// to (e0, e1, e2), with at least one whole block. stream: room for the
// compressed bound. status: num_hc + 1 64-bit words of scratch, which belong
// to this call alone. length: one int32. Launches on the current device.
// Returns the first CUDA error, 0 if none.
extern "C" int ndzip_encode_fp32_nd(const void* words, int64_t dims, int64_t e0, int64_t e1, int64_t e2,
                                    void* stream, void* status, void* length, void* cuda_stream) {
    using namespace ndzip;
    const auto* in = static_cast<const uint32_t*>(words);
    auto* out = static_cast<uint32_t*>(stream);
    auto* st = static_cast<uint64_t*>(status);
    auto* len = static_cast<int32_t*>(length);
    const auto s = static_cast<cudaStream_t>(cuda_stream);
    if (dims == 2) return encode_nd<2>(in, e0, e1, e2, out, st, len, s);
    if (dims == 3) return encode_nd<3>(in, e0, e1, e2, out, st, len, s);
    return cudaErrorInvalidValue;
}

// CTAs of encode_blocks_nd for `dims` (2 or 3) that one SM holds at a time,
// or minus the CUDA error.
extern "C" int ndzip_encode_fp32_nd_ctas_per_sm(int64_t dims) {
    if (dims == 2) return ndzip::ctas_per_sm(ndzip::encode_blocks_nd<2>);
    if (dims == 3) return ndzip::ctas_per_sm(ndzip::encode_blocks_nd<3>);
    return -static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of encode_blocks_nd_box (3D grids whose rows start 16-byte aligned)
// that one SM holds at a time, or minus the CUDA error.
extern "C" int ndzip_encode_fp32_nd_box_ctas_per_sm() { return ndzip::ctas_per_sm(ndzip::encode_blocks_nd_box); }
