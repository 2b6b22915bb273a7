"""The fp64 decoders' arithmetic (``csrc/common64.cuh``'s ``start_run_copy64``
and ``expand_run64``, ``csrc/decode_fp64_nd.cu``'s order of the inverse
transform with ``csrc/grid_nd64.cuh``'s ``store_block64_rowsum``), modelled
on the CPU.

The kernels run only on a card, so what they compute is modelled here in
numpy, lane for lane where lanes talk to each other (warp scans,
``__shfl_up_sync``, the transpose of ``tests/test_torch_transpose64.py``):

* the bulk copy's window: for every skew of the stream in memory and many
  run starts, for runs of 64, 65, 4159 and 4160 words, whole or cut by the
  stream's size, and for damaged headers, the window stays inside
  ``[0, size)``, is 16-byte aligned in memory and in shared memory, fits the
  run buffer, and with the plain loads beside it covers exactly the
  available run;
* the expansion: each warp's start from the two-per-lane scan of the heads'
  popcounts, the rank gather from the run as the copy left it in shared
  memory (garbage beyond the run: only heads are read there, and no word
  past the available run enters the block), and the transpose, against the body of ``golden.encode_blocks_dense`` and
  ``golden.block_transform`` on random, sparse, all-zero and all-dense
  blocks, and against a plain sequential expansion with zeros past the cut
  when the run is truncated;
* the 2D/3D inverse transform in the decoder's order: passes along the
  columns (2D) or along z and then y (3D) in the segments a thread walks,
  then the sums along the rows on the store, the 32 (2D) or 8 (3D) lanes of
  a row each summing two words and scanning the sums; or, for rows that are
  not 16-byte aligned, a third pass and a store of one word a lane; and the
  1D decoder's scan of 16 words a thread, a warp scan and a carry. Each
  against ``golden.inverse_block_transform`` on wrapping int64 data.

The JAX package's ``golden`` is imported only to hold the port's to it.
"""

import numpy as np
import pytest

from ndzip_tpu import golden as ref_golden
from ndzip_tpu_torch import format as fmt
from ndzip_tpu_torch import golden
from test_torch_transpose64 import transpose_lane64

HC = fmt.HC_SIZE
CHUNKS, RUN_MAX, RUN_SLOTS = 64, 64 + HC, 64 + HC + 2  # kChunks64, kRunMax64, kRunSlots64
LANE = np.arange(32)
U64 = np.uint64
GARBAGE = U64(0xDEADBEEFCAFEF00D)


# ------------------------------------------------------------ start_run_copy64


def run_copy(size: int, num_hc: int, h0: int, h1: int, base: int):
    """start_run_copy64 for a stream of ``size`` u32 words whose first word
    lies ``base`` u64 words past a 16-byte boundary. Returns (skew, avail,
    start, window, plain): the bulk copy's [lo, hi) in stream u64 indices or
    None, and the stream words loaded one by one."""
    length = (h1 - h0) % 2**32  # u32 arithmetic: a header that decreases gives a huge length
    length = min(max(length, CHUNKS), RUN_MAX)
    n, start = size // 2, (num_hc + 1) // 2 + h0
    avail = min(n - start, length) if start < n else 0
    skew = (start + base) & 1
    end = start + avail
    lo, hi = start - skew, end + ((end + base) & 1)
    if hi > n:
        hi -= 2
    if hi > lo:
        return skew, avail, start, (lo, hi), list(range(start, lo)) + list(range(hi, end))
    return skew, avail, start, None, list(range(start, end))


def copy_into_buffer(stream64: np.ndarray, num_hc: int, h0: int, h1: int, base: int):
    """The run buffer as start_run_copy64 leaves it (garbage where nothing
    was copied), with the run's skew and avail."""
    skew, avail, start, window, plain = run_copy(2 * stream64.size, num_hc, h0, h1, base)
    buf = np.full(RUN_SLOTS, GARBAGE, U64)
    if window:
        lo, hi = window
        buf[skew - start + lo: skew - start + hi] = stream64[lo:hi]
    for w in plain:
        buf[skew - start + w] = stream64[w]
    return buf, skew, avail


def window_cases():
    for base in (0, 1):
        for num_hc in (1, 2, 3, 6):
            hw = (num_hc + 1) // 2
            for length in (64, 65, 4159, 4160):
                for h0 in (0, 1, 2, 3, 1000, 1001):
                    start = hw + h0
                    sizes = {start + length + extra for extra in (0, 1, 2, 5)}
                    sizes |= {max(hw, start + cut) for cut in (-1, 0, 1, 2, 3, length // 2, length - 2, length - 1)}
                    for n in sorted(sizes):
                        yield base, num_hc, h0, h0 + length, 2 * n
                    # damaged headers: a decreasing entry, one far past the stream
                    yield base, num_hc, h0 + 5, h0, 2 * (start + 100)
                    yield base, num_hc, h0, h0 + 10**6, 2 * (start + length)


def test_run_copy_window_stays_inside_and_covers_the_run():
    cases = 0
    for base, num_hc, h0, h1, size in window_cases():
        n = size // 2
        skew, avail, start, window, plain = run_copy(size, num_hc, h0, h1, base)
        length = min(max((h1 - h0) % 2**32, CHUNKS), RUN_MAX)
        assert avail == max(0, min(length, n - start))
        assert skew in (0, 1) and (base + start - skew) % 2 == 0
        assert start - skew >= 0  # the window needs no cut at the stream's start
        end = start + avail
        covered = list(plain)
        if window:
            lo, hi = window
            assert 0 <= lo < hi <= n                                   # never leaves [0, size)
            assert (base + lo) % 2 == 0 and (base + hi) % 2 == 0       # 16-byte aligned in memory
            assert (skew - start + lo) % 2 == 0                        # and in the (aligned) buffer
            assert 0 <= skew - start + lo and skew - start + hi <= RUN_SLOTS
            assert not set(plain) & set(range(lo, hi))
            covered += range(lo, hi)
        assert len(covered) == len(set(covered))
        assert all(0 <= w < n for w in covered)
        assert set(range(start, end)) <= set(covered)                  # the available run, all of it
        assert set(covered) - set(range(start, end)) <= {start - 1, end}  # and at most the skew's words
        assert len(plain) <= 2
        cases += 1
    assert cases > 1500


@pytest.mark.parametrize("base", [0, 1])
def test_run_copy_puts_word_i_at_skew_plus_i(base):
    rng = np.random.default_rng(base)
    stream64 = rng.integers(0, 2**64, 9000, dtype=U64)
    for num_hc, h0, length in ((1, 0, 4160), (2, 7, 64), (3, 8, 65), (6, 4001, 4159), (5, 4470, 4160)):
        buf, skew, avail = copy_into_buffer(stream64, num_hc, h0, h0 + length, base)
        start = (num_hc + 1) // 2 + h0
        assert avail == min(length, stream64.size - start)
        assert np.array_equal(buf[skew: skew + avail], stream64[start: start + avail])


# ------------------------------------------------------------ expand_run64


def popc(x) -> np.ndarray:
    return np.bitwise_count(np.asarray(x, U64)).astype(np.int64)


def brev64(v: int) -> int:
    return int(f"{v:064b}"[::-1], 2)


def expand_model(buf: np.ndarray, skew: int, avail: int):
    """expand_run64 on the run buffer: returns the gathered words (the
    stream's transposed words, chunk after chunk) and the block it writes
    (without the pad slots)."""
    run = buf[skew:]
    heads = run[:CHUNKS]  # read whether or not they lie below avail
    two = popc(heads[0::2]) + popc(heads[1::2])                  # lane l: chunks 2l and 2l + 1
    before = np.cumsum(two) - two                                # warp_inclusive_scan - own
    gathered, block = np.zeros(HC, U64), np.zeros(HC, U64)
    below_a = (U64(1) << LANE.astype(U64)) - U64(1)
    below_c = (U64(1) << (LANE + 32).astype(U64)) - U64(1)
    for warp in range(8):
        at = CHUNKS + int(before[4 * warp])                      # __shfl_sync(before, 4 * warp)
        for k in range(8):
            chunk = 8 * warp + k
            present = U64(brev64(int(heads[chunk])))
            i, j = at + popc(present & below_a), at + popc(present & below_c)
            has_a = ((present >> LANE.astype(U64)) & U64(1)).astype(bool)
            has_c = ((present >> (LANE + 32).astype(U64)) & U64(1)).astype(bool)
            a = np.array([run[r] if h and r < avail else U64(0) for h, r in zip(has_a, i)], U64)
            c = np.array([run[r] if h and r < avail else U64(0) for h, r in zip(has_c, j)], U64)
            gathered[64 * chunk: 64 * chunk + 32], gathered[64 * chunk + 32: 64 * chunk + 64] = a, c
            ta, tc = transpose_lane64(a, c)
            block[64 * chunk: 64 * chunk + 32], block[64 * chunk + 32: 64 * chunk + 64] = ta, tc
            at += int(popc(present))
    return gathered, block


def sequential_expand(run: np.ndarray, avail: int) -> np.ndarray:
    """The plain expansion: the 64 heads, then each head's words in order,
    every word at or past avail read as 0."""
    def word(i):
        return int(run[i]) if i < avail else 0

    out, at = np.zeros(HC, U64), CHUNKS
    for c in range(CHUNKS):
        head = word(c)
        for i in range(64):
            if head >> (63 - i) & 1:
                out[64 * c + i] = word(at)
                at += 1
    return out


KINDS = ["random", "sparse", "all zeros", "all dense"]


def blocks_of(kind: str, nb: int = 3) -> np.ndarray:
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "random":
        x = np.sin(np.arange(nb * HC) * 1e-3) + 1e-3 * rng.standard_normal(nb * HC)
    elif kind == "sparse":
        x = np.zeros(nb * HC)
        x[rng.integers(0, nb * HC, 300)] = rng.standard_normal(300)
    elif kind == "all zeros":
        x = np.zeros(nb * HC)
    else:
        x = rng.integers(0, 2**64, nb * HC, dtype=U64).view(np.float64)
    return x


def stream_of(x: np.ndarray):
    stream, length = golden.compress(x)
    ref, ref_length = ref_golden.compress(x)
    assert length == ref_length and stream.tobytes() == ref.tobytes()
    return np.ascontiguousarray(stream).view(U64)[:length], x.size // HC


@pytest.mark.parametrize("base", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_expand_run_matches_encode_blocks_dense(kind, base):
    x = blocks_of(kind)
    stream64, num_hc = stream_of(x)
    header = stream64.view(np.uint32)[:num_hc].astype(np.int64)
    words = x.view(U64).reshape(num_hc, HC)
    dense, valid, lengths = golden.encode_blocks_dense(words, 1)
    ref_dense, _, _ = ref_golden.encode_blocks_dense(words, 1)
    assert np.array_equal(dense, ref_dense)
    if kind == "all zeros":
        assert np.all(lengths == CHUNKS)
    if kind == "all dense":
        assert np.all(lengths == RUN_MAX)
    transformed = golden.block_transform(words, 1)
    for b in range(num_hc):
        h0, h1 = (int(header[b - 1]) if b else 0), int(header[b])
        buf, skew, avail = copy_into_buffer(stream64, num_hc, h0, h1, base)
        assert avail == lengths[b]
        gathered, block = expand_model(buf, skew, avail)
        assert np.array_equal(gathered, dense[b, CHUNKS:])
        assert np.array_equal(block, transformed[b])


@pytest.mark.parametrize("kind", ["random", "sparse", "all dense"])
def test_expand_run_of_a_truncated_run(kind):
    """A stream cut inside a run (and before it): no word past the cut is
    read, and the missing words count as zeros."""
    stream64, num_hc = stream_of(blocks_of(kind))
    header = stream64.view(np.uint32)[:num_hc].astype(np.int64)
    hw = (num_hc + 1) // 2
    b = num_hc - 1
    h0, h1 = int(header[b - 1]), int(header[b])
    start = hw + h0
    for cut in sorted({start, start + 1, start + 33, start + 64, start + 65, start + (h1 - h0) // 2,
                       start + h1 - h0 - 1}):
        cut_stream = stream64[:cut]
        buf, skew, avail = copy_into_buffer(cut_stream, num_hc, h0, h1, 1)
        assert avail == cut - start
        zeros_past = np.zeros(RUN_MAX, U64)
        zeros_past[:avail] = stream64[start: start + avail]
        gathered, block = expand_model(buf, skew, avail)
        want = sequential_expand(zeros_past, RUN_MAX)
        assert np.array_equal(gathered, want), cut
        assert np.array_equal(block, golden.transpose_bits(want.reshape(CHUNKS, 64)).reshape(-1)), cut


# ------------------------------------------------------------ the inverse transform's order


def complement_negative(x: np.ndarray) -> np.ndarray:
    return np.where(x >> U64(63), x ^ U64(0x7FFFFFFFFFFFFFFF), x)


def rotr1(x: np.ndarray) -> np.ndarray:
    return (x >> U64(1)) | (x << U64(63))


def segment(dims: int, axis: int, t: int):
    """grid_nd.cuh's segment<Dims, Axis>(t): start, step, s, tstride."""
    if dims == 2:
        if axis == 1:
            return 16 * t, 1, t & 3, 1
        return (t >> 6) * 16 * 64 + (t & 63), 64, t >> 6, 64
    if axis == 2:
        return 16 * t, 1, 0, 0
    if axis == 0:
        return t, 256, 0, 0
    w, lane = t >> 5, t & 31
    z = 4 * (w >> 1) + (w & 1) + 2 * (lane >> 4)
    return z * 256 + (lane & 15), 16, 0, 0


def prefix_pass(x: np.ndarray, dims: int, axis: int, first: bool) -> np.ndarray:
    """prefix_sum64<Dims, Axis, kFirst>: each of 256 threads scans its 16
    words; in 2D it adds the sums of the segments before its own."""
    idx = np.array([[segment(dims, axis, t)[0] + k * segment(dims, axis, t)[1] for k in range(16)]
                    for t in range(256)])
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(HC))  # every word once
    u = x[idx]
    if first:
        u = complement_negative(u)
    v = np.cumsum(u, axis=1, dtype=U64)
    if dims == 2:
        partial = v[:, -1]
        carry = np.array([partial[[t - j * segment(2, axis, t)[3] for j in range(1, segment(2, axis, t)[2] + 1)]]
                          .sum(dtype=U64) for t in range(256)], U64)
        v = v + carry[:, None]
    out = x.copy()
    out[idx] = v
    return out


def store_rowsum(x: np.ndarray, dims: int) -> np.ndarray:
    """store_block64_rowsum into the block (row-major, unpadded): thread t's
    words i, i + 1 for i = 2 (t + 256 k); lanes of a row scan their sums
    with __shfl_up_sync within the warp."""
    side = 64 if dims == 2 else 16
    lanes = side // 2
    out = np.zeros(HC, U64)
    for k in range(HC // 2 // 256):
        for warp in range(8):
            i = 2 * (32 * warp + LANE + 256 * k)
            a = x[i]
            c = a + x[i + 1]
            total = c.copy()
            at = LANE & (lanes - 1)
            off = 1
            while off < lanes:
                up = total[np.maximum(LANE - off, 0)]           # __shfl_up_sync: lane - off, own if < 0
                total = np.where(at >= off, total + up, total)
                off <<= 1
            before = total - c
            out[i], out[i + 1] = rotr1(a + before), rotr1(c + before)
            assert np.all(i // side == (i + 1) // side)          # a lane's two words share a row
    return out


def decode_order_nd(block: np.ndarray, dims: int, vec: bool) -> np.ndarray:
    x = prefix_pass(block, dims, 0, True)
    if dims == 3:
        x = prefix_pass(x, 3, 1, False)
    if vec:
        return store_rowsum(x, dims)
    return rotr1(prefix_pass(x, dims, dims - 1, False))       # store_block64: one word a lane


def decode_order_1d(block: np.ndarray) -> np.ndarray:
    """decode_fp64.cu: 16 words a thread, a warp scan of the thread sums,
    the sums of the warps before, rotate right."""
    seg = np.cumsum(complement_negative(block).reshape(256, 16), axis=1, dtype=U64)
    sums = seg[:, -1].reshape(8, 32)
    incl = np.cumsum(sums, axis=1, dtype=U64)
    warp_totals = incl[:, -1]
    carry = (incl - sums) + (np.cumsum(warp_totals, dtype=U64) - warp_totals)[:, None]
    return rotr1(seg + carry.reshape(256, 1)).reshape(-1)


@pytest.mark.parametrize("dims, vec", [(1, True), (2, True), (2, False), (3, True), (3, False)])
def test_decoder_order_matches_inverse_block_transform(dims, vec):
    rng = np.random.default_rng(dims)
    blocks = rng.integers(0, 2**64, (3, HC), dtype=U64)
    blocks[1] = golden.block_transform(rng.integers(0, 2**64, (1, HC), dtype=U64), dims)[0]
    blocks[2, :HC // 2] = 0
    want = golden.inverse_block_transform(blocks, dims)
    assert np.array_equal(want, ref_golden.inverse_block_transform(blocks, dims))
    for b in range(blocks.shape[0]):
        got = decode_order_1d(blocks[b]) if dims == 1 else decode_order_nd(blocks[b], dims, vec)
        assert np.array_equal(got, want[b]), b
