"""The fp64 encoders' 64x64 bit transpose, ``TransposeLane64`` of
``ndzip_tpu_torch/csrc/common64.cuh``, modelled on the CPU.

The kernel runs only on a card, so its arithmetic is modelled here lane for
lane: 32 lanes in numpy, each with its ``TransposeLane`` selectors (copied
from ``csrc/common.cuh``), ``__shfl_xor_sync`` as a permutation of the lanes,
``__byte_perm`` and ``__funnelshift_l`` as CUDA defines them. A chunk's rows
r and r + 32 sit in lane r's two words; the model swaps the low half of the
first with the high half of the second and runs the 32-bit transpose on each
of the four halves. It must give the JAX package's ``transpose_bits``
(numpy path) and the port's ``golden.transpose_bits``, exactly, on random,
sparse, all-zero, all-ones and one-bit chunks.
"""

import numpy as np
import pytest

from ndzip_tpu.ops import bitops as ref_bitops
from ndzip_tpu_torch import golden

LANE = np.arange(32)
M32 = np.uint64(0xFFFFFFFF)


def shfl_xor(x: np.ndarray, j: int) -> np.ndarray:
    return x[LANE ^ j]


def byte_perm(x: np.ndarray, y: np.ndarray, s: np.ndarray) -> np.ndarray:
    """``__byte_perm(x, y, s)``: byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes of y:x (x's bytes 0-3, y's bytes 4-7)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        sel = ((s >> (4 * n)) & 7).astype(np.uint64)
        out |= ((both >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def funnelshift_l(lo: np.ndarray, hi: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """``__funnelshift_l(lo, hi, shift)``: the high 32 bits of hi:lo shifted
    left by shift & 31."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both << (shift & 31).astype(np.uint64)) >> np.uint64(32)).astype(np.uint32)


def pick(bit: int, yes: int, no: int) -> np.ndarray:
    return np.where(LANE & bit, np.uint32(yes), np.uint32(no)).astype(np.uint32)


# TransposeLane's selectors, as its constructor sets them for each lane
PERM16, PERM8 = pick(16, 0x5410, 0x3276), pick(8, 0x6240, 0x3715)
ROT4, ROT2, ROT1 = pick(4, 4, 28), pick(2, 2, 30), pick(1, 1, 31)
KEEP4, KEEP2, KEEP1 = pick(4, 0x0F0F0F0F, 0xF0F0F0F0), pick(2, 0x33333333, 0xCCCCCCCC), pick(1, 0x55555555, 0xAAAAAAAA)


def transpose_lane(x: np.ndarray) -> np.ndarray:
    """TransposeLane::operator() on the 32 lanes' uint32 words."""
    x = byte_perm(x, shfl_xor(x, 16), PERM16)
    x = byte_perm(x, shfl_xor(x, 8), PERM8)
    for j, rot, keep in ((4, ROT4, KEEP4), (2, ROT2, KEEP2), (1, ROT1, KEEP1)):
        p = shfl_xor(x, j)
        x = (x & keep) | (funnelshift_l(p, p, rot) & ~keep)
    return x


def transpose_lane64(a: np.ndarray, b: np.ndarray):
    """TransposeLane64::operator(): lane r holds rows r (a) and r + 32 (b)."""
    def half(v):
        return transpose_lane(v.astype(np.uint32)).astype(np.uint64)

    a_hi, a_lo = half(a >> np.uint64(32)), half(b >> np.uint64(32))
    b_hi, b_lo = half(a & M32), half(b & M32)
    return (a_hi << np.uint64(32)) | a_lo, (b_hi << np.uint64(32)) | b_lo


def model(chunk: np.ndarray) -> np.ndarray:
    a, b = transpose_lane64(chunk[:32], chunk[32:])
    return np.concatenate([a, b])


KINDS = ["random", "sparse", "all zeros", "all ones", "one bit a row"]


def chunks64(kind: str) -> np.ndarray:
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "random":
        return rng.integers(0, 2**64, (16, 64), dtype=np.uint64)
    if kind == "sparse":
        c = np.zeros((16, 64), np.uint64)
        rows, bits = rng.integers(0, 64, 40), rng.integers(0, 64, 40)
        for n, (r, bit) in enumerate(zip(rows, bits)):
            c[n % 16, r] |= np.uint64(1) << np.uint64(bit)
        return c
    if kind == "all zeros":
        return np.zeros((2, 64), np.uint64)
    if kind == "all ones":
        return np.full((2, 64), 2**64 - 1, np.uint64)
    if kind == "one bit a row":  # the diagonal, the anti-diagonal and the halves' edges
        c = np.zeros((4, 64), np.uint64)
        for r in range(64):
            c[0, r] = np.uint64(1) << np.uint64(r)
            c[1, r] = np.uint64(1) << np.uint64(63 - r)
            c[2, r] = np.uint64(1) << np.uint64(31 + (r & 1))
            c[3, r] = np.uint64(1) << np.uint64((r * 7) % 64)
        return c
    raise ValueError(kind)


@pytest.mark.parametrize("kind", KINDS)
def test_transpose_lane64_matches_transpose_bits(kind):
    chunks = chunks64(kind)
    want = ref_bitops.transpose_bits(chunks, np)
    assert np.array_equal(golden.transpose_bits(chunks), want)
    got = np.stack([model(c) for c in chunks])
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "sparse"])
def test_transpose_lane_matches_transpose_bits32(kind):
    """The 32-bit TransposeLane that the model builds on, on 32-word chunks:
    each half of the 64-bit chunks above, as uint32."""
    chunks = chunks64(kind)
    halves = np.concatenate([(chunks >> np.uint64(32)).astype(np.uint32).reshape(-1, 32),
                             (chunks & M32).astype(np.uint32).reshape(-1, 32)])
    got = np.stack([transpose_lane(c) for c in halves])
    assert np.array_equal(got, ref_bitops.transpose_bits(halves, np))
    assert np.array_equal(got, golden.transpose_bits(halves))
