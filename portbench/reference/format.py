"""ndzip stream-format geometry and layout math.

The benchmark's frozen copy of the port's geometry
(``ndzip_tpu_torch/format.py``), read by the plain reference ``codec`` beside
it.  It contains only integer math, no array framework.

Format summary (reference: src/ndzip/common.hh:328-393 and
src/ndzip/cpu_codec.inl:541-578):

* A grid of 1-3 dimensions of float32/float64 is partitioned into hypercube
  blocks of side length 4096 (1D), 64 (2D) or 16 (3D) — always 4096 elements
  per block (common.hh:368-381).
* The compressed stream is, in order:
    [header][hypercube bodies][border elements]
  - header: ``num_hypercubes`` uint32 entries; entry i is the cumulative
    word count ("offset after") of bodies 0..i, in units of the word type
    (uint32 for float, uint64 for double).  The header byte length is padded
    up to word alignment (common.hh:350-358).
  - each body: ``hc_size / word_bits`` head words first, then for each chunk
    of ``word_bits`` consecutive words (in order) whose head is nonzero, the
    nonzero bit-transposed words of that chunk, compacted in order
    (cpu_codec.inl:541-559).
  - border: grid elements not covered by a whole block, bit-cast verbatim in
    ``for_each_border_slice`` order (common.hh:245-306).
* Per-block transform before chunking: rotate-left-1 of each word, then a
  first-order difference along each axis (axis order below), then
  complement-negative sign mapping (common.hh:436-501).

All functions below take ``shape`` as a tuple of ints (first-major, i.e. the
reference's ``extent`` order) and ``word_bits`` in {32, 64}.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_DIMENSIONALITY = 3

#: Hypercube side length per dimensionality (common.hh:368-381).
SIDE_LENGTH = {1: 4096, 2: 64, 3: 16}

#: Elements per hypercube — equal for every dimensionality.
HC_SIZE = 4096

#: Forward-difference axis order of the block transform per dimensionality
#: (common.hh:469-501).  The inverse transform applies prefix sums along the
#: reversed order.
FORWARD_AXIS_ORDER = {1: (0,), 2: (1, 0), 3: (1, 2, 0)}


@dataclass(frozen=True)
class Profile:
    """Binds (word width, dimensionality) — the analog of detail::profile
    (common.hh:383-393).  Six instances exist: {32,64} x {1,2,3}."""

    word_bits: int  # 32 or 64
    dims: int  # 1..3

    def __post_init__(self):
        if self.word_bits not in (32, 64) or not 1 <= self.dims <= MAX_DIMENSIONALITY:
            raise ValueError(f"no ndzip profile of {self.word_bits}-bit words in {self.dims} dims")

    @property
    def side_length(self) -> int:
        return SIDE_LENGTH[self.dims]

    @property
    def hc_size(self) -> int:
        return HC_SIZE

    @property
    def word_bytes(self) -> int:
        return self.word_bits // 8

    @property
    def heads_per_block(self) -> int:
        """Number of head-bitmap words per block (= number of chunks)."""
        return HC_SIZE // self.word_bits

    @property
    def compressed_block_length_bound(self) -> int:
        """Max words per compressed block: heads + all chunk words nonzero
        (common.hh:391-392)."""
        return HC_SIZE // self.word_bits * (self.word_bits + 1)

    @property
    def block_shape(self) -> tuple[int, ...]:
        return (self.side_length,) * self.dims


def num_hypercubes(shape: tuple[int, ...]) -> int:
    side = SIDE_LENGTH[len(shape)]
    n = 1
    for s in shape:
        n *= s // side
    return n


def grid_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Number of whole blocks along each axis."""
    side = SIDE_LENGTH[len(shape)]
    return tuple(s // side for s in shape)


def header_words(num_hc: int, word_bits: int) -> int:
    """Header length in stream words (uint32 entries padded to word
    alignment; common.hh:350-352)."""
    word_bytes = word_bits // 8
    header_bytes = num_hc * 4
    padded = (header_bytes + word_bytes - 1) // word_bytes * word_bytes
    return padded // word_bytes


def header_u32_words(num_hc: int, word_bits: int) -> int:
    """Header length in uint32 units (including the zero pad entry for
    64-bit profiles with odd block counts; cuda_codec.inl:446-452)."""
    return header_words(num_hc, word_bits) * (word_bits // 32)


def border_element_count(shape: tuple[int, ...]) -> int:
    """common.hh:308-317."""
    side = SIDE_LENGTH[len(shape)]
    n_cube = 1
    n_all = 1
    for s in shape:
        n_cube *= s // side * side
        n_all *= s
    return n_all - n_cube


def compressed_bound_words(shape: tuple[int, ...], word_bits: int) -> int:
    """Upper bound of the compressed stream length in stream words
    (common.cc:31-52)."""
    num_hc = num_hypercubes(shape)
    p = Profile(word_bits, len(shape))
    return (
        header_words(num_hc, word_bits)
        + num_hc * p.compressed_block_length_bound
        + border_element_count(shape)
    )


def compressed_bound_u32(shape: tuple[int, ...], word_bits: int) -> int:
    return compressed_bound_words(shape, word_bits) * (word_bits // 32)


