"""The benchmark's plain reference of the ndzip codec: PyTorch tensor ops on
int32 words (fp32) or int64 words (fp64), on any device, for grids of 1-3
dims.

A frozen copy of the port's plain codec (``ndzip_tpu_torch/codec_torch.py``)
with its imports rewritten to this folder's ``format`` and ``bitops``, so
that the benchmark's yardstick does not move when the program does. It
imports nothing of the program; ``portbench/tests`` hold it to the port's
numpy ``golden`` codec byte for byte. ``encode`` works a stream out again
from the words the benchmark made; ``decode`` is used by the control.

Stream layout (the ndzip format), held as int32 words whatever the profile:
``num_hc`` u32 header entries, each the offset after a block counted in the
profile's words from the first body word; for fp64 one zero u32 pad entry
when ``num_hc`` is odd, so the body starts at u64 word
``hw = format.header_words(num_hc, 64)``; then each block's ``4096 / W``
head words (W the word width) followed by its nonzero bit-transposed words;
then the border elements verbatim, one word each, in the order of
``border_take``.
"""

from __future__ import annotations

import math

import torch

from . import bitops
from . import format as fmt

HC = fmt.HC_SIZE                   # words per block

# ------------------------------------------------------------ block geometry


def _interior(shape):
    side = fmt.SIDE_LENGTH[len(shape)]
    return tuple(slice(0, g * side) for g in fmt.grid_shape(shape))


def gather_blocks(words: torch.Tensor, shape) -> torch.Tensor:
    """Every whole block of ``words`` (of ``shape``) as a (num_hc, 4096)
    tensor, in canonical block order, row-major inside each block."""
    shape = tuple(shape)
    dims, side, grid = len(shape), fmt.SIDE_LENGTH[len(shape)], fmt.grid_shape(shape)
    split = tuple(x for g in grid for x in (g, side))
    perm = tuple(range(0, 2 * dims, 2)) + tuple(range(1, 2 * dims, 2))
    blocks = words.reshape(shape)[_interior(shape)].reshape(split).permute(perm)
    return blocks.reshape(math.prod(grid), HC)


def scatter_blocks(blocks: torch.Tensor, shape, out: torch.Tensor) -> None:
    """Inverse of ``gather_blocks``: write the blocks into ``out`` (of
    ``shape``) in place. Border elements are left as they are."""
    shape = tuple(shape)
    dims, side, grid = len(shape), fmt.SIDE_LENGTH[len(shape)], fmt.grid_shape(shape)
    inv_perm = [a for d in range(dims) for a in (d, dims + d)]
    interior = blocks.reshape(grid + (side,) * dims).permute(inv_perm)
    out.reshape(shape)[_interior(shape)] = interior.reshape(tuple(g * side for g in grid))


def block_transform(blocks: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Forward transform of (nb, 4096) int32/int64 blocks: rotate-left-1, first
    differences along each axis in ``format.FORWARD_AXIS_ORDER[dims]``
    (the first element of each line stays), complement-negative."""
    side = fmt.SIDE_LENGTH[dims]
    x = bitops.rotate_left_1(blocks).reshape((-1,) + (side,) * dims)
    for axis in fmt.FORWARD_AXIS_ORDER[dims]:
        d = x.clone()
        d.narrow(axis + 1, 1, side - 1).sub_(x.narrow(axis + 1, 0, side - 1))
        x = d
    return bitops.complement_negative(x.reshape(-1, HC))


def inverse_block_transform(blocks: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Complement-negative, wrapping prefix sums along each axis in the
    reversed forward order, rotate-right-1."""
    side = fmt.SIDE_LENGTH[dims]
    x = bitops.complement_negative(blocks).reshape((-1,) + (side,) * dims)
    for axis in reversed(fmt.FORWARD_AXIS_ORDER[dims]):
        x = torch.cumsum(x, dim=axis + 1, dtype=x.dtype)
    return bitops.rotate_right_1(x.reshape(-1, HC))


# ------------------------------------------------------------ border


def _box(shape):
    """``shape`` padded in front with 1s to three axes, and the extent each
    axis' whole blocks cover (a padded axis counts as covered)."""
    dims = len(shape)
    side = fmt.SIDE_LENGTH[dims]
    e = (1,) * (3 - dims) + tuple(shape)
    b = (1,) * (3 - dims) + tuple(s // side * side for s in shape)
    return e, b


def border_take(words: torch.Tensor, shape) -> torch.Tensor:
    """The border of ``words`` (of ``shape``) in stream order, as at most
    three box slices."""
    shape = tuple(shape)
    w = words.reshape(shape)
    if any(s < fmt.SIDE_LENGTH[len(shape)] for s in shape):
        return w.reshape(-1)
    (_, e1, e2), (b0, b1, b2) = _box(shape)
    w = w.reshape(-1, e1, e2)
    per_p = torch.cat([w[:b0, :b1, b2:].reshape(b0, -1), w[:b0, b1:, :].reshape(b0, -1)], dim=1)
    return torch.cat([per_p.reshape(-1), w[b0:].reshape(-1)])


def border_place(out: torch.Tensor, values: torch.Tensor, shape) -> None:
    """Inverse of ``border_take``: write the stream-order border ``values``
    into ``out`` (of ``shape``) in place."""
    shape = tuple(shape)
    if any(s < fmt.SIDE_LENGTH[len(shape)] for s in shape):
        out.reshape(-1)[:] = values
        return
    (e0, e1, e2), (b0, b1, b2) = _box(shape)
    w = out.reshape(-1, e1, e2)
    wa, wb = b1 * (e2 - b2), (e1 - b1) * e2
    per_p = values[: b0 * (wa + wb)].reshape(b0, wa + wb)
    w[:b0, :b1, b2:] = per_p[:, :wa].reshape(b0, b1, e2 - b2)
    w[:b0, b1:, :] = per_p[:, wa:].reshape(b0, e1 - b1, e2)
    w[b0:] = values[b0 * (wa + wb):].reshape(e0 - b0, e1, e2)


# ------------------------------------------------------------ blocks


def _bit_weights(bits: int, dtype, device) -> torch.Tensor:
    """Word i of a chunk -> head bit (W-1-i) of a W-bit word (the top bit is
    the signed type's minimum)."""
    return torch.ones(bits, dtype=dtype, device=device) << (
        bits - 1 - torch.arange(bits, dtype=dtype, device=device))


def encode_blocks_dense(blocks: torch.Tensor, dims: int = 1):
    """Transform, chunk and bit-transpose (nb, 4096) int32 (fp32) or int64
    (fp64) blocks of a ``dims``-dimensional grid, before compaction
    (``golden.encode_blocks_dense``).

    Returns ``(dense, valid, lengths)``: ``dense`` (nb, 4096/W + 4096) words,
    per block its W-bit head words then every transposed word, zeros
    included; ``valid`` the bool mask of the words the stream keeps;
    ``lengths`` (nb,) int64 words per block."""
    nb, bits = blocks.shape[0], bitops.word_bits(blocks)
    heads_n = HC // bits
    t = bitops.transpose_bits(block_transform(blocks, dims).reshape(nb, heads_n, bits))
    nz = t != 0
    # distinct powers of two sum to their OR: head bit (W-1-i) <=> word i != 0
    heads = (nz.to(blocks.dtype) * _bit_weights(bits, blocks.dtype, blocks.device)).sum(-1, dtype=blocks.dtype)
    dense = torch.cat([heads, t.reshape(nb, HC)], dim=1)
    valid = torch.cat([torch.ones_like(heads, dtype=torch.bool), nz.reshape(nb, HC)], dim=1)
    return dense, valid, valid.sum(dim=1)


def encode_blocks_ref(blocks: torch.Tensor, dims: int = 1):
    """Encode (nb, 4096) int32 (fp32) or int64 (fp64) blocks of a
    ``dims``-dimensional grid.

    Returns ``(header, body, lengths)``: ``header`` (nb,) int32 offset-after
    entries in the profile's words, ``body`` the blocks' compressed words back
    to back in the blocks' dtype (what the stream holds from the first body
    word on), ``lengths`` (nb,) int64 words per block."""
    dense, valid, lengths = encode_blocks_dense(blocks, dims)
    header = torch.cumsum(lengths, 0).to(torch.int32)
    return header, dense[valid], lengths


def _stream_words(stream: torch.Tensor, word_bits: int) -> torch.Tensor:
    """The int32 stream as the profile's words: itself for fp32, its int64
    view for fp64 (an fp64 stream holds a whole number of u64 words)."""
    if word_bits == 32:
        return stream
    if stream.numel() % 2:
        raise ValueError(f"an fp64 stream holds a whole number of u64 words, got {stream.numel()} u32 words")
    return stream.view(torch.int64)


def decode_blocks_ref(stream: torch.Tensor, num_hc: int, dims: int = 1, word_bits: int = 32) -> torch.Tensor:
    """Decode the ``num_hc`` blocks of an int32 stream (header from word 0)
    of a ``dims``-dimensional grid into (num_hc, 4096) words: int32 for
    ``word_bits`` 32, int64 for 64. Reads only the words each block owns, so
    whatever lies past the stream's length does not matter."""
    if stream.numel() < fmt.header_u32_words(num_hc, word_bits):
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {num_hc}-entry header")
    dev = stream.device
    words = _stream_words(stream, word_bits)
    heads_n, last = HC // word_bits, words.numel() - 1
    offsets = stream[:num_hc].to(torch.int64)
    starts = fmt.header_words(num_hc, word_bits) + torch.cat([offsets.new_zeros(1), offsets[:-1]])
    heads = words[(starts[:, None] + torch.arange(heads_n, device=dev)).clamp_(0, last)]
    shifts = word_bits - 1 - torch.arange(word_bits, dtype=words.dtype, device=dev)
    present = (heads[:, :, None] >> shifts) & 1                                 # (nb, heads_n, W)
    rank = torch.cumsum(present, dim=2, dtype=torch.int32) - present
    counts = present.sum(dim=2, dtype=torch.int32)
    chunk_start = heads_n + torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    src = starts[:, None, None] + (chunk_start[:, :, None] + rank)
    chunks = torch.where(present != 0, words[src.clamp_(0, last)], 0)
    blocks = bitops.transpose_bits(chunks).reshape(num_hc, HC)
    return inverse_block_transform(blocks, dims)


# ------------------------------------------------------------ codec


def encode(words: torch.Tensor, shape=None):
    """Compress int32 (fp32) or int64 (fp64) words of ``shape`` (default:
    their own shape, 1-3 dims). Returns ``(stream, length)``: an int32 stream
    of ``format.compressed_bound_u32(shape, W)`` words, zero past ``length``,
    and ``length`` in u32 words as an int32 scalar tensor on the same
    device."""
    shape = tuple(words.shape if shape is None else shape)
    bits = bitops.word_bits(words)
    num_hc = fmt.num_hypercubes(shape)
    parts = []
    if num_hc:
        header, body, _ = encode_blocks_ref(gather_blocks(words, shape), len(shape))
        pad = header.new_zeros(fmt.header_u32_words(num_hc, bits) - num_hc)  # fp64, odd num_hc
        parts += [header, pad, body.view(torch.int32)]
    parts.append(border_take(words, shape).reshape(-1).view(torch.int32))
    flat = torch.cat(parts)
    stream = torch.zeros(fmt.compressed_bound_u32(shape, bits), dtype=torch.int32, device=words.device)
    stream[: flat.numel()] = flat
    return stream, torch.tensor(flat.numel(), dtype=torch.int32, device=words.device)


def decode(stream: torch.Tensor, shape, word_bits: int = 32) -> torch.Tensor:
    """Decompress an int32 stream into words of ``shape`` (1-3 dims): int32
    for ``word_bits`` 32, int64 for 64."""
    shape = tuple(shape)
    num_hc = fmt.num_hypercubes(shape)
    words = _stream_words(stream, word_bits)
    out = torch.empty(shape, dtype=words.dtype, device=stream.device)
    border_start = torch.zeros((), dtype=torch.int64, device=stream.device)
    if num_hc:
        scatter_blocks(decode_blocks_ref(stream, num_hc, len(shape), word_bits), shape, out)
        border_start = fmt.header_words(num_hc, word_bits) + stream[num_hc - 1].to(torch.int64)
    border = fmt.border_element_count(shape)
    if border:
        border_place(out, words[border_start + torch.arange(border, device=stream.device)], shape)
    return out
