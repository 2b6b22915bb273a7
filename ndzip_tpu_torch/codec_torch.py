"""Plain PyTorch versions of the fp32 codec, for grids of 1-3 dims.

The counterpart of ``golden.gather_blocks``/``scatter_blocks``,
``block_transform``, ``encode_blocks_dense``, ``decode_blocks_dense`` and
``golden.decompress``'s window logic, of ``codec_pallas._border_take``/
``_border_place``, and of ``codec_xla.encode_fn``/``decode_fn`` for fp32.
These are the reference the CUDA kernels of ``codec_cuda`` are held against
on the card, and the path a tensor on the CPU takes. They run on any device,
as plain tensor ops on int32 word views (see ``ops/bitops.py``).

Stream layout (``ndzip_tpu/format.py``): ``num_hc`` header words of
offset-after entries counted from the first body word, then each block's
128 head words followed by its nonzero bit-transposed words, then the border
elements verbatim, in ``format.border_slices`` order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ndzip_tpu import format as fmt

from .ops import bitops

HC = fmt.HC_SIZE                   # words per block
HEADS = fmt.HC_SIZE // 32          # 32-word chunks, hence head words, per block

_FP64_TODO = "fp64 is not ported yet (ROADMAP Queue 1 item 6)"


def _check_shape(shape) -> None:
    """Refuse what the fp32 codec cannot hold: 0 or more than 3 dims, or a
    stream too long for an int32 length."""
    fmt.validate_shape(tuple(shape))
    if fmt.compressed_bound_u32(tuple(shape), 32) >= 2**31:
        raise ValueError(f"shape {tuple(shape)}: the stream length must fit an int32")


def as_words(x: torch.Tensor) -> torch.Tensor:
    """The contiguous int32 word view of a float32/int32 tensor of 1-3 dims.
    fp64 raises NotImplementedError naming the ROADMAP item."""
    if x.dtype in (torch.float64, torch.int64, torch.uint64):
        raise NotImplementedError(f"dtype {x.dtype}: {_FP64_TODO}")
    if x.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"compress takes float32 or int32 word tensors, got {x.dtype}")
    _check_shape(x.shape)
    return x.contiguous().view(torch.int32)


def output_dtype(shape, dtype) -> torch.dtype:
    """Check a decode request; return the tensor dtype to view the words as
    (float32 for float32, int32 for 32-bit word types)."""
    name = str(dtype)[len("torch."):] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    if name in ("float64", "int64", "uint64"):
        raise NotImplementedError(f"dtype {name}: {_FP64_TODO}")
    if name not in ("float32", "int32", "uint32"):
        raise ValueError(f"decompress gives float32 or 32-bit words, not {name}")
    _check_shape(shape)
    return torch.float32 if name == "float32" else torch.int32


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
    """Forward transform of (nb, 4096) int32 blocks: rotate-left-1, first
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
        x = torch.cumsum(x, dim=axis + 1, dtype=torch.int32)
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


def border_offsets(shape, device=None) -> torch.Tensor:
    """Linear offset (int64) of border element ``i`` in stream order, for
    every ``i``: the mapping the CUDA kernels compute per element.

    On the 3-axis view ``e`` of the shape with covered extents ``b``, the
    border is, for each leading index ``p < b0``, first ``words[p, :b1, b2:]``
    then ``words[p, b1:, :]``, and after all of them ``words[b0:]``
    (``format.border_slices``). An axis shorter than its side makes the whole
    array border."""
    shape = tuple(shape)
    i = torch.arange(fmt.border_element_count(shape), dtype=torch.int64, device=device)
    if any(s < fmt.SIDE_LENGTH[len(shape)] for s in shape):
        return i
    (_, e1, e2), (b0, b1, b2) = _box(shape)
    r2 = e2 - b2
    per_p = b1 * r2 + (e1 - b1) * e2          # border elements of each p < b0
    p, j = i // max(per_p, 1), i % max(per_p, 1)
    q, k = j // max(r2, 1), j % max(r2, 1)
    # words[p, :b1, b2:] (q, k) first, then words[p, b1:, :]
    lead = p * (e1 * e2) + torch.where(j < b1 * r2, q * e2 + b2 + k, b1 * e2 + (j - b1 * r2))
    return torch.where(i < b0 * per_p, lead, b0 * e1 * e2 + (i - b0 * per_p))


def border_take(words: torch.Tensor, shape) -> torch.Tensor:
    """The border of ``words`` (of ``shape``) in stream order, as at most
    three box slices (``codec_pallas._border_take``)."""
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


def _bit_weights(device) -> torch.Tensor:
    """Word i of a chunk -> head bit (31 - i), as int32 (bit 31 is -2**31)."""
    return torch.ones(32, dtype=torch.int32, device=device) << (
        31 - torch.arange(32, dtype=torch.int32, device=device))


def encode_blocks_ref(blocks: torch.Tensor, dims: int = 1):
    """Encode (nb, 4096) int32 blocks of a ``dims``-dimensional grid.

    Returns ``(header, body, lengths)``: ``header`` (nb,) int32 offset-after
    entries, ``body`` the blocks' compressed words back to back (what the
    stream holds from word ``nb`` on), ``lengths`` (nb,) int64 words per
    block."""
    nb = blocks.shape[0]
    t = bitops.transpose_bits(block_transform(blocks, dims).reshape(nb, HEADS, 32))
    nz = t != 0
    # distinct powers of two sum to their OR: head bit (31-i) <=> word i != 0
    heads = (nz.to(torch.int32) * _bit_weights(blocks.device)).sum(-1, dtype=torch.int32)
    dense = torch.cat([heads, t.reshape(nb, HC)], dim=1)
    valid = torch.cat([torch.ones_like(heads, dtype=torch.bool), nz.reshape(nb, HC)], dim=1)
    lengths = valid.sum(dim=1)
    header = torch.cumsum(lengths, 0).to(torch.int32)
    return header, dense[valid], lengths


def decode_blocks_ref(stream: torch.Tensor, num_hc: int, dims: int = 1) -> torch.Tensor:
    """Decode the ``num_hc`` blocks of an int32 stream (header from word 0)
    of a ``dims``-dimensional grid into (num_hc, 4096) int32 words. Reads
    only the words each block owns, so whatever lies past the stream's
    length does not matter."""
    if stream.numel() < num_hc:
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {num_hc}-entry header")
    dev = stream.device
    last = stream.numel() - 1
    offsets = stream[:num_hc].to(torch.int64)
    starts = num_hc + torch.cat([offsets.new_zeros(1), offsets[:-1]])            # (nb,)
    heads = stream[(starts[:, None] + torch.arange(HEADS, device=dev)).clamp_(0, last)]
    shifts = 31 - torch.arange(32, dtype=torch.int32, device=dev)
    present = (heads[:, :, None] >> shifts) & 1                                 # (nb, 128, 32)
    rank = torch.cumsum(present, dim=2, dtype=torch.int32) - present
    counts = present.sum(dim=2, dtype=torch.int32)
    chunk_start = HEADS + torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    src = starts[:, None, None] + (chunk_start[:, :, None] + rank)
    words = torch.where(present != 0, stream[src.clamp_(0, last)], 0)
    blocks = bitops.transpose_bits(words).reshape(num_hc, HC)
    return inverse_block_transform(blocks, dims)


# ------------------------------------------------------------ codec


def encode(words: torch.Tensor, shape=None):
    """Compress int32 words of ``shape`` (default: their own shape, 1-3
    dims). Returns ``(stream, length)``: an int32 stream of
    ``format.compressed_bound_u32(shape, 32)`` words, zero past ``length``,
    and ``length`` as an int32 scalar tensor on the same device."""
    shape = tuple(words.shape if shape is None else shape)
    num_hc = fmt.num_hypercubes(shape)
    parts = []
    if num_hc:
        header, body, _ = encode_blocks_ref(gather_blocks(words, shape), len(shape))
        parts += [header, body]
    parts.append(border_take(words, shape))
    flat = torch.cat(parts)
    stream = torch.zeros(fmt.compressed_bound_u32(shape, 32), dtype=torch.int32, device=words.device)
    stream[: flat.numel()] = flat
    return stream, torch.tensor(flat.numel(), dtype=torch.int32, device=words.device)


def decode(stream: torch.Tensor, shape) -> torch.Tensor:
    """Decompress an int32 stream into int32 words of ``shape`` (1-3 dims)."""
    shape = tuple(shape)
    num_hc = fmt.num_hypercubes(shape)
    out = torch.empty(shape, dtype=torch.int32, device=stream.device)
    border_start = torch.zeros((), dtype=torch.int64, device=stream.device)
    if num_hc:
        scatter_blocks(decode_blocks_ref(stream, num_hc, len(shape)), shape, out)
        border_start = num_hc + stream[num_hc - 1].to(torch.int64)
    border = fmt.border_element_count(shape)
    if border:
        border_place(out, stream[border_start + torch.arange(border, device=stream.device)], shape)
    return out
