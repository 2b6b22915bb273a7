"""Vectorized numpy reference implementation of the ndzip codec.

The port's own copy of ``ndzip_tpu/golden.py``, with the numpy half of
``ndzip_tpu/ops/bitops.py`` that it uses: simple, fully deterministic, and
matching the reference serial CPU codec byte-for-byte
(src/ndzip/cpu_codec.inl:580-659).  It is the ``golden`` backend of ``api``
and ``cli``; ``tests/test_torch_format.py`` holds its streams to the JAX
package's byte for byte.

Streams are represented as little-endian ``np.uint32`` arrays regardless of
data type; for float64 each 64-bit stream word occupies two consecutive
uint32s (lo, hi) exactly as in the on-disk byte layout.
"""

from __future__ import annotations

import numpy as np

from . import format as fmt


def _rotate_left_1(x: np.ndarray) -> np.ndarray:
    """(v << 1) | (v >> (bits-1)), common.hh:436-439."""
    bits = x.dtype.itemsize * 8
    return (x << x.dtype.type(1)) | (x >> x.dtype.type(bits - 1))


def _rotate_right_1(x: np.ndarray) -> np.ndarray:
    """common.hh:441-444."""
    bits = x.dtype.itemsize * 8
    return (x >> x.dtype.type(1)) | (x << x.dtype.type(bits - 1))


def _complement_negative(x: np.ndarray) -> np.ndarray:
    """If the sign bit is set, flip all non-sign bits (common.hh:446-449).
    An involution."""
    bits = x.dtype.itemsize * 8
    sign = (x >> x.dtype.type(bits - 1)) != 0
    return np.where(sign, x ^ x.dtype.type((1 << (bits - 1)) - 1), x)


def _transpose_masks(bits: int) -> list[tuple[int, int]]:
    """(j, mask) pairs of the butterfly transpose network, j descending."""
    out = []
    j = bits // 2
    m = (1 << (bits // 2)) - 1
    while j:
        out.append((j, m))
        j >>= 1
        if j:
            m = m ^ ((m << j) & ((1 << bits) - 1))
    return out


def transpose_bits(chunks: np.ndarray) -> np.ndarray:
    """Bit-matrix transpose of each chunk.

    ``chunks`` has shape (..., W) where W = word bits (32 or 64) and dtype
    uint{W}.  Word j of a chunk is row j of a WxW bit matrix in MSB-first
    column order; the result is the transposed matrix in the same
    convention:  out[..., i] bit (W-1-j)  ==  in[..., j] bit (W-1-i).
    Matches transpose_bits_trivial (cpu_codec.inl:355-363) bit-for-bit and
    is an involution.
    """
    bits = chunks.dtype.itemsize * 8
    if chunks.shape[-1] != bits:
        raise ValueError(f"chunks of {bits}-bit words must hold {bits} words, got {chunks.shape}")
    lead = chunks.shape[:-1]
    a = chunks
    for j, m in _transpose_masks(bits):
        a = a.reshape(lead + (bits // (2 * j), 2, j))
        upper = a[..., 0, :]
        lower = a[..., 1, :]
        jj, mm = chunks.dtype.type(j), chunks.dtype.type(m)
        t = (upper ^ (lower >> jj)) & mm
        a = np.stack([upper ^ t, lower ^ (t << jj)], axis=-2)
    return a.reshape(lead + (bits,))


def _as_words(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32:
        return data.view(np.uint32)
    if data.dtype == np.float64:
        return data.view(np.uint64)
    if data.dtype in (np.uint32, np.uint64):
        return data
    raise ValueError(f"unsupported dtype {data.dtype}")


def gather_blocks(words: np.ndarray) -> np.ndarray:
    """Extract all whole hypercubes as a (num_blocks, 4096) array in
    canonical block order (for_each_hypercube, common.hh:428-433; row-major
    element order within each block as load_hypercube, cpu_codec.inl:74-86).
    """
    shape = words.shape
    dims = len(shape)
    side = fmt.SIDE_LENGTH[dims]
    grid = fmt.grid_shape(shape)
    interior = words[tuple(slice(0, g * side) for g in grid)]
    # (g0, s0, g1, s1, ...) -> (g0, g1, ..., s0, s1, ...)
    split_shape = tuple(x for g in grid for x in (g, side))
    arr = interior.reshape(split_shape)
    perm = tuple(range(0, 2 * dims, 2)) + tuple(range(1, 2 * dims, 2))
    arr = arr.transpose(perm)
    nb = int(np.prod(grid)) if dims else 0
    return np.ascontiguousarray(arr).reshape(nb, fmt.HC_SIZE)


def scatter_blocks(blocks: np.ndarray, shape: tuple[int, ...], dtype) -> np.ndarray:
    """Inverse of gather_blocks; returns a words array with border elements
    left zero (filled by the caller)."""
    dims = len(shape)
    side = fmt.SIDE_LENGTH[dims]
    grid = fmt.grid_shape(shape)
    out = np.zeros(shape, dtype=dtype)
    if blocks.shape[0]:
        arr = blocks.reshape(grid + (side,) * dims)
        inv_perm = []
        for d in range(dims):
            inv_perm += [d, dims + d]
        arr = arr.transpose(inv_perm).reshape(tuple(g * side for g in grid))
        out[tuple(slice(0, g * side) for g in grid)] = arr
    return out


def block_transform(blocks: np.ndarray, dims: int) -> np.ndarray:
    """Forward integer transform, vectorized over blocks (common.hh:469-501).
    ``blocks``: (nb, 4096) uint array."""
    side = fmt.SIDE_LENGTH[dims]
    x = _rotate_left_1(blocks)
    x = x.reshape((-1,) + (side,) * dims)
    for axis in fmt.FORWARD_AXIS_ORDER[dims]:
        ax = axis + 1  # block batch axis in front
        d = x.copy()
        sl_hi = [slice(None)] * x.ndim
        sl_lo = [slice(None)] * x.ndim
        sl_hi[ax] = slice(1, None)
        sl_lo[ax] = slice(0, -1)
        d[tuple(sl_hi)] = x[tuple(sl_hi)] - x[tuple(sl_lo)]
        x = d
    x = x.reshape(-1, fmt.HC_SIZE)
    return _complement_negative(x)


def inverse_block_transform(blocks: np.ndarray, dims: int) -> np.ndarray:
    """common.hh:503-535: complement -> per-axis prefix sums in reverse axis
    order -> rotate right."""
    side = fmt.SIDE_LENGTH[dims]
    x = _complement_negative(blocks)
    x = x.reshape((-1,) + (side,) * dims)
    for axis in reversed(fmt.FORWARD_AXIS_ORDER[dims]):
        ax = axis + 1
        # wrapping cumulative sum in the word dtype
        x = np.cumsum(x, axis=ax, dtype=x.dtype)
    x = x.reshape(-1, fmt.HC_SIZE)
    return _rotate_right_1(x)


def encode_blocks_dense(blocks: np.ndarray, dims: int):
    """Transform + chunk + bit-transpose all blocks; return the dense
    (pre-compaction) representation.

    Returns (dense, valid, lengths):
      dense:   (nb, heads + 4096) words — per block the head words followed
               by every bit-transposed word (zeros included),
      valid:   same shape bool — True where the word appears in the stream,
      lengths: (nb,) int64 — compressed length of each block in words.
    """
    wb = blocks.dtype.itemsize * 8
    heads_n = fmt.HC_SIZE // wb
    t = block_transform(blocks, dims)
    chunks = t.reshape(-1, heads_n, wb)
    heads = np.bitwise_or.reduce(chunks, axis=2)
    transposed = transpose_bits(chunks)
    body = transposed.reshape(-1, fmt.HC_SIZE)
    dense = np.concatenate([heads, body], axis=1)
    valid = np.concatenate(
        [np.ones_like(heads, dtype=bool), body != 0], axis=1
    )
    lengths = valid.sum(axis=1, dtype=np.int64)
    return dense, valid, lengths


def decode_blocks_dense(dense: np.ndarray, dims: int) -> np.ndarray:
    """Inverse of encode_blocks_dense given re-expanded dense words."""
    wb = dense.dtype.itemsize * 8
    heads_n = fmt.HC_SIZE // wb
    body = dense[:, heads_n:]
    chunks = transpose_bits(body.reshape(-1, heads_n, wb))
    return inverse_block_transform(chunks.reshape(-1, fmt.HC_SIZE), dims)


def _words_to_u32(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint32:
        return arr
    return arr.view(np.uint32) if arr.flags.c_contiguous else np.ascontiguousarray(arr).view(np.uint32)


def compress(data: np.ndarray) -> tuple[np.ndarray, int]:
    """Compress a 1-3D float32/float64 array.

    Returns (stream, length_words) where ``stream`` is a uint32 array holding
    exactly the compressed bytes and ``length_words`` is the stream length in
    words of the profile's word type (reference return-value semantics,
    cpu_codec.inl:598-619).
    """
    fmt.validate_shape(data.shape)
    words = _as_words(np.ascontiguousarray(data))
    dims = words.ndim
    wb = words.dtype.itemsize * 8
    num_hc = fmt.num_hypercubes(words.shape)

    parts: list[np.ndarray] = []
    if num_hc:
        blocks = gather_blocks(words)
        dense, valid, lengths = encode_blocks_dense(blocks, dims)
        offsets_after = np.cumsum(lengths).astype(np.uint32)
        header = np.zeros(fmt.header_u32_words(num_hc, wb), dtype=np.uint32)
        header[:num_hc] = offsets_after
        parts.append(header)
        parts.append(_words_to_u32(dense.reshape(-1)[valid.reshape(-1)]))

    flat = words.reshape(-1)
    for off, cnt in fmt.border_slices(words.shape):
        parts.append(_words_to_u32(np.ascontiguousarray(flat[off : off + cnt])))

    stream = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint32)
    length_words = stream.size * 4 // (wb // 8)
    return stream, length_words


def decompress(stream: np.ndarray, shape: tuple[int, ...], dtype) -> np.ndarray:
    """Decompress ``stream`` (uint32 array) into an array of ``shape``."""
    fmt.validate_shape(shape)
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    word_dt = np.uint32 if wb == 32 else np.uint64
    dims = len(shape)
    num_hc = fmt.num_hypercubes(shape)
    heads_n = fmt.HC_SIZE // wb

    pos_u32 = fmt.header_u32_words(num_hc, wb)
    if num_hc:
        offsets_after = stream[:num_hc].astype(np.int64)
        starts = np.concatenate([[0], offsets_after[:-1]])
        body_words = stream[pos_u32:].view(np.uint32)
        if wb == 64:
            usable = body_words.size // 2 * 2
            body = np.ascontiguousarray(body_words[:usable]).view(np.uint64)
        else:
            body = body_words

        bound = heads_n + fmt.HC_SIZE
        # fixed-size window gather per block (clamped), mirrors random access
        # through the offset table (cuda_codec.inl:279-297)
        idx = starts[:, None] + np.arange(bound)[None, :]
        idx = np.minimum(idx, max(body.size - 1, 0))
        if body.size == 0:
            windows = np.zeros((num_hc, bound), dtype=word_dt)
        else:
            windows = body[idx]

        heads = windows[:, :heads_n]
        shifts = np.arange(wb - 1, -1, -1, dtype=word_dt)[None, None, :]
        present = ((heads[:, :, None] >> shifts) & word_dt(1)).astype(bool)
        # source rank of word i within its chunk = #present words before it
        rank = np.cumsum(present, axis=2) - present
        chunk_counts = present.sum(axis=2)
        chunk_starts = heads_n + np.cumsum(chunk_counts, axis=1) - chunk_counts
        src = chunk_starts[:, :, None] + rank
        src = np.minimum(src, bound - 1)
        transposed = np.where(present, np.take_along_axis(windows, src.reshape(num_hc, -1), axis=1).reshape(num_hc, heads_n, wb), word_dt(0))

        chunks = transpose_bits(transposed)
        blocks = inverse_block_transform(chunks.reshape(num_hc, fmt.HC_SIZE), dims)
        words = scatter_blocks(blocks, shape, word_dt)

        border_start_u32 = pos_u32 + int(offsets_after[-1]) * (wb // 32)
    else:
        words = np.zeros(shape, dtype=word_dt)
        border_start_u32 = pos_u32

    flat = words.reshape(-1)
    bpos = border_start_u32
    for off, cnt in fmt.border_slices(shape):
        chunk = stream[bpos : bpos + cnt * (wb // 32)]
        flat[off : off + cnt] = np.ascontiguousarray(chunk).view(word_dt)
        bpos += cnt * (wb // 32)

    return flat.reshape(shape).view(dtype)


def compressed_length_words(stream_u32_len: int, wb: int) -> int:
    return stream_u32_len * 4 // (wb // 8)
