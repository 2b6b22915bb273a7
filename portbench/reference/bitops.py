"""Word-level bit operations of the ndzip format on int32 and int64 tensors.

The benchmark's frozen copy of the port's ``ops/bitops.py``. PyTorch implements
neither shifts nor addition for ``torch.uint32``/``torch.uint64``, so every
32-bit word is held as its int32 view and every 64-bit word as its int64
view: ``<<``, ``^``, ``&``, ``+`` and ``-`` give the same bits as on the
unsigned type (two's complement wraps), and a logical right shift is an
arithmetic shift followed by a mask. The word width comes from the dtype.
"""

from __future__ import annotations

import torch

#: (shift, mask) rounds of the butterfly transpose per word width, shift
#: descending (the transpose networks of 32- and 64-bit words); every mask
#: has its top bit clear, so it fits the signed type.
_MASKS = {
    32: ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)),
    64: ((32, 0x00000000FFFFFFFF), (16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
         (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333), (1, 0x5555555555555555)),
}
_WIDTHS = {torch.int32: 32, torch.int64: 64}


def word_bits(x: torch.Tensor) -> int:
    """32 for int32 words, 64 for int64 words."""
    if x.dtype not in _WIDTHS:
        raise TypeError(f"words are held as int32 or int64, got {x.dtype}")
    return _WIDTHS[x.dtype]


def logical_shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x >> k`` on the unsigned bits of an int32/int64 tensor, 0 <= k < width."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (word_bits(x) - k)) - 1)


def rotate_left_1(x: torch.Tensor) -> torch.Tensor:
    """(v << 1) | (v >> (width - 1)) on unsigned bits."""
    return (x << 1) | logical_shift_right(x, word_bits(x) - 1)


def rotate_right_1(x: torch.Tensor) -> torch.Tensor:
    """(v >> 1) | (v << (width - 1)) on unsigned bits."""
    return logical_shift_right(x, 1) | (x << (word_bits(x) - 1))


def complement_negative(x: torch.Tensor) -> torch.Tensor:
    """If the sign bit is set, flip all other bits. An involution."""
    return torch.where(x < 0, x ^ ((1 << (word_bits(x) - 1)) - 1), x)


def transpose_bits(chunks: torch.Tensor) -> torch.Tensor:
    """Bit-matrix transpose of each chunk of an int32 (..., 32) or int64
    (..., 64) tensor: ``out[..., i]`` bit (W-1-j) == ``in[..., j]`` bit
    (W-1-i), W the word width. An involution."""
    bits = word_bits(chunks)
    if chunks.shape[-1] != bits:
        raise ValueError(f"chunks of {chunks.dtype} words must end in an axis of {bits}, "
                         f"got {tuple(chunks.shape)}")
    lead = chunks.shape[:-1]
    a = chunks
    for j, m in _MASKS[bits]:
        a = a.reshape(lead + (bits // (2 * j), 2, j))
        upper, lower = a[..., 0, :], a[..., 1, :]
        t = (upper ^ logical_shift_right(lower, j)) & m
        a = torch.stack([upper ^ t, lower ^ (t << j)], dim=-2)
    return a.reshape(lead + (bits,))
