"""The benchmark's yardstick for a call's least time on the card: the bytes
the ndzip format makes a call move, and the card's peak bandwidth.

Both are fixed here, under the benchmark, so that a change to the program
cannot move its own roofline.
"""

from __future__ import annotations

#: peak device-memory bandwidth in bytes/s by ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheets; the SXM part at its full 700 W power limit)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def codec_bytes(elements: int, word_bytes: int, length_u32: int) -> int:
    """Bytes that one compress or one decompress call of the ndzip format
    has to move at the least: the field's ``elements`` words of
    ``word_bytes`` read once (compress) or written once (decompress), and
    the stream's ``length_u32`` u32 words written once (compress) or read
    once (decompress).

    The count depends on the format alone (the field's shape and dtype and
    the stream's length, which the format fixes for given data), never on
    what the implementation reads again, so it reads the same for the same
    stream whatever produced it."""
    if elements < 0 or word_bytes not in (4, 8) or length_u32 < 0:
        raise ValueError(f"bad call: {elements} elements of {word_bytes} B, a stream of {length_u32} words")
    return elements * word_bytes + 4 * length_u32


def peak_bytes_per_s(kind: str) -> float | None:
    """The card's peak bandwidth, or None for a card the table lacks (its
    rooflines are then not read)."""
    return PEAK_BYTES_PER_S.get(kind)
