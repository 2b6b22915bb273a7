"""The device codec on CUDA, for fp32 and fp64 grids of 1-3 dims:
hand-written kernels and their glue.

The counterpart of ``ndzip_tpu/codec_pallas.py``. fp32:

* ``_encode_blocks_fp32`` launches the 1D encoder of ``csrc/encode_fp32.cu``
  (the TPU kernel ``_encode_kernel_fp32``, flat mode);
* ``_decode_blocks_fp32`` launches the 1D decoder of ``csrc/decode_fp32.cu``
  (the TPU kernel ``_decode_kernel_fp32``, flat mode);
* ``_encode_interior_fp32`` launches the 2D/3D encoder of
  ``csrc/encode_fp32_nd.cu`` (``_encode_kernel_fp32`` in tile modes, which
  ``codec_pallas._encode_interior_fp32`` launches);
* ``_decode_interior_fp32`` launches the 2D/3D decoder of
  ``csrc/decode_fp32_nd.cu`` (``_decode_kernel_fp32`` in tile modes);
* ``_encode_fp32_device``/``_decode_fp32_device`` are the glue.

fp64, on native 64-bit words (the TPU kernels' (lo, hi) u32 planes do not
carry over):

* ``_encode_blocks_fp64`` launches ``csrc/encode_fp64.cu``
  (``_encode_kernel_fp64`` flat, which ``codec_pallas._encode_blocks_fp64``
  launches);
* ``_decode_blocks_fp64`` launches ``csrc/decode_fp64.cu``
  (``_decode_kernel_fp64`` flat);
* ``_encode_interior_fp64`` launches ``csrc/encode_fp64_nd.cu``
  (``_encode_kernel_fp64`` in tile modes);
* ``_decode_interior_fp64`` launches ``csrc/decode_fp64_nd.cu``
  (``_decode_kernel_fp64`` in tile modes);
* ``_encode_fp64_device``/``_decode_fp64_device`` are the glue.

``compress_device``/``decompress_device`` are the API of both.

Only CUDA tensors are taken here: nothing falls back to the plain versions
of ``codec_torch``, and a failed build or launch raises. ``LAUNCHES`` counts
the launches of each wrapper, so a run can show that it went through the
kernels.

Spans (``utils.trace``, recorded only while a ``torch.profiler`` records or
under ``NDZIP_TORCH_VERBOSE``): ``ndzip.compress_device`` and
``ndzip.decompress_device`` around the whole of each API call (checks,
allocations, the path's choice and its launch), and ``ndzip.launch`` inside
it around each kernel's launch (the device guard, the current stream and the
ctypes call with the memset and the kernel launch it makes). A call's glue
is its span less its ``ndzip.launch`` children.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import format as fmt
from . import utils
from .codec_torch import HC, as_words, output_dtype

#: launches of each kernel wrapper since the count was last set to 0
LAUNCHES = {"encode": 0, "decode": 0, "encode_nd": 0, "decode_nd": 0,
            "encode64": 0, "decode64": 0, "encode64_nd": 0, "decode64_nd": 0}


def _check_cuda_words(name: str, t: torch.Tensor, dims=(1,), dtype=torch.int32):
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} words, got {t.dtype}")
    if t.dim() not in dims or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous with {' or '.join(map(str, dims))} dims, "
                         f"got shape {tuple(t.shape)}")


def _launch(fn, t: torch.Tensor, *args):
    """Launch on ``t``'s device and that device's current stream; the host
    thread's current device is restored afterwards."""
    with utils.trace("ndzip.launch"), torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")


def _extents(shape) -> list[int]:
    """A 2D/3D shape padded in front with 1s to three axes, as the nd kernels take it."""
    return [1] * (3 - len(shape)) + list(shape)


def _encode_blocks_fp32(words: torch.Tensor):
    """Encode (n,) int32 words, n >= 4096, 16-byte aligned, on the card.
    Returns ``(stream, length)``: the int32 stream in a buffer of the
    compressed bound (words past ``length`` are undefined) and the int32
    length as a device scalar. No host sync."""
    _check_cuda_words("words", words)
    n = words.numel()
    num_hc = n // HC
    if num_hc == 0:
        raise ValueError(f"the encode kernel needs at least one {HC}-word block, got {n} words")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    lib = _build.load()
    stream = torch.empty(fmt.compressed_bound_u32((n,), 32), dtype=torch.int32, device=words.device)
    # the look-back's status words and ticket: this call's own, cleared by the launch
    status = torch.empty(num_hc + 1, dtype=torch.int64, device=words.device)
    length = torch.empty((), dtype=torch.int32, device=words.device)
    _launch(lib.ndzip_encode_fp32, words, words.data_ptr(), num_hc, n - num_hc * HC,
            stream.data_ptr(), status.data_ptr(), length.data_ptr())
    LAUNCHES["encode"] += 1
    return stream, length


def _decode_blocks_fp32(stream: torch.Tensor, n: int) -> torch.Tensor:
    """Decode an int32 stream (header from word 0) into (n,) int32 words on
    the card, n >= 4096. Reads only the words each block owns, so the stream
    needs no padding, may start at any word of its storage (a slice), and
    what lies past its length does not matter."""
    _check_cuda_words("stream", stream)
    num_hc = n // HC
    if num_hc == 0:
        raise ValueError(f"the decode kernel needs at least one {HC}-word block, got n={n}")
    if stream.numel() < num_hc:
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {num_hc}-entry header")
    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=stream.device)
    _launch(lib.ndzip_decode_fp32, stream, stream.data_ptr(), stream.numel(), num_hc,
            n - num_hc * HC, out.data_ptr())
    LAUNCHES["decode"] += 1
    return out


def _encode_interior_fp32(words: torch.Tensor):
    """Encode a 2D/3D grid of int32 words with at least one whole block on
    the card, in one launch that reads the grid once: blocks read straight
    from the grid, border copied after them. Returns ``(stream, length)`` as
    ``_encode_blocks_fp32``. No host sync."""
    _check_cuda_words("words", words, dims=(2, 3))
    shape = tuple(words.shape)
    num_hc = fmt.num_hypercubes(shape)
    if num_hc == 0:
        raise ValueError(f"shape {shape} has no whole block: it is all border")
    lib = _build.load()
    stream = torch.empty(fmt.compressed_bound_u32(shape, 32), dtype=torch.int32, device=words.device)
    # the look-back's status words and ticket: this call's own, cleared by the launch
    status = torch.empty(num_hc + 1, dtype=torch.int64, device=words.device)
    length = torch.empty((), dtype=torch.int32, device=words.device)
    _launch(lib.ndzip_encode_fp32_nd, words, words.data_ptr(), len(shape), *_extents(shape),
            stream.data_ptr(), status.data_ptr(), length.data_ptr())
    LAUNCHES["encode_nd"] += 1
    return stream, length


def _decode_interior_fp32(stream: torch.Tensor, shape) -> torch.Tensor:
    """Decode an int32 stream into int32 words of a 2D/3D ``shape`` with at
    least one whole block on the card: blocks stored straight into the grid,
    border placed from the stream. Reads only the words each block owns, so
    the stream needs no padding, may start at any word of its storage (a
    slice), and what lies past its length does not matter, as for
    ``_decode_blocks_fp32``."""
    _check_cuda_words("stream", stream)
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"the nd decode kernel takes 2D/3D shapes, got {shape}")
    num_hc = fmt.num_hypercubes(shape)
    if num_hc == 0:
        raise ValueError(f"shape {shape} has no whole block: it is all border")
    if stream.numel() < num_hc:
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {num_hc}-entry header")
    lib = _build.load()
    out = torch.empty(shape, dtype=torch.int32, device=stream.device)
    _launch(lib.ndzip_decode_fp32_nd, stream, stream.data_ptr(), stream.numel(), len(shape),
            *_extents(shape), out.data_ptr())
    LAUNCHES["decode_nd"] += 1
    return out


def _encode_fp32_device(words: torch.Tensor):
    """int32 CUDA words of 1-3 dims -> (stream, length) as in ``compress_device``."""
    shape = tuple(words.shape)
    if fmt.num_hypercubes(shape) == 0:  # all border: the stream is the words themselves
        n = words.numel()
        stream = torch.zeros(fmt.compressed_bound_u32(shape, 32), dtype=torch.int32, device=words.device)
        stream[:n] = words.reshape(-1)
        return stream, torch.full((), n, dtype=torch.int32, device=words.device)
    if len(shape) > 1:
        return _encode_interior_fp32(words)
    if words.data_ptr() % 16:
        words = words.clone()
    return _encode_blocks_fp32(words)


def _decode_fp32_device(stream: torch.Tensor, shape) -> torch.Tensor:
    """int32 CUDA stream -> int32 words of ``shape`` (1-3 dims)."""
    shape = tuple(shape)
    if fmt.num_hypercubes(shape) == 0:
        n = math.prod(shape)
        if stream.numel() < n:
            raise ValueError(f"stream of {stream.numel()} words is shorter than its {n} border words")
        return stream[:n].clone().reshape(shape)
    if len(shape) > 1:
        return _decode_interior_fp32(stream, shape)
    return _decode_blocks_fp32(stream, shape[0])


# ------------------------------------------------------------ fp64


def _check_stream64(stream: torch.Tensor, num_hc: int):
    """An fp64 stream: int32 words on the card, a whole number of u64 words,
    8-byte aligned, long enough for the header and its pad word."""
    _check_cuda_words("stream", stream)
    if stream.numel() % 2 or stream.data_ptr() % 8:
        raise ValueError("an fp64 stream holds whole u64 words: an even number of u32 words, "
                         "8-byte aligned")
    if stream.numel() < fmt.header_u32_words(num_hc, 64):
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {num_hc}-entry header")


def _encode_buffers(shape, num_hc: int, device):
    """The stream buffer of the fp64 compressed bound, the look-back's status
    words and ticket (this call's own, cleared by the launch) and the length
    scalar of an fp64 encode."""
    return (torch.empty(fmt.compressed_bound_u32(shape, 64), dtype=torch.int32, device=device),
            torch.empty(num_hc + 1, dtype=torch.int64, device=device),
            torch.empty((), dtype=torch.int32, device=device))


def _encode_blocks_fp64(words: torch.Tensor):
    """Encode (n,) int64 words, n >= 4096, 16-byte aligned, on the card.
    Returns ``(stream, length)``: the int32 stream in a buffer of the fp64
    compressed bound (words past ``length`` are undefined) and its length in
    u32 words as an int32 device scalar. No host sync."""
    _check_cuda_words("words", words, dtype=torch.int64)
    n = words.numel()
    num_hc = n // HC
    if num_hc == 0:
        raise ValueError(f"the encode kernel needs at least one {HC}-word block, got {n} words")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    lib = _build.load()
    stream, status, length = _encode_buffers((n,), num_hc, words.device)
    _launch(lib.ndzip_encode_fp64, words, words.data_ptr(), num_hc, n - num_hc * HC,
            stream.data_ptr(), status.data_ptr(), length.data_ptr())
    LAUNCHES["encode64"] += 1
    return stream, length


def _decode_blocks_fp64(stream: torch.Tensor, n: int) -> torch.Tensor:
    """Decode an int32 fp64 stream (header from word 0) into (n,) int64 words
    on the card, n >= 4096. Reads only the words each block owns, so the
    stream needs no padding, may start at any u64 word of its storage (a
    slice), and what lies past its length does not matter."""
    num_hc = n // HC
    if num_hc == 0:
        raise ValueError(f"the decode kernel needs at least one {HC}-word block, got n={n}")
    _check_stream64(stream, num_hc)
    lib = _build.load()
    out = torch.empty(n, dtype=torch.int64, device=stream.device)
    _launch(lib.ndzip_decode_fp64, stream, stream.data_ptr(), stream.numel(), num_hc,
            n - num_hc * HC, out.data_ptr())
    LAUNCHES["decode64"] += 1
    return out


def _encode_interior_fp64(words: torch.Tensor):
    """Encode a 2D/3D grid of int64 words with at least one whole block on
    the card, in one launch that reads the grid once: blocks read straight
    from the grid, border copied after them. Returns ``(stream, length)`` as
    ``_encode_blocks_fp64``. No host sync."""
    _check_cuda_words("words", words, dims=(2, 3), dtype=torch.int64)
    shape = tuple(words.shape)
    num_hc = fmt.num_hypercubes(shape)
    if num_hc == 0:
        raise ValueError(f"shape {shape} has no whole block: it is all border")
    lib = _build.load()
    stream, status, length = _encode_buffers(shape, num_hc, words.device)
    _launch(lib.ndzip_encode_fp64_nd, words, words.data_ptr(), len(shape), *_extents(shape),
            stream.data_ptr(), status.data_ptr(), length.data_ptr())
    LAUNCHES["encode64_nd"] += 1
    return stream, length


def _decode_interior_fp64(stream: torch.Tensor, shape) -> torch.Tensor:
    """Decode an int32 fp64 stream into int64 words of a 2D/3D ``shape``
    with at least one whole block on the card: blocks stored straight into
    the grid, border placed from the stream. Takes the stream as
    ``_decode_blocks_fp64`` does."""
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"the nd decode kernel takes 2D/3D shapes, got {shape}")
    num_hc = fmt.num_hypercubes(shape)
    if num_hc == 0:
        raise ValueError(f"shape {shape} has no whole block: it is all border")
    _check_stream64(stream, num_hc)
    lib = _build.load()
    out = torch.empty(shape, dtype=torch.int64, device=stream.device)
    _launch(lib.ndzip_decode_fp64_nd, stream, stream.data_ptr(), stream.numel(), len(shape),
            *_extents(shape), out.data_ptr())
    LAUNCHES["decode64_nd"] += 1
    return out


def _encode_fp64_device(words: torch.Tensor):
    """int64 CUDA words of 1-3 dims -> (stream, length) as in ``compress_device``."""
    shape = tuple(words.shape)
    if fmt.num_hypercubes(shape) == 0:  # all border: the stream is the words themselves
        n = words.numel()
        stream = torch.zeros(fmt.compressed_bound_u32(shape, 64), dtype=torch.int32, device=words.device)
        stream.view(torch.int64)[:n] = words.reshape(-1)
        return stream, torch.full((), 2 * n, dtype=torch.int32, device=words.device)
    if len(shape) > 1:
        return _encode_interior_fp64(words)
    if words.data_ptr() % 16:
        words = words.clone()
    return _encode_blocks_fp64(words)


def _decode_fp64_device(stream: torch.Tensor, shape) -> torch.Tensor:
    """int32 CUDA fp64 stream -> int64 words of ``shape`` (1-3 dims)."""
    shape = tuple(shape)
    if stream.data_ptr() % 8:  # a slice at an odd u32 offset: realign
        stream = stream.clone()
    if fmt.num_hypercubes(shape) == 0:
        n = math.prod(shape)
        if stream.numel() < 2 * n:
            raise ValueError(f"stream of {stream.numel()} u32 words is shorter than its {n} border words")
        return stream[: 2 * n].clone().view(torch.int64).reshape(shape)
    if len(shape) > 1:
        return _decode_interior_fp64(stream, shape)
    return _decode_blocks_fp64(stream, shape[0])


# ------------------------------------------------------------ device API


def compress_device(x: torch.Tensor):
    """Compress a float32/float64 (or int32/int64 word) CUDA tensor of 1-3
    dims on the card.

    Returns ``(stream, length)``: ``stream`` an int32 tensor of
    ``format.compressed_bound_u32(x.shape, W)`` words (W = 32 or 64),
    ``length`` its length in u32 words as an int32 device scalar, so the
    call makes no host sync. ``stream[:length]`` is byte for byte the stream
    of ``ndzip_tpu.golden.compress``. The length is an int32, so a grid
    whose compressed bound reaches 2**31 u32 words (just under 8 GiB) raises
    ``ValueError`` (``codec_torch.check_stream_length``)."""
    with utils.trace("ndzip.compress_device"):
        words = as_words(x)
        _check_cuda_words("x", words, dims=(1, 2, 3), dtype=words.dtype)
        if words.dtype == torch.int64:
            return _encode_fp64_device(words)
        return _encode_fp32_device(words)


def decompress_device(stream: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Decompress an int32 CUDA stream (``stream[:length]`` as it is, or the
    whole buffer) into a tensor of ``shape`` (1-3 dims): float32/float64 for
    those, int32/int64 for the word types."""
    with utils.trace("ndzip.decompress_device"):
        out_dtype = output_dtype(shape, dtype)
        _check_cuda_words("stream", stream)
        if out_dtype.itemsize == 8:
            return _decode_fp64_device(stream, shape).view(out_dtype)
        return _decode_fp32_device(stream, shape).view(out_dtype)
