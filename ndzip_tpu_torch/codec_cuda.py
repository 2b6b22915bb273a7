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
  ``csrc/decode_fp32_nd.cu`` (``_decode_kernel_fp32`` in tile modes).

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
  (``_decode_kernel_fp64`` in tile modes).

``compress_device``/``decompress_device`` are the API of both: they choose
the path (all border, 1D or 2D/3D) and launch it as the wrappers do.

A launch plan (``_plan``) holds what a call needs beyond its tensors, worked
out once for each (operation, shape, word dtype, card): the shape's checks
(``codec_torch.check_stream_length``: 1-3 dims, no negative extent, a
compressed bound under 2**31 u32 words), the block count, the compressed
bound, the header's size, the path, the kernel's C entry point and its
integer arguments. A refused shape raises again on every call, as
``functools.lru_cache`` keeps no exception. Every call still checks its
tensors: on a CUDA device (the first refusal of a wrapper, so a host tensor
builds no plan), their dtype, dims and contiguity, an input's 16-byte
alignment on the 1D path, a stream's length against its header and an fp64
stream's u64 alignment. ``plans()`` reads the cache's hits and misses.

A call allocates its stream and one scratch buffer, which holds the
encoder's look-back status words and ticket and, after them, the length
that is returned as a 0-dim int32 view. It launches on the raw handle of
its card's current stream, and enters a device guard only where the host
thread's current device is another card.

Only CUDA tensors are taken here: nothing falls back to the plain versions
of ``codec_torch``, and a failed build or launch raises. ``LAUNCHES`` counts
the launches of each wrapper, so a run can show that it went through the
kernels. ``COPIES`` counts the copies the API makes of a caller's tensor
before a launch: a non-contiguous input made contiguous, a 1D input at a
16-byte misalignment cloned, an fp64 stream at an odd u32 offset realigned.

Spans (``utils.trace``, recorded only while a ``torch.profiler`` records or
under ``NDZIP_TORCH_VERBOSE``): ``ndzip.compress_device`` and
``ndzip.decompress_device`` around the whole of each API call (checks, the
plan's lookup, allocations and the launch), and ``ndzip.launch`` inside it
around each kernel's launch (the current device's check, the stream's
handle and the ctypes call with the memset and the kernel launch it makes),
and ``ndzip.copy_in`` around each copy that ``COPIES`` counts. A call's glue
is its span less its ``ndzip.launch`` children.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import NamedTuple

import torch

from . import _build
from . import format as fmt
from . import utils
from .codec_torch import _WORDS, HC, as_words, check_stream_length, output_dtype

#: launches of each kernel wrapper since the count was last set to 0
LAUNCHES = {"encode": 0, "decode": 0, "encode_nd": 0, "decode_nd": 0,
            "encode64": 0, "decode64": 0, "encode64_nd": 0, "decode64_nd": 0}
#: copies of a caller's tensor made before a launch, by cause, since the count was last set to 0
COPIES = {"realign64": 0, "align1d": 0, "contiguous": 0}

#: the torch dtypes ``decompress_device`` gives as they are named; others are parsed
_OUT_DTYPES = {d: d for d in (torch.float32, torch.int32, torch.float64, torch.int64)}


def _check_cuda_words(name: str, t: torch.Tensor, dims=(1,), dtype=torch.int32):
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} words, got {t.dtype}")
    if t.dim() not in dims or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous with {' or '.join(map(str, dims))} dims, "
                         f"got shape {tuple(t.shape)}")


@functools.cache
def _current_raw_stream():
    """``torch._C._cuda_getCurrentRawStream``: a card's index -> the raw
    handle of its current stream, the call torch's generated code makes.
    Looked up on the first launch: CPU builds of torch lack it."""
    return torch._C._cuda_getCurrentRawStream


def _launch(fn, index: int, *args):
    """Launch ``fn`` on the current stream of card ``index``; a host thread
    whose current device is another card gets it back afterwards."""
    with utils.trace("ndzip.launch"):
        if torch.cuda.current_device() == index:
            err = fn(*args, _current_raw_stream()(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, _current_raw_stream()(index))
    if err:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")


def _extents(shape) -> list[int]:
    """A 2D/3D shape padded in front with 1s to three axes, as the nd kernels take it."""
    return [1] * (3 - len(shape)) + list(shape)


class _Plan(NamedTuple):
    """What a call of one (operation, shape, word dtype, card) needs beyond its tensors."""
    path: str             # "border" (no kernel: the stream is the words), "1d" or "nd"
    shape: tuple
    n: int                # elements
    num_hc: int
    bound: int            # the compressed bound in u32 words
    header: int           # the header in u32 words, with the fp64 pad word
    words: torch.dtype    # int32 or int64
    index: int            # the card
    device: torch.device
    fn: object            # the C entry point, None on the border path
    args: tuple           # its integer arguments after the words (encode) or the stream's size (decode)
    counter: str          # its key in LAUNCHES


@functools.lru_cache(maxsize=256)
def _plan(op: str, shape: tuple, words: torch.dtype, index: int) -> _Plan:
    """The launch plan of ``op`` ("encode" or "decode") for a grid of
    ``shape`` and word dtype ``words`` on card ``index``; raises, uncached,
    for a shape the codec cannot take."""
    shape = tuple(map(operator.index, shape))
    bits = words.itemsize * 8
    check_stream_length(shape, bits)
    num_hc, n = fmt.num_hypercubes(shape), math.prod(shape)
    path = "border" if num_hc == 0 else "nd" if len(shape) > 1 else "1d"
    fn, args, counter = None, (), ""
    if path != "border":
        nd = "_nd" if path == "nd" else ""
        fn = getattr(_build.load(), f"ndzip_{op}_fp{bits}{nd}")
        args = (len(shape), *_extents(shape)) if nd else (num_hc, n - num_hc * HC)
        counter = op + ("64" if bits == 64 else "") + nd
    return _Plan(path, shape, n, num_hc, fmt.compressed_bound_u32(shape, bits),
                 fmt.header_u32_words(num_hc, bits), words, index, torch.device("cuda", index),
                 fn, args, counter)


def plans():
    """The launch plans' cache: ``hits``, ``misses`` (a refused shape counts
    one each time), ``maxsize`` and ``currsize``."""
    return _plan.cache_info()


def _kernel_plan(op: str, shape: tuple, words: torch.dtype, index: int) -> _Plan:
    """``_plan`` for a kernel's wrapper: a shape with no whole block is refused."""
    plan = _plan(op, shape, words, index)
    if plan.path != "border":
        return plan
    if len(shape) > 1:
        raise ValueError(f"shape {plan.shape} has no whole block: it is all border")
    raise ValueError(f"the {op} kernel needs at least one {HC}-word block, got "
                     + (f"{plan.n} words" if op == "encode" else f"n={plan.n}"))


def _check_stream(plan: _Plan, stream: torch.Tensor):
    """A stream long enough for ``plan``'s header; an fp64 one holds whole
    u64 words, 8-byte aligned."""
    if plan.words == torch.int64 and (stream.numel() % 2 or stream.data_ptr() % 8):
        raise ValueError("an fp64 stream holds whole u64 words: an even number of u32 words, "
                         "8-byte aligned")
    if stream.numel() < plan.header:
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {plan.num_hc}-entry header")


def _encode(plan: _Plan, words: int):
    """Launch ``plan``'s encoder on the words at address ``words``. Returns
    ``(stream, length)``: the int32 stream in a buffer of the compressed
    bound (words past ``length`` are undefined) and its length in u32 words
    as an int32 device scalar. No host sync."""
    stream = torch.empty(plan.bound, dtype=torch.int32, device=plan.device)
    # the look-back's status words and ticket (num_hc + 1 u64, this call's own, cleared by the
    # launch), then the length
    at = 2 * (plan.num_hc + 1)
    scratch = torch.empty(at + 1, dtype=torch.int32, device=plan.device)
    status = scratch.data_ptr()
    _launch(plan.fn, plan.index, words, *plan.args, stream.data_ptr(), status, status + 4 * at)
    LAUNCHES[plan.counter] += 1
    return stream, scratch[at]


def _decode(plan: _Plan, stream: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch ``plan``'s decoder on ``stream`` into a new tensor of its shape and ``dtype``."""
    out = torch.empty(plan.shape, dtype=dtype, device=plan.device)
    _launch(plan.fn, plan.index, stream.data_ptr(), stream.numel(), *plan.args, out.data_ptr())
    LAUNCHES[plan.counter] += 1
    return out


def _encode_kernel(words: torch.Tensor, word_dtype: torch.dtype, dims: tuple):
    """The encode wrappers' body: ``words`` of ``word_dtype`` with ``dims``
    dims, checked and launched; a 1D input must be 16-byte aligned."""
    _check_cuda_words("words", words, dims, word_dtype)
    plan = _kernel_plan("encode", tuple(words.shape), word_dtype, words.get_device())
    if dims == (1,) and words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    return _encode(plan, words.data_ptr())


def _decode_kernel(stream: torch.Tensor, shape: tuple, word_dtype: torch.dtype, dims: tuple) -> torch.Tensor:
    """The decode wrappers' body: ``stream`` checked and decoded into words
    of ``word_dtype`` and ``shape``, which has ``dims`` dims."""
    _check_cuda_words("stream", stream)
    if len(shape) not in dims:
        raise ValueError(f"the nd decode kernel takes 2D/3D shapes, got {shape}")
    plan = _kernel_plan("decode", shape, word_dtype, stream.get_device())
    _check_stream(plan, stream)
    return _decode(plan, stream, word_dtype)


def _encode_blocks_fp32(words: torch.Tensor):
    """Encode (n,) int32 words, n >= 4096, 16-byte aligned, on the card.
    Returns ``(stream, length)``: the int32 stream in a buffer of the
    compressed bound (words past ``length`` are undefined) and the int32
    length as a device scalar. No host sync."""
    return _encode_kernel(words, torch.int32, (1,))


def _decode_blocks_fp32(stream: torch.Tensor, n: int) -> torch.Tensor:
    """Decode an int32 stream (header from word 0) into (n,) int32 words on
    the card, n >= 4096. Reads only the words each block owns, so the stream
    needs no padding, may start at any word of its storage (a slice), and
    what lies past its length does not matter."""
    return _decode_kernel(stream, (n,), torch.int32, (1,))


def _encode_interior_fp32(words: torch.Tensor):
    """Encode a 2D/3D grid of int32 words with at least one whole block on
    the card, in one launch that reads the grid once: blocks read straight
    from the grid, border copied after them. Returns ``(stream, length)`` as
    ``_encode_blocks_fp32``. No host sync."""
    return _encode_kernel(words, torch.int32, (2, 3))


def _decode_interior_fp32(stream: torch.Tensor, shape) -> torch.Tensor:
    """Decode an int32 stream into int32 words of a 2D/3D ``shape`` with at
    least one whole block on the card: blocks stored straight into the grid,
    border placed from the stream. Reads only the words each block owns, so
    the stream needs no padding, may start at any word of its storage (a
    slice), and what lies past its length does not matter, as for
    ``_decode_blocks_fp32``."""
    return _decode_kernel(stream, tuple(shape), torch.int32, (2, 3))


def _encode_blocks_fp64(words: torch.Tensor):
    """Encode (n,) int64 words, n >= 4096, 16-byte aligned, on the card.
    Returns ``(stream, length)``: the int32 stream in a buffer of the fp64
    compressed bound (words past ``length`` are undefined) and its length in
    u32 words as an int32 device scalar. No host sync."""
    return _encode_kernel(words, torch.int64, (1,))


def _decode_blocks_fp64(stream: torch.Tensor, n: int) -> torch.Tensor:
    """Decode an int32 fp64 stream (header from word 0) into (n,) int64 words
    on the card, n >= 4096. Reads only the words each block owns, so the
    stream needs no padding, may start at any u64 word of its storage (a
    slice), and what lies past its length does not matter."""
    return _decode_kernel(stream, (n,), torch.int64, (1,))


def _encode_interior_fp64(words: torch.Tensor):
    """Encode a 2D/3D grid of int64 words with at least one whole block on
    the card, in one launch that reads the grid once: blocks read straight
    from the grid, border copied after them. Returns ``(stream, length)`` as
    ``_encode_blocks_fp64``. No host sync."""
    return _encode_kernel(words, torch.int64, (2, 3))


def _decode_interior_fp64(stream: torch.Tensor, shape) -> torch.Tensor:
    """Decode an int32 fp64 stream into int64 words of a 2D/3D ``shape``
    with at least one whole block on the card: blocks stored straight into
    the grid, border placed from the stream. Takes the stream as
    ``_decode_blocks_fp64`` does."""
    return _decode_kernel(stream, tuple(shape), torch.int64, (2, 3))


# ------------------------------------------------------------ device API


def _copy_in(cause: str, copy) -> torch.Tensor:
    """``copy()`` of a caller's tensor, in an ``ndzip.copy_in`` span and
    counted in ``COPIES[cause]``."""
    with utils.trace("ndzip.copy_in"):
        out = copy()
    COPIES[cause] += 1
    return out


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
        words = _WORDS.get(x.dtype)
        if words is None or not x.is_cuda:  # refused: the dtype's and shape's message first, as on the CPU
            _check_cuda_words("x", as_words(x), dims=(1, 2, 3), dtype=words)
        plan = _plan("encode", tuple(x.shape), words, x.get_device())
        if not x.is_contiguous():
            x = _copy_in("contiguous", x.contiguous)
        if plan.path == "1d" and x.data_ptr() % 16:
            # held until the launch is queued, or the stream's allocation may take its block
            x = _copy_in("align1d", x.clone)
        if plan.path != "border":
            return _encode(plan, x.data_ptr())
        # all border: the stream is the words themselves
        stream = torch.zeros(plan.bound, dtype=torch.int32, device=plan.device)
        stream.view(words)[:plan.n] = x.view(words).reshape(-1)
        return stream, torch.full((), plan.n * (words.itemsize // 4), dtype=torch.int32, device=plan.device)


def decompress_device(stream: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Decompress an int32 CUDA stream (``stream[:length]`` as it is, or the
    whole buffer) into a tensor of ``shape`` (1-3 dims): float32/float64 for
    those, int32/int64 for the word types."""
    with utils.trace("ndzip.decompress_device"):
        out_dtype = _OUT_DTYPES.get(dtype) if isinstance(dtype, torch.dtype) else None
        if out_dtype is None or not stream.is_cuda:
            out_dtype = output_dtype(shape, dtype)
            _check_cuda_words("stream", stream)
        plan = _plan("decode", tuple(shape), _WORDS[out_dtype], stream.get_device())
        if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
            _check_cuda_words("stream", stream)
        if plan.words == torch.int64 and stream.data_ptr() % 8:  # a slice at an odd u32 offset: realign
            stream = _copy_in("realign64", stream.clone)
        if plan.path != "border":
            _check_stream(plan, stream)
            return _decode(plan, stream, out_dtype)
        w = plan.words.itemsize // 4
        if stream.numel() < w * plan.n:
            raise ValueError(f"stream of {stream.numel()} {'u32 ' if w == 2 else ''}words is shorter than "
                             f"its {plan.n} border words")
        return stream[: w * plan.n].clone().view(out_dtype).reshape(plan.shape)
