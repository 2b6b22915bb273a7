"""Public API of the port: compressor, decompressor and offloader objects and
their factories, on numpy arrays. The counterpart of ``ndzip_tpu/api.py``,
after the reference's public surface (``include/ndzip/ndzip.hh:228-269``,
``include/ndzip/offload.hh:8-71``).

Backends, all of which give the same stream byte for byte:

* ``cuda``: the CUDA kernels of ``codec_cuda`` on the first card; raises
  RuntimeError when ``torch.cuda.is_available()`` is false;
* ``torch``: the plain PyTorch versions of ``codec_torch`` on the CPU;
* ``golden``: the numpy reference of ``golden``;
* ``cpu``/``native``: the C++ codec under ``native/``, through ``native``;
* ``sharded``: block-parallel over every visible CUDA device
  (``parallel.sharded``, one row slab a device); raises RuntimeError without
  one, and grids with no whole block (all border) raise ValueError;
* ``auto``: the backend named by the environment variable
  ``NDZIP_TORCH_BACKEND`` where that is set (an unknown name raises like an
  unknown ``backend``), else ``cuda`` where a GPU is present, else ``cpu``
  where the native codec builds, else ``golden``
  (``ndzip_tpu/api.py:214-225``); never ``sharded``.

A call that names no backend (``backend=None``: ``make_compressor``,
``make_decompressor``, ``Offloader``, the package's ``compress`` and
``decompress`` and the CLI's ``-e``) takes the one that
``NDZIP_TORCH_BACKEND`` names where that is set, else ``cuda``: without a GPU
it raises RuntimeError naming the GPU, and nothing falls back to the CPU.
``auto`` probes only where the caller asks for it, by name or in the
variable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import _build, codec_cuda, codec_torch, golden, interop, native, utils
from . import format as fmt


class CompressorRequirements:
    """ndzip.hh:255-269: the planned shapes of one dimensionality and the
    largest block count among them."""

    def __init__(self, *shapes):
        self.dims = None
        self.max_num_hypercubes = 0
        self.shapes = []
        for s in shapes:
            self.include(s)

    def include(self, shape):
        shape = tuple(shape)
        fmt.validate_shape(shape)
        if self.dims is None:
            self.dims = len(shape)
        elif self.dims != len(shape):
            raise ValueError("all shapes in requirements must share dimensionality")
        self.shapes.append(shape)
        self.max_num_hypercubes = max(self.max_num_hypercubes, fmt.num_hypercubes(shape))
        return self


@dataclass
class KernelTiming:
    """Most recent duration of each call in ns; -1 when not measured."""

    compress_ns: int = -1
    decompress_ns: int = -1


class _Codec:
    """What a compressor and a decompressor are made for: a dtype and a
    dimensionality."""

    def __init__(self, dtype, dims):
        self.dtype = np.dtype(dtype)
        self.word_bits = fmt.word_bits_for_dtype(self.dtype)
        if not 1 <= dims <= fmt.MAX_DIMENSIONALITY:
            raise ValueError(f"dims must be 1..{fmt.MAX_DIMENSIONALITY}")
        self.dims = dims


class Compressor(_Codec):
    def _check(self, data):
        if data.ndim != self.dims:
            raise ValueError(
                f"data dimensionality {data.ndim} does not match compressor dimensionality {self.dims}")
        if np.dtype(data.dtype) != self.dtype:
            raise ValueError(f"data dtype {data.dtype} != compressor dtype {self.dtype}")

    def compress(self, data) -> tuple[np.ndarray, int]:
        raise NotImplementedError


class Decompressor(_Codec):
    def decompress(self, stream, shape) -> np.ndarray:
        raise NotImplementedError


class _GoldenCompressor(Compressor):
    def compress(self, data):
        data = np.ascontiguousarray(data)
        self._check(data)
        return golden.compress(data)


class _GoldenDecompressor(Decompressor):
    def decompress(self, stream, shape):
        return golden.decompress(np.asarray(stream), tuple(shape), self.dtype)


class _NativeCompressor(Compressor):
    def __init__(self, dtype, dims, threads=1):
        super().__init__(dtype, dims)
        self.threads = threads

    def compress(self, data):
        data = np.ascontiguousarray(data)
        self._check(data)
        return native.compress(data, threads=self.threads)


class _NativeDecompressor(Decompressor):
    def __init__(self, dtype, dims, threads=1):
        super().__init__(dtype, dims)
        self.threads = threads

    def decompress(self, stream, shape):
        return native.decompress(np.asarray(stream), tuple(shape), self.dtype, threads=self.threads)


def _require_gpu():
    if not torch.cuda.is_available():
        raise RuntimeError("backend 'cuda' needs an NVIDIA GPU: torch.cuda.is_available() is false")


def _cuda_ready():
    """Build or load the kernels' library and create the card's context, so
    that no compress or decompress pays for either."""
    _require_gpu()
    _build.load()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


class _TorchCompressor(Compressor):
    """The plain versions on the CPU. ``compress`` holds the staging spans
    that ``_CudaCompressor`` inherits (``utils.trace``):
    ``ndzip.offload.stage`` (the check and the copy to the device),
    ``ndzip.offload.length`` (``int(length)``, the wait for the encode) and
    ``ndzip.offload.copy_out`` (the stream's copy into numpy)."""

    device = "cpu"

    def stage(self, data) -> torch.Tensor:
        """Check ``data`` and copy its words to the device."""
        data = np.ascontiguousarray(data)
        self._check(data)
        return interop.words_from_numpy(data, self.device)

    def encode(self, words: torch.Tensor):
        return codec_torch.encode(words)

    def compress(self, data):
        with utils.trace("ndzip.offload.stage"):
            words = self.stage(data)
        stream, length = self.encode(words)
        with utils.trace("ndzip.offload.length"):
            length = int(length)
        with utils.trace("ndzip.offload.copy_out"):
            out = interop.stream_to_numpy(stream, length)
        return out, length // (self.word_bits // 32)


class _TorchDecompressor(Decompressor):
    """The plain versions on the CPU; ``decompress`` holds the spans
    ``ndzip.offload.stage`` and ``ndzip.offload.copy_out``, as
    ``_TorchCompressor.compress`` does."""

    device = "cpu"

    def stage(self, stream) -> torch.Tensor:
        return interop.stream_from_numpy(stream, self.device)

    def decode(self, stream: torch.Tensor, shape) -> torch.Tensor:
        return codec_torch.decode(stream, shape, self.word_bits)

    def decompress(self, stream, shape):
        shape = tuple(shape)
        with utils.trace("ndzip.offload.stage"):
            staged = self.stage(stream)
        words = self.decode(staged, shape)
        with utils.trace("ndzip.offload.copy_out"):
            return interop.words_to_numpy(words, self.dtype).reshape(shape)


class _CudaCompressor(_TorchCompressor):
    """The kernels on the first card, made ready here (``_cuda_ready``)."""

    device = "cuda"

    def __init__(self, dtype, dims):
        super().__init__(dtype, dims)
        _cuda_ready()

    def encode(self, words):
        return codec_cuda.compress_device(words)


class _CudaDecompressor(_TorchDecompressor):
    device = "cuda"

    def __init__(self, dtype, dims):
        super().__init__(dtype, dims)
        _cuda_ready()

    def decode(self, stream, shape):
        return codec_cuda.decompress_device(stream, shape, self.dtype)


class _Sharded(_Codec):
    """Block-parallel over every visible CUDA device (``parallel.make_mesh``),
    as ``ndzip_tpu/api.py:228-246`` is over every visible accelerator; the
    stream is byte for byte every single-device backend's."""

    def __init__(self, dtype, dims):
        # imported on use: parallel.sharded takes compress_device from the package, which imports this module
        from .parallel import sharded

        super().__init__(dtype, dims)
        self.mesh = sharded.make_mesh()
        if any(d.type == "cuda" for d in self.mesh):
            _cuda_ready()


class _ShardedCompressor(_Sharded, Compressor):
    def compress(self, data):
        from .parallel import sharded

        data = np.ascontiguousarray(data)
        self._check(data)
        return sharded.compress_sharded(data, self.mesh)


class _ShardedDecompressor(_Sharded, Decompressor):
    def decompress(self, stream, shape):
        from .parallel import sharded

        return sharded.decompress_sharded(np.asarray(stream), tuple(shape), self.dtype, self.mesh)


#: the environment variable that names the backend of a call that names none, and of ``auto``
BACKEND_ENV = "NDZIP_TORCH_BACKEND"


def _resolve_backend(backend) -> str:
    if backend is None:
        backend = os.environ.get(BACKEND_ENV, "cuda")
    if backend == "auto":
        backend = os.environ.get(BACKEND_ENV, "auto")
    if backend != "auto":
        return backend
    if torch.cuda.is_available():
        return "cuda"
    return "cpu" if native.available() else "golden"


_COMPRESSORS = {"golden": _GoldenCompressor, "cpu": _NativeCompressor, "native": _NativeCompressor,
                "torch": _TorchCompressor, "cuda": _CudaCompressor, "sharded": _ShardedCompressor}
_DECOMPRESSORS = {"golden": _GoldenDecompressor, "cpu": _NativeDecompressor, "native": _NativeDecompressor,
                  "torch": _TorchDecompressor, "cuda": _CudaDecompressor, "sharded": _ShardedDecompressor}


def _precompile(backend: str, dtype, requirements: CompressorRequirements):
    """compressor_requirements (ndzip.hh:255-269) on the card: build or load
    the kernels' library, then compress and decompress zeros of every planned
    shape once, so the first real call loads no kernel."""
    if backend != "cuda":
        return
    _cuda_ready()
    for shape in requirements.shapes:
        stream, length = codec_cuda.compress_device(torch.zeros(shape, dtype=_torch_dtype(dtype), device="cuda"))
        codec_cuda.decompress_device(stream[: int(length)], shape, dtype)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.float64 if fmt.word_bits_for_dtype(np.dtype(dtype)) == 64 else torch.float32


def make_compressor(dtype, dims, backend=None, threads=1, requirements=None) -> Compressor:
    backend = _resolve_backend(backend)
    cls = _COMPRESSORS.get(backend)
    if cls is None:
        raise ValueError(f"unknown backend {backend!r}; options: {sorted(_COMPRESSORS)}")
    if requirements is not None:
        _precompile(backend, dtype, requirements)
    if cls is _NativeCompressor:
        return cls(dtype, dims, threads=threads)
    return cls(dtype, dims)


def make_decompressor(dtype, dims, backend=None, threads=1) -> Decompressor:
    backend = _resolve_backend(backend)
    cls = _DECOMPRESSORS.get(backend)
    if cls is None:
        raise ValueError(f"unknown backend {backend!r}; options: {sorted(_DECOMPRESSORS)}")
    if cls is _NativeDecompressor:
        return cls(dtype, dims, threads=threads)
    return cls(dtype, dims)


def compress_device(x: torch.Tensor):
    """Compress a tensor where it lies, without leaving its device (the
    reference's cuda_compressor, cuda.hh:10-41); ``ndzip_tpu_torch.compress_device``."""
    from . import compress_device as f  # the package imports this module

    return f(x)


def decompress_device(stream: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Decompress a stream where it lies (cuda.hh:28-41);
    ``ndzip_tpu_torch.decompress_device``."""
    from . import decompress_device as f

    return f(stream, shape, dtype)


class Offloader:
    """Host arrays in and out, with the duration of each call
    (offload.hh:8-71).

    ``timing_mode`` says what ``timing`` holds after each call:

    * ``"wall"`` (default): the host clock around the whole call, staging
      and copies included.
    * ``"device"``, for ``cuda``: the reference's ``kernel_duration``
      (offload.hh:16-24), the device's time for the codec's kernels. The
      input or stream is first copied to the card and synchronized; then
      ``codec_cuda.compress_device``/``decompress_device`` alone runs
      between two CUDA events, its launches queued behind a spin kernel
      (``utils.event_time_ms(..., queued=True)``), and the elapsed time is
      ``compress_ns``/``decompress_ns``. The host's time to enqueue the
      launches (0.05-0.4 ms a call on an H100 machine) is not in it; reading
      the length and the copy back come after the second event. Host
      backends take wall time.

    ``measure(data)`` fills ``timing`` with the median of the same device
    time of one compress and one decompress over ``reps`` calls
    (``utils.device_time_ms(..., queued=True)``); it needs ``cuda``."""

    def __init__(self, dtype, dims, backend=None, threads=1, timing_mode="wall"):
        if timing_mode not in ("wall", "device"):
            raise ValueError("timing_mode must be 'wall' or 'device'")
        self.backend = _resolve_backend(backend)
        self._comp = make_compressor(dtype, dims, self.backend, threads)
        self._dec = make_decompressor(dtype, dims, self.backend, threads)
        self.dtype = self._comp.dtype
        self.dims = dims
        self.timing = KernelTiming()
        self.timing_mode = timing_mode if self.backend == "cuda" else "wall"

    def compress(self, data) -> tuple[np.ndarray, int]:
        if self.timing_mode == "device":
            return self._compress_device_timed(data)
        (stream, words), self.timing.compress_ns = utils.wall_time_ns(lambda: self._comp.compress(data))
        return stream, words

    def decompress(self, stream, shape) -> np.ndarray:
        if self.timing_mode == "device":
            return self._decompress_device_timed(stream, shape)
        out, self.timing.decompress_ns = utils.wall_time_ns(lambda: self._dec.decompress(stream, shape))
        return out

    def _compress_device_timed(self, data):
        words = self._comp.stage(data)
        torch.cuda.synchronize()
        (stream, length), ms = utils.event_time_ms(lambda: codec_cuda.compress_device(words), queued=True)
        self.timing.compress_ns = round(ms * 1e6)
        length = int(length)
        return interop.stream_to_numpy(stream, length), length // (self._comp.word_bits // 32)

    def _decompress_device_timed(self, stream, shape):
        shape = tuple(shape)
        s = self._dec.stage(stream)
        torch.cuda.synchronize()
        out, ms = utils.event_time_ms(lambda: codec_cuda.decompress_device(s, shape, self.dtype),
                                      queued=True)
        self.timing.decompress_ns = round(ms * 1e6)
        return interop.words_to_numpy(out, self.dtype).reshape(shape)

    def measure(self, data, reps: int = 10) -> KernelTiming:
        """Median device time over ``reps`` calls (after 2 warm-ups) of one
        compress and one decompress of ``data`` on the card, in ns, the
        host's time to enqueue them left out as in ``timing_mode="device"``."""
        if self.backend != "cuda":
            raise ValueError("measure() requires the cuda backend")
        words = self._comp.stage(data)
        shape = tuple(words.shape)
        stream, length = codec_cuda.compress_device(words)
        s = stream[: int(length)]
        self.timing.compress_ns = round(
            utils.device_time_ms(lambda: codec_cuda.compress_device(words), reps, queued=True) * 1e6)
        self.timing.decompress_ns = round(
            utils.device_time_ms(lambda: codec_cuda.decompress_device(s, shape, self.dtype), reps,
                                 queued=True) * 1e6)
        return self.timing

    def compressed_length_bound(self, shape) -> int:
        return fmt.compressed_bound_words(tuple(shape), self._comp.word_bits)


def make_offloader(backend, dtype, dims, threads: int = 1, **kwargs) -> Offloader:
    return Offloader(dtype, dims, backend=backend, threads=threads, **kwargs)
