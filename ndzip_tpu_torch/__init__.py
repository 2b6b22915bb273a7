"""ndzip_tpu_torch: the ndzip codec on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper. The port of ``ndzip_tpu``; streams are byte for
byte the ndzip format, so either package decodes the other's.

The port covers fp32 and fp64 grids of 1-3 dims. A tensor's device picks
the path:

* a CUDA tensor goes to the kernels of ``codec_cuda`` (built from
  ``csrc/`` with nvcc on first use; a failed build or launch raises);
* a CPU tensor goes to the plain PyTorch versions of ``codec_torch``.

Streams are int32 tensors and lengths count u32 words for both profiles, so
``stream[:length]`` is the stream; ``compress`` returns the length in the
profile's words, as ``ndzip_tpu.compress`` does.

``compress``/``decompress`` take numpy arrays and a backend by name, as
``ndzip_tpu.compress``/``decompress`` do, through ``api.make_offloader``.
``device=`` instead runs the call on that device's path, as above.

The objects of ``api`` (``make_compressor``, ``make_decompressor``,
``make_offloader``, ``Offloader``, ``CompressorRequirements``) take numpy
arrays and a backend by name. Every entry point that is given no backend
(these, ``compress``/``decompress`` and the CLI's ``-e``) takes the one that
``NDZIP_TORCH_BACKEND`` names where that is set, else ``cuda``: without a
GPU it raises RuntimeError, and nothing falls back. ``backend="auto"`` asks
for the card where one answers, else the CPU codecs (see ``api``).

``python -m ndzip_tpu_torch.cli`` is the command-line compressor, ``.warm``
builds and loads the kernels for planned shapes, ``.ubench`` times the codec
stage by stage, and ``.bench`` prints the headline throughputs on the card
as one JSON line.
"""

from __future__ import annotations

import numpy as np
import torch

from . import api, codec_cuda, codec_torch, interop
from . import format  # noqa: F401
from .api import (CompressorRequirements, Offloader, make_compressor,  # noqa: F401
                  make_decompressor, make_offloader)
from .format import Profile, compressed_bound_words, num_hypercubes, profile_for  # noqa: F401

__version__ = "0.1.0"


def compress_device(x: torch.Tensor):
    """Compress a float32/float64 (or int32/int64 word) tensor of 1-3 dims
    where it lies. Returns ``(stream, length)``: an int32 stream of the
    compressed bound and its length in u32 words as an int32 scalar tensor
    on the same device."""
    if x.is_cuda:
        return codec_cuda.compress_device(x)
    words = codec_torch.as_words(x)
    if words.device.type != "cpu":
        raise ValueError(f"tensors on {words.device} are not supported")
    return codec_torch.encode(words)


def decompress_device(stream: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Decompress an int32 stream into a tensor of ``shape`` on the stream's
    device: float32/float64 for those, int32/int64 for the word types."""
    if stream.is_cuda:
        return codec_cuda.decompress_device(stream, shape, dtype)
    out_dtype = codec_torch.output_dtype(shape, dtype)
    if stream.device.type != "cpu" or stream.dtype != torch.int32:
        raise ValueError(f"expected an int32 stream on the CPU or a CUDA device, got "
                         f"{stream.dtype} on {stream.device}")
    return codec_torch.decode(stream, shape, out_dtype.itemsize * 8).view(out_dtype)


def compress(data: np.ndarray, backend=None, device=None, **kwargs) -> tuple[np.ndarray, int]:
    """Compress a float32/float64 numpy array of 1-3 dims; returns (uint32
    stream, length in the profile's words) as ``ndzip_tpu.compress`` does.

    ``backend`` (default: ``NDZIP_TORCH_BACKEND`` where set, else ``cuda``)
    and ``kwargs`` go to ``api.make_offloader``. With ``device`` (and no
    backend) the call runs on that device instead: the kernels
    on a CUDA device, the plain versions on the CPU."""
    if device is None:
        return make_offloader(backend, data.dtype, data.ndim, **kwargs).compress(data)
    words = interop.words_from_numpy(data, _device(device, backend, kwargs))
    stream, length = compress_device(words)
    length = int(length)
    return interop.stream_to_numpy(stream, length), length // (words.element_size() // 4)


def decompress(stream: np.ndarray, shape, dtype=np.float32, backend=None, device=None, **kwargs) -> np.ndarray:
    """Decompress a uint32 numpy stream into a numpy array of ``shape`` and
    ``dtype``, with ``backend`` or on ``device`` as ``compress``."""
    if device is None:
        return make_offloader(backend, dtype, len(shape), **kwargs).decompress(stream, shape)
    out = decompress_device(interop.stream_from_numpy(stream, _device(device, backend, kwargs)), shape, dtype)
    return interop.words_to_numpy(out, dtype).reshape(tuple(shape))


def _device(device, backend, kwargs) -> torch.device:
    """``device`` for a call that names one, which then takes no other backend
    and no options; a CUDA device needs a GPU."""
    if backend is not None or kwargs:
        raise ValueError(f"pass device= or backend=/options, not both (device={device!r}, backend={backend!r})")
    device = torch.device(device)
    if device.type == "cuda":
        api._require_gpu()
    return device
