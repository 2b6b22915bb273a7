"""Conversions between the numpy arrays of ``ndzip_tpu`` and the port's
tensors.

The port holds every 32-bit word as an int32 view and every 64-bit word as
an int64 view (see ``ops/bitops.py``); ``ndzip_tpu`` holds data as
float32/float64/uint32/uint64 and streams as uint32. The bits never change,
so a stream made by either package decodes with the other. The JAX package's
fp64 device API carries 64-bit words as (lo, hi) uint32 planes, because the
TPU has no 64-bit lanes; ``words_from_planes``/``planes_from_words`` move
between those and the port's int64 words.
"""

from __future__ import annotations

import numpy as np
import torch

#: numpy word dtypes -> the signed view the port computes on
_VIEWS = {np.dtype(np.float32): np.int32, np.dtype(np.uint32): np.int32, np.dtype(np.int32): np.int32,
          np.dtype(np.float64): np.int64, np.dtype(np.uint64): np.int64, np.dtype(np.int64): np.int64}


def words_from_numpy(data: np.ndarray, device="cpu") -> torch.Tensor:
    """float32/uint32/int32 array -> contiguous int32 word tensor, and
    float64/uint64/int64 array -> int64 word tensor, on ``device``."""
    data = np.ascontiguousarray(data)
    if data.dtype not in _VIEWS:
        raise ValueError(f"expected a 32- or 64-bit float or word array, got {data.dtype}")
    if not data.flags.writeable:  # a tensor may not alias read-only memory
        data = data.copy()
    return torch.from_numpy(data.view(_VIEWS[data.dtype])).to(device)


def words_to_numpy(words: torch.Tensor, dtype=np.float32) -> np.ndarray:
    """int32/int64 (or float32/float64) word tensor -> numpy array of
    ``dtype`` with the same bits."""
    if words.dtype in (torch.float32, torch.float64):
        words = words.view(torch.int32 if words.dtype == torch.float32 else torch.int64)
    if words.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expected int32 or int64 words, got {words.dtype}")
    return words.detach().cpu().numpy().view(dtype)


def words_from_planes(lo, hi, device="cpu") -> torch.Tensor:
    """(lo, hi) uint32 planes of the JAX fp64 device API -> int64 words
    ``hi << 32 | lo`` on ``device`` (``ndzip_tpu.ops.u64pair.join``)."""
    lo, hi = np.asarray(lo, dtype=np.uint32), np.asarray(hi, dtype=np.uint32)
    if lo.shape != hi.shape:
        raise ValueError(f"planes differ in shape: {lo.shape} vs {hi.shape}")
    pairs = np.stack([lo, hi], axis=-1)  # little-endian: lo at the lower address
    return torch.from_numpy(pairs.view(np.int64).reshape(lo.shape)).to(device)


def planes_from_words(words: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 (or float64) words -> their (lo, hi) uint32 planes
    (``ndzip_tpu.ops.u64pair.split``)."""
    pairs = words_to_numpy(words, np.uint32).reshape(tuple(words.shape) + (2,))
    return np.ascontiguousarray(pairs[..., 0]), np.ascontiguousarray(pairs[..., 1])


def stream_from_numpy(stream: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 stream (as ``golden.compress`` gives it) -> int32 tensor."""
    return words_from_numpy(np.asarray(stream, dtype=np.uint32), device)


def stream_to_numpy(stream: torch.Tensor, length) -> np.ndarray:
    """(stream tensor, length in u32 words) -> the uint32 stream ``golden``
    produces. ``length`` may be an int or a device scalar."""
    return words_to_numpy(stream[: int(length)], np.uint32)
