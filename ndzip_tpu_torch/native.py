"""ctypes bindings for the native C++ CPU codec (native/ndzip_cpu.cc): the
port's own copy of ``ndzip_tpu/native.py``.

The shared library is built on demand with g++ (no pip packages needed) into
``native/build/``, apart from the JAX package's library beside the source,
and is rebuilt whenever the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import format as fmt

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "ndzip_cpu.cc"
_LIB = _NATIVE_DIR / "build" / "libndzip_cpu.so"
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    _LIB.parent.mkdir(exist_ok=True)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-march=native",
        "-funroll-loops",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-pthread",
        str(_SRC),
        "-o",
        str(_LIB),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeUnavailable(f"native codec build failed:\n{res.stderr}")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _SRC.exists():
            raise NativeUnavailable(f"native source missing: {_SRC}")
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        lib.ndzip_compressed_bound_words.restype = ctypes.c_size_t
        lib.ndzip_compressed_bound_words.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
        lib.ndzip_compress.restype = ctypes.c_size_t
        lib.ndzip_compress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.ndzip_decompress.restype = ctypes.c_size_t
        lib.ndzip_decompress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _shape_arg(shape):
    return (ctypes.c_uint64 * len(shape))(*shape)


def compress(data: np.ndarray, threads: int = 1) -> tuple[np.ndarray, int]:
    """Compress with the native codec; returns (uint32 stream, words)."""
    lib = _load()
    data = np.ascontiguousarray(data)
    fmt.validate_shape(data.shape)
    wb = fmt.word_bits_for_dtype(data.dtype)
    bound_w = fmt.compressed_bound_words(data.shape, wb)
    out = np.empty(bound_w * (wb // 32), dtype=np.uint32)
    n = lib.ndzip_compress(
        wb, data.ndim, _shape_arg(data.shape),
        data.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        threads)
    if n == ctypes.c_size_t(-1).value:
        raise RuntimeError("ndzip_compress failed")
    return np.ascontiguousarray(out[: n * (wb // 32)]), int(n)


def decompress(stream: np.ndarray, shape, dtype, threads: int = 1) -> np.ndarray:
    lib = _load()
    fmt.validate_shape(tuple(shape))
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    stream = np.ascontiguousarray(stream, dtype=np.uint32)
    out = np.empty(shape, dtype=dtype)
    n = lib.ndzip_decompress(
        wb, len(shape), _shape_arg(shape),
        stream.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        threads)
    if n == ctypes.c_size_t(-1).value:
        raise RuntimeError("ndzip_decompress failed")
    return out
