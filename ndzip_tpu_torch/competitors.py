"""Bindings for the benchmark's competitor codecs: the port's own copy of
``ndzip_tpu/competitors.py``, with the same ctypes signatures and functions.

The reference's benchmark builds 18 third-party compressors from vendored
submodules (``src/benchmark/benchmark.cc:1196-1253``). The competitors here
are the JAX package's, no more:

* ``fpc`` and ``pfpc`` (chunk-parallel FPC over std::thread), ``spdp``,
  ``lz4``, and serial CPU reimplementations of the reference's GPU
  competitors ``mpc``, ``gfc`` and nvCOMP's ``cascaded`` scheme, all in the
  shared C++ source ``native/competitors.cc``;
* the byte codecs of the standard library and the optional pip wrappers,
  which live in ``benchmark.py``.

The source is built with g++ on first use into
``native/build/libndzip_competitors.so``, apart from the JAX package's
library beside the source, and built again when the source is newer. The
build writes a temporary file in that directory and moves it into place
with ``os.replace``, so a process that loads the library never finds it
half written while another builds it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "competitors.cc"
_LIB = _NATIVE_DIR / "build" / "libndzip_competitors.so"
_lock = threading.Lock()
_lib = None


class CompetitorUnavailable(RuntimeError):
    pass


def _build() -> None:
    _LIB.parent.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{_LIB.name}.", suffix=".tmp", dir=_LIB.parent)
    os.close(fd)
    try:
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native",
               "-funroll-loops", "-std=c++17", "-shared", "-fPIC",
               str(_SRC), "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise CompetitorUnavailable(f"competitor build failed:\n{res.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _SRC.exists():
            raise CompetitorUnavailable(f"source missing: {_SRC}")
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        lib.fpc_bound.restype = ctypes.c_size_t
        lib.fpc_bound.argtypes = [ctypes.c_size_t]
        lib.fpc_compress.restype = ctypes.c_size_t
        lib.fpc_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int]
        lib.fpc_decompress.restype = ctypes.c_size_t
        lib.fpc_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int]
        lib.pfpc_bound.restype = ctypes.c_size_t
        lib.pfpc_bound.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.pfpc_compress.restype = ctypes.c_size_t
        lib.pfpc_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.pfpc_decompress.restype = ctypes.c_size_t
        lib.pfpc_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int]
        lib.spdp_bound.restype = ctypes.c_size_t
        lib.spdp_bound.argtypes = [ctypes.c_size_t]
        lib.spdp_compress.restype = ctypes.c_size_t
        lib.spdp_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int]
        lib.spdp_decompress.restype = ctypes.c_size_t
        lib.spdp_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int]
        for suffix in ("32", "64"):
            b = getattr(lib, f"mpc_bound{suffix}")
            b.restype = ctypes.c_size_t
            b.argtypes = [ctypes.c_size_t]
            c = getattr(lib, f"mpc_compress{suffix}")
            c.restype = ctypes.c_size_t
            c.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                          ctypes.c_int]
            d = getattr(lib, f"mpc_decompress{suffix}")
            d.restype = ctypes.c_size_t
            d.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                          ctypes.c_size_t, ctypes.c_int]
        lib.ncc_bound.restype = ctypes.c_size_t
        lib.ncc_bound.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.ncc_compress.restype = ctypes.c_size_t
        lib.ncc_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int]
        lib.ncc_decompress.restype = ctypes.c_size_t
        lib.ncc_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int]
        lib.gfc_bound.restype = ctypes.c_size_t
        lib.gfc_bound.argtypes = [ctypes.c_size_t]
        lib.gfc_compress.restype = ctypes.c_size_t
        lib.gfc_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int]
        lib.gfc_decompress.restype = ctypes.c_size_t
        lib.gfc_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int]
        lib.lz4_bound.restype = ctypes.c_size_t
        lib.lz4_bound.argtypes = [ctypes.c_size_t]
        lib.lz4_compress.restype = ctypes.c_size_t
        lib.lz4_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.lz4_decompress.restype = ctypes.c_size_t
        lib.lz4_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t]
        _lib = lib
        return lib


def fpc_available() -> bool:
    try:
        _load()
        return True
    except CompetitorUnavailable:
        return False


def fpc_compress(data: np.ndarray, level: int = 16) -> bytes:
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    n = data.size
    out = np.empty(lib.fpc_bound(n), np.uint8)
    written = lib.fpc_compress(
        data.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p), level)
    if written == ctypes.c_size_t(-1).value:
        raise RuntimeError("fpc_compress failed")
    return out[:written].tobytes()


def pad_stream(comp: bytes) -> np.ndarray:
    """Copy ``comp`` into a buffer with 8 bytes of tail slack (the decoders
    read residuals as unaligned 8-byte loads masked to the live byte
    count).  Decompress calls accept the result in place of raw bytes —
    pad once OUTSIDE a timed rep loop so the copy never lands in
    competitor decompress timings."""
    buf = np.zeros(len(comp) + 8, np.uint8)
    buf[: len(comp)] = np.frombuffer(comp, np.uint8)
    return buf


def _as_padded(comp) -> tuple[np.ndarray, int]:
    if isinstance(comp, np.ndarray):
        return comp, comp.size - 8
    return pad_stream(comp), len(comp)


def fpc_decompress(comp, n: int, level: int = 16,
                   out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    buf, clen = _as_padded(comp)
    if out is None:
        out = np.empty(n, np.float64)
    got = lib.fpc_decompress(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n, level)
    if got != n:
        raise RuntimeError("fpc_decompress failed")
    return out


def pfpc_compress(data: np.ndarray, level: int = 16,
                  threads: int = 0) -> bytes:
    if threads <= 0:
        threads = os.cpu_count() or 1
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    n = data.size
    out = np.empty(lib.pfpc_bound(n, threads), np.uint8)
    written = lib.pfpc_compress(
        data.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p), level, threads)
    if written == ctypes.c_size_t(-1).value:
        raise RuntimeError("pfpc_compress failed")
    return out[:written].tobytes()


def pfpc_decompress(comp, n: int, level: int = 16,
                    out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    buf, clen = _as_padded(comp)  # same 8-byte tail slack as fpc
    if out is None:
        out = np.empty(n, np.float64)
    got = lib.pfpc_decompress(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n, level)
    if got != n:
        raise RuntimeError("pfpc_decompress failed")
    return out


def mpc_compress(data: np.ndarray, dim: int = 1) -> bytes:
    """MPC pipeline over fp32/fp64 values (native CPU reimplementation of
    the CUDA competitor, native/competitors.cc; benchmark.cc "mpc")."""
    lib = _load()
    data = np.ascontiguousarray(data)
    suffix = "64" if data.dtype == np.float64 else "32"
    flat = data.reshape(-1).view(np.uint64 if suffix == "64" else np.uint32)
    out = np.empty(getattr(lib, f"mpc_bound{suffix}")(flat.size), np.uint32)
    written = getattr(lib, f"mpc_compress{suffix}")(
        flat.ctypes.data_as(ctypes.c_void_p), flat.size,
        out.ctypes.data_as(ctypes.c_void_p), dim)
    if written == ctypes.c_size_t(-1).value:
        raise RuntimeError("mpc_compress failed")
    return out[:written].tobytes()


def mpc_decompress(comp, n: int, dtype, dim: int = 1,
                   out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    if isinstance(comp, np.ndarray):
        buf, clen = comp, comp.size
    else:
        clen = len(comp) // 4  # ragged tails (corrupt input) are dropped;
        buf = np.frombuffer(comp[: clen * 4], np.uint32)  # the codec rejects
    suffix = "64" if np.dtype(dtype) == np.float64 else "32"
    if out is None:
        out = np.empty(n, dtype)
    got = getattr(lib, f"mpc_decompress{suffix}")(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n, dim)
    if got != n:
        raise RuntimeError("mpc_decompress failed")
    return out


def cascaded_compress(data: np.ndarray, cfg: int = 0) -> bytes:
    """Cascaded RLE/delta/bit-pack scheme over the value bits (own serial
    implementation of the nvCOMP Cascaded scheme, native/competitors.cc;
    benchmark.cc "nvcomp-cascaded").  cfg 0 auto-tunes; else R*100+D*10+bp
    (101 = nvCOMP's default {1,0,1})."""
    lib = _load()
    data = np.ascontiguousarray(data)
    eb = data.dtype.itemsize
    flat = data.reshape(-1)
    out = np.empty(lib.ncc_bound(flat.size, eb), np.uint8)
    written = lib.ncc_compress(
        flat.ctypes.data_as(ctypes.c_void_p), flat.size, eb,
        out.ctypes.data_as(ctypes.c_void_p), cfg)
    if written == ctypes.c_size_t(-1).value:
        raise RuntimeError("ncc_compress failed")
    return out[:written].tobytes()


def cascaded_decompress(comp, n: int, dtype,
                        out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    if isinstance(comp, np.ndarray):
        buf, clen = comp, comp.size
    else:
        buf, clen = np.frombuffer(comp, np.uint8), len(comp)
    dtype = np.dtype(dtype)
    if out is None:
        out = np.empty(n, dtype)
    got = lib.ncc_decompress(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n, dtype.itemsize)
    if got != n:
        raise RuntimeError("ncc_decompress failed")
    return out


def gfc_compress(data: np.ndarray, dim: int = 1) -> bytes:
    """GFC double compressor (native CPU reimplementation of the CUDA
    competitor, native/competitors.cc; benchmark.cc "gfc")."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64).reshape(-1)
    out = np.empty(lib.gfc_bound(data.size), np.uint8)
    written = lib.gfc_compress(
        data.ctypes.data_as(ctypes.c_void_p), data.size,
        out.ctypes.data_as(ctypes.c_void_p), dim)
    if written == ctypes.c_size_t(-1).value:
        raise RuntimeError("gfc_compress failed")
    return out[:written].tobytes()


def gfc_decompress(comp, n: int, dim: int = 1,
                   out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    if isinstance(comp, np.ndarray):
        buf, clen = comp, comp.size
    else:
        buf, clen = np.frombuffer(comp, np.uint8), len(comp)
    if out is None:
        out = np.empty(n, np.float64)
    got = lib.gfc_decompress(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n, dim)
    if got != n:
        raise RuntimeError("gfc_decompress failed")
    return out


def lz4_compress(buf: bytes) -> bytes:
    """LZ4 block format, greedy fast level (own implementation,
    native/competitors.cc; reference: benchmark.cc "lz4")."""
    lib = _load()
    src = np.frombuffer(buf, np.uint8)
    n = src.size
    out = np.empty(lib.lz4_bound(n), np.uint8)
    written = lib.lz4_compress(
        src.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p))
    return out[:written].tobytes()


def lz4_decompress(comp, n: int, out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    if isinstance(comp, np.ndarray):
        buf, clen = comp, comp.size
    else:
        buf, clen = np.frombuffer(comp, np.uint8), len(comp)
    if out is None:
        out = np.empty(n, np.uint8)
    got = lib.lz4_decompress(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n)
    if got != n:
        raise RuntimeError("lz4_decompress failed")
    return out


def spdp_compress(buf: bytes, level: int = 5) -> bytes:
    """SPDP over a raw byte stream (dtype-agnostic, like the author code)."""
    lib = _load()
    src = np.frombuffer(buf, np.uint8)
    n = src.size
    out = np.empty(lib.spdp_bound(n), np.uint8)
    written = lib.spdp_compress(
        src.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p), level)
    if written == ctypes.c_size_t(-1).value:
        raise RuntimeError("spdp_compress failed")
    return out[:written].tobytes()


def spdp_decompress(comp, n: int, level: int = 5,
                    out: np.ndarray | None = None) -> np.ndarray:
    lib = _load()
    if isinstance(comp, np.ndarray):
        buf, clen = comp, comp.size
    else:
        buf, clen = np.frombuffer(comp, np.uint8), len(comp)
    if out is None:
        out = np.empty(n, np.uint8)
    got = lib.spdp_decompress(
        buf.ctypes.data_as(ctypes.c_void_p), clen,
        out.ctypes.data_as(ctypes.c_void_p), n, level)
    if got != n:
        raise RuntimeError("spdp_decompress failed")
    return out
