"""Chunked streaming I/O, the port's own copy of ``ndzip_tpu/io.py`` — the
analog of the reference io library (src/io/io.hh:23-67): fixed-size chunk reads for raw data
(``read_exact``), sliding-window reads for variable-size compressed chunks
(``read_some``), and buffered chunk writes, over either stdio or mmap.
mmap is the default for regular files (io.cc:118-246); pipes fall back to
stdio automatically.
"""

from __future__ import annotations

import io as _stdio
import mmap
import os
import sys
from typing import BinaryIO, Iterator, Optional

import numpy as np

from . import format as fmt


class InputStream:
    def read_exact(self, nbytes: int) -> Iterator[memoryview]:
        """Yield successive chunks of exactly ``nbytes`` until EOF
        (io.hh:25-28).  A trailing partial chunk raises."""
        raise NotImplementedError

    def read_some(self, nbytes: int, consumed: int) -> Optional[memoryview]:
        """Sliding window: report ``consumed`` bytes from the previous
        window, then return a new window of up to ``nbytes`` (io.hh:29-31).
        Returns None at EOF."""
        raise NotImplementedError

    def close(self):
        pass


class OutputStream:
    def write_chunk(self, data) -> None:
        raise NotImplementedError

    def close(self):
        pass


# ---------------------------------------------------------------- stdio


class StdioInputStream(InputStream):
    def __init__(self, f: BinaryIO):
        self.f = f
        self._buf = bytearray()

    def read_exact(self, nbytes):
        while True:
            chunk = self.f.read(nbytes)
            if not chunk:
                return
            if len(chunk) < nbytes:
                # keep pulling; pipes may return short reads
                chunk = bytearray(chunk)
                while len(chunk) < nbytes:
                    more = self.f.read(nbytes - len(chunk))
                    if not more:
                        raise IOError(f"unexpected end of input: got {len(chunk)} of {nbytes} bytes")
                    chunk += more
            yield memoryview(bytes(chunk))

    def read_some(self, nbytes, consumed):
        del self._buf[:consumed]
        while len(self._buf) < nbytes:
            more = self.f.read(nbytes - len(self._buf))
            if not more:
                break
            self._buf += more
        if not self._buf:
            return None
        return memoryview(bytes(self._buf))

    def close(self):
        if self.f not in (sys.stdin.buffer,):
            self.f.close()


class StdioOutputStream(OutputStream):
    def __init__(self, f: BinaryIO):
        self.f = f

    def write_chunk(self, data):
        self.f.write(bytes(memoryview(data).cast("B")))

    def close(self):
        self.f.flush()
        if self.f not in (sys.stdout.buffer,):
            self.f.close()


# ---------------------------------------------------------------- mmap


class MmapInputStream(InputStream):
    """Memory-mapped input (io.cc:118-176); zero-copy chunk views."""

    def __init__(self, path: str):
        self._file = open(path, "rb")
        size = os.fstat(self._file.fileno()).st_size
        self._mm = mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ) if size else None
        self._pos = 0
        self._size = size

    def read_exact(self, nbytes):
        while self._pos + nbytes <= self._size:
            yield memoryview(self._mm)[self._pos : self._pos + nbytes]
            self._pos += nbytes
        if self._pos != self._size:
            raise IOError(
                f"unexpected end of input: trailing {self._size - self._pos} bytes "
                f"are not a whole {nbytes}-byte chunk")

    def read_some(self, nbytes, consumed):
        self._pos += consumed
        if self._pos >= self._size:
            return None
        end = min(self._pos + nbytes, self._size)
        return memoryview(self._mm)[self._pos : end]

    def close(self):
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # numpy views of the map are still alive; drop our handle and
                # let the GC unmap once the last view dies
                pass
            self._mm = None
        self._file.close()


class MmapOutputStream(OutputStream):
    """ftruncate-grow output mapping (io.cc:178-246): the file is grown by
    ``max_chunk_size`` with ftruncate, mapped MAP_SHARED, the chunk written
    into the map, and the file truncated back to the committed size on
    commit — so variable-size compressed chunks never over-allocate and the
    final file length is exact without a second pass.

    ``get_write_buffer``/``commit_chunk`` mirror the reference's zero-copy
    protocol (io.cc:199-211); the returned view is invalidated by
    ``commit_chunk`` (callers must release it first, as in C++ where the
    pointer dangles after the munmap).  ``write_chunk`` wraps the pair."""

    def __init__(self, path: str):
        self._fd = os.open(path, os.O_RDWR | os.O_TRUNC | os.O_CREAT, 0o666)
        self._size = 0       # committed bytes (io.cc:216)
        self._capacity = 0   # current ftruncate'd capacity (io.cc:217)
        self._map: Optional[mmap.mmap] = None

    def _unmap_if_mapped(self):
        if self._map is not None:
            self._map.close()  # munmap (io.cc:220-225)
            self._map = None

    def _truncate(self, new_capacity: int):
        self._unmap_if_mapped()
        os.ftruncate(self._fd, new_capacity)  # io.cc:227-231
        self._capacity = new_capacity

    def get_write_buffer(self, max_chunk_size: int) -> memoryview:
        # grow whenever the unmapped-or-remaining capacity cannot hold the
        # request (io.cc:199-211 grows on every call, not only the first)
        if self._map is None or self._capacity - self._size < max_chunk_size:
            self._truncate(self._size + max_chunk_size)
            self._map = mmap.mmap(self._fd, self._capacity,
                                  access=mmap.ACCESS_WRITE)  # io.cc:233-241
        return memoryview(self._map)[self._size:]

    def commit_chunk(self, length: int) -> None:
        self._unmap_if_mapped()
        self._size += length
        self._truncate(self._size)

    def write_chunk(self, data):
        view = memoryview(data).cast("B")
        if not len(view):
            return
        buf = self.get_write_buffer(len(view))
        buf[: len(view)] = view
        buf.release()
        self.commit_chunk(len(view))

    def close(self):
        self._unmap_if_mapped()
        os.ftruncate(self._fd, self._size)
        os.close(self._fd)


# ---------------------------------------------------------------- factory


def open_input(path: Optional[str], use_mmap: bool = True) -> InputStream:
    if path is None or path == "-":
        return StdioInputStream(sys.stdin.buffer)
    if use_mmap:
        try:
            return MmapInputStream(path)
        except (OSError, ValueError):
            pass
    return StdioInputStream(open(path, "rb"))


def open_output(path: Optional[str], use_mmap: bool = True) -> OutputStream:
    if path is None or path == "-":
        return StdioOutputStream(sys.stdout.buffer)
    return MmapOutputStream(path) if use_mmap else StdioOutputStream(open(path, "wb"))


# ------------------------------------------------- compressed-chunk parsing


def compressed_chunk_bytes(window: memoryview, shape, dtype) -> int:
    """Number of bytes the compressed chunk at the start of ``window``
    occupies (header + bodies + border) — lets the CLI advance through
    multi-chunk files of variable-size compressed chunks
    (compress.cc:59-86)."""
    shape = tuple(shape)
    wb = fmt.word_bits_for_dtype(dtype)
    num_hc = fmt.num_hypercubes(shape)
    if num_hc:
        header = np.frombuffer(window[: 4 * num_hc], dtype=np.uint32)
        body_words = int(header[num_hc - 1])
    else:
        body_words = 0
    total_words = fmt.header_words(num_hc, wb) + body_words + fmt.border_element_count(shape)
    return total_words * (wb // 8)
