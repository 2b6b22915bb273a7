"""Benchmark harness of the port, after the reference's benchmark driver
(``src/benchmark/benchmark.cc``): the port's own copy of
``ndzip_tpu/benchmark.py``, with the same names, flags and CSV.

The measurement protocol is the reference's:

* Dataset registry: CSV lines ``name;float|double;d0 [d1 [d2]]`` naming raw
  little-endian ``.f32``/``.f64`` dumps relative to the CSV's directory
  (benchmark.cc:102-125, docs/benchmarking.md:20-34). ``--synthetic``
  generates the BASELINE.json config set instead, into the directory that
  ``NDZIP_TORCH_BENCH_DIR`` names (default ``ndzip_torch_bench`` under
  ``tempfile.gettempdir()``, so ``TMPDIR`` applies).
* Repetition protocol: one warm-up rep, then reps until the accumulated
  time reaches ``--min-time`` (default 1 s), at least ``--min-reps``, at
  most ``--max-reps`` = 100 (benchmark.cc:128-136,193-228).
* Cache trashing between host-codec reps: a 256 MiB buffer walk so CPU
  timings aren't flattered by residency (benchmark.cc:147-156).
* Device timing for ``ndzip-cuda``: each rep is the device time of one
  ``codec_cuda.compress_device`` or ``decompress_device`` between two CUDA
  events, its launches queued behind a spin kernel so that the events hold
  the device's time alone (``utils.event_time_ms(fn, queued=True)``, as
  ``api.Offloader.measure`` does): the reference's ``kernel_duration``
  (benchmark.cc:331-341). The data is copied to the card once, outside the
  timing; transfers are not timed.
* Correctness gate: every algorithm round-trips and the output is compared
  bit-exactly against the input on every benchmark run
  (benchmark.cc:263-265,346).
* Output CSV: ``dataset;data type;dimensions;algorithm;tunable;number of
  threads;compression times (microseconds);decompression times
  (microseconds);uncompressed bytes;compressed bytes`` with comma-joined
  rep lists (benchmark.cc:1332-1337), which the reference's
  plot_benchmark.py and ``python -m ndzip_tpu_torch.plot_benchmark`` read.

The algorithms: memcpy and memcpy-mt, the standard library's byte codecs
(deflate, lzma, bzip2) and zstd where installed, the native competitors of
``competitors.py`` (fpc, pfpc, spdp, lz4, mpc, gfc, cascaded), the fpzip,
zfp and blosc2 wrappers that activate where those packages are installed,
``ndzip-golden``/``ndzip-cpu``/``ndzip-torch`` over the port's ``api``
(host-timed; ``torch`` is the plain PyTorch path on the CPU) and
``ndzip-cuda`` (the kernels, device-timed; it needs a GPU and never falls
back to the CPU).

The JAX package's ``chained_device_times`` (N codec calls chained in one
jitted loop, the slope of two chain lengths) has no counterpart here: CUDA
events time one call on the device, and ``api.Offloader.measure`` uses them.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import format as fmt

#: the environment variable naming the directory of ``--synthetic``'s data
BENCH_DIR_ENV = "NDZIP_TORCH_BENCH_DIR"
#: the directory under ``tempfile.gettempdir()`` used where that variable is unset
BENCH_DIR_NAME = "ndzip_torch_bench"


def bench_dir() -> Path:
    """The directory of ``--synthetic``'s data: ``NDZIP_TORCH_BENCH_DIR`` where
    it is set, else ``BENCH_DIR_NAME`` in the temporary directory."""
    return Path(os.environ.get(BENCH_DIR_ENV) or Path(tempfile.gettempdir()) / BENCH_DIR_NAME)


MAX_REPS_DEFAULT = 100
CACHE_TRASH_BYTES = 256 * 1024 * 1024  # benchmark.cc:147


@dataclass
class Dataset:
    name: str
    path: Path
    dtype: np.dtype
    shape: tuple

    def load(self) -> np.ndarray:
        data = np.fromfile(self.path, dtype=self.dtype)
        n = int(np.prod(self.shape))
        if data.size != n:
            raise ValueError(
                f"{self.path}: has {data.size} elements, metadata says {n}")
        return data.reshape(self.shape)


def read_dataset_registry(csv_path: Path) -> list[Dataset]:
    """Parse the reference's metadata CSV (benchmark.cc:102-125)."""
    out = []
    base = csv_path.parent
    for line in csv_path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(";")]
        if len(parts) != 3:
            raise ValueError(f"malformed dataset line: {line!r}")
        name, typ, dims_s = parts
        dtype = np.dtype(np.float32 if typ == "float" else np.float64)
        if typ not in ("float", "double"):
            raise ValueError(f"bad data type {typ!r} in line {line!r}")
        shape = tuple(int(x) for x in dims_s.split())
        out.append(Dataset(name, base / name, dtype, shape))
    return out


def make_synthetic(tmpdir: Path) -> list[Dataset]:
    """Generate the BASELINE.json benchmark configs as raw dumps.  Each
    family mimics a reference-suite data class: a smooth 1D signal, a
    CESM-like 2D field smooth along BOTH axes, a 3D scalar field, an fp64
    random walk (the FPC/GFC home turf), and a mostly-zero 3D field
    (exercises zero-word elimination).  Each dataset draws from its own
    seeded rng so content is deterministic regardless of which files
    already exist on disk."""

    def smooth1d(shape, dt, rng):
        t = np.arange(shape[0], dtype=np.float64) * 1e-4
        return (np.sin(t) + 0.001 * rng.standard_normal(shape[0])).astype(dt)

    def field2d(shape, dt, rng):
        y = np.linspace(0, 11.0, shape[0])[:, None]
        x = np.linspace(0, 7.0, shape[1])[None, :]
        f = (np.sin(y) * np.cos(x) + 0.3 * np.sin(3.1 * y + 0.5 * x)
             + 0.002 * rng.standard_normal(shape))
        return f.astype(dt)

    def field3d(shape, dt, rng):
        z = np.linspace(0, 5.0, shape[0])[:, None, None]
        y = np.linspace(0, 4.0, shape[1])[None, :, None]
        x = np.linspace(0, 6.0, shape[2])[None, None, :]
        f = (np.sin(z) * np.sin(y) * np.cos(x)
             + 0.2 * np.cos(2.7 * z * y * 0.1 + x)
             + 0.002 * rng.standard_normal(shape))
        return f.astype(dt)

    def walk1d(shape, dt, rng):
        return np.cumsum(rng.standard_normal(shape[0]) * 1e-3).astype(dt)

    def sparse3d(shape, dt, rng):
        f = field3d(shape, np.float64, rng)
        mask = rng.random(shape) < 0.05
        return (f * mask).astype(dt)

    specs = [
        ("sin1d.f32", np.float32, (2**24,), smooth1d),
        ("grid2d.f32", np.float32, (1800, 3600), field2d),
        ("cube3d.f64", np.float64, (256, 256, 256), field3d),
        ("walk1d.f64", np.float64, (2**23,), walk1d),
        ("sparse3d.f32", np.float32, (128, 128, 256), sparse3d),
    ]
    tmpdir.mkdir(parents=True, exist_ok=True)
    sets = []
    for i, (name, dt, shape, gen) in enumerate(specs):
        path = tmpdir / name
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        if not path.exists() or path.stat().st_size != nbytes:
            gen(shape, dt, np.random.default_rng(i)).tofile(path)
        sets.append(Dataset(name, path, np.dtype(dt), shape))
    return sets


# ------------------------------------------------------------------ timing


class _CacheTrasher:
    """Touch 256 MiB between reps so host timings include cold cache
    effects (benchmark.cc:147-156)."""

    def __init__(self):
        self._buf = None

    def trash(self):
        if self._buf is None:
            self._buf = np.ones(CACHE_TRASH_BYTES // 8, dtype=np.int64)
        self._buf += 1


_TRASHER = _CacheTrasher()


def _rep_loop(fn, min_time: float, min_reps: int, max_reps: int,
              trash_cache: bool) -> list[float]:
    """Reference rep protocol (benchmark.cc:193-228): warm-up + timed reps."""
    fn()  # warm-up (also triggers any jit compile)
    times = []
    total = 0.0
    while len(times) < max_reps and (total < min_time or len(times) < min_reps):
        if trash_cache:
            _TRASHER.trash()
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
    return times


# ------------------------------------------------------------------ algorithms


@dataclass
class BenchResult:
    algorithm: str
    tunable: int
    threads: int
    comp_times: list[float]
    decomp_times: list[float]
    uncompressed_bytes: int
    compressed_bytes: int


class Algorithm:
    name = "?"
    tunables = (1,)
    threaded = False  # True: sweep the -T thread list (parallel algorithms)

    def available(self, dataset: Dataset) -> bool:
        return True

    def run(self, data: np.ndarray, tunable: int, threads: int,
            min_time: float, min_reps: int, max_reps: int) -> BenchResult:
        raise NotImplementedError


class _ByteCodecAlgorithm(Algorithm):
    """Generic byte-stream compressor benched on the raw array bytes."""

    trash_cache = True

    def _compress(self, buf: bytes, tunable: int) -> bytes:
        raise NotImplementedError

    def _decompress(self, comp: bytes, out_len: int) -> bytes:
        raise NotImplementedError

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        buf = data.tobytes()
        comp = self._compress(buf, tunable)
        out = self._decompress(comp, len(buf))
        assert out == buf, f"{self.name}: round-trip failed"
        comp_times = _rep_loop(lambda: self._compress(buf, tunable),
                               min_time, min_reps, max_reps, self.trash_cache)
        decomp_times = _rep_loop(lambda: self._decompress(comp, len(buf)),
                                 min_time, min_reps, max_reps, self.trash_cache)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, len(buf), len(comp))


class MemcpyAlgorithm(Algorithm):
    """Upper-bound baseline (benchmark.cc memcpy integration)."""

    name = "memcpy"

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        src = np.frombuffer(data.tobytes(), dtype=np.uint8)
        dst = np.empty_like(src)

        def do():
            np.copyto(dst, src)

        do()
        assert dst.tobytes() == src.tobytes()
        comp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, src.nbytes, src.nbytes)


class MemcpyMtAlgorithm(Algorithm):
    """Threaded memcpy baseline (benchmark.cc "memcpy-mt"): the DRAM
    bandwidth ceiling with -T threads.  np.copyto on large slices releases
    the GIL, so plain Python threads scale the copy."""

    name = "memcpy-mt"
    threaded = True

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import threading

        src = np.frombuffer(data.tobytes(), dtype=np.uint8)
        dst = np.empty_like(src)
        t = max(1, threads)
        cuts = [src.nbytes * i // t for i in range(t + 1)]

        def do():
            ts = [threading.Thread(
                target=np.copyto,
                args=(dst[cuts[i]:cuts[i + 1]], src[cuts[i]:cuts[i + 1]]))
                for i in range(t)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()

        do()
        assert dst.tobytes() == src.tobytes()
        comp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, t, comp_times,
                           decomp_times, src.nbytes, src.nbytes)


class ZlibAlgorithm(_ByteCodecAlgorithm):
    name = "deflate"
    tunables = (1, 9)

    def _compress(self, buf, tunable):
        import zlib

        return zlib.compress(buf, tunable)

    def _decompress(self, comp, out_len):
        import zlib

        return zlib.decompress(comp)


class LzmaAlgorithm(_ByteCodecAlgorithm):
    name = "lzma"
    tunables = (1,)

    def _compress(self, buf, tunable):
        import lzma

        return lzma.compress(buf, preset=tunable)

    def _decompress(self, comp, out_len):
        import lzma

        return lzma.decompress(comp)


class Bz2Algorithm(_ByteCodecAlgorithm):
    name = "bzip2"
    tunables = (1,)

    def _compress(self, buf, tunable):
        import bz2

        return bz2.compress(buf, tunable)

    def _decompress(self, comp, out_len):
        import bz2

        return bz2.decompress(comp)


class ZstdAlgorithm(_ByteCodecAlgorithm):
    name = "zstd"
    tunables = (1, 19)

    def available(self, dataset):
        try:
            import zstandard  # noqa: F401

            return True
        except ImportError:
            return False

    def _compress(self, buf, tunable):
        import zstandard

        return zstandard.ZstdCompressor(level=tunable).compress(buf)

    def _decompress(self, comp, out_len):
        import zstandard

        return zstandard.ZstdDecompressor().decompress(comp, max_output_size=out_len)


class FpcAlgorithm(Algorithm):
    """FPC double-precision predictive compressor (native C++
    reimplementation, native/competitors.cc) — the first of the
    reference's domain-compressor competitors (benchmark.cc:1196-1253
    "fpc").  Tunable = log2 of the predictor table entries, matching the
    FPC level sweep (the reference benches its default level)."""

    name = "fpc"
    tunables = (16,)

    def available(self, dataset):
        if np.dtype(dataset.dtype) != np.float64:
            return False  # FPC is a double-precision algorithm
        from . import competitors

        return competitors.fpc_available()

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.fpc_compress(flat, tunable)
        out = competitors.fpc_decompress(comp, flat.size, tunable)
        assert np.array_equal(out.view(np.uint64), flat.view(np.uint64)), \
            "fpc: round-trip failed"
        # pad + allocate outside the rep loop: only the codec is timed
        padded, dst = competitors.pad_stream(comp), np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.fpc_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.fpc_decompress(padded, flat.size, tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class PfpcAlgorithm(Algorithm):
    """pFPC: chunk-parallel FPC over std::thread (native/competitors.cc),
    following the pFPC design vendored by the reference (benchmark.cc
    "pfpc").  Sweeps the -T thread list like ndzip-cpu; tunable = log2
    predictor table entries, as for fpc."""

    name = "pfpc"
    tunables = (16,)
    threaded = True

    def available(self, dataset):
        if np.dtype(dataset.dtype) != np.float64:
            return False  # FPC is a double-precision algorithm
        from . import competitors

        return competitors.fpc_available()

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.pfpc_compress(flat, tunable, threads)
        out = competitors.pfpc_decompress(comp, flat.size, tunable)
        assert np.array_equal(out.view(np.uint64), flat.view(np.uint64)), \
            "pfpc: round-trip failed"
        padded, dst = competitors.pad_stream(comp), np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.pfpc_compress(flat, tunable, threads),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.pfpc_decompress(padded, flat.size, tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class CascadedAlgorithm(Algorithm):
    """Cascaded RLE/delta/bit-pack scheme (nvCOMP Cascaded), serial CPU
    reimplementation (native/competitors.cc; reference: benchmark.cc
    "nvcomp-cascaded").  Tunable 0 auto-tunes the (R, D, bp) grid like
    the reference's selector; 101 is nvCOMP's non-auto default."""

    name = "cascaded"
    tunables = (0,)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.cascaded_compress(flat, tunable)
        out = competitors.cascaded_decompress(comp, flat.size, flat.dtype)
        wdt = np.uint64 if flat.dtype == np.float64 else np.uint32
        assert np.array_equal(out.view(wdt), flat.view(wdt)), \
            "cascaded: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.cascaded_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.cascaded_decompress(cbuf, flat.size,
                                                    flat.dtype, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class GfcAlgorithm(Algorithm):
    """GFC double compressor, serial CPU reimplementation of the CUDA
    competitor (native/competitors.cc; reference: benchmark.cc "gfc").
    Double-precision only; tunable = dimensionality (default 1)."""

    name = "gfc"
    tunables = (1,)

    def available(self, dataset):
        if np.dtype(dataset.dtype) != np.float64:
            return False  # GFC is a double-precision algorithm
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.gfc_compress(flat, tunable)
        out = competitors.gfc_decompress(comp, flat.size, tunable)
        assert np.array_equal(out.view(np.uint64), flat.view(np.uint64)), \
            "gfc: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.gfc_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.gfc_decompress(cbuf, flat.size, tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class MpcAlgorithm(Algorithm):
    """MPC massively-parallel compressor pipeline, serial CPU
    reimplementation (native/competitors.cc; reference: benchmark.cc
    "mpc", a CUDA competitor run at dimensionality 1).  Handles fp32 and
    fp64; tunable = the dim-stride (the reference benches dim=1)."""

    name = "mpc"
    tunables = (1,)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.mpc_compress(flat, tunable)
        out = competitors.mpc_decompress(comp, flat.size, flat.dtype, tunable)
        wdt = np.uint64 if flat.dtype == np.float64 else np.uint32
        assert np.array_equal(out.view(wdt), flat.view(wdt)), \
            "mpc: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint32)
        dst = np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.mpc_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.mpc_decompress(cbuf, flat.size, flat.dtype,
                                               tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class Lz4Algorithm(Algorithm):
    """LZ4 block format (own native implementation, native/competitors.cc;
    reference: benchmark.cc "lz4" and "nvcomp:lz4"; no LZ4 library is
    assumed to be installed)."""

    name = "lz4"
    tunables = (1,)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        buf = data.tobytes()
        comp = competitors.lz4_compress(buf)
        out = competitors.lz4_decompress(comp, len(buf))
        assert out.tobytes() == buf, "lz4: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty(len(buf), np.uint8)
        comp_times = _rep_loop(
            lambda: competitors.lz4_compress(buf),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.lz4_decompress(cbuf, len(buf), dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class SpdpAlgorithm(Algorithm):
    """SPDP synthesized byte-pipeline compressor (native C++
    reimplementation, native/competitors.cc; reference: benchmark.cc
    "spdp", tunable sweep 1..9 with default 5).  Dimensionality- and
    dtype-agnostic: runs on the raw array bytes for fp32 and fp64
    alike, exactly like the author code."""

    name = "spdp"
    tunables = (1, 9)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        buf = data.tobytes()
        comp = competitors.spdp_compress(buf, tunable)
        out = competitors.spdp_decompress(comp, len(buf), tunable)
        assert out.tobytes() == buf, "spdp: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty(len(buf), np.uint8)
        comp_times = _rep_loop(
            lambda: competitors.spdp_compress(buf, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.spdp_decompress(cbuf, len(buf), tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class FpzipAlgorithm(Algorithm):
    """fpzip via the pip package, when installed (available() probes the
    import and skips otherwise; reference: benchmark.cc "fpzip")."""

    name = "fpzip"

    def available(self, dataset):
        try:
            import fpzip  # noqa: F401

            return True
        except ImportError:
            return False

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import fpzip

        comp = fpzip.compress(data, precision=0)
        out = fpzip.decompress(comp)[tuple(slice(0, s) for s in data.shape)]
        assert np.array_equal(out.reshape(data.shape).view(np.uint8),
                              data.view(np.uint8)), "fpzip: round-trip failed"
        comp_times = _rep_loop(lambda: fpzip.compress(data, precision=0),
                               min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(lambda: fpzip.decompress(comp),
                                 min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class ZfpAlgorithm(Algorithm):
    """zfp lossless via zfpy, when installed (reference: benchmark.cc
    "zfp")."""

    name = "zfp"

    def available(self, dataset):
        try:
            import zfpy  # noqa: F401

            return True
        except ImportError:
            return False

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import zfpy

        comp = zfpy.compress_numpy(data)
        out = zfpy.decompress_numpy(comp)
        assert np.array_equal(out.view(np.uint8), data.view(np.uint8)), \
            "zfp: round-trip failed"
        comp_times = _rep_loop(lambda: zfpy.compress_numpy(data),
                               min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(lambda: zfpy.decompress_numpy(comp),
                                 min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class Blosc2Algorithm(_ByteCodecAlgorithm):
    """blosc2 (shuffle + lz4/zstd), when installed."""

    name = "blosc2"
    tunables = (5,)

    def available(self, dataset):
        try:
            import blosc2  # noqa: F401

            self._typesize = np.dtype(dataset.dtype).itemsize
            return True
        except ImportError:
            return False

    def _compress(self, buf, tunable):
        import blosc2

        return blosc2.compress(buf, typesize=getattr(self, "_typesize", 8),
                               clevel=tunable)

    def _decompress(self, comp, out_len):
        import blosc2

        return blosc2.decompress(comp)




class NdzipHostAlgorithm(Algorithm):
    """ndzip host backends over the port's ``api``: golden (numpy), cpu
    (native C++, 1..N threads), torch (the plain PyTorch path on the CPU);
    host-timed."""

    def __init__(self, backend: str):
        self.backend = backend
        self.name = f"ndzip-{backend}"
        self.threaded = backend == "cpu"

    def available(self, dataset):
        if self.backend == "cpu":
            from . import native

            return native.available()
        return True

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import api

        comp = api.make_compressor(data.dtype, data.ndim, self.backend, threads)
        dec = api.make_decompressor(data.dtype, data.ndim, self.backend, threads)
        stream, words = comp.compress(data)
        out = dec.decompress(stream, data.shape)
        assert np.array_equal(
            out.view(np.uint8).reshape(-1), data.view(np.uint8).reshape(-1)), \
            f"{self.name}: round-trip failed"
        comp_times = _rep_loop(lambda: comp.compress(data),
                               min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(lambda: dec.decompress(stream, data.shape),
                                 min_time, min_reps, max_reps, True)
        word_bytes = fmt.word_bits_for_dtype(data.dtype) // 8
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, words * word_bytes)


def _device_rep_loop(fn, min_time: float, min_reps: int, max_reps: int) -> list[float]:
    """``_rep_loop`` on the card's clock: the same warm-up and stopping
    rule, but each rep is the device time of one ``fn()`` in seconds, from
    ``utils.event_time_ms(fn, queued=True)``. Where that runs ``fn`` again
    behind a longer spin, the rep is its final reading alone."""
    import torch

    from . import utils

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    total = 0.0
    while len(times) < max_reps and (total < min_time or len(times) < min_reps):
        dt = utils.event_time_ms(fn, queued=True)[1] / 1e3
        times.append(dt)
        total += dt
    return times


class NdzipCudaAlgorithm(Algorithm):
    """ndzip on the card through the CUDA kernels of ``codec_cuda``,
    device-timed (``_device_rep_loop``): the counterpart of the JAX
    package's ``ndzip-tpu``. The data goes to ``cuda:0`` once, outside the
    timing, and the stream is sliced to its length once; the decompress
    allocates its output inside the timing, as the API does. Without a GPU
    it is unavailable and ``run`` raises: it never runs the plain versions."""

    name = "ndzip-cuda"

    def available(self, dataset):
        import torch

        return torch.cuda.is_available()

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import torch

        from . import codec_cuda, interop

        if not torch.cuda.is_available():
            raise RuntimeError("ndzip-cuda needs an NVIDIA GPU: torch.cuda.is_available() is false")
        shape = tuple(data.shape)
        x = interop.words_from_numpy(data, "cuda:0")
        torch.cuda.synchronize()
        stream, length = codec_cuda.compress_device(x)
        length = int(length)
        s = stream[:length]
        # correctness gate: bit-exact round trip (benchmark.cc:263-265)
        out = codec_cuda.decompress_device(s, shape, x.dtype)
        if not torch.equal(out, x):
            raise RuntimeError(f"{self.name}: round-trip failed")
        del stream, out
        comp_times = _device_rep_loop(lambda: codec_cuda.compress_device(x),
                                      min_time, min_reps, max_reps)
        decomp_times = _device_rep_loop(lambda: codec_cuda.decompress_device(s, shape, x.dtype),
                                        min_time, min_reps, max_reps)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, length * 4)


def default_algorithms() -> dict[str, Algorithm]:
    algos = [
        MemcpyAlgorithm(),
        MemcpyMtAlgorithm(),
        ZlibAlgorithm(),
        LzmaAlgorithm(),
        Bz2Algorithm(),
        ZstdAlgorithm(),
        FpcAlgorithm(),
        PfpcAlgorithm(),
        SpdpAlgorithm(),
        Lz4Algorithm(),
        MpcAlgorithm(),
        GfcAlgorithm(),
        CascadedAlgorithm(),
        FpzipAlgorithm(),
        ZfpAlgorithm(),
        Blosc2Algorithm(),
        NdzipHostAlgorithm("golden"),
        NdzipHostAlgorithm("cpu"),
        NdzipHostAlgorithm("torch"),
        NdzipCudaAlgorithm(),
    ]
    return {a.name: a for a in algos}


# ------------------------------------------------------------------ driver


CSV_HEADER = ("dataset;data type;dimensions;algorithm;tunable;"
              "number of threads;compression times (microseconds);"
              "decompression times (microseconds);"
              "uncompressed bytes;compressed bytes")


def format_row(ds: Dataset, r: BenchResult) -> str:
    """benchmark.cc:1332-1337 CSV row format: `;`-separated fields, rep-time
    lists joined with `,` (benchmark.cc:1335) so the reference's
    plot_benchmark.py parses this CSV unchanged (and vice versa)."""
    fmt_times = lambda ts: ",".join(str(round(t * 1e6)) for t in ts)
    typ = "float" if ds.dtype == np.float32 else "double"
    return ";".join([
        ds.name, typ, str(len(ds.shape)), r.algorithm, str(r.tunable),
        str(r.threads), fmt_times(r.comp_times), fmt_times(r.decomp_times),
        str(r.uncompressed_bytes), str(r.compressed_bytes)])


def benchmark_file(ds: Dataset, algorithms: dict[str, Algorithm],
                   threads_list: list[int], min_time: float, min_reps: int,
                   max_reps: int, out=sys.stdout):
    data = ds.load()
    for name, algo in algorithms.items():
        if not algo.available(ds):
            print(f"# {name}: not available, skipped", file=sys.stderr)
            continue
        thread_opts = threads_list if algo.threaded else [1]
        for threads in thread_opts:
            for tunable in algo.tunables:
                try:
                    r = algo.run(data, tunable, threads, min_time,
                                 min_reps, max_reps)
                except Exception as e:  # report and continue, like the ref
                    print(f"# {name} failed on {ds.name}: {e}", file=sys.stderr)
                    continue
                print(format_row(ds, r), file=out)
                out.flush()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ndzip-torch benchmark (reference: src/benchmark/benchmark.cc)")
    p.add_argument("metadata", nargs="?", help="dataset registry CSV")
    p.add_argument("--synthetic", action="store_true",
                   help="generate + bench the BASELINE.json synthetic configs")
    p.add_argument("-a", "--algorithms", nargs="*", default=None,
                   help="subset of algorithms to run")
    p.add_argument("-r", "--min-reps", type=int, default=1)
    p.add_argument("-R", "--max-reps", type=int, default=MAX_REPS_DEFAULT)
    p.add_argument("-t", "--min-time", type=float, default=1.0)
    p.add_argument("-T", "--threads", type=int, nargs="*", default=[1])
    args = p.parse_args(argv)

    if args.synthetic:
        datasets = make_synthetic(bench_dir())
    elif args.metadata:
        datasets = read_dataset_registry(Path(args.metadata))
    else:
        p.error("either a metadata CSV or --synthetic is required")

    algorithms = default_algorithms()
    if args.algorithms:
        unknown = set(args.algorithms) - set(algorithms)
        if unknown:
            p.error(f"unknown algorithms: {sorted(unknown)}; "
                    f"available: {sorted(algorithms)}")
        algorithms = {k: v for k, v in algorithms.items() if k in args.algorithms}

    print(CSV_HEADER)
    for ds in datasets:
        benchmark_file(ds, algorithms, args.threads, args.min_time,
                       args.min_reps, args.max_reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
