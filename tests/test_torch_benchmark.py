"""The port's benchmark harness (``ndzip_tpu_torch.benchmark``,
``competitors`` and ``plot_benchmark``): the cases of tests/test_benchmark.py
on the port, and the port held to the JAX package's harness exactly, on
inputs that numpy makes from a seed: the CSV header and rows, the rep
protocol's counts, the registry, the synthetic files, every competitor's
stream bytes and the tabulated summary. ``ndzip-cuda`` is unavailable
without a GPU and its ``run`` raises; on a card (marker ``cuda``) it runs on
the registry's data, its compressed bytes equal to ``ndzip-golden``'s."""

import hashlib
import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu import benchmark as ref_bm  # noqa: E402
from ndzip_tpu import competitors as ref_competitors  # noqa: E402
from ndzip_tpu import plot_benchmark as ref_pb  # noqa: E402
from ndzip_tpu_torch import benchmark as bm  # noqa: E402
from ndzip_tpu_torch import codec_cuda, competitors, golden  # noqa: E402
from ndzip_tpu_torch import plot_benchmark as pb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the environment variable naming a checkout of the reference (celerity/ndzip); the
#: two cases that run its own files skip where it is unset
REFERENCE_ENV = "NDZIP_REFERENCE_DIR"


def reference_file(*parts):
    """A file of the reference checkout, or skip the case where none is named."""
    root = os.environ.get(REFERENCE_ENV)
    if not root:
        pytest.skip(f"{REFERENCE_ENV} names no reference checkout")
    return Path(root).joinpath(*parts)

#: the columns of a CSV row apart from the two lists of rep times
FIXED_COLUMNS = [0, 1, 2, 3, 4, 5, 8, 9]


@pytest.fixture
def registry(tmp_path):
    rng = np.random.default_rng(0)
    d1 = np.sin(np.arange(4096 * 3 + 5, dtype=np.float32) * 1e-3)
    d1.tofile(tmp_path / "a.f32")
    d2 = rng.standard_normal((70, 66)).astype(np.float64)
    d2.tofile(tmp_path / "b.f64")
    meta = tmp_path / "meta.csv"
    meta.write_text("a.f32;float;12293\nb.f64;double;70 66\n")
    return meta


@pytest.fixture
def built():
    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def synthetic_dirs(tmp_path_factory):
    """The five synthetic datasets, made once by each package."""
    base = tmp_path_factory.mktemp("synthetic")
    return bm.make_synthetic(base / "port"), ref_bm.make_synthetic(base / "ref")


def run_rows(module, datasets, names, min_reps=1, max_reps=2):
    algos = {k: v for k, v in module.default_algorithms().items() if k in names}
    out = io.StringIO()
    for ds in datasets:
        module.benchmark_file(ds, algos, [1], min_time=0.0, min_reps=min_reps, max_reps=max_reps, out=out)
    return [line.split(";") for line in out.getvalue().strip().splitlines()]


# ------------------------------------------------------------------ the cases of tests/test_benchmark.py


def test_registry_parse(registry):
    sets = bm.read_dataset_registry(registry)
    assert [d.name for d in sets] == ["a.f32", "b.f64"]
    assert sets[0].dtype == np.float32 and sets[0].shape == (12293,)
    assert sets[1].dtype == np.float64 and sets[1].shape == (70, 66)
    data = sets[1].load()
    assert data.shape == (70, 66)


def test_registry_rejects_bad_lines(tmp_path):
    meta = tmp_path / "meta.csv"
    meta.write_text("a.f32;float\n")
    with pytest.raises(ValueError):
        bm.read_dataset_registry(meta)
    meta.write_text("a.f32;quad;16\n")
    with pytest.raises(ValueError):
        bm.read_dataset_registry(meta)


def test_rep_protocol_counts():
    calls = []
    times = bm._rep_loop(lambda: calls.append(1), min_time=0.0,
                         min_reps=3, max_reps=10, trash_cache=False)
    # warm-up + min_reps timed reps
    assert len(times) == 3 and len(calls) == 4

    times = bm._rep_loop(lambda: None, min_time=1e9, min_reps=1,
                         max_reps=5, trash_cache=False)
    assert len(times) == 5  # max_reps cap


def test_benchmark_file_round_trips_and_formats(registry):
    rows = run_rows(bm, bm.read_dataset_registry(registry), ("memcpy", "deflate", "ndzip-golden"))
    # memcpy + deflate x2 tunables + golden, per dataset
    assert len(rows) == 8
    assert rows[0][:3] == ["a.f32", "float", "1"]


def test_plot_tool_reads_harness_output(registry):
    sets = bm.read_dataset_registry(registry)
    algos = {k: v for k, v in bm.default_algorithms().items()
             if k in ("memcpy", "ndzip-golden")}
    out = io.StringIO()
    out.write(bm.CSV_HEADER + "\n")
    for ds in sets:
        bm.benchmark_file(ds, algos, [1], min_time=0.0, min_reps=2,
                          max_reps=3, out=out)
    out.seek(0)
    rows = pb.read_rows(out)
    assert len(rows) == 4
    assert all(len(r.comp_times) >= 2 for r in rows)
    table = pb.summarize(rows)
    assert len(table) == 2
    gold = [t for t in table if t[0].startswith("ndzip-golden")][0]
    assert 0.0 < gold[2] < 1.0  # compression ratio
    buf = io.StringIO()
    pb.print_table(table, out=buf)
    assert "ndzip-golden" in buf.getvalue()


def test_reference_plot_script_parses_harness_csv(registry, tmp_path):
    """The reference's own plot_benchmark.py, run headless as a subprocess,
    parses this harness's CSV and prints its throughput/ratio tables
    (benchmark.cc:1335: comma-joined rep lists in ;-separated columns)."""
    ref = reference_file("src", "benchmark", "plot_benchmark.py")
    if not ref.exists():
        pytest.skip("reference checkout not mounted")
    pytest.importorskip("scipy")
    pytest.importorskip("tabulate")
    pytest.importorskip("matplotlib")

    sets = bm.read_dataset_registry(registry)
    algos = {k: v for k, v in bm.default_algorithms().items()
             if k in ("memcpy", "ndzip-golden")}
    csv_path = tmp_path / "results.csv"
    with open(csv_path, "w") as out:
        out.write(bm.CSV_HEADER + "\n")
        for ds in sets:
            bm.benchmark_file(ds, algos, [1], min_time=0.0, min_reps=2,
                              max_reps=3, out=out)
    env = dict(os.environ, MPLBACKEND="Agg")
    res = subprocess.run([sys.executable, str(ref), str(csv_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ndzip-golden" in res.stdout and "memcpy" in res.stdout
    assert "(float)" in res.stdout and "(double)" in res.stdout


def test_fpc_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(5)
    for d in (np.cumsum(rng.standard_normal(10_001)),
              np.zeros(513), rng.standard_normal(1)):
        comp = competitors.fpc_compress(d)
        out = competitors.fpc_decompress(comp, d.size)
        assert np.array_equal(out.view(np.uint64), np.ascontiguousarray(d).view(np.uint64))

    algo = bm.FpcAlgorithm()
    f32, f64 = bm.read_dataset_registry(registry)
    assert not algo.available(f32)   # FPC is double-precision only
    assert algo.available(f64)
    r = algo.run(f64.load(), 16, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_pfpc_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(6)
    data = np.cumsum(rng.standard_normal(32_003))
    serial = competitors.fpc_compress(data)
    for threads in (1, 2, 3, 7):
        comp = competitors.pfpc_compress(data, threads=threads)
        out = competitors.pfpc_decompress(comp, data.size)
        assert np.array_equal(out.view(np.uint64), data.view(np.uint64))
        # chunking costs a little ratio against serial FPC, never an order
        assert len(comp) < len(serial) * 1.1 + 64
    for d in (np.zeros(513), rng.standard_normal(1), rng.standard_normal(0)):
        comp = competitors.pfpc_compress(d, threads=4)
        out = competitors.pfpc_decompress(comp, d.size)
        assert np.array_equal(out.view(np.uint64), np.ascontiguousarray(d).view(np.uint64))

    algo = bm.PfpcAlgorithm()
    assert algo.threaded  # sweeps the -T list like ndzip-cpu
    f32, f64 = bm.read_dataset_registry(registry)
    assert not algo.available(f32)
    assert algo.available(f64)
    r = algo.run(f64.load(), 16, 2, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.threads == 2


def test_spdp_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(7)
    cases = [
        np.sin(np.arange(10_001, dtype=np.float32) * 1e-3).tobytes(),
        np.cumsum(rng.standard_normal(9_173)).tobytes(),
        bytes(513), rng.integers(0, 256, 7, np.uint8).tobytes(), b"",
    ]
    for level in (1, 5, 9):
        for buf in cases:
            comp = competitors.spdp_compress(buf, level)
            out = competitors.spdp_decompress(comp, len(buf), level)
            assert out.tobytes() == buf

    algo = bm.SpdpAlgorithm()
    f32, f64 = bm.read_dataset_registry(registry)
    assert algo.available(f32) and algo.available(f64)
    r = algo.run(f64.load(), 5, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_lz4_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(9)
    cases = [
        b"", b"a", b"x" * 12, b"x" * 100_000, b"ab" * 70_000,
        bytes(range(256)) * 50, rng.integers(0, 256, 1 << 18, np.uint8).tobytes(),
        np.sin(np.arange(1 << 16, dtype=np.float32) * 1e-3).tobytes(),
        b"z" * (15 + 255 * 3 + 7),
    ]
    for buf in cases:
        comp = competitors.lz4_compress(buf)
        out = competitors.lz4_decompress(comp, len(buf))
        assert out.tobytes() == buf
    # a truncated stream fails cleanly
    comp = competitors.lz4_compress(b"x" * 1000)
    with pytest.raises(RuntimeError):
        competitors.lz4_decompress(comp[: len(comp) - 1], 1000)

    algo = bm.Lz4Algorithm()
    sets = bm.read_dataset_registry(registry)
    assert algo.available(sets[0]) and algo.available(sets[1])
    r = algo.run(sets[0].load(), 1, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_mpc_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(10)
    cases = [
        np.sin(np.arange(100_003, dtype=np.float32) * 1e-3),
        np.cumsum(rng.standard_normal(65_537)),
        np.zeros(1024, np.float32), rng.standard_normal(1),
        np.zeros(0, np.float64),
    ]
    for dim in (1, 2, 32):
        for d in cases:
            comp = competitors.mpc_compress(d, dim)
            out = competitors.mpc_decompress(comp, d.size, d.dtype, dim)
            wdt = np.uint64 if d.dtype == np.float64 else np.uint32
            assert np.array_equal(out.view(wdt), d.reshape(-1).view(wdt))

    algo = bm.MpcAlgorithm()
    sets = bm.read_dataset_registry(registry)
    assert algo.available(sets[0]) and algo.available(sets[1])
    for ds in sets:
        r = algo.run(ds.load(), 1, 1, min_time=0.0, min_reps=1, max_reps=2)
        assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_gfc_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(11)
    cases = [
        np.cumsum(rng.standard_normal(100_003)),
        np.zeros(1024), rng.standard_normal(1), np.zeros(0),
        -np.abs(np.cumsum(rng.standard_normal(5000))),
        np.array([np.nan, np.inf, -np.inf, -0.0, 5e-324]),
    ]
    for dim in (1, 3, 32):
        for d in cases:
            comp = competitors.gfc_compress(d, dim)
            out = competitors.gfc_decompress(comp, d.size, dim)
            assert np.array_equal(out.view(np.uint64), d.reshape(-1).view(np.uint64))

    algo = bm.GfcAlgorithm()
    f32, f64 = bm.read_dataset_registry(registry)
    assert not algo.available(f32)  # GFC is double-precision only
    assert algo.available(f64)
    r = algo.run(f64.load(), 1, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_cascaded_competitor_roundtrip(registry, built):
    rng = np.random.default_rng(12)
    cases = [
        np.sin(np.arange(50_003, dtype=np.float32) * 1e-3),
        np.cumsum(rng.standard_normal(30_011)),
        np.zeros(4096, np.float32),
        np.repeat(rng.standard_normal(100), rng.integers(1, 50, 100)).astype(np.float32),
        rng.standard_normal(1), np.zeros(0, np.float32),
    ]
    for cfg in (0, 101, 1, 111, 221):
        for d in cases:
            comp = competitors.cascaded_compress(d, cfg)
            out = competitors.cascaded_decompress(comp, d.size, d.dtype)
            wdt = np.uint64 if d.dtype == np.float64 else np.uint32
            assert np.array_equal(out.view(wdt), d.reshape(-1).view(wdt))
    # run-heavy data compresses hard; smooth float data does not
    runs = competitors.cascaded_compress(cases[3], 0)
    assert len(runs) < cases[3].nbytes * 0.2

    algo = bm.CascadedAlgorithm()
    sets = bm.read_dataset_registry(registry)
    assert algo.available(sets[0]) and algo.available(sets[1])
    for ds in sets:
        r = algo.run(ds.load(), 0, 1, min_time=0.0, min_reps=1, max_reps=2)
        assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_spdp_payload_matches_author_code(tmp_path, built):
    """The reimplementation is the same algorithm as the author code
    vendored by the reference (contrib/spdp/SPDP_11.c), compiled here as a
    test oracle: per-chunk payload sizes net of framing are equal."""
    import ctypes
    import shutil

    src = reference_file("contrib", "spdp", "SPDP_11.c")
    if not src.exists() or shutil.which("gcc") is None:
        pytest.skip("reference SPDP sources or gcc unavailable")
    drv = tmp_path / "drv.c"
    drv.write_text(
        '#include "SPDP_11.h"\n#include <stddef.h>\n'
        "size_t oc(const void *i, size_t n, void *o, int l) "
        "{ return SPDP_Compress_Memory(i, n, o, l); }\n")
    lib = tmp_path / "oracle.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-I", str(src.parent), str(drv), str(src), "-o", str(lib)],
                   check=True, capture_output=True)
    oracle = ctypes.CDLL(str(lib))
    oracle.oc.restype = ctypes.c_size_t
    oracle.oc.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int]

    rng = np.random.default_rng(8)
    cases = [
        np.sin(np.arange(50_000, dtype=np.float32) * 1e-3).tobytes(),
        np.cumsum(rng.standard_normal(20_011)).tobytes(),
        bytes(4096), rng.integers(0, 4, 100_003, np.uint8).tobytes(),
    ]
    for level in (1, 5, 9):
        for buf in cases:
            n = len(buf)
            src_arr = np.frombuffer(buf, np.uint8)
            out = np.empty(2 * n + 1024, np.uint8)
            ref_total = oracle.oc(src_arr.ctypes.data, n, out.ctypes.data, level)
            nchunks = (n + (1 << 23) - 1) >> 23
            mine = competitors.spdp_compress(buf, level)
            assert len(mine) - 4 * nchunks == ref_total - 1 - 8 * nchunks


def test_optional_pip_competitors_skip_gracefully(registry):
    """fpzip/zfp/blosc2 report whether they are available and do not raise
    when their packages are absent."""
    sets = bm.read_dataset_registry(registry)
    for algo in (bm.FpzipAlgorithm(), bm.ZfpAlgorithm(), bm.Blosc2Algorithm()):
        assert isinstance(algo.available(sets[0]), bool)


def test_csv_times_comma_joined(registry):
    """benchmark.cc:1335: rep-time lists are comma-joined, unquoted."""
    ds = bm.read_dataset_registry(registry)[0]
    r = bm.BenchResult("x", 1, 1, [1e-6, 2e-6], [3e-6], 8, 4)
    row = bm.format_row(ds, r)
    assert ";1,2;" in row and '"' not in row


def test_synthetic_generator(tmp_path):
    sets = bm.make_synthetic(tmp_path / "s")
    assert len(sets) == 5
    for ds in sets:
        n = int(np.prod(ds.shape))
        assert ds.path.stat().st_size == n * ds.dtype.itemsize
    assert {ds.dtype.name for ds in sets} == {"float32", "float64"}
    assert {len(ds.shape) for ds in sets} == {1, 2, 3}
    # deterministic whichever files already exist: delete one, make again
    victim = sets[3]
    before = victim.path.read_bytes()[:4096]
    victim.path.unlink()
    sets2 = bm.make_synthetic(tmp_path / "s")
    assert sets2[3].path.read_bytes()[:4096] == before


def test_native_competitor_decoders_survive_corruption(built):
    """Truncated and bit-flipped streams fail cleanly (RuntimeError) or
    decode to garbage, never crash."""
    rng = np.random.default_rng(13)
    f32 = np.sin(np.arange(9_173, dtype=np.float32) * 1e-3)
    f64 = np.cumsum(rng.standard_normal(7_001))

    def mutations(comp):
        yield comp[: len(comp) // 2]          # truncate
        yield comp[:7]                        # near-empty
        arr = bytearray(comp)
        for pos in rng.integers(0, len(arr), 32):
            arr[pos] ^= 0xFF
        yield bytes(arr)                      # bit flips

    codecs = [
        (competitors.spdp_compress(f32.tobytes()), lambda c: competitors.spdp_decompress(c, f32.nbytes)),
        (competitors.lz4_compress(f32.tobytes()), lambda c: competitors.lz4_decompress(c, f32.nbytes)),
        (competitors.mpc_compress(f32), lambda c: competitors.mpc_decompress(c, f32.size, np.float32)),
        (competitors.mpc_compress(f64), lambda c: competitors.mpc_decompress(c, f64.size, np.float64)),
        (competitors.gfc_compress(f64), lambda c: competitors.gfc_decompress(c, f64.size)),
        (competitors.cascaded_compress(f32), lambda c: competitors.cascaded_decompress(c, f32.size, np.float32)),
        (competitors.fpc_compress(f64), lambda c: competitors.fpc_decompress(c, f64.size)),
    ]
    for comp, dec in codecs:
        for bad in mutations(comp):
            try:
                dec(bad)
            except RuntimeError:
                pass  # a clean failure is the expected outcome


# ------------------------------------------------------------------ the port against the JAX package's harness


def test_csv_header_equals_the_reference():
    assert bm.CSV_HEADER == ref_bm.CSV_HEADER


def test_format_row_equals_the_reference(registry):
    rng = np.random.default_rng(21)
    for ds, ref_ds in zip(bm.read_dataset_registry(registry), ref_bm.read_dataset_registry(registry)):
        for _ in range(5):
            comp, dec = rng.random(int(rng.integers(1, 6))) * 1e-2, rng.random(int(rng.integers(1, 6))) * 1e-2
            args = ("ndzip-x", int(rng.integers(0, 20)), int(rng.integers(1, 9)), list(comp), list(dec),
                    int(rng.integers(1, 1 << 30)), int(rng.integers(1, 1 << 30)))
            assert bm.format_row(ds, bm.BenchResult(*args)) == ref_bm.format_row(ref_ds, ref_bm.BenchResult(*args))


@pytest.mark.parametrize("min_time,min_reps,max_reps", [(0.0, 3, 10), (1e9, 1, 5), (0.0, 0, 4), (0.0, 7, 3)])
def test_rep_loop_counts_equal_the_reference(min_time, min_reps, max_reps):
    calls, ref_calls = [], []
    times = bm._rep_loop(lambda: calls.append(1), min_time, min_reps, max_reps, False)
    ref_times = ref_bm._rep_loop(lambda: ref_calls.append(1), min_time, min_reps, max_reps, False)
    assert len(times) == len(ref_times) and len(calls) == len(ref_calls)


def test_registry_equals_the_reference(registry):
    port, ref = bm.read_dataset_registry(registry), ref_bm.read_dataset_registry(registry)
    assert [(d.name, d.path, d.dtype, d.shape) for d in port] == [(d.name, d.path, d.dtype, d.shape) for d in ref]
    for d, r in zip(port, ref):
        assert d.load().tobytes() == r.load().tobytes()


def test_synthetic_files_equal_the_reference(synthetic_dirs):
    port, ref = synthetic_dirs
    assert [(d.name, d.dtype, d.shape) for d in port] == [(d.name, d.dtype, d.shape) for d in ref]
    for d, r in zip(port, ref):
        assert hashlib.sha256(d.path.read_bytes()).hexdigest() == hashlib.sha256(r.path.read_bytes()).hexdigest()


def test_default_algorithms_are_the_reference_set_with_the_port_backends():
    ref = set(ref_bm.default_algorithms()) - {"ndzip-xla", "ndzip-tpu"}
    assert set(bm.default_algorithms()) == ref | {"ndzip-torch", "ndzip-cuda"}


def competitor_streams(mod):
    rng = np.random.default_rng(30)
    f32 = (np.sin(np.arange(20_011) * 1e-3) + 1e-4 * rng.standard_normal(20_011)).astype(np.float32)
    f64 = np.cumsum(rng.standard_normal(15_013))
    return {
        "fpc": [mod.fpc_compress(f64, level) for level in (10, 16, 20)],
        "pfpc": [mod.pfpc_compress(f64, 16, threads) for threads in (1, 3, 4)],
        "spdp": [mod.spdp_compress(buf, level) for buf in (f32.tobytes(), f64.tobytes()) for level in (1, 5, 9)],
        "lz4": [mod.lz4_compress(buf) for buf in (f32.tobytes(), f64.tobytes(), bytes(5000))],
        "mpc32": [mod.mpc_compress(f32, dim) for dim in (1, 2, 32)],
        "mpc64": [mod.mpc_compress(f64, dim) for dim in (1, 2, 32)],
        "gfc": [mod.gfc_compress(f64, dim) for dim in (1, 3, 32)],
        "cascaded": [mod.cascaded_compress(d, cfg) for d in (f32, f64) for cfg in (0, 101, 221)],
    }


@pytest.fixture(scope="module")
def both_competitor_streams():
    if not (competitors.fpc_available() and ref_competitors.fpc_available()):
        pytest.skip("no C++ toolchain for the competitor build")
    return competitor_streams(competitors), competitor_streams(ref_competitors)


@pytest.mark.parametrize("name", ["fpc", "pfpc", "spdp", "lz4", "mpc32", "mpc64", "gfc", "cascaded"])
def test_competitor_streams_equal_the_reference(both_competitor_streams, name):
    port, ref = both_competitor_streams
    assert port[name] == ref[name]


def test_competitors_build_apart_from_the_reference_library(built):
    assert competitors._LIB == ROOT / "native" / "build" / "libndzip_competitors.so"
    assert competitors._LIB.exists() and competitors._LIB != ref_competitors._LIB


def test_competitor_build_moves_a_whole_library_into_place(tmp_path, monkeypatch):
    """The build writes a temporary file and renames it, so no loader finds
    a half-written library; a failed build leaves nothing behind."""
    lib = tmp_path / "build" / "libndzip_competitors.so"
    monkeypatch.setattr(competitors, "_LIB", lib)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(competitors.CompetitorUnavailable):
        competitors._build()
    assert list(lib.parent.iterdir()) == []

    def fake_compiler(cmd, **kwargs):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"whole")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(competitors.subprocess, "run", fake_compiler)
    competitors._build()
    assert [p.name for p in lib.parent.iterdir()] == [lib.name] and lib.read_bytes() == b"whole"


def test_plot_summary_equals_the_reference():
    rng = np.random.default_rng(40)
    lines = [bm.CSV_HEADER]
    for ds in ("a.f32", "b.f64", "c.f32"):
        for algo, threads in (("memcpy", 1), ("ndzip-cpu", 1), ("ndzip-cpu", 4), ("ndzip-golden", 1)):
            comp = ",".join(str(int(t)) for t in rng.integers(1, 10_000, int(rng.integers(1, 5))))
            dec = ",".join(str(int(t)) for t in rng.integers(1, 10_000, int(rng.integers(1, 5))))
            n = int(rng.integers(1 << 10, 1 << 26))
            lines.append(";".join([ds, "float", "1", algo, "1", str(threads), comp, dec, str(n),
                                   str(int(n * rng.random()) + 1)]))
    csv = "\n".join(lines) + "\n"
    rows, ref_rows = pb.read_rows(io.StringIO(csv)), ref_pb.read_rows(io.StringIO(csv))
    table, ref_table = pb.summarize(rows), ref_pb.summarize(ref_rows)
    assert table == ref_table and len(table) == 4
    buf, ref_buf = io.StringIO(), io.StringIO()
    pb.print_table(table, out=buf)
    ref_pb.print_table(ref_table, out=ref_buf)
    assert buf.getvalue() == ref_buf.getvalue()
    assert pb.mean_ci95([1.0, 2.0, 4.0]) == ref_pb.mean_ci95([1.0, 2.0, 4.0])


def test_plot_main_prints_the_table_without_matplotlib(registry, tmp_path):
    csv_path = tmp_path / "results.csv"
    with open(csv_path, "w") as out:
        out.write(bm.CSV_HEADER + "\n")
        for ds in bm.read_dataset_registry(registry):
            bm.benchmark_file(ds, {"memcpy": bm.MemcpyAlgorithm()}, [1], 0.0, 1, 1, out=out)
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "from ndzip_tpu_torch import plot_benchmark\n"
            f"sys.exit(plot_benchmark.main([{str(csv_path)!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[0].startswith("algorithm") and "memcpy[1]x1" in res.stdout


def test_benchmark_file_rows_equal_the_reference(registry):
    """Every column but the two lists of times equals the JAX harness's, on
    memcpy, deflate, ndzip-golden and ndzip-cpu; ndzip-torch's compressed
    bytes equal ndzip-golden's."""
    names = ("memcpy", "deflate", "ndzip-golden", "ndzip-cpu")
    rows = run_rows(bm, bm.read_dataset_registry(registry), names)
    ref_rows = run_rows(ref_bm, ref_bm.read_dataset_registry(registry), names)
    assert [[r[i] for i in FIXED_COLUMNS] for r in rows] == [[r[i] for i in FIXED_COLUMNS] for r in ref_rows]
    assert len(rows) == 10 and {r[3] for r in rows} == set(names)

    torch_rows = run_rows(bm, bm.read_dataset_registry(registry), ("ndzip-torch", "ndzip-golden"))
    by = {(r[0], r[3]): r for r in torch_rows}
    for ds in ("a.f32", "b.f64"):
        assert by[ds, "ndzip-torch"][9] == by[ds, "ndzip-golden"][9]
        assert by[ds, "ndzip-torch"][8] == by[ds, "ndzip-golden"][8]


def test_main_prints_the_header_and_a_row_per_algorithm(registry):
    res = subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.benchmark", str(registry), "-a", "memcpy",
                          "ndzip-golden", "ndzip-torch", "-t", "0", "-r", "1", "-R", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0] == bm.CSV_HEADER and len(lines) == 7
    assert [line.split(";")[3] for line in lines[1:4]] == ["memcpy", "ndzip-golden", "ndzip-torch"]
    assert all(len(line.split(";")[6].split(",")) == 1 for line in lines[1:])
    table = subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.plot_benchmark"], input=res.stdout,
                           cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert table.returncode == 0 and "ndzip-torch[1]x1" in table.stdout


def test_main_synthetic_reads_its_directory_from_the_environment(monkeypatch, tmp_path, registry, capsys):
    seen = []

    def fake_synthetic(path):
        seen.append(path)
        return bm.read_dataset_registry(registry)[:1]

    monkeypatch.setattr(bm, "make_synthetic", fake_synthetic)
    monkeypatch.delenv(bm.BENCH_DIR_ENV, raising=False)
    assert bm.main(["--synthetic", "-a", "memcpy", "-t", "0", "-R", "1"]) == 0
    monkeypatch.setenv("NDZIP_TORCH_BENCH_DIR", str(tmp_path / "here"))
    assert bm.main(["--synthetic", "-a", "memcpy", "-t", "0", "-R", "1"]) == 0
    assert seen == [Path(tempfile.gettempdir()) / "ndzip_torch_bench", tmp_path / "here"]
    with pytest.raises(SystemExit):
        bm.main(["-a", "nope", "--synthetic"])


def test_ndzip_cuda_is_unavailable_and_raises_without_a_gpu(registry, no_gpu, capsys):
    algo = bm.default_algorithms()["ndzip-cuda"]
    ds = bm.read_dataset_registry(registry)[0]
    assert algo.available(ds) is False
    with pytest.raises(RuntimeError, match="GPU"):
        algo.run(ds.load(), 1, 1, 0.0, 1, 1)
    out = io.StringIO()
    bm.benchmark_file(ds, {"ndzip-cuda": algo}, [1], 0.0, 1, 1, out=out)
    assert out.getvalue() == "" and "ndzip-cuda: not available" in capsys.readouterr().err


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1], ids=["a.f32", "b.f64"])
def test_cuda_ndzip_cuda_on_the_registry(registry, cuda, index):
    ds = bm.read_dataset_registry(registry)[index]
    data = ds.load()
    for k in codec_cuda.LAUNCHES:
        codec_cuda.LAUNCHES[k] = 0
    r = bm.NdzipCudaAlgorithm().run(data, 1, 1, 0.0, 3, 5)
    suffix = ("64" if data.dtype == np.float64 else "") + ("_nd" if data.ndim > 1 else "")
    launched = {k for k, v in codec_cuda.LAUNCHES.items() if v}
    assert launched == {"encode" + suffix, "decode" + suffix}
    stream, words = golden.compress(data)
    assert r.compressed_bytes == stream.nbytes and r.uncompressed_bytes == data.nbytes
    assert len(r.comp_times) == 3 and len(r.decomp_times) == 3
    assert all(t > 0 for t in r.comp_times + r.decomp_times)


@pytest.mark.cuda
def test_cuda_benchmark_file_rows(registry, cuda):
    rows = run_rows(bm, bm.read_dataset_registry(registry), ("ndzip-golden", "ndzip-cuda"), 2, 3)
    by = {(r[0], r[3]): r for r in rows}
    assert len(rows) == 4
    for ds in ("a.f32", "b.f64"):
        assert by[ds, "ndzip-cuda"][9] == by[ds, "ndzip-golden"][9]
        assert by[ds, "ndzip-cuda"][8] == by[ds, "ndzip-golden"][8]


@pytest.mark.cuda
def test_cuda_round_trip_gate_raises(registry, cuda, monkeypatch):
    real = codec_cuda.decompress_device

    def corrupt(stream, shape, dtype=torch.float32):
        out = real(stream, shape, dtype)
        out.view(-1)[0] ^= 1
        return out

    monkeypatch.setattr(codec_cuda, "decompress_device", corrupt)
    ds = bm.read_dataset_registry(registry)[0]
    with pytest.raises(RuntimeError, match="round-trip failed"):
        bm.NdzipCudaAlgorithm().run(ds.load(), 1, 1, 0.0, 1, 1)
