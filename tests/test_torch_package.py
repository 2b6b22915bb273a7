"""The port's package as a whole: it imports no JAX, its kernel build has no
fallback, its CUDA entry points refuse CPU tensors, fp64 round-trips in
1-3 dims through the same entry points as fp32, and bad inputs raise
ValueError."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu_torch import _build, api, codec_cuda, codec_torch, interop, stages  # noqa: E402
from ndzip_tpu_torch import format as port_format  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["ndzip_tpu_torch", "ndzip_tpu_torch._build", "ndzip_tpu_torch.codec_cuda",
           "ndzip_tpu_torch.codec_torch", "ndzip_tpu_torch.interop", "ndzip_tpu_torch.ops.bitops",
           "ndzip_tpu_torch.api", "ndzip_tpu_torch.cli", "ndzip_tpu_torch.stages",
           "ndzip_tpu_torch.ubench", "ndzip_tpu_torch.utils", "ndzip_tpu_torch.warm",
           "ndzip_tpu_torch.format", "ndzip_tpu_torch.golden", "ndzip_tpu_torch.io", "ndzip_tpu_torch.native",
           "ndzip_tpu_torch.bench"]


def test_import_leaves_jax_out():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for src in (ROOT / "ndzip_tpu_torch").rglob("*.py"):
        assert "import jax" not in src.read_text(), src


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda *csrc: tmp_path / "libndzip_cuda_test.so")
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert list(tmp_path.iterdir()) == []


def test_failing_nvcc_raises_with_its_stderr(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: kernel does not compile' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path", lambda *csrc: tmp_path / "build" / "libndzip_cuda_test.so")
    with pytest.raises(RuntimeError, match="kernel does not compile"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_cuda_entry_points_refuse_cpu_tensors():
    before = dict(codec_cuda.LAUNCHES)
    x = torch.zeros(4096 * 2)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.compress_device(x)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._encode_blocks_fp32(x.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.decompress_device(torch.zeros(10, dtype=torch.int32), (4096 * 2,))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._decode_blocks_fp32(torch.zeros(10, dtype=torch.int32), 4096 * 2)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.compress_device(torch.zeros(64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._encode_interior_fp32(torch.zeros(16, 16, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.decompress_device(torch.zeros(10, dtype=torch.int32), (64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._decode_interior_fp32(torch.zeros(10, dtype=torch.int32), (16, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.compress_device(torch.zeros(4096 * 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._encode_blocks_fp64(torch.zeros(4096 * 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.decompress_device(torch.zeros(10, dtype=torch.int32), (4096 * 2,), torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._decode_blocks_fp64(torch.zeros(10, dtype=torch.int32), 4096 * 2)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._encode_interior_fp64(torch.zeros(16, 16, 16, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._decode_interior_fp64(torch.zeros(10, dtype=torch.int32), (16, 16, 16))
    assert codec_cuda.LAUNCHES == before

    stage_before = dict(stages.LAUNCHES)
    blocks = torch.zeros(2, 4096, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        stages.placement_floor(blocks)
    with pytest.raises(ValueError, match="CUDA"):
        stages.placement_compute(blocks)
    with pytest.raises(ValueError, match="CUDA"):
        stages.keep_mask(torch.ones(stages.P2_ROWS, stages.LANES, dtype=torch.int32))
    for grid in (torch.zeros(64, 64, dtype=torch.int32), torch.zeros(16, 16, 16, dtype=torch.int64)):
        with pytest.raises(ValueError, match="CUDA"):
            stages.gather_blocks_nd(grid)
        with pytest.raises(ValueError, match="CUDA"):
            stages.scatter_blocks_nd(torch.zeros(1, 4096, dtype=grid.dtype), grid)
    assert stages.LAUNCHES == stage_before


@pytest.mark.parametrize("shape", [(4096,), (64, 64), (16, 16, 16)], ids=["fp64", "2d", "3d"])
def test_fp64_round_trips_on_the_cpu(shape):
    """fp64 in 1, 2 and 3 dims, one whole block each: the plain path's stream
    is golden's, and the round trip is bit-exact."""
    data = np.random.default_rng(len(shape)).standard_normal(shape)
    x = torch.from_numpy(data)
    stream, length = nt.compress_device(x)
    assert interop.stream_to_numpy(stream, length).tobytes() == golden.compress(data)[0].tobytes()
    out = nt.decompress_device(stream[:length], shape, np.float64)
    assert out.dtype == torch.float64 and torch.equal(out.view(torch.int64), x.view(torch.int64))


def test_bad_inputs_raise_value_error():
    with pytest.raises(ValueError):
        nt.compress_device(torch.zeros(10, dtype=torch.float16))
    with pytest.raises(ValueError):
        nt.compress_device(torch.zeros(2, 2, 2, 2))
    with pytest.raises(ValueError):
        nt.compress_device(torch.zeros(2, 2, 2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        nt.decompress_device(torch.zeros(10, dtype=torch.int32), (10,), np.float16)
    with pytest.raises(ValueError):
        nt.decompress_device(torch.zeros(10, dtype=torch.int32), (2, 2, 2, 2), np.float64)
    with pytest.raises(ValueError):  # an fp64 stream of an odd number of u32 words
        nt.decompress_device(torch.zeros(4097 * 2 + 1, dtype=torch.int32), (4096,), np.float64)


HOST_CASES = [(np.float32, (4096 * 2 + 5,)), (np.float32, (130, 70)), (np.float64, (4096 + 3,)),
              (np.float64, (17, 16, 35))]
HOST_IDS = [f"{np.dtype(d).name}-{len(s)}d" for d, s in HOST_CASES]


def host_data(dtype, shape):
    return np.random.default_rng(len(shape)).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype,shape", HOST_CASES, ids=HOST_IDS)
def test_auto_backend_equals_golden_and_round_trips(monkeypatch, dtype, shape):
    """``backend="auto"`` as ``ndzip_tpu.compress``'s: the card where one
    answers, else the CPU codecs; byte for byte golden's stream and length."""
    monkeypatch.delenv(api.BACKEND_ENV, raising=False)
    data = host_data(dtype, shape)
    stream, words = nt.compress(data, backend="auto")
    ref_stream, ref_words = golden.compress(data)
    assert words == ref_words and stream.tobytes() == ref_stream.tobytes()
    out = nt.decompress(stream, shape, dtype, backend="auto")
    assert out.dtype == dtype and out.tobytes() == data.tobytes()


@pytest.mark.parametrize("backend", ["golden", "torch"])
def test_named_backend_and_its_options_reach_the_offloader(backend):
    data = host_data(np.float64, (64, 65))
    stream, words = nt.compress(data, backend, timing_mode="wall")
    assert stream.tobytes() == golden.compress(data)[0].tobytes()
    assert nt.decompress(stream, data.shape, np.float64, backend=backend).tobytes() == data.tobytes()
    with pytest.raises(TypeError):
        nt.compress(data, backend, no_such_option=1)


def test_default_backend_without_a_gpu_raises_naming_it(monkeypatch):
    """The default backend is the card's: without one the call says so, and
    does not fall back or fail inside torch."""
    if torch.cuda.is_available():
        pytest.skip("a GPU answers here")
    monkeypatch.delenv(api.BACKEND_ENV, raising=False)
    data = host_data(np.float32, (4096,))
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        nt.compress(data)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        nt.decompress(golden.compress(data)[0], data.shape, np.float32)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        nt.compress(data, device="cuda")


@pytest.mark.parametrize("backend", ["golden", "torch"])
def test_default_backend_is_the_one_the_variable_names(monkeypatch, backend):
    """NDZIP_TORCH_BACKEND names the backend of a call that names none, as in
    ``api``; the stream is golden's either way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(api.BACKEND_ENV, backend)
    data = host_data(np.float64, (17, 16, 35))
    stream, words = nt.compress(data)
    assert (stream.tobytes(), words) == (golden.compress(data)[0].tobytes(), golden.compress(data)[1])
    assert nt.decompress(stream, data.shape, np.float64).tobytes() == data.tobytes()


def test_device_runs_there_and_excludes_a_backend():
    data = host_data(np.float32, (130, 70))
    stream, words = nt.compress(data, device="cpu")
    assert (stream.tobytes(), words) == (golden.compress(data)[0].tobytes(), golden.compress(data)[1])
    assert nt.decompress(stream, data.shape, device=torch.device("cpu")).tobytes() == data.tobytes()
    for kwargs in ({"backend": "golden"}, {"backend": "auto"}, {"backend": "cuda"}, {"threads": 2}):
        with pytest.raises(ValueError, match="device"):
            nt.compress(data, device="cpu", **kwargs)
        with pytest.raises(ValueError, match="device"):
            nt.decompress(stream, data.shape, np.float32, device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["Profile", "profile_for", "compressed_bound_words", "num_hypercubes"])
def test_reexports_are_the_ports_own(name):
    from ndzip_tpu import format as ref_format

    assert nt.format is port_format and getattr(nt, name) is getattr(port_format, name)
    assert getattr(nt, name) is not getattr(ref_format, name)


@pytest.mark.parametrize("dtype,shape", HOST_CASES, ids=HOST_IDS)
def test_api_device_functions_on_the_cpu_equal_golden(dtype, shape):
    data = host_data(dtype, shape)
    x = torch.from_numpy(data)
    stream, length = api.compress_device(x)
    assert interop.stream_to_numpy(stream, length).tobytes() == golden.compress(data)[0].tobytes()
    out = api.decompress_device(stream[: int(length)], shape, x.dtype)
    assert out.dtype == x.dtype and torch.equal(codec_torch.as_words(out), codec_torch.as_words(x))


#: (shape, word bits, whether its stream's length may not fit an int32)
LENGTH_CASES = [
    ((2**31,), 32, True), ((2**31 - 4096,), 32, True), ((1024, 1024, 1024), 64, True), ((2**30,), 64, True),
    ((46341, 46341), 32, True), ((1, 1, 2**31), 32, True),
    ((512, 512, 2048), 32, False), ((2**28 + 17,), 32, False), ((512, 512, 512), 64, False),
    ((2**30,), 32, False), ((1024, 1024, 960), 64, False), ((100,), 32, False),
]


@pytest.mark.parametrize("shape,bits,too_long", LENGTH_CASES, ids=str)
def test_stream_length_that_does_not_fit_raises(shape, bits, too_long):
    """From shapes alone: a grid whose compressed bound reaches 2**31 u32
    words is refused by the one function both paths of compress_device and
    decompress_device call, and every other grid passes it."""
    assert (port_format.compressed_bound_u32(shape, bits) >= 2**31) == too_long
    if not too_long:
        codec_torch.check_stream_length(shape, bits)
        return
    with pytest.raises(ValueError, match="int32"):
        codec_torch.check_stream_length(shape, bits)
    dtype = torch.float32 if bits == 32 else torch.float64
    with pytest.raises(ValueError, match="int32"):
        codec_torch.output_dtype(shape, dtype)
    # the entry points refuse before they touch any data: a tensor without storage will do
    x = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="int32"):
        codec_torch.as_words(x)
    with pytest.raises(ValueError, match="int32"):
        nt.compress_device(x)
    with pytest.raises(ValueError, match="int32"):
        codec_cuda.compress_device(x)
    for decompress in (nt.decompress_device, codec_cuda.decompress_device):
        with pytest.raises(ValueError, match="int32"):
            decompress(torch.zeros(8, dtype=torch.int32), shape, dtype)


def _c_entry_points():
    """Every extern "C" function of csrc/*.cu: name -> the kinds of its
    arguments, ctypes.c_void_p for a pointer and ctypes.c_int64 for int64_t."""
    import ctypes
    import re

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src.read_text()):
            kinds = []
            for arg in filter(None, (a.strip() for a in args.split(","))):
                if "*" in arg:
                    kinds.append(ctypes.c_void_p)
                else:
                    assert arg.split()[0] == "int64_t", f"{src.name}: {name} takes {arg!r}: neither a pointer nor int64_t"
                    kinds.append(ctypes.c_int64)
            assert name not in found, f"{name} is defined twice"
            found[name] = kinds
    return found


def test_c_signatures_match_the_sources():
    """_build.SIGNATURES against the extern "C" functions of the sources, both
    ways: a wrong argtype cuts a pointer to 32 bits without a word."""
    found = _c_entry_points()
    assert sorted(found) == sorted(_build.SIGNATURES)
    assert len(found) >= 17


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_signature(name):
    assert _c_entry_points()[name] == _build.SIGNATURES[name]
