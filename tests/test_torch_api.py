"""The port's public API (``ndzip_tpu_torch.api``): factories, offloader,
requirements, backend resolution; the cases of tests/test_api.py that apply
to the port. Streams are held to ``golden`` byte for byte. On a card (marker
``cuda``): the Offloader's device timing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu import golden, native  # noqa: E402
from ndzip_tpu_torch import api  # noqa: E402

HOST_BACKENDS = ["golden", "cpu", "torch"]


def host_backend(name):
    if name == "cpu" and not native.available():
        pytest.skip("the native CPU codec is not built on this machine")
    return name


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("backend", ["multihost", "xla", "pallas"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        api.make_compressor(np.float32, 1, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        api.make_decompressor(np.float32, 1, backend=backend)


@pytest.mark.parametrize("backend", ["golden", "torch"])
def test_dtype_and_dims_validation(backend):
    with pytest.raises(ValueError):
        api.make_compressor(np.int8, 1, backend=backend)
    with pytest.raises(ValueError):
        api.make_compressor(np.float32, 4, backend=backend)
    comp = api.make_compressor(np.float32, 2, backend=backend)
    with pytest.raises(ValueError, match="dimensionality"):
        comp.compress(np.zeros(16, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        comp.compress(np.zeros((4, 4), np.float64))


def test_requirements_accumulate_and_validate():
    req = api.CompressorRequirements((4096,), (8192,))
    assert req.max_num_hypercubes == 2
    req.include((4096 * 5,))
    assert req.max_num_hypercubes == 5
    with pytest.raises(ValueError, match="dimensionality"):
        req.include((64, 64))
    with pytest.raises(ValueError):
        api.CompressorRequirements((2, 2, 2, 2))


def test_requirements_on_a_host_backend_build_nothing():
    req = api.CompressorRequirements((4096 * 2 + 7,))
    comp = api.make_compressor(np.float32, 1, backend="torch", requirements=req)
    data = np.sin(np.arange(4096 * 2 + 7, dtype=np.float32))
    stream, words = comp.compress(data)
    assert np.array_equal(api.make_decompressor(np.float32, 1, backend="torch").decompress(stream, data.shape),
                          data)


@pytest.mark.parametrize("backend", HOST_BACKENDS)
def test_offloader_round_trip_and_wall_timing(backend):
    backend = host_backend(backend)
    data = np.sin(np.arange(4096 * 3 + 5, dtype=np.float32))
    off = api.make_offloader(backend, np.float32, 1)
    assert off.backend == backend and off.timing_mode == "wall"
    stream, words = off.compress(data)
    assert off.timing.compress_ns > 0
    g, gl = golden.compress(data)
    assert words == gl and stream.tobytes() == g.tobytes()
    out = off.decompress(stream, data.shape)
    assert off.timing.decompress_ns > 0
    assert np.array_equal(out, data)
    assert off.compressed_length_bound(data.shape) == fmt.compressed_bound_words(data.shape, 32) >= words


@pytest.mark.parametrize("shape", [(4096 * 2 + 3,), (70, 66), (17, 16, 33)], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float", "double"])
def test_torch_backend_streams_are_golden(dtype, shape):
    data = np.random.default_rng(len(shape)).standard_normal(shape).astype(dtype)
    data.reshape(-1)[:100] = 0
    stream, words = api.make_compressor(dtype, len(shape), "torch").compress(data)
    g, gl = golden.compress(data)
    assert stream.dtype == np.uint32 and words == gl and stream.tobytes() == g.tobytes()
    out = api.make_decompressor(dtype, len(shape), "torch").decompress(g, shape)
    assert out.dtype == dtype and out.shape == shape
    assert out.tobytes() == data.tobytes()


def test_auto_without_a_gpu_resolves_to_a_host_codec(no_gpu, monkeypatch):
    off = api.make_offloader("auto", np.float64, 2)
    assert off.backend == ("cpu" if native.available() else "golden")
    data = np.ones((70, 66), np.float64)
    stream, _ = off.compress(data)
    assert np.array_equal(off.decompress(stream, data.shape), data)
    monkeypatch.setattr(api.native, "available", lambda: False)
    assert api.make_offloader("auto", np.float32, 1).backend == "golden"


def test_backend_env_override_and_probe(no_gpu, monkeypatch):
    """No backend and backend="auto" honour NDZIP_TORCH_BACKEND, an explicit
    backend passes both the variable and the probe by, and an unknown name in
    the variable raises as an unknown backend does (tests/test_api.py's
    case)."""
    assert api.BACKEND_ENV == "NDZIP_TORCH_BACKEND"
    monkeypatch.setenv(api.BACKEND_ENV, "golden")
    assert api._resolve_backend("auto") == api._resolve_backend(None) == "golden"
    assert api.make_offloader("auto", np.float32, 1).backend == "golden"
    assert type(api.make_compressor(np.float32, 1)) is api._GoldenCompressor
    assert type(api.make_decompressor(np.float32, 1)) is api._GoldenDecompressor
    # explicit backends bypass both the variable and the probe
    assert api._resolve_backend("torch") == "torch"
    assert api.make_offloader("torch", np.float32, 1).backend == "torch"
    monkeypatch.setenv(api.BACKEND_ENV, "torch")
    data = np.sin(np.arange(4096 + 9, dtype=np.float32))
    comp = api.make_compressor(np.float32, 1)
    assert type(comp) is api._TorchCompressor
    assert comp.compress(data)[0].tobytes() == golden.compress(data)[0].tobytes()

    for unknown in ("pallas", "no-such-backend"):
        monkeypatch.setenv(api.BACKEND_ENV, unknown)
        with pytest.raises(ValueError, match="unknown backend"):
            api.make_compressor(np.float32, 1)
        with pytest.raises(ValueError, match="unknown backend"):
            api.make_decompressor(np.float32, 1, "auto")
        assert api.make_compressor(np.float32, 1, "golden").compress(data)[1] > 0

    # "auto" in the variable, or "auto" by name without it, leaves the probe to decide; no backend and
    # no variable is the card, with a GPU or without
    monkeypatch.setenv(api.BACKEND_ENV, "auto")
    assert api._resolve_backend("auto") in ("cpu", "golden")
    assert api._resolve_backend(None) in ("cpu", "golden")
    monkeypatch.delenv(api.BACKEND_ENV)
    assert api._resolve_backend("auto") in ("cpu", "golden")
    assert api._resolve_backend(None) == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert api._resolve_backend("auto") == api._resolve_backend(None) == "cuda"
    monkeypatch.setenv(api.BACKEND_ENV, "golden")
    assert api._resolve_backend("auto") == api._resolve_backend(None) == "golden"


#: the entry points of api that take no backend: each builds a compressor, a decompressor or both
DEFAULT_ENTRY_POINTS = {
    "make_compressor": lambda: api.make_compressor(np.float32, 1),
    "make_decompressor": lambda: api.make_decompressor(np.float64, 3),
    "Offloader": lambda: api.Offloader(np.float32, 1),
    "Offloader device timing": lambda: api.Offloader(np.float64, 2, timing_mode="device"),
}


@pytest.mark.parametrize("entry", list(DEFAULT_ENTRY_POINTS))
def test_default_backend_without_a_gpu_raises_naming_it(no_gpu, monkeypatch, entry):
    """Given no backend and no NDZIP_TORCH_BACKEND, an entry point takes the
    card, and without one it says so: no CPU codec stands in for it."""
    monkeypatch.delenv(api.BACKEND_ENV, raising=False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        DEFAULT_ENTRY_POINTS[entry]()


@pytest.mark.parametrize("backend", ["golden", "torch"])
@pytest.mark.parametrize("entry", list(DEFAULT_ENTRY_POINTS))
def test_default_backend_is_the_one_the_variable_names(no_gpu, monkeypatch, entry, backend):
    """NDZIP_TORCH_BACKEND names the backend of an entry point given none,
    and that backend's stream is golden's."""
    monkeypatch.setenv(api.BACKEND_ENV, backend)
    made = DEFAULT_ENTRY_POINTS[entry]()
    cls = {"golden": (api._GoldenCompressor, api._GoldenDecompressor),
           "torch": (api._TorchCompressor, api._TorchDecompressor)}[backend]
    if isinstance(made, api.Offloader):
        assert made.backend == backend and made.timing_mode == "wall"
        assert (type(made._comp), type(made._dec)) == cls
        data = np.sin(np.arange(64 * 70, dtype=made.dtype)).reshape((64, 70) if made.dims == 2 else (-1,))
        stream, _ = made.compress(data)
        assert stream.tobytes() == golden.compress(data)[0].tobytes()
        assert made.decompress(stream, data.shape).tobytes() == data.tobytes()
    else:
        assert type(made) in cls


def test_cuda_without_a_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="GPU"):
        api.make_compressor(np.float32, 1, "cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        api.make_decompressor(np.float64, 3, "cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        api.Offloader(np.float32, 1, "cuda", timing_mode="device")
    with pytest.raises(RuntimeError, match="GPU"):
        api.make_compressor(np.float32, 1, "cuda", requirements=api.CompressorRequirements((4096,)))


@pytest.mark.parametrize("backend", HOST_BACKENDS)
def test_device_timing_on_host_backends_is_wall_time(backend):
    off = api.Offloader(np.float32, 1, host_backend(backend), timing_mode="device")
    assert off.timing_mode == "wall"
    data = np.sin(np.arange(4096 + 9, dtype=np.float32))
    stream, _ = off.compress(data)
    assert off.timing.compress_ns > 0
    assert np.array_equal(off.decompress(stream, data.shape), data)
    assert off.timing.decompress_ns > 0
    with pytest.raises(ValueError, match="timing_mode"):
        api.Offloader(np.float32, 1, "golden", timing_mode="events")


def test_measure_needs_cuda():
    off = api.Offloader(np.float32, 1, "torch")
    with pytest.raises(ValueError, match="cuda"):
        off.measure(np.zeros(4096, np.float32))


def test_package_reexports_the_api():
    assert nt.Offloader is api.Offloader and nt.make_offloader is api.make_offloader
    assert nt.make_compressor is api.make_compressor and nt.make_decompressor is api.make_decompressor
    assert nt.CompressorRequirements is api.CompressorRequirements


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float", "double"])
def test_cuda_offloader_device_timing(cuda, dtype):
    data = np.random.default_rng(0).standard_normal((130, 513)).astype(dtype)
    off = api.Offloader(dtype, 2, "cuda", timing_mode="device")
    assert off.backend == "cuda" and off.timing_mode == "device"
    stream, words = off.compress(data)
    g, gl = golden.compress(data)
    assert words == gl and stream.tobytes() == g.tobytes()
    assert off.timing.compress_ns > 0
    out = off.decompress(stream, data.shape)
    assert off.timing.decompress_ns > 0 and out.tobytes() == data.tobytes()
    timing = off.measure(data)
    assert timing.compress_ns > 0 and timing.decompress_ns > 0
