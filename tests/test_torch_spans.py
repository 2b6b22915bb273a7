"""The port's spans: ``utils.trace`` enters a ``record_function`` only while
a profiler records or under ``NDZIP_TORCH_VERBOSE``; ``codec_cuda`` opens
``ndzip.compress_device``/``ndzip.decompress_device`` around each API call
and ``ndzip.launch`` around each launch; the Offloader's staging opens
``ndzip.offload.stage``, ``.length`` and ``.copy_out``. A span nests in the
span that encloses it on the same host thread, as the profiler's trace
shows. On a card (marker ``cuda``): the codec's spans around its kernels."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu_torch import api, codec_cuda, utils  # noqa: E402


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.delenv(utils.VERBOSE_ENV, raising=False)
    utils.verbose.cache_clear()
    yield
    utils.verbose.cache_clear()


@pytest.fixture
def entered(monkeypatch):
    """The labels of every ``torch.profiler.record_function`` made."""
    labels, real = [], torch.profiler.record_function

    def counting(label, *args, **kwargs):
        labels.append(label)
        return real(label, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return labels


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(log_dir) -> list:
    """``(name, start, end, tid)`` of the spans in the one trace that
    ``utils.profiler_trace`` wrote into ``log_dir``, sorted by start."""
    (path,) = list(log_dir.glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"), key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return inner[3] == outer[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_record_function_while_nothing_listens(entered):
    for label in ("ndzip.compress_device", "ndzip.launch", "ndzip.offload.stage"):
        with utils.trace(label):
            torch.ones(8).sum()
    assert entered == []


def test_one_record_function_under_a_profiler_and_none_after_it(entered):
    with _cpu_profile() as prof:
        with utils.trace("ndzip.unit"):
            torch.ones(8).sum()
    assert entered == ["ndzip.unit"]
    assert any(e.key == "ndzip.unit" for e in prof.key_averages())
    with utils.trace("ndzip.after"):
        pass
    assert entered == ["ndzip.unit"]


def test_one_record_function_under_verbose(entered, monkeypatch, capsys):
    monkeypatch.setenv(utils.VERBOSE_ENV, "1")
    with utils.trace("ndzip.verbose"):
        pass
    assert entered == ["ndzip.verbose"] and "[profile] ndzip.verbose" in capsys.readouterr().err


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "profiled"])
def test_a_region_that_raises_leaves_its_span_closed(tmp_path, profiled):
    def fail():
        with utils.trace("ndzip.failing"):
            raise KeyError("inside")

    if not profiled:
        with pytest.raises(KeyError):
            fail()
        return
    with utils.profiler_trace(tmp_path):
        with utils.trace("caller"):
            with pytest.raises(KeyError):
                fail()
            with utils.trace("ndzip.next"):
                pass
    found = {s[0]: s for s in _spans(tmp_path)}
    assert _inside(found["ndzip.failing"], found["caller"]) and _inside(found["ndzip.next"], found["caller"])
    assert found["ndzip.failing"][2] <= found["ndzip.next"][1]  # closed before the next one opened


@pytest.mark.parametrize("call", [
    lambda: codec_cuda.compress_device(torch.zeros((64, 64))),
    lambda: codec_cuda.decompress_device(torch.zeros(64, dtype=torch.int32), (64, 64)),
], ids=["ndzip.compress_device", "ndzip.decompress_device"])
def test_the_codec_span_holds_its_checks(tmp_path, request, call):
    """On the CPU the codec's checks refuse a host tensor; the refusal lies
    inside the API call's span, which nests in the caller's."""
    label = request.node.callspec.id
    with utils.profiler_trace(tmp_path):
        with utils.trace("caller"):
            with pytest.raises(ValueError, match="CUDA device"):
                call()
    found = _spans(tmp_path)
    assert [s[0] for s in found] == ["caller", label]
    assert _inside(found[1], found[0])


@pytest.mark.parametrize("dtype, shape", [(np.float32, (130, 513)), (np.float64, (17, 16, 129))],
                         ids=["fp32-2d", "fp64-3d"])
def test_an_offloader_round_trip_shows_its_staging_spans(tmp_path, dtype, shape):
    data = np.random.default_rng(3).standard_normal(shape).astype(dtype)
    off = api.Offloader(dtype, len(shape), backend="torch")
    with utils.profiler_trace(tmp_path):
        with utils.trace("caller.compress"):
            stream, _ = off.compress(data)
        with utils.trace("caller.decompress"):
            out = off.decompress(stream, shape)
    assert np.array_equal(out.view(np.uint8), data.view(np.uint8))
    found = _spans(tmp_path)
    assert [s[0] for s in found] == ["caller.compress", "ndzip.offload.stage", "ndzip.offload.length",
                                     "ndzip.offload.copy_out", "caller.decompress", "ndzip.offload.stage",
                                     "ndzip.offload.copy_out"]
    for caller, first, last in ((0, 1, 4), (4, 5, 7)):
        assert all(_inside(s, found[caller]) for s in found[first:last])
        assert all(a[2] <= b[1] for a, b in zip(found[first:last], found[first + 1:last]))  # in call order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", [(torch.float32, (1800, 3600)), (torch.float32, (1 << 20,)),
                                          (torch.float64, (64, 64, 96))], ids=["fp32-2d", "fp32-1d", "fp64-3d"])
def test_the_codec_spans_around_the_kernels(cuda, tmp_path, dtype, shape):
    """One compress_device and one decompress_device under the profiler:
    one API span each, nested in the caller's; one ``ndzip.launch`` inside
    it, holding the kernel's launch."""
    x = torch.randn(shape, dtype=dtype, device=cuda)
    codec_cuda.compress_device(x)  # the library built and loaded outside the trace
    torch.cuda.synchronize()
    with utils.profiler_trace(tmp_path):
        with utils.trace("caller.compress"):
            stream, length = codec_cuda.compress_device(x)
            n = int(length)
        with utils.trace("caller.decompress"):
            out = codec_cuda.decompress_device(stream[:n], shape, dtype)
            torch.cuda.synchronize()
    assert torch.equal(out, x)
    (path,) = list(tmp_path.glob("*.pt.trace.json"))
    launches = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
                for e in json.loads(path.read_text())["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and e["name"] == "cudaLaunchKernel"]
    found = _spans(tmp_path)
    assert [s[0] for s in found] == ["caller.compress", "ndzip.compress_device", "ndzip.launch",
                                     "caller.decompress", "ndzip.decompress_device", "ndzip.launch"]
    for caller, api_span, launch in (found[0:3], found[3:6]):
        assert _inside(api_span, caller) and _inside(launch, api_span)
        assert sum(_inside(k, launch) for k in launches) == 1
